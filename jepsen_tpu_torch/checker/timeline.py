"""HTML timeline renderer — per-process Gantt of operations.

Reference: jepsen/src/jepsen/checker/timeline.clj — pairs invocations
with completions (pairs, timeline.clj:33-53), lays each process out in
its own column with one div per op spanning its duration, color-coded by
completion type (stylesheet at 24-31, pair->div at 97-141), written into
the store as timeline.html (html checker, 159-179).
"""

from __future__ import annotations

import html as html_mod

from .. import store
from ..history import Op
from .core import Checker

TIMESCALE = 1e6  # nanoseconds per pixel (timeline.clj:19)
COL_WIDTH = 100
GUTTER_WIDTH = 106
HEIGHT = 16

STYLESHEET = """
.ops        { position: absolute; }
.op         { position: absolute; padding: 2px; border-radius: 2px;
              box-shadow: 0 1px 3px rgba(0,0,0,0.12); font-size: 10px;
              font-family: sans-serif; overflow: hidden; }
.op.invoke  { background: #eeeeee; }
.op.ok      { background: #6DB6FE; }
.op.info    { background: #FFAA26; }
.op.fail    { background: #FEB5DA; }
.op:target  { box-shadow: 0 14px 28px rgba(0,0,0,0.25); }
"""


def pairs(history: list[Op]):
    """[invoke, completion] / [lone-info] pairs (timeline.clj:33-53)."""
    invocations: dict = {}
    out = []
    for op in history:
        if op.type == "invoke":
            assert op.process not in invocations
            invocations[op.process] = op
        elif op.type == "info":
            if op.process in invocations:
                out.append((invocations.pop(op.process), op))
            else:
                out.append((op, None))
        elif op.type in ("ok", "fail"):
            if op.process in invocations:
                out.append((invocations.pop(op.process), op))
    # unterminated invokes render open-ended
    for op in invocations.values():
        out.append((op, None))
    return out


def _title(start: Op, stop: Op | None) -> str:
    bits = []
    if stop is not None and start.time is not None and stop.time is not None:
        bits.append(f"Dur: {int((stop.time - start.time) / 1e6)} ms")
    op = stop or start
    if op.error is not None:
        bits.append(f"Err: {op.error}")
    bits.append(f"Op: {op.to_dict()}")
    return "\n".join(bits)


def _body(start: Op, stop: Op | None) -> str:
    op = stop or start
    s = f"{op.process} {op.f}"
    if op.process != "nemesis":
        s += f" {start.value}"
    if stop is not None and stop.value != start.value:
        s += f"<br />{html_mod.escape(str(stop.value))}"
    return s


def html(test: dict, history: list[Op], opts: dict | None = None) -> str:
    """Render timeline.html into the store (timeline.clj:143-179)."""
    procs = []
    for op in history:
        if op.process not in procs:
            procs.append(op.process)
    process_index = {p: i for i, p in enumerate(procs)}

    t0 = min((op.time or 0) for op in history) if history else 0
    divs = []
    for start, stop in pairs(history):
        op = stop or start
        top = ((start.time or 0) - t0) / TIMESCALE
        bottom = (((stop.time or 0) - t0) / TIMESCALE
                  if stop is not None and stop.time is not None
                  else top + HEIGHT)
        height = max(HEIGHT, bottom - top)
        left = GUTTER_WIDTH * process_index[start.process]
        divs.append(
            f'<a href="#i{op.index}"><div class="op {op.type}" '
            f'id="i{op.index}" title="{html_mod.escape(_title(start, stop))}"'
            f' style="width:{COL_WIDTH}px;left:{left:.0f}px;'
            f'top:{top:.0f}px;min-height:{height:.0f}px">'
            f"{_body(start, stop)}</div></a>")

    headers = "".join(
        f'<div style="position:absolute;left:{GUTTER_WIDTH * i}px;'
        f'top:-20px;font-weight:bold;font-family:sans-serif;'
        f'font-size:11px">{html_mod.escape(str(p))}</div>'
        for p, i in process_index.items())

    doc = (f"<html><head><style>{STYLESHEET}</style></head><body>"
           f'<h1 style="font-family:sans-serif">'
           f"{html_mod.escape(str(test.get('name', 'test')))}</h1>"
           f'<div class="ops" style="margin-top:40px">{headers}{divs and "".join(divs)}'
           f"</div></body></html>")
    p = store.path_mkdirs(test, *(opts or {}).get("subdirectory", []),
                          "timeline.html")
    with open(p, "w") as f:
        f.write(doc)
    return p


class Timeline(Checker):
    """timeline.clj:159-179."""

    def check(self, test, history, opts=None):
        html(test, history, opts)
        return {"valid": True}


def timeline() -> Checker:
    return Timeline()
