"""``linear.html``: the failure report of an invalid linearizability
verdict, the analog of knossos' ``linear.svg``.

An inline-SVG timeline of the history: one lane per process, x = event
rank; ops colored green (in the deepest linearizable prefix), red (the
frontier candidates that could not be linearized), orange (crashed,
never returned) or gray.  Above it the minimal failing subhistory when
the verdict was shrunk (``analyze/shrink.py``); below it the frontier
ops and the deepest partial linearizations (at most ten each) with the
model state each reaches.  Written into the test's store directory.
"""

from __future__ import annotations

import html as html_mod

from .. import store
from ..history import INF_RET, OpSeq

LANE_H = 22
BAR_H = 14
LEFT = 90
PX_PER_RANK = 14
COLORS = {
    "prefix": "#2da44e",
    "frontier": "#cf222e",
    "crashed": "#d4a72c",
    "other": "#8c959f",
}


def _op_label(seq: OpSeq, row: int) -> str:
    op = seq.ops[row]
    v = "" if op.value is None else f" {op.value!r}"
    return f"{op.process} {op.f}{v}"


def _svg(seq: OpSeq, result: dict) -> str:
    n = len(seq)
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    procs = sorted({int(p) for p in seq.process})
    lane = {p: i for i, p in enumerate(procs)}

    paths = result.get("final_paths") or []
    prefix = set(paths[0]["linearized"]) if paths else set()
    frontier = set(result.get("final_ops") or [])
    max_rank = max([r for r in ret if r < INF_RET] + inv + [1])

    width = LEFT + (max_rank + 2) * PX_PER_RANK + 40
    height = (len(procs) + 1) * LANE_H + 30
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="11">']
    for p in procs:
        y = lane[p] * LANE_H + 20
        parts.append(f'<text x="4" y="{y + BAR_H - 3}">proc {p}</text>')
        parts.append(f'<line x1="{LEFT}" y1="{y + BAR_H / 2}" '
                     f'x2="{width - 20}" y2="{y + BAR_H / 2}" '
                     'stroke="#eee"/>')
    for i in range(n):
        p = int(seq.process[i])
        y = lane[p] * LANE_H + 20
        x0 = LEFT + inv[i] * PX_PER_RANK
        crashed = not bool(seq.ok[i])
        r = ret[i] if not crashed else max_rank + 1
        x1 = LEFT + r * PX_PER_RANK + PX_PER_RANK // 2
        if i in frontier:
            color = COLORS["frontier"]
        elif i in prefix:
            color = COLORS["prefix"]
        elif crashed:
            color = COLORS["crashed"]
        else:
            color = COLORS["other"]
        dash = ' stroke-dasharray="3,2" fill-opacity="0.55"' \
            if crashed else ""
        label = html_mod.escape(_op_label(seq, i))
        parts.append(
            f'<rect x="{x0}" y="{y}" width="{max(4, x1 - x0)}" '
            f'height="{BAR_H}" rx="2" fill="{color}" stroke="{color}"'
            f'{dash}><title>{label}</title></rect>')
    depth = result.get("max_depth", 0)
    parts.append(
        f'<text x="{LEFT}" y="{height - 8}" fill="{COLORS["frontier"]}">'
        f'deepest linearizable prefix: {depth} of '
        f'{int(sum(map(bool, seq.ok)))} ok ops</text>')
    parts.append("</svg>")
    return "".join(parts)


def shrink_block(result: dict) -> str:
    """The minimal failing subhistory (``result["shrink"]``), or ""."""
    sh = result.get("shrink")
    if not sh:
        return ""
    confirm = {True: "brute-force checker says VALID — engine "
                     "divergence, report it",
               False: "independently confirmed invalid by the "
                      "brute-force permutation checker",
               None: "too large for the brute-force confirmation"
               }[sh.get("brute_force")]
    items = ""
    for d in (sh.get("ops") or []):
        tag = " <em>(crashed)</em>" if d.get("crashed") else ""
        v = "" if d.get("value") is None else f" {d['value']!r}"
        items += (f"<li><code>{html_mod.escape(str(d.get('process')))} "
                  f"{html_mod.escape(str(d.get('f')))}"
                  f"{html_mod.escape(v)}</code>{tag}</li>")
    minimal = "1-minimal" if sh.get("minimal") else \
        "reduced (check budget hit before 1-minimality)"
    return (f"<h3>Minimal failing subhistory</h3>"
            f"<p>{sh.get('n_from')} ops shrank to "
            f"<b>{sh.get('n_to')}</b> ({minimal}, "
            f"{sh.get('checks')} re-checks); {confirm}.</p>"
            f"<ol>{items}</ol>")


def render_linear_html(seq: OpSeq, result: dict) -> str:
    """The whole linear.html document for an invalid verdict."""
    paths = (result.get("final_paths") or [])[:10]
    frontier = (result.get("final_ops") or [])[:10]
    rows = []
    for i, p in enumerate(paths):
        ops = " → ".join(html_mod.escape(_op_label(seq, r))
                         for r in p["linearized"][-8:])
        pre = "… " if len(p["linearized"]) > 8 else ""
        rows.append(f"<tr><td>{i}</td><td>{pre}{ops}</td>"
                    f"<td>{html_mod.escape(repr(p.get('state')))}"
                    "</td></tr>")
    frontier_items = "".join(
        f"<li><code>{html_mod.escape(_op_label(seq, r))}</code></li>"
        for r in frontier)
    legend = "".join(
        f'<span style="color:{c}">■ {name}</span>&nbsp;&nbsp;'
        for name, c in COLORS.items())
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>linearizability failure</title>
<style>body{{font-family:sans-serif;margin:16px}}
table{{border-collapse:collapse}}td,th{{border:1px solid #ddd;
padding:4px 8px;font-family:monospace;font-size:12px}}</style>
</head><body>
<h2>Linearizability failure</h2>
<p>configs explored: {result.get('configs')} ·
max depth: {result.get('max_depth')} · {legend}</p>
{shrink_block(result)}
{_svg(seq, result)}
<h3>Ops that could not be linearized (≤ 10)</h3>
<ul>{frontier_items}</ul>
<h3>Deepest partial linearizations (≤ 10)</h3>
<table><tr><th>#</th><th>linearized (tail)</th><th>model state</th></tr>
{''.join(rows)}</table>
</body></html>"""


def write_linear_html(test: dict, seq: OpSeq, result: dict,
                      opts: dict | None = None) -> str | None:
    """Write the report into the test's store directory and return its
    path; None when it could not be written.  Never raises: reporting
    must not change a verdict."""
    try:
        # keys checked independently pass {"history_key": k} in opts;
        # each gets its own file
        key = (opts or {}).get("history_key")
        fname = "linear.html" if key is None else f"linear-{key}.html"
        p = store.path_mkdirs(test, *(opts or {}).get("subdirectory", []),
                              fname)
        with open(p, "w") as fh:
            fh.write(render_linear_html(seq, result))
        return str(p)
    except Exception:  # noqa: BLE001 — reporting only
        return None
