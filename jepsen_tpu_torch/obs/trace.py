"""Span tracing: where the wall clock went.

A *span* is one timed region of work (a device slice, a bucket's host
prep, a prepass) recorded as a plain dict into a bounded per-run ring
buffer.  The API is two primitives:

  * :func:`span`, a context manager: ``with obs.span("fold", run="r1",
    rows=128): ...`` records begin, end and attributes; with tracing
    off it returns a shared no-op object, so an instrumented hot path
    costs one check and nothing else;
  * :func:`traced`, the decorator form for whole functions.

Spans attribute to a *run*: the explicit ``run=`` argument, or the
process-wide current run (:func:`set_run`).  Each run gets its own
:class:`SpanRecorder` ring buffer; :func:`drop_recorder` forgets one
after export.

Export is Chrome-trace JSON (``"X"`` complete events, microsecond
timestamps), which Perfetto and ``chrome://tracing`` load:
:func:`chrome_trace` and :func:`write_trace`.

Tracing is off until :func:`enable` turns it on; nothing reads the
environment.  A copy of the JAX package's recorder, with the same span
and trace shapes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

#: process epoch every span timestamp is relative to (microseconds
#: since this module imported): Chrome trace wants one monotonic
#: microsecond clock, not wall time
_EPOCH = time.perf_counter()

#: default ring-buffer capacity (spans per run).  A span dict is a few
#: hundred bytes, so a run's recorder stays at tens of MB at most.
DEFAULT_CAP = 65536

#: the switch; off until :func:`enable`
_on = False


def enabled() -> bool:
    """Is tracing on?"""
    return _on


def enable(on: bool = True) -> None:
    """Turn tracing on or off for this process."""
    global _on
    _on = bool(on)


# ---------------------------------------------------------------------------
# recorders
# ---------------------------------------------------------------------------


class SpanRecorder:
    """A bounded ring buffer of finished spans for one run.

    Appends are ``deque.append`` on a ``maxlen`` deque — atomic under
    the GIL, so worker threads, the bucket prep thread, and the stream
    fold thread all record without a lock on the hot path."""

    def __init__(self, run: str | None = None, cap: int = DEFAULT_CAP):
        self.run = run
        self.cap = cap
        self._spans: deque = deque(maxlen=cap)
        self.dropped = 0  # spans pushed off the back, lifetime

    def __len__(self) -> int:
        return len(self._spans)

    def record(self, name: str, cat: str, t0: float, t1: float,
               args: dict | None = None) -> None:
        """Record one finished span; ``t0``/``t1`` are
        ``time.perf_counter()`` readings."""
        if len(self._spans) == self.cap:
            self.dropped += 1
        self._spans.append({
            "name": name, "cat": cat,
            "ts": round((t0 - _EPOCH) * 1e6, 1),
            "dur": round((t1 - t0) * 1e6, 1),
            "tid": threading.current_thread().name,
            "args": args or {},
        })

    def spans(self) -> list[dict]:
        return list(self._spans)

    def clear(self) -> None:
        self._spans.clear()

    def chrome_trace(self) -> dict:
        """The Chrome-trace / Perfetto JSON object: ``"X"`` complete
        events plus thread-name metadata so tracks are labelled."""
        pid = os.getpid()
        tids: dict[str, int] = {}
        events = []
        for s in self.spans():
            tid = tids.setdefault(s["tid"], len(tids) + 1)
            events.append({"name": s["name"], "cat": s["cat"],
                           "ph": "X", "ts": s["ts"], "dur": s["dur"],
                           "pid": pid, "tid": tid,
                           "args": s["args"]})
        meta = [{"name": "thread_name", "ph": "M", "pid": pid,
                 "tid": t, "args": {"name": n}}
                for n, t in tids.items()]
        if self.run is not None:
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": str(self.run)}})
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"run": self.run,
                              "dropped_spans": self.dropped}}


_recorders: dict = {}
_recorders_lock = threading.Lock()
_current_run: str | None = None


def recorder(run: str | None = None) -> SpanRecorder:
    """The (created-on-demand) recorder for ``run`` — ``None`` is the
    process-default buffer for spans outside any run."""
    rec = _recorders.get(run)
    if rec is None:
        with _recorders_lock:
            rec = _recorders.setdefault(run, SpanRecorder(run))
    return rec


def set_run(run: str | None) -> None:
    """Set the process-wide current run: spans with no explicit
    ``run=`` attribute to it.  Callers that multiplex runs pass
    ``run=`` explicitly instead."""
    global _current_run
    _current_run = run


def current_run() -> str | None:
    return _current_run


def drop_recorder(run: str | None) -> None:
    """Forget a finished run's buffer (after export) so a long-lived
    process does not keep one ring buffer per run forever."""
    with _recorders_lock:
        _recorders.pop(run, None)


# ---------------------------------------------------------------------------
# the span primitive
# ---------------------------------------------------------------------------


class _Noop:
    """The shared do-nothing span: tracing off costs one call + one
    truthiness check, allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "cat", "run", "args", "_t0")

    def __init__(self, name: str, cat: str, run: str | None,
                 args: dict | None):
        self.name = name
        self.cat = cat
        self.run = run
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        args = self.args
        if exc_type is not None:
            args = dict(args or {})
            args["error"] = exc_type.__name__
        run = self.run if self.run is not None else _current_run
        try:
            recorder(run).record(self.name, self.cat, self._t0, t1, args)
        except Exception:  # pragma: no cover — the recorder must never
            pass           # take down the instrumented code
        return False


def span(name: str, *, cat: str = "span", run: str | None = None,
         **attrs):
    """``with obs.span("fold", run=..., rows=128): ...`` — no-op when
    tracing is off."""
    if not enabled():
        return _NOOP
    return _Span(name, cat, run, attrs or None)


def traced(name: str | None = None, *, cat: str = "span"):
    """Decorator form: ``@obs.traced()`` / ``@obs.traced("prep",
    cat="host")`` wraps the call in a span named after the function."""
    import functools

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not enabled():
                return fn(*a, **kw)
            with _Span(label, cat, None, None):
                return fn(*a, **kw)

        return wrapper

    return deco


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def chrome_trace(run: str | None = None) -> dict:
    """The Chrome-trace JSON for one run's recorder (``None`` = the
    default buffer)."""
    return recorder(run).chrome_trace()


def write_trace(path: str, run: str | None = None) -> str:
    """Write ``run``'s Chrome trace to ``path`` (atomically: a reader
    may hold the previous snapshot); returns the path."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(chrome_trace(run), f)
    os.replace(tmp, path)
    return path
