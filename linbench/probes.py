"""The benchmark's own timers around the port's functions, installed in a
traced run only: the host wall of the re-check of invalid verdicts and
of their report (``confirm_share`` reads :data:`CONFIRM`), and of the
competition race's legs and of the race's waits for them.

* ``independent.check_safe`` called after the batch's ``search_batch``
  returned, in the same check: the independent checker's re-check of
  each invalid key, with its confirmation and its report;
* ``Linearizable._check_direct`` from its call of ``truncate_to_failure``
  (made only for an invalid device verdict) to its return: the host
  confirmation on the shortest sound prefix, and its report;
* ``Linearizable._render_failure``: the report of an invalid verdict
  that a host engine reached;
* each host leg of ``check_competition`` (``race_leg:<thread name>``),
  from its start to its end, and each of the race's ``join`` calls on
  them (``race_join``): the wait for the losers once a leg has won.

Each interval is ``(start, end, name)`` in ``time.perf_counter``
seconds; intervals may nest, and a reader takes their union.
"""

from __future__ import annotations

import threading
import time
import types

#: the intervals ``confirm_share`` reads
CONFIRM = ("recheck", "confirm", "report")


def _timed_threading(rec: list):
    """``threading`` with a ``Thread`` that records its run and the joins
    on it into ``rec``."""

    class Thread(threading.Thread):
        def run(self):
            t0 = time.perf_counter()
            try:
                super().run()
            finally:
                rec.append((t0, time.perf_counter(),
                            f"race_leg:{self.name}"))

        def join(self, timeout=None):
            t0 = time.perf_counter()
            try:
                return super().join(timeout)
            finally:
                rec.append((t0, time.perf_counter(), "race_join"))

    return types.SimpleNamespace(**{**vars(threading), "Thread": Thread})


class Probes:
    def __init__(self):
        self.intervals: list[tuple[float, float, str]] = []
        self._tl = threading.local()
        self._saved: list = []

    def new_check(self) -> None:
        self._tl.after_batch = False

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def install(self) -> None:
        from jepsen_tpu_torch import independent
        from jepsen_tpu_torch.checker import linearizable as lin

        tl = self._tl
        rec = self.intervals

        def search_batch(orig):
            def wrapped(*a, **kw):
                try:
                    return orig(*a, **kw)
                finally:
                    tl.after_batch = True
            return wrapped

        def check_safe(orig):
            def wrapped(*a, **kw):
                if not getattr(tl, "after_batch", False):
                    return orig(*a, **kw)
                t0 = time.perf_counter()
                try:
                    return orig(*a, **kw)
                finally:
                    rec.append((t0, time.perf_counter(), "recheck"))
            return wrapped

        def truncate(orig):
            def wrapped(*a, **kw):
                tl.mark = time.perf_counter()
                return orig(*a, **kw)
            return wrapped

        def check_direct(orig):
            def wrapped(*a, **kw):
                tl.mark = None
                try:
                    return orig(*a, **kw)
                finally:
                    if tl.mark is not None:
                        rec.append((tl.mark, time.perf_counter(),
                                    "confirm"))
                    tl.mark = None
            return wrapped

        def render(orig):
            def wrapped(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **kw)
                finally:
                    rec.append((t0, time.perf_counter(), "report"))
            return wrapped

        self._patch(lin, "search_batch", search_batch)
        self._patch(independent, "check_safe", check_safe)
        self._patch(lin, "truncate_to_failure", truncate)
        self._patch(lin.Linearizable, "_check_direct", check_direct)
        self._patch(lin.Linearizable, "_render_failure", render)
        # ``check_competition`` is the module's only user of ``Thread``
        self._patch(lin, "threading", lambda orig: _timed_threading(rec))

    def uninstall(self) -> None:
        while self._saved:
            owner, name, orig = self._saved.pop()
            setattr(owner, name, orig)
