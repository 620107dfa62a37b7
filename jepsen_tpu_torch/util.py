"""Kitchen-sink utilities.

Semantics follow the reference's jepsen.util (jepsen/src/jepsen/util.clj):
majority (util.clj:58), relative time (util.clj:248-260), timeout
(util.clj:283), retry (util.clj:296-335), real-pmap (util.clj:45),
history->latencies (util.clj:565-599), nemesis-intervals (util.clj:601),
integer-interval-set-str (util.clj:495), longest-common-prefix (util.clj:620).
Implementations are idiomatic Python, not translations.

A copy of the JAX package's ``util.py`` without its two JAX knobs (the
persistent compilation cache and the CPU platform pin).
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Any, Callable, Iterable, Sequence


def majority(n: int) -> int:
    """Smallest integer strictly greater than half of n (util.clj:58).

    majority(2) == 2 so that a 2-node cluster cannot split-brain.
    """
    return n // 2 + 1


def real_pmap(f: Callable, xs: Iterable) -> list:
    """Map f over xs, one real thread per element (util.clj:45-51).

    Used for node fan-out where every element must make progress
    concurrently (e.g. cluster-wide setup with barriers) — a bounded pool
    could deadlock, so we spawn one thread each, like the reference's
    unbounded futures.
    """
    xs = list(xs)
    results: list = [None] * len(xs)
    errors: list = [None] * len(xs)

    def run(i, x):
        try:
            results[i] = f(x)
        except BaseException as e:  # noqa: BLE001 - propagated below
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i, x), daemon=True)
               for i, x in enumerate(xs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def bounded_pmap(f: Callable, xs: Iterable, max_workers: int | None = None) -> list:
    """Semi-lazy bounded parallel map (util.clj bounded-pmap analog).

    Used by the independent checker to cap concurrent sub-checks
    (independent.clj:247-298)."""
    xs = list(xs)
    if not xs:
        return []
    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(f, xs))


# ---------------------------------------------------------------------------
# Relative time (util.clj:248-260): histories are timestamped in nanoseconds
# relative to a per-test origin, so ops from one run are comparable.
# ---------------------------------------------------------------------------

_relative_time_origin = threading.local()


class relative_time:
    """Context manager anchoring t=0 for relative_time_nanos (util.clj:251)."""

    def __enter__(self):
        _relative_time_origin.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        _relative_time_origin.t0 = None
        return False


def relative_time_nanos() -> int:
    """Nanoseconds since the enclosing relative_time block began.

    Falls back to absolute monotonic time when no origin is bound, so ops
    are still monotonically ordered (util.clj:256-260).
    """
    t0 = getattr(_relative_time_origin, "t0", None)
    now = time.monotonic_ns()
    return now if t0 is None else now - t0


def sleep_seconds(dt: float) -> None:
    """High-resolution-enough sleep (util.clj:262-281 uses nanoTime spin;
    Python's time.sleep is adequate at our op rates)."""
    if dt > 0:
        time.sleep(dt)


class Timeout(Exception):
    pass


def timeout(seconds: float, f: Callable[[], Any], default: Any = Timeout) -> Any:
    """Run f with a wall-clock timeout (util.clj:283-294).

    Runs f in a thread; on timeout returns `default`, or raises Timeout if
    no default given.  The thread is left to finish in the background (the
    JVM reference interrupts; Python cannot safely kill threads, and
    callers treat timeouts as indeterminate anyway).
    """
    box: dict = {}

    def run():
        try:
            box["ok"] = f()
        except BaseException as e:  # noqa: BLE001
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        if default is Timeout:
            raise Timeout(f"timed out after {seconds}s")
        return default
    if "err" in box:
        raise box["err"]
    return box.get("ok")


def retry(delay_seconds: float, f: Callable[[], Any], retries: int | None = None) -> Any:
    """Call f, retrying after delay on any exception (util.clj:296-306).

    retries=None retries forever, like the reference."""
    attempt = 0
    while True:
        try:
            return f()
        except Exception:
            attempt += 1
            if retries is not None and attempt > retries:
                raise
            time.sleep(delay_seconds)


def integer_interval_set_str(xs: Iterable[int]) -> str:
    """Compact string for a set of integers: '#{1-5 7 9-11}' (util.clj:495).

    Used by the set checker to render lost/recovered element sets readably.
    """
    xs = sorted(set(xs))
    if not xs:
        return "#{}"
    parts = []
    lo = prev = xs[0]
    for x in xs[1:]:
        if x == prev + 1:
            prev = x
            continue
        parts.append(str(lo) if lo == prev else f"{lo}-{prev}")
        lo = prev = x
    parts.append(str(lo) if lo == prev else f"{lo}-{prev}")
    return "#{" + " ".join(parts) + "}"


def longest_common_prefix(seqs: Sequence[Sequence]) -> list:
    """Longest common prefix of several sequences (util.clj:620-634)."""
    if not seqs:
        return []
    out = []
    for vals in zip(*seqs):
        if all(v == vals[0] for v in vals[1:]):
            out.append(vals[0])
        else:
            break
    return out


def history_latencies(history) -> list:
    """Pair invocations with completions and compute per-op latency
    (util.clj:565-599).  Returns (invoke_op, completion_op, latency_nanos)
    tuples in completion order.
    """
    out = []
    open_by_process: dict = {}
    for op in history:
        if op.type == "invoke":
            open_by_process[op.process] = op
        elif op.process in open_by_process:
            inv = open_by_process.pop(op.process)
            out.append((inv, op, (op.time or 0) - (inv.time or 0)))
    return out


def nemesis_intervals(history) -> list[tuple]:
    """Pair up nemesis start/stop ops into [start, stop] windows
    (util.clj:601-618).  Returns (start_op, stop_op_or_None) tuples."""
    intervals = []
    start = None
    for op in history:
        if op.process != "nemesis":
            continue
        if op.type != "info":
            continue
        if start is None:
            start = op
        else:
            intervals.append((start, op))
            start = None
    if start is not None:
        intervals.append((start, None))
    return intervals


class WithThreadName:
    """Temporarily rename the current thread (util.clj:527-534) so logs
    identify workers ('jepsen worker 3', 'jepsen nemesis')."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._old = threading.current_thread().name
        threading.current_thread().name = self.name
        return self

    def __exit__(self, *exc):
        threading.current_thread().name = self._old
        return False


def fcatch(f: Callable) -> Callable:
    """Wrap f so exceptions are returned instead of raised (util.clj:239)."""

    def wrapper(*a, **kw):
        try:
            return f(*a, **kw)
        except Exception as e:
            return e

    return wrapper


class WorkerAbort(Exception):
    """Raised in worker threads when the run is aborting."""


class AbortableBarrier:
    """A cyclic barrier whose waiters can be released by an abort event.

    The reference parks workers on CyclicBarriers and breaks them with
    thread interrupts (core.clj:204-245); Python threads can't be
    interrupted, so waiters poll an abort event while blocked.
    """

    def __init__(self, parties: int, abort_event=None):
        self.parties = parties
        self.abort_event = abort_event
        self._cond = threading.Condition()
        self._count = 0
        self._generation = 0
        self._aborted = False

    def abort(self) -> None:
        with self._cond:
            self._aborted = True
            self._cond.notify_all()

    def _is_aborted(self) -> bool:
        return self._aborted or (self.abort_event is not None
                                 and self.abort_event.is_set())

    def wait(self, poll: float = 0.05) -> None:
        with self._cond:
            if self._is_aborted():
                raise WorkerAbort("barrier aborted")
            gen = self._generation
            self._count += 1
            if self._count >= self.parties:
                self._count = 0
                self._generation += 1
                self._cond.notify_all()
                return
            while self._generation == gen and not self._is_aborted():
                self._cond.wait(poll)
            if self._is_aborted() and self._generation == gen:
                raise WorkerAbort("barrier aborted")


def random_nonempty_subset(coll):
    """A random non-empty subset of coll (util.clj random-nonempty-subset)."""
    import random as _r

    coll = list(coll)
    n = _r.randint(1, len(coll))
    return _r.sample(coll, n)
