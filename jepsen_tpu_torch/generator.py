"""Workload generation — the composable generator DSL (reference L3).

Reference: jepsen/src/jepsen/generator.clj.  A generator is a stateful
object with one method ``op(test, process) -> op-dict | None`` (protocol at
generator.clj:23-24); None means exhausted.  Generators are demand-driven:
each worker thread repeatedly asks the (shared) generator tree for its next
operation, so generators may sleep to pace the test and may block on
barriers to synchronize phases.  Ops are plain dicts here ({"type":
"invoke", "f": ..., "value": ...}); workers fill in :process and :time
(the reference does the same — generator.clj:6-8).

Anything can act as a generator (generator.clj:40-52): a dict constantly
yields itself; a callable is invoked with (test, process) or no args; None
is exhausted.  Use :func:`gen_op` to pull from any such object.

Thread context: the dynamic var ``*threads*`` (generator.clj:52-58) — the
sorted collection of worker threads a generator subtree serves — becomes a
thread-local binding stack managed by :func:`with_threads`; `on`/`reserve`
rebind it so barriers inside subtrees count only their own threads.
"""

from __future__ import annotations

import random as _random
import threading
import time
from typing import Any, Callable, Iterable, Optional

from .util import sleep_seconds

OpDict = dict


class Generator:
    """Base class; subclasses override op(test, process)."""

    def op(self, test: dict, process) -> Optional[OpDict]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# dynamic *threads* binding (generator.clj:52-67)
# ---------------------------------------------------------------------------

_ctx = threading.local()


def sort_processes(ps: Iterable) -> list:
    """Numeric processes ascending, then named ones (knossos
    history/sort-processes ordering: workers first, :nemesis last)."""
    nums = sorted(p for p in ps if isinstance(p, int))
    names = sorted((p for p in ps if not isinstance(p, int)), key=str)
    return nums + names


def current_threads() -> list:
    t = getattr(_ctx, "threads", None)
    if t is None:
        raise RuntimeError("no *threads* binding; use with_threads(...)")
    return t


class with_threads:
    """Bind the ordered thread collection for the duration of a block
    (generator.clj:60-67).  Asserts the collection is sorted."""

    def __init__(self, threads: list):
        threads = list(threads)
        assert threads == sort_processes(threads), \
            f"threads not sorted: {threads}"
        self.threads = threads

    def __enter__(self):
        self._old = getattr(_ctx, "threads", None)
        _ctx.threads = self.threads
        return self

    def __exit__(self, *exc):
        _ctx.threads = self._old
        return False


def process_to_thread(test: dict, process):
    """process mod concurrency for ints; names pass through
    (generator.clj:69-74)."""
    if isinstance(process, int):
        return process % test["concurrency"]
    return process


def process_to_node(test: dict, process):
    """The node this process is likely talking to (generator.clj:76-83)."""
    thread = process_to_thread(test, process)
    if isinstance(thread, int):
        nodes = test["nodes"]
        return nodes[thread % len(nodes)]
    return None


# ---------------------------------------------------------------------------
# lifting plain objects into generators (generator.clj:40-52)
# ---------------------------------------------------------------------------


def gen_op(gen, test: dict, process) -> Optional[OpDict]:
    """Pull one operation from anything generator-like."""
    if gen is None:
        return None
    if hasattr(gen, "op") and callable(gen.op):
        return gen.op(test, process)
    if isinstance(gen, dict):
        return dict(gen)  # constantly yields (a copy of) itself
    if callable(gen):
        return gen(test, process) if _arity_two(gen) else gen()
    return gen


import weakref

# Keyed by weakref so entries die with the callable; an id()-keyed cache
# can hand a new function a dead function's arity after id reuse.
_ARITY_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _compute_arity_two(f) -> bool:
    import inspect

    try:
        sig = inspect.signature(f)
        pos = [p for p in sig.parameters.values()
               if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        var = any(p.kind == p.VAR_POSITIONAL
                  for p in sig.parameters.values())
        required = [p for p in pos if p.default is p.empty]
        return var or (len(required) <= 2 and len(pos) >= 2)
    except (ValueError, TypeError):
        return True


def _arity_two(f) -> bool:
    """Can f be called with (test, process)?  (The reference dispatches on
    ArityException, generator.clj:46-52; we inspect the signature.)"""
    try:
        hit = _ARITY_CACHE.get(f)
        if hit is None:
            hit = _compute_arity_two(f)
            _ARITY_CACHE[f] = hit
        return hit
    except TypeError:  # not weak-referenceable; compute uncached
        return _compute_arity_two(f)


class InvalidOp(Exception):
    pass


class StreamLinter:
    """Emit-time well-formedness guard over a live generator stream.

    The post-run history linter (analyze/lint.py) finds a double-invoke
    hours after the generator emitted it; this catches the same defects
    AT THE MOMENT OF EMISSION, naming the offending generator, so a
    broken custom generator fails its first op instead of poisoning a
    whole run's history.  Tracks per-process open ops from the emitted
    stream (completions are closed by the worker via
    :meth:`on_complete`); raises the SAME stable diagnostics as the
    post-run linter:

      * H001 — a generator emitted an invoke for a process whose
        previous op is still open (single-threaded-process invariant,
        core.clj:387-404);
      * H002 — a generator emitted a completion-typed op for a process
        with no open invoke.

    Installed by ``core.prepare_test`` under ``test["__stream_lint__"]``
    unless the test map's ``lint`` is False (the ``lint=`` the post-run
    linter takes);
    nemesis emissions (:info journal entries, core.clj:315-327) are
    exempt exactly as there.  Thread-safe: workers share one instance.
    """

    def __init__(self):
        self._open: dict = {}  # process -> f of the open invoke
        self._lock = threading.Lock()

    def on_emit(self, op: OpDict, process, gen) -> None:
        if not isinstance(process, int):
            return  # nemesis journals :info events freely
        t = op.get("type", "invoke")  # workers apply the same default
        from .analyze.lint import Diagnostic, HistoryLintError

        with self._lock:
            if t == "invoke":
                prev = self._open.get(process)
                if prev is not None:
                    raise HistoryLintError([Diagnostic(
                        "H001", "error",
                        f"generator {gen!r} emitted invoke "
                        f"{op.get('f')!r} for process {process} while "
                        f"its {prev!r} op is still open (live stream "
                        f"lint; single-threaded-process invariant, "
                        f"core.clj:387-404)",
                        process=process, f=op.get("f"))])
                self._open[process] = op.get("f")
            elif t in ("ok", "fail", "info"):
                if process not in self._open:
                    raise HistoryLintError([Diagnostic(
                        "H002", "error",
                        f"generator {gen!r} emitted {t!r} completion "
                        f"for process {process} with no open invoke "
                        f"(live stream lint)",
                        process=process, f=op.get("f"))])
                del self._open[process]
            # unknown types fall through to the post-run linter's H003

    def on_complete(self, process) -> None:
        """The worker closed this process's op (any completion type —
        an :info retires the process id entirely)."""
        with self._lock:
            self._open.pop(process, None)


def op_and_validate(gen, test, process) -> Optional[OpDict]:
    """Ops must be None or dicts (generator.clj:26-35); with the live
    stream linter installed (``test["__stream_lint__"]``), emissions
    are additionally checked for H001/H002 at emit time."""
    op = gen_op(gen, test, process)
    if op is not None and not isinstance(op, dict):
        raise InvalidOp(f"generator {gen!r} produced non-map op {op!r}")
    if op is not None and isinstance(test, dict):
        linter = test.get("__stream_lint__")
        if linter is not None:
            linter.on_emit(op, process, gen)
    return op


class _Fn(Generator):
    def __init__(self, f):
        self.f = f

    def op(self, test, process):
        return self.f(test, process)


# ---------------------------------------------------------------------------
# combinators
# ---------------------------------------------------------------------------


class _Void(Generator):
    def op(self, test, process):
        return None


void = _Void()


class FMap(Generator):
    """Rename :f values via a mapping (generator.clj:90-98); used to wire a
    workload's op names onto a composed nemesis."""

    def __init__(self, f_map: dict | Callable, gen):
        self.f_map = f_map if callable(f_map) else \
            (lambda f, m=dict(f_map): m.get(f, f))
        self.gen = gen

    def op(self, test, process):
        op = gen_op(self.gen, test, process)
        if op is None:
            return None
        op = dict(op)
        op["f"] = self.f_map(op.get("f"))
        return op


f_map = FMap


class DelayFn(Generator):
    """Each op takes (f)() extra seconds (generator.clj:111-117)."""

    def __init__(self, f: Callable[[], float], gen):
        self.f = f
        self.gen = gen

    def op(self, test, process):
        sleep_seconds(self.f())
        return gen_op(self.gen, test, process)


def delay(dt: float, gen) -> Generator:
    return DelayFn(lambda: dt, gen)


def stagger(dt: float, gen) -> Generator:
    """Uniform random delay, mean dt, range [0, 2dt)
    (generator.clj:159-163)."""
    return DelayFn(lambda: _random.uniform(0, 2 * dt), gen)


def next_tick_nanos(anchor: int, dt: int, now: int | None = None) -> int:
    """Next instant after `now` separated from anchor by a multiple of dt
    (generator.clj:119-127)."""
    if now is None:
        now = time.monotonic_ns()
    return now + (dt - (now - anchor) % dt)


class DelayTil(Generator):
    """Emit ops as close as possible to multiples of dt from an epoch —
    aligns invocations across threads "for triggering race conditions"
    (generator.clj:134-157)."""

    def __init__(self, dt: float, gen, precache: bool = True):
        self.anchor = time.monotonic_ns()
        self.dt = int(dt * 1e9)
        self.gen = gen
        self.precache = precache

    def _sleep_til(self, t):
        while time.monotonic_ns() + 10_000 < t:
            sleep_seconds((t - time.monotonic_ns()) / 1e9)

    def op(self, test, process):
        if self.precache:
            op = gen_op(self.gen, test, process)
            self._sleep_til(next_tick_nanos(self.anchor, self.dt))
            return op
        self._sleep_til(next_tick_nanos(self.anchor, self.dt))
        return gen_op(self.gen, test, process)


delay_til = DelayTil


def sleep(dt: float) -> Generator:
    """dt seconds of nothing (generator.clj:165-168)."""
    return delay(dt, void)


class Once(Generator):
    """Invoke the underlying generator at most once
    (generator.clj:170-177)."""

    def __init__(self, gen):
        self.gen = gen
        self._lock = threading.Lock()
        self._emitted = False

    def op(self, test, process):
        with self._lock:
            if self._emitted:
                return None
            self._emitted = True
        return gen_op(self.gen, test, process)


once = Once


class Derefer(Generator):
    """Resolve a generator lazily at op time (generator.clj:179-189)."""

    def __init__(self, fgen: Callable[[], Any]):
        self.fgen = fgen

    def op(self, test, process):
        return gen_op(self.fgen(), test, process)


derefer = Derefer


class LogEvery(Generator):
    def __init__(self, msg):
        self.msg = msg

    def op(self, test, process):
        import logging

        logging.getLogger("jepsen").info(self.msg)
        return None


def log_every(msg) -> Generator:
    return LogEvery(msg)


def log(msg) -> Generator:
    """Log once, yield nil (generator.clj:198-201)."""
    return once(LogEvery(msg))


class Each(Generator):
    """A fresh copy of the underlying generator per process
    (generator.clj:203-228)."""

    def __init__(self, gen_fn: Callable[[], Any]):
        self.gen_fn = gen_fn
        self._gens: dict = {}
        self._lock = threading.Lock()

    def op(self, test, process):
        g = self._gens.get(process)
        if g is None:
            with self._lock:
                g = self._gens.setdefault(process, self.gen_fn())
        return gen_op(g, test, process)


each = Each


class Seq(Generator):
    """One op from the first generator, then the second, ... skipping
    exhausted ones immediately (generator.clj:231-243).  NB: unlike
    `concat`, this advances to the next generator after every op."""

    def __init__(self, coll: Iterable):
        self._iter = iter(coll)
        self._lock = threading.Lock()

    def op(self, test, process):
        while True:
            with self._lock:
                gen = next(self._iter, None)
            if gen is None:
                return None
            op = gen_op(gen, test, process)
            if op is not None:
                return op


seq = Seq


def _cycle(xs):
    import itertools

    return itertools.cycle(xs)


def start_stop(t1: float, t2: float) -> Generator:
    """sleep t1, :start, sleep t2, :stop, forever (generator.clj:245-251);
    the standard nemesis schedule."""
    return Seq(_cycle([sleep(t1), {"type": "info", "f": "start"},
                       sleep(t2), {"type": "info", "f": "stop"}]))


class Mix(Generator):
    """Uniform random choice among generators (generator.clj:253-262)."""

    def __init__(self, gens):
        self.gens = list(gens)

    def op(self, test, process):
        if not self.gens:
            return None
        return gen_op(_random.choice(self.gens), test, process)


mix = Mix


class _Cas(Generator):
    """Random read/write/cas mix over small ints (generator.clj:264-276)."""

    def op(self, test, process):
        r = _random.random()
        if r > 0.66:
            return {"type": "invoke", "f": "read", "value": None}
        if r > 0.33:
            return {"type": "invoke", "f": "write",
                    "value": _random.randrange(5)}
        return {"type": "invoke", "f": "cas",
                "value": (_random.randrange(5), _random.randrange(5))}


cas = _Cas()


class QueueGen(Generator):
    """Random enqueue (consecutive ints) / dequeue mix
    (generator.clj:279-290)."""

    def __init__(self):
        self._i = -1
        self._lock = threading.Lock()

    def op(self, test, process):
        if _random.random() < 0.5:
            with self._lock:
                self._i += 1
                return {"type": "invoke", "f": "enqueue", "value": self._i}
        return {"type": "invoke", "f": "dequeue", "value": None}


queue = QueueGen


class DrainQueue(Generator):
    """After the wrapped generator is exhausted, emit one dequeue per
    attempted enqueue (generator.clj:292-307)."""

    def __init__(self, gen):
        self.gen = gen
        self._outstanding = 0
        self._lock = threading.Lock()

    def op(self, test, process):
        op = gen_op(self.gen, test, process)
        if op is not None:
            if op.get("f") == "enqueue":
                with self._lock:
                    self._outstanding += 1
            return op
        with self._lock:
            self._outstanding -= 1
            if self._outstanding >= 0:
                return {"type": "invoke", "f": "dequeue", "value": None}
        return None


drain_queue = DrainQueue


class Limit(Generator):
    """At most n operations (generator.clj:309-316)."""

    def __init__(self, n: int, gen):
        self._life = n
        self.gen = gen
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            if self._life <= 0:
                return None
            self._life -= 1
        return gen_op(self.gen, test, process)


limit = Limit


class TimeLimit(Generator):
    """Ops until dt seconds elapse from the first request
    (generator.clj:318-329)."""

    def __init__(self, dt: float, gen):
        self.dt = dt
        self.gen = gen
        self._deadline = None
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            if self._deadline is None:
                self._deadline = time.monotonic() + self.dt
        if time.monotonic() <= self._deadline:
            return gen_op(self.gen, test, process)
        return None


time_limit = TimeLimit


class Filter(Generator):
    """Only ops satisfying f (generator.clj:331-341)."""

    def __init__(self, f: Callable[[OpDict], bool], gen):
        self.f = f
        self.gen = gen

    def op(self, test, process):
        while True:
            op = gen_op(self.gen, test, process)
            if op is None:
                return None
            if self.f(op):
                return op


filter = Filter  # noqa: A001 - mirrors the reference name


class On(Generator):
    """Forward to the source iff (f thread); rebinds *threads* to the
    matching subset (generator.clj:343-351)."""

    def __init__(self, f: Callable, source):
        self.f = f
        self.source = source

    def op(self, test, process):
        if not self.f(process_to_thread(test, process)):
            return None
        sub = [t for t in current_threads() if self.f(t)]
        with with_threads(sub):
            return gen_op(self.source, test, process)


on = On


class Reserve(Generator):
    """(reserve 5, writes, 10, cas, reads): thread-range partitioning
    with a default pool (generator.clj:353-396)."""

    def __init__(self, *args):
        assert args, "reserve needs a default generator"
        *pairs, self.default = args
        assert len(pairs) % 2 == 0, "reserve takes count/gen pairs + default"
        self.ranges = []  # [lower, upper, gen) in thread-index space
        n = 0
        for i in range(0, len(pairs), 2):
            count, gen = pairs[i], pairs[i + 1]
            self.ranges.append((n, n + count, gen))
            n += count
        self._n = n

    def op(self, test, process):
        threads = list(current_threads())
        thread = process_to_thread(test, process)
        idx = threads.index(thread)
        for lower, upper, gen in self.ranges:
            if idx < upper:
                with with_threads(threads[lower:upper]):
                    return gen_op(gen, test, process)
        with with_threads(threads[self._n:]):
            return gen_op(self.default, test, process)


reserve = Reserve


class Concat(Generator):
    """First non-nil op from the sources, in order
    (generator.clj:398-407)."""

    def __init__(self, *sources):
        self.sources = sources

    def op(self, test, process):
        for source in self.sources:
            op = gen_op(source, test, process)
            if op is not None:
                return op
        return None


concat = Concat


def nemesis(nemesis_gen, client_gen=None) -> Generator:
    """Route :nemesis to one generator, workers to another
    (generator.clj:410-418)."""
    if client_gen is None:
        return On(lambda t: t == "nemesis", nemesis_gen)
    return Concat(On(lambda t: t == "nemesis", nemesis_gen),
                  On(lambda t: t != "nemesis", client_gen))


def clients(client_gen) -> Generator:
    """Only clients (generator.clj:420-423)."""
    return On(lambda t: t != "nemesis", client_gen)


class Await(Generator):
    """Block every op until f returns (f runs once)
    (generator.clj:425-437)."""

    def __init__(self, f: Callable[[], Any], gen=None):
        self.f = f
        self.gen = gen
        self._lock = threading.Lock()
        self._ready = False

    def op(self, test, process):
        if not self._ready:
            with self._lock:
                if not self._ready:
                    self.f()
                    self._ready = True
        return gen_op(self.gen, test, process)


await_fn = Await


class Synchronize(Generator):
    """All of *threads* must arrive before any proceeds; synchronizes once
    (generator.clj:440-456).  Workers blocked here are released (with
    WorkerAbort) if the test aborts — the analog of the reference breaking
    barriers via thread interrupts (core.clj:204-245)."""

    def __init__(self, gen):
        self.gen = gen
        self._lock = threading.Lock()
        self._barrier = None
        self._clear = False

    def op(self, test, process):
        if not self._clear:
            from .util import AbortableBarrier

            with self._lock:
                if self._barrier is None and not self._clear:
                    self._barrier = AbortableBarrier(
                        len(current_threads()),
                        abort_event=test.get("__abort__"))
                barrier = self._barrier
            if not self._clear and barrier is not None:
                barrier.wait()
                self._clear = True
        return gen_op(self.gen, test, process)


synchronize = Synchronize


def phases(*generators) -> Generator:
    """Like concat, but all threads finish each phase before the next
    begins (generator.clj:458-462)."""
    return Concat(*[Synchronize(g) for g in generators])


def then(a, b) -> Generator:
    """b, synchronize, then a — backwards for pipeline composition
    (generator.clj:464-468)."""
    return Concat(b, Synchronize(a))


class SingleThreaded(Generator):
    """Exclusive lock around the underlying generator
    (generator.clj:470-477)."""

    def __init__(self, gen):
        self.gen = gen
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            return gen_op(self.gen, test, process)


singlethreaded = SingleThreaded


def barrier(gen) -> Generator:
    """When gen completes, synchronize, then nil (generator.clj:479-482)."""
    return then(void, gen)
