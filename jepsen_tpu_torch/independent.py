"""Independent keys: one workload over many keys, checked key by key
(jepsen's ``independent.clj``).

Values of a keyed history are ``[k v]`` tuples (:class:`KV`).  The
generators (:func:`sequential_generator`, :func:`concurrent_generator`)
wrap each key's ops in them; the checker splits the history into one subhistory per key and requires
each to be valid.  When the lifted checker is the linearizability
checker, all keys above its host threshold go through one
:func:`~.checker.linearizable.search_batch` on the card, where the
fused kernel runs every key's slice in one grid launch; the reference's
bounded parallel map serves every other checker.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Iterable

from .checker.core import Checker, check_safe, merge_valid
from .history import Op
from .util import bounded_pmap


class KV:
    """A ``[k v]`` value, told apart from plain values: a plain tuple can
    be an op's value (a cas pair)."""

    __slots__ = ("key", "value")

    def __init__(self, key, value):
        self.key = key
        self.value = value

    def __iter__(self):
        yield self.key
        yield self.value

    def __eq__(self, other):
        return (isinstance(other, KV) and other.key == self.key
                and other.value == self.value)

    def __hash__(self):
        return hash((KV, self.key, self.value))

    def __repr__(self):
        return f"[{self.key!r} {self.value!r}]"


def tuple_(k, v) -> KV:
    return KV(k, v)


def is_tuple(v) -> bool:
    return isinstance(v, KV)


def history_keys(history: Iterable[Op]) -> list:
    """The distinct keys of a history's tuple values, in first-seen
    order."""
    seen: dict = {}
    for op in history:
        if is_tuple(op.value):
            seen.setdefault(op.value.key, None)
    return list(seen)


def subhistory(k, history: Iterable[Op]) -> list[Op]:
    """The ops of key ``k`` with their tuples unwrapped, and every op
    without a key (nemesis and logging ops)."""
    out = []
    for op in history:
        if not is_tuple(op.value):
            out.append(op)
        elif op.value.key == k:
            out.append(replace(op, value=op.value.value))
    return out


class SequentialGenerator:
    """Work through keys one at a time (independent.clj:31-64): build
    fgen(k1), emit its ops (values wrapped as [k1 v]) until exhausted,
    then move to k2, ..."""

    def __init__(self, keys: Iterable, fgen: Callable):
        import threading

        self._keys = iter(keys)
        self._fgen = fgen
        self._lock = threading.Lock()
        self._cur = None
        self._done = False
        self._advance()

    def _advance(self):
        k = next(self._keys, _SENTINEL := object())
        if k is _SENTINEL:
            self._cur = None
            self._done = True
        else:
            self._cur = (k, self._fgen(k))

    def op(self, test, process):
        from .generator import gen_op

        while True:
            with self._lock:
                if self._done:
                    return None
                k, g = self._cur
            op = gen_op(g, test, process)
            if op is not None:
                op = dict(op)
                op["value"] = KV(k, op.get("value"))
                return op
            with self._lock:
                if not self._done and self._cur is not None \
                        and self._cur[0] == k:
                    self._advance()


def sequential_generator(keys, fgen) -> SequentialGenerator:
    return SequentialGenerator(keys, fgen)


class ConcurrentGenerator:
    """n threads per key, groups working concurrently on distinct keys
    (independent.clj:66-220).  Worker threads are split into contiguous
    groups of n; each group runs fgen(k) for its current key with
    *threads* rebound to the group (so barriers inside sub-generators
    synchronize per-key), and pulls the next key when exhausted.  The
    nemesis never enters sub-generators."""

    def __init__(self, n: int, keys: Iterable, fgen: Callable):
        import threading

        assert n > 0 and isinstance(n, int)
        self.n = n
        self._keys = iter(keys)
        self._fgen = fgen
        self._lock = threading.Lock()
        self._active: list | None = None  # per-group [k, gen] or None
        self._group_threads: list | None = None

    def _init_state(self, test):
        from .generator import current_threads

        threads = [t for t in current_threads() if isinstance(t, int)]
        tc = len(threads)
        assert sorted(threads) == list(range(tc)), \
            "concurrent-generator expects integer threads 0..n-1"
        assert test["concurrency"] == tc, (
            f"expected test concurrency ({test['concurrency']}) to equal "
            f"the number of integer threads ({tc})")
        group_count = tc // self.n
        assert self.n <= tc, (
            f"with {tc} worker threads, cannot run a key with {self.n} "
            f"threads concurrently; raise concurrency to at least {self.n}")
        assert tc == self.n * group_count, (
            f"{tc} threads cannot be split into groups of {self.n}; "
            f"make concurrency a multiple of {self.n}")
        self._active = []
        for _ in range(group_count):
            k = next(self._keys, None)
            self._active.append(None if k is None else [k, self._fgen(k)])
        self._group_threads = [threads[i * self.n:(i + 1) * self.n]
                               for i in range(group_count)]

    def op(self, test, process):
        from .generator import gen_op, process_to_thread, with_threads

        with self._lock:
            if self._active is None:
                self._init_state(test)
        thread = process_to_thread(test, process)
        assert isinstance(thread, int), (
            f"only numeric worker threads may draw from "
            f"concurrent-generator, got {thread!r}")
        group = thread // self.n
        while True:
            with self._lock:
                pair = self._active[group]
            if pair is None:
                return None
            k, g = pair
            with with_threads(self._group_threads[group]):
                op = gen_op(g, test, process)
            if op is not None:
                op = dict(op)
                op["value"] = KV(k, op.get("value"))
                return op
            with self._lock:
                if self._active[group] is pair:
                    nk = next(self._keys, None)
                    self._active[group] = \
                        None if nk is None else [nk, self._fgen(nk)]


def concurrent_generator(n: int, keys, fgen) -> ConcurrentGenerator:
    return ConcurrentGenerator(n, keys, fgen)


class IndependentChecker(Checker):
    """A checker over values lifted to ``[k v]`` histories: valid iff
    every key's subhistory is.  ``"unknown"`` keys are not failures.
    ``telemetry`` (None: the test map's ``"telemetry"``, else on) goes
    to the batch's ``search_batch``."""

    def __init__(self, checker: Checker, *, batch_device: bool = True,
                 telemetry: bool | None = None):
        self.checker = checker
        self.batch_device = batch_device
        self.telemetry = telemetry

    def _device_batch(self, test, subhistories: dict) -> dict:
        """Keys up to the checker's host threshold on the host, the rest
        in one ``search_batch`` on the checker's device; an invalid key
        is checked again on its own, for the host confirmation and the
        report."""
        from .checker.linearizable import search_batch
        from .history import encode_ops

        chk = self.checker.resolved(test)
        model = chk.model or test.get("model")
        keys = list(subhistories)
        seqs = [encode_ops(subhistories[k], model.f_codes) for k in keys]
        small = {i for i, s in enumerate(seqs)
                 if len(s) <= chk.host_threshold}
        results: dict = {}
        for i in sorted(small):
            results[keys[i]] = check_safe(chk, test, subhistories[keys[i]])
        big = [i for i in range(len(keys)) if i not in small]
        if big:
            # the batch follows the test map's settings, not the lifted
            # checker's arguments, as the JAX package's follows its
            # JEPSEN_TPU_* variables
            knobs = {k: test.get(k) for k in ("lint", "audit", "hb", "dpor",
                                              "telemetry")}
            if self.telemetry is not None:
                knobs["telemetry"] = self.telemetry
            batch = search_batch([seqs[i] for i in big], model,
                                 budget=chk.budget, device=chk.device,
                                 **knobs)
            for i, r in zip(big, batch):
                if r["valid"] is False:
                    results[keys[i]] = check_safe(
                        chk, test, subhistories[keys[i]])
                else:
                    results[keys[i]] = r
        return results

    def check(self, test, history, opts=None):
        from .checker.linearizable import Linearizable

        ks = history_keys(history)
        subs = {k: subhistory(k, history) for k in ks}
        if self.batch_device and isinstance(self.checker, Linearizable):
            results = self._device_batch(test, subs)
        else:
            vals = bounded_pmap(
                lambda k: check_safe(self.checker, test, subs[k],
                                     (opts or {}) | {"history_key": k}),
                ks)
            results = dict(zip(ks, vals))
        failures = [k for k, r in results.items()
                    if r.get("valid") in (False, None)]
        return {"valid": merge_valid(r.get("valid")
                                     for r in results.values()),
                "results": results, "failures": failures}


def checker(sub: Checker, *, batch_device: bool = True,
            telemetry: bool | None = None) -> Checker:
    return IndependentChecker(sub, batch_device=batch_device,
                              telemetry=telemetry)
