"""Independent keys: one workload over many keys, checked key by key
(jepsen's ``independent.clj``).

Values of a keyed history are ``[k v]`` tuples (:class:`KV`); the
checker splits the history into one subhistory per key and requires
each to be valid.  When the lifted checker is the linearizability
checker, all keys above its host threshold go through one
:func:`~.checker.linearizable.search_batch` on the card, where the
fused kernel runs every key's slice in one grid launch; the reference's
bounded parallel map serves every other checker.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Iterable

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


class IndependentChecker(Checker):
    """A checker over values lifted to ``[k v]`` histories: valid iff
    every key's subhistory is.  ``"unknown"`` keys are not failures.
    ``telemetry`` (None: on) goes to the batch's ``search_batch``."""

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

        chk = self.checker
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
            batch = search_batch([seqs[i] for i in big], model,
                                 budget=chk.budget, device=chk.device,
                                 telemetry=self.telemetry)
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
