"""Atom demo suite — the whole stack with zero cluster infrastructure.

Promotes the jepsen.tests/atom-db fixture (tests.clj:27-56) into a
runnable suite: independent-key CAS registers over an in-process map of
atoms, checked by the linearizability checker (the device search on the card).  This is
SURVEY.md §7 step 5 ("minimum end-to-end slice") as a user-facing
entry point:

    python -m jepsen_tpu_torch.suites.atomdemo test --dummy --time-limit 10
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod,
                fixtures, generator as gen, independent, nemesis)
from ..checker import linearizable as lin, perf as perf_mod, timeline
from ..models import cas_register


class AtomMapClient(client_mod.Client):
    """Per-key CAS registers over a shared dict of AtomRegisters.

    ``latency`` (seconds) delays each reply by a uniform draw in
    ``[0, latency]`` after the op has applied, as a network's reply leg
    would: replies then arrive out of the order the ops applied in, so
    completion order alone no longer witnesses a key.  0 (the default)
    replies at once."""

    def __init__(self, registers=None, lock=None, latency: float = 0.0):
        self.registers = registers if registers is not None else {}
        self.lock = lock or threading.Lock()
        self.latency = latency
        self._rng = random.Random()

    def open(self, test, node):
        return self

    def _reg(self, k):
        with self.lock:
            return self.registers.setdefault(k, fixtures.AtomRegister(0))

    def invoke(self, test, op):
        out = self._apply(op)
        if self.latency > 0:
            time.sleep(self._rng.uniform(0, self.latency))
        return out

    def _apply(self, op):
        k, v = op.value.key, op.value.value
        reg = self._reg(k)
        if op.f == "read":
            return replace(op, type="ok",
                           value=independent.tuple_(k, reg.read()))
        if op.f == "write":
            reg.write(v)
            return replace(op, type="ok")
        if op.f == "cas":
            old, new = v
            return replace(op, type="ok" if reg.cas(old, new) else "fail")
        raise ValueError(f"unknown f {op.f!r}")


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def _naturals():
    k = 0
    while True:
        yield k
        k += 1


def atom_test(opts: dict) -> dict:
    rate = opts.get("rate", 50)
    group = opts.get("group_size", 2)
    conc = opts.get("concurrency", 4)
    conc -= conc % group  # groups must divide concurrency
    return fixtures.noop_test() | dict(opts) | {
        "name": "atomdemo",
        "concurrency": max(group, conc),
        "client": AtomMapClient(latency=opts.get("latency", 0) / 1000),
        "nemesis": nemesis.noop,
        "model": cas_register(0),
        "checker": checker_mod.compose({
            "perf": perf_mod.perf(),
            "workload": independent.checker(checker_mod.compose({
                "linear": lin.linearizable(),
                "timeline": timeline.timeline(),
            })),
        }),
        "generator": gen.time_limit(
            opts.get("time_limit", 10),
            gen.clients(gen.stagger(
                1.0 / rate,
                independent.concurrent_generator(
                    group, _naturals(),
                    lambda k: gen.limit(opts.get("ops_per_key", 50),
                                        gen.mix([r, w, cas])))))),
    }


def add_opts(p):
    p.add_argument("-r", "--rate", type=float, default=50)
    p.add_argument("--ops-per-key", type=int, default=50)
    p.add_argument("--group-size", type=int, default=2)
    p.add_argument("--latency", type=float, default=0,
                   help="delay each reply by up to this many ms after its "
                   "op applies (default 0)")


def main(argv=None):
    cli.main(cli.single_test_cmd(atom_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
