"""Harness self-test fixtures — in-process fake DB and client.

Reference: jepsen/src/jepsen/tests.clj — `noop-test` (12-25), the base
test map suites merge into, and `atom-db`/`atom-client` (27-56): a
CAS register backed by an in-process atom, letting the whole runner +
checker stack execute with zero cluster infrastructure (Tier 2 of the
test strategy, SURVEY.md §4).
"""

from __future__ import annotations

import threading
from dataclasses import replace

from . import checker as checker_mod
from . import client as client_mod
from . import db as db_mod
from . import generator as gen
from . import nemesis as nemesis_mod
from . import net as net_mod
from . import os as os_mod


def noop_test() -> dict:
    """Boring test stub (tests.clj:12-25)."""
    return {
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "name": "noop",
        "os": os_mod.noop,
        "db": db_mod.noop,
        "net": net_mod.iptables,
        "client": client_mod.noop,
        "nemesis": nemesis_mod.noop,
        "generator": gen.void,
        "checker": checker_mod.unbridled_dionysus,
    }


class AtomRegister:
    """The shared atom: a lock-protected register."""

    def __init__(self, value=None):
        self.value = value
        self.lock = threading.Lock()

    def read(self):
        with self.lock:
            return self.value

    def write(self, v):
        with self.lock:
            self.value = v

    def cas(self, cur, new) -> bool:
        with self.lock:
            if self.value == cur:
                self.value = new
                return True
            return False


class AtomDB(db_mod.DB):
    """Resets the atom on setup (tests.clj:27-32)."""

    def __init__(self, state: AtomRegister):
        self.state = state

    def setup(self, test, node):
        self.state.write(0)

    def teardown(self, test, node):
        self.state.write("done")


class AtomClient(client_mod.Client):
    """CAS client over the atom (tests.clj:34-56)."""

    def __init__(self, state: AtomRegister):
        self.state = state

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        # keyed (independent) workloads travel values as [key value]
        # tuples; the completion must carry the SAME keyed shape, or
        # every other key's subhistory inherits this op's completion as
        # an orphan (un-keyed ops pass the key filter) — the silent
        # mis-pairing the history linter (analyze/lint.py, H002) flags.
        # Real clients do exactly this re-wrap (e.g. etcdemo's reads).
        from . import independent

        v = op.value
        key = None
        if independent.is_tuple(v):
            key, v = v.key, v.value
        if op.f == "write":
            self.state.write(v)
            return replace(op, type="ok")
        if op.f == "cas":
            cur, new = v
            return replace(op, type="ok" if self.state.cas(cur, new)
                           else "fail")
        if op.f == "read":
            val = self.state.read()
            if key is not None:
                return replace(op, type="ok",
                               value=independent.tuple_(key, val))
            return replace(op, type="ok", value=val)
        raise ValueError(f"unknown op {op.f!r}")


def atom_db(state: AtomRegister) -> AtomDB:
    return AtomDB(state)


def atom_client(state: AtomRegister) -> AtomClient:
    return AtomClient(state)
