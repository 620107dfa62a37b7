"""Canonical forms of (sub-)histories: the verdict cache's key space,
and the dead-value quotient the engines' canonical-state dedup reads.

Two histories that differ only in what no engine can observe hash
alike, so one cached verdict covers both.  The engines read only
``(f, v1, v2, inv, ret, ok)`` per row and compare ``inv``/``ret`` by
order, so the canonical form drops the process column, erases event
indices down to dense ranks (crashed returns stay infinite), and, for
the single-register family, renames values by first appearance (a value
bijection fixing NIL commutes with read/write/cas legality).  The
model's identity (name, width, init) is part of the key; so is a
segment's set of input states.

The payload is the JAX package's byte for byte (``repr`` of the same
list of Python ints, strings and tuples), so a key computed by either
package is valid in the other, and so are their cache files.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from ..history import INF_RET, NIL
from ..models import R_CAS, R_READ, R_WRITE

#: models whose semantics see values only through equality with each
#: other and with the initial value: the value-renaming family
RENAME_FAMILY = ("register", "cas-register")

#: canonical id of "the initial value" under renaming (NIL stays NIL)
_INIT_ID = -2


class _Renamer:
    """First-appearance value interning; the identity when disabled."""

    def __init__(self, model, enabled: bool):
        self.enabled = enabled
        self._map: dict[int, int] = {}
        self._next = 0
        if enabled:
            # NIL (an unknown value, always legal to read) stays apart
            # from the initial value: an init of NIL constrains no read
            self._map[NIL] = NIL
            init = int(model.init[0])
            if init != NIL:
                self._map[init] = _INIT_ID

    def rename(self, v: int) -> int:
        if not self.enabled:
            return v
        r = self._map.get(v)
        if r is None:
            r = self._next  # fresh ids count up from 0
            self._next += 1
            self._map[v] = r
        return r

    def decode_states(self, states) -> list[tuple]:
        """Canonical state tuples (a cache hit's) back to real values."""
        if not self.enabled:
            return [tuple(s) for s in states]
        inv = {r: v for v, r in self._map.items()}
        return [tuple(inv[int(x)] for x in s) for s in states]

    def encode_states(self, states) -> list[list[int]]:
        """State tuples in canonical form, for the cache.  Every lane of
        a reachable state is the init value, NIL or a written value, all
        interned by the row scan already."""
        if not self.enabled:
            return [list(s) for s in sorted(states)]
        return sorted([self._map[int(x)] for x in s] for s in states)

#: a cutoff meaning "never dead": a crashed row compares the value, and
#: its comparison may linearize at any later point
NEVER_DEAD = 2**31 - 1


def event_ranks(inv, ret) -> tuple[list[int], list[int]]:
    """Dense ranks of a (sub-)history's own events; INF stays INF.

    The engines compare ``inv``/``ret`` by order only, so re-ranking
    changes no verdict."""
    inv = [int(x) for x in inv]
    ret = [int(x) for x in ret]
    events = sorted(set(inv) | {r for r in ret if r != INF_RET})
    rank = {e: i for i, e in enumerate(events)}
    return ([rank[i] for i in inv],
            [rank[r] if r != INF_RET else INF_RET for r in ret])


def canonical_payload(seq, model, instates=None) -> tuple[bytes, _Renamer]:
    """The canonical bytes of (history, model, input states), with the
    renamer, so a segment's caller encodes its output states (and
    decodes cached ones) under the same value map.  ``instates`` are
    interned before the rows: the map is a function of the key, not of
    which copy computed it."""
    ren = _Renamer(model, model.name in RENAME_FAMILY)
    parts: list = [model.name, model.state_width]
    if ren.enabled:
        # the init value is renamed away, but "unset" (NIL) stays a
        # different model from "starts at some value"
        parts.append("I" if int(model.init[0]) != NIL else "I=NIL")
    else:
        parts.append(tuple(model.init))
    if instates is not None:
        parts.append(tuple(
            tuple(ren.rename(int(x)) for x in s) for s in sorted(instates)))
    inv_r, ret_r = event_ranks(seq.inv, seq.ret)
    f = np.asarray(seq.f)
    v1 = np.asarray(seq.v1)
    v2 = np.asarray(seq.v2)
    ok = np.asarray(seq.ok)
    for i in range(len(seq)):
        parts.append((int(f[i]), ren.rename(int(v1[i])),
                      ren.rename(int(v2[i])), inv_r[i], ret_r[i],
                      bool(ok[i])))
    return repr(parts).encode(), ren


def canonical_key(seq, model, instates=None) -> str:
    """sha256 hex of the canonical form: the verdict cache's key."""
    payload, _ = canonical_payload(seq, model, instates)
    return hashlib.sha256(payload).hexdigest()


@dataclass
class DeadValues:
    """The observation-equivalence quotient of one register history.

    A register model sees a state value only through equality tests (a
    read of v, a cas expecting v).  Once every row comparing v is in the
    linearized past, states holding different dead values are
    bisimilar, so they rewrite to one ``token`` and merge in the
    engines' dedup before they are expanded apart.

    ``cutoffs[v]`` is the first determinate prefix position p from which
    v is dead (every det row comparing v sits at a position < p);
    :data:`NEVER_DEAD` when a crashed row compares v.  ``token`` is a
    value no row writes, compares or inits.  ``candidates`` are the
    values a reachable state can hold (init and write/cas targets)."""

    cutoffs: dict = field(default_factory=dict)
    token: int = 0
    candidates: frozenset = frozenset()

    def dead_at(self, value: int, prefix: int) -> bool:
        if value == self.token or value == NIL:
            # the token is canonical already; NIL states never fold (a
            # crashed cas may compare NIL at any later point)
            return False
        return prefix >= self.cutoffs.get(value, 0)

    def value_range(self) -> tuple[int, int]:
        """[lo, hi] over the candidate values only: the token and
        compared-only values lie outside by design."""
        vals = list(self.candidates) or [0]
        return min(vals), max(vals)


def dead_value_cutoffs(seq, model) -> DeadValues | None:
    """The dead-value quotient of a width-1 register-family history, or
    None out of scope (other models, NIL-only values, no room for a
    token).  Comparing rows: :ok or crashed reads of a concrete value
    and every cas (on its expected value)."""
    if model.name not in RENAME_FAMILY or model.state_width != 1:
        return None
    n = len(seq)
    if n == 0:
        return None
    f = np.asarray(seq.f)
    v1 = np.asarray(seq.v1)
    v2 = np.asarray(seq.v2)
    ok = np.asarray(seq.ok, dtype=bool)
    # det position of each row = count of ok rows before it
    det_pos = np.cumsum(ok) - ok.astype(np.int64)
    candidates: set[int] = set()
    init = int(model.init[0])
    if init != NIL:
        candidates.add(init)
    cutoffs: dict[int, int] = {}

    def compare(v: int, row: int) -> None:
        if v == NIL:
            return  # NIL states are never rewritten
        if not ok[row]:
            cutoffs[v] = NEVER_DEAD
        elif cutoffs.get(v, -1) != NEVER_DEAD:
            cutoffs[v] = max(cutoffs.get(v, 0), int(det_pos[row]) + 1)

    for i in range(n):
        fi = int(f[i])
        if fi == R_WRITE:
            if int(v1[i]) != NIL:
                candidates.add(int(v1[i]))
        elif fi == R_READ:
            compare(int(v1[i]), i)
        elif fi == R_CAS:
            compare(int(v1[i]), i)
            if int(v2[i]) != NIL:
                candidates.add(int(v2[i]))
        else:
            return None  # foreign op code
    if not candidates:
        return None  # states only ever hold NIL
    for v in candidates:
        cutoffs.setdefault(v, 0)
    token = max(max(cutoffs), max(candidates)) + 1
    if token >= NEVER_DEAD or token == NIL:
        return None  # no room for a fresh token
    return DeadValues(cutoffs=cutoffs, token=token,
                      candidates=frozenset(candidates))


def comparison_row_masks(seq, model):
    """The quotient in the DFS's exact form: per concrete value, the
    bitmask of rows comparing it.  A state value v rewrites to the token
    once ``masks.get(v, 0) & ~linearized == 0``.  Returns ``(masks,
    DeadValues)``, or None out of scope."""
    dv = dead_value_cutoffs(seq, model)
    if dv is None:
        return None
    f = np.asarray(seq.f)
    v1 = np.asarray(seq.v1)
    masks: dict[int, int] = {}
    for i in range(len(seq)):
        fi = int(f[i])
        if fi == R_READ or fi == R_CAS:
            v = int(v1[i])
            if v != NIL:
                masks[v] = masks.get(v, 0) | (1 << i)
    return masks, dv
