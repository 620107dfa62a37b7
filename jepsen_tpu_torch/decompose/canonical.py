"""Canonical forms of (sub-)histories: the event ranks, and the
dead-value quotient the engines' canonical-state dedup reads."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..history import INF_RET, NIL
from ..models import R_CAS, R_READ, R_WRITE

#: models whose semantics see values only through equality with each
#: other and with the initial value
RENAME_FAMILY = ("register", "cas-register")

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
