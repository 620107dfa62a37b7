"""Decomposition applicability gates: the one home of the rules the
partitioners (``decompose/partition.py``) and the cell schedulers
(``decompose/schedule.py``) consume.

So far only these gates.  The plan explainer that predicts a search
without running it (``explain``, ``explain_batch``, ``render_plan`` and
``Linearizable(explain=True)``) comes with the engine's remaining
consumers, queue item A12 of ``ROADMAP.md``.
"""

from __future__ import annotations

import numpy as np

from ..history import NIL, OpSeq
from ..models import R_READ, R_WRITE


def key_partition_applies(model) -> bool:
    """Herlihy-Wing locality applies to the multi-register model: each
    key's projection checks on its own as a single register."""
    return model.name == "multi-register"


def value_block_gate(seq: OpSeq, model):
    """Eligibility for the per-value block decomposition:
    ``(applies, reason, writes)``.  ``reason`` names the first
    disqualifier when ``applies`` is False; ``writes`` maps each written
    value to its row, reused by ``partition.value_block_verdict`` so the
    gate and the verdict cannot diverge.

    The class: a single-register model, every row :ok, only reads and
    writes, every written value distinct and not the initial value."""
    if model.name not in ("register", "cas-register"):
        return False, f"model {model.name!r} is not a single register", None
    if not bool(np.asarray(seq.ok).all()):
        return False, "crashed (:info) rows present", None
    n = len(seq)
    if n == 0:
        return True, None, {}
    f = np.asarray(seq.f)
    if not bool(np.isin(f, (R_READ, R_WRITE)).all()):
        return False, "non-read/write ops (cas or foreign codes)", None
    v1 = np.asarray(seq.v1)
    init = int(model.init[0])
    writes: dict[int, int] = {}  # value -> row
    for i in np.nonzero(f == R_WRITE)[0]:
        v = int(v1[i])
        if v == NIL:
            return False, "write of NIL", None
        if v == init:
            return False, "write of the initial value", None
        if v in writes:
            return False, f"duplicate write of value {v}", None
        writes[v] = int(i)
    return True, None, writes


def quiescence_cuts(seq: OpSeq) -> np.ndarray:
    """The rows where a quiescence cut lands (segment starts, 0
    excluded): every op before row i returned before row i invokes
    (``max(ret[..i-1]) < inv[i]``).  A crashed row's infinite return
    suppresses every later cut."""
    n = len(seq)
    if n <= 1:
        return np.zeros(0, dtype=np.int64)
    inv = np.asarray(seq.inv, dtype=np.int64)
    ret = np.asarray(seq.ret, dtype=np.int64)
    run_max = np.maximum.accumulate(ret)
    return np.nonzero(run_max[:-1] < inv[1:])[0] + 1


def schedule_weight(seq: OpSeq) -> int:
    """The cell schedulers' cost proxy for largest-first ordering: the
    row count."""
    return len(seq)
