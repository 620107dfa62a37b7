"""Applicability gates: the one home of the rules the partitioners
(``decompose/partition.py``), the cell schedulers
(``decompose/schedule.py``) and the streaming checker
(``stream/checker.py``) consume, so that a prediction and the engine
that executes it cannot drift.

So far only these gates and :func:`stream_plan`.  The plan explainer
that predicts a search without running it (``explain``,
``explain_batch``, ``render_plan`` and ``Linearizable(explain=True)``)
comes with the engine's remaining consumers, queue item A12 of
``ROADMAP.md``.
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


# ---------------------------------------------------------------------------
# the streaming gates (stream/checker.py consumes them)
# ---------------------------------------------------------------------------

#: model families whose segment folds can ride the device batch (the
#: state-pinning pseudo-ops of ``stream/device.py`` need a single-value
#: register)
STREAM_DEVICE_FAMILIES = ("register", "cas-register")

#: the host fold's cost cap: a closed segment predicted past it folds
#: on the device batch instead of the host sweep
STREAM_HOST_FOLD_MAX = 1 << 22

#: the bounded `:info` lookahead: after this many post-crash :ok rows
#: at a pseudo-quiescent point, the stream fork-checks the crashed
#: cell's open segment (each `:info` op present at any position vs
#: absent), so a kill-seeded violation flips the live verdict before
#: finalize.  0 turns it off
STREAM_INFO_LOOKAHEAD = 16

#: the flat fork cap the cost budget below is seeded from (6 pending
#: infos over a 64-row segment); :func:`info_fork_gate` still answers it
STREAM_INFO_FORK_MAX = 6

#: the fork check is admitted while ``n_infos * (segment_rows + 1)``
#: stays under this: the sub-search sweeps the open segment once per
#: carried state per placement, so infos times rows is its first-order
#: cost
STREAM_INFO_FORK_BUDGET = STREAM_INFO_FORK_MAX * 64

#: the `:info` ceiling whatever the segment's width: the device
#: encoding's crash dimension stops at 64 words of lanes
STREAM_INFO_FORK_HARD_MAX = 32


def info_fork_cost(n_infos: int, segment_rows: int) -> int:
    """The fork check's cost proxy: pending `:info` ops times the open
    segment's rows (+1, so an empty segment still prices each info)."""
    return max(0, n_infos) * (max(0, segment_rows) + 1)


def info_fork_budget(n_infos: int, segment_rows: int, *,
                     budget: int | None = None) -> bool:
    """May the stream fork ``n_infos`` pending `:info` ops over a
    ``segment_rows``-row open segment?  Narrow segments afford more
    pending infos, wide ones fewer, never more than
    :data:`STREAM_INFO_FORK_HARD_MAX`."""
    cap = STREAM_INFO_FORK_BUDGET if budget is None else budget
    if not 0 < n_infos <= STREAM_INFO_FORK_HARD_MAX:
        return False
    return info_fork_cost(n_infos, segment_rows) <= cap


def info_fork_gate(n_infos: int, *, fork_max: int | None = None) -> bool:
    """The width-free predicate: may the stream fork this many pending
    `:info` ops at the characteristic segment width?"""
    cap = STREAM_INFO_FORK_MAX if fork_max is None else fork_max
    return 0 < n_infos <= cap


def segment_fold_cost(n_rows: int, window: int) -> int:
    """The host fold's cost proxy for one crash-free segment: rows times
    the window's interleaving factor (``segment_states`` is a level
    sweep whose frontier is bounded by 2^(window-1) per position)."""
    return (n_rows + 1) << min(max(window - 1, 0), 40)


def segment_fold_route(n_rows: int, window: int, model, *,
                       host_fold_max: int | None = None) -> str:
    """``"host"`` or ``"device"`` for one closed streaming segment: the
    device needs the register family and a predicted host cost past the
    cap; everything else folds on the host."""
    if model.name not in STREAM_DEVICE_FAMILIES:
        return "host"
    cap = STREAM_HOST_FOLD_MAX if host_fold_max is None else host_fold_max
    return "device" if segment_fold_cost(n_rows, window) > cap else "host"


def stream_plan(seq: OpSeq, model, *, host_fold_max: int | None = None,
                info_lookahead: int | None = None) -> dict:
    """Would the streaming checker pay off on this history, and how
    would it route?  Cut density, segment sizes, rows until the first
    closed segment (the time-to-first-verdict proxy), the host/device
    split of the closed segments and the `:info` lookahead's gate, from
    the same cut primitive (:func:`quiescence_cuts`) and routing rule
    (:func:`segment_fold_route`) the stream executes."""
    from ..decompose.partition import partition_by_key, subseq
    from ..history import max_concurrency

    cells_map, cell_model, early = (None, model, None)
    if key_partition_applies(model):
        cells_map, cell_model, early = partition_by_key(seq, model)
    cells = list(cells_map.values()) if cells_map else [seq]
    if cell_model is None:
        cell_model = model

    horizon = STREAM_INFO_LOOKAHEAD if info_lookahead is None \
        else max(0, int(info_lookahead))
    seg_rows: list[int] = []
    routes = {"host": 0, "device": 0}
    ttfv_rows = None
    crashed_cells = info_rows = spec_checks = 0
    forkable = True
    fork_cost_max = 0
    for cseq in cells:
        n = len(cseq)
        if n == 0:
            continue
        cuts = quiescence_cuts(cseq)
        bounds = [0, *cuts.tolist(), n]
        infos = int((~cseq.ok).sum())
        if infos:
            crashed_cells += 1
            info_rows += infos
            # the fork check sweeps the rows past the last cut: the
            # stream's open segment
            open_rows = bounds[-1] - bounds[-2]
            fork_cost_max = max(fork_cost_max,
                                info_fork_cost(infos, open_rows))
            if not info_fork_budget(infos, open_rows):
                forkable = False
            elif horizon:
                # one fork check per horizon of post-crash ok rows
                first = int(np.argmax(~cseq.ok))
                spec_checks += int(cseq.ok[first:].sum()) // horizon
        if len(cuts) and (ttfv_rows is None or int(cuts[0]) < ttfv_rows):
            ttfv_rows = int(cuts[0])
        for i in range(len(bounds) - 1):
            rows = bounds[i + 1] - bounds[i]
            seg_rows.append(rows)
            if i < len(bounds) - 2:  # closed segments fold mid-stream
                w = max_concurrency(
                    subseq(cseq, np.arange(bounds[i], bounds[i + 1])))
                routes[segment_fold_route(
                    rows, w, cell_model,
                    host_fold_max=host_fold_max)] += 1
    n_cells = max(1, len(cells))
    n_rows = max(1, len(seq))
    closed = sum(routes.values())
    return {
        "applies": closed > 0 and early is not False,
        "cells": n_cells,
        "segments": len(seg_rows),
        "closed_segments": closed,
        "cut_density": round(closed / n_rows, 4),
        "expected_segment_rows": {
            "mean": round(sum(seg_rows) / len(seg_rows), 2)
            if seg_rows else 0,
            "max": max(seg_rows) if seg_rows else 0,
        },
        "ttfv_rows": ttfv_rows,
        "routes": routes,
        "device_eligible": cell_model.name in STREAM_DEVICE_FAMILIES,
        "info_lookahead": {
            "horizon": horizon,
            "fork_max": STREAM_INFO_FORK_MAX,
            "fork_budget": STREAM_INFO_FORK_BUDGET,
            "fork_cost_max": fork_cost_max,
            "crashed_cells": crashed_cells,
            "info_rows": info_rows,
            "forkable": forkable,
            "speculative_checks": spec_checks,
        },
    }


def schedule_weight(seq: OpSeq) -> int:
    """The cell schedulers' cost proxy for largest-first ordering: the
    row count."""
    return len(seq)
