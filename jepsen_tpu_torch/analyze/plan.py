"""The static plan: predict the search without running it, and the
applicability gates the engines consume.

Everything the engines decide on the host before (or instead of) the
search follows from one cheap scan: the concurrency width, the
real-time window, the crash words, the quantized ``SearchDims``, the
shape bucket, the engine route and which decompositions apply.
:func:`explain` computes all of it for one history and
:func:`explain_batch` for a batch, with the bucketed scheduler's bucket
assignment (and with ``n_devices``, the mesh scheduler's pad lanes);
:func:`render_plan` prints either.  Each calls the engines' own
primitives (``encode_search``, ``choose_dims``, ``batch_dims``,
``bucket_key``, ``plan_buckets``, ``greedy_witness``) rather than
re-deriving them, and the gates below live here and are consumed by the
partitioners (``decompose/partition.py``), the cell schedulers
(``decompose/schedule.py``) and the streaming checker
(``stream/checker.py``), so that a prediction and the engine that
executes it cannot drift.

The first frontier follows the device (``choose_dims`` starts at 64
rows on the card, 16 on the host), so :func:`explain` takes the
``device`` the search would run on.  A plan launches nothing and moves
no live metric.
"""

from __future__ import annotations

import math

import numpy as np

from ..history import NIL, OpSeq, encode_ops
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


def independent_keys(seq: OpSeq, model):
    """The sorted keys of a jepsen.independent ``[k v]`` history encoded
    under a single-register model, or None.  ``encode_ops`` splits a
    pair value across (v1, v2), so a register write with a second lane
    can only be a keyed write (cas rows use v2 legitimately and are not
    looked at).  :func:`explain` reports the per-key route such a
    history takes instead of reading key lanes as values."""
    if model.name not in ("register", "cas-register"):
        return None
    f = np.asarray(seq.f)
    writes = f == R_WRITE
    if not bool(writes.any()):
        return None
    v2 = np.asarray(seq.v2)
    if not bool((v2[writes] != NIL).all()):
        return None
    v1 = np.asarray(seq.v1)
    keyed = np.isin(f, (R_READ, R_WRITE)) & (v1 != NIL)
    return sorted(int(k) for k in np.unique(v1[keyed]))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _dims_dict(dims) -> dict:
    return {"n_det_pad": dims.n_det_pad, "n_crash_pad": dims.n_crash_pad,
            "window": dims.window, "k": dims.k,
            "state_width": dims.state_width, "frontier": dims.frontier}


def _decompositions(seq: OpSeq, model) -> dict:
    """Which decompositions ``decompose/engine.py``'s funnel would
    apply, in its order: the key partition, then per cell the value
    blocks and the quiescence cuts."""
    from ..decompose.partition import partition_by_key

    out: dict = {}
    cells_map = None
    cell_model = model
    if key_partition_applies(model):
        cells_map, cell_model, early = partition_by_key(seq, model)
        out["key_partition"] = {
            "applies": True,
            "cells": len(cells_map) if cells_map else 0,
            "early_verdict": early,
        }
        if early is False or not cells_map:
            out["value_blocks"] = {"applies": False,
                                   "reason": "decided by key partition"}
            out["quiescence"] = {"applies": False, "segments": 1}
            return out
    else:
        out["key_partition"] = {"applies": False,
                                "reason": f"model {model.name!r} is not "
                                          f"multi-register"}
    cells = list(cells_map.values()) if cells_map else [seq]

    vb_cells = segs_total = cut_cells = 0
    vb_reason = None
    for cseq in cells:
        applies, reason, _writes = value_block_gate(cseq, cell_model)
        if applies:
            vb_cells += 1
        elif vb_reason is None:
            vb_reason = reason
        nsegs = len(quiescence_cuts(cseq)) + 1
        segs_total += nsegs
        if nsegs > 1:
            cut_cells += 1
    out["value_blocks"] = {"applies": vb_cells > 0,
                           "eligible_cells": vb_cells}
    if vb_reason is not None:
        out["value_blocks"]["reason"] = vb_reason
    out["quiescence"] = {"applies": segs_total > len(cells),
                         "segments": segs_total,
                         "cells_with_cuts": cut_cells}
    return out


def _telemetry_block(engine: str, telemetry: bool | None) -> dict:
    """Where the plan's predicted prune ratios will be observed: the
    device search's ``search_telemetry`` block, or the
    ``search.telemetry`` span of a history decided or routed on the
    host.  ``telemetry`` (None: on) is the flag the search would run
    with."""
    from ..obs.telemetry import resolve

    on = resolve(telemetry)
    out: dict = {"enabled": on}
    if on:
        out["observed_at"] = (
            "search_telemetry.observed_prune_ratio on device results "
            "(prune_ratio_delta vs the predicted ratio above)"
            if engine == "device-bfs" else
            "search.telemetry trace span (observed=0 for a "
            "statically decided / host-routed history)")
    else:
        out["note"] = ("telemetry=False: predictions will not be "
                       "observable on results")
    return out


def explain(history, model, *, frontier: int | None = None,
            host_threshold: int = 48, device="cuda",
            hb: bool | None = None, dpor: bool | None = None,
            telemetry: bool | None = None) -> dict:
    """The static plan of one history: what the engines would do.

    ``history`` is an event list or an encoded OpSeq.
    ``host_threshold`` is ``Linearizable``'s small-history host route;
    ``frontier`` pins the first frontier as ``choose_dims`` takes it,
    and otherwise the plan's ``search_dims`` are the ones the search on
    ``device`` starts at (a CUDA device without a card raises).  ``hb``,
    ``dpor`` and ``telemetry`` (None: on) are the flags the search would
    run with; they only set the blocks' ``enabled``."""
    from ..checker import linearizable as lin
    from ..checker.bucket import bucket_key
    from .constraints import plan_block as constraints_block
    from .dpor import plan_block as dpor_block
    from .hb import analyze_hb
    from .hb import plan_block as hb_block

    dev = lin._resolve_device(device)
    seq = history if isinstance(history, OpSeq) else \
        encode_ops(history, model.f_codes)
    es = lin.encode_search(seq)
    dims = lin.choose_dims(es, model, device=dev, frontier=frontier)

    greedy = lin.greedy_witness(seq, model)
    device_ok = es.window <= lin.MAX_WINDOW and es.n_crash <= lin.MAX_CRASH
    if es.n_det == 0 and es.n_crash == 0:
        engine = "trivial"
    elif greedy:
        engine = "greedy-witness"
    elif not device_ok:
        engine = "host-linear(fallback)"
    else:
        engine = "device-bfs"

    # distinct reachable configs, model state excluded: det prefix
    # position x window mask (its first bit is the prefix boundary) x
    # crash mask, what the frontier and budget cover at worst
    ub_log2 = max(0, es.window - 1) + es.n_crash
    upper = (es.n_det + 1) << ub_log2

    # one prepass solve shared by the hb and dpor blocks
    hbres = analyze_hb(seq, model) if len(seq) else None

    # a keyed composite under a register model routes per key: the
    # whole-history predictions below would read key lanes as values
    ind = independent_keys(seq, model)
    independent: dict = {"detected": ind is not None}
    if ind is not None:
        independent.update({
            "keys": len(ind),
            "route": "per-key demux (independent.checker post-hoc; "
                     "stream independent mode live)",
            "note": "whole-history dims/decomposition/hb predictions "
                    "below do not apply to a keyed composite — demux "
                    "first, then explain each key's subhistory",
        })

    return {
        "model": model.name,
        "independent": independent,
        "n_rows": len(seq),
        "n_det": es.n_det,
        "n_crash": es.n_crash,
        "window": es.window,
        "concurrency": es.concurrency,
        "crash_words": dims.crash_words,
        "config_words": dims.words,
        "search_dims": _dims_dict(dims),
        "bucket": list(bucket_key(es)),
        "greedy_witness": greedy,
        "device_eligible": device_ok,
        "host_threshold_route": len(seq) <= host_threshold,
        "engine": engine,
        "config_upper_bound": upper,
        "config_upper_bound_log2": round(
            ub_log2 + float(np.log2(max(1, es.n_det + 1))), 2),
        "hb": hb_block(seq, model, upper, es.n_crash, es.window,
                       hb_analysis=hbres, hb=hb),
        "constraints": constraints_block(seq, model, hb=hb),
        "dpor": dpor_block(seq, model, upper, hb_analysis=hbres, dpor=dpor),
        "decompositions": _decompositions(seq, model),
        "streaming": stream_plan(seq, model),
        "telemetry": _telemetry_block(engine, telemetry),
    }


def explain_batch(seqs: list[OpSeq], model, *, hb: bool | None = None,
                  dpor: bool | None = None, n_devices: int | None = None,
                  device="cuda") -> dict:
    """The static plan of a batch: each key's route and the bucketed
    scheduler's bucket assignment (``checker/bucket.py``'s
    ``plan_buckets`` over the same keys, merged down to
    ``bucket.MAX_BUCKETS``).

    It mirrors ``search_batch_bucketed``: the greedy witness and the
    prepass (``hb``, None: on) dispose of keys on the host, keys past
    the device encoding go to the host sweep, and the rest group into
    power-of-two buckets, each searched at its own tight dims.

    ``n_devices`` mirrors the mesh scheduler instead
    (``search_batch_sharded_bucketed`` over that many shards): the dims
    start at its frontier of 64, each bucket's lanes round up to the
    shard count (the inert pad lanes bill into ``padded_ops`` as the
    live ``shard_batch`` stats bill them), and the totals carry the
    fused single-shape counterfactual, so the plan compares field for
    field with the stats of the run.  ``dpor`` (None: on) is reported as
    the dpor block's ``enabled``; ``device`` is the one the batch would
    run on (a CUDA device without a card raises): the batch's dims do
    not depend on it."""
    from ..checker import linearizable as lin
    from ..checker.bucket import MAX_BUCKETS, bucket_key, plan_buckets
    from .constraints import analyze_prepass, family_of
    from .dpor import plan_block as dpor_block
    from .hb import resolve_hb

    lin._resolve_device(device)
    ess = [lin.encode_search(s) for s in seqs]
    hard, fit = [], []
    for i, e in enumerate(ess):
        (hard if e.window > lin.MAX_WINDOW
         or e.n_crash > lin.MAX_CRASH else fit).append(i)
    plans = plan_buckets([bucket_key(ess[i]) for i in fit], MAX_BUCKETS)
    plans = [[fit[p] for p in grp] for grp in plans]

    greedy = [i for i in range(len(seqs))
              if lin.greedy_witness(seqs[i], model)]
    greedy_set = set(greedy)
    # the prepass disposes of decided keys beside the greedy witness, by
    # the same solver the scheduler dispatches to (hb for registers, the
    # constraint compiler for queues and locks)
    hb_set: set[int] = set()
    constraint_set: set[int] = set()
    # the hb solver's analyses, kept for the dpor block (one solve per
    # key); the constraint compiler's do not fit its shape
    analyses: dict[int, object] = {}
    hb_solver = family_of(model) is None
    if resolve_hb(hb):
        for i in range(len(seqs)):
            if i in greedy_set:
                continue
            a = analyze_prepass(seqs[i], model)
            if hb_solver:
                analyses[i] = a
            if a.decided is not None:
                (constraint_set
                 if a.stats.get("solver") == "constraints"
                 else hb_set).add(i)
    disposed = greedy_set | hb_set | constraint_set

    # the dpor block per undecided key, aggregated
    dpor_keys = [i for i in range(len(seqs)) if i not in disposed]
    per_key = [dpor_block(seqs[i], model,
                          (ess[i].n_det + 1)
                          << (max(0, ess[i].window - 1) + ess[i].n_crash),
                          hb_analysis=analyses.get(i), dpor=dpor)
               for i in dpor_keys]
    dedup_rates = [b["dedup"].get("hit_rate_prediction", 0.0)
                   for b in per_key if b["dedup"].get("applies")]
    dpor_plan = {
        "enabled": per_key[0]["enabled"] if per_key else True,
        "keys": len(dpor_keys),
        "masked_keys": sum(1 for b in per_key if b["masked_rows"]),
        "dedup_keys": sum(1 for b in per_key if b["dedup"].get("applies")),
        "dup_edges": sum(b["dup_edges"] for b in per_key),
        "mask_coverage": (round(sum(b["mask_coverage"] for b in per_key)
                                / len(per_key), 4) if per_key else 0.0),
        "dedup_hit_rate_prediction": (round(sum(dedup_rates)
                                            / len(dedup_rates), 4)
                                      if dedup_rates else 0.0),
        "sleep_set_bound": max((b["sleep_set_bound"] for b in per_key),
                               default=0),
    }
    frontier = 64 if n_devices else 32
    buckets = []
    useful_total = padded_total = 0
    run_all: list[int] = []
    for idxs in plans:
        run = [i for i in idxs if i not in disposed]
        dims = (lin.batch_dims([ess[i] for i in run], model,
                               frontier=frontier) if run else None)
        useful = sum(ess[i].n_det + ess[i].n_crash for i in run)
        lanes = (lin._round_up(len(run), n_devices)
                 if run and n_devices else len(run))
        padded = lanes * (dims.n_det_pad + dims.n_crash_pad) if run else 0
        useful_total += useful
        padded_total += padded
        run_all += run
        bk = {
            "keys": idxs,
            "n_keys": len(idxs),
            "searched": len(run),
            "dims": ([dims.n_det_pad, dims.window, dims.n_crash_pad]
                     if run else None),
            "useful_ops": useful,
            "padded_ops": padded,
            "padding_efficiency": (round(useful / padded, 4)
                                   if padded else None),
        }
        if n_devices:
            bk["lanes"] = lanes if run else 0
            bk["pad_lanes"] = (lanes - len(run)) if run else 0
        buckets.append(bk)
    out = {
        "n_keys": len(seqs),
        "n_buckets": len(plans),
        "bucketing": True,
        "greedy": len(greedy),
        "hb_decided": len(hb_set),
        "constraint_decided": len(constraint_set),
        "hard": len(hard),
        "hard_keys": hard,
        "dpor": dpor_plan,
        "buckets": buckets,
    }
    if n_devices:
        fused_padded = 0
        if run_all:
            fdims = lin.batch_dims([ess[i] for i in run_all], model,
                                   frontier=frontier)
            fused_padded = lin._round_up(len(run_all), n_devices) \
                * (fdims.n_det_pad + fdims.n_crash_pad)
        out.update({
            "n_devices": n_devices,
            "useful_ops": useful_total,
            "padded_ops": padded_total,
            "padding_efficiency": (round(useful_total / padded_total, 4)
                                   if padded_total else None),
            "fused_padded_ops": fused_padded or None,
            "fused_padding_efficiency": (
                round(useful_total / fused_padded, 4)
                if fused_padded else None),
        })
    return out


def _log2(x) -> float:
    # math.log2 takes ints of any size: a crash-heavy history's bounds
    # pass 2**64, where numpy's log2 raises TypeError
    return round(math.log2(max(1, int(x or 0))), 1)


def _render_batch(plan: dict) -> list[str]:
    lines = [f"batch plan: {plan['n_keys']} keys -> "
             f"{plan['n_buckets']} bucket(s), "
             f"{plan['greedy']} greedy-disposed, "
             f"{plan.get('hb_decided', 0)} hb-decided, "
             f"{plan.get('constraint_decided', 0)} constraint-decided, "
             f"{plan['hard']} host-fallback"]
    if plan.get("n_devices"):
        lines.append(
            f"  sharded over {plan['n_devices']} device(s): "
            f"padding_efficiency={plan.get('padding_efficiency')} "
            f"(fused counterfactual "
            f"{plan.get('fused_padding_efficiency')})")
    dp = plan.get("dpor")
    if dp:
        lines.append(
            f"  dpor: {'on' if dp.get('enabled') else 'OFF'}; "
            f"{dp.get('masked_keys', 0)}/{dp.get('keys', 0)} keys "
            f"device-masked ({dp.get('dup_edges', 0)} dup edges), "
            f"{dp.get('dedup_keys', 0)} dedup-eligible "
            f"(predicted hit-rate "
            f"{dp.get('dedup_hit_rate_prediction')}), sleep-set "
            f"bound {dp.get('sleep_set_bound')}")
    for b, bk in enumerate(plan["buckets"]):
        lines.append(
            f"  bucket {b}: {bk['n_keys']} keys, {bk['searched']} "
            f"searched, dims={bk['dims']}, "
            f"padding_efficiency={bk['padding_efficiency']}")
    return lines


def render_plan(plan: dict, *, batch: bool = False) -> str:
    """The plan as text (what ``Linearizable(explain=True)`` prints)."""
    if batch or "buckets" in plan:
        return "\n".join(_render_batch(plan))
    d = plan["search_dims"]
    lines = [
        f"plan: {plan['n_rows']} rows ({plan['n_det']} det, "
        f"{plan['n_crash']} crashed) under model {plan['model']!r}",
        f"  window={plan['window']} concurrency={plan['concurrency']} "
        f"crash_words={plan['crash_words']} "
        f"config_words={plan['config_words']}",
        f"  SearchDims: n_det_pad={d['n_det_pad']} "
        f"n_crash_pad={d['n_crash_pad']} window={d['window']} "
        f"k={d['k']} frontier={d['frontier']}",
        f"  bucket={tuple(plan['bucket'])} engine={plan['engine']}"
        + (" (greedy witness exists)" if plan["greedy_witness"] else ""),
        f"  config upper bound ~2^{plan['config_upper_bound_log2']}",
    ]
    dec = plan["decompositions"]
    kp, vb, qc = (dec["key_partition"], dec["value_blocks"],
                  dec["quiescence"])
    lines.append(
        "  decompositions: key-partition "
        + (f"applies ({kp.get('cells')} cells)" if kp["applies"]
           else "n/a")
        + "; value-blocks "
        + ("applies" if vb["applies"]
           else f"n/a ({vb.get('reason', '')})")
        + "; quiescence "
        + (f"applies ({qc['segments']} segments)" if qc["applies"]
           else "n/a"))
    ind = plan.get("independent")
    if ind and ind.get("detected"):
        lines.append(
            f"  KEYED COMPOSITE: {ind['keys']} independent key(s) — "
            f"engines route {ind['route']}; whole-history predictions "
            f"below are the un-demuxed counterfactual")
    hb = plan.get("hb")
    if hb:
        if not hb.get("applies"):
            line = f"n/a ({hb.get('reason')})"
        elif hb.get("decided") is not None:
            line = (f"DECIDES this history "
                    f"({'valid' if hb['decided'] else 'invalid'} via "
                    f"{hb.get('reason')}; no search needed)")
        else:
            line = (f"undecided; {hb.get('must_edges', 0)} must-order "
                    f"edge(s) {hb.get('edges')}, pruned bound "
                    f"~2^{_log2(hb.get('pruned_upper_bound', 0))} of "
                    f"raw ~2^{_log2(plan.get('config_upper_bound', 0))}"
                    f" (ratio {hb.get('prune_ratio')})")
        lines.append("  happens-before: " + line)
    cs = plan.get("constraints")
    if cs and cs.get("applies"):
        if cs.get("decided") is not None:
            line = (f"DECIDES this history "
                    f"({'valid' if cs['decided'] else 'invalid'} via "
                    f"{cs.get('reason')}; no search needed)")
        else:
            line = (f"undecided; {cs.get('must_edges', 0)} must-order "
                    f"edge(s) {cs.get('edges')}")
        sf = cs.get("stream_fold") or {}
        if sf.get("eligible"):
            line += f"; streamed fold route: {sf.get('route')}"
        lines.append(f"  constraints[{cs.get('family')}]: " + line)
    dp = plan.get("dpor")
    if dp:
        dd = dp.get("dedup", {})
        lines.append(
            f"  dpor: {'on' if dp.get('enabled') else 'OFF'}; "
            f"{dp.get('dup_edges', 0)} duplicate-op edge(s), "
            f"device-mask coverage {dp.get('mask_coverage')} "
            f"({dp.get('masked_rows', 0)} rows), dedup "
            + (f"applies ({dd.get('dead_values')}/{dd.get('values')} "
               f"values die; predicted hit-rate "
               f"{dd.get('hit_rate_prediction')})"
               if dd.get("applies") else "n/a")
            + f", sleep-set bound {dp.get('sleep_set_bound')}, "
              f"pruned bound ~2^{_log2(dp.get('pruned_upper_bound', 0))}")
    tl = plan.get("telemetry")
    if tl:
        lines.append(
            "  telemetry: "
            + (f"on — observed at {tl.get('observed_at')}"
               if tl.get("enabled") else f"off ({tl.get('note')})"))
    st = plan.get("streaming")
    if st:
        lines.append(
            "  streaming: "
            + ("applies" if st["applies"] else "n/a")
            + f" ({st['closed_segments']} closed segment(s), cut "
              f"density {st['cut_density']}, ttfv ~{st['ttfv_rows']} "
              f"rows, routes {st['routes']})")
    return "\n".join(lines)
