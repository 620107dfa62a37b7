"""The shard bench tier: the bucket-then-shard scheduler
(:func:`.bucket.search_batch_sharded_bucketed`) against the fused
single-shape sharded batch, on a mixed-size key set over a
``ShardMesh``.  The counterpart of the JAX package's
``checker/shard_bench.py``; its mesh is a ``distributed.ShardMesh``
(by default eight logical shards of the card, the JAX package's device
count), its shards run B1's grid form on the card, and it writes only
where its caller says.

Its gates:

  * **parity**: the bucketed verdicts equal the fused route's key for
    key, and a sample equals the host oracle's;
  * **padding efficiency**: the bucketed route's useful/padded row
    ratio, the mesh's pad lanes billed, beside the fused shape's;
  * **no steady-state build**: the measured laps re-run the warm lap's
    shapes, and the kernel cache's miss counter does not move;
  * **warm-boot round trip**: ``fleet.warmup.shapes_from_trace`` over
    this run's own trace rebuilds the sharded slice-function set
    exactly, so ``warm_boot`` on those shapes builds nothing;
  * **explain match**: the live ``shard_batch`` stats equal
    ``analyze.plan.explain_batch(n_devices=)``'s prediction field for
    field.
"""

from __future__ import annotations

import json
import os
import random
import tempfile
import time

#: oracle re-checks sweep the whole config space of a key: a sample
_PARITY_SAMPLE = 6

#: the per-bucket and batch-wide ``shard_batch`` fields that must equal
#: ``explain_batch(..., n_devices=)``'s
_EXPLAIN_BUCKET_FIELDS = ("searched", "dims", "lanes", "pad_lanes",
                          "useful_ops", "padded_ops")
_EXPLAIN_TOTAL_FIELDS = ("n_buckets", "greedy", "hb_decided",
                         "constraint_decided", "hard", "useful_ops",
                         "padded_ops", "fused_padded_ops")

#: the run's span buffer (``obs.set_run``), written to ``trace_path``
_RUN = "shard-tier"


def _mk_keys(*, n_small: int, n_big: int, small_ops: int, big_ops: int,
             seed0: int):
    """The mixed-size key set: many small keys and a few big ones, each
    with a corrupted read, so that none is disposed of by the greedy
    witness (the tier measures the device path's padding)."""
    from ..history import encode_ops
    from ..models import cas_register
    from ..synth import corrupt_read, register_history

    model = cas_register()
    seqs = []
    for k in range(n_small + n_big):
        rng = random.Random(seed0 + k)
        n_ops = small_ops if k < n_small else big_ops
        h = register_history(rng, n_ops=n_ops, n_procs=6, overlap=4)
        h = corrupt_read(rng, h, at=0.85)
        seqs.append(encode_ops(h, model.f_codes))
    return seqs, model


def _stats_match_plan(sb: dict, plan: dict) -> tuple[bool, list]:
    """The live ``shard_batch`` stats against ``explain_batch(...,
    n_devices=)``, field for field: (equal, the differing fields)."""
    diffs = []
    for f in _EXPLAIN_TOTAL_FIELDS:
        if sb.get(f) != plan.get(f):
            diffs.append({"field": f, "live": sb.get(f),
                          "plan": plan.get(f)})
    live_b, plan_b = sb.get("buckets", []), plan.get("buckets", [])
    if len(live_b) != len(plan_b):
        diffs.append({"field": "len(buckets)", "live": len(live_b),
                      "plan": len(plan_b)})
    else:
        for i, (lb, pb) in enumerate(zip(live_b, plan_b)):
            for f in _EXPLAIN_BUCKET_FIELDS:
                if lb.get(f) != pb.get(f):
                    diffs.append({"field": f"buckets[{i}].{f}",
                                  "live": lb.get(f), "plan": pb.get(f)})
    return not diffs, diffs


def run_shard_tier(*, quick: bool = False, mesh=None,
                   out_path: str | None = None,
                   trace_path: str | None = None) -> dict:
    """The tier at the JAX package's size: 40 keys of 74 ops and 8 of
    240 (16 of 74 and 4 of 120 with ``quick``) over ``mesh`` (a
    ``ShardMesh``; None: ``ShardMesh(["cuda:0"] * 8)``).  Returns the
    numbers; writes them to ``out_path`` and the run's trace to
    ``trace_path`` when given."""
    from .. import obs as _obs
    from ..distributed import ShardMesh

    if mesh is None:
        mesh = ShardMesh(["cuda:0"] * 8)
    was_on, run0 = _obs.enabled(), _obs.current_run()
    _obs.enable(True)
    _obs.drop_recorder(_RUN)
    _obs.set_run(_RUN)
    try:
        out = _run_shard_tier(quick, mesh)
        if trace_path is not None:
            _obs.write_trace(trace_path, _RUN)
    finally:
        _obs.set_run(run0)
        _obs.drop_recorder(_RUN)
        _obs.enable(was_on)
    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


def _run_shard_tier(quick: bool, mesh) -> dict:
    from .. import obs as _obs
    from ..analyze.plan import explain_batch
    from ..fleet.warmup import shapes_from_trace, warm_boot
    from ..obs import metrics as obs_metrics
    from . import linearizable as lin
    from . import seq as oracle

    device = mesh.devices[0]
    n_dev = mesh.size
    if quick:
        n_small, n_big, small_ops, big_ops = 16, 4, 74, 120
    else:
        # sized so each power-of-two bucket packs tight: 74-op keys put
        # about 56 useful rows under 64+32 padded, 240-op keys about 177
        # under 256+32, about 0.59 useful/padded against the fused 0.26
        n_small, n_big, small_ops, big_ops = 40, 8, 74, 240
    budget = 1_500_000
    seqs, model = _mk_keys(n_small=n_small, n_big=n_big,
                           small_ops=small_ops, big_ops=big_ops,
                           seed0=31000)
    out: dict = {
        "metric": "shard tier: bucket-then-shard vs fused mesh batch",
        "quick": quick, "n_devices": n_dev,
        "device": str(lin._resolve_device(device)),
        "n_keys": len(seqs),
        "mix": {"small": [n_small, small_ops], "big": [n_big, big_ops]},
    }

    # -- the warm lap: every slice function built once ---------------------
    t0 = time.perf_counter()
    lin.search_batch(seqs, model, budget=budget, sharding=mesh, audit=False)
    wall_warm_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    lin.search_batch(seqs, model, budget=budget, sharding=mesh,
                     bucket=False, audit=False)
    wall_warm_f = time.perf_counter() - t0
    out["warm_lap"] = {"bucketed_wall_s": round(wall_warm_b, 3),
                       "fused_wall_s": round(wall_warm_f, 3)}

    # -- the warm-boot round trip: the trace's compile spans rebuild the
    # sharded slice-function set (no fresh build) -------------------------
    with tempfile.TemporaryDirectory(prefix="shard-bench-") as td:
        mid = _obs.write_trace(os.path.join(td, "trace_mid.json"), _RUN)
        with open(mid) as f:
            shapes = shapes_from_trace(json.load(f))
    out["warmup"] = warm_boot(shapes, device=device)
    out["warmup_shapes"] = {"total": len(shapes),
                            "sharded": sum(1 for s in shapes if s.shards)}

    # -- the measured laps: the same work on a warm cache ------------------
    misses0 = lin.KERNEL_CACHE_STATS["misses"]
    t0 = time.perf_counter()
    got_b = lin.search_batch(seqs, model, budget=budget, sharding=mesh,
                             audit=True)
    wall_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_f = lin.search_batch(seqs, model, budget=budget, sharding=mesh,
                             bucket=False, audit=True)
    wall_f = time.perf_counter() - t0
    out["steady_state_compile_misses"] = (
        lin.KERNEL_CACHE_STATS["misses"] - misses0)

    sb = got_b[0].get("shard_batch") or {}
    out["bucketed"] = {
        "wall_s": round(wall_b, 3),
        "padding_efficiency": sb.get("padding_efficiency"),
        "n_buckets": sb.get("n_buckets"),
        "pad_keys": sb.get("pad_keys"),
        "shard_map": sb.get("shard_map"),
        "overflow_redo": sb.get("overflow_redo"),
        "kernel_cache": sb.get("kernel_cache"),
        "buckets": sb.get("buckets"),
    }
    out["fused_counterfactual"] = {
        "wall_s": round(wall_f, 3),
        "padded_ops": sb.get("fused_padded_ops"),
        "padding_efficiency": sb.get("fused_padding_efficiency"),
    }
    out["speedup_vs_fused"] = round(wall_f / wall_b, 3) if wall_b else None

    # -- parity: bucketed against fused key for key, the oracle sampled ----
    parity = all(rb["valid"] == rf["valid"] for rb, rf in zip(got_b, got_f))
    sample = random.Random(11).sample(range(len(seqs)),
                                      min(_PARITY_SAMPLE, len(seqs)))
    for i in sample:
        want = oracle.check_opseq(seqs[i], model, dpor=False)["valid"]
        if got_b[i]["valid"] != want:
            parity = False
            out.setdefault("parity_diffs", []).append(
                {"key": i, "bucketed": got_b[i]["valid"], "oracle": want})
    out["parity"] = parity
    out["parity_oracle_sampled"] = len(sample)

    # -- the closed loop: prediction == observation ------------------------
    plan = explain_batch(seqs, model, n_devices=n_dev, device=device)
    match, diffs = _stats_match_plan(sb, plan)
    out["explain_match"] = match
    if diffs:
        out["explain_diffs"] = diffs[:16]

    out["derived_stats"] = {
        k: v for k, v in
        obs_metrics.derived_stats(obs_metrics.REGISTRY).items()
        if k in ("shard_padding_efficiency", "bucket_padding_efficiency",
                 "kernel_cache_hit_ratio", "device_idle_fraction")}
    return out
