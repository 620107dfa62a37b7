"""The port's shard bench tier (``checker/shard_bench.py``) on the CPU:
the quick tier over four logical CPU shards passes every gate of the
JAX package's tier (parity, no steady-state build, the warm-boot round
trip, the plan matching the live stats), bills the same rows as the
JAX package's plan of the same keys, and writes only where it is told.
The JAX package's own tier runs a mesh route that fails on this
image's jax, so its plan stands in for its numbers."""

import hashlib
import json
from pathlib import Path

import pytest
import torch

from jepsen_tpu.analyze import plan as jplan
from jepsen_tpu.checker import shard_bench as jsb
from jepsen_tpu_torch.checker import shard_bench as tsb
from jepsen_tpu_torch.distributed import ShardMesh

REPO = Path(__file__).resolve().parents[1]


def _digest() -> dict:
    """Every file at the repo's top level, by content."""
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in REPO.iterdir() if p.is_file()}


@pytest.fixture(scope="module")
def quick_tier(tmp_path_factory):
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("shard-tier")
    before = _digest()
    out = tsb.run_shard_tier(quick=True, mesh=ShardMesh(["cpu"] * 4),
                             out_path=str(d / "BENCH_shard.json"),
                             trace_path=str(d / "trace.json"))
    return out, d, before, _digest()


def test_quick_tier_passes_every_gate(quick_tier):
    out, _d, _before, _after = quick_tier
    assert out["parity"] is True and "parity_diffs" not in out
    assert out["parity_oracle_sampled"] == 6
    assert out["explain_match"] is True, out.get("explain_diffs")
    assert out["steady_state_compile_misses"] == 0
    w = out["warmup"]
    assert w["compiled"] == 0 and w["verified"] is True
    assert w["shapes"] == out["warmup_shapes"]["total"] > 0
    assert out["warmup_shapes"]["sharded"] > 0
    assert out["bucketed"]["shard_map"] is True
    assert out["n_devices"] == 4 and out["device"] == "cpu"


def test_quick_tier_bills_the_reference_plan(quick_tier):
    """The live stats equal the JAX package's plan of the same keys."""
    out = quick_tier[0]
    seqs, model = jsb._mk_keys(n_small=16, n_big=4, small_ops=74,
                               big_ops=120, seed0=31000)
    plan = jplan.explain_batch(seqs, model, n_devices=4)
    b = out["bucketed"]
    assert b["n_buckets"] == plan["n_buckets"] == 2
    assert b["padding_efficiency"] == plan["padding_efficiency"]
    assert out["fused_counterfactual"]["padded_ops"] == \
        plan["fused_padded_ops"] == 3200
    assert out["fused_counterfactual"]["padding_efficiency"] == \
        plan["fused_padding_efficiency"]
    assert [bk["dims"] for bk in b["buckets"]] == \
        [bk["dims"] for bk in plan["buckets"]]
    assert sum(bk["useful_ops"] for bk in b["buckets"]) == 1249
    assert sum(bk["padded_ops"] for bk in b["buckets"]) == 2176


def test_quick_tier_writes_only_where_told(quick_tier):
    out, d, before, after = quick_tier
    assert before == after  # BENCH_shard.json, BENCH_trace_shard.json
    assert sorted(p.name for p in d.iterdir()) == ["BENCH_shard.json",
                                                   "trace.json"]
    assert json.loads((d / "BENCH_shard.json").read_text()) == out
    trace = json.loads((d / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"shard.prep", "shard.device", "device.compile"} <= names
    # the JAX package's result shape, with the device named
    ref = json.loads((REPO / "BENCH_shard.json").read_text())
    assert set(out) - {"device"} == set(ref)


def test_stats_match_plan_names_every_difference():
    sb = {"n_buckets": 2, "greedy": 0, "hb_decided": 0,
          "constraint_decided": 0, "hard": 0, "useful_ops": 10,
          "padded_ops": 20, "fused_padded_ops": 30,
          "buckets": [{"searched": 4, "dims": [64, 32, 32], "lanes": 4,
                       "pad_lanes": 0, "useful_ops": 10,
                       "padded_ops": 20}]}
    plan = json.loads(json.dumps(sb))
    for a, b in ((sb, plan), (plan, sb)):
        assert tsb._stats_match_plan(a, b) == jsb._stats_match_plan(a, b)
    assert tsb._stats_match_plan(sb, plan) == (True, [])
    plan["buckets"][0]["pad_lanes"] = 1
    plan["fused_padded_ops"] = 31
    ok, diffs = tsb._stats_match_plan(sb, plan)
    assert not ok and diffs == jsb._stats_match_plan(sb, plan)[1]
    assert [x["field"] for x in diffs] == ["fused_padded_ops",
                                           "buckets[0].pad_lanes"]
    plan["buckets"].append(plan["buckets"][0])
    assert tsb._stats_match_plan(sb, plan)[1][-1]["field"] == \
        "len(buckets)"


def test_mk_keys_are_the_reference_keys():
    kw = dict(n_small=3, n_big=2, small_ops=74, big_ops=120, seed0=31000)
    jseqs, _ = jsb._mk_keys(**kw)
    tseqs, _ = tsb._mk_keys(**kw)
    for a, b in zip(jseqs, tseqs):
        for col in ("process", "f", "v1", "v2", "inv", "ret", "ok"):
            assert list(getattr(a, col)) == list(getattr(b, col))


def test_default_mesh_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tsb.run_shard_tier(quick=True)
