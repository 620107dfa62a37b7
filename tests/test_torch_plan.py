"""The port's static plan against the JAX package's: ``explain``,
``explain_batch`` (bucketed and, with ``n_devices``, sharded),
``render_plan``, the hb/constraints/dpor plan blocks and ``analyze``,
on the histories of the JAX package's own plan tests, with exact
equality (the plan is integer and string).  Then the closed loop: the
port's live batch stats against the plan, ``Linearizable(explain=True)``
against the JAX package's plan-only result, and the rule that a plan
moves no live metric and launches nothing.  The port runs with
``device="cpu"``; the JAX package's knobs are unset, so both run their
defaults."""

import math
import random

import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.analyze import analyze as j_analyze
from jepsen_tpu.analyze import constraints as jcons
from jepsen_tpu.analyze import dpor as jdpor
from jepsen_tpu.analyze import hb as jhb
from jepsen_tpu.analyze import plan as jplan
from jepsen_tpu.checker import linearizable as jlin
from jepsen_tpu.history import encode_ops as j_encode
from jepsen_tpu.history import invoke_op, ok_op
from jepsen_tpu.obs import telemetry as jtele
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.analyze import analyze as t_analyze
from jepsen_tpu_torch.analyze import constraints as tcons
from jepsen_tpu_torch.analyze import dpor as tdpor
from jepsen_tpu_torch.analyze import hb as thb
from jepsen_tpu_torch.analyze import plan as tplan
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import shard_bench as tsb
from jepsen_tpu_torch.distributed import ShardMesh
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.history import encode_ops as t_encode
from jepsen_tpu_torch.obs.metrics import REGISTRY

#: the JAX package's knobs the plan reads; unset, each is on
KNOBS = ("JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR", "JEPSEN_TPU_TELEMETRY",
         "JEPSEN_TPU_BATCH_BUCKETS", "JEPSEN_TPU_LINT", "JEPSEN_TPU_EXPLAIN")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    torch.set_num_threads(1)
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    # the JAX package caches its telemetry knob at the first read
    monkeypatch.setattr(jtele, "_forced", None)
    monkeypatch.setattr(jtele, "_env_on", None)


MODELS = {
    "cas-register": lambda: (jm.cas_register(), tm.cas_register()),
    "cas-register-1": lambda: (jm.cas_register(-1), tm.cas_register(-1)),
    "register": lambda: (jm.register(0), tm.register(0)),
    "multi-register-4": lambda: (jm.multi_register(4),
                                 tm.multi_register(4)),
    "unordered-queue-8": lambda: (jm.unordered_queue(8),
                                  tm.unordered_queue(8)),
    "unordered-queue-33": lambda: (jm.unordered_queue(33),
                                   tm.unordered_queue(33)),
    "mutex": lambda: (jm.mutex(), tm.mutex()),
}


def _port_ops(h):
    return [Op.from_dict(op.to_dict()) for op in h]


def _v2_style(keyed=False, with_cas=False):
    """A replicated/pgwire-shaped history (``test_analyze.py``)."""
    h = [invoke_op(0, "read", (7, None) if keyed else -1),
         ok_op(0, "read", (7, -1) if keyed else -1),
         invoke_op(1, "write", (7, 5) if keyed else 5),
         ok_op(1, "write", (7, 5) if keyed else 5),
         invoke_op(0, "read", (7, 5) if keyed else 5),
         ok_op(0, "read", (7, 5) if keyed else 5),
         invoke_op(2, "write", (9, 8) if keyed else 8),
         ok_op(2, "write", (9, 8) if keyed else 8)]
    if with_cas:
        h += [invoke_op(1, "cas", (8, 11)), ok_op(1, "cas", (8, 11))]
    return h


def _read_storm(n_readers=8, reads_each=4):
    """Concurrent same-value reads around sequential writes
    (``test_hb.py``)."""
    h = [invoke_op(0, "write", 1), ok_op(0, "write", 1),
         invoke_op(0, "write", 1), ok_op(0, "write", 1)]
    for _ in range(reads_each):
        h += [invoke_op(p, "read", 1) for p in range(1, n_readers + 1)]
        h += [ok_op(p, "read", 1) for p in range(1, n_readers + 1)]
    return h + [invoke_op(0, "write", 2), ok_op(0, "write", 2),
                invoke_op(1, "read", 1), ok_op(1, "read", 1)]


def _multi_register_writes():
    rng = random.Random(31)
    h = []
    for p in range(3):
        for i in range(6):
            k = rng.randrange(4)
            h += [invoke_op(p, "write", (k, p * 100 + i)),
                  ok_op(p, "write", (k, p * 100 + i))]
    return h


def _queue_round_trip():
    h = []
    for i in range(4):
        h += [invoke_op(i % 2, "enqueue", i + 1),
              ok_op(i % 2, "enqueue", i + 1)]
    for i in range(4):
        h += [invoke_op(i % 2, "dequeue", i + 1),
              ok_op(i % 2, "dequeue", i + 1)]
    return h


def _batch_key(k):
    """BASELINE config #3's key (``bench.make_batch_key``)."""
    rng = random.Random(f"bench-batch-{k}")
    h = js.register_history(rng, n_ops=128, n_procs=8, overlap=4,
                            crash_p=0.01, max_crashes=2, n_values=4)
    if k % 4 == 0:
        h = js.corrupt_read(rng, h, at=0.85)
    return h


def _fallback():
    rng = random.Random(4)
    h = js.register_history(rng, n_ops=400, n_procs=80, overlap=70,
                            crash_p=0.9, max_crashes=70)
    return js.corrupt_read(rng, h, at=0.5)


#: (name, model, the function that makes the history): the inputs of
#: the JAX package's plan tests (test_analyze.py:446-659,
#: test_hb.py:473, test_dpor.py:432, test_constraints.py:412/437)
HISTORIES = [
    ("batch-key-0", "cas-register", lambda: _batch_key(0)),
    ("greedy", "cas-register", lambda: js.register_history(
        random.Random(3), n_ops=60, n_procs=4, overlap=2, crash_p=0.0)),
    ("fallback", "cas-register", _fallback),
    ("value-blocks", "register", lambda: js.register_history(
        random.Random(21), n_ops=80, n_procs=6, overlap=5, crash_p=0.0,
        unique_writes=True, cas=False)),
    ("reused-values", "register", lambda: js.register_history(
        random.Random(22), n_ops=80, n_procs=8, overlap=8, crash_p=0.0,
        n_values=3, cas=False)),
    ("quiescent", "register", lambda: js.register_history(
        random.Random(23), n_ops=40, n_procs=3, overlap=1, crash_p=0.0,
        n_values=3, cas=False)),
    ("key-partition", "multi-register-4", _multi_register_writes),
    ("replicated", "cas-register-1", _v2_style),
    ("replicated-cas", "cas-register-1",
     lambda: _v2_style(with_cas=True)),
    ("pgwire-keyed", "cas-register-1", lambda: _v2_style(keyed=True)),
    ("queue", "unordered-queue-8", _queue_round_trip),
    ("analyze", "cas-register", lambda: js.sim_register_history(
        random.Random(41), n_ops=40, crash_p=0.1)),
    ("read-storm", "register", _read_storm),
    ("hb-decided", "register", lambda: js.register_history(
        random.Random(9), n_ops=40, n_procs=3, overlap=3, crash_p=0.0,
        cas=False, unique_writes=True)),
    ("dpor", "cas-register", lambda: js.register_history(
        random.Random(3), n_ops=30, n_procs=4, overlap=4, crash_p=0.1)),
    ("constraints-queue", "unordered-queue-33",
     lambda: js.sim_queue_history(random.Random(31), 20, 4)),
    ("constraints-register", "register",
     lambda: js.sim_register_history(random.Random(1), cas=False)),
    ("lock", "mutex", lambda: js.sim_mutex_history(
        random.Random(5), 30, 3, crash_p=0.1)),
]
IDS = [c[0] for c in HISTORIES]


def _pair(model_name, build):
    """(jax seq, jax model, port seq, port model) of one history."""
    jmodel, tmodel = MODELS[model_name]()
    h = build()
    return (j_encode(h, jmodel.f_codes), jmodel,
            t_encode(_port_ops(h), tmodel.f_codes), tmodel)


@pytest.mark.parametrize("name,model_name,build", HISTORIES, ids=IDS)
def test_explain_and_render_match_reference(name, model_name, build):
    js_, jmodel, ts_, tmodel = _pair(model_name, build)
    want = jplan.explain(js_, jmodel)
    got = tplan.explain(ts_, tmodel, device="cpu")
    assert got == want
    if name in RENDER_RAISES:
        return  # test_render_plan_takes_bounds_past_int64
    assert tplan.render_plan(got) == jplan.render_plan(want)


#: the histories whose plans the JAX package's ``render_plan`` cannot
#: print: their bounds pass 2**64, and its ``_log2`` takes them through
#: numpy, which raises
RENDER_RAISES = {"fallback"}


def test_render_plan_takes_bounds_past_int64():
    """A reference fault the port does not copy: on the crash-heavy
    history (70 crashed ops, bound ~2^112.8) the JAX package's
    ``render_plan`` raises ``TypeError``, so its
    ``Linearizable(explain=True)`` fails on it; the port prints the
    plan, each bound's log2 rounded as for smaller bounds."""
    js_, jmodel, ts_, tmodel = _pair("cas-register", _fallback)
    want = jplan.explain(js_, jmodel)
    with pytest.raises(TypeError):
        jplan.render_plan(want)
    text = tplan.render_plan(tplan.explain(ts_, tmodel, device="cpu"))
    hb = want["hb"]
    assert hb["pruned_upper_bound"] > 2 ** 64
    assert (f"pruned bound ~2^{round(math.log2(hb['pruned_upper_bound']), 1)}"
            f" of raw ~2^{round(math.log2(want['config_upper_bound']), 1)}"
            ) in text
    assert "config upper bound ~2^112.83" in text


@pytest.mark.parametrize("name,model_name,build", HISTORIES[:6],
                         ids=IDS[:6])
def test_plan_blocks_match_reference(name, model_name, build):
    """The three blocks called on their own, the hb and dpor blocks
    with and without a shared solve."""
    js_, jmodel, ts_, tmodel = _pair(model_name, build)
    raw = 1 << 40
    jres, tres = jhb.analyze_hb(js_, jmodel), thb.analyze_hb(ts_, tmodel)
    for share in (False, True):
        assert thb.plan_block(ts_, tmodel, raw, 0, 32,
                              hb_analysis=tres if share else None) == \
            jhb.plan_block(js_, jmodel, raw, 0, 32,
                           hb_analysis=jres if share else None)
        assert tdpor.plan_block(ts_, tmodel, raw,
                                hb_analysis=tres if share else None) == \
            jdpor.plan_block(js_, jmodel, raw,
                             hb_analysis=jres if share else None)
    assert tcons.plan_block(ts_, tmodel) == jcons.plan_block(js_, jmodel)


def test_explain_with_the_passes_off_matches_reference(monkeypatch):
    """``hb=False``, ``dpor=False`` and ``telemetry=False`` are the JAX
    package's knobs at 0; only the telemetry note, which names the
    argument in place of the knob, differs."""
    for k in ("JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR", "JEPSEN_TPU_TELEMETRY"):
        monkeypatch.setenv(k, "0")
    monkeypatch.setattr(jtele, "_env_on", None)
    for name, model_name, build in (HISTORIES[0], HISTORIES[15]):
        js_, jmodel, ts_, tmodel = _pair(model_name, build)
        want = jplan.explain(js_, jmodel)
        got = tplan.explain(ts_, tmodel, device="cpu", hb=False,
                            dpor=False, telemetry=False)
        assert got["telemetry"]["note"].startswith("telemetry=False")
        assert want["telemetry"]["note"].startswith("JEPSEN_TPU_TELEMETRY")
        got["telemetry"].pop("note"), want["telemetry"].pop("note")
        assert got == want, name
        assert not got["hb"]["enabled"] and not got["dpor"]["enabled"]
        assert not got["constraints"]["enabled"]


def test_explain_pins_the_frontier_and_the_host_threshold():
    js_, jmodel, ts_, tmodel = _pair(*HISTORIES[0][1:])
    for kw in ({"frontier": 256}, {"host_threshold": 1000}):
        assert tplan.explain(ts_, tmodel, device="cpu", **kw) == \
            jplan.explain(js_, jmodel, **kw)


def _batch_pairs(builds, model_name="cas-register"):
    jseqs, tseqs = [], []
    for b in builds:
        js_, jmodel, ts_, tmodel = _pair(model_name, b)
        jseqs.append(js_)
        tseqs.append(ts_)
    return jseqs, jmodel, tseqs, tmodel


def _wide():
    rng = random.Random(77)
    h = js.register_history(rng, n_ops=256, n_procs=16, overlap=12,
                            crash_p=0.0)
    return js.corrupt_read(rng, h, at=0.9)


def _queue_key(i):
    rng = random.Random(700 + i)
    h = js.sim_queue_history(rng, 20, 4, crash_p=0.0)
    return js.corrupt_dequeue(rng, h) if i % 2 else h


BATCHES = {
    "batch-keys": lambda: _batch_pairs(
        [lambda k=k: _batch_key(k) for k in range(12)] + [_wide]),
    "hard-key": lambda: _batch_pairs(
        [lambda k=k: _batch_key(k) for k in range(3)] + [_fallback]),
    "dpor-pair": lambda: _batch_pairs([HISTORIES[14][2]] * 2),
    "queues": lambda: _batch_pairs(
        [lambda i=i: _queue_key(i) for i in range(6)],
        "unordered-queue-33"),
}


@pytest.mark.parametrize("batch", sorted(BATCHES))
@pytest.mark.parametrize("n_devices", [None, 4])
def test_explain_batch_matches_reference(batch, n_devices):
    jseqs, jmodel, tseqs, tmodel = BATCHES[batch]()
    want = jplan.explain_batch(jseqs, jmodel, n_devices=n_devices)
    got = tplan.explain_batch(tseqs, tmodel, n_devices=n_devices,
                              device="cpu")
    assert got == want
    assert tplan.render_plan(got, batch=True) == \
        jplan.render_plan(want, batch=True)
    for hb in (False, True):
        assert tplan.explain_batch(tseqs, tmodel, hb=hb, device="cpu") == \
            jplan.explain_batch(jseqs, jmodel, hb=hb)


def _shard_keys(quick):
    n = (16, 4, 74, 120) if quick else (40, 8, 74, 240)
    kw = dict(n_small=n[0], n_big=n[1], small_ops=n[2], big_ops=n[3],
              seed0=31000)
    from jepsen_tpu.checker.shard_bench import _mk_keys as j_mk_keys

    return (*j_mk_keys(**kw), *tsb._mk_keys(**kw))


@pytest.mark.parametrize("quick,n_devices,buckets,totals", [
    (True, 4, [[64, 32, 32], [128, 32, 32]], (1249, 2176, 3200)),
    (False, 8, [[64, 32, 32], [256, 32, 32]], (3619, 6144, 13824)),
])
def test_shard_tier_plan_matches_reference(quick, n_devices, buckets,
                                           totals):
    """The shard tier's key sets: the port's sharded plan is the JAX
    package's, whose totals the committed BENCH_shard.json records for
    the full set (padding efficiency 0.589 against a fused 0.2618)."""
    jseqs, jmodel, tseqs, tmodel = _shard_keys(quick)
    want = jplan.explain_batch(jseqs, jmodel, n_devices=n_devices)
    got = tplan.explain_batch(tseqs, tmodel, n_devices=n_devices,
                              device="cpu")
    assert got == want
    assert sorted(b["dims"] for b in got["buckets"]) == buckets
    assert sum(b["pad_lanes"] for b in got["buckets"]) == 0
    assert (got["useful_ops"], got["padded_ops"],
            got["fused_padded_ops"]) == totals
    if not quick:
        assert (got["padding_efficiency"],
                got["fused_padding_efficiency"]) == (0.589, 0.2618)


def test_live_sharded_stats_match_the_reference_plan():
    """The closed loop on the CPU: the port's live bucket-then-shard
    batch over four logical shards bills what the JAX package's plan
    predicts, field for field (the JAX package's own mesh run fails on
    this image's jax, so its plan stands in)."""
    jseqs, jmodel, tseqs, tmodel = _shard_keys(True)
    plan = jplan.explain_batch(jseqs, jmodel, n_devices=4)
    res = tlin.search_batch(tseqs, tmodel, budget=1_500_000,
                            sharding=ShardMesh(["cpu"] * 4))
    sb = res[0]["shard_batch"]
    match, diffs = tsb._stats_match_plan(sb, plan)
    assert match, diffs
    assert (sb["n_buckets"], sb["useful_ops"], sb["padded_ops"],
            sb["fused_padded_ops"]) == (2, 1249, 2176, 3200)
    assert sb["padding_efficiency"] == plan["padding_efficiency"]


def test_live_bucketed_stats_match_the_plan():
    """The bucketed scheduler's stats against the plan without a mesh
    (``test_analyze.py``'s check, on fewer keys)."""
    jseqs, jmodel, tseqs, tmodel = _batch_pairs(
        [lambda k=k: _batch_key(k) for k in range(4)] + [_wide])
    plan = tplan.explain_batch(tseqs, tmodel, device="cpu")
    assert plan == jplan.explain_batch(jseqs, jmodel)
    res = tlin.search_batch(tseqs, tmodel, budget=50_000, bucket=True,
                            device="cpu")
    st = res[0]["bucket_batch"]
    for k in ("n_keys", "n_buckets", "greedy", "hard", "hb_decided",
              "constraint_decided"):
        assert plan[k] == st[k], k
    for f in ("n_keys", "dims", "padding_efficiency", "searched"):
        assert [b[f] for b in plan["buckets"]] == \
            [b[f] for b in st["buckets"]], f


def test_live_search_starts_at_the_planned_dims():
    """The device search starts at the plan's ``search_dims`` and takes
    the plan's route."""
    js_, jmodel, ts_, tmodel = _pair(*HISTORIES[0][1:])
    plan = tplan.explain(ts_, tmodel, device="cpu")
    seen = []
    run = tlin._run_kernel

    def spy(esp, es, model, dims, *a, **kw):
        seen.append(tplan._dims_dict(dims))
        return run(esp, es, model, dims, *a, **kw)

    tlin._run_kernel = spy
    try:
        r = tlin.search_opseq(ts_, tmodel, budget=500_000, device="cpu",
                              hb=False)
    finally:
        tlin._run_kernel = run
    assert plan["engine"] == "device-bfs" and r["engine"] == "device-bfs"
    assert seen[0] == plan["search_dims"]
    assert (r["window"], r["concurrency"]) == (plan["window"],
                                               plan["concurrency"])


def test_analyze_matches_reference():
    for h, jmodel, tmodel in (
            (js.sim_register_history(random.Random(41), n_ops=40,
                                     crash_p=0.1),
             jm.cas_register(), tm.cas_register()),
            ([invoke_op(0, "write", 1), invoke_op(0, "write", 2),
              ok_op(0, "write", 2)], jm.cas_register(), tm.cas_register())):
        want = j_analyze(h, jmodel)
        got = t_analyze(_port_ops(h), tmodel, device="cpu")
        assert [d.to_dict() for d in got["diagnostics"]] == \
            [d.to_dict() for d in want["diagnostics"]]
        assert (got["errors"], got["warnings"], got["plan"]) == \
            (want["errors"], want["warnings"], want["plan"])
    seq = t_encode(_port_ops(h), tmodel.f_codes)
    assert t_analyze(seq, None, device="cpu")["plan"] is None


def test_linearizable_explain_is_the_reference_plan_only_result(
        monkeypatch, capsys):
    """``Linearizable(explain=True)`` prints the plan and returns it as
    an "unknown" verdict, as the JAX package does, and searches
    nothing."""
    h = js.sim_register_history(random.Random(41), n_ops=40, crash_p=0.1)
    # a completion whose value drifts from its invocation's: a lint
    # warning (H006) rides the result
    h = [invoke_op(9, "write", 3), ok_op(9, "write", 4)] + h
    want = jlin.Linearizable(jm.cas_register(), explain=True).check({}, h)
    want_out = capsys.readouterr().out

    def refuse(*a, **kw):
        raise AssertionError("explain=True searched")

    for name in ("search_opseq", "check_competition", "search_batch"):
        monkeypatch.setattr(tlin, name, refuse)
    got = tlin.linearizable(tm.cas_register(), explain=True,
                            device="cpu").check({}, _port_ops(h))
    assert capsys.readouterr().out == want_out
    assert got == want
    assert got["valid"] == "unknown" and got["lint_warnings"]


def _live_metrics() -> dict:
    return {name: REGISTRY.get(name).snapshot() for name in (
        "jtpu_hb_prepass_total", "jtpu_hb_edges_total",
        "jtpu_hb_prune_ratio", "jtpu_constraint_prepass_total",
        "jtpu_constraint_edges_total", "jtpu_dpor_dup_edges_total",
        "jtpu_search_levels_total", "jtpu_bucket_ops_total")}


def test_a_plan_moves_no_live_metric():
    before = _live_metrics()
    for name, model_name, build in HISTORIES[12:17]:
        _, _, ts_, tmodel = _pair(model_name, build)
        tplan.explain(ts_, tmodel, device="cpu")
    _, _, tseqs, tmodel = BATCHES["batch-keys"]()
    tplan.explain_batch(tseqs, tmodel, device="cpu")
    tplan.explain_batch(tseqs, tmodel, n_devices=4, device="cpu")
    assert _live_metrics() == before


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, ts_, tmodel = _pair(*HISTORIES[0][1:])
    with pytest.raises(RuntimeError, match="cuda"):
        tplan.explain(ts_, tmodel)
    with pytest.raises(RuntimeError, match="cuda"):
        tplan.explain_batch([ts_], tmodel)
    with pytest.raises(RuntimeError, match="cuda"):
        t_analyze(ts_, tmodel)
    with pytest.raises(RuntimeError, match="cuda"):
        tlin.linearizable(tmodel, explain=True).check({}, ts_)
