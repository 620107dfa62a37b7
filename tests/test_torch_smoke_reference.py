"""The reference numbers ``chip_smoke.py`` holds the card to, recomputed
by the JAX package on the CPU from the same histories: the bench tiers'
device search with the JAX package's defaults (``REFERENCE_REDUCED``,
``PREPASS_REASON``), the queue histories' verdicts (``QUEUES``), and
the batch256 keys' answers (``BATCH256_*``)."""

import pytest

import chip_smoke
import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import models as jm
from jepsen_tpu.checker import linear as jlinear
from jepsen_tpu.history import OpSeq
from test_torch_search import reference_defaults


def _jax(seq):
    """A port OpSeq as the JAX package's (the same columns)."""
    return OpSeq(process=seq.process, f=seq.f, v1=seq.v1, v2=seq.v2,
                 inv=seq.inv, ret=seq.ret, ok=seq.ok, ops=[], encoder=None)


@pytest.mark.parametrize("tier", ["mutex2k", "1k"])
def test_reduced_tier_reference(tier, monkeypatch):
    reference_defaults(monkeypatch)
    monkeypatch.setattr(lin, "_SLICE_TARGET_S", 1e9)
    seq, _model = chip_smoke.tier_history(tier)
    model = jm.mutex() if tier == "mutex2k" else jm.cas_register()
    out = lin.search_opseq(_jax(seq), model)
    assert (out["valid"], out["configs"], out["max_depth"]) == \
        chip_smoke.REFERENCE_REDUCED[tier]
    stats = out.get("hb") or out.get("constraints")
    want = chip_smoke.PREPASS_REASON[tier]
    if want is None:
        assert stats["decided"] is None
    else:
        assert stats["decided"] is False and stats["reason"] == want


@pytest.mark.parametrize("name,fifo,want", chip_smoke.QUEUES)
def test_queue_verdicts(name, fifo, want, monkeypatch):
    reference_defaults(monkeypatch)
    seq, model = chip_smoke.queue_history(name, fifo=fifo)
    assert model.state_width == 16
    jmodel = (jm.fifo_queue if fifo else jm.unordered_queue)(16)
    out = jlinear.check_opseq_linear(_jax(seq), jmodel)
    assert out["valid"] is want


def test_batch256_reference(monkeypatch):
    """The batch256 keys' per-key verdicts, configs and depths
    (``BATCH256_*``): the JAX package's ``search_batch`` with DPOR off."""
    reference_defaults(monkeypatch)
    keys, _model = chip_smoke.batch_keys()
    out = lin.search_batch([_jax(s) for s in keys], jm.cas_register(),
                           dpor=False)
    assert {k for k, r in enumerate(out) if r["valid"] is False} == \
        chip_smoke.BATCH256_INVALID
    assert all(r["valid"] is True for k, r in enumerate(out)
               if k not in chip_smoke.BATCH256_INVALID)
    assert tuple(r["configs"] for r in out) == chip_smoke.BATCH256_CONFIGS
    assert tuple(r["max_depth"] for r in out) == chip_smoke.BATCH256_DEPTH


def test_batch256_at64_reference(monkeypatch):
    """``BATCH256_AT64_CONFIGS``: the JAX package's ``search_batch`` with
    DPOR off on the batch256 keys at one fixed frontier of 64 rows, the
    sharded batch's shape; the other keys' configs, and every key's
    verdict and depth, as ``BATCH256_*``."""
    reference_defaults(monkeypatch)
    keys, _model = chip_smoke.batch_keys()
    keys = [_jax(s) for s in keys]
    model = jm.cas_register()
    dims = lin.batch_dims([lin.encode_search(s) for s in keys], model,
                          frontier=64)
    out = lin.search_batch(keys, model, dpor=False, dims=dims)
    assert {k: r["configs"] for k, r in enumerate(out)
            if r["configs"] != chip_smoke.BATCH256_CONFIGS[k]} == \
        chip_smoke.BATCH256_AT64_CONFIGS
    assert {k for k, r in enumerate(out) if r["valid"] is False} == \
        chip_smoke.BATCH256_INVALID
    assert tuple(r["max_depth"] for r in out) == chip_smoke.BATCH256_DEPTH


def test_batch256_decomposed_reference(monkeypatch, tmp_path):
    """``BATCH256_DECOMP_*``: the JAX package's ``search_batch`` with
    ``decompose=True`` (DPOR off) on the batch256 keys, a fresh cache
    file and then the same file again; every key's verdict, configs and
    depth as ``BATCH256_*``."""
    from jepsen_tpu.decompose.cache import VerdictCache

    reference_defaults(monkeypatch)
    keys, _model = chip_smoke.batch_keys()
    keys = [_jax(s) for s in keys]
    path = str(tmp_path / "verdicts.jsonl")
    out = lin.search_batch(keys, jm.cas_register(), dpor=False,
                           decompose=True,
                           decompose_cache=VerdictCache(path))
    assert out[0]["decompose_batch"] == chip_smoke.BATCH256_DECOMP_COLD
    assert {k for k, r in enumerate(out) if r["valid"] is False} == \
        chip_smoke.BATCH256_INVALID
    assert tuple(r["configs"] for r in out) == chip_smoke.BATCH256_CONFIGS
    assert tuple(r["max_depth"] for r in out) == chip_smoke.BATCH256_DEPTH
    again = lin.search_batch(keys, jm.cas_register(), dpor=False,
                             decompose=True,
                             decompose_cache=VerdictCache(path))
    assert again[0]["decompose_batch"] == chip_smoke.BATCH256_DECOMP_WARM
    assert [r["valid"] for r in again] == [r["valid"] for r in out]


def _jax_history(history):
    from jepsen_tpu.history import Op

    return [Op(op.process, op.type, op.f, op.value) for op in history]


@pytest.mark.parametrize("name", sorted(chip_smoke.MULTIREG256))
def test_multireg256_reference(name, monkeypatch, tmp_path):
    """``MULTIREG256``: the JAX package's decomposed ``Linearizable`` on
    the multireg256 history (in-process cells, host engines, a fresh
    cache file)."""
    reference_defaults(monkeypatch)
    history, model = chip_smoke.multireg_history(
        corrupt=name == "multireg256")
    assert len(history) == 2 * 256 * 128
    want_valid, want = chip_smoke.MULTIREG256[name]
    chk = lin.Linearizable(jm.multi_register(256), decompose=True,
                           verdict_cache=str(tmp_path / "v.jsonl"))
    out = chk.check({"name": name, "store_base": str(tmp_path)},
                    _jax_history(history))
    assert out["valid"] is want_valid
    assert out["decompose"] == want


@pytest.mark.parametrize("name", sorted(chip_smoke.MULTIREG256_DEVICE))
def test_multireg256_device_reference(name, monkeypatch):
    """``MULTIREG256_DEVICE``: the JAX package's
    ``check_opseq_decomposed(scheduler="device")`` on the multireg256
    history, DPOR off, as the card's kernel runs its cells."""
    from jepsen_tpu.decompose.engine import check_opseq_decomposed
    from jepsen_tpu.history import encode_ops

    reference_defaults(monkeypatch)
    monkeypatch.setenv("JEPSEN_TPU_DPOR", "0")
    history, _model = chip_smoke.multireg_history(
        corrupt=name == "multireg256")
    model = jm.multi_register(256)
    seq = encode_ops(_jax_history(history), model.f_codes)
    out = check_opseq_decomposed(seq, model, scheduler="device")
    want_valid, want = chip_smoke.MULTIREG256_DEVICE[name]
    assert out["valid"] is want_valid
    assert out["decompose"] == want


def test_shard_tier_plan_reference(monkeypatch):
    """``SHARD_TIER_PLAN``: the JAX package's static plan of the shard
    tier's full key set over 8 devices, which its committed
    BENCH_shard.json also records."""
    import json
    from pathlib import Path

    from jepsen_tpu.analyze.plan import explain_batch
    from jepsen_tpu.checker.shard_bench import _mk_keys

    monkeypatch.delenv("JEPSEN_TPU_BATCH_BUCKETS", raising=False)
    reference_defaults(monkeypatch)
    seqs, model = _mk_keys(n_small=40, n_big=8, small_ops=74, big_ops=240,
                           seed0=31000)
    plan = explain_batch(seqs, model, n_devices=8)
    assert {k: plan[k] for k in chip_smoke.SHARD_TIER_PLAN} == \
        chip_smoke.SHARD_TIER_PLAN
    bench = json.loads((Path(chip_smoke.REPO) / "BENCH_shard.json")
                       .read_text())
    assert bench["bucketed"]["padding_efficiency"] == \
        chip_smoke.SHARD_TIER_PLAN["padding_efficiency"]
    assert bench["fused_counterfactual"]["padded_ops"] == \
        chip_smoke.SHARD_TIER_PLAN["fused_padded_ops"]


@pytest.mark.parametrize("name", sorted(chip_smoke.CHECKERS_REFERENCE))
def test_checkers_reference(name, monkeypatch, tmp_path):
    """``phase_checkers``' verdicts (``CHECKERS_REFERENCE``): the JAX
    package's checker of each kind on the same history.  The
    ``queue_linearizable`` case (200 queue ops) also goes through the
    port's checker on the CPU, as the card runs it."""
    from jepsen_tpu import history as jh

    reference_defaults(monkeypatch)
    spec, tmap, h = chip_smoke.checker_histories()[name]
    test = {**tmap, "store_base": str(tmp_path)}
    hj = [jh.Op.from_dict(op.to_dict()) for op in h]
    got = chip_smoke.make_checker(spec, root="jepsen_tpu").check(test, hj, {})
    assert got["valid"] is chip_smoke.CHECKERS_REFERENCE[name]
    if spec[1] == "queue_linearizable":
        assert 400 <= len(h) <= 800  # 200 to 400 ops
        import torch

        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            port = chip_smoke.make_checker(spec, device="cpu").check(
                test, h, {})
        finally:
            torch.set_num_threads(n)
        assert (port["valid"], port["model"]) == (got["valid"],
                                                  got["model"])


def _one_thread():
    """Pins torch to one thread for a test that runs the torch step;
    returns the restore."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return lambda: torch.set_num_threads(n)


def _gate_run(checker_cls, sd, engine, model, history, monkeypatch):
    """One stream of ``stream[gate]`` at the default gate and
    ``STREAM_GATE_BUDGET``: (result, device folds as (rows, out), host
    sweeps as (rows, states))."""
    folds, sweeps = [], []
    fold, sweep = sd.device_fold_states, engine.segment_states

    def traced_fold(sseq, *a, **kw):
        out = fold(sseq, *a, **kw)
        folds.append((len(sseq), out))
        return out

    def traced_sweep(sseq, *a, **kw):
        out = sweep(sseq, *a, **kw)
        sweeps.append((len(sseq), out[0] if isinstance(out, tuple) else out))
        return out

    monkeypatch.setattr(sd, "device_fold_states", traced_fold)
    monkeypatch.setattr(engine, "segment_states", traced_sweep)
    kw = {"device": "cpu"} if checker_cls.__module__.startswith(
        "jepsen_tpu_torch") else {}
    sc = checker_cls(model, device_budget=chip_smoke.STREAM_GATE_BUDGET,
                     **kw)
    for op in history:
        sc.ingest(op)
    return sc.finalize(), folds, sweeps


def test_stream_gate_reference(monkeypatch):
    """``stream[gate]``'s burst: at the default gate and
    ``STREAM_GATE_BUDGET`` both packages' stream checkers send the gated
    segment to the device, find its fold undecided, sweep it on the host
    to the same states and give the same verdict and routes."""
    from jepsen_tpu import history as jh
    from jepsen_tpu.decompose import engine as jengine
    from jepsen_tpu.stream import StreamChecker as JStream
    from jepsen_tpu.stream import device as jsd
    from jepsen_tpu_torch.analyze.plan import segment_fold_route
    from jepsen_tpu_torch.decompose import engine
    from jepsen_tpu_torch.history import encode_ops, max_concurrency
    from jepsen_tpu_torch.stream import StreamChecker
    from jepsen_tpu_torch.stream import device as sd

    reference_defaults(monkeypatch)
    h, model = chip_smoke.stream_gate_history()
    g = chip_smoke.STREAM_GATE
    rows = g["n_cas"] + g["n_writes"] + g["n_reads"]
    burst = encode_ops(h[2:-2], model.f_codes)
    assert (len(burst), max_concurrency(burst)) == (rows, rows)
    assert segment_fold_route(rows, rows, model) == "device"
    restore = _one_thread()
    try:
        port, folds, sweeps = _gate_run(StreamChecker, sd, engine, model, h,
                                        monkeypatch)
    finally:
        restore()
    ref, jfolds, jsweeps = _gate_run(
        JStream, jsd, jengine, jm.cas_register(),
        [jh.Op.from_dict(op.to_dict()) for op in h], monkeypatch)
    assert folds == jfolds == [(rows, None)]
    want = {(100 + i,) for i in range(g["n_writes"])}
    assert [s for s in sweeps if s[0] == rows] == \
        [s for s in jsweeps if s[0] == rows] == [(rows, want)]
    assert port["valid"] is ref["valid"] is True
    assert port["stream"]["routes"] == ref["stream"]["routes"]
    assert port["stream"]["routes"]["host"] >= 1
    assert not port["stream"]["fallback"]


def test_queue_linearizable_device_leg(tmp_path):
    """``phase_checkers``' device leg of ``queue_linearizable``, on the
    CPU: the JAX package's verdict (``CHECKERS_REFERENCE``) from the
    torch step alone, its slices counted on the device asked for."""
    restore = _one_thread()
    try:
        out, slices, requests = chip_smoke.queue_linear_device_leg(
            str(tmp_path), device="cpu")
    finally:
        restore()
    assert out["valid"] is \
        chip_smoke.CHECKERS_REFERENCE["queue_linearizable/valid"]
    assert requests > 0 and set(slices) == {"cpu"} and slices["cpu"] > 0
