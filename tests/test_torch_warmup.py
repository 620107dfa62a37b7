"""The fleet's warm boot (``jepsen_tpu_torch/fleet/warmup.py``) and
devlint's K007 cache-key model (``jepsen_tpu_torch/analyze/devlint.py``),
held to the JAX package's: the shapes both load from the committed
traces and from a manifest are the same field tuples, K007 gives the
same messages on the same drift, and the warm-boot report has the same
keys and wire line.  Then the port alone, on the CPU: its own compile
spans satisfy its model exactly; a trace of a single search, a batch and
a sharded batch warms into an emptied kernel cache and the same searches
then miss nothing; a boot under the wrong telemetry flag leaves the
service's first fold a miss; ``"cuda"`` and ``"cuda:0"`` key alike."""

import dataclasses
import json
import random
from pathlib import Path

import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.analyze import devlint as jdl
from jepsen_tpu.fleet import warmup as jw
from jepsen_tpu_torch import obs
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.analyze import devlint as tdl
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.distributed import ShardMesh
from jepsen_tpu_torch.fleet import bench as tbench
from jepsen_tpu_torch.fleet import warmup as tw
from jepsen_tpu_torch.history import encode_ops as t_encode_ops

REPO = Path(__file__).resolve().parents[1]
TRACES = ("BENCH_trace_fleet.json", "BENCH_trace_shard.json",
          "BENCH_trace_1k.json")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """An empty kernel cache of its own, tracing off, torch on one
    thread."""
    monkeypatch.setattr(tlin, "_STEP_CACHE", {})
    was_on = obs.enabled()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    obs.enable(was_on)


def _tuples(shapes):
    return [dataclasses.astuple(s) for s in shapes]


# ---------------------------------------------------------------------------
# the loaders and K007, against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TRACES)
def test_load_shapes_from_committed_traces_equal(name):
    path = str(REPO / name)
    want = _tuples(jw.load_shapes(path))
    assert want
    assert _tuples(tw.load_shapes(path)) == want


def test_load_shapes_from_manifest_equal(tmp_path):
    man = tmp_path / "shapes.json"
    man.write_text(json.dumps({"shapes": [
        {"model": ["register", 0, 1], "n_det_pad": 256, "frontier": 64},
        {"model": ["cas-register", -2147483648, 1], "n_det_pad": 1024,
         "window": 64, "k": 8, "frontier": 512, "batch": 24},
        {"model": ["mutex"], "n_det_pad": 128, "batch": 8, "shards": 4,
         "masked": True, "dedup": True, "vt": 16},
    ]}))
    want = _tuples(jw.load_shapes(str(man)))
    assert len(want) == 3
    assert _tuples(tw.load_shapes(str(man))) == want


def _drifts():
    """(name, drift) pairs applied to a valid span of either package."""
    def drop(k):
        return lambda a: {x: v for x, v in a.items() if x != k}
    return [
        ("missing-window", drop("window")),
        ("missing-model", drop("model")),
        ("unmodelled", lambda a: {**a, "lanes_hint": 3}),
        ("window-33", lambda a: {**a, "window": 33}),
        ("crash-pad-96", lambda a: {**a, "n_crash_pad": 96}),
        ("frontier-0", lambda a: {**a, "frontier": 0}),
        ("k-str", lambda a: {**a, "k": "four"}),
        ("model-int", lambda a: {**a, "model": 3}),
        ("shards-0", lambda a: {**a, "shards": 0}),
    ]


@pytest.mark.parametrize("kind", ["solo", "batch", "batch-sharded"])
@pytest.mark.parametrize("drift", _drifts(), ids=lambda d: d[0])
def test_k007_messages_equal_on_drifted_spans(kind, drift):
    """Each package's own valid span, drifted the same way, draws the
    same K007 messages (strict and not)."""
    shape = jw.WarmShape(batch=0 if kind == "solo" else 8,
                         shards=4 if kind == "batch-sharded" else 0)
    j_args = jw._shape_span_args(shape)
    t_args = tw._shape_span_args(tw.WarmShape(**dataclasses.asdict(shape)))
    assert jdl.check_span_args(j_args) == []
    assert tdl.check_span_args(t_args) == []
    for strict in (True, False):
        want = jdl.check_span_args(drift[1](j_args), strict=strict)
        got = tdl.check_span_args(drift[1](t_args), strict=strict)
        assert got == want
    if drift[0] != "shards-0":
        assert want


def test_k007_reads_reference_generations_only_when_not_strict():
    ref = jw._shape_span_args(jw.WarmShape(batch=8, shards=4))
    assert tdl.check_span_args(ref, strict=False) == []
    errs = tdl.check_span_args(ref)
    assert errs == ["[batch-sharded] missing coords ['telemetry'], "
                    "unmodelled coords ['vt']", "unknown engine 'xla'"]
    legacy = {"engine": "xla", "frontier": 64, "n_det_pad": 64}
    assert tdl.check_span_args(legacy, strict=False) == []
    assert tdl.check_span_args({**legacy, "engine": "tpu"},
                               strict=False) == ["unknown engine 'tpu'"]


def test_trace_loader_k007_raises_and_diagnoses_alike(tmp_path):
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"name": "device.compile", "args": {
            "engine": "xla", "n_det_pad": 64, "frontier": 64,
            "window": 48, "n_crash_pad": 32, "k": 4}},
        {"name": "device.compile", "args": {
            "n_det_pad": 128, "frontier": 128}},
    ]}))
    msgs = []
    for mod in (jw, tw):
        with pytest.raises(ValueError) as e:
            mod.load_shapes(str(trace))
        diags = []
        shapes = mod.load_shapes(str(trace), diagnostics=diags)
        msgs.append((str(e.value), [d.message for d in diags],
                     _tuples(shapes)))
    assert msgs[1] == msgs[0]
    assert len(msgs[0][2]) == 1


def test_parse_warmup_line_equal():
    line = ("stream service warmup: shapes=14 compiled=12 verified=true "
            "persistent_cache=false wall_s=1.250")
    assert tw.parse_warmup_line(line) == jw.parse_warmup_line(line)
    assert tw.parse_warmup_line("stream service listening on x:1") is None


def test_warm_boot_report_keys_equal_and_second_boot_compiles_nothing():
    shape = tw.WarmShape(n_det_pad=64, frontier=8)
    want = jw.warm_boot([jw.WarmShape(n_det_pad=64, frontier=8)])
    rep = tw.warm_boot([shape], device="cpu")
    assert set(rep) == set(want)
    assert rep["shapes"] == 1 and rep["compiled"] == 1
    assert rep["verified"] is True and rep["wall_s"] > 0
    rep2 = tw.warm_boot([shape], device="cpu")
    assert rep2["compiled"] == 0 and rep2["verified"] is True
    # a drifted shape is not warmed, and the boot does not verify
    bad = tw.warm_boot([tw.WarmShape(window=40)], device="cpu")
    assert bad["verified"] is False and bad["shapes"] == 0
    assert bad["k007"] == [
        "warm shape #0 (register): window=40 not a positive multiple "
        "of 32"]


def test_noop_model_shape_warms():
    """The noop model's f-code table is empty: the JAX package's
    ``_tiny_seq`` indexes into it and raises; the port's warms the shape
    (``ROADMAP.md`` section C)."""
    with pytest.raises(IndexError):
        jw._tiny_seq(jm.noop())
    rep = tw.warm_boot([tw.WarmShape(model=("noop", 0, 1))], device="cpu")
    assert rep["verified"] is True and rep["compiled"] == 1


def test_warm_boot_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tw.warm_boot([tw.WarmShape()])


def test_cuda_and_cuda0_resolve_to_one_kernel_key(monkeypatch):
    """The device is part of every kernel-cache key: a worker warmed on
    ``cuda:0`` that serves on ``"cuda"`` must find what it warmed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    a = tlin._resolve_device("cuda")
    b = tlin._resolve_device("cuda:0")
    assert a == b and str(a) == str(b) == "cuda:0"
    assert str(tlin._resolve_device(torch.device("cuda", 1))) == "cuda:1"
    assert str(tlin._resolve_device("cpu")) == "cpu"


# ---------------------------------------------------------------------------
# the round trip on the CPU
# ---------------------------------------------------------------------------


def _histories(n=4, n_ops=48):
    model = tm.cas_register()
    seqs = []
    for k in range(n):
        rng = random.Random(900 + k)
        h = ts.register_history(rng, n_ops=n_ops, n_procs=4, overlap=3)
        if k % 2:
            h = ts.corrupt_read(rng, h, at=0.7)
        seqs.append(t_encode_ops(h, model.f_codes))
    return seqs, model


def _searches(seqs, model):
    return [
        tlin.search_opseq(seqs[0], model, device="cpu"),
        tlin.search_opseq(seqs[1], model, device="cpu"),
        tlin.search_batch(seqs, model, device="cpu"),
        tlin.search_batch(seqs, model, sharding=ShardMesh(["cpu"] * 2)),
    ]


def test_trace_round_trip_warms_every_kernel():
    seqs, model = _histories()
    obs.enable(True)
    obs.set_run("warm-round-trip")
    try:
        first = _searches(seqs, model)
        doc = obs.chrome_trace("warm-round-trip")
    finally:
        obs.set_run(None)
        obs.drop_recorder("warm-round-trip")
    spans = [e["args"] for e in doc["traceEvents"]
             if e.get("name") == "device.compile"]
    kinds = {tdl.span_kind_for_args(a) for a in spans}
    assert kinds == {"solo", "batch", "batch-sharded"}
    for a in spans:
        assert tdl.check_span_args(a, strict=True) == [], a
    shapes = tw.shapes_from_trace(doc)
    assert {(s.batch > 0, s.shards) for s in shapes} \
        >= {(False, 0), (True, 0), (True, 2)}

    tlin._STEP_CACHE.clear()
    rep = tw.warm_boot(shapes, device="cpu")
    assert rep["verified"] is True
    assert rep["compiled"] >= len(shapes)
    misses = tlin.KERNEL_CACHE_STATS["misses"]
    again = _searches(seqs, model)
    assert tlin.KERNEL_CACHE_STATS["misses"] == misses
    strip = [{k: v for k, v in r.items() if k != "search_telemetry"}
             for rs in (first, again) for r in
             (rs[:2] + rs[2] + rs[3])]
    half = len(strip) // 2
    assert [(r["valid"], r["configs"]) for r in strip[half:]] \
        == [(r["valid"], r["configs"]) for r in strip[:half]]


def test_sharded_shape_launches_every_shard(monkeypatch):
    """A sharded warm shape gives every shard live keys: each shard's
    batch function runs (a shard without one would not)."""
    calls = []
    real = tlin.get_batch_kernel

    def counting(model, dims, device, **kw):
        fn = real(model, dims, device, **kw)

        def run(*a):
            calls.append(int(a[0].shape[0]))
            return fn(*a)
        return run

    monkeypatch.setattr(tlin, "get_batch_kernel", counting)
    rep = tw.warm_boot([tw.WarmShape(batch=8, shards=4)], device="cpu")
    assert rep["verified"] is True
    assert calls == [2, 2, 2, 2]


def test_wrong_telemetry_flag_leaves_the_first_fold_a_miss():
    """The service's folds request the telemetry builds: a boot with
    telemetry off verifies for itself, and the first fold then misses;
    the default boot leaves nothing to miss."""
    h = tbench._mk_history(2001, 64)
    shapes = tbench.record_traffic_shapes([h], device="cpu",
                                          host_fold_max=0)
    assert shapes and not tlin._STEP_CACHE
    probe = tbench._mk_history(2002, 64)

    def fold_misses():
        m0 = tlin.KERNEL_CACHE_STATS["misses"]
        tbench._single_service_final(probe, device="cpu", host_fold_max=0)
        return tlin.KERNEL_CACHE_STATS["misses"] - m0

    off = tw.warm_boot(shapes, device="cpu", telemetry=False)
    assert off["verified"] is True and off["compiled"] == len(shapes)
    assert fold_misses() > 0
    tlin._STEP_CACHE.clear()
    on = tw.warm_boot(shapes, device="cpu")
    assert on["verified"] is True
    assert fold_misses() == 0
