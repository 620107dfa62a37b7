"""The port's observation layer (``jepsen_tpu_torch/obs``) against the
JAX package's (``jepsen_tpu/obs``): the metrics registry renders the
same Prometheus text and JSON snapshot after the same operations, the
span recorder exports the same Chrome-trace shape, ``derived_stats``
gives the device idle share, and the prepass, DPOR, bucket and device
search instrumentation moves the same counters and records the same
spans as the reference's for the same work."""

import json
import logging
import random

import numpy as np
import pytest

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import history as jh
from jepsen_tpu import obs as jobs
from jepsen_tpu import synth as js
from jepsen_tpu.analyze import hb as jhb
from jepsen_tpu.checker import seq as jseq
from jepsen_tpu.obs import metrics as jmetrics
from jepsen_tpu.obs import telemetry as jtele
from jepsen_tpu_torch import _build
from jepsen_tpu_torch import obs as tobs
from jepsen_tpu_torch.analyze import hb as thb
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import seq as tseq
from jepsen_tpu_torch.obs import metrics as tmetrics
from jepsen_tpu_torch.obs import telemetry as ttele
from jepsen_tpu_torch.obs import trace as ttrace
from test_torch_hb import encoded


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    monkeypatch.setattr(lin, "_SLICE_TARGET_S", 1e9)
    monkeypatch.setattr(tlin, "_SLICE_TARGET_S", 1e9)
    for knob in ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
                 "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_BATCH_BUCKETS",
                 "JEPSEN_TPU_TELEMETRY", "JEPSEN_TPU_TRACE"):
        monkeypatch.delenv(knob, raising=False)
    yield
    tobs.enable(False)
    jobs.enable(None)
    jtele.enable(None)


def _drive(reg, ops):
    """The same operations on a registry of either package."""
    for kind, name, args, labels in ops:
        if kind == "counter":
            reg.counter(name, "h", tuple(sorted(labels))).inc(args,
                                                             **labels)
        elif kind == "gauge":
            reg.gauge(name, "h", tuple(sorted(labels))).set(args, **labels)
        else:
            reg.histogram(name, "h", tuple(sorted(labels))).observe(
                args, **labels)


OPS = [("counter", "jtpu_bucket_ops_total", 120, {"kind": "useful"}),
       ("counter", "jtpu_bucket_ops_total", 192, {"kind": "padded"}),
       ("counter", "jtpu_kernel_cache_total", 3, {"event": "miss"}),
       ("counter", "jtpu_kernel_cache_total", 9, {"event": "hit"}),
       ("counter", "jtpu_search_levels_total", 77, {}),
       ("counter", "jtpu_hb_edges_total", 5, {"kind": "forced"}),
       ("gauge", "jtpu_search_observed_prune_ratio", 0.625, {}),
       ("gauge", "jtpu_device_memory_bytes", 4096.0, {}),
       ("histogram", "jtpu_bucket_seconds", 0.003, {"stage": "prep"}),
       ("histogram", "jtpu_bucket_seconds", 0.7, {"stage": "device"}),
       ("histogram", "jtpu_search_level_occupancy", 40, {}),
       ("histogram", "jtpu_fold_seconds", 12.5, {})]


def test_registry_renders_as_the_reference():
    regs = []
    for mod in (tmetrics, jmetrics):
        reg = mod.Registry()
        mod._declare(reg)
        _drive(reg, OPS)
        regs.append(reg)
    t, j = regs
    assert t.render() == j.render()
    assert t.snapshot() == j.snapshot()
    snap = t.snapshot()["derived"]
    assert snap["kernel_cache_hit_ratio"] == 0.75
    assert snap["bucket_padding_efficiency"] == 0.625
    assert snap["device_idle_fraction"] is None  # no device time yet
    for reg in regs:
        with pytest.raises(ValueError):
            reg.gauge("jtpu_bucket_ops_total", "h", ("kind",))
        with pytest.raises(ValueError):
            reg.get("jtpu_bucket_ops_total").inc(1, shape="x")
    t.reset()
    j.reset()
    assert t.render() == j.render()


def test_module_registry_declares_the_reference_taxonomy():
    names = set(tmetrics.REGISTRY._m)
    fresh = jmetrics.Registry()
    jmetrics._declare(fresh)
    assert set(fresh._m) <= names
    assert tmetrics.render() == tmetrics.REGISTRY.render()
    assert set(tmetrics.snapshot()) == names | {"derived"}


def test_derived_stats_gives_the_device_idle_fraction():
    regs = []
    for mod in (tmetrics, jmetrics):
        reg = mod.Registry()
        mod._declare(reg)
        assert mod.derived_stats(reg)["device_idle_fraction"] is None
        reg.get("jtpu_device_seconds_total").inc(1e-6)
        regs.append(mod.derived_stats(reg))
    d, ref = regs
    assert 0.0 <= d["device_idle_fraction"] <= 1.0
    assert set(d) == set(ref)
    before = tmetrics.REGISTRY.get("jtpu_device_seconds_total").total()
    ttele.record_device_seconds(0.25)
    ttele.record_device_seconds(0.0)
    assert tmetrics.REGISTRY.get("jtpu_device_seconds_total").total() \
        == pytest.approx(before + 0.25)


def _shape(trace: dict) -> list:
    """A Chrome trace with its clock readings blanked."""
    out = []
    for e in trace["traceEvents"]:
        e = dict(e)
        for k in ("ts", "dur", "pid"):
            e.pop(k, None)
        out.append(e)
    return out + [trace["displayTimeUnit"], trace["otherData"]]


def test_chrome_trace_has_the_reference_shape(tmp_path):
    recs = []
    for mod in (ttrace, jobs.trace):
        rec = mod.SpanRecorder("run-1", cap=3)
        for i in range(5):  # two fall off the back
            rec.record(f"s{i}", "device", 1.0 + i, 1.5 + i, {"i": i})
        recs.append(rec)
    t, j = recs
    assert len(t) == len(j) == 3 and t.dropped == j.dropped == 2
    assert _shape(t.chrome_trace()) == _shape(j.chrome_trace())
    assert [s["dur"] for s in t.spans()] == [s["dur"] for s in j.spans()]


def test_span_switch_and_export(tmp_path):
    run = "obs-test"
    assert not tobs.enabled()
    with tobs.span("off", run=run):
        pass
    assert len(tobs.recorder(run)) == 0
    tobs.enable(True)

    @tobs.traced("wrapped", cat="host")
    def work(x):
        return x + 1

    tobs.set_run(run)
    try:
        with tobs.span("outer", cat="host", rows=3):
            assert work(1) == 2
        with pytest.raises(KeyError):
            with tobs.span("fails"):
                raise KeyError("x")
        assert tobs.current_run() == run
    finally:
        tobs.set_run(None)
    names = [(s["name"], s["cat"], s["args"])
             for s in tobs.recorder(run).spans()]
    assert names == [("wrapped", "host", {}), ("outer", "host", {"rows": 3}),
                     ("fails", "span", {"error": "KeyError"})]
    path = tobs.write_trace(str(tmp_path / "t" / "trace.json"), run)
    with open(path) as fh:
        assert json.load(fh) == tobs.chrome_trace(run)
    tobs.drop_recorder(run)
    assert len(tobs.recorder(run)) == 0
    tobs.drop_recorder(run)


def test_log_ctx_prefixes_fields(caplog):
    log = logging.getLogger("jepsen_tpu_torch.test")
    with caplog.at_level(logging.WARNING):
        tobs.log_ctx(log, run_id="r1", conn=None).warning("hello")
    assert caplog.records[-1].getMessage() == "[run_id=r1] hello"


def test_compile_span_reads_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.prebuilt() is False
    for src in _build.SRC_DIR.glob("*.cu"):
        _build._target(src).write_bytes(b"")
    assert _build.prebuilt() is True
    tobs.enable(True)
    with ttele.compile_span(engine="torch", frontier=16):
        pass
    span = tobs.recorder(None).spans()[-1]
    assert span["name"] == "device.compile"
    assert span["args"] == {"cache": "miss", "persistent_cache": True,
                            "engine": "torch", "frontier": 16}
    tobs.drop_recorder(None)


def test_memory_gauge_stays_on_the_cpu():
    gauge = tmetrics.REGISTRY.get("jtpu_device_memory_bytes")
    before = gauge.value()
    ttele.update_device_memory("cpu")
    ttele.update_device_memory(None)
    assert gauge.value() == before


# ---------------------------------------------------------------------------
# instrumentation against the reference's
# ---------------------------------------------------------------------------


COUNTERS = ("jtpu_hb_prepass_total", "jtpu_hb_edges_total",
            "jtpu_dpor_dup_edges_total", "jtpu_constraint_prepass_total",
            "jtpu_constraint_edges_total", "jtpu_dpor_mask_total",
            "jtpu_dpor_dedup_total", "jtpu_dpor_sleep_prunes_total",
            "jtpu_search_levels_total", "jtpu_search_expanded_total",
            "jtpu_search_mask_killed_total", "jtpu_search_dedup_folds_total",
            "jtpu_search_crash_rounds_total", "jtpu_search_overflows_total",
            "jtpu_bucket_ops_total", "jtpu_kernel_cache_total")


def _values(reg) -> dict:
    out = {}
    for name in COUNTERS:
        m = reg.get(name)
        v = m.snapshot() if m is not None else 0
        out[name] = v if isinstance(v, dict) else {"": v}
    return out


def _delta(before: dict, after: dict) -> dict:
    return {name: {k: v - before[name].get(k, 0)
                   for k, v in after[name].items()
                   if v - before[name].get(k, 0)}
            for name in after}


def _histories():
    """Register-family histories with must-order edges and dead values,
    one the prepass decides, a mutex and a queue history."""
    out = []
    for seed in (3, 8):
        rng = random.Random(seed)
        h = js.register_history(rng, n_ops=36, n_procs=5, overlap=4,
                                crash_p=0.1, max_crashes=3, n_values=3)
        out.append((js.corrupt_read(rng, h, at=0.8) if seed == 3 else h,
                    "cas_register", ()))
    h = []
    for p in range(3):
        h += [jh.invoke_op(p, "write", 10 + p), jh.ok_op(p, "write", 10 + p)]
    out.append((h + [jh.invoke_op(0, "read", None),
                     jh.ok_op(0, "read", 12)], "register", (0,)))
    out.append((js.sim_mutex_history(random.Random(4), 30, 3, crash_p=0.1,
                                     max_crashes=3), "mutex", ()))
    out.append((js.sim_queue_history(random.Random(5), 24, 3, crash_p=0.1),
                "unordered_queue", (16,)))
    return out


def test_prepass_and_host_counters_match_reference():
    """The same prepasses and host searches move the same hb, dpor and
    constraint counters in both registries, and record the same spans."""
    tobs.enable(True)
    jobs.enable(True)
    t0, j0 = _values(tmetrics.REGISTRY), _values(jmetrics.REGISTRY)
    tobs.set_run("pp")
    jobs.set_run("pp")
    try:
        for h, factory, args in _histories():
            sj, mj, st, mt = encoded(h, factory, *args)
            assert (thb.maybe_hb(st, mt) is None) == \
                (jhb.maybe_hb(sj, mj) is None)
            rt = tseq.check_opseq(st, mt, max_configs=200_000)
            rj = jseq.check_opseq(sj, mj, max_configs=200_000)
            assert rt["valid"] == rj["valid"]
    finally:
        tobs.set_run(None)
        jobs.set_run(None)
    dt = _delta(t0, _values(tmetrics.REGISTRY))
    dj = _delta(j0, _values(jmetrics.REGISTRY))
    assert dt == dj
    assert dt["jtpu_hb_prepass_total"] and \
        dt["jtpu_constraint_prepass_total"]
    names = [s["name"] for s in tobs.recorder("pp").spans()]
    assert names == [s["name"] for s in jobs.recorder("pp").spans()
                     if s["name"] in ("hb.prepass", "constraints.prepass")]
    assert set(names) == {"hb.prepass", "constraints.prepass"}
    assert tmetrics.REGISTRY.get("jtpu_hb_prune_ratio").value() == \
        jmetrics.REGISTRY.get("jtpu_hb_prune_ratio").value()
    tobs.drop_recorder("pp")
    jobs.drop_recorder("pp")


def _span_args(rec, name) -> set:
    return {k for s in rec.spans() if s["name"] == name for k in s["args"]}


def test_device_search_spans_and_counters_match_reference():
    """A traced device search and a traced bucketed batch in both
    packages: the same search and bucket counters move, and the same
    spans are recorded with the same argument names."""
    rng = random.Random(5)
    h = js.corrupt_read(rng, js.register_history(
        rng, n_ops=40, n_procs=5, overlap=4, crash_p=0.1, max_crashes=4,
        n_values=3), at=0.8)
    sj, mj, st, mt = encoded(h, "cas_register")
    keys = []
    for k in range(3):
        rng = random.Random(f"b-{k}")
        hk = js.register_history(rng, n_ops=24, n_procs=5, overlap=4,
                                 crash_p=0.05, max_crashes=3, n_values=3)
        keys.append(encoded(js.corrupt_read(rng, hk, at=0.7), "cas_register"))
    tobs.enable(True)
    jobs.enable(True)
    jtele.enable(True)
    t0, j0 = _values(tmetrics.REGISTRY), _values(jmetrics.REGISTRY)
    tobs.set_run("dev")
    jobs.set_run("dev")
    try:
        rt = tlin.search_opseq(st, mt, device="cpu")
        rj = lin.search_opseq(sj, mj)
        bt = tlin.search_batch([k[2] for k in keys], mt, device="cpu")
        bj = lin.search_batch([k[0] for k in keys], mj)
    finally:
        tobs.set_run(None)
        jobs.set_run(None)
    assert rt["search_telemetry"] == rj["search_telemetry"]
    assert [r["valid"] for r in bt] == [r["valid"] for r in bj]
    dt = _delta(t0, _values(tmetrics.REGISTRY))
    dj = _delta(j0, _values(jmetrics.REGISTRY))
    for name in COUNTERS:
        if name != "jtpu_kernel_cache_total":  # the processes' warmth
            assert dt[name] == dj[name], name
    assert dt["jtpu_search_levels_total"] and dt["jtpu_bucket_ops_total"]
    trec, jrec = tobs.recorder("dev"), jobs.recorder("dev")
    for name in ("device.level", "search.telemetry", "bucket.prep",
                 "bucket.device", "device.transfer"):
        assert _span_args(trec, name) == _span_args(jrec, name), name
    # the single search's slices carry the reference's arguments; the
    # port also times each batch slice (``lanes``)
    assert _span_args(trec, "device.slice") == \
        _span_args(jrec, "device.slice") | {"lanes"}
    slices = [s for s in trec.spans() if s["name"] == "device.slice"]
    assert sum(s["dur"] for s in slices) > 0
    assert np.isclose(
        sum(1 for s in trec.spans() if s["name"] == "device.level"),
        sum(1 for s in jrec.spans() if s["name"] == "device.level"))
    tobs.drop_recorder("dev")
    jobs.drop_recorder("dev")
