"""The port's trace report (``obs/report.py``) and its command line
(``python -m jepsen_tpu_torch.obs``) against the JAX package's: the
phase table and its text on every committed ``BENCH_trace_*.json``, on
fixed synthetic traces (overlapping spans, the ``run`` envelope, the
telemetry spans, the port's compile-span coordinates) and on a trace
the port records itself, each equal to the JAX package's.  No test
times a real sleep: the spans are written with fixed timestamps."""

import io
import json
import random
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from jepsen_tpu.obs import report as jreport
from jepsen_tpu_torch import obs as tobs
from jepsen_tpu_torch.obs import __main__ as tcli
from jepsen_tpu_torch.obs import report as treport

REPO = Path(__file__).resolve().parents[1]
TRACES = sorted(p.name for p in REPO.glob("BENCH_trace_*.json"))


def _x(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def _level(level, ts, **cols):
    return _x("device.level", "device", ts, 10.0, level=level, **cols)


#: fixed synthetic traces: name -> trace
SYNTHETIC = {
    "empty": {"traceEvents": []},
    "no-complete-events": {"traceEvents": [
        {"name": "m", "ph": "M", "ts": 0}, {"name": "i", "ph": "i",
                                            "ts": 5}]},
    "overlap-and-envelope": {"traceEvents": [
        _x("run", "run", 0.0, 1e6),
        _x("device.slice", "device", 1e5, 2e5),
        _x("device.slice", "device", 2.5e5, 1e5),  # overlaps the first
        _x("bucket.prep", "host", 3.2e5, 8e4),
        _x("hb.prepass", "analyze", 6e5, 5e4),
        _x("hb.prepass", "analyze", 9e5, 0.0),
        _x("untitled", None, 9.5e5, 2.5e4),
    ]},
    "port-telemetry": {"traceEvents": [
        _x("device.compile", "device", 0.0, 400.0, cache="miss",
           persistent_cache=True, engine="cuda", telemetry=True,
           n_det_pad=1024, n_crash_pad=32, window=32, k=4, frontier=64),
        _x("device.compile", "device", 500.0, 300.0, cache="miss",
           persistent_cache=True, engine="device-sharded", telemetry=True,
           n_det_pad=64, n_crash_pad=32, window=32, k=4, frontier=64,
           batch=4, shards=4),
        _x("device.compile", "device", 900.0, 30.0, cache="miss",
           persistent_cache=False, engine="torch", telemetry=False,
           n_det_pad=64, n_crash_pad=32, window=32, k=4, frontier=16),
        _x("device.transfer", "device", 950.0, 1.0, bytes=4096),
        _x("device.transfer", "device", 960.0, 1.0, bytes=512),
        *[_level(lvl % 7, 1000.0 + 11 * lvl, occupancy=lvl + 1,
                 expanded=3 * lvl, mask_killed=lvl % 3,
                 dedup_folds=lvl % 2) for lvl in range(30)],
        _x("search.telemetry", "telemetry", 1400.0, 0.0, expanded=90,
           mask_killed=10, dedup_folds=5, overflows=1,
           observed_prune_ratio=0.84, predicted_prune_ratio=0.9,
           prune_ratio_delta=-0.06),
        _x("search.telemetry", "telemetry", 1500.0, 0.0, expanded=0,
           mask_killed=0, dedup_folds=0, overflows=0, decided=True,
           observed_prune_ratio=None),
    ]},
    "long-search": {"traceEvents": [
        _level(lvl, 10.0 * lvl, occupancy=64, expanded=100 + lvl)
        for lvl in range(40)]},
    "levels-without-columns": {"traceEvents": [
        _level(0, 0.0), _level(1, 20.0)]},
}


def _both(trace):
    return jreport.phase_table(trace), treport.phase_table(trace)


@pytest.mark.parametrize("name", TRACES)
def test_committed_traces_fold_as_the_reference(name):
    trace = treport.load_trace(str(REPO / name))
    want, got = _both(trace)
    assert got == want
    assert treport.render_report(got) == jreport.render_report(want)


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_traces_fold_as_the_reference(name):
    want, got = _both(SYNTHETIC[name])
    assert got == want
    assert treport.render_report(got) == jreport.render_report(want)


def test_phase_table_numbers():
    """The interval union: overlapping device spans bill once, the
    envelope claims no time, idle is the extent less the union."""
    rep = treport.phase_table(SYNTHETIC["overlap-and-envelope"])
    assert rep["wall_s"] == 1.0
    by = {p["cat"]: p for p in rep["phases"]}
    assert by["device"]["busy_s"] == 0.25  # 0.10 to 0.35 s
    assert by["device"]["spans"] == 2 and by["span"]["spans"] == 1
    # busy outside the envelope: 0.1 to 0.4, 0.6 to 0.65, 0.95 to 0.975
    assert rep["idle_s"] == 0.625 and rep["idle_pct"] == 62.5
    t = treport.phase_table(SYNTHETIC["port-telemetry"])["telemetry"]
    assert t["compiles"] == {"count": 3, "total_s": 0.0007,
                             "persistent_cache": True}
    assert t["transfer_bytes"] == 4608
    assert t["search"]["searches"] == 2 and t["search"]["decided"] is True
    assert len(t["levels"]) == 7


@pytest.mark.parametrize("seed", range(5))
def test_union_matches_reference(seed):
    rng = random.Random(seed)
    ivs = []
    for _ in range(rng.randrange(0, 60)):
        s = rng.uniform(0, 1000)
        ivs.append((s, s + rng.choice([0.0, rng.uniform(0, 80)])))
    assert treport._union_us(ivs) == jreport._union_us(ivs)


def test_a_port_trace_folds_as_the_reference(tmp_path):
    """A traced search of the port on the CPU: its spans (device slices,
    compile spans with the ``torch`` engine and the telemetry
    coordinate) fold to the same table in both packages."""
    from jepsen_tpu_torch import models, synth
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.history import encode_ops

    torch.set_num_threads(1)
    m = models.cas_register()
    h = synth.register_history(random.Random(5), n_ops=60, n_procs=4,
                               overlap=3, crash_p=0.05)
    h = synth.corrupt_read(random.Random(6), h, at=0.7)
    run = "trace-report-test"
    was = tobs.enabled()
    tobs.enable(True)
    tobs.set_run(run)
    lin._STEP_CACHE.clear()
    try:
        lin.search_opseq(encode_ops(h, m.f_codes), m, device="cpu",
                         hb=False)
        path = tobs.write_trace(str(tmp_path / "trace.json"), run)
    finally:
        tobs.set_run(None)
        tobs.drop_recorder(run)
        tobs.enable(was)
    trace = treport.load_trace(path)
    compiles = [e for e in trace["traceEvents"]
                if e["name"] == "device.compile"]
    assert compiles and all(e["args"]["engine"] == "torch"
                            and "telemetry" in e["args"] for e in compiles)
    want, got = _both(trace)
    assert got == want and got["telemetry"]["compiles"]["count"] == len(
        compiles)


def _cli(*argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tcli.main(list(argv))
    return rc, buf.getvalue()


def test_cli_report_trace_and_metrics(tmp_path):
    src = REPO / "BENCH_trace_hb.json"
    rep = jreport.phase_table(jreport.load_trace(str(src)))
    rc, out = _cli("report", str(src), "--json")
    assert rc == 0 and json.loads(out) == rep
    rc, out = _cli("report", str(src))
    assert rc == 0 and out == jreport.render_report(rep) + "\n"
    rc, out = _cli("trace", str(src))
    assert rc == 0 and out == src.read_text()
    rc, out = _cli("metrics")
    assert rc == 0 and "# TYPE jtpu_" in out
    rc, out = _cli()
    assert rc == 2


def test_resolve_trace_reads_the_store(tmp_path):
    run = tmp_path / "atomdemo" / "20260101T000000"
    run.mkdir(parents=True)
    (run / "trace.json").write_text("{}")
    (tmp_path / "atomdemo" / "latest").symlink_to(run)
    base = str(tmp_path)
    assert tcli.resolve_trace("atomdemo/20260101T000000", base) == \
        str(run / "trace.json")
    assert tcli.resolve_trace("atomdemo", base) == \
        str(tmp_path / "atomdemo" / "latest" / "trace.json")
    with pytest.raises(FileNotFoundError):
        tcli.resolve_trace("nothing", base)


def test_module_runs_as_a_program():
    """``python -m jepsen_tpu_torch.obs report <trace> --json`` exits 0
    and prints the JAX package's dict."""
    src = REPO / "BENCH_trace_dpor.json"
    p = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch.obs",
                        "report", str(src), "--json"], cwd=str(REPO),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout) == jreport.phase_table(
        jreport.load_trace(str(src)))
