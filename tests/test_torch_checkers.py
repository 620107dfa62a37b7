"""The port's checker library against the JAX package's: ``compose``,
``concurrency_limit``, ``check_safe``, the queue/unique-ids/counter/
bank/G2 checkers, ``queue_linearizable``, ``extra``, ``dirty``,
``schedule``, the timeline's HTML and perf's numbers.  The same
history, made from a seed, goes through both packages; the results are
equal exactly (``queue_linearizable`` past the host threshold races
its engines, whose winner follows wall time: there the verdict, the
model and the note are compared).  Last,
the slice as a whole: a keyed history stored, loaded and checked by
``compose`` of the lifted linearizability checker, the lifted timeline
and perf, in both packages."""

import argparse
import importlib
import os
import random
import sys
from dataclasses import replace

import pytest
import torch

import jepsen_tpu.checker.linearizable as jlin
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import store as jstore
from jepsen_tpu import synth as jsynth
from jepsen_tpu.checker import basic as jbasic
from jepsen_tpu.checker import core as jcore
from jepsen_tpu.checker import extra as jextra
from jepsen_tpu.checker import perf as jperf
from jepsen_tpu.checker import schedule as jschedule
from jepsen_tpu.checker import timeline as jtimeline
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch.checker import basic as tbasic
from jepsen_tpu_torch.checker import core as tcore
from jepsen_tpu_torch.checker import extra as textra
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import perf as tperf
from jepsen_tpu_torch.checker import schedule as tschedule
from jepsen_tpu_torch.checker import timeline as ttimeline
from jepsen_tpu_torch.models import cas_register as t_cas
from jepsen_tpu.models import cas_register as j_cas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _jax_module(name):
    """The JAX package's module ``name``, for chip_smoke's builders."""
    return importlib.import_module(f"jepsen_tpu.{name}")


KNOBS = ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
         "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_BATCH_BUCKETS",
         "JEPSEN_TPU_SHRINK")


@pytest.fixture(autouse=True)
def _reference_defaults(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(jlin, "_SLICE_TARGET_S", 1e9)
    monkeypatch.setattr(tlin, "_SLICE_TARGET_S", 1e9)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(h):
    """Port ops as the JAX package's."""
    return [jh.Op.from_dict(op.to_dict()) for op in h]


# ---------------------------------------------------------------------------
# each checker on its seeded histories
# ---------------------------------------------------------------------------

CASES = chip_smoke.checker_histories()


@pytest.mark.parametrize("name", sorted(
    n for n in CASES if not n.startswith("queue_linearizable")))
def test_checker_equals_the_reference(name, tmp_path):
    """Every checker's whole result on its chip_smoke history (the
    200-op ``queue_linearizable`` case is
    ``tests/test_torch_smoke_reference.py``'s, which holds the card's
    constants)."""
    spec, tmap, h = CASES[name]
    rt = chip_smoke.make_checker(spec).check(
        {**tmap, "store_base": str(tmp_path / "t")}, h, {})
    rj = chip_smoke.make_checker(spec, mod=_jax_module).check(
        {**tmap, "store_base": str(tmp_path / "j")}, _j(h), {})
    assert rt == rj
    assert rt["valid"] is chip_smoke.CHECKERS_REFERENCE[name]


def _queue_variants(seed):
    rng = random.Random(seed)
    h = tsynth.sim_queue_history(rng, 30, 4, crash_p=0.1 * (seed % 2),
                                 fifo=bool(seed % 3 == 0))
    return [h, tsynth.corrupt_dequeue(rng, h), tsynth.swap_dequeues(rng, h)]


@pytest.mark.parametrize("seed", range(6))
def test_queue_checkers_fuzz(seed):
    for h in _queue_variants(7000 + seed):
        for make in ("queue", "total_queue"):
            assert getattr(tbasic, make)().check({}, h) == \
                getattr(jbasic, make)().check({}, _j(h))
        for model in ("UnorderedQueue", "FIFOQueue"):
            rt = tbasic.queue(getattr(tbasic, model)()).check({}, h)
            rj = jbasic.queue(getattr(jbasic, model)()).check({}, _j(h))
            assert rt == rj


@pytest.mark.parametrize("seed", range(4))
def test_counter_ids_g2_fuzz(seed):
    for corrupt in (False, True):
        h = chip_smoke._counter_history(f"fuzz-{seed}", corrupt=corrupt)
        assert tbasic.counter().check({}, h) == \
            jbasic.counter().check({}, _j(h))
    h = chip_smoke._bank_history(f"fuzz-bank-{seed}", n_ops=30,
                                 corrupt=bool(seed % 2))
    assert tbasic.bank().check({"total_amount": 100}, h) == \
        jbasic.bank().check({"total_amount": 100}, _j(h))


def _reference_queue_linear_histories(mk):
    """The JAX package's own queue_linearizable cases
    (tests/test_checker_basic.py)."""
    inv, ok, info, fail = mk.invoke_op, mk.ok_op, mk.info_op, mk.fail_op
    big = []
    for i in range(60):
        big += [inv(0, "enqueue", i), ok(0, "enqueue", i)]
    return {
        "drain": [inv(0, "enqueue", 1), ok(0, "enqueue", 1),
                  inv(0, "enqueue", 2), ok(0, "enqueue", 2),
                  inv(0, "drain", None), ok(0, "drain", [2, 1])],
        "lifo": [inv(0, "enqueue", 1), ok(0, "enqueue", 1),
                 inv(0, "enqueue", 2), ok(0, "enqueue", 2),
                 inv(0, "dequeue", None), ok(0, "dequeue", 2),
                 inv(0, "dequeue", None), ok(0, "dequeue", 1)],
        "window": [inv(0, "enqueue", 1), ok(0, "enqueue", 1),
                   inv(0, "drain", None), inv(1, "enqueue", 2),
                   ok(1, "enqueue", 2), inv(1, "dequeue", None),
                   ok(1, "dequeue", 2), ok(0, "drain", [1])],
        "empty": [inv(0, "enqueue", 1), ok(0, "enqueue", 1),
                  inv(1, "drain", None), ok(1, "drain", []),
                  inv(0, "dequeue", None), ok(0, "dequeue", 1)],
        "thin-air": [inv(0, "enqueue", 1), ok(0, "enqueue", 1),
                     inv(0, "dequeue", None), ok(0, "dequeue", 99)],
        "count": [inv(0, "enqueue", 1), ok(0, "enqueue", 1),
                  inv(0, "drain", None), ok(0, "drain", 1),
                  inv(1, "drain", None), info(1, "drain", None)],
        "failed": [inv(0, "enqueue", 1), ok(0, "enqueue", 1),
                   inv(0, "drain", None), fail(0, "drain", None),
                   inv(0, "dequeue", None), ok(0, "dequeue", 1)],
        "dangling": [inv(0, "enqueue", 1), ok(0, "enqueue", 1),
                     inv(0, "enqueue", 2), ok(0, "enqueue", 2),
                     inv(1, "drain", None), inv(0, "dequeue", None),
                     ok(0, "dequeue", 2)],
        "big": big,
    }


@pytest.mark.parametrize("fifo", [False, True])
def test_queue_linearizable_reference_cases(fifo):
    ht = _reference_queue_linear_histories(th)
    hj = _reference_queue_linear_histories(jh)
    for name in ht:
        kw = {"max_ops": 50} if name == "big" else {}
        rt = tbasic.queue_linearizable(fifo=fifo, device="cpu", **kw).check(
            {}, ht[name], {})
        rj = jbasic.queue_linearizable(fifo=fifo, **kw).check(
            {}, hj[name], {})
        keys = ("valid", "model", "info", "engine", "configs")
        assert {k: rt.get(k) for k in keys} == \
            {k: rj.get(k) for k in keys}, name


def test_queue_linear_opts_and_entry():
    pt, pj = argparse.ArgumentParser(), argparse.ArgumentParser()
    tbasic.add_queue_linear_opts(pt)
    jbasic.add_queue_linear_opts(pj)
    for argv in ([], ["--queue-linear"], ["--queue-linear",
                                          "--queue-linear-max-ops", "7"]):
        ot, oj = vars(pt.parse_args(argv)), vars(pj.parse_args(argv))
        assert ot == oj
        et = tbasic.queue_linear_entry(ot, device="cpu")
        ej = jbasic.queue_linear_entry(oj)
        assert list(et) == list(ej)
        for k in et:
            assert (et[k].max_ops, et[k].fifo, et[k].device) == (
                ej[k].max_ops, ej[k].fifo, "cpu")


def test_inconsistent_and_queue_models():
    for mod in (tbasic, jbasic):
        q = mod.FIFOQueue().step(th.Op(0, "ok", "dequeue", 1))
        assert isinstance(q, mod.Inconsistent)
    assert repr(tbasic.Inconsistent("x")) == repr(jbasic.Inconsistent("x"))


# ---------------------------------------------------------------------------
# the combinators
# ---------------------------------------------------------------------------


def _boom(test, history, opts):
    raise ValueError("checker crashed")


def _without_traceback(r):
    """A result with each crashed checker's traceback cut to its last
    line (the file paths are each package's)."""
    out = {}
    for k, v in r.items():
        if isinstance(v, dict) and "error" in v and "Traceback" in str(
                v["error"]):
            v = {**v, "error": v["error"].strip().splitlines()[-1]}
        out[k] = v
    return out


@pytest.mark.parametrize("seed", range(3))
def test_compose_equals_the_reference(seed):
    h = chip_smoke._counter_history(f"compose-{seed}", corrupt=seed == 1)
    mk = {"t": (tcore, tbasic, textra), "j": (jcore, jbasic, jextra)}
    res = {}
    for side, (core, basic, extra) in mk.items():
        chk = core.compose({
            "counter": basic.counter(),
            "limited": core.concurrency_limit(1, basic.counter()),
            "unique": basic.unique_ids(),
            "boom": core.CheckerFn(_boom),
            "happy": core.unbridled_dionysus,
            "mono": extra.monotonic()})
        res[side] = chk.check({}, h if side == "t" else _j(h))
    assert _without_traceback(res["t"]) == _without_traceback(res["j"])
    assert res["t"]["valid"] is False if seed == 1 else \
        res["t"]["valid"] == "unknown"
    assert res["t"]["boom"]["error"].strip().endswith(
        "ValueError: checker crashed")


def test_check_safe_checker_fn_and_merge():
    for core in (tcore, jcore):
        r = core.check_safe(core.CheckerFn(_boom), {}, [])
        assert r["valid"] == "unknown" and "checker crashed" in r["error"]
        assert core.CheckerFn(_boom).name == "_boom"
        assert core.noop.check({}, []) == {"valid": True}
    for vs in ([], [True], [True, "unknown"], [True, False, "unknown"],
               [None], [True, True]):
        assert tcore.merge_valid(vs) == jcore.merge_valid(vs)


def test_concurrency_limit_bounds_concurrent_runs():
    import threading
    import time

    live, peak, lock = [0], [0], threading.Lock()

    class Slow(tcore.Checker):
        def check(self, test, history, opts=None):
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            time.sleep(0.02)
            with lock:
                live[0] -= 1
            return {"valid": True}

    chk = tcore.concurrency_limit(2, Slow())
    out = tcore.compose({str(i): chk for i in range(8)}).check({}, [])
    assert out["valid"] is True and peak[0] == 2


# ---------------------------------------------------------------------------
# timeline, perf and schedule's artifacts
# ---------------------------------------------------------------------------


def _timed_history(mk, seed):
    """A register history 0.5 s per event with a nemesis window and an
    op that carries an error (perf_test.clj's fixed history)."""
    synth = tsynth if mk is th else jsynth
    h = synth.register_history(random.Random(seed), n_ops=60, n_procs=4,
                               overlap=3, crash_p=0.05)
    h.insert(len(h) // 3, mk.info_op("nemesis", "start", "partition!"))
    h.insert(2 * len(h) // 3, mk.info_op("nemesis", "stop", "healed"))
    h[5] = replace(h[5], error="timeout <b>")
    return mk.index([replace(op, time=int(i * 0.5e9))
                     for i, op in enumerate(h)])


@pytest.mark.parametrize("seed", range(3))
def test_timeline_html_bytes_equal(tmp_path, seed):
    ht, hj = _timed_history(th, seed), _timed_history(jh, seed)
    assert [(a.to_dict(), b and b.to_dict()) for a, b in
            ttimeline.pairs(ht)] == [(a.to_dict(), b and b.to_dict())
                                     for a, b in jtimeline.pairs(hj)]
    pages = []
    for tl, h, side in ((ttimeline, ht, "t"), (jtimeline, hj, "j")):
        test = {"name": "tl demo", "store_base": str(tmp_path / side),
                "start_time": "20260729T000000"}
        out = tl.timeline().check(test, h, {"subdirectory": ["k", "3"]})
        assert out == {"valid": True}
        with open(os.path.join(str(tmp_path / side), "tl demo",
                               "20260729T000000", "k", "3",
                               "timeline.html"), "rb") as f:
            pages.append(f.read())
    assert pages[0] == pages[1] and b"op ok" in pages[0]


def _plain(x):
    """Nested defaultdicts as dicts."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("seed", range(3))
def test_perf_numbers_equal(seed):
    ht, hj = _timed_history(th, seed), _timed_history(jh, seed)
    bt, bj = tperf.latencies_by_f_type(ht), jperf.latencies_by_f_type(hj)
    assert _plain(bt) == _plain(bj) and bt
    assert tperf.nemesis_regions(ht) == jperf.nemesis_regions(hj)
    for f in bt:
        pts = bt[f]["ok"]
        assert tperf.latencies_to_quantiles(
            tperf.DT, tperf.QUANTILES, pts) == jperf.latencies_to_quantiles(
            jperf.DT, jperf.QUANTILES, pts)
        vals = [lat for _t, lat in pts]
        assert tperf.quantiles(tperf.QUANTILES, vals) == jperf.quantiles(
            jperf.QUANTILES, vals)
    assert tperf.quantiles([0.5], []) == {}


def test_perf_and_schedule_write_their_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    test = {"name": "perfdemo", "store_base": str(tmp_path),
            "start_time": "20260729T000000", "start_wall_time": 0}
    out = tperf.perf().check(test, _timed_history(th, 0), {})
    assert out == jperf.perf().check(
        {**test, "store_base": str(tmp_path / "j")}, _timed_history(jh, 0),
        {})
    assert out["valid"] is True
    d = os.path.join(str(tmp_path), "perfdemo", "20260729T000000")
    for png in ("latency-raw.png", "latency-quantiles.png", "rate.png"):
        assert os.path.getsize(os.path.join(d, png)) > 0
    spec, tmap, h = CASES["schedule/valid"]
    rt = tschedule.schedule_checker().check(test, h, {})
    rj = jschedule.schedule_checker().check(
        {**test, "store_base": str(tmp_path / "j")}, _j(h), {})
    assert rt == rj and rt["valid"] is True
    assert os.path.getsize(os.path.join(d, "chronos.png")) > 0


def test_perf_imports_no_matplotlib():
    import subprocess

    code = ("import sys; sys.modules['matplotlib'] = None; "
            "import jepsen_tpu_torch.checker.perf as p; "
            "print(p.quantiles([0.5], [1, 2, 3]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "{0.5: 2}", \
        out.stderr


# ---------------------------------------------------------------------------
# the slice as a whole: a stored keyed test checked by compose
# ---------------------------------------------------------------------------

#: (key, ops, corrupt): every key above the host threshold (48 ops),
#: so all go through one search_batch
KEYS = ((0, 60, True), (1, 60, False), (2, 70, False), (3, 64, False),
        (4, 60, True), (5, 66, False))


def _stored_keyed(mk, synth, ind):
    out = []
    for i, (k, n_ops, corrupt) in enumerate(KEYS):
        rng = random.Random(f"stored-{k}")
        h = synth.register_history(rng, n_ops=n_ops, n_procs=4, overlap=3,
                                   crash_p=0.02, max_crashes=1, n_values=3)
        if corrupt:
            h = synth.corrupt_read(rng, h, at=0.8)
        out += [replace(op, process=op.process + 10 * i,
                        value=[k, op.value]) for op in h]
    return [replace(op, time=i * 1_000_000) for i, op in enumerate(out)]


def _compose_stored(side, base):
    mk, synth, ind, store, core, lin, tl, perf, model = {
        "t": (th, tsynth, tind, tstore, tcore, tlin, ttimeline, tperf,
              t_cas()),
        "j": (jh, jsynth, jind, jstore, jcore, jlin, jtimeline, jperf,
              j_cas())}[side]
    test = {"name": "stored", "start_time": "20260101T000000",
            "store_base": base, "concurrency": 4}
    store.save_1(test, _stored_keyed(mk, synth, ind))
    run = store.load("stored", "20260101T000000", base)
    history = [replace(op, value=ind.tuple_(*op.value))
               for op in run["history"]]

    def per_key(t, h, opts):
        return tl.timeline().check(t, h, {**opts, "subdirectory": [
            "independent", str(opts["history_key"])]})

    kw = {"device": "cpu"} if side == "t" else {}
    chk = core.compose({
        "linear": ind.checker(lin.linearizable(model, shrink=False, **kw)),
        "timeline": ind.checker(core.CheckerFn(per_key)),
        "perf": perf.perf()})
    res = chk.check(run, history)
    store.save_2(test, res)
    return res, store.latest(base)


def test_stored_keyed_test_through_compose(tmp_path):
    pytest.importorskip("matplotlib")
    rt, lt = _compose_stored("t", str(tmp_path / "t"))
    rj, lj = _compose_stored("j", str(tmp_path / "j"))
    assert rt["valid"] is rj["valid"] is False
    assert sorted(rt["linear"]["failures"]) == sorted(
        rj["linear"]["failures"]) == [0, 4]
    for k, *_ in KEYS:
        a, b = rt["linear"]["results"][k], rj["linear"]["results"][k]
        assert a["valid"] is b["valid"]
        if a["valid"]:  # from the batch: configs and depth exact
            assert (a["configs"], a["max_depth"]) == (b["configs"],
                                                      b["max_depth"])
    assert rt["timeline"]["valid"] is rj["timeline"]["valid"] is True
    assert rt["perf"] == rj["perf"] == {
        "valid": True, "latency-graph": {"valid": True},
        "rate-graph": {"valid": True}}
    for k, *_ in KEYS:
        rel = os.path.join("stored", "20260101T000000", "independent",
                           str(k), "timeline.html")
        with open(tmp_path / "t" / rel, "rb") as f1, \
                open(tmp_path / "j" / rel, "rb") as f2:
            assert f1.read() == f2.read()
    assert lt["results"]["valid"] is lj["results"]["valid"] is False
    assert lt["results"]["linear"]["failures"] == \
        lj["results"]["linear"]["failures"]
