"""The port's search and checker entry points against the JAX package's,
on the same synth histories: ``search_opseq`` (verdict, configs, depth,
final frontier width, window), ``Linearizable`` with the device and host
algorithms, and the host WGL oracle ``check_opseq``, all with the lint,
happens-before, DPOR and audit passes off on both sides (``OFF``); the
passes themselves are compared in tests/test_torch_{lint,hb,dpor,
audit}.py."""

import random

import pytest

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.checker import seq as jseq
from jepsen_tpu.history import encode_ops as j_encode_ops
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import seq as tseq
from jepsen_tpu_torch.checker.linear import \
    check_opseq_linear as tcheck_linear
from jepsen_tpu_torch.history import encode_ops as t_encode_ops

OFF = dict(lint=False, hb=False, dpor=False, audit=False)


#: the JAX package's knobs for its passes; unset, each pass takes its
#: default, which is the port's default too
KNOBS = ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
         "JEPSEN_TPU_AUDIT")


def reference_defaults(monkeypatch):
    """Unset the JAX package's pass knobs, so that what reads them (the
    checker's host confirmation, the shrink's re-checks) runs the
    defaults, as the port always does."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(autouse=True)
def _deterministic_driver(monkeypatch):
    """The width ladder's downshift timing follows the adaptive level
    cap, which follows wall time; a huge slice target pins the cap
    schedule so both packages take the same rungs."""
    monkeypatch.setattr(lin, "_SLICE_TARGET_S", 1e9)
    monkeypatch.setattr(tlin, "_SLICE_TARGET_S", 1e9)
    reference_defaults(monkeypatch)


def _pair(kind, seed, *, corrupt):
    """(jax seq, jax model, port seq, port model) from one seed."""
    out = []
    for synth, models, encode in ((js, jm, j_encode_ops),
                                  (ts, tm, t_encode_ops)):
        rng = random.Random(seed)
        if kind == "mutex":
            h = synth.sim_mutex_history(rng, n_ops=80, n_procs=4,
                                        crash_p=0.05, max_crashes=4)
            model = models.mutex()
        else:
            cas = kind == "cas-register"
            h = synth.register_history(rng, n_ops=90, n_procs=5, overlap=4,
                                       crash_p=0.04, max_crashes=4,
                                       n_values=3, cas=cas)
            model = models.cas_register() if cas else models.register(0)
        if corrupt:
            h = synth.corrupt_read(rng, h, at=0.7)
        out += [encode(h, model.f_codes), model]
    return out


CASES = [("register", 1, True), ("register", 4, False),
         ("cas-register", 3, True), ("cas-register", 5, True),
         ("mutex", 1, False), ("mutex", 3, False)]

KEYS = ("valid", "configs", "max_depth", "frontier", "window",
        "concurrency")


@pytest.mark.parametrize("kind,seed,corrupt", CASES)
def test_search_opseq_matches_reference(kind, seed, corrupt):
    sj, mj, st, mt = _pair(kind, seed, corrupt=corrupt)
    oj = lin.search_opseq(sj, mj, **OFF)
    ot = tlin.search_opseq(st, mt, device="cpu", **OFF)
    assert {k: ot.get(k) for k in KEYS} == {k: oj.get(k) for k in KEYS}
    # this host has no card: the port's search never ran the kernel
    assert ot["engine"] == oj["engine"]
    for k in ("linearization", "witness_dropped", "frontier_dropped"):
        assert ot.get(k) == oj.get(k), k


def test_search_cases_cover_device_verdicts():
    """The parity cases above reach the device search (not only the
    greedy witness), with both verdicts and a widened frontier."""
    seen = set()
    for kind, seed, corrupt in CASES:
        _, _, st, mt = _pair(kind, seed, corrupt=corrupt)
        out = tlin.search_opseq(st, mt, device="cpu", **OFF)
        seen.add((out["engine"], out["valid"]))
        seen.add(("wide", out.get("frontier", 0) > 16))
    assert {("device-bfs", True), ("device-bfs", False),
            ("wide", True)} <= seen


@pytest.mark.parametrize("algorithm", ["device", "host"])
@pytest.mark.parametrize("kind,seed,corrupt", CASES[:4])
def test_linearizable_matches_reference(kind, seed, corrupt, algorithm,
                                       tmp_path):
    sj, mj, st, mt = _pair(kind, seed, corrupt=corrupt)
    oj = lin.linearizable(mj, algorithm=algorithm, **OFF).check(
        {"store_base": str(tmp_path / "jax")}, sj)
    ot = tlin.linearizable(mt, algorithm=algorithm, device="cpu",
                           **OFF).check({"store_base": str(tmp_path / "port")},
                                        st)
    for k in ("valid", "configs", "max_depth", "engine", "final_ops",
              "linearization", "device_configs", "witness_prefix_ops",
              "shrink"):
        assert ot.get(k) == oj.get(k), k


@pytest.mark.parametrize("kind,seed,corrupt", CASES)
def test_host_oracle_matches_reference(kind, seed, corrupt):
    sj, mj, st, mt = _pair(kind, seed, corrupt=corrupt)
    oj = jseq.check_opseq(sj, mj, **OFF)
    ot = tseq.check_opseq(st, mt, **OFF)
    for k in ("valid", "configs", "max_depth", "linearization",
              "final_ops", "final_paths"):
        assert ot.get(k) == oj.get(k), k


def test_routes_of_later_slices_refuse(tmp_path):
    """The routes of queue item A5, the passes of item A7, the
    checkpoints of A3, the decomposition of A8, the sharding of A11 and
    the plan of A12 answer: no option refuses any more."""
    test = {"store_base": str(tmp_path)}
    _, _, st, mt = _pair("register", 1, corrupt=True)
    big = tlin.linearizable(mt, device="cpu", host_threshold=10)
    out = big.check(test, st)
    assert out["valid"] is False and out["engine"].startswith("competition(")
    out = tlin.linearizable(mt, algorithm="competition",
                            device="cpu").check(test, st)
    assert out["valid"] is False and out["engine"].startswith("competition(")
    # the plan of queue item A12 answers (tests/test_torch_plan.py)
    out = tlin.linearizable(mt, device="cpu", explain=True).check(test, st)
    assert out["valid"] == "unknown" and out["configs"] == 0
    assert out["engine"] == "explain(plan-only)"
    # decomposition (queue item A8) answers on every entry point
    # (tests/test_torch_decompose.py)
    out = tlin.linearizable(mt, device="cpu", decompose=True).check(test, st)
    assert out["valid"] is False and out["engine"].startswith("decompose")
    # the checkpoints of queue item A3 answer (tests/test_torch_checkpoint.py)
    ckpt = str(tmp_path / "ckpt")
    out = tcheck_linear(st, mt, checkpoint_path=ckpt, checkpoint_every=1,
                        hb=False)
    assert tcheck_linear(st, mt, resume_from=ckpt)["valid"] == out["valid"]
    assert tcheck_linear(st, mt, decompose=True)["valid"] is False
    assert tlin.search_batch([st], mt, device="cpu",
                             decompose=True)[0]["valid"] is False
    # the mesh-sharded batch of queue item A11 answers
    # (tests/test_torch_sharded_batch.py); a sharding that is not a mesh
    # raises
    from jepsen_tpu_torch.distributed import ShardMesh

    assert tlin.search_batch([st], mt, sharding=ShardMesh(["cpu"] * 2)
                             )[0]["valid"] is False
    with pytest.raises(TypeError):
        tlin.search_batch([st], mt, device="cpu", sharding=object())
    small = tlin.linearizable(mt, device="cpu", host_threshold=10**6)
    out = small.check(test, st)
    assert out["engine"] == "host-oracle" and out["valid"] is False


@pytest.mark.parametrize("flag", ["lint", "hb", "dpor", "audit"])
def test_passes_answer_true(flag, tmp_path):
    """``True`` runs a pass instead of raising, at every entry point."""
    _, _, st, mt = _pair("cas-register", 3, corrupt=True)
    kw = {flag: True}
    want = tseq.check_opseq(st, mt, **OFF)["valid"]
    outs = [tlin.linearizable(mt, device="cpu", host_threshold=10,
                              **kw).check({"store_base": str(tmp_path)},
                                          st),
            tlin.search_opseq(st, mt, device="cpu", **kw),
            tlin.check_competition(st, mt, device="cpu", **kw),
            tseq.check_opseq(st, mt, **kw),
            tcheck_linear(st, mt, **kw)]
    assert [o["valid"] for o in outs] == [want] * len(outs)
    if flag == "audit":
        assert all(o["audit"]["ok"] for o in outs)
    if flag == "dpor":
        assert all("dpor" in o for o in outs[1:2] + outs[3:])


def test_engine_label():
    assert tlin._engine_label(False) == "device-bfs"
    assert tlin._engine_label(True) == "device-bfs(cuda)"
