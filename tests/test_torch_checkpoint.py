"""Checkpoints of the port's device search and of its ``linear`` sweep
against the JAX package's: a search stopped after a slice and resumed
from its file gives the uninterrupted run's verdict, configs and depth;
a file written by either package resumes in the other; a file of
another history or model refuses to load; the sweep's file keeps the
witness's parent table."""

import json
import random
import threading

import pytest

import jepsen_tpu.checker.linear as jlinear
import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.history import encode_ops as j_encode_ops
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.checker import linear as tlinear
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.history import encode_ops as t_encode_ops
from jepsen_tpu_torch.history import invoke_op, ok_op

OFF = dict(lint=False, hb=False, dpor=False)
KEYS = ("valid", "configs", "max_depth")
BUDGET = 20_000_000


@pytest.fixture(autouse=True)
def _deterministic_driver(monkeypatch):
    """Short first slices, so a search spans several; a level cap that
    does not follow wall time, so both packages slice alike."""
    for mod in (lin, tlin):
        monkeypatch.setattr(mod, "_SLICE_LEVELS0", 8)
        monkeypatch.setattr(mod, "_adapt_lvl_cap",
                            lambda cap, dt, **kw: cap)
    for knob in ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
                 "JEPSEN_TPU_AUDIT"):
        monkeypatch.delenv(knob, raising=False)


def _pair(seed, *, corrupt=True, n_ops=70):
    """(jax seq, jax model, port seq, port model) from one seed."""
    out = []
    for synth, models, encode in ((js, jm, j_encode_ops),
                                  (ts, tm, t_encode_ops)):
        rng = random.Random(seed)
        h = synth.register_history(rng, n_ops=n_ops, n_procs=5, overlap=4,
                                   crash_p=0.05, max_crashes=3, n_values=3)
        if corrupt:
            h = synth.corrupt_read(rng, h, at=0.8)
        model = models.cas_register()
        out += [encode(h, model.f_codes), model]
    return out


def _stop_after(pkg, path, seq, model, slices):
    """An ``on_slice`` hook that checkpoints every slice into ``path``
    and stops the search after ``slices`` of them, and its event."""
    stop = threading.Event()
    seen = [0]

    def hook(carry, dims):
        pkg.save_checkpoint(path, carry, dims, model, BUDGET, seq=seq)
        seen[0] += 1
        if seen[0] >= slices:
            stop.set()
    return hook, stop


def _port_stopped(st, mt, path, slices=2):
    hook, stop = _stop_after(tlin, path, st, mt, slices)
    out = tlin.search_opseq(st, mt, device="cpu", on_slice=hook, stop=stop,
                            **OFF)
    assert out["valid"] == "unknown", "the search ended before its stop"
    return out


def _jax_stopped(sj, mj, path, slices=2):
    hook, stop = _stop_after(lin, path, sj, mj, slices)
    out = lin.search_opseq(sj, mj, on_slice=hook, stop=stop, **OFF)
    assert out["valid"] == "unknown", "the search ended before its stop"
    return out


@pytest.mark.parametrize("seed,corrupt", [(1, True), (3, True), (8, False)])
def test_port_resume_gives_the_uninterrupted_run(seed, corrupt, tmp_path):
    sj, mj, st, mt = _pair(seed, corrupt=corrupt)
    want = tlin.search_opseq(st, mt, device="cpu", **OFF)
    ref = lin.search_opseq(sj, mj, **OFF)
    assert {k: want[k] for k in KEYS} == {k: ref[k] for k in KEYS}
    path = str(tmp_path / "search.npz")
    _port_stopped(st, mt, path)
    out = tlin.resume_opseq(st, mt, path, device="cpu")
    assert {k: out[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert out["engine"] == "device-bfs(resumed)"
    # the JAX package's own resume of its own checkpoint agrees
    jpath = str(tmp_path / "jax.npz")
    _jax_stopped(sj, mj, jpath)
    jout = lin.resume_opseq(sj, mj, jpath)
    assert {k: jout[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert jout["engine"] == out["engine"]


@pytest.mark.parametrize("seed", [1, 3])
def test_checkpoints_cross_load(seed, tmp_path):
    """The file format is shared: the same carry, dims and flags come
    back from either package's file, and each resumes the other's."""
    sj, mj, st, mt = _pair(seed)
    want = tlin.search_opseq(st, mt, device="cpu", **OFF)
    ppath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    _port_stopped(st, mt, ppath)
    _jax_stopped(sj, mj, jpath)
    for a, b in ((ppath, jpath),):
        ca, da, na, ba, ga, ua = tlin.load_checkpoint(a)
        cb, db, nb, bb, gb, ub = lin.load_checkpoint(b)
        assert (da.__dict__, na, ba, ga, ua) == (db.__dict__, nb, bb, gb,
                                                 ub)
        n = int(ca[1])
        assert [int(v) for v in ca[1:]] == [int(v) for v in cb[1:]]
        assert (ca[0][:n] == cb[0][:n]).all()
    out = tlin.resume_opseq(st, mt, jpath, device="cpu")
    jout = lin.resume_opseq(sj, mj, ppath)
    for o in (out, jout):
        assert {k: o[k] for k in KEYS} == {k: want[k] for k in KEYS}
        assert o["engine"] == "device-bfs(resumed)"


def test_history_digest_matches_reference():
    for seed in (1, 2, 3):
        sj, mj, st, mt = _pair(seed)
        assert tlin.history_digest(st, mt) == lin.history_digest(sj, mj)
    # the model's parameters bind: register(0) and register(7) differ
    _, _, st, _ = _pair(1)
    assert tlin.history_digest(st, tm.register(0)) != \
        tlin.history_digest(st, tm.register(7))


def test_mismatched_checkpoint_refuses(tmp_path):
    _, _, st, mt = _pair(1)
    path = str(tmp_path / "search.npz")
    _port_stopped(st, mt, path)
    _, _, other, _ = _pair(2)
    with pytest.raises(ValueError, match="digest"):
        tlin.resume_opseq(other, mt, path, device="cpu")
    with pytest.raises(ValueError, match="model"):
        tlin.resume_opseq(st, tm.register(0), path, device="cpu")


def test_save_outside_a_driver_records_no_kernel(tmp_path):
    """``used_pallas`` comes from the active slice driver only: a save
    from outside one records False, as in the reference; a driver that
    ran no kernel (the CPU) records False too."""
    _, _, st, mt = _pair(1)
    es = tlin.encode_search(st)
    dims = tlin.choose_dims(es, mt, device="cpu")
    carry = tlin._init_carry(dims, mt)
    path = str(tmp_path / "bare.npz")
    tlin.save_checkpoint(path, carry, dims, mt, BUDGET, seq=st)
    assert tlin.load_checkpoint(path)[5] is False
    _port_stopped(st, mt, path)
    assert tlin.load_checkpoint(path)[5] is False


def test_resume_stopped_again_is_a_checkpoint(tmp_path):
    """A resumed search stopped once more leaves a checkpoint that
    resumes to the same answer."""
    _, _, st, mt = _pair(3)
    want = tlin.search_opseq(st, mt, device="cpu", **OFF)
    path = str(tmp_path / "a.npz")
    _port_stopped(st, mt, path, slices=1)
    path2 = str(tmp_path / "b.npz")
    hook, stop = _stop_after(tlin, path2, st, mt, 1)
    mid = tlin.resume_opseq(st, mt, path, device="cpu", on_slice=hook,
                            stop=stop)
    assert mid["valid"] == "unknown"
    out = tlin.resume_opseq(st, mt, path2, device="cpu")
    assert {k: out[k] for k in KEYS} == {k: want[k] for k in KEYS}


# ---------------------------------------------------------------------------
# the linear sweep
# ---------------------------------------------------------------------------


def _linear_pair(seed, *, corrupt, n_ops=60):
    return _pair(seed, corrupt=corrupt, n_ops=n_ops)


@pytest.mark.parametrize("seed,corrupt", [(41, True), (5, False)])
def test_linear_checkpoint_matches_reference(seed, corrupt, tmp_path):
    """The sweep's file, byte for byte the reference's, and the resumed
    verdict, configs and depth of both packages."""
    sj, mj, st, mt = _linear_pair(seed, corrupt=corrupt)
    pj, pt = str(tmp_path / "jax.ck"), str(tmp_path / "port.ck")
    oj = jlinear.check_opseq_linear(sj, mj, checkpoint_path=pj,
                                    checkpoint_every=3)
    ot = tlinear.check_opseq_linear(st, mt, checkpoint_path=pt,
                                    checkpoint_every=3)
    assert {k: ot.get(k) for k in KEYS} == {k: oj.get(k) for k in KEYS}
    assert json.load(open(pt)) == json.load(open(pj))
    assert json.load(open(pt))["depth"] > 0
    # each resumes the other's file
    rj = jlinear.check_opseq_linear(sj, mj, resume_from=pt)
    rt = tlinear.check_opseq_linear(st, mt, resume_from=pj)
    assert {k: rt.get(k) for k in KEYS} == {k: rj.get(k) for k in KEYS}
    assert rt["valid"] == ot["valid"]


def test_linear_checkpoint_chain_keeps_its_witness(tmp_path):
    """With the parent table in the file, a resumed valid verdict still
    carries the full witness; without a cap it says why it has none;
    from a witnessless file it says that."""
    sj, mj, st, mt = _linear_pair(5, corrupt=False)
    path = str(tmp_path / "lin.ck")
    base = tlinear.check_opseq_linear(st, mt, witness_cap=500_000,
                                      checkpoint_path=path,
                                      checkpoint_every=3)
    assert base["valid"] is True and base["linearization"]
    assert "parents" in json.load(open(path))
    r = tlinear.check_opseq_linear(st, mt, witness_cap=500_000,
                                   resume_from=path)
    jr = jlinear.check_opseq_linear(sj, mj, witness_cap=500_000,
                                    resume_from=path)
    assert r["valid"] is True and r["linearization"] == jr["linearization"]
    assert r["linearization"] == base["linearization"]
    r2 = tlinear.check_opseq_linear(st, mt, resume_from=path)
    assert r2["valid"] is True and "witness_cap=0" in r2["witness_dropped"]
    nolin = str(tmp_path / "nolin.ck")
    tlinear.check_opseq_linear(st, mt, checkpoint_path=nolin,
                               checkpoint_every=3)
    r3 = tlinear.check_opseq_linear(st, mt, witness_cap=500_000,
                                    resume_from=nolin)
    assert r3["valid"] is True
    assert "witnessless checkpoint" in r3["witness_dropped"]


def test_linear_checkpoint_refuses_another_history(tmp_path):
    _, _, st, mt = _linear_pair(41, corrupt=True)
    path = str(tmp_path / "lin.ck")
    tlinear.check_opseq_linear(st, mt, checkpoint_path=path,
                               checkpoint_every=3)
    h = [invoke_op(0, "write", 1), ok_op(0, "write", 1)]
    other = t_encode_ops(h, mt.f_codes)
    with pytest.raises(ValueError, match="digest"):
        tlinear.check_opseq_linear(other, mt, resume_from=path)
    with pytest.raises(ValueError, match="model"):
        tlinear.check_opseq_linear(st, tm.register(0), resume_from=path)
