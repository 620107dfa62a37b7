"""The port's sharded-frontier search (B7, ``search_opseq_sharded``) on
``ShardMesh(["cpu"] * 8)`` against the JAX package's on its 8-device
virtual CPU mesh (``tests/conftest.py``):

  * the cases of ``tests/test_sharded.py``: six seeds, the 220-op
    history, escalation from ``frontier_per_device=64`` and from 8 with
    ``_SLICE_LEVELS0`` pinned on both sides, and the deadline and slice
    hook; whole results equal (verdict, configs, depth, engine,
    frontier, the certificates' drop reasons, the prepass stats and the
    ``search_telemetry`` block);
  * lockstep: one sharded slice from the same inputs and carry in both
    packages gives the same live rows per shard in order, the same
    counts and scalars and the same per-shard telemetry blocks, with
    the prune by sort (the CPU's) and all-pairs (the card's).

The level cap follows wall time in both packages, so it is pinned on
both sides: the slices, and so the carries an escalation resumes from,
are the same.  Everything compared is integer: the comparison is
exact."""

import random
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.analyze.hb import maybe_hb as j_maybe_hb
from jepsen_tpu.history import encode_ops as j_encode_ops
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.analyze.hb import maybe_hb as t_maybe_hb
from jepsen_tpu_torch.checker import encode as tenc
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import step as tstep
from jepsen_tpu_torch.distributed import ShardMesh
from jepsen_tpu_torch.history import encode_ops as t_encode_ops

D = 8
TMESH = ShardMesh(["cpu"] * D)
FIELDS = ("valid", "configs", "max_depth", "engine", "frontier_per_device",
          "witness_dropped", "frontier_dropped", "linearization", "hb",
          "constraints", "search_telemetry")


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """The level cap pinned in both packages, the JAX package's knobs
    unset (its defaults: telemetry, prepass and DPOR on), torch on one
    thread."""
    for mod in (lin, tlin):
        monkeypatch.setattr(mod, "_adapt_lvl_cap",
                            lambda cap, dt, target_s=None: cap)
    for knob in ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
                 "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_TELEMETRY",
                 "JEPSEN_TPU_DOMINANCE"):
        monkeypatch.delenv(knob, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < D:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return Mesh(np.array(devs[:D]), ("shard",))


def _pair(seed, *, corrupt=None, **kw):
    """(jax seq, jax model, port seq, port model) of one
    ``register_history`` on cas-register."""
    out = []
    for synth, models, encode in ((js, jm, j_encode_ops),
                                  (ts, tm, t_encode_ops)):
        rng = random.Random(seed)
        model = models.cas_register()
        h = synth.register_history(rng, **kw)
        if corrupt is not None:
            h = synth.corrupt_read(rng, h, at=corrupt)
        out += [encode(h, model.f_codes), model]
    return out


def _same(ref: dict, got: dict) -> None:
    for f in FIELDS:
        assert got.get(f) == ref.get(f), (f, ref.get(f), got.get(f))


def _both(mesh, seed, frontier, hist, **kw):
    sj, mj, st, mt = _pair(seed, **hist)
    ref = lin.search_opseq_sharded(sj, mj, mesh, frontier_per_device=frontier,
                                   **kw)
    got = tlin.search_opseq_sharded(st, mt, TMESH,
                                    frontier_per_device=frontier, **kw)
    _same(ref, got)
    return ref, got


@pytest.mark.parametrize("seed", range(6))
def test_sharded_matches_reference(mesh, seed):
    """The six seeds of the reference's own test, prepass and DPOR off
    (one compiled shape on the JAX side; the reductions ride the cases
    below)."""
    ref, got = _both(mesh, seed, 128, dict(
        n_ops=50, n_procs=6, overlap=4, crash_p=0.1,
        corrupt=0.9 if seed % 2 else None), hb=False, dpor=False)
    if got["engine"].startswith("device-sharded"):
        assert got["engine"] == f"device-sharded-x{D}"
        assert got["search_telemetry"]["levels"] > 0


#: the reference's 220-op case (16 processes, crashed ops, one corrupted
#: read); 64 rows per shard hold it, so it is also the case from 64 and
#: the deadline case's history
H220 = dict(n_ops=220, n_procs=16, overlap=6, crash_p=0.01, max_crashes=4,
            corrupt=0.95)


def test_sharded_220_ops_from_64_matches_reference(mesh):
    ref, got = _both(mesh, 42, 64, H220, audit=True)
    assert got["valid"] is False and got["frontier_dropped"]
    assert got["engine"] == f"device-sharded-x{D}"
    assert got["frontier_per_device"] == 64
    assert got["search_telemetry"]["mask_killed"] > 0


#: a history that outgrows 8 rows per shard (and the lockstep's)
SEED915 = dict(n_ops=40, n_procs=6, overlap=4, crash_p=0.1, corrupt=0.8)


def test_sharded_escalation_resumes_from_8(mesh, monkeypatch):
    """Short slices (``_SLICE_LEVELS0`` = 4 on both sides), so the
    escalations resume from carries in the middle of the search."""
    monkeypatch.setattr(lin, "_SLICE_LEVELS0", 4)
    monkeypatch.setattr(tlin, "_SLICE_LEVELS0", 4)
    ref, got = _both(mesh, 915, 8, SEED915, budget=500_000, hb=False,
                     dpor=False)
    assert got["frontier_per_device"] > 8
    assert got["search_telemetry"]["overflows"] > 0
    assert got["search_telemetry"]["slices"] > 2


def test_sharded_deadline_and_slice_hook(mesh):
    """A deadline already past: one slice, then "unknown" (not a hang),
    and the hook sees every slice's global carry and dims."""
    seen = {"ref": [], "port": []}
    sj, mj, st, mt = _pair(42, **H220)
    ref = lin.search_opseq_sharded(
        sj, mj, mesh, frontier_per_device=64,
        deadline=time.perf_counter() - 1.0,
        on_slice=lambda c, dims: seen["ref"].append(
            (np.asarray(c[0]).shape, dims.frontier)))
    got = tlin.search_opseq_sharded(
        st, mt, TMESH, frontier_per_device=64,
        deadline=time.perf_counter() - 1.0,
        on_slice=lambda c, dims: seen["port"].append(
            (tuple(c[0].shape), dims.frontier)))
    _same(ref, got)
    assert got["valid"] == "unknown"
    assert len(seen["port"]) == 1 and seen["port"] == seen["ref"]
    assert seen["port"][0][0][0] == D * 64


def _lockstep_inputs(frontier, reductions: bool):
    """Each package's (model, dims, padded encoding, step args) of the
    SEED915 history, with its reductions attached or not, as
    ``search_opseq_sharded`` builds them."""
    sj, mj, st, mt = _pair(915, **SEED915)
    out = []
    for pkg, seq, model, hb_fn, kw in (
            (lin, sj, mj, j_maybe_hb, {}),
            (tenc, st, mt, t_maybe_hb, {"device": "cpu"})):
        es = pkg.encode_search(seq)
        if reductions:
            pkg.attach_reductions(es, seq, model,
                                  hb_fn(seq, model, True, True).must_pred,
                                  dedup=True)
        dims = pkg.choose_dims(es, model, frontier=frontier, **kw)
        esp = pkg.pad_search(es, dims.n_det_pad, dims.n_crash_pad)
        out.append((model, dims, esp, pkg.search_args(esp, es, **kw)))
    assert out[0][1].__dict__ == out[1][1].__dict__
    return out


def _reference_step(model, dims, esp, mesh):
    """The JAX package's sharded step with telemetry, as its search
    builds it: from its kernel cache when a search already compiled it
    (one compiled shape fewer), else built here."""
    masked, mcrash, dedup, vt = lin._reduction_key(esp)
    key = (model.name, dims, "shard",
           (tuple(mesh.shape.items()), tuple(d.id for d in mesh.devices.flat)),
           lin._dominance_key(), masked, mcrash, dedup, vt, True)
    fn = lin._SHARDED_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lin.build_sharded_search_step_fn(
            model, dims, mesh, "shard", masked=masked, masked_crash=mcrash,
            dedup=dedup, telemetry=True))
    return fn


def _root_carry(dims, model):
    fr = np.zeros((D * dims.frontier, dims.words), np.int32)
    fr[0] = lin._init_config(dims, model)
    count = np.zeros(D, np.int32)
    count[0] = 1
    return (fr, count, np.int32(-1), np.int32(0), np.int32(0),
            np.bool_(False), np.int32(1))


def _assert_lockstep(cj, ct, F):
    cj = [np.asarray(x) for x in cj]
    ct = [x.numpy() for x in ct]
    assert (cj[1] == ct[1]).all(), (cj[1], ct[1])
    for d in range(D):
        n = int(cj[1][d])
        assert (cj[0][d * F:d * F + n] == ct[0][d * F:d * F + n]).all(), d
    for i in range(2, 7):
        assert int(cj[i]) == int(ct[i]), (i, cj[i], ct[i])
    assert (cj[7] == ct[7]).all()  # the per-shard telemetry blocks


@pytest.mark.parametrize("mode,reductions", [("auto", False),
                                             ("allpairs", True)])
def test_sharded_slice_lockstep(mesh, monkeypatch, mode, reductions):
    """Slices of 4 levels at 8 rows per shard from the root, each from
    the reference's carry: the crash closure routes rows every round.
    The CPU's prune (by sort) unreduced, until the frontier
    overflows and bails, and all-pairs (the card's) with the mask and
    the dedup."""
    monkeypatch.setattr(lin, "_DOMINANCE_MODE", mode)
    monkeypatch.setattr(tstep, "_DOMINANCE_MODE", mode)
    F = 8
    (mj, dj, pj, aj), (mt, dt, pt, at) = _lockstep_inputs(F, reductions)
    red = tlin._reduction_key(pt)
    assert red == tuple(lin._reduction_key(pj)[:3])
    assert red[0] == red[2] == reductions
    fj = _reference_step(mj, dj, pj, mesh)
    ft = tlin.build_sharded_search_step_fn(
        mt, dt, TMESH, "shard", masked=red[0], masked_crash=red[1],
        dedup=red[2], telemetry=True)
    carry = _root_carry(dj, mj)
    for _ in range(8):
        cj = fj(*aj, np.int32(2_000_000), np.int32(4), np.bool_(True),
                *carry)
        ct = ft(*at, 2_000_000, 4, True,
                *(torch.as_tensor(np.array(c)) for c in carry))
        _assert_lockstep(cj, ct, F)
        carry = tuple(np.asarray(c) for c in cj[:7])
        if int(carry[2]) != -1 or bool(carry[5]) or int(carry[6]) == 0:
            break
    if not reductions:
        assert bool(carry[5]), "no slice overflowed"
