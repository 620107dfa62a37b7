"""The fused level loop's plain version against the JAX package's Pallas
kernel (interpret mode), in lockstep on the Pallas kernel's own test
histories, and the wrapper's device rule.  The CUDA kernel itself is
tested on the card by tests/test_torch_cuda.py."""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import models as jm
from jepsen_tpu.checker import pallas_level as plev
from jepsen_tpu.history import encode_ops
from jepsen_tpu.synth import (corrupt_read, register_history,
                              sim_mutex_history)
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import encode as enc
from jepsen_tpu_torch.checker import level_kernel as lk
from jepsen_tpu_torch.checker import step as tstep
from jepsen_tpu_torch.checker.linearizable import linearizable, search_opseq
from jepsen_tpu_torch.history import encode_ops as t_encode_ops
from jepsen_tpu_torch.synth import register_history as t_register_history

_PALLAS: dict = {}


def _pallas(model, dims):
    """One interpreted Pallas step per (model, dims): cases that share
    dims share a compile."""
    key = (model.name, dims)
    if key not in _PALLAS:
        _PALLAS[key] = jax.jit(plev.build_pallas_step_fn(model, dims,
                                                         interpret=True))
    return _PALLAS[key]


def _history(kind, seed):
    rng = random.Random(seed)
    if kind == "mutex":
        return jm.mutex(), tm.mutex(), sim_mutex_history(
            rng, n_ops=60, n_procs=3, crash_p=0.06, max_crashes=4)
    if kind == "overflow":
        return jm.cas_register(), tm.cas_register(), register_history(
            rng, n_ops=64, n_procs=8, overlap=7, crash_p=0.05,
            max_crashes=3, n_values=2)
    h = register_history(rng, n_ops=56, n_procs=4, overlap=3, crash_p=0.08,
                         max_crashes=4, n_values=3)
    if seed % 2:
        h = corrupt_read(rng, h, at=0.85)
    return jm.cas_register(), tm.cas_register(), h


def _prepare(jmodel, h, frontier):
    seq = encode_ops(h, jmodel.f_codes)
    es = lin.encode_search(seq)
    dims = lin.choose_dims(es, jmodel, frontier=frontier)
    esp = lin.pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    return es, dims, esp


def _lockstep(kind, seed, *, bail, slices=6, lvl_cap=16, budget=10**8):
    jmodel, tmodel, h = _history(kind, seed)
    es, dims, esp = _prepare(jmodel, h, 16)
    tdims = enc.SearchDims(**dataclasses.asdict(dims))
    assert plev.eligible(jmodel, dims) and lk.eligible(tmodel, tdims)
    pal = _pallas(jmodel, dims)
    jargs = lin.search_args(esp, es)
    targs, tc = enc.from_reference(dataclasses.asdict(esp),
                                   lin._init_carry(dims, jmodel), "cpu")
    targs = targs[:15] + (es.n_det, es.n_crash) + targs[17:]
    jc = tuple(jnp.asarray(c) for c in lin._init_carry(dims, jmodel))
    for s in range(slices):
        jc = pal(*jargs, jnp.int32(budget), jnp.int32(lvl_cap),
                 jnp.bool_(bail), *jc)
        tc = lk.level_loop_reference(tmodel, tdims, *targs, budget,
                                     lvl_cap, bail, *tc)
        fj, *scal_j = [np.asarray(v) for v in jc]
        ft, *scal_t = enc.to_numpy(tc)
        assert [int(v) for v in scal_j] == [int(v) for v in scal_t], \
            f"slice {s}"
        n = int(scal_j[0])
        assert np.array_equal(fj[:n], ft[:n]), f"slice {s} frontier"
        if int(scal_j[1]) != -1 or n == 0 or (bail and bool(scal_j[4])):
            break
    return [int(v) for v in scal_j]


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_reference_matches_pallas_cas_with_crashes(seed):
    _lockstep("cas-crash", seed, bail=False)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_reference_matches_pallas_mutex(seed):
    _lockstep("mutex", seed, bail=False)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_reference_matches_pallas_overflow_and_bail(seed):
    *_, ovf = _lockstep("overflow", seed, bail=True)
    assert ovf
    _lockstep("overflow", seed, bail=False)


def _cpu_case():
    model = tm.cas_register()
    h = t_register_history(random.Random(2), n_ops=40, n_procs=4,
                           overlap=3, crash_p=0.08, max_crashes=3,
                           n_values=3)
    seq = t_encode_ops(h, model.f_codes)
    es = enc.encode_search(seq)
    dims = enc.choose_dims(es, model, device="cpu", frontier=16)
    esp = enc.pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    args = enc.search_args(esp, es, device="cpu")
    carry = enc.carry_to_device(enc._init_carry(dims, model), "cpu")
    return model, seq, dims, args, carry


def test_wrapper_takes_plain_path_for_cpu_tensors():
    model, _seq, dims, args, carry = _cpu_case()
    before = lk.LAUNCHES
    out = lk.level_loop(model, dims, *args, 10**8, 8, False, *carry)
    ref = lk.level_loop_reference(model, dims, *args, 10**8, 8, False,
                                  *carry)
    assert lk.LAUNCHES == before
    n = int(ref[1])
    assert [int(v) for v in out[1:]] == [int(v) for v in ref[1:]]
    assert torch.equal(out[0][:n], ref[0][:n])
    fn = lk.build_level_loop_fn(model, dims)
    again = fn(*args, 10**8, 8, False, *carry)
    assert [int(v) for v in again[1:]] == [int(v) for v in ref[1:]]


_BASE_DIMS = dict(n_det_pad=64, n_crash_pad=32, window=64, k=16,
                  state_width=1, frontier=64)


@pytest.mark.parametrize("frontier,ok", [(16, True), (64, True),
                                         (128, True), (512, True),
                                         (2048, True), (4096, False)])
def test_eligibility_bounds(frontier, ok):
    """The kernel takes every rung where the card's torch step prunes
    all-pairs at both of its sites (2F and 4F rows), and no other."""
    model = tm.cas_register()
    dims = enc.SearchDims(**{**_BASE_DIMS, "frontier": frontier})
    assert lk.eligible(model, dims) is ok
    cuda = torch.device("cuda")
    assert ok == (tstep._use_allpairs(2 * frontier, cuda)
                  and tstep._use_allpairs(4 * frontier, cuda))


def test_kernel_source_takes_the_eligible_range():
    """The C entry point's own frontier bound (MAXF in level_loop.cu)
    is the widest rung :func:`eligible` takes on the width grid."""
    import re
    from pathlib import Path

    src = (Path(lk.__file__).resolve().parents[1] / "csrc"
           / "level_loop.cu").read_text()
    maxf = int(re.search(r"^#define MAXF (\d+)", src, re.M).group(1))
    model = tm.cas_register()
    widths = [16 << i for i in range(10)]
    took = [f for f in widths
            if lk.eligible(model, enc.SearchDims(**{**_BASE_DIMS,
                                                   "frontier": f}))]
    assert max(took) == maxf


@pytest.mark.parametrize("key,val", [("window", 96), ("n_crash_pad", 96),
                                     ("state_width", 5)])
def test_eligibility_refuses_wide_masks(key, val):
    model = tm.cas_register()
    assert not lk.eligible(model,
                           enc.SearchDims(**{**_BASE_DIMS, key: val}))


@pytest.mark.parametrize("mode", ["allpairs", "sort"])
def test_eligibility_follows_the_default_prune_mode(monkeypatch, mode):
    """A test that pins the step's prune mode does not move the kernel's
    range: eligibility is a function of the model and the dims only."""
    model = tm.cas_register()
    monkeypatch.setattr(tstep, "_DOMINANCE_MODE", mode)
    for frontier, ok in ((64, True), (2048, True), (4096, False)):
        dims = enc.SearchDims(**{**_BASE_DIMS, "frontier": frontier})
        assert lk.eligible(model, dims) is ok


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, seq, *_ = _cpu_case()
    with pytest.raises(RuntimeError, match="cuda"):
        search_opseq(seq, model, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        linearizable(model, algorithm="device").check({}, seq)


@pytest.mark.parametrize("masked,dedup", [(True, False), (False, True),
                                          (True, True)])
def test_eligibility_declines_reduced_searches(masked, dedup):
    """The kernel computes the unreduced search: a masked or dedup
    search runs the torch step, at every rung, as the JAX package's
    ``pallas_level.eligible`` declines them."""
    model = tm.cas_register()
    for frontier in (16, 64, 2048):
        dims = enc.SearchDims(**{**_BASE_DIMS, "frontier": frontier})
        assert lk.eligible(model, dims)
        assert not lk.eligible(model, dims, masked=masked, dedup=dedup)
        jdims = lin.SearchDims(**dataclasses.asdict(dims))
        if frontier <= 64:
            assert plev.eligible(jm.cas_register(), jdims)
            assert not plev.eligible(jm.cas_register(), jdims,
                                     masked=masked, dedup=dedup)


def _reduced_case():
    """The CPU case's history with its reduction planes attached."""
    from jepsen_tpu_torch.analyze.hb import maybe_hb

    model, seq, dims, _args, carry = _cpu_case()
    es = enc.attach_reductions(enc.encode_search(seq), seq, model,
                               maybe_hb(seq, model).must_pred, dedup=True)
    assert es.masked and es.dedup
    return model, dims, es, carry


@pytest.mark.parametrize("plane", ["mask", "dead", "both"])
def test_wrapper_refuses_live_planes(plane):
    """Neither the kernel nor its plain version reads the planes, so
    the wrapper refuses them on every device rather than ignore them."""
    model, dims, es, carry = _reduced_case()
    if plane == "mask":
        es.dedup, es.dead_from = False, None
    elif plane == "dead":
        es.masked, es.det_mpred, es.crash_mpred = False, None, None
        es.det_cpred = es.crash_cpred = None
    esp = enc.pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    args = enc.search_args(esp, es, device="cpu")
    before = lk.LAUNCHES
    with pytest.raises(ValueError, match="not inert"):
        lk.level_loop(model, dims, *args, 10**8, 8, False, *carry)
    assert lk.LAUNCHES == before
    # the same planes drive the masked torch step
    red = dict(masked=esp.masked, masked_crash=esp.mask_has_crash,
               dedup=esp.dedup)
    out = tstep.build_search_step_fn(model, dims, "cpu", **red)(
        *args, 10**8, 8, False, *carry)
    assert int(out[3]) > 0


def test_kernel_route_strips_reductions(monkeypatch):
    """Where the kernel takes the starting rung, the search drops its
    reductions for the whole search (``device_masked`` False), as the
    JAX package does for its Pallas kernel; the planes the kernel then
    receives are inert."""
    from jepsen_tpu_torch.checker import linearizable as tlin
    from jepsen_tpu_torch.synth import corrupt_read as t_corrupt_read

    model = tm.cas_register()
    rng = random.Random(2)
    h = t_corrupt_read(rng, t_register_history(
        rng, n_ops=40, n_procs=4, overlap=3, crash_p=0.08, max_crashes=3,
        n_values=3), at=0.8)
    seq = t_encode_ops(h, model.f_codes)

    monkeypatch.setattr(tlin, "_use_kernel",
                        lambda m, d, dev, masked=False, dedup=False:
                        not masked and not dedup)
    out = tlin.search_opseq(seq, model, device="cpu")
    assert out["dpor"] == {"enabled": True, "device_masked": False,
                           "device_mask_rows": 0, "dedup": False}
    assert out["engine"] == "device-bfs(cuda)"
    unreduced = tlin.search_opseq(seq, model, device="cpu", hb=False,
                                  dpor=False)
    assert (out["valid"], out["configs"]) == (unreduced["valid"],
                                              unreduced["configs"])
