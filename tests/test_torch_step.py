"""The port's torch slice step against the JAX package's XLA step, in
lockstep: both start from the same root carry and must return the same
live frontier rows (word for word, in order) and the same count, status,
configs, max_depth and overflow after every slice, under both dominance
prunes and with overflow under bail."""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import models as jm
from jepsen_tpu.history import encode_ops
from jepsen_tpu.synth import (corrupt_read, register_history,
                              sim_mutex_history)
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import encode as enc
from jepsen_tpu_torch.checker import step as tstep


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the step's small tensor ops gain nothing from
    more, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(kind, seed):
    rng = random.Random(seed)
    if kind == "mutex":
        h = sim_mutex_history(rng, n_ops=60, n_procs=3, crash_p=0.06,
                              max_crashes=4)
        return jm.mutex(), tm.mutex(), h
    if kind == "overflow":
        h = register_history(rng, n_ops=64, n_procs=8, overlap=7,
                             crash_p=0.05, max_crashes=3, n_values=2)
        return jm.cas_register(), tm.cas_register(), h
    h = register_history(rng, n_ops=56, n_procs=4, overlap=3, crash_p=0.08,
                         max_crashes=4, n_values=3)
    if seed % 2:
        h = corrupt_read(rng, h, at=0.85)
    return jm.cas_register(), tm.cas_register(), h


def _lockstep(jmodel, tmodel, h, *, frontier, bail, mode, slices=12,
              lvl_cap=8, budget=10**8):
    seq = encode_ops(h, jmodel.f_codes)
    es = lin.encode_search(seq)
    dims = lin.choose_dims(es, jmodel, frontier=frontier)
    esp = lin.pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    old = lin._DOMINANCE_MODE, tstep._DOMINANCE_MODE
    lin._DOMINANCE_MODE = tstep._DOMINANCE_MODE = mode
    try:
        jfn = jax.jit(lin.build_search_step_fn(jmodel, dims))
        tfn = tstep.build_search_step_fn(
            tmodel, enc.SearchDims(**dataclasses.asdict(dims)), "cpu")
        jargs = lin.search_args(esp, es)
        targs, tc = enc.from_reference(dataclasses.asdict(esp),
                                       lin._init_carry(dims, jmodel),
                                       device="cpu")
        targs = targs[:15] + (es.n_det, es.n_crash) + targs[17:]
        jc = tuple(jnp.asarray(c) for c in lin._init_carry(dims, jmodel))
        for s in range(slices):
            jc = jfn(*jargs, jnp.int32(budget), jnp.int32(lvl_cap),
                     jnp.bool_(bail), *jc)
            tc = tfn(*targs, budget, lvl_cap, bail, *tc)
            fj, *scal_j = [np.asarray(v) for v in jc]
            ft, *scal_t = enc.to_numpy(tc)
            assert [int(v) for v in scal_j] == [int(v) for v in scal_t], \
                f"slice {s}"
            n = int(scal_j[0])
            assert np.array_equal(fj[:n], ft[:n]), f"slice {s} frontier"
            if int(scal_j[1]) != -1 or n == 0 or (bail and bool(scal_j[4])):
                break
        return [int(v) for v in scal_j]
    finally:
        lin._DOMINANCE_MODE, tstep._DOMINANCE_MODE = old


@pytest.mark.parametrize("mode", ["allpairs", "sort"])
@pytest.mark.parametrize("kind,seed", [("cas-crash", 1), ("cas-crash", 2),
                                       ("mutex", 13)])
def test_step_lockstep(kind, seed, mode):
    jmodel, tmodel, h = _case(kind, seed)
    _lockstep(jmodel, tmodel, h, frontier=16, bail=False, mode=mode)


@pytest.mark.parametrize("mode", ["allpairs", "sort"])
def test_step_lockstep_overflow_under_bail(mode):
    """Frontier 16 overflows on this history: the uncommitted level and
    the bail must match, and so must the truncated run without bail."""
    jmodel, tmodel, h = _case("overflow", 21)
    count, status, _configs, _depth, ovf = _lockstep(
        jmodel, tmodel, h, frontier=16, bail=True, mode=mode)
    assert ovf and status == -1 and count > 0
    *_, ovf = _lockstep(jmodel, tmodel, h, frontier=16, bail=False,
                        mode=mode)
    assert ovf


@pytest.mark.parametrize("bail", [True, False])
@pytest.mark.parametrize("frontier", [128, 256])
def test_step_lockstep_wide_allpairs(frontier, bail):
    """The rungs the CUDA level loop took over from the torch step: the
    port's step pinned to all-pairs (the kernel's oracle) against the JAX
    package's step, on a 12-process cas-register history with crashes
    whose frontier fills hundreds of rows."""
    rng = random.Random(31)
    h = register_history(rng, n_ops=120, n_procs=12, overlap=10,
                         crash_p=0.06, max_crashes=6, n_values=3)
    h = corrupt_read(rng, h, at=0.85)
    count, status, _configs, _depth, ovf = _lockstep(
        jm.cas_register(), tm.cas_register(), h, frontier=frontier,
        bail=bail, mode="allpairs", slices=3)
    assert ovf and status == -1 and count > 0


def test_prune_selection_follows_device():
    assert tstep._DOMINANCE_MODE == "auto"
    assert tstep._use_allpairs(256, torch.device("cuda"))
    assert not tstep._use_allpairs(256, torch.device("cpu"))
    assert not tstep._use_allpairs(16384, torch.device("cuda"))


def test_hash_words_matches_reference():
    rng = np.random.default_rng(5)
    words = rng.integers(-2**31, 2**31, size=(33, 5), dtype=np.int64)
    words = words.astype(np.int32)
    jh = np.asarray(lin._hash_words(jnp.asarray(words).astype(jnp.uint32),
                                    0x9E3779B1))
    th = tstep._hash_words(enc._u32(torch.from_numpy(words)), 0x9E3779B1)
    assert np.array_equal(jh.astype(np.int64), th.numpy())
