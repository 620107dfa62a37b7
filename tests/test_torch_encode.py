"""The port's host encoding against the JAX package's: the same synth
history through both packages must give byte-equal encodings, padded
tables, dims and root carries, and the carry/encoding exchange
(``from_reference``/``to_numpy``) must round-trip word for word."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.history import encode_ops as j_encode_ops
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.checker import encode as enc
from jepsen_tpu_torch.history import encode_ops as t_encode_ops

CPU = torch.device("cpu")


def _histories(kind, seed):
    """The same history built by both packages' synth from one seed."""
    out = []
    for synth, models in ((js, jm), (ts, tm)):
        rng = random.Random(seed)
        if kind == "mutex":
            h = synth.sim_mutex_history(rng, n_ops=70, n_procs=4,
                                        crash_p=0.05, max_crashes=5)
            model = models.mutex()
        else:
            crash = kind == "cas-crash"
            h = synth.register_history(
                rng, n_ops=80, n_procs=5, overlap=4,
                crash_p=0.06 if crash else 0.0, max_crashes=4,
                n_values=3, cas=crash)
            h = synth.corrupt_read(rng, h, at=0.6)
            model = models.cas_register() if crash else models.register(0)
        out.append((h, model))
    return out


def _pair(kind, seed):
    (hj, mj), (ht, mt) = _histories(kind, seed)
    return (j_encode_ops(hj, mj.f_codes), mj,
            t_encode_ops(ht, mt.f_codes), mt)


def _assert_same_fields(a, b):
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            assert va.shape == vb.shape and np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name


CASES = [(k, s) for k in ("register", "cas-crash", "mutex")
         for s in (1, 2)]


@pytest.mark.parametrize("kind,seed", CASES)
def test_history_encoding_matches_reference(kind, seed):
    sj, _, st, _ = _pair(kind, seed)
    for col in ("process", "f", "v1", "v2", "inv", "ret", "ok"):
        a, b = getattr(sj, col), getattr(st, col)
        assert a.dtype == b.dtype and np.array_equal(a, b), col


@pytest.mark.parametrize("kind,seed", CASES)
def test_encode_pad_dims_carry_match_reference(kind, seed):
    sj, mj, st, mt = _pair(kind, seed)
    ej, et = lin.encode_search(sj), enc.encode_search(st)
    _assert_same_fields(ej, et)
    dj = lin.choose_dims(ej, mj)
    dt = enc.choose_dims(et, mt, device=CPU)
    assert dataclasses.asdict(dj) == dataclasses.asdict(dt)
    pj = lin.pad_search(ej, dj.n_det_pad, dj.n_crash_pad)
    pt = enc.pad_search(et, dt.n_det_pad, dt.n_crash_pad)
    _assert_same_fields(pj, pt)
    for a, b in zip(lin._init_carry(dj, mj), enc._init_carry(dt, mt)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind,seed", CASES[:3])
def test_from_reference_to_numpy_round_trip(kind, seed):
    sj, mj, st, mt = _pair(kind, seed)
    ej = lin.encode_search(sj)
    dj = lin.choose_dims(ej, mj)
    pj = lin.pad_search(ej, dj.n_det_pad, dj.n_crash_pad)
    carry = list(lin._init_carry(dj, mj))
    # a carry with bit 31 set in a window word must survive the trip
    carry[0] = carry[0].copy()
    carry[0][0, 1] = np.int32(-2**31)
    args, tcarry = enc.from_reference(dataclasses.asdict(pj), tuple(carry),
                                      device="cpu")
    jargs = lin.search_args(pj, ej)
    assert len(args) == len(jargs) == 19
    for a, b in zip(enc.to_numpy(args), jargs):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    back = enc.to_numpy(tcarry)
    for a, b in zip(back, carry):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)
    assert tcarry[0].dtype == torch.int32 and tcarry[5].dtype == torch.bool


def test_pack_unpack_bits_match_reference():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, size=(9, 64)).astype(bool)
    bits[0] = True  # all ones: both words hold bit 31
    jw = np.asarray(lin._pack_bits(jnp.asarray(bits), 2))
    tw = enc._pack_bits(torch.from_numpy(bits), 2)
    assert tw.dtype == torch.int32
    assert np.array_equal(jw, tw.numpy())
    assert np.array_equal(enc._unpack_bits(tw, 2).numpy(), bits)


def test_width_floor_follows_device():
    assert enc._grid_width(1, torch.device("cpu")) == 16
    assert enc._grid_width(1, torch.device("cuda")) == 64
    assert enc._grid_width(100, torch.device("cuda")) == 128
    assert enc._grid_width(10**9, CPU) == enc.MAX_FRONTIER
