"""The port's batch of independent keys against the JAX package's:
``search_batch`` per key (verdict, configs, depth, engine and the
certificate fields), bucketed and fused, with the reductions on and off,
over keys with crashed ops, a key past ``MAX_CRASH``, duplicate keys,
and keys the greedy witness or the prepass decides; the grid form's
plain version against the JAX package's vmapped step; and the stacking
and refusals of the grid wrapper.

On the CPU both packages prune by sort, and each key of the port's
batch runs the torch step alone, which a lane of the JAX package's
vmapped step equals: the comparison is exact."""

import random

import numpy as np
import pytest
import torch

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.history import encode_ops as j_encode_ops
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.checker import encode as tenc
from jepsen_tpu_torch.checker import level_kernel as lk
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import step as tstep
from jepsen_tpu_torch.history import encode_ops as t_encode_ops

OFF = dict(hb=False, dpor=False)
FIELDS = ("valid", "configs", "max_depth", "engine", "linearization",
          "witness_dropped", "frontier_dropped", "final_ops", "info")

#: (seed, corrupt) of 30-op cas-register keys: device-searched valid and
#: invalid keys, one the greedy witness decides, one the prepass decides
#: ("b-27"), and a wide one that climbs past the first rung
KEYS = (("b-0", False), ("b-1", True), ("b-4", False), ("b-7", True),
        ("b-24", False), ("b-27", True), ("b-9", True))


@pytest.fixture(autouse=True)
def _reference_knobs(monkeypatch):
    for knob in ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
                 "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_BATCH_BUCKETS"):
        monkeypatch.delenv(knob, raising=False)


def _keys(pkg_synth, models, encode):
    m = models.cas_register()
    out = []
    for seed, corrupt in KEYS:
        rng = random.Random(seed)
        h = pkg_synth.register_history(rng, n_ops=30, n_procs=5, overlap=4,
                                       crash_p=0.05, max_crashes=3,
                                       n_values=3)
        if corrupt:
            h = pkg_synth.corrupt_read(rng, h, at=0.7)
        out.append(encode(h, m.f_codes))
    rng = random.Random("wide")
    out.append(encode(pkg_synth.register_history(
        rng, n_ops=40, n_procs=8, overlap=7, crash_p=0.12, max_crashes=6,
        n_values=2), m.f_codes))
    out.append(out[1])  # a duplicate key
    # past MAX_CRASH: the host sweep decides it (the port's synth builds
    # it; the JAX package gets the same ops)
    h = ts.crash_heavy_register_history(
        random.Random("heavy"), n_ops=40, n_procs=6, overlap=4, n_values=3,
        n_crash=70, corrupt=True)
    if pkg_synth is js:
        h = [jh.Op(process=o.process, type=o.type, f=o.f, value=o.value)
             for o in h]
    out.append(encode(h, m.f_codes))
    return out, m


@pytest.fixture(scope="module")
def keys():
    sj, mj = _keys(js, jm, j_encode_ops)
    st, mt = _keys(ts, tm, t_encode_ops)
    return sj, mj, st, mt


def _same(rj, rt):
    assert len(rj) == len(rt)
    for k, (a, b) in enumerate(zip(rj, rt)):
        assert {f: b.get(f) for f in FIELDS} == \
            {f: a.get(f) for f in FIELDS}, f"key {k}"


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("reductions", ["on", "off"])
def test_search_batch_matches_reference(keys, bucket, reductions):
    """Bucketed over every key; fused over the keys the encoding takes
    (one key past it sends a fused batch solo, the next test)."""
    sj, mj, st, mt = keys
    if not bucket:
        sj, st = sj[:-1], st[:-1]
    kw = {} if reductions == "on" else OFF
    rj = lin.search_batch(sj, mj, bucket=bucket, **kw)
    rt = tlin.search_batch(st, mt, bucket=bucket, device="cpu", **kw)
    _same(rj, rt)
    engines = {r["engine"] for r in rt}
    assert {"device-batch", "greedy-witness"} <= engines
    assert ("host-linear(fallback)" in engines) == bucket
    if reductions == "on":
        assert "hb-decide" in engines
    if bucket:
        st_j = dict(rj[0]["bucket_batch"])
        st_t = dict(rt[0]["bucket_batch"])
        for s in (st_j, st_t):
            s.pop("seconds")
            s.pop("kernel_cache")
            for b in s["buckets"]:
                b.pop("seconds")
        assert st_t == st_j
    else:
        assert "bucket_batch" not in rt[0]


def test_fused_batch_with_a_key_past_the_encoding_goes_solo(keys):
    """A fused batch holding a key past ``MAX_CRASH`` sends that key to
    the host sweep and every other key to its own search, as the
    reference does."""
    sj, mj, st, mt = keys
    sj, st = sj[:2] + sj[-1:], st[:2] + st[-1:]
    rj = lin.search_batch(sj, mj, bucket=False, **OFF)
    rt = tlin.search_batch(st, mt, bucket=False, device="cpu", **OFF)
    _same(rj, rt)
    engines = {r["engine"] for r in rt}
    assert "device-batch" not in engines
    assert {"device-bfs", "host-linear(fallback)"} <= engines


def test_search_batch_audit(keys):
    """``audit=True`` replays every key's certificate, as the
    reference's does."""
    sj, mj, st, mt = keys
    rj = lin.search_batch(sj, mj, audit=True)
    rt = tlin.search_batch(st, mt, audit=True, device="cpu")
    _same(rj, rt)
    assert all(r["audit"]["ok"] for r in rt)
    assert [r["audit"] for r in rt] == [r["audit"] for r in rj]


def test_search_batch_climbs_rungs_and_counts_spend(keys, monkeypatch):
    """The ladder runs every pending key at 32, then the overflowing ones
    at 128: one slice function per rung, and a key's configs add up
    over the rungs it took."""
    _, _, st, mt = keys
    rungs = []
    get = tlin.get_batch_kernel

    def traced(model, dims, device, **kw):
        rungs.append(dims.frontier)
        return get(model, dims, device, **kw)

    monkeypatch.setattr(tlin, "get_batch_kernel", traced)
    out = tlin.search_batch(st[:-1], mt, bucket=False, device="cpu", **OFF)
    assert rungs[:2] == [32, 128]
    solo = tlin.search_opseq(st[len(KEYS)], mt, device="cpu", lint=False,
                             **OFF)
    assert out[len(KEYS)]["valid"] == solo["valid"]


def test_search_batch_small_and_empty(keys):
    sj, mj, st, mt = keys
    assert tlin.search_batch([], mt, device="cpu") == []
    _same(lin.search_batch(sj[:1], mj), tlin.search_batch(st[:1], mt,
                                                           device="cpu"))


def test_search_batch_lint_names_the_key(keys):
    from jepsen_tpu_torch.analyze.lint import HistoryLintError

    _, _, st, mt = keys
    broken = st[1]
    broken = type(broken)(**{**broken.__dict__,
                             "inv": broken.inv[::-1].copy()})
    with pytest.raises(HistoryLintError, match="batch key 1"):
        tlin.search_batch([st[0], broken], mt, device="cpu")


def test_search_batch_refuses_missing_card(keys):
    _, _, st, mt = keys
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        tlin.search_batch(st, mt)


# ---------------------------------------------------------------------------
# the grid form's plain version and its wrapper
# ---------------------------------------------------------------------------


def _stacked(esps_j, esps_t, dims_t, carry_n):
    """JAX and port stacked args plus fresh batch carries."""
    args_j = lin.stack_batch(esps_j)
    args_t = tenc.stack_batch(esps_t, device="cpu")
    carry_j = lin._init_batch_carry(carry_n, lin.SearchDims(
        **dims_t.__dict__), jm.cas_register())
    carry_t = tlin._init_batch_carry(carry_n, dims_t, tm.cas_register(),
                                     "cpu")
    return args_j, args_t, carry_j, carry_t


@pytest.mark.parametrize("frontier,bail", [(16, True), (32, False)])
def test_plain_grid_matches_reference_vmapped_step(keys, monkeypatch,
                                                   frontier, bail):
    """level_loop_batch_reference (the per-key all-pairs step) against
    the JAX package's vmapped step pinned to the all-pairs prune, slice
    by slice: every key's scalars and live rows."""
    sj, mj, st, mt = keys
    monkeypatch.setattr(lin, "_DOMINANCE_MODE", "allpairs")
    ej = [lin.encode_search(s) for s in sj[:len(KEYS)]]
    et = [tlin.encode_search(s) for s in st[:len(KEYS)]]
    dj = lin.batch_dims(ej, mj, frontier=frontier)
    dt = tlin.batch_dims(et, mt, frontier=frontier)
    assert dj.__dict__ == dt.__dict__
    pj = [lin.pad_search(e, dj.n_det_pad, dj.n_crash_pad) for e in ej]
    pt = [tenc.pad_search(e, dt.n_det_pad, dt.n_crash_pad) for e in et]
    args_j, args_t, cj, ct = _stacked(pj, pt, dt, len(et))
    fn = lin.get_batch_kernel(mj, dj, batch=len(ej), allow_pallas=False)
    for _ in range(4):
        cj = fn(*args_j, np.int32(10**8), np.int32(8), np.bool_(bail), *cj)
        ct = lk.level_loop_batch(mt, dt, *args_t, 10**8, 8, bail, *ct)
        cj_np = [np.asarray(c) for c in cj]
        ct_np = tenc.to_numpy(ct)
        for i in range(1, 6):
            assert (ct_np[i] == cj_np[i]).all(), i
        for b in range(len(et)):
            n = int(ct_np[1][b])
            assert (ct_np[0][b, :n] == cj_np[0][b, :n]).all()


def test_plain_grid_equals_single_steps(keys):
    """Each key of a plain grid slice gets its own all-pairs step's
    answer; finished and pad lanes come back unchanged."""
    _, _, st, mt = keys
    et = [tlin.encode_search(s) for s in st[:len(KEYS)]]
    dims = tlin.batch_dims(et, mt, frontier=32)
    pt = [tenc.pad_search(e, dims.n_det_pad, dims.n_crash_pad) for e in et]
    B = len(pt) + 3
    args = tenc.stack_batch(pt, pad_to=B, device="cpu")
    carry = tlin.pad_batch_carry(
        tlin._init_batch_carry(len(pt), dims, mt, "cpu"), 3, dims, mt,
        "cpu")
    before = lk.LAUNCHES, lk.BATCH_LAUNCHES
    out = lk.level_loop_batch(mt, dims, *args, 10**8, 64, True, *carry)
    assert (lk.LAUNCHES, lk.BATCH_LAUNCHES) == before
    for b, e in enumerate(pt):
        single = lk.level_loop_reference(
            mt, dims, *tenc.search_args(e, device="cpu"), 10**8, 64, True,
            *(c[b] for c in carry))
        n = int(single[1])
        assert [int(c[b]) for c in out[1:]] == [int(v) for v in single[1:]]
        assert torch.equal(out[0][b, :n], single[0][:n])
    assert out[2][len(pt):].eq(tlin.VALID).all()
    assert out[1][len(pt):].eq(0).all()
    # a second slice leaves the finished keys as they were
    again = lk.level_loop_batch(mt, dims, *args, 10**8, 64, True, *out)
    done = (out[2] != -1) | (out[1] <= 0) | out[5]
    for i in range(1, 6):
        assert torch.equal(again[i][done], out[i][done])


def test_stack_batch_rounds_the_suffix_stride(keys):
    _, _, st, mt = keys
    et = [tlin.encode_search(s) for s in st[:3]]
    dims = tlin.batch_dims(et, mt)
    pt = [tenc.pad_search(e, dims.n_det_pad, dims.n_crash_pad) for e in et]
    args = tenc.stack_batch(pt, pad_to=5, device="cpu")
    assert args[5].shape == (5, lk.sfx_stride(dims))
    assert lk.sfx_stride(dims) % 4 == 0
    assert lk.sfx_stride(dims) >= dims.n_det_pad + 1
    assert (args[5][:, dims.n_det_pad + 1:] == tenc.INF32).all()
    assert args[15].tolist() == [e.n_det for e in et] + [0, 0]
    for b in (3, 4):  # pad keys repeat key 0's tables
        assert torch.equal(args[0][b], args[0][0])


def test_grid_wrapper_refuses(keys):
    """Planes that are not inert and per-key counts out of range are
    refused, on the CPU as on the card."""
    _, _, st, mt = keys
    et = [tlin.encode_search(s) for s in st[:3]]
    dims = tlin.batch_dims(et, mt)
    pt = [tenc.pad_search(e, dims.n_det_pad, dims.n_crash_pad) for e in et]
    args = list(tenc.stack_batch(pt, device="cpu"))
    carry = tlin._init_batch_carry(3, dims, mt, "cpu")
    bad = list(args)
    bad[10] = args[10].clone()
    bad[10][1, 0, 0] = 0
    with pytest.raises(ValueError, match="not inert"):
        lk.level_loop_batch(mt, dims, *bad, 10**8, 8, True, *carry)
    bad = list(args)
    bad[15] = args[15].clone()
    bad[15][2] = dims.n_det_pad + 1
    with pytest.raises(ValueError, match="out of range"):
        lk.level_loop_batch(mt, dims, *bad, 10**8, 8, True, *carry)


def test_run_per_key_skips_idle_keys(keys):
    """The torch step's batch form never runs a key with nothing to do;
    its carry comes back unchanged."""
    _, _, st, mt = keys
    et = [tlin.encode_search(s) for s in st[:2]]
    dims = tlin.batch_dims(et, mt)
    pt = [tenc.pad_search(e, dims.n_det_pad, dims.n_crash_pad) for e in et]
    args = tenc.stack_batch(pt, device="cpu")
    carry = list(tlin._init_batch_carry(2, dims, mt, "cpu"))
    carry[2] = torch.tensor([tlin.VALID, -1], dtype=torch.int32)
    calls = []

    def step(*a):
        calls.append(a)
        return tuple(a[22:28])

    out = tstep.run_per_key(step, dims, *args, 10**8, 8, True, *carry)
    assert len(calls) == 1 and calls[0][15] == et[1].n_det
    assert int(out[2][0]) == tlin.VALID


def test_plain_grid_matches_vmapped_pallas_kernel(keys, monkeypatch):
    """level_loop_batch_reference against the JAX package's batch kernel
    with its Pallas engine forced (the fused level loop under
    ``jax.vmap``, interpreted on the CPU) at F=16, slice by slice."""
    sj, mj, st, mt = keys
    monkeypatch.setattr(lin, "_ENGINE_MODE", "pallas")
    n = 3
    ej = [lin.encode_search(s) for s in sj[:n]]
    et = [tlin.encode_search(s) for s in st[:n]]
    dj = lin.batch_dims(ej, mj, frontier=16)
    dt = tlin.batch_dims(et, mt, frontier=16)
    pj = [lin.pad_search(e, dj.n_det_pad, dj.n_crash_pad) for e in ej]
    pt = [tenc.pad_search(e, dt.n_det_pad, dt.n_crash_pad) for e in et]
    args_j, args_t, cj, ct = _stacked(pj, pt, dt, n)
    fn = lin.get_batch_kernel(mj, dj, batch=n)
    for _ in range(3):
        cj = fn(*args_j, np.int32(10**8), np.int32(8), np.bool_(True), *cj)
        ct = lk.level_loop_batch(mt, dt, *args_t, 10**8, 8, True, *ct)
        cj_np = [np.asarray(c) for c in cj]
        ct_np = tenc.to_numpy(ct)
        for i in range(1, 6):
            assert (ct_np[i] == cj_np[i]).all(), i
        for b in range(n):
            live = int(ct_np[1][b])
            assert (ct_np[0][b, :live] == cj_np[0][b, :live]).all()
