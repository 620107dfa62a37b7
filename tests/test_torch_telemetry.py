"""The port's device-search telemetry against the JAX package's.

  * the host side (``obs/telemetry.py``): ``unpack_levels``,
    ``observed_prune_ratio``, ``SearchTelemetry`` and its ``block()``
    give the reference's dicts for the same arrays;
  * the torch step's telemetry build returns the JAX XLA step's aux
    block for the same carry, unreduced, masked, with dedup, and over a
    slice of more than ``TELE_ROWS`` levels (the last row folds);
  * B1-T's plain version (the all-pairs torch step) returns the
    interpreted Pallas kernel's ``telemetry=True`` block, with a crash
    closure and with an overflow and a bail;
  * telemetry on and off give the same results apart from
    ``search_telemetry`` on every entry point, and the block on device
    results equals the reference's, with the slicing pinned on both
    sides.

The blocks are integer: every comparison is exact."""

import dataclasses
import json
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.checker import pallas_level as plev
from jepsen_tpu.obs import telemetry as jtele
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.checker import encode as enc
from jepsen_tpu_torch.checker import level_kernel as lk
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import seq as tseq
from jepsen_tpu_torch.checker import step as tstep
from jepsen_tpu_torch.history import encode_ops as t_encode_ops
from jepsen_tpu_torch.obs import telemetry as ttele
from test_torch_dpor import _reduced

R, C = ttele.TELE_ROWS, ttele.TELE_COLS


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """The slicing pinned in both packages (the level cap follows wall
    time), the JAX package's pass knobs unset and its telemetry on, as
    its default is, and torch on one thread."""
    monkeypatch.setattr(lin, "_SLICE_TARGET_S", 1e9)
    monkeypatch.setattr(tlin, "_SLICE_TARGET_S", 1e9)
    for knob in ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
                 "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_BATCH_BUCKETS",
                 "JEPSEN_TPU_TELEMETRY"):
        monkeypatch.delenv(knob, raising=False)
    jtele.enable(True)
    # one intra-op thread: the steps' small tensor ops gain nothing from
    # more, and the test workers share the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jtele.enable(None)


# ---------------------------------------------------------------------------
# the host side
# ---------------------------------------------------------------------------


def _block(rng, rows, *, full=False):
    """A random aux block with ``rows`` written rows (occupancy >= 1) and
    junk in the columns of some unwritten ones."""
    b = np.zeros((R, C), np.int32)
    n = R if full else rows
    b[:n] = rng.integers(0, 50, size=(n, C))
    b[:n, ttele.C_OCC] = rng.integers(1, 20, size=n)
    if not full:
        b[n:n + 3, ttele.C_EXP] = 7  # occupancy 0: never written
    return b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unpack_and_ratio_match_reference(seed):
    rng = np.random.default_rng(seed)
    b = _block(rng, 5 + seed * 40)
    assert ttele.unpack_levels(b) == jtele.unpack_levels(b)
    for shape in ((4, 3), (C,)):
        with pytest.raises(ValueError):
            ttele.unpack_levels(np.zeros(shape, np.int32))
    for args in ((0, 0, 0), (10, 0, 0), (1, 3, 0), (1, 1, 2),
                 tuple(int(x) for x in rng.integers(0, 1000, 3))):
        assert ttele.observed_prune_ratio(*args) == \
            jtele.observed_prune_ratio(*args)
    assert (ttele.COLUMNS, ttele.TELE_ROWS, ttele.TELE_COLS,
            ttele.BLOCK_LEVEL_CAP) == (jtele.COLUMNS, jtele.TELE_ROWS,
                                       jtele.TELE_COLS,
                                       jtele.BLOCK_LEVEL_CAP)


@pytest.mark.parametrize("case", ["slices", "truncated", "capped",
                                  "totals", "empty"])
def test_accumulator_matches_reference(case):
    """The same blocks into both accumulators: the same totals, flags
    and ``block()`` dict, with and without a predicted ratio."""
    rng = np.random.default_rng(hash(case) % 1000)
    accs = [ttele.SearchTelemetry(), jtele.SearchTelemetry()]
    for _ in range({"slices": 3, "truncated": 2, "capped": 6,
                    "totals": 2, "empty": 1}[case]):
        if case == "totals":
            b = np.stack([_block(rng, 9), _block(rng, 30)])
            for a in accs:
                a.add_totals(b)
        else:
            b = (np.zeros((R, C), np.int32) if case == "empty"
                 else _block(rng, 20, full=case != "slices"))
            for a in accs:
                a.add_slice(b)
    t, j = accs
    for attr in ("levels", "totals", "n_levels", "max_occupancy", "slices",
                 "truncated"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for predicted in (None, 0.25):
        assert t.block(predicted) == j.block(predicted)
    blk = t.block()
    assert blk["truncated"] is (case in ("truncated", "capped"))
    assert blk.get("per_level_capped", False) is (case == "capped")


# ---------------------------------------------------------------------------
# the torch step's block against the JAX XLA step's
# ---------------------------------------------------------------------------


def _step_pair(esj, mj, mt, dims, red, monkeypatch, mode="sort"):
    monkeypatch.setattr(lin, "_DOMINANCE_MODE", mode)
    monkeypatch.setattr(tstep, "_DOMINANCE_MODE", mode)
    esp = lin.pad_search(esj, dims.n_det_pad, dims.n_crash_pad)
    jfn = jax.jit(lin.build_search_step_fn(mj, dims, telemetry=True, **red))
    tfn = tstep.build_search_step_fn(
        mt, enc.SearchDims(**dataclasses.asdict(dims)), "cpu",
        telemetry=True, **red)
    jargs = lin.search_args(esp, esj)
    targs, tc = enc.from_reference(dataclasses.asdict(esp),
                                   lin._init_carry(dims, mj), "cpu")
    targs = targs[:15] + (esj.n_det, esj.n_crash) + targs[17:]
    jc = tuple(jnp.asarray(c) for c in lin._init_carry(dims, mj))
    return jfn, jargs, jc, tfn, targs, tc


def _lockstep_blocks(jfn, jargs, jc, tfn, targs, tc, *, lvl_cap, bail,
                     slices):
    """Both steps slice by slice: the same carry and the same block
    after every slice; returns the blocks summed over the slices."""
    total = np.zeros((R, C), np.int64)
    for s in range(slices):
        jo = jfn(*jargs, jnp.int32(10**8), jnp.int32(lvl_cap),
                 jnp.bool_(bail), *jc)
        to = tfn(*targs, 10**8, lvl_cap, bail, *tc)
        jc, tc = jo[:6], to[:6]
        fj, *scal_j = [np.asarray(v) for v in jc]
        ft, *scal_t = enc.to_numpy(tc)
        assert [int(v) for v in scal_j] == [int(v) for v in scal_t], \
            f"slice {s}"
        n = int(scal_j[0])
        assert np.array_equal(fj[:n], ft[:n]), f"slice {s} frontier"
        bj, bt = np.asarray(jo[6]), to[6].numpy()
        assert bt.dtype == np.int32 and bt.shape == (R, C)
        assert np.array_equal(bj, bt), f"slice {s} block"
        total += bt
        if int(scal_j[1]) != -1 or n == 0 or (bail and bool(scal_j[4])):
            break
    return total


@pytest.mark.parametrize("kind,seed,column", [
    ("unreduced", 1, None), ("mutex", 0, ttele.C_KILL),
    ("dead-values", 0, ttele.C_DEDUP), ("cas", 0, ttele.C_KILL)])
def test_step_block_matches_xla_step(kind, seed, column, monkeypatch):
    """Unreduced, masked (``mask_killed`` > 0), dedup (``dedup_folds``
    > 0), and both reductions at once."""
    if kind == "unreduced":
        rng = random.Random(seed)
        h = js.register_history(rng, n_ops=56, n_procs=4, overlap=3,
                                crash_p=0.08, max_crashes=4, n_values=3)
        mj, mt = jm.cas_register(), tm.cas_register()
        esj = lin.encode_search(jh.encode_ops(h, mj.f_codes))
        red = {}
    else:
        _sj, mj, _st, mt, esj, _ = _reduced(kind, seed)
        red = dict(masked=esj.masked, masked_crash=esj.mask_has_crash,
                   dedup=esj.dedup)
    dims = lin.choose_dims(esj, mj, frontier=16)
    total = _lockstep_blocks(*_step_pair(esj, mj, mt, dims, red,
                                         monkeypatch),
                             lvl_cap=8, bail=False, slices=10)
    assert total[:, ttele.C_OCC].sum() > 0
    if column is not None:
        assert total[:, column].sum() > 0
    else:
        assert total[:, ttele.C_ROUNDS].sum() > 0
        assert total[:, [ttele.C_KILL, ttele.C_DEDUP]].sum() == 0


def test_step_block_folds_levels_past_the_buffer(monkeypatch):
    """One slice of more than ``TELE_ROWS`` levels: the last row holds
    the sum of every level from ``TELE_ROWS - 1`` on, in both steps."""
    rng = random.Random(44)
    h = js.sim_mutex_history(rng, n_ops=140, n_procs=3, crash_p=0.02,
                             max_crashes=2)
    mj, mt = jm.mutex(), tm.mutex()
    esj = lin.encode_search(jh.encode_ops(h, mj.f_codes))
    dims = lin.choose_dims(esj, mj, frontier=16)
    total = _lockstep_blocks(*_step_pair(esj, mj, mt, dims, {},
                                         monkeypatch),
                             lvl_cap=R + 8, bail=False, slices=1)
    assert total[R - 1, ttele.C_OCC] > total[R - 2, ttele.C_OCC] > 0


# ---------------------------------------------------------------------------
# B1-T's plain version against the interpreted Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,seed,bail", [("crash", 2, False),
                                            ("overflow", 21, True)])
def test_plain_block_matches_pallas(kind, seed, bail):
    """The all-pairs torch step's block equals the Pallas kernel's
    ``telemetry=True`` block (interpret mode): a history whose levels
    run crash-closure rounds, and one that overflows F=16 under bail
    (the overflowing level's row is written, its carry reverted)."""
    rng = random.Random(seed)
    if kind == "crash":
        h = js.register_history(rng, n_ops=56, n_procs=4, overlap=3,
                                crash_p=0.08, max_crashes=4, n_values=3)
    else:
        h = js.register_history(rng, n_ops=64, n_procs=8, overlap=7,
                                crash_p=0.05, max_crashes=3, n_values=2)
    mj, mt = jm.cas_register(), tm.cas_register()
    es = lin.encode_search(jh.encode_ops(h, mj.f_codes))
    dims = lin.choose_dims(es, mj, frontier=16)
    tdims = enc.SearchDims(**dataclasses.asdict(dims))
    assert plev.eligible(mj, dims) and lk.eligible(mt, tdims)
    esp = lin.pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    pal = jax.jit(plev.build_pallas_step_fn(mj, dims, interpret=True,
                                            telemetry=True))
    jargs = lin.search_args(esp, es)
    targs, tc = enc.from_reference(dataclasses.asdict(esp),
                                   lin._init_carry(dims, mj), "cpu")
    targs = targs[:15] + (es.n_det, es.n_crash) + targs[17:]
    jc = tuple(jnp.asarray(c) for c in lin._init_carry(dims, mj))
    total = np.zeros((R, C), np.int64)
    for s in range(4):
        jo = pal(*jargs, jnp.int32(10**8), jnp.int32(16), jnp.bool_(bail),
                 *jc)
        to = lk.level_loop(mt, tdims, *targs, 10**8, 16, bail, *tc,
                           telemetry=True)
        jc, tc = jo[:6], to[:6]
        scal_j = [int(np.asarray(v)) for v in jc[1:]]
        assert scal_j == [int(v) for v in enc.to_numpy(tc)[1:]], \
            f"slice {s}"
        assert np.array_equal(np.asarray(jo[6]), to[6].numpy()), \
            f"slice {s} block"
        total += to[6].numpy()
        if scal_j[1] != -1 or scal_j[0] == 0 or (bail and scal_j[4]):
            break
    if kind == "crash":
        assert total[:, ttele.C_ROUNDS].sum() > 0
    else:
        assert total[:, ttele.C_OVF].sum() == 1 and scal_j[4]


def test_plain_batch_stacks_blocks_with_idle_keys_zero():
    """The grid form's plain version stacks the per-key blocks; a pad
    key and a finished key run no level and read zero."""
    m = tm.cas_register()
    seqs = [t_encode_ops(ts.register_history(
        random.Random(f"g-{k}"), n_ops=30, n_procs=5, overlap=4,
        crash_p=0.05, max_crashes=3, n_values=3), m.f_codes)
        for k in range(3)]
    ess = [enc.encode_search(s) for s in seqs]
    dims = tlin.batch_dims(ess, m, frontier=16)
    esps = [enc.pad_search(e, dims.n_det_pad, dims.n_crash_pad)
            for e in ess]
    args = tlin.stack_batch(esps, pad_to=4, device="cpu")
    carry = tlin.pad_batch_carry(tlin._init_batch_carry(3, dims, m, "cpu"),
                                 1, dims, m, "cpu")
    carry = (carry[0], carry[1], carry[2].clone(), *carry[3:])
    carry[2][1] = tlin.VALID  # key 1 finished
    out = lk.level_loop_batch(m, dims, *args, 10**8, 8, False, *carry,
                              telemetry=True)
    off = lk.level_loop_batch(m, dims, *args, 10**8, 8, False, *carry)
    assert out[6].shape == (4, R, C)
    assert int(out[6][1].abs().sum()) == int(out[6][3].abs().sum()) == 0
    for k in (0, 2):
        one = lk.level_loop(
            m, dims, *[t[k] for t in args[:5]],
            args[5][k][:dims.n_det_pad + 1], *[t[k] for t in args[6:15]],
            *(int(t[k]) for t in args[15:19]), 10**8, 8, False,
            *(c[k] for c in carry), telemetry=True)
        assert np.array_equal(one[6].numpy(), out[6][k].numpy())
    for a, b in zip(out[:6], off):
        assert np.array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# entry points: on/off identity and the reference's block
# ---------------------------------------------------------------------------


#: fields that differ from run to run whatever the telemetry: wall
#: times, the process's cache warmth, and the failure report's path
#: (its directory is named by the time of the check)
_VOLATILE = ("seconds", "kernel_cache", "report_file")


def _canon(v):
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()
                if k not in _VOLATILE and k != "search_telemetry"}
    if isinstance(v, list):
        return [_canon(x) for x in v]
    return v


def _bytes(r) -> str:
    return json.dumps(_canon(r), sort_keys=True, default=str)


def _pair(seed, *, corrupt, n_ops=40, crash_p=0.1):
    out = []
    for synth, models, encode in ((js, jm, jh.encode_ops),
                                  (ts, tm, t_encode_ops)):
        rng = random.Random(seed)
        h = synth.register_history(rng, n_ops=n_ops, n_procs=5, overlap=4,
                                   crash_p=crash_p, max_crashes=4,
                                   n_values=3)
        if corrupt:
            h = synth.corrupt_read(rng, h, at=0.8)
        m = models.cas_register()
        out += [encode(h, m.f_codes), m]
    return out


HISTORIES = [(5, True), (6, False)]


@pytest.mark.parametrize("flags", [dict(hb=False, dpor=False), dict()],
                         ids=["off", "defaults"])
@pytest.mark.parametrize("seed,corrupt", HISTORIES)
def test_search_block_matches_reference(seed, corrupt, flags):
    """``search_opseq``'s ``search_telemetry`` equals the JAX package's
    (with the prepass's predicted ratio when it runs), and telemetry
    off gives the same result without it."""
    sj, mj, st, mt = _pair(seed, corrupt=corrupt)
    ref = lin.search_opseq(sj, mj, **flags)
    on = tlin.search_opseq(st, mt, device="cpu", **flags)
    off = tlin.search_opseq(st, mt, device="cpu", telemetry=False, **flags)
    assert ref["engine"].startswith("device")
    assert on["search_telemetry"] == ref["search_telemetry"]
    assert "search_telemetry" not in off
    assert _bytes(on) == _bytes(off)
    blk = on["search_telemetry"]
    assert blk["levels"] > 0 and blk["expanded"] > 0
    assert sum(r[0] for r in blk["per_level"]) >= on["configs"]
    if not flags:
        assert on["hb"]["applies"]
        assert blk["predicted_prune_ratio"] == on["hb"]["prune_ratio"]


def test_decided_search_carries_no_block():
    """A history the prepass decides has no device work: no
    ``search_telemetry`` key, as in the reference."""
    h = []
    for p in range(3):
        h += [jh.invoke_op(p, "write", 10 + p), jh.ok_op(p, "write", 10 + p)]
    h += [jh.invoke_op(0, "read", None), jh.ok_op(0, "read", 12)]
    mj = jm.register(0)
    ref = lin.search_opseq(jh.encode_ops(h, mj.f_codes), mj)
    from test_torch_hb import to_port

    mt = tm.register(0)
    out = tlin.search_opseq(t_encode_ops(to_port(h), mt.f_codes), mt,
                            device="cpu")
    assert out["engine"] == ref["engine"] == "hb-decide"
    assert "search_telemetry" not in out and "search_telemetry" not in ref


def test_resume_block_matches_reference(tmp_path):
    """A search stopped after its first slice and resumed: the resumed
    run's block is the reference's resumed block, and off is the same
    result without it."""
    sj, mj, st, mt = _pair(11, corrupt=True, n_ops=60)
    blocks = {}
    for name, pkg, seq, model, kw in (("jax", lin, sj, mj, {}),
                                      ("port", tlin, st, mt,
                                       {"device": "cpu"})):
        path = str(tmp_path / f"{name}.npz")
        stop = threading.Event()

        def hook(carry, dims, pkg=pkg, path=path, seq=seq, model=model,
                 stop=stop):
            pkg.save_checkpoint(path, carry, dims, model, 20_000_000,
                                seq=seq)
            stop.set()
        first = pkg.search_opseq(seq, model, on_slice=hook, stop=stop,
                                 hb=False, dpor=False, **kw)
        assert first["valid"] == "unknown"
        blocks[name] = pkg.resume_opseq(seq, model, path, **kw)
    off = tlin.resume_opseq(st, mt, str(tmp_path / "port.npz"),
                            device="cpu", telemetry=False)
    assert blocks["port"]["search_telemetry"] == \
        blocks["jax"]["search_telemetry"]
    assert _bytes(blocks["port"]) == _bytes(off)
    assert "search_telemetry" not in off


@pytest.fixture(scope="module")
def batch():
    keys = [_pair(f"k-{k}", corrupt=k % 3 == 0, n_ops=24, crash_p=0.05)
            for k in range(5)]
    return ([k[0] for k in keys], keys[0][1], [k[2] for k in keys],
            keys[0][3])


@pytest.mark.parametrize("bucket", [True, False])
def test_batch_block_matches_reference(batch, bucket):
    """``search_batch``: the first result carries the ladder's block,
    the reference's; off, every result is the same without it."""
    sj, mj, st, mt = batch
    ref = lin.search_batch(sj, mj, bucket=bucket)
    on = tlin.search_batch(st, mt, device="cpu", bucket=bucket)
    off = tlin.search_batch(st, mt, device="cpu", bucket=bucket,
                            telemetry=False)
    assert [r.get("search_telemetry") for r in on] == \
        [r.get("search_telemetry") for r in ref]
    assert "search_telemetry" in on[0]
    assert all("search_telemetry" not in r for r in off)
    assert [_bytes(r) for r in on] == [_bytes(r) for r in off]


def test_competition_and_checker_on_off(monkeypatch, tmp_path):
    """``check_competition`` with its host legs held back (so the device
    leg decides) and ``Linearizable(algorithm="device")``: the same
    result on and off, apart from the block."""
    _sj, _mj, st, mt = _pair(5, corrupt=True)
    monkeypatch.setattr(tseq, "check_opseq",
                        lambda *a, **k: {"valid": "unknown", "configs": 0})
    monkeypatch.setattr(tlin, "check_opseq_linear",
                        lambda *a, **k: {"valid": "unknown", "configs": 0})
    on = tlin.check_competition(st, mt, device="cpu")
    off = tlin.check_competition(st, mt, device="cpu", telemetry=False)
    assert on["engine"] == "competition(device)"
    assert "search_telemetry" in on and "search_telemetry" not in off
    assert _bytes(on) == _bytes(off)
    monkeypatch.undo()
    test = {"name": "tele", "store_base": str(tmp_path)}
    outs = [tlin.linearizable(mt, algorithm="device", device="cpu",
                              telemetry=t).check(test, st)
            for t in (None, False)]
    assert outs[0]["valid"] is False
    assert _bytes(outs[0]) == _bytes(outs[1])
