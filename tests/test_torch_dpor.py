"""The port's reductions against the JAX package's, mirroring
tests/test_dpor.py: duplicate-op edges, the dead-value quotient, sleep
sets, the reduction planes of the encoding, the masked and dedup torch
step slice by slice against the masked XLA step, and the three engines
(``check_opseq``, ``check_opseq_linear``, ``search_opseq`` on the CPU)
with the reductions on and off: the same verdict either way, and the
reference's ``configs``, ``max_depth`` and ``dpor`` stats under the
same flags."""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import history as jh
from jepsen_tpu import synth as js
from jepsen_tpu.analyze import dpor as jdpor
from jepsen_tpu.analyze import hb as jhb
from jepsen_tpu.checker import linear as jlinear
from jepsen_tpu.checker import seq as jseq
from jepsen_tpu.decompose import canonical as jcanon
from jepsen_tpu_torch.analyze import dpor as tdpor
from jepsen_tpu_torch.checker import encode as enc
from jepsen_tpu_torch.checker import linear as tlinear
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import seq as tseq
from jepsen_tpu_torch.checker import step as tstep
from jepsen_tpu_torch.decompose import canonical as tcanon
from test_torch_hb import _multi, encoded
from test_torch_search import reference_defaults


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setattr(lin, "_SLICE_TARGET_S", 1e9)
    monkeypatch.setattr(tlin, "_SLICE_TARGET_S", 1e9)
    reference_defaults(monkeypatch)


def _crash_bit63():
    """64 crashed writes and a read of the last one: an rf edge from
    crash index 63 (tests/test_dpor.py)."""
    h = []
    for i in range(64):
        h.append(jh.invoke_op(i % 8, "write", i + 1))
        h.append(jh.info_op(i % 8, "write", i + 1))
    h.append(jh.invoke_op(0, "read", None))
    h.append(jh.ok_op(0, "read", 64))
    return h


def _history(kind, seed):
    """(events, model factory, factory args) per case family."""
    rng = random.Random(1000 + seed)
    if kind == "cas":
        h = js.register_history(rng, n_ops=48, n_procs=5, overlap=4,
                                crash_p=0.12, max_crashes=4)
        if seed % 2:
            h = js.corrupt_read(rng, h, at=0.85)
        return h, "cas_register", ()
    if kind == "register":
        h = js.register_history(rng, n_ops=44, n_procs=4, overlap=4,
                                crash_p=0.1, cas=False, n_values=2)
        if seed % 2:
            h = js.swap_read_values(rng, h, min_gap=4)
        return h, "register", (0,)
    if kind == "mutex":
        h = js.sim_mutex_history(rng, 40, 4, crash_p=0.1, max_crashes=6)
        return h, "mutex", ()
    if kind in ("fifo", "queue"):
        h = js.sim_queue_history(rng, 34, 4, crash_p=0.15,
                                 fifo=kind == "fifo")
        if seed % 2:
            h = js.swap_dequeues(rng, h)
        return h, ("fifo_queue" if kind == "fifo"
                   else "unordered_queue"), (16,)
    if kind == "multi":
        return _multi(seed), "multi_register", (3,)
    if kind == "dup-writes":
        h = []
        for wave in (1, 2):
            for p in range(4):
                h.append(jh.invoke_op(p, "write", wave))
            for p in range(4):
                h.append(jh.ok_op(p, "write", wave))
            h.append(jh.invoke_op(0, "read", None))
            h.append(jh.ok_op(0, "read", wave))
        return h, "register", (0,)
    if kind == "dead-values":
        h = []
        for base in (10, 20):
            for p in range(3):
                h.append(jh.invoke_op(p, "write", base + p))
            for p in range(3):
                h.append(jh.ok_op(p, "write", base + p))
        return h, "register", (0,)
    assert kind == "crash-bit63"
    return _crash_bit63(), "cas_register", ()


CASES = ([("cas", s) for s in range(2)] + [("register", s) for s in range(2)]
         + [("mutex", s) for s in range(2)] + [("fifo", s) for s in range(2)]
         + [("queue", s) for s in range(2)] + [("multi", 2), ("multi", 7),
                                                ("dup-writes", 0),
                                                ("dead-values", 0)])

#: beside CASES: a search over 64 crashed writes, for the planes and
#: the step (through the engines it costs seconds per flag setting)
PLANE_CASES = CASES + [("crash-bit63", 0)]

KEYS = ("valid", "configs", "max_depth", "engine", "final_ops",
        "final_paths", "linearization", "witness_dropped", "dpor", "hb",
        "constraints", "hb_cycle", "queue_cycle", "frontier", "window")

FLAGS = [dict(), dict(hb=False), dict(dpor=False), dict(hb=False,
                                                        dpor=False)]


def _routes(sj, mj, st, mt, flags):
    budget = dict(max_configs=300_000)
    return [("check_opseq", jseq.check_opseq(sj, mj, **budget, **flags),
             tseq.check_opseq(st, mt, **budget, **flags)),
            ("check_opseq_linear",
             jlinear.check_opseq_linear(sj, mj, **budget, **flags),
             tlinear.check_opseq_linear(st, mt, **budget, **flags)),
            ("search_opseq",
             lin.search_opseq(sj, mj, budget=2_000_000, **flags),
             tlin.search_opseq(st, mt, budget=2_000_000, device="cpu",
                               **flags))]


@pytest.mark.parametrize("kind,seed", CASES)
def test_engines_match_reference_on_and_off(kind, seed):
    h, factory, args = _history(kind, seed)
    sj, mj, st, mt = encoded(h, factory, *args)
    verdicts = set()
    for flags in FLAGS:
        for route, oj, ot in _routes(sj, mj, st, mt, flags):
            assert {k: ot.get(k) for k in KEYS} == \
                {k: oj.get(k) for k in KEYS}, (route, flags)
            if ot["valid"] != "unknown":
                verdicts.add(ot["valid"])
    assert len(verdicts) == 1  # the same verdict, reductions on or off


def test_cases_exercise_every_reduction():
    """Across the cases above the port's engines mask lanes, prune by
    sleep sets, fold dead values, and run the masked device step."""
    seen = set()
    for kind, seed in CASES:
        h, factory, args = _history(kind, seed)
        _, _, st, mt = encoded(h, factory, *args)
        a = tseq.check_opseq(st, mt, max_configs=300_000).get("dpor") or {}
        b = tlinear.check_opseq_linear(st, mt).get("dpor") or {}
        c = tlin.search_opseq(st, mt, budget=2_000_000,
                              device="cpu").get("dpor") or {}
        seen |= {k for k in ("sleep_prunes", "mask_skips",
                             "dedup_rewrites") if a.get(k)}
        seen |= {"lanes_killed"} if b.get("mask_lanes_killed") else set()
        seen |= {"device_masked"} if c.get("device_masked") else set()
        seen |= {"device_dedup"} if c.get("dedup") else set()
    assert seen == {"sleep_prunes", "mask_skips", "dedup_rewrites",
                    "lanes_killed", "device_masked", "device_dedup"}


@pytest.mark.parametrize("kind,seed", CASES)
def test_reduction_units_match_reference(kind, seed):
    h, factory, args = _history(kind, seed)
    sj, mj, st, mt = encoded(h, factory, *args)
    assert tdpor.duplicate_op_edges(st) == jdpor.duplicate_op_edges(sj)
    assert tdpor.duplicate_op_edges(st, cap=3) == \
        jdpor.duplicate_op_edges(sj, cap=3)
    dj, dt = (jcanon.dead_value_cutoffs(sj, mj),
              tcanon.dead_value_cutoffs(st, mt))
    assert (dt is None) == (dj is None)
    if dj is not None:
        assert (dt.cutoffs, dt.token, dt.candidates, dt.value_range()) == \
            (dj.cutoffs, dj.token, dj.candidates, dj.value_range())
        for v in list(dj.cutoffs)[:6] + [dj.token, jh.NIL]:
            for p in (0, 3, 10**6):
                assert dt.dead_at(v, p) == dj.dead_at(v, p)
    cj, ct = (jcanon.comparison_row_masks(sj, mj),
              tcanon.comparison_row_masks(st, mt))
    assert (ct is None) == (cj is None)
    if cj is not None:
        assert ct[0] == cj[0]
    # commutation and child sleep masks over seeded states and rows
    sl_j, sl_t = jdpor.SleepSets(sj, mj), tdpor.SleepSets(st, mt)
    rng = random.Random(seed)
    states = [mj.init] + [mj.pystep(mj.init, int(sj.f[i]), int(sj.v1[i]),
                                    int(sj.v2[i])) for i in range(len(sj))]
    states = [s for s in states if s is not None]
    n = len(st)
    for _ in range(60):
        s = rng.choice(states)
        a, b = rng.randrange(n), rng.randrange(n)
        assert sl_t.commutes(s, a, b) == sl_j.commutes(s, a, b)
        base = rng.getrandbits(min(n, 40))
        assert sl_t.child_sleep(s, a, base) == sl_j.child_sleep(s, a, base)


def test_sleep_visit_matches_reference():
    rng = random.Random(3)
    vj, vt = {}, {}
    for _ in range(400):
        key = rng.randrange(12)
        sleep = rng.getrandbits(6)
        assert tdpor.sleep_visit(vt, key, sleep) == \
            jdpor.sleep_visit(vj, key, sleep)
    assert vt == vj


def _reduced(kind, seed):
    """(jax seq, jax model, port seq, port model, jax EncodedSearch with
    reductions attached, port one)."""
    h, factory, args = _history(kind, seed)
    sj, mj, st, mt = encoded(h, factory, *args)
    hbj = jhb.maybe_hb(sj, mj)
    esj = lin.attach_reductions(lin.encode_search(sj), sj, mj,
                                hbj.must_pred if hbj else None, dedup=True)
    from jepsen_tpu_torch.analyze.hb import maybe_hb

    hbt = maybe_hb(st, mt)
    est = enc.attach_reductions(enc.encode_search(st), st, mt,
                                hbt.must_pred if hbt else None, dedup=True)
    return sj, mj, st, mt, esj, est


PLANES = ("det_mpred", "det_cpred", "crash_mpred", "crash_cpred",
          "dead_from", "dead_lo", "dead_tok", "masked", "mask_has_crash",
          "dedup")
PADDED = PLANES + ("det_cpredw", "crash_cpredw", "det_f", "det_inv",
                   "suffix_min_ret", "crash_inv")


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b)) and \
        np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("kind,seed", PLANE_CASES)
def test_planes_match_reference(kind, seed):
    _, mj, _, _, esj, est = _reduced(kind, seed)
    for k in PLANES:
        assert _same(getattr(est, k), getattr(esj, k)), k
    dims = lin.choose_dims(esj, mj)
    pj = lin.pad_search(esj, dims.n_det_pad, dims.n_crash_pad)
    pt = enc.pad_search(est, dims.n_det_pad, dims.n_crash_pad)
    for k in PADDED:
        assert _same(getattr(pt, k), getattr(pj, k)), k
    assert enc.MASK_PREDS == lin.MASK_PREDS
    assert enc.DEAD_TABLE_MAX == lin.DEAD_TABLE_MAX


def test_plane_cases_cover_crash_preds_and_dedup():
    flags = set()
    for kind, seed in PLANE_CASES:
        *_, est = _reduced(kind, seed)
        flags |= {k for k in ("masked", "mask_has_crash", "dedup")
                  if getattr(est, k)}
    assert flags == {"masked", "mask_has_crash", "dedup"}


LOCKSTEP = [("cas", 0), ("cas", 1), ("mutex", 0), ("queue", 0),
            ("fifo", 0), ("multi", 7), ("crash-bit63", 0),
            ("dup-writes", 0)]


@pytest.mark.parametrize("mode", ["allpairs", "sort"])
@pytest.mark.parametrize("kind,seed", LOCKSTEP)
def test_masked_step_lockstep(kind, seed, mode):
    """The port's masked/dedup step against the JAX package's masked
    XLA step from the same padded reduction planes, slice by slice:
    live frontier rows and every carry scalar."""
    sj, mj, st, mt, esj, _ = _reduced(kind, seed)
    dims = lin.choose_dims(esj, mj, frontier=16)
    esp = lin.pad_search(esj, dims.n_det_pad, dims.n_crash_pad)
    red = dict(masked=esp.masked, masked_crash=esp.mask_has_crash,
               dedup=esp.dedup)
    assert esp.masked or esp.dedup
    old = lin._DOMINANCE_MODE, tstep._DOMINANCE_MODE
    lin._DOMINANCE_MODE = tstep._DOMINANCE_MODE = mode
    try:
        jfn = jax.jit(lin.build_search_step_fn(mj, dims, **red))
        tfn = tstep.build_search_step_fn(
            mt, enc.SearchDims(**dataclasses.asdict(dims)), "cpu", **red)
        jargs = lin.search_args(esp, esj)
        targs, tc = enc.from_reference(dataclasses.asdict(esp),
                                       lin._init_carry(dims, mj), "cpu")
        targs = targs[:15] + (esj.n_det, esj.n_crash) + targs[17:]
        jc = tuple(jnp.asarray(c) for c in lin._init_carry(dims, mj))
        for s in range(10):
            jc = jfn(*jargs, jnp.int32(10**8), jnp.int32(8),
                     jnp.bool_(False), *jc)
            tc = tfn(*targs, 10**8, 8, False, *tc)
            fj, *scal_j = [np.asarray(v) for v in jc]
            ft, *scal_t = enc.to_numpy(tc)
            assert [int(v) for v in scal_j] == [int(v) for v in scal_t], \
                f"slice {s}"
            n = int(scal_j[0])
            assert np.array_equal(fj[:n], ft[:n]), f"slice {s} frontier"
            if int(scal_j[1]) != -1 or n == 0:
                break
    finally:
        lin._DOMINANCE_MODE, tstep._DOMINANCE_MODE = old


def test_tier_history_reductions_match_reference():
    """The 1k-shaped cas-register history at a tenth of its size: the
    prepass applies without deciding, and the masked, deduplicated
    device search gives the reference's configs."""
    rng = random.Random("bench-1k")
    h = js.corrupt_read(rng, js.register_history(
        rng, n_ops=140, n_procs=32, overlap=8, crash_p=0.002,
        max_crashes=8, n_values=4), at=0.98)
    sj, mj, st, mt = encoded(h, "cas_register")
    oj = lin.search_opseq(sj, mj)
    ot = tlin.search_opseq(st, mt, device="cpu")
    assert {k: ot.get(k) for k in KEYS} == {k: oj.get(k) for k in KEYS}
    assert ot["dpor"]["device_masked"] and ot["dpor"]["dedup"]
    off = tlin.search_opseq(st, mt, device="cpu", hb=False, dpor=False)
    assert off["valid"] == ot["valid"] and off["configs"] >= ot["configs"]


def test_mutex_tier_shape_is_decided_by_the_prepass():
    """A mutex history with an acquire chain no crash explains (the
    mutex2k tier's corruption) is decided with 0 configs."""
    rng = random.Random("bench-mutex2k")
    h = js.sim_mutex_history(rng, n_ops=200, n_procs=16, crash_p=0.01,
                             max_crashes=12)
    n_info = sum(1 for op in h if op.type == "info")
    for i in range(n_info + 2):
        h = h + [jh.invoke_op(16 + i, "acquire", None),
                 jh.ok_op(16 + i, "acquire", None)]
    sj, mj, st, mt = encoded(h, "mutex")
    oj = lin.search_opseq(sj, mj)
    ot = tlin.search_opseq(st, mt, device="cpu")
    assert {k: ot.get(k) for k in KEYS} == {k: oj.get(k) for k in KEYS}
    assert ot["engine"] == "constraint-decide" and ot["configs"] == 0
    assert ot["constraints"]["reason"] == "lock-overhold"
