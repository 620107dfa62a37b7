"""The port's decomposition layer (``jepsen_tpu_torch/decompose/``)
against the JAX package's, on the same histories made from seeds.

The fuzz covers the JAX package's own five classes
(``tests/test_decompose.py``): cas registers with crashes, unique-write
registers (value blocks), low-overlap registers (quiescence cuts),
mutexes with crashes and multi-registers (the key partition).  Each
history goes through both packages' ``check_opseq_decomposed`` with
their own WGL oracle as ``direct``, once without witnesses and once with
witnesses, an in-memory verdict cache and the audit, and the whole
results must be equal: verdict, configs, engine, the ``decompose`` dict
(cache hits, misses and inserts included) and the certificates.  Then
the pieces: segment state sets and witness chains, value blocks,
canonical keys, the batch front of ``search_batch``, the pool and device
schedulers, and the entry points that take ``decompose=``."""

import dataclasses
import random

import numpy as np
import pytest

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.checker import linearizable as jlin
from jepsen_tpu.checker.seq import check_opseq as j_check
from jepsen_tpu.decompose import canonical as jcan
from jepsen_tpu.decompose import engine as jeng
from jepsen_tpu.decompose import partition as jpart
from jepsen_tpu.decompose.cache import VerdictCache as JCache
from jepsen_tpu.history import encode_ops as j_encode_ops
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker.linear import check_opseq_linear as t_linear
from jepsen_tpu_torch.checker.seq import check_opseq as t_check
from jepsen_tpu_torch.decompose import canonical as tcan
from jepsen_tpu_torch.decompose import engine as teng
from jepsen_tpu_torch.decompose import partition as tpart
from jepsen_tpu_torch.decompose.cache import VerdictCache as TCache
from jepsen_tpu_torch.history import encode_ops as t_encode_ops
from test_torch_search import reference_defaults


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    reference_defaults(monkeypatch)


def sim_multireg_history(h, rng, width=3, n_procs=4, n_ops=30,
                         crash_p=0.05):
    """The JAX package test's valid-by-construction multi-register
    generator ((key, value) ops; a crashed write applies on a coin
    flip), over history module ``h``."""
    state = {k: 0 for k in range(width)}
    out, pending, crashed = [], {}, set()
    done = 0
    while done < n_ops or pending:
        live = [p for p in range(n_procs) if p not in crashed]
        if not live:
            break
        p = rng.choice(live)
        if p in pending:
            f, k, v = pending.pop(p)
            if crash_p and rng.random() < crash_p:
                if rng.random() < 0.5 and f == "write":
                    state[k] = v
                crashed.add(p)
                out.append(h.info_op(p, f, (k, v if f == "write" else None)))
                continue
            if f == "read":
                out.append(h.ok_op(p, f, (k, state[k])))
            else:
                state[k] = v
                out.append(h.ok_op(p, f, (k, v)))
        elif done < n_ops:
            f = rng.choice(["read", "write"])
            k = rng.randrange(width)
            v = None if f == "read" else rng.randrange(5)
            out.append(h.invoke_op(p, f, (k, v)))
            pending[p] = (f, k, v)
            done += 1
    return out


def _flip_mr_read(rng, h):
    idx = [i for i, op in enumerate(h)
           if op.type == "ok" and op.f == "read"]
    if not idx:
        return h
    h = list(h)
    i = rng.choice(idx)
    k, v = h[i].value
    h[i] = dataclasses.replace(h[i], value=(k, (v or 0) + 7))
    return h


JAX = (js, jm, j_encode_ops, jh)
PORT = (ts, tm, t_encode_ops, th)

#: (class, first seed, count): the JAX package test's five classes, 150
#: histories in all
CLASSES = (("cas", 0, 40), ("uniq", 1000, 30), ("quiesce", 2000, 30),
           ("mutex", 3000, 25), ("multireg", 4000, 25))
CASES = [(label, seed0 + i, i) for label, seed0, n in CLASSES
         for i in range(n)]


def fuzz_case(pkg, label, seed, i):
    """(model, OpSeq) of one fuzz history in package ``pkg``."""
    synth, models, encode, hist = pkg
    rng = random.Random(seed)
    if label == "cas":
        m = models.cas_register()
        h = synth.sim_register_history(rng, n_procs=4, n_ops=24,
                                       crash_p=0.1, cas=(i % 2 == 0))
        if i % 3 == 0:
            h = synth.flip_read(rng, h)
    elif label == "uniq":
        m = models.register(0)
        h = synth.register_history(rng, n_ops=36, n_procs=6, overlap=5,
                                   crash_p=0.0, n_values=10**6, cas=False)
        if i % 2 == 0:
            h = synth.flip_read(rng, h)
    elif label == "quiesce":
        m = models.cas_register()
        h = synth.register_history(rng, n_ops=40, n_procs=3, overlap=1,
                                   crash_p=0.02, max_crashes=2, n_values=4)
        if i % 2 == 0:
            h = synth.flip_read(rng, h)
    elif label == "mutex":
        m = models.mutex()
        h = synth.sim_mutex_history(rng, n_ops=26, n_procs=4, crash_p=0.06)
    else:
        m = models.multi_register(3)
        h = sim_multireg_history(hist, rng)
        if i % 3 == 0:
            h = _flip_mr_read(rng, h)
    return m, encode(h, m.f_codes)


def _both(label, seed, i, caches=(None, None), **kw):
    """The two packages' decomposed results on one fuzz history, each
    with its own cache of ``caches``."""
    jmod, jseq = fuzz_case(JAX, label, seed, i)
    tmod, tseq = fuzz_case(PORT, label, seed, i)
    a = jeng.check_opseq_decomposed(
        jseq, jmod, direct=lambda s: j_check(s, jmod), cache=caches[0],
        **kw)
    b = teng.check_opseq_decomposed(
        tseq, tmod, direct=lambda s: t_check(s, tmod), cache=caches[1],
        **kw)
    return a, b, (tseq, tmod)


@pytest.mark.parametrize("label,seed,i", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_fuzz_decomposed_equals_reference(label, seed, i):
    a, b, (tseq, tmod) = _both(label, seed, i)
    assert b == a
    assert b["valid"] == t_check(tseq, tmod)["valid"]
    a, b, _ = _both(label, seed, i, witness=True, audit=True)
    assert b == a
    # each with a cache of its own package: the same hits, misses and
    # inserts, under the same keys
    jc, tc = JCache(), TCache()
    a, b, _ = _both(label, seed, i, (jc, tc), witness=True, audit=True)
    assert b == a
    assert sorted(tc._d.items()) == sorted(jc._d.items())


def test_fuzz_exercises_every_decomposition():
    """The fuzz reaches every stage of the funnel, or the parity claim
    would be vacuous."""
    used = set()
    for label, seed, i in CASES[::3]:
        tmod, tseq = fuzz_case(PORT, label, seed, i)
        r = teng.check_opseq_decomposed(
            tseq, tmod, direct=lambda s: t_check(s, tmod), witness=True)
        used.update(r["decompose"]["methods"])
    assert {"value-blocks", "quiescence", "key-partition", "hb-fold",
            "sub-search", "direct"} <= used, used


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_segment_states_and_chains_match_reference(seed):
    """Every crash-free segment of a low-overlap history, folded from
    two input states: the same state set and the same witness chains."""
    folded = 0
    for pkg_seed in range(seed * 5, seed * 5 + 5):
        jmod, jseq = fuzz_case(JAX, "quiesce", 2000 + pkg_seed, 1)
        tmod, tseq = fuzz_case(PORT, "quiesce", 2000 + pkg_seed, 1)
        jsegs = jpart.quiescence_segments(jseq)
        tsegs = tpart.quiescence_segments(tseq)
        assert [s.tolist() for s in tsegs] == [s.tolist() for s in jsegs]
        for rows in tsegs[:-1]:
            js_ = jpart.subseq(jseq, rows)
            ts_ = tpart.subseq(tseq, rows)
            for ins in ([(0,)], [(1,), (3,)]):
                for witness in (False, True):
                    a = jeng.segment_states(js_, jmod, ins,
                                            witness=witness)
                    b = teng.segment_states(ts_, tmod, ins,
                                            witness=witness)
                    assert b == a
                    folded += 1
    assert folded > 0


def test_segment_states_refuses_crashes():
    m = tm.cas_register()
    seq = t_encode_ops([th.invoke_op(0, "write", 1),
                        th.info_op(0, "write", 1)], m.f_codes)
    with pytest.raises(ValueError):
        teng.segment_states(seq, m, [(0,)])


@pytest.mark.parametrize("seed", range(4))
def test_value_blocks_match_reference(seed):
    """The value-block verdict and witness on the unique-writes class,
    and the gate's answer on the other classes."""
    for k in range(seed * 8, seed * 8 + 8):
        for label, seed0 in (("uniq", 1000), ("cas", 0), ("quiesce", 2000)):
            jmod, jseq = fuzz_case(JAX, label, seed0 + k, k)
            tmod, tseq = fuzz_case(PORT, label, seed0 + k, k)
            assert tpart.value_block_verdict(tseq, tmod) == \
                jpart.value_block_verdict(jseq, jmod)
            assert tpart.value_block_witness(tseq, tmod) == \
                jpart.value_block_witness(jseq, jmod)


def test_value_blocks_refuse_the_naive_projection():
    """w(1) w(2) concurrent, then reads 1, 2, 1 in sequence: each value's
    projection linearizes alone, but 1, 2, 1 needs two writes of 1.  The
    block order test catches it, in both packages."""
    out = []
    for h, models, encode in ((jh, jm, j_encode_ops),
                              (th, tm, t_encode_ops)):
        ev = [h.invoke_op(0, "write", 1), h.invoke_op(1, "write", 2),
              h.invoke_op(2, "read", None), h.ok_op(2, "read", 1),
              h.invoke_op(3, "read", None), h.ok_op(3, "read", 2),
              h.invoke_op(4, "read", None), h.ok_op(4, "read", 1),
              h.ok_op(0, "write", 1), h.ok_op(1, "write", 2)]
        m = models.register(0)
        out.append((m, encode(ev, m.f_codes)))
    (jmod, jseq), (tmod, tseq) = out
    assert t_check(tseq, tmod)["valid"] is False
    assert tpart.value_block_verdict(tseq, tmod) is False
    assert tpart.value_block_witness(tseq, tmod) is None
    a = jeng.check_opseq_decomposed(jseq, jmod)
    b = teng.check_opseq_decomposed(tseq, tmod)
    assert b == a and b["valid"] is False


def test_value_block_gate_matches_reference():
    def hists(h):
        return [
            [h.invoke_op(0, "cas", (0, 1)), h.ok_op(0, "cas", (0, 1))],
            [h.invoke_op(0, "write", 3), h.ok_op(0, "write", 3),
             h.invoke_op(0, "write", 3), h.ok_op(0, "write", 3)],
            [h.invoke_op(0, "write", 3), h.info_op(0, "write", 3)],
            [h.invoke_op(0, "read", None), h.ok_op(0, "read", 42)],
            [h.invoke_op(0, "read", None), h.ok_op(0, "read", 0),
             h.invoke_op(0, "write", 5), h.ok_op(0, "write", 5),
             h.invoke_op(0, "read", None), h.ok_op(0, "read", 5)]]

    from jepsen_tpu.analyze import plan as jplan
    from jepsen_tpu_torch.analyze import plan as tplan

    got = []
    for jev, tev in zip(hists(jh), hists(th)):
        jmod, tmod = jm.cas_register(0), tm.cas_register(0)
        jseq = j_encode_ops(jev, jmod.f_codes)
        tseq = t_encode_ops(tev, tmod.f_codes)
        assert tplan.value_block_gate(tseq, tmod) == \
            jplan.value_block_gate(jseq, jmod)
        assert tplan.quiescence_cuts(tseq).tolist() == \
            jplan.quiescence_cuts(jseq).tolist()
        got.append(tpart.value_block_verdict(tseq, tmod))
        assert got[-1] == jpart.value_block_verdict(jseq, jmod)
    assert got == [None, None, None, False, True]


def _canon_models(models):
    return [models.register(0), models.register(7), models.cas_register(),
            models.cas_register(3), models.mutex(), models.noop(),
            models.multi_register(3), models.unordered_queue(4),
            models.fifo_queue(4)]


@pytest.mark.parametrize("label", ["cas", "uniq", "quiesce", "mutex",
                                   "multireg"])
def test_canonical_keys_are_the_reference_keys(label):
    """The canonical payload is the JAX package's byte for byte, for
    every model identity and with input states, so keys (and cache
    files) are shared between the packages."""
    for k in range(6):
        jmod, jseq = fuzz_case(JAX, label, 500 + k, k)
        tmod, tseq = fuzz_case(PORT, label, 500 + k, k)
        for jm_, tm_ in zip(_canon_models(jm), _canon_models(tm)):
            pj, _ = jcan.canonical_payload(jseq, jm_)
            pt, _ = tcan.canonical_payload(tseq, tm_)
            assert pt == pj
            assert tcan.canonical_key(tseq, tm_) == \
                jcan.canonical_key(jseq, jm_)
        ins = {tuple(tmod.init), tuple(x + 1 for x in tmod.init)}
        assert tcan.canonical_key(tseq, tmod, instates=ins) == \
            jcan.canonical_key(jseq, jmod, instates=ins)


def test_canonical_key_invariances():
    """Process renaming, shifted event indices and a value bijection
    leave the key alone; the model's identity does not."""
    m = tm.cas_register()
    h = ts.sim_register_history(random.Random(21), n_procs=4, n_ops=24,
                                crash_p=0.1)
    seq = t_encode_ops(h, m.f_codes)
    k0 = tcan.canonical_key(seq, m)
    h2 = [dataclasses.replace(op, process=op.process + 100) for op in h]
    assert tcan.canonical_key(t_encode_ops(h2, m.f_codes), m) == k0
    h3 = [th.invoke_op(99, "write", 7),
          dataclasses.replace(th.ok_op(99, "write", 7), type="fail"), *h]
    assert tcan.canonical_key(t_encode_ops(h3, m.f_codes), m) == k0

    def shift(v):
        if isinstance(v, int):
            return v + 50
        if isinstance(v, (tuple, list)):
            return tuple(shift(x) for x in v)
        return v

    h4 = [dataclasses.replace(op, value=shift(op.value)) for op in h]
    assert tcan.canonical_key(t_encode_ops(h4, m.f_codes), m) == k0
    assert tcan.canonical_key(seq, tm.cas_register(7)) != k0
    assert tcan.canonical_key(seq, tm.register(0)) != k0


def test_cells_carry_the_register_key():
    """A multi-register cell (value moved to v1) has the canonical key
    of the same register history checked on its own."""
    rng = random.Random(8)
    m = tm.multi_register(2)
    h = sim_multireg_history(th, rng, width=2, n_ops=24)
    seq = t_encode_ops(h, m.f_codes)
    cells, cm = tpart.partition_by_key(seq, m)[:2]
    for k, cell in cells.items():
        own = [dataclasses.replace(op, value=op.value[1])
               for op in h if op.value[0] == k]
        alone = t_encode_ops(own, cm.f_codes)
        assert tcan.canonical_key(cell, cm) == tcan.canonical_key(alone, cm)
    jcells = jpart.partition_by_key(
        j_encode_ops(sim_multireg_history(jh, random.Random(8),
                                          width=2, n_ops=24),
                     jm.multi_register(2).f_codes),
        jm.multi_register(2))[0]
    assert {k: tcan.canonical_key(c, cm) for k, c in cells.items()} == \
        {k: jcan.canonical_key(c, jm.register(0)) for k, c in jcells.items()}


def test_partition_early_verdict_and_bad_rows():
    m = tm.multi_register(2)
    ev = [th.invoke_op(0, "write", (5, 1)), th.ok_op(0, "write", (5, 1)),
          th.invoke_op(1, "write", (0, 1)), th.ok_op(1, "write", (0, 1))]
    seq = t_encode_ops(ev, m.f_codes)
    assert tpart.partition_by_key(seq, m) == ({}, None, False)
    r = teng.check_opseq_decomposed(seq, m)
    assert r["valid"] is False and r["final_ops"] == [0]
    assert tpart.partition_by_key(seq, tm.register()) == (None, None, None)


# ---------------------------------------------------------------------------
# the batch front, the schedulers and the entry points
# ---------------------------------------------------------------------------


def _shapes(pkg, copies=3, n=4):
    """``n`` shapes, ``copies`` of each, shaped like the batch256 keys
    (overlapping cas-register histories, shape 0 corrupted), so one of
    them rides the batch ladder."""
    synth, models, encode, _h = pkg
    m = models.cas_register()
    seqs = []
    for k in range(n * copies):
        rng = random.Random(f"shape-{k % n}")
        h = synth.register_history(rng, n_ops=32, n_procs=4, overlap=3,
                                   crash_p=0.02, max_crashes=2, n_values=4)
        if k % n == 0:
            h = synth.corrupt_read(rng, h, at=0.85)
        seqs.append(encode(h, m.f_codes))
    return seqs, m


def test_search_batch_decompose_dedups_like_reference():
    """4 shapes x 3 copies: 4 searched, 8 deduplicated, every key's
    verdict and engine the JAX package's."""
    jseqs, jmod = _shapes(JAX)
    tseqs, tmod = _shapes(PORT)
    ref = jlin.search_batch(jseqs, jmod, budget=200_000, decompose=True)
    out = tlin.search_batch(tseqs, tmod, budget=200_000, decompose=True,
                            device="cpu")
    assert [r["valid"] for r in out] == [r["valid"] for r in ref]
    assert [r["engine"] for r in out] == [r["engine"] for r in ref]
    assert "device-batch" in {r["engine"] for r in out}
    assert out[0]["decompose_batch"] == ref[0]["decompose_batch"]
    st = out[0]["decompose_batch"]
    assert st["searched"] == 4 and st["deduped"] == 8
    assert [r["engine"] for r in out if r["configs"] == 0].count(
        "decompose-dedup") == 8
    # the copies carry the representative's certificate
    for i in range(4, 12):
        for f in ("linearization", "final_ops", "witness_dropped",
                  "frontier_dropped"):
            assert out[i].get(f) == out[i % 4].get(f)
    plain = tlin.search_batch(tseqs, tmod, budget=200_000, device="cpu")
    assert [r["valid"] for r in out] == [r["valid"] for r in plain]


def test_search_batch_decompose_cache_persists(tmp_path):
    """A second batch on the same cache file (a fresh object) is all
    hits, nothing searched, each key's verdict the first run's."""
    tseqs, tmod = _shapes(PORT, copies=2)
    path = str(tmp_path / "verdicts.jsonl")
    first = tlin.search_batch(tseqs, tmod, decompose=True, device="cpu",
                              decompose_cache=TCache(path))
    again = tlin.search_batch(tseqs, tmod, decompose=True, device="cpu",
                              decompose_cache=path)
    assert [r["valid"] for r in again] == [r["valid"] for r in first]
    st = again[0]["decompose_batch"]
    assert (st["cache_hits"], st["searched"], st["deduped"]) == (8, 0, 0)
    assert {r["engine"] for r in again} == {"decompose-cache"}


def test_search_batch_decompose_solo_retry(monkeypatch):
    """A representative the batch leaves undecided is searched alone
    once per shape; the decided retry serves every copy and the
    representative."""
    tseqs, tmod = _shapes(PORT, copies=2, n=2)
    real = tlin.search_batch
    solo = []

    def undecided_batch(seqs, model, **kw):
        if kw.get("decompose"):
            return real(seqs, model, **kw)
        return [{"valid": "unknown", "configs": 1, "engine": "device-batch"}
                for _ in seqs]

    def counted_opseq(seq, model, **kw):
        solo.append(kw)
        return tlin_search_opseq(seq, model, **kw)

    tlin_search_opseq = tlin.search_opseq
    monkeypatch.setattr(tlin, "search_batch", undecided_batch)
    monkeypatch.setattr(tlin, "search_opseq", counted_opseq)
    out = real(tseqs, tmod, decompose=True, device="cpu")
    assert len(solo) == 2 and all(str(k["device"]) == "cpu" for k in solo)
    want = [t_check(s, tmod)["valid"] for s in tseqs]
    assert [r["valid"] for r in out] == want
    assert all(out[i]["engine"].endswith("+decompose-retry")
               for i in range(2))
    assert out[0]["decompose_batch"]["deduped"] == 0


def _multireg(pkg, seed=5, width=4, n_ops=50, n_procs=6):
    synth, models, encode, h = pkg
    m = models.multi_register(width)
    ev = sim_multireg_history(h, random.Random(seed), width=width,
                              n_ops=n_ops, n_procs=n_procs)
    return encode(ev, m.f_codes), m


def test_pool_scheduler_matches_reference():
    """Two spawned workers, each importing only the port, run host
    engines over the cells: the JAX package's verdict and decompose
    dict."""
    jseq, jmod = _multireg(JAX)
    tseq, tmod = _multireg(PORT)
    ref = jeng.check_opseq_decomposed(jseq, jmod, scheduler="pool",
                                      n_procs=2)
    out = teng.check_opseq_decomposed(tseq, tmod, scheduler="pool",
                                      n_procs=2, device="no-card-needed")
    assert out == ref
    assert out["decompose"]["cells"] > 1
    assert "pool" in out["decompose"]["methods"]
    assert out["valid"] == t_check(tseq, tmod)["valid"]


@pytest.mark.parametrize("corrupt", [False, True])
def test_device_scheduler_matches_reference(corrupt):
    """The cells as one ``search_batch`` on the CPU, one of them on the
    batch ladder: the JAX package's whole result."""
    outs = []
    for synth, models, encode, h in (JAX, PORT):
        m = models.multi_register(3)
        ev = sim_multireg_history(h, random.Random(4), width=3, n_ops=40,
                                  n_procs=6, crash_p=0.1)
        if corrupt:
            ev = _flip_mr_read(random.Random(3), ev)
        outs.append((encode(ev, m.f_codes), m))
    (jseq, jmod), (tseq, tmod) = outs
    ref = jeng.check_opseq_decomposed(jseq, jmod, scheduler="device")
    out = teng.check_opseq_decomposed(tseq, tmod, scheduler="device",
                                      device="cpu")
    assert out == ref
    assert out["valid"] == t_check(tseq, tmod)["valid"]
    assert "device" in out["decompose"]["methods"]
    assert "device-batch" in out["decompose"]["cell_engines"]
    with pytest.raises(RuntimeError, match="is_available"):
        teng.check_opseq_decomposed(tseq, tmod, scheduler="device")


def test_in_process_scheduler_needs_no_card():
    """``device`` (default "cuda") is resolved only where a device route
    runs, so the in-process scheduler runs without a card."""
    tseq, tmod = _multireg(PORT, n_ops=20)
    r = teng.check_opseq_decomposed(tseq, tmod, device="cuda")
    assert r["valid"] == t_check(tseq, tmod)["valid"]
    assert r["decompose"]["cells"] > 1


def test_schedule_model_descriptor_roundtrip():
    from jepsen_tpu_torch.decompose.schedule import (model_descriptor,
                                                     model_from_descriptor)

    for m in (tm.register(3), tm.cas_register(), tm.mutex(), tm.noop(),
              tm.multi_register(5, 2), tm.unordered_queue(8),
              tm.fifo_queue(4)):
        m2 = model_from_descriptor(model_descriptor(m))
        assert (m2.name, m2.init, m2.state_width) == \
            (m.name, m.init, m.state_width)
    with pytest.raises(ValueError):
        model_from_descriptor(("nope", (0,), 1))


@pytest.mark.parametrize("seed", range(8))
def test_entry_points_decompose_match_direct(seed):
    """``check_opseq`` and ``check_opseq_linear`` with ``decompose=True``
    give their direct verdicts and the JAX package's decomposed
    results."""
    from jepsen_tpu.checker.linear import check_opseq_linear as j_linear

    for k in range(seed * 3, seed * 3 + 3):
        jmod, jseq = fuzz_case(JAX, "cas", 50 + k, k)
        tmod, tseq = fuzz_case(PORT, "cas", 50 + k, k)
        want = t_check(tseq, tmod)["valid"]
        a = t_check(tseq, tmod, decompose=True)
        b = t_linear(tseq, tmod, decompose=True, witness_cap=100_000)
        assert a["valid"] == b["valid"] == want
        assert a == j_check(jseq, jmod, decompose=True)
        assert b == j_linear(jseq, jmod, decompose=True,
                             witness_cap=100_000)


def test_check_opseq_decompose_cache(tmp_path):
    tmod, tseq = fuzz_case(PORT, "quiesce", 2003, 3)
    path = str(tmp_path / "v.jsonl")
    r1 = t_check(tseq, tmod, decompose=True, decompose_cache=path)
    r2 = t_linear(tseq, tmod, decompose=True, decompose_cache=TCache(path))
    assert r1["valid"] == r2["valid"]
    assert r2["configs"] == 0 and r2["decompose"]["methods"] == ["cache"]


def test_linear_refuses_checkpoint_with_decompose(tmp_path):
    tmod, tseq = fuzz_case(PORT, "cas", 1, 1)
    with pytest.raises(ValueError, match="checkpoint"):
        t_linear(tseq, tmod, decompose=True,
                 checkpoint_path=str(tmp_path / "c.npz"),
                 checkpoint_every=1)
    with pytest.raises(ValueError, match="checkpoint"):
        t_linear(tseq, tmod, decompose=True,
                 resume_from=str(tmp_path / "c.npz"))


@pytest.mark.parametrize("algorithm", ["linear", "host", "device"])
def test_linearizable_decompose_matches_reference(algorithm, tmp_path):
    """``Linearizable(decompose=True)``: the JAX package's result, valid
    and invalid (with its report), on a history the quiescence cuts and
    interval folds decide and on one that falls back to the selected
    route (``direct``)."""
    for seed, corrupt, method in ((0, False, "quiescence"),
                                  (0, True, "quiescence"),
                                  (1, False, "direct"),
                                  (1, True, "direct")):
        outs = []
        for pkg, lin in ((JAX, jlin), (PORT, tlin)):
            synth, models, encode, _h = pkg
            m = models.cas_register()
            rng = random.Random(seed)
            h = synth.register_history(rng, n_ops=50, n_procs=4, overlap=3,
                                       crash_p=0.05, n_values=4)
            if corrupt:
                h = synth.corrupt_read(rng, h, at=0.5)
            kw = {"device": "cpu"} if lin is tlin else {}
            test = {"name": "dec", "store_base": str(tmp_path / lin.__name__)}
            outs.append(lin.Linearizable(
                m, algorithm=algorithm, decompose=True, **kw).check(test, h))
        ref, out = outs
        assert out["valid"] == ref["valid"]
        assert out["engine"] == ref["engine"]
        assert out["engine"].startswith("decompose")
        assert out["decompose"] == ref["decompose"]
        assert method in out["decompose"]["methods"]
        assert out["valid"] is not corrupt
        for f in ("linearization", "final_ops", "witness_dropped",
                  "frontier_dropped"):
            assert out.get(f) == ref.get(f)
        if out["valid"] is False:
            assert out["report_file"].endswith("linear.html")


def test_linearizable_verdict_cache(tmp_path, monkeypatch):
    """``verdict_cache`` as a path is opened once per checker;
    ``verdict_cache=True`` is the store's default path; the second check
    of a history is one whole-history hit."""
    from jepsen_tpu_torch.decompose.cache import default_cache_path

    monkeypatch.chdir(tmp_path)
    m = tm.cas_register()
    h = ts.sim_register_history(random.Random(9), n_procs=4, n_ops=40)
    for vc in (str(tmp_path / "v.jsonl"), True):
        chk = tlin.Linearizable(m, algorithm="linear", decompose=True,
                                verdict_cache=vc, device="cpu")
        r1 = chk.check({"name": "vc"}, h)
        obj = chk._cache_obj
        r2 = chk.check({"name": "vc"}, h)
        assert chk._cache_obj is obj
        assert r2["valid"] == r1["valid"] is True
        assert r2["decompose"]["methods"] == ["cache"]
        assert r2["configs"] == 0
    assert (tmp_path / default_cache_path()).exists()
    assert default_cache_path("b") == "b/verdict_cache/verdicts.jsonl"


def test_decompose_lint_runs_before_the_cache():
    from jepsen_tpu_torch.analyze.lint import HistoryLintError

    m = tm.cas_register()
    seq = t_encode_ops([th.invoke_op(0, "write", 1),
                        th.ok_op(0, "write", 1)], m.f_codes)
    seq.inv = np.array([3], dtype=np.int64)
    seq.ret = np.array([1], dtype=np.int64)
    cache = TCache()
    with pytest.raises(HistoryLintError):
        teng.check_opseq_decomposed(seq, m, cache=cache)
    assert len(cache) == 0
