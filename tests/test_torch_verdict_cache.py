"""The port's verdict cache (``decompose/cache.py``): the JAX package's
compaction contract (``tests/test_cache_compact.py``) on
``VerdictCache(compact_bytes=)``, files shared between the two packages
in both directions, and no "unknown" ever stored.  Beside them, the
interval pass's segment fold and per-key disposal (``analyze/hb.py``'s
``hb_fold_states`` and ``hb_dispose``) against the JAX package's."""

import json
import os
import random
import threading

import pytest

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.analyze import hb as jhb
from jepsen_tpu.checker.seq import check_opseq as j_check
from jepsen_tpu.decompose import engine as jeng
from jepsen_tpu.decompose.cache import VerdictCache as JCache
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.analyze import hb as thb
from jepsen_tpu_torch.checker.seq import check_opseq as t_check
from jepsen_tpu_torch.decompose import engine as teng
from jepsen_tpu_torch.decompose.cache import VerdictCache
from jepsen_tpu_torch.obs import REGISTRY
from test_torch_search import reference_defaults


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    reference_defaults(monkeypatch)


def _lines(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def test_compact_drops_superseded_lines(tmp_path):
    p = str(tmp_path / "v.jsonl")
    c = VerdictCache(p, compact_bytes=0)  # compaction by hand only
    for _ in range(5):
        c.put_verdict("k1", True)
        c.put_verdict("k2", False)
        c.put_states("k3", [[1, 2], [3, 4]])
    assert len(_lines(p)) == 15
    assert c.compact() == 12
    live = _lines(p)
    assert len(live) == 3
    assert {e["k"] for e in live} == {"k1", "k2", "k3"}
    c2 = VerdictCache(p)
    assert c2.get("k1") == {"k": "k1", "v": True}
    assert c2.get("k2") == {"k": "k2", "v": False}
    assert c2.get("k3")["out"] == [[1, 2], [3, 4]]
    assert (c.compactions, c.compacted_away) == (1, 12)


def test_compact_then_append_lands_in_new_file(tmp_path):
    p = str(tmp_path / "v.jsonl")
    c = VerdictCache(p, compact_bytes=0)
    for _ in range(3):
        c.put_verdict("a", True)
    c.compact()
    c.put_verdict("b", False)  # the append handle follows the replace
    assert {e["k"] for e in _lines(p)} == {"a", "b"}
    assert len(_lines(p)) == 2


def test_compact_merges_other_writers_entries(tmp_path):
    """Another writer appended since the load: compaction keeps its
    entries."""
    p = str(tmp_path / "v.jsonl")
    c1 = VerdictCache(p, compact_bytes=0)
    c1.put_verdict("mine", True)
    c2 = VerdictCache(p, compact_bytes=0)
    c2.put_verdict("theirs", False)
    c1.compact()
    assert {e["k"] for e in _lines(p)} == {"mine", "theirs"}
    c3 = VerdictCache(p)
    assert c3.get("mine")["v"] is True
    assert c3.get("theirs")["v"] is False


def test_auto_compaction_triggers_past_threshold(tmp_path):
    p = str(tmp_path / "v.jsonl")
    c = VerdictCache(p, compact_bytes=2000)
    # one hot key: the file grows while the live set stays at 1
    for _ in range(3000):
        c.put_verdict("hot", True)
    assert c.compactions >= 1
    assert os.path.getsize(p) < 2000 + 4096
    assert len(_lines(p)) < 300
    c.close()
    assert VerdictCache(p).get("hot")["v"] is True


def test_compaction_disabled_with_zero_threshold(tmp_path):
    p = str(tmp_path / "v.jsonl")
    c = VerdictCache(p, compact_bytes=0)
    for _ in range(600):
        c.put_verdict("hot", True)
    assert c.compactions == 0
    assert len(_lines(p)) == 600
    assert VerdictCache(p).compact_bytes == 64 << 20


def test_in_memory_cache_compact_is_noop():
    c = VerdictCache(None)
    c.put_verdict("x", True)
    assert c.compact() == 0


def test_concurrent_writer_appends_survive_compaction_race(tmp_path):
    """A second writer appending while the first compacts loses nothing:
    the lock serializes each append against the merge-read -> replace
    window, and each append re-checks its handle's inode."""
    p = str(tmp_path / "v.jsonl")
    a = VerdictCache(p, compact_bytes=0)
    b = VerdictCache(p, compact_bytes=0)
    n = 200
    stop = threading.Event()

    def writer():
        for i in range(n):
            b.put_verdict(f"b{i}", i % 2 == 0)
        stop.set()

    def compactor():
        while True:  # at least once, even if the writer finished first
            a.put_verdict("hot", True)
            a.compact()
            if stop.is_set():
                break

    threads = [threading.Thread(target=writer),
               threading.Thread(target=compactor)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    a.compact()
    fresh = VerdictCache(p)
    assert [i for i in range(n) if fresh.get(f"b{i}") is None] == []
    assert fresh.get("hot")["v"] is True


def test_reader_mid_scan_sees_complete_old_view(tmp_path):
    """A reader that opened the file before a compaction reads the whole
    old file; a fresh loader sees the compacted one."""
    p = str(tmp_path / "v.jsonl")
    c = VerdictCache(p, compact_bytes=0)
    for i in range(50):
        c.put_verdict(f"k{i}", True)
        c.put_verdict(f"k{i}", False)
    with open(p) as f:
        head = [json.loads(f.readline()) for _ in range(10)]
        c.compact()
        tail = [json.loads(x) for x in f if x.strip()]
    assert len(head) + len(tail) == 100
    assert [e["k"] for e in head] == [f"k{i // 2}" for i in range(10)]
    assert len(_lines(p)) == 50


def test_unknown_is_never_stored(tmp_path):
    """A budget miss is not a property of the history: "unknown" is not
    stored, and a decomposed check cut short by its budget writes no
    verdict."""
    p = str(tmp_path / "v.jsonl")
    c = VerdictCache(p)
    c.put_verdict("k1", "unknown")
    c.put_verdict("k2", True)
    assert len(VerdictCache(p)) == 1 and c.inserts == 1
    m = tm.cas_register()
    h = ts.register_history(random.Random(3), n_ops=40, n_procs=4,
                            overlap=3, crash_p=0.05, n_values=4)
    seq = th.encode_ops(h, m.f_codes)
    path = str(tmp_path / "u.jsonl")
    cache = VerdictCache(path)
    r = teng.check_opseq_decomposed(seq, m, cache=cache, sub_max_configs=1,
                                    hb=False)
    assert r["valid"] == "unknown"
    assert not any("v" in e for e in cache._d.values())
    assert not any("v" in e for e in
                   (_lines(path) if os.path.exists(path) else []))


def test_verdict_cache_metric_counts_events(tmp_path):
    metric = REGISTRY.get("jtpu_verdict_cache_total")
    before = {e: metric.value(event=e) for e in ("hit", "miss", "insert")}
    c = VerdictCache(str(tmp_path / "v.jsonl"))
    c.get("a")
    c.put_verdict("a", True)
    c.get("a")
    c.put_verdict("b", "unknown")
    after = {e: metric.value(event=e) for e in ("hit", "miss", "insert")}
    assert {e: after[e] - before[e] for e in after} == \
        {"hit": 1, "miss": 1, "insert": 1}


# ---------------------------------------------------------------------------
# one file, two packages
# ---------------------------------------------------------------------------


def _histories(pkg_synth, models, encode):
    """A mix that fills whole-history, cell and segment entries."""
    out = []
    for k in range(6):
        m = models.cas_register()
        rng = random.Random(k)
        h = pkg_synth.register_history(rng, n_ops=40, n_procs=3, overlap=1,
                                       crash_p=0.02, max_crashes=2,
                                       n_values=4)
        if k % 2:
            h = pkg_synth.flip_read(rng, h)
        out.append((encode(h, m.f_codes), m))
        m = models.register(0)
        h = pkg_synth.register_history(random.Random(100 + k), n_ops=30,
                                       n_procs=4, overlap=3,
                                       unique_writes=True, cas=False)
        out.append((encode(h, m.f_codes), m))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_files_are_shared_between_packages(writer, tmp_path):
    """A jsonl written by one package's cache serves the other's hits on
    the same histories: every history a whole-history hit, no search."""
    path = str(tmp_path / "verdicts.jsonl")
    jax_h = _histories(js, jm, jh.encode_ops)
    port_h = _histories(ts, tm, th.encode_ops)
    first, then = ((jax_h, jeng, JCache, j_check),
                   (port_h, teng, VerdictCache, t_check))
    if writer == "port":
        first, then = then, first
    hs, eng, cache_cls, check = first
    c = cache_cls(path)
    want = []
    for seq, m in hs:
        r = eng.check_opseq_decomposed(seq, m, cache=c,
                                       direct=lambda s, m=m: check(s, m))
        want.append(r["valid"])
    c.close()
    hs, eng, cache_cls, check = then
    c = cache_cls(path)
    for (seq, m), v in zip(hs, want):
        r = eng.check_opseq_decomposed(seq, m, cache=c)
        assert r["valid"] is v and v == check(seq, m)["valid"]
        assert r["decompose"]["methods"] == ["cache"]
        assert r["configs"] == 0
    assert c.hits == 1 and c.misses == 0  # the last check's counts
    assert True in want and False in want


def test_segment_entries_are_shared_between_packages(tmp_path):
    """Segment state sets stored by the JAX package serve the port's
    folds: a second cell with the same segments but another final
    segment reads them."""
    path = str(tmp_path / "verdicts.jsonl")
    jc = JCache(path)
    m = jm.cas_register()
    h = js.register_history(random.Random(7), n_ops=44, n_procs=3,
                            overlap=1, crash_p=0.0, n_values=3)
    jeng.check_opseq_decomposed(jh.encode_ops(h, m.f_codes), m, cache=jc,
                                hb=False)
    jc.close()
    segs = [e for e in JCache(path)._d.values() if "out" in e]
    assert segs
    m = tm.cas_register()
    h = ts.register_history(random.Random(7), n_ops=44, n_procs=3,
                            overlap=1, crash_p=0.0, n_values=3)
    seq = th.encode_ops(h, m.f_codes)
    tc = VerdictCache(path)
    r = teng.check_opseq_decomposed(seq, m, cache=tc, hb=False)
    assert r["decompose"]["methods"] == ["cache"] and r["configs"] == 0
    # the same cell with its whole-history entry gone: every segment a
    # hit, then the final segment's verdict a hit too
    from jepsen_tpu_torch.decompose.canonical import canonical_key

    del tc._d[canonical_key(seq, m)]
    tc.reset_stats()
    r2 = teng.check_opseq_decomposed(seq, m, cache=tc, hb=False)
    assert r2["valid"] == r["valid"] and r2["configs"] == 0
    # one hit per segment: the folds before the last cut, then the final
    # segment's verdict
    assert r2["decompose"]["cache_hits"] == r2["decompose"]["segments"]


# ---------------------------------------------------------------------------
# the interval pass's segment fold and disposal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", range(4))
def test_fold_states_match_reference_and_sweep(chunk):
    """On segments from the JAX package's fold fuzz (unique or repeated
    writes, some corrupted, one or two input states): the port's fold
    is the JAX package's (states and chains), and where it decides, its
    states are the sweep's."""
    folded = 0
    for i in range(chunk * 30, chunk * 30 + 30):
        outs = []
        for synth, models, h_mod in ((js, jm, jh), (ts, tm, th)):
            rng = random.Random(40_000 + i)
            m = models.register(rng.randrange(0, 3))
            h = synth.register_history(
                rng, n_ops=rng.randrange(4, 22),
                n_procs=rng.randrange(2, 5), overlap=rng.randrange(1, 5),
                crash_p=0.0, cas=False, unique_writes=rng.random() < 0.7)
            if rng.random() < 0.4:
                h = synth.flip_read(rng, h)
            insts = [tuple(m.init)]
            if rng.random() < 0.5:
                insts.append((rng.randrange(0, 4),))
            witness = rng.random() < 0.5
            outs.append((h_mod.encode_ops(h, m.f_codes), m, insts, witness))
        (jseq, jmod, insts, witness), (tseq, tmod, _, _) = outs
        if len(tseq) == 0:
            continue
        a = jhb.hb_fold_states(jseq, jmod, insts, witness=witness)
        b = thb.hb_fold_states(tseq, tmod, insts, witness=witness)
        assert b == a, i
        if b is None:
            continue
        states = b[0] if witness else b
        assert states == teng.segment_states(tseq, tmod, insts)
        if witness and b[1] is not None:
            assert set(b[1]) == states
        folded += 1
    assert folded >= 3


def test_fold_cedes_rather_than_truncating_states():
    """Twelve concurrent writes have twelve final states, past the
    fold's witness cap: the fold cedes (None) instead of returning part
    of the set, in both packages."""
    outs = []
    for h_mod, models in ((jh, jm), (th, tm)):
        m = models.register(0)
        ev = [h_mod.invoke_op(v, "write", v) for v in range(1, 13)] + \
             [h_mod.ok_op(v, "write", v) for v in range(1, 13)]
        outs.append((h_mod.encode_ops(ev, m.f_codes), m))
    (jseq, jmod), (tseq, tmod) = outs
    assert thb.hb_fold_states(tseq, tmod, [(0,)], witness=True) is None
    assert jhb.hb_fold_states(jseq, jmod, [(0,)], witness=True) is None
    assert len(teng.segment_states(tseq, tmod, [(0,)])) == 12
    assert thb.FOLD_INSTATE_CAP == jhb.FOLD_INSTATE_CAP
    many = [(v,) for v in range(thb.FOLD_INSTATE_CAP + 1)]
    assert thb.hb_fold_states(tseq, tmod, many) is None


def test_fold_counter_and_out_of_scope():
    metric = REGISTRY.get("jtpu_hb_fold_total")
    before = metric.value()
    m = tm.register(0)
    ev = [th.invoke_op(0, "write", 1), th.ok_op(0, "write", 1),
          th.invoke_op(1, "read", None), th.ok_op(1, "read", 1)]
    seq = th.encode_ops(ev, m.f_codes)
    assert thb.hb_fold_states(seq, m, [(0,)]) == {(1,)}
    assert metric.value() == before + 1
    mx = tm.mutex()
    assert thb.hb_fold_states(seq, mx, [(0,)]) is None
    crashed = th.encode_ops([th.invoke_op(0, "write", 1),
                             th.info_op(0, "write", 1)], m.f_codes)
    assert thb.hb_fold_states(crashed, m, [(0,)]) is None
    assert metric.value() == before + 1


def test_hb_false_reaches_decomposed_folds():
    """``hb=False`` reaches the decomposed route: no segment is folded
    by the interval pass, and the verdict is the same."""
    m = tm.register(0)
    # a crash near the end keeps the history out of the value-block
    # class, and leaves crash-free segments before it
    h = ts.register_history(random.Random(11), n_ops=40, n_procs=3,
                            overlap=2, quiesce_every=5, crash_p=0.0,
                            cas=False, unique_writes=True)
    h += [th.invoke_op(7, "write", 99), th.info_op(7, "write", 99)]
    s = th.encode_ops(h, m.f_codes)
    from jepsen_tpu_torch.checker.linear import check_opseq_linear

    on = check_opseq_linear(s, m, decompose=True, hb=True, lint=False)
    off = check_opseq_linear(s, m, decompose=True, hb=False, lint=False)
    assert on["valid"] == off["valid"]
    assert "hb-fold" in on["decompose"]["methods"]
    assert "hb-fold" not in off["decompose"]["methods"]


@pytest.mark.parametrize("family", ["register", "mutex", "multireg"])
def test_hb_dispose_matches_reference(family):
    """The per-key disposal: the JAX package's decided result
    (certificate included) or None, register keys through the interval
    pass and mutex keys through the constraint compiler."""
    decided = 0
    for k in range(12):
        outs = []
        for synth, models, h_mod in ((js, jm, jh), (ts, tm, th)):
            rng = random.Random(700 + k)
            if family == "register":
                m = models.register(0)
                h = synth.register_history(rng, n_ops=20, n_procs=3,
                                           overlap=2, cas=False,
                                           unique_writes=k % 2 == 0)
                if k % 3 == 0:
                    h = synth.flip_read(rng, h)
            elif family == "mutex":
                m = models.mutex()
                h = synth.sim_mutex_history(rng, n_ops=16, n_procs=3,
                                            crash_p=0.05 * (k % 2))
                if k % 3 == 0:
                    # a lock taken first and never released
                    h = [h_mod.invoke_op(9, "acquire"),
                         h_mod.ok_op(9, "acquire"), *h]
            else:
                m = models.multi_register(2)
                h = synth.register_history(rng, n_ops=16, n_procs=3,
                                           overlap=2, cas=False,
                                           unique_writes=True)
                if k % 3 == 0:
                    h = synth.flip_read(rng, h)
                h = [h_mod.Op(op.process, op.type, op.f, (k % 2, op.value))
                     for op in h]
            outs.append((h_mod.encode_ops(h, m.f_codes), m))
        (jseq, jmod), (tseq, tmod) = outs
        a = jhb.hb_dispose(jseq, jmod)
        b = thb.hb_dispose(tseq, tmod)
        assert b == a
        assert thb.hb_dispose(tseq, tmod, False) is None
        if b is not None:
            decided += 1
            assert b["valid"] == t_check(tseq, tmod, hb=False)["valid"]
    assert decided > 0
