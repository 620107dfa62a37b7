"""The port's streaming checker (``jepsen_tpu_torch/stream/``) against the
JAX package's, on the same histories made from seeds.

Every history goes through both packages' ``StreamChecker`` op by op,
and the whole results must be equal: ``valid``, ``configs``,
``engine``, the ``stream`` dict, the certificates and the drop reasons,
and the event at which the live verdict first turned ``invalid``.
Covered: a stride of the JAX package's 215-case fuzz corpus
(``tests/test_stream.py``, every fifth case, all five classes), the
early-invalid event, the never-quiescing tail, independent ``[k v]``
streams against the port's ``independent.checker``, the verdict cache
shared both ways between the packages, forced device routing on the
torch step, ``device_fold_states`` against ``segment_states``, async
against inline folds, the ``:info`` lookahead and its fork budget,
``stream_plan``, the multiset folds, and the rule that a device-route
error propagates while a host-fold error falls back."""

import dataclasses
import random

import pytest
import torch

import jepsen_tpu.checker.linearizable as jlin
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.analyze import constraints as jcons
from jepsen_tpu.analyze import plan as jplan
from jepsen_tpu.decompose import engine as jeng
from jepsen_tpu.decompose import partition as jpart
from jepsen_tpu.decompose.cache import VerdictCache as JCache
from jepsen_tpu.stream import StreamChecker as JStream
from jepsen_tpu.stream.checker import TotalFoldStream as JTotal
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.analyze import constraints as tcons
from jepsen_tpu_torch.analyze import plan as tplan
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.decompose import engine as teng
from jepsen_tpu_torch.decompose import partition as tpart
from jepsen_tpu_torch.decompose.cache import VerdictCache as TCache
from jepsen_tpu_torch.stream import StreamChecker as TStream
from jepsen_tpu_torch.stream import TotalFoldStream as TTotal
from jepsen_tpu_torch.stream import device as tdev
from test_torch_decompose import _flip_mr_read, sim_multireg_history
from test_torch_search import reference_defaults

JAX = dict(synth=js, models=jm, hist=jh, ind=jind, stream=JStream,
           total=JTotal, kw={})
PORT = dict(synth=ts, models=tm, hist=th, ind=tind, stream=TStream,
            total=TTotal, kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """The JAX package's knobs unset (its defaults are the port's), one
    torch thread, and the slice target pinned in both packages (the
    width ladder follows wall time otherwise)."""
    reference_defaults(monkeypatch)
    monkeypatch.setattr(jlin, "_SLICE_TARGET_S", 1e9)
    monkeypatch.setattr(tlin, "_SLICE_TARGET_S", 1e9)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stream(pkg, h, model, **kw):
    """Stream op by op: (final result, first invalid event, checker)."""
    sc = pkg["stream"](model, **pkg["kw"], **kw)
    invalid_at = None
    for i, op in enumerate(h):
        sc.ingest(op)
        if invalid_at is None and sc.verdict()["status"] == "invalid":
            invalid_at = i
    return sc.finalize(), invalid_at, sc


def _both(make, **kw):
    """``make(pkg) -> (history, model)`` in both packages; the histories
    must be the same events; returns ((result, invalid_at) of the JAX
    package, of the port, the port's checker)."""
    hj, mj = make(JAX)
    hp, mp = make(PORT)
    assert [op.to_dict() for op in hj] == [op.to_dict() for op in hp]
    rj, aj, _ = _stream(JAX, hj, mj, **kw)
    rp, ap, sc = _stream(PORT, hp, mp, **kw)
    return (rj, aj), (rp, ap), sc


# ---------------------------------------------------------------------------
# the fuzz stride
# ---------------------------------------------------------------------------

#: (class, first seed, count) of the JAX package's 215-case corpus
CLASSES = (("cas", 0, 70), ("burst", 2000, 45), ("tail", 5000, 30),
           ("mutex", 3000, 35), ("multireg", 4000, 35))
CORPUS = [(label, seed0 + i, i) for label, seed0, n in CLASSES
          for i in range(n)]
STRIDE = CORPUS[::5]


def fuzz_case(pkg, label, seed, i):
    synth, models, hist = pkg["synth"], pkg["models"], pkg["hist"]
    rng = random.Random(seed)
    if label == "cas":
        m = models.cas_register()
        h = synth.sim_register_history(rng, n_procs=4, n_ops=24,
                                       crash_p=0.1, cas=(i % 2 == 0))
        if i % 3 == 0:
            h = synth.flip_read(rng, h)
    elif label == "burst":
        m = models.cas_register()
        h = synth.register_history(rng, n_ops=36, n_procs=4, overlap=3,
                                   quiesce_every=6, crash_p=0.03,
                                   max_crashes=2, n_values=4, cas=False)
        if i % 2 == 0:
            h = synth.flip_read(rng, h)
    elif label == "tail":
        m = models.cas_register()
        h = synth.sim_register_history(rng, n_procs=6, n_ops=20,
                                       crash_p=0.05)
        if i % 3 == 0:
            h = synth.flip_read(rng, h)
    elif label == "mutex":
        m = models.mutex()
        h = synth.sim_mutex_history(rng, n_ops=24, n_procs=4,
                                    crash_p=0.06)
    else:
        m = models.multi_register(3)
        h = sim_multireg_history(hist, rng)
        if i % 3 == 0:
            h = _flip_mr_read(rng, h)
    return h, m


def test_stride_covers_every_class():
    assert len(CORPUS) == 215 and len(STRIDE) == 43
    assert {c[0] for c in STRIDE} == {c[0] for c in CLASSES}


@pytest.mark.parametrize("label,seed,i", STRIDE,
                         ids=[f"{c[0]}-{c[1]}" for c in STRIDE])
def test_fuzz_stride_matches_reference(label, seed, i):
    """Whole results, the first invalid event and the streamed history
    equal; and the result audits clean in the port."""
    from jepsen_tpu_torch.analyze.audit import audit

    j, p, sc = _both(lambda pkg: fuzz_case(pkg, label, seed, i))
    assert p == j
    _h, m = fuzz_case(PORT, label, seed, i)
    assert audit(sc.seq(), m, p[0])["ok"]


def test_stride_exercises_the_stream():
    """The stride reaches the cuts, the final sub-search, the key
    partition and a mid-stream invalid verdict."""
    methods, early = set(), 0
    for label, seed, i in STRIDE:
        h, m = fuzz_case(PORT, label, seed, i)
        r, at, _ = _stream(PORT, h, m)
        methods.update(r["stream"]["methods"])
        early += at is not None and at < len(h) - 1
    assert {"quiescence", "sub-search", "key-partition"} <= methods
    assert early >= 2


# ---------------------------------------------------------------------------
# single cases of the JAX package's tests
# ---------------------------------------------------------------------------


def test_early_invalid_event_matches_reference():
    def make(pkg):
        rng = random.Random(42)
        h = pkg["synth"].register_history(rng, n_ops=300, n_procs=5,
                                          overlap=4, quiesce_every=8,
                                          n_values=5, cas=False)
        return pkg["synth"].corrupt_read(rng, h, at=0.1), \
            pkg["models"].register(0)

    j, p, _ = _both(make)
    assert p == j
    r, at = p
    h, _m = make(PORT)
    assert r["valid"] is False and at < len(h) // 2
    assert r["stream"]["invalid_event"] == at


def test_never_quiescing_tail_matches_reference():
    def make(pkg):
        rng = random.Random(7)
        return pkg["synth"].register_history(
            rng, n_ops=24, n_procs=6, overlap=4, n_values=4), \
            pkg["models"].cas_register()

    h, m = make(PORT)
    sc = TStream(m, device="cpu")
    for op in h:
        sc.ingest(op)
        assert sc.verdict()["status"] == "open"
    j, p, _ = _both(make)
    assert p == j and p[0]["stream"]["segments"] == 1


def sim_indep_history(pkg, rng, n_keys=3, n_procs=4, n_ops=40,
                      crash_p=0.05):
    """The JAX package test's independent cas registers, KV-wrapped."""
    hist, tup = pkg["hist"], pkg["ind"].tuple_
    state = {k: 0 for k in range(n_keys)}
    h, pending, crashed = [], {}, set()
    done = 0
    while done < n_ops or pending:
        live = [p for p in range(n_procs) if p not in crashed]
        if not live:
            break
        p = rng.choice(live)
        if p in pending:
            f, k, v = pending.pop(p)
            if crash_p and rng.random() < crash_p:
                if rng.random() < 0.5:
                    if f == "write":
                        state[k] = v
                    elif f == "cas" and state[k] == v[0]:
                        state[k] = v[1]
                crashed.add(p)
                h.append(hist.info_op(p, f, tup(
                    k, v if f != "read" else None)))
                continue
            if f == "read":
                h.append(hist.ok_op(p, f, tup(k, state[k])))
            elif f == "write":
                state[k] = v
                h.append(hist.ok_op(p, f, tup(k, v)))
            elif state[k] == v[0]:
                state[k] = v[1]
                h.append(hist.ok_op(p, f, tup(k, v)))
            else:
                h.append(hist.fail_op(p, f, tup(k, v)))
        elif done < n_ops:
            f = rng.choice(["read", "write", "cas"])
            k = rng.randrange(n_keys)
            v = (None if f == "read" else rng.randrange(5)
                 if f == "write" else (rng.randrange(5),
                                       rng.randrange(5)))
            h.append(hist.invoke_op(p, f, tup(k, v)))
            pending[p] = (f, k, v)
            done += 1
    return h


def _flip_kv_read(pkg, rng, h):
    idx = [i for i, op in enumerate(h)
           if op.type == "ok" and op.f == "read"]
    if not idx:
        return h
    h = list(h)
    i = rng.choice(idx)
    kv = h[i].value
    h[i] = dataclasses.replace(h[i], value=pkg["ind"].tuple_(
        kv.key, (kv.value or 0) + 7))
    return h


def test_independent_streams_match_reference_and_checker():
    """Per-key cells of ``[k v]`` streams: whole results and per-key
    results equal the JAX package's, and every key's verdict is the
    port's ``independent.checker``'s after the fact."""
    from jepsen_tpu_torch.checker.seq import check_opseq

    for i in range(0, 40, 4):
        def make(pkg, i=i):
            rng = random.Random(9000 + i)
            h = sim_indep_history(pkg, rng)
            if i % 3 == 0:
                h = _flip_kv_read(pkg, rng, h)
            return h, pkg["models"].cas_register(0)

        hj, mj = make(JAX)
        hp, mp = make(PORT)
        rj, aj, scj = _stream(JAX, hj, mj)
        rp, ap, scp = _stream(PORT, hp, mp)
        assert (rp, ap) == (rj, aj), i
        assert scp.cell_results == scj.cell_results, i
        assert "independent" in rp["stream"]["methods"]

        class HostWGL(tind.Checker):
            def check(self, test, history, opts=None):
                return check_opseq(th.encode_ops(history, mp.f_codes), mp)

        post = tind.checker(HostWGL()).check({}, hp)
        assert rp["valid"] == post["valid"], i
        for k, res in post["results"].items():
            assert scp.cell_results[k]["valid"] == res["valid"], (i, k)


def test_cache_file_serves_both_packages(tmp_path):
    """A cache file the JAX package wrote serves the port (every fold a
    hit, no search), and one the port wrote serves the JAX package; the
    results are equal run for run."""
    def make(pkg):
        rng = random.Random(77)
        return pkg["synth"].register_history(
            rng, n_ops=44, n_procs=3, overlap=1, crash_p=0.0,
            n_values=3), pkg["models"].cas_register()

    hj, mj = make(JAX)
    hp, mp = make(PORT)
    renamed = [dataclasses.replace(op, process=op.process + 10)
               for op in hp]
    for first, second, name in ((JAX, PORT, "j"), (PORT, JAX, "p")):
        path = str(tmp_path / f"{name}.jsonl")
        cache = (JCache if first is JAX else TCache)(path)
        h1, m1 = (hj, mj) if first is JAX else (hp, mp)
        r1, _a, _ = _stream(first, h1, m1, cache=cache)
        assert r1["stream"]["cache_inserts"] > 0
        cache2 = (JCache if second is JAX else TCache)(path)
        h2 = renamed if second is PORT else [
            dataclasses.replace(op, process=op.process + 10) for op in hj]
        m2 = mp if second is PORT else mj
        r2, _a, _ = _stream(second, h2, m2, cache=cache2)
        assert r2["valid"] == r1["valid"] and r2["configs"] == 0
        assert r2["stream"]["cache_hits"] \
            >= r1["stream"]["cache_inserts"] - 2
    # the same run on a fresh file in each package: equal results
    rj, _a, _ = _stream(JAX, hj, mj, cache=JCache(str(tmp_path / "a")))
    rp, _a, _ = _stream(PORT, hp, mp, cache=TCache(str(tmp_path / "b")))
    assert rp == rj


# ---------------------------------------------------------------------------
# the device route on the torch step
# ---------------------------------------------------------------------------


def test_forced_device_routing_matches_reference():
    """``host_fold_max=0`` sends every eligible fold through the port's
    ``search_batch`` (the torch step on the CPU), at the JAX package
    test's shapes; the whole results equal the JAX package's with the
    same gate."""
    def make(pkg):
        rng = random.Random(6)
        return pkg["synth"].register_history(
            rng, n_ops=40, n_procs=5, overlap=4, quiesce_every=8,
            n_values=6, cas=False), pkg["models"].register(0)

    j, p, _ = _both(make, host_fold_max=0)
    assert p == j
    r = p[0]
    assert r["stream"]["routes"]["device"] >= 1
    assert "device" in r["stream"]["methods"]
    assert "linearization" in r or "witness_dropped" in r


def test_device_fold_states_matches_segment_states():
    """Segment by segment at the JAX package test's shapes: the port's
    device fold gives the host fold's state set (the port's and the JAX
    package's)."""
    m = tm.register(0)
    h = ts.register_history(random.Random(5), n_ops=48, n_procs=6,
                            overlap=5, quiesce_every=8, unique_writes=True,
                            cas=False)
    seq = th.encode_ops(h, m.f_codes)
    jseq = jh.encode_ops(js.register_history(
        random.Random(5), n_ops=48, n_procs=6, overlap=5, quiesce_every=8,
        unique_writes=True, cas=False), jm.register(0).f_codes)
    segs = tpart.quiescence_segments(seq)
    assert [list(s) for s in segs] == \
        [list(s) for s in jpart.quiescence_segments(jseq)]
    states = {tuple(m.init)}
    checked = 0
    for rows in segs[:-1]:
        ss = tpart.subseq(seq, rows)
        host = teng.segment_states(ss, m, states)
        assert host == jeng.segment_states(jpart.subseq(jseq, rows),
                                           jm.register(0), states)
        dev = tdev.device_fold_states(ss, m, states, device="cpu")
        if dev is not None:
            assert dev[0] == host
            checked += 1
        states = host
    assert checked >= 2


def test_async_folds_match_inline_and_reference():
    for i in range(6):
        def make(pkg, i=i):
            rng = random.Random(800 + i)
            h = pkg["synth"].register_history(
                rng, n_ops=36, n_procs=4, overlap=2, quiesce_every=6,
                crash_p=0.05, max_crashes=2, n_values=4)
            if i % 2 == 0:
                h = pkg["synth"].flip_read(rng, h)
            return h, pkg["models"].cas_register()

        h, m = make(PORT)
        sc = TStream(m, device="cpu", async_folds=True)
        for op in h:
            sc.ingest(op)
        r_async = sc.finalize()
        (rj, _aj), (rp, _ap), _ = _both(make)
        assert rp == rj, i
        # the async run's live timeline depends on the worker's pace;
        # its final result does not
        st_a, st_i = dict(r_async["stream"]), dict(rp["stream"])
        for k in ("first_verdict_event", "invalid_event"):
            st_a.pop(k), st_i.pop(k)
        assert {**r_async, "stream": st_a} == {**rp, "stream": st_i}, i


# ---------------------------------------------------------------------------
# the `:info` lookahead
# ---------------------------------------------------------------------------


def _kill_shaped_history(hist, corrupt: bool, n_tail: int = 60):
    """An acked write, a crashed write, then a long read tail;
    ``corrupt`` makes one read return what no fork can explain."""
    h = [hist.invoke_op(0, "write", 3), hist.ok_op(0, "write", 3),
         hist.invoke_op(1, "write", 4), hist.info_op(1, "write", 4)]
    for i in range(n_tail):
        p = 2 + (i % 3)
        v = 2 if (corrupt and i == 12) else 3
        h += [hist.invoke_op(p, "read", None), hist.ok_op(p, "read", v)]
    return h


def _crashed_writer_history(hist, n_infos, n_reads):
    h = [hist.invoke_op(0, "write", 3), hist.ok_op(0, "write", 3)]
    for j in range(n_infos):
        p = 10 + j
        h += [hist.invoke_op(p, "write", 4), hist.info_op(p, "write", 4)]
    for i in range(n_reads):
        p = 2 + (i % 3)
        h += [hist.invoke_op(p, "read", None),
              hist.ok_op(p, "read", 2 if i == 5 else 3)]
    return h


@pytest.mark.parametrize("corrupt,horizon", [(True, 8), (True, 0),
                                             (False, 8)])
def test_info_lookahead_flip_matches_reference(corrupt, horizon):
    def make(pkg):
        h = _kill_shaped_history(pkg["hist"], corrupt)
        if not corrupt:
            h += [pkg["hist"].invoke_op(1, "read", None),
                  pkg["hist"].ok_op(1, "read", 4)]
        return h, pkg["models"].register(0)

    j, p, _ = _both(make, info_lookahead=horizon)
    assert p == j
    r, at = p
    h, _m = make(PORT)
    assert r["valid"] is (not corrupt)
    if corrupt and horizon:
        assert at is not None and at < len(h) - 20
        assert r["stream"]["lookahead_checks"] >= 1
    else:
        assert at is None


@pytest.mark.parametrize("n_infos", [20, jplan.STREAM_INFO_FORK_MAX + 1])
def test_info_fork_budget_matches_reference(n_infos):
    """Past the fork budget the check is skipped (20 crashed writers);
    under it a narrow segment forks more infos than the flat cap."""
    j, p, _ = _both(lambda pkg: (_crashed_writer_history(
        pkg["hist"], n_infos, 40), pkg["models"].register(0)),
        info_lookahead=8)
    assert p == j
    assert p[0]["valid"] is False
    assert (p[0]["stream"]["lookahead_checks"] == 0) is (n_infos == 20)


def test_fork_gates_match_reference():
    for name in ("STREAM_INFO_LOOKAHEAD", "STREAM_INFO_FORK_MAX",
                 "STREAM_INFO_FORK_BUDGET", "STREAM_INFO_FORK_HARD_MAX",
                 "STREAM_HOST_FOLD_MAX", "STREAM_DEVICE_FAMILIES"):
        assert getattr(tplan, name) == getattr(jplan, name), name
    for n in range(0, 36):
        for rows in (0, 8, 63, 64, 200, 384):
            assert tplan.info_fork_budget(n, rows) \
                == jplan.info_fork_budget(n, rows)
            assert tplan.info_fork_cost(n, rows) \
                == jplan.info_fork_cost(n, rows)
        assert tplan.info_fork_gate(n) == jplan.info_fork_gate(n)
    for rows, window in ((8, 4), (10**6, 30), (190, 16), (190, 17)):
        assert tplan.segment_fold_cost(rows, window) \
            == jplan.segment_fold_cost(rows, window)
        for tmod, jmod in ((tm.register(0), jm.register(0)),
                           (tm.mutex(), jm.mutex())):
            for cap in (None, 0):
                assert tplan.segment_fold_route(
                    rows, window, tmod, host_fold_max=cap) \
                    == jplan.segment_fold_route(rows, window, jmod,
                                                host_fold_max=cap)


def test_stream_plan_matches_reference():
    """``stream_plan`` on the stride, the kill-shaped history and a
    full-width burst stream, with and without the lookahead."""
    cases = [fuzz_case(pkg, *c) for c in STRIDE[::3]
             for pkg in (JAX, PORT)]
    cases += [(_kill_shaped_history(pkg["hist"], False),
               pkg["models"].register(0)) for pkg in (JAX, PORT)]
    cases += [(pkg["synth"].register_history(
        random.Random("bench-stream-0"), n_ops=600, n_procs=24, overlap=20,
        quiesce_every=256, n_values=5, cas=True),
        pkg["models"].cas_register()) for pkg in (JAX, PORT)]
    for (hj, mj), (hp, mp) in zip(cases[::2], cases[1::2]):
        for kw in ({}, {"info_lookahead": 8, "host_fold_max": 0}):
            assert tplan.stream_plan(th.encode_ops(hp, mp.f_codes), mp,
                                     **kw) \
                == jplan.stream_plan(jh.encode_ops(hj, mj.f_codes), mj,
                                     **kw)


# ---------------------------------------------------------------------------
# the multiset folds
# ---------------------------------------------------------------------------


def queue_events(hist, rng, *, n=40, n_procs=4, fault=None):
    """A total-queue history of enqueues, dequeues and a final drain,
    by simulated clients against one FIFO; ``fault`` is ``"lost"`` (an
    acked enqueue vanishes), ``"unexpected"`` (a dequeue of a value
    never enqueued) or ``"crashed-drain"``."""
    q, h, pending, v = [], [], {}, 0
    for _ in range(n):
        p = rng.randrange(n_procs)
        if p in pending:
            f, val = pending.pop(p)
            if f == "enqueue":
                q.append(val)
                h.append(hist.ok_op(p, f, val))
            elif q:
                h.append(hist.ok_op(p, f, q.pop(0)))
            else:
                h.append(hist.fail_op(p, f, None))
        elif rng.random() < 0.6:
            v += 1
            pending[p] = ("enqueue", v)
            h.append(hist.invoke_op(p, "enqueue", v))
        else:
            pending[p] = ("dequeue", None)
            h.append(hist.invoke_op(p, "dequeue", None))
    for p, (f, val) in sorted(pending.items()):
        if f == "enqueue":
            q.append(val)
            h.append(hist.ok_op(p, f, val))
        else:
            h.append(hist.fail_op(p, f, None))
    if fault == "lost" and q:
        q.pop(0)
    if fault == "unexpected":
        h += [hist.invoke_op(0, "dequeue", None),
              hist.ok_op(0, "dequeue", 999)]
    h.append(hist.invoke_op(0, "drain", None))
    if fault == "crashed-drain":
        h.append(hist.info_op(0, "drain", None))
    else:
        h.append(hist.ok_op(0, "drain", list(q)))
    return h


def set_events(hist, rng, *, n=30, fault=None):
    h, added = [], []
    for i in range(n):
        p = i % 3
        h.append(hist.invoke_op(p, "add", i))
        if rng.random() < 0.1:
            h.append(hist.info_op(p, "add", i))
            if rng.random() < 0.5:
                added.append(i)
        else:
            h.append(hist.ok_op(p, "add", i))
            added.append(i)
    seen = set(added)
    if fault == "lost" and added:
        seen.discard(added[0])
    if fault == "unexpected":
        seen.add(1000)
    h += [hist.invoke_op(3, "read", None), hist.ok_op(3, "read", seen)]
    return h


MULTISET = [(family, fault, seed)
            for family, faults in (
                ("total-queue", (None, "lost", "unexpected",
                                 "crashed-drain")),
                ("set", (None, "lost", "unexpected")))
            for fault in faults for seed in (1, 2)]


@pytest.mark.parametrize("family,fault,seed", MULTISET)
def test_total_fold_stream_matches_reference(family, fault, seed):
    """``TotalFoldStream`` (the post-hoc checker's verdict, the stream
    dict, the evidence, the audit) and ``MultisetFold``'s flip event by
    event, on queue and set histories."""
    outs = []
    for pkg, cons in ((JAX, jcons), (PORT, tcons)):
        rng = random.Random(seed)
        make = set_events if family == "set" else queue_events
        h = make(pkg["hist"], rng, fault=fault)
        fold = cons.MultisetFold(family)
        flips = [fold.step(op, i) for i, op in enumerate(h)]
        sink = pkg["total"](family)
        statuses = []
        for op in h:
            sink.ingest(op)
            statuses.append(sink.verdict())
        r = sink.finalize(audit=True)
        events = (cons.analyze_set_events(h) if family == "set"
                  else cons.analyze_queue_events(h))
        outs.append((flips, statuses, r, events))
    assert outs[1] == outs[0]
    r = outs[1][2]
    assert r["valid"] is (True if fault is None else
                          "unknown" if fault == "crashed-drain" else False)


# ---------------------------------------------------------------------------
# failures: a device-route error propagates, a host-fold error falls back
# ---------------------------------------------------------------------------


def _device_stream():
    rng = random.Random(6)
    h = ts.register_history(rng, n_ops=40, n_procs=5, overlap=4,
                            quiesce_every=8, n_values=6, cas=False)
    return h, tm.register(0)


class _Boom(RuntimeError):
    pass


def _raising_search_batch(*a, **kw):
    raise _Boom("injected search_batch failure")


def test_device_route_error_raises_out_of_ingest(monkeypatch):
    monkeypatch.setattr(tlin, "search_batch", _raising_search_batch)
    h, m = _device_stream()
    sc = TStream(m, device="cpu", host_fold_max=0)
    with pytest.raises(tdev.DeviceFoldError) as ei:
        for op in h:
            sc.ingest(op)
    assert isinstance(ei.value.__cause__, _Boom)
    assert sc.verdict()["routes"]["host"] == 0
    # finalize does not turn it into a verdict either
    with pytest.raises(tdev.DeviceFoldError):
        sc.finalize()


def test_device_route_error_raises_out_of_async_finalize(monkeypatch):
    monkeypatch.setattr(tlin, "search_batch", _raising_search_batch)
    h, m = _device_stream()
    sc = TStream(m, device="cpu", host_fold_max=0, async_folds=True)
    for op in h:
        sc.ingest(op)
    with pytest.raises(tdev.DeviceFoldError) as ei:
        sc.finalize()
    assert isinstance(ei.value.__cause__, _Boom)
    v = sc.verdict()
    assert v["routes"]["host"] == 0 and v["fallback"] is False


def test_host_fold_error_falls_back_as_reference(monkeypatch):
    """An exception in a host fold on the fold worker marks the run
    ``fallback``; finalize decides the whole history directly, in both
    packages alike."""
    def boom(*a, **kw):
        raise _Boom("injected host fold failure")

    monkeypatch.setattr(teng, "segment_states", boom)
    monkeypatch.setattr(jeng, "segment_states", boom)
    out = []
    for pkg in (JAX, PORT):
        rng = random.Random(800)
        h = pkg["synth"].register_history(
            rng, n_ops=36, n_procs=4, overlap=2, quiesce_every=6,
            n_values=4, cas=False)
        m = pkg["models"].cas_register()
        sc = pkg["stream"](m, **pkg["kw"], async_folds=True, hb=False)
        for op in h:
            sc.ingest(op)
        out.append(sc.finalize())
    assert out[1] == out[0]
    assert out[1]["stream"]["fallback"] is True
    assert "direct" in out[1]["stream"]["methods"]
