"""The port's static prepass against the JAX package's: the happens-
before solver (``analyze/hb.py``) and the constraint compiler
(``analyze/constraints.py``) behind ``maybe_hb``.  For each family
(register, cas-register, multi-register, mutex, fifo and unordered
queue), valid and corrupted, the whole ``HBAnalysis`` must be equal:
``decided`` (verdict and certificate), ``must_pred`` and the stats, with
the dpor layer's duplicate-op edges merged in or not.  The cases mirror
tests/test_hb.py and tests/test_constraints.py; histories are built
with the JAX package's generators and copied event for event."""

import dataclasses
import random

import pytest

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.analyze import constraints as jcon
from jepsen_tpu.analyze import hb as jhb
from jepsen_tpu.decompose import partition as jpart
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.analyze import constraints as tcon
from jepsen_tpu_torch.analyze import hb as thb
from jepsen_tpu_torch.decompose import partition as tpart
from test_torch_search import reference_defaults

_FIELDS = ("process", "type", "f", "value", "time", "index", "error")


def to_port(history):
    """The JAX package's events as the port's."""
    return [th.Op(**{k: getattr(op, k) for k in _FIELDS})
            for op in history]


def encoded(history, factory, *args):
    """(jax seq, jax model, port seq, port model) of one event history
    and one model factory name."""
    mj = getattr(jm, factory)(*args)
    mt = getattr(tm, factory)(*args)
    return (jh.encode_ops(history, mj.f_codes), mj,
            th.encode_ops(to_port(history), mt.f_codes), mt)


def _analysis(a):
    if a is None:
        return None
    return (a.n, a.applies, a.decided, a.must_pred, a.stats)


def assert_prepass_equal(sj, mj, st, mt):
    """Every prepass entry agrees; returns the port's maybe_hb."""
    assert _analysis(tcon.analyze_prepass(st, mt)) == \
        _analysis(jcon.analyze_prepass(sj, mj))
    for dpor in (None, False):
        got = thb.maybe_hb(st, mt, None, dpor)
        assert _analysis(got) == _analysis(jhb.maybe_hb(sj, mj, None, dpor))
    assert thb.maybe_hb(st, mt, False) is None
    out = thb.maybe_hb(st, mt)
    assert thb.attach({}, out) == jhb.attach({}, jhb.maybe_hb(sj, mj))
    return out


def ops(mod, *specs):
    mk = {"invoke": mod.invoke_op, "ok": mod.ok_op, "info": mod.info_op}
    return [mk[t](p, f, v) for t, p, f, v in specs]


# ---------------------------------------------------------------------------
# register family (tests/test_hb.py)
# ---------------------------------------------------------------------------


def _unique_writes(seed, *, swap=False, n_ops=80):
    rng = random.Random(seed)
    h = js.register_history(rng, n_ops=n_ops, n_procs=4, overlap=6,
                            crash_p=0.0, cas=False, unique_writes=True)
    return js.swap_read_values(rng, h) if swap else h


REGISTER_CASES = {
    "gk-valid": (lambda: _unique_writes(1), "register", 0),
    "hb-cycle": (lambda: _unique_writes(2, swap=True), "register", 0),
    "hb-cycle-5": (lambda: _unique_writes(5, swap=True, n_ops=60),
                   "register", 0),
    "impossible-read": (lambda: ops(jh, ("invoke", 0, "write", 5),
                                    ("ok", 0, "write", 5),
                                    ("invoke", 1, "read", 9),
                                    ("ok", 1, "read", 9)), "register", 0),
    "crash-cycle": (lambda: ops(jh, ("invoke", 1, "read", 7),
                                ("ok", 1, "read", 7),
                                ("invoke", 0, "write", 7),
                                ("info", 0, "write", 7)), "register", 0),
    "init-read-inverted": (lambda: ops(jh, ("invoke", 0, "write", 3),
                                       ("ok", 0, "write", 3),
                                       ("invoke", 1, "read", 0),
                                       ("ok", 1, "read", 0)),
                           "register", 0),
    "cas-canon-only": (lambda: ops(jh, ("invoke", 0, "write", 1),
                                   ("ok", 0, "write", 1),
                                   ("invoke", 0, "cas", (1, 2)),
                                   ("ok", 0, "cas", (1, 2))),
                       "cas_register", None),
    "crashes-undecided": (lambda: js.register_history(
        random.Random(3), n_ops=60, n_procs=5, overlap=5, crash_p=0.15,
        cas=False, unique_writes=True), "register", 0),
    "duplicate-writes": (lambda: js.register_history(
        random.Random(8), n_ops=50, n_procs=4, overlap=4, crash_p=0.05,
        cas=False, n_values=2), "register", 0),
}


@pytest.mark.parametrize("case", list(REGISTER_CASES))
def test_register_prepass_matches_reference(case):
    build, factory, init = REGISTER_CASES[case]
    args = () if init is None else (init,)
    sj, mj, st, mt = encoded(build(), factory, *args)
    out = assert_prepass_equal(sj, mj, st, mt)
    assert _analysis(thb.analyze_hb(st, mt)) == \
        _analysis(jhb.analyze_hb(sj, mj))
    assert _analysis(thb.analyze_hb(st, mt, canon=False)) == \
        _analysis(jhb.analyze_hb(sj, mj, canon=False))
    want = {"gk-valid": True, "hb-cycle": False, "hb-cycle-5": False,
            "impossible-read": False, "crash-cycle": False,
            "init-read-inverted": False}.get(case)
    assert (out.decided or {}).get("valid") == want


def _multi(seed, *, corrupt=False):
    """A multi-register history over 3 keys (tests/test_hb.py's fuzz
    generator), with unique writes per key."""
    rng = random.Random(seed)
    h = []
    state = {k: 0 for k in range(3)}
    nxt = 1
    open_ops = {}
    for _ in range(30):
        p = rng.randrange(3)
        if p in open_ops:
            op = open_ops.pop(p)
            h.append((jh.info_op if rng.random() < 0.08 else
                      jh.ok_op)(p, op.f, op.value))
        else:
            k = rng.randrange(3)
            if rng.random() < 0.5:
                op = jh.invoke_op(p, "write", (k, nxt))
                state[k] = nxt
                nxt += 1
            else:
                op = jh.invoke_op(p, "read", (k, state[k]))
            h.append(op)
            open_ops[p] = op
    for p, op in open_ops.items():
        h.append(jh.ok_op(p, op.f, op.value))
    if corrupt:
        # one ok read sees a value its key never held
        i = rng.choice([i for i, op in enumerate(h)
                        if op.type == "ok" and op.f == "read"])
        k, v = h[i].value
        h[i] = dataclasses.replace(h[i], value=(k, v + 100))
    return h


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("corrupt", [False, True])
def test_multi_register_prepass_matches_reference(seed, corrupt):
    sj, mj, st, mt = encoded(_multi(seed, corrupt=corrupt),
                             "multi_register", 3)
    assert_prepass_equal(sj, mj, st, mt)


def test_multi_register_decides_per_key_and_stitches():
    h = []
    v = 1
    for p in range(3):
        for _ in range(5):
            h.append(jh.invoke_op(p, "write", (p, v)))
            h.append(jh.ok_op(p, "write", (p, v)))
            v += 1
    sj, mj, st, mt = encoded(h, "multi_register", 3)
    out = assert_prepass_equal(sj, mj, st, mt)
    assert out.decided["valid"] is True
    assert len(out.decided["linearization"]) == len(st)
    # the stitch itself
    lins = [[i for i in range(len(st)) if int(st.v1[i]) == k]
            for k in range(3)]
    assert tpart.merge_linearizations(st, lins) == \
        jpart.merge_linearizations(sj, lins)


def test_merge_linearizations_refuses_dependent_cells():
    """Two cells whose orders contradict real time cannot merge."""
    h = ops(jh, ("invoke", 0, "write", (0, 1)), ("ok", 0, "write", (0, 1)),
            ("invoke", 1, "write", (1, 2)), ("ok", 1, "write", (1, 2)))
    sj, _, st, _ = encoded(h, "multi_register", 2)
    assert tpart.merge_linearizations(st, [[1, 0]]) is None
    assert jpart.merge_linearizations(sj, [[1, 0]]) is None


def _fuzz(n):
    """Register-family histories in and out of the decidable class:
    crashes, cas, duplicate values, mutations (tests/test_hb.py)."""
    out = []
    for i in range(n):
        rng = random.Random(100_000 + i)
        kind = rng.randrange(3)
        h = js.register_history(
            rng, n_ops=rng.randrange(8, 40), n_procs=rng.randrange(2, 6),
            overlap=rng.randrange(1, 6),
            crash_p=rng.choice([0.0, 0.0, 0.1, 0.3]),
            cas=(kind == 1 and rng.random() < 0.5), max_crashes=8,
            unique_writes=rng.random() < 0.5,
            n_values=rng.choice([2, 3, 8]))
        if rng.random() < 0.5:
            h = js.mutate(rng, h)
        out.append((h, "register" if kind == 0 else "cas_register"))
    return out


@pytest.mark.parametrize("chunk", range(4))
def test_register_fuzz_matches_reference(chunk):
    decided = 0
    for h, factory in _fuzz(160)[chunk::4]:
        args = (0,) if factory == "register" else ()
        sj, mj, st, mt = encoded(h, factory, *args)
        out = assert_prepass_equal(sj, mj, st, mt)
        decided += out is not None and out.decided is not None
    assert decided > 0


# ---------------------------------------------------------------------------
# queue and lock families (tests/test_constraints.py)
# ---------------------------------------------------------------------------


def _queue(i, *, fifo):
    rng = random.Random(9000 + i)
    h = js.sim_queue_history(rng, 26, 4, crash_p=rng.choice([0.0, 0.0, 0.2]),
                             fifo=fifo)
    if rng.random() < 0.5:
        h = (js.swap_dequeues if rng.random() < 0.5
             else js.corrupt_dequeue)(rng, h)
    return h


@pytest.mark.parametrize("fifo", [False, True])
@pytest.mark.parametrize("chunk", range(3))
def test_queue_fuzz_matches_reference(fifo, chunk):
    reasons = set()
    for i in range(chunk, 60, 3):
        factory = "fifo_queue" if fifo else "unordered_queue"
        sj, mj, st, mt = encoded(_queue(i, fifo=fifo), factory, 33)
        out = assert_prepass_equal(sj, mj, st, mt)
        reasons.add(out.stats["reason"])
    assert len(reasons) >= 2


QUEUE_CASES = {
    "duplicate-delivery": ("unordered_queue", [
        ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
        ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 1),
        ("invoke", 2, "dequeue", None), ("ok", 2, "dequeue", 1)]),
    "fifo-inversion": ("fifo_queue", [
        ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
        ("invoke", 0, "enqueue", 2), ("ok", 0, "enqueue", 2),
        ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 2),
        ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 1)]),
    "impossible-dequeue": ("unordered_queue", [
        ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
        ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 5)]),
    "rf-cycle": ("unordered_queue", [
        ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 3),
        ("invoke", 0, "enqueue", 3), ("ok", 0, "enqueue", 3)]),
    "completion-schedule": ("unordered_queue", [
        ("invoke", 0, "enqueue", 1), ("invoke", 1, "enqueue", 2),
        ("ok", 1, "enqueue", 2), ("invoke", 2, "dequeue", None),
        ("ok", 0, "enqueue", 1), ("ok", 2, "dequeue", 1)]),
    "fifo-undecided": ("fifo_queue", [
        ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
        ("invoke", 0, "enqueue", 2), ("invoke", 1, "dequeue", None),
        ("ok", 0, "enqueue", 2), ("ok", 1, "dequeue", 1),
        ("invoke", 2, "enqueue", 3), ("info", 2, "enqueue", 3),
        ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 2)]),
    "lock-overhold": ("mutex", [
        ("invoke", 0, "acquire", None), ("ok", 0, "acquire", None),
        ("invoke", 1, "acquire", None), ("ok", 1, "acquire", None)]),
    "release-unheld": ("mutex", [
        ("invoke", 0, "release", None), ("ok", 0, "release", None)]),
    "lock-undecided": ("mutex", [
        ("invoke", 0, "acquire", None), ("invoke", 1, "acquire", None),
        ("ok", 0, "acquire", None), ("invoke", 0, "release", None),
        ("ok", 0, "release", None), ("info", 1, "acquire", None)]),
}


@pytest.mark.parametrize("case", list(QUEUE_CASES))
def test_constraint_cases_match_reference(case):
    factory, specs = QUEUE_CASES[case]
    args = () if factory == "mutex" else (8,)
    sj, mj, st, mt = encoded(ops(jh, *specs), factory, *args)
    out = assert_prepass_equal(sj, mj, st, mt)
    assert _analysis(tcon.analyze_constraints(st, mt)) == \
        _analysis(jcon.analyze_constraints(sj, mj))
    if case.endswith("undecided"):
        assert out.decided is None
    else:
        assert out.stats["reason"] == case
        assert out.decided["valid"] is (case == "completion-schedule")


@pytest.mark.parametrize("seed", range(8))
def test_mutex_fuzz_matches_reference(seed):
    rng = random.Random(5000 + seed)
    h = js.sim_mutex_history(rng, 22, 4,
                             crash_p=rng.choice([0.0, 0.0, 0.2]))
    if rng.random() < 0.5:
        h = js.mutate(rng, h)
    assert_prepass_equal(*encoded(h, "mutex"))


def test_out_of_scope_and_family_dispatch():
    for name in ("unordered-queue-4", "fifo-queue-16", "mutex",
                 "register", "multi-register", "noop", ""):
        model = type("M", (), {"name": name})
        assert tcon.family_of(model) == jcon.family_of(model)
    # a queue model started non-empty is out of the compiler's scope
    h = ops(jh, ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1))
    sj, mj, st, mt = encoded(h, "unordered_queue", 4)
    mj1 = dataclasses.replace(mj, init=(1,) + mj.init[1:])
    mt1 = dataclasses.replace(mt, init=(1,) + mt.init[1:])
    assert_prepass_equal(sj, mj1, st, mt1)
    # a model no solver takes
    assert_prepass_equal(*encoded(ops(jh, ("invoke", 0, "write", 1),
                                      ("ok", 0, "write", 1)), "noop"))


def test_prepass_is_thread_safe():
    """The three legs of the race run the prepass at once: per-thread
    rank state keeps concurrent analyses apart."""
    import threading

    cases = [encoded(_unique_writes(s, swap=s % 2 == 0), "register", 0)
             for s in range(1, 7)]
    want = [_analysis(jhb.analyze_hb(sj, mj)) for sj, mj, _, _ in cases]
    got = [None] * len(cases)

    def run(i):
        for _ in range(20):
            _, _, st, mt = cases[i]
            got[i] = _analysis(thb.analyze_hb(st, mt))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == want


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    reference_defaults(monkeypatch)
