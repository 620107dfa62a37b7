"""The port's host engines against the JAX package's: the ``linear``
sweep (``check_opseq_linear``) on the search cases and on crash-heavy
register histories past the device encoding (``MAX_CRASH``), with and
without a witness, and the deadline and cancel exits of both host
engines.  Both sides run with their lint, happens-before, DPOR and audit
passes off (``OFF``; the passes are compared in
tests/test_torch_dpor.py).  The tolerance is exact equality."""

import random
import threading
import time

import pytest

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu.checker import linear as jlinear
from jepsen_tpu.checker import seq as jseq
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.checker import linear as tlinear
from jepsen_tpu_torch.checker import seq as tseq
from jepsen_tpu_torch.checker.encode import MAX_CRASH, encode_search
from test_torch_search import CASES, OFF, _pair


def crash_heavy(seed, *, corrupt, n_writes=4, n_crash=70):
    """(jax seq, jax model, port seq, port model): an 80-op register
    history with ``n_crash`` crashed ops from processes of their own
    (``n_writes`` writes, the rest reads) inserted at seeded places, built
    by the port's synth and copied op for op into the JAX package's ops."""
    h = ts.crash_heavy_register_history(
        random.Random(seed), n_ops=80, n_procs=4, overlap=4, n_values=3,
        n_crash=n_crash, n_writes=n_writes, corrupt=corrupt)
    hj = [jh.Op(process=o.process, type=o.type, f=o.f, value=o.value)
          for o in h]
    mj, mt = jm.register(0), tm.register(0)
    return (jh.encode_ops(hj, mj.f_codes), mj,
            th.encode_ops(h, mt.f_codes), mt)


CRASH_HEAVY = [(1, False), (2, True)]

LINEAR_KEYS = ("valid", "configs", "max_depth", "final_ops",
               "linearization", "witness_dropped", "info")


def _cases():
    return ([("case",) + c for c in CASES]
            + [("crash-heavy", seed, corrupt)
               for seed, corrupt in CRASH_HEAVY])


@pytest.mark.parametrize("witness_cap", [0, jlinear.DEFAULT_WITNESS_CAP])
@pytest.mark.parametrize("case", _cases(), ids=str)
def test_linear_matches_reference(case, witness_cap):
    if case[0] == "case":
        sj, mj, st, mt = _pair(case[1], case[2], corrupt=case[3])
    else:
        sj, mj, st, mt = crash_heavy(case[1], corrupt=case[2])
    oj = jlinear.check_opseq_linear(sj, mj, witness_cap=witness_cap, **OFF)
    ot = tlinear.check_opseq_linear(st, mt, witness_cap=witness_cap, **OFF)
    assert {k: ot.get(k) for k in LINEAR_KEYS} == \
        {k: oj.get(k) for k in LINEAR_KEYS}


def test_crash_heavy_cases_pass_the_encoding():
    """The crash-heavy histories lie past the device encoding, and give
    both verdicts."""
    verdicts = set()
    for seed, corrupt in CRASH_HEAVY:
        _, _, st, mt = crash_heavy(seed, corrupt=corrupt)
        assert encode_search(st).n_crash > MAX_CRASH
        verdicts.add(tlinear.check_opseq_linear(st, mt, **OFF)["valid"])
    assert verdicts == {True, False}


def _cancelled():
    ev = threading.Event()
    ev.set()
    return ev


@pytest.mark.parametrize("stop", ["cancel", "deadline"])
@pytest.mark.parametrize("engine", ["wgl", "linear"])
def test_host_engines_stop_like_reference(engine, stop):
    """A set ``cancel`` or a passed ``deadline`` ends both host engines
    as "unknown" at their first check, with the reference's ``info`` and
    counts.  The invalid crash-heavy history runs the WGL search far past
    its first check; the valid one runs the sweep past its own."""
    seed, corrupt = (2, True) if engine == "wgl" else (1, False)
    sj, mj, st, mt = crash_heavy(seed, corrupt=corrupt)
    kw = ({"cancel": _cancelled()} if stop == "cancel"
          else {"deadline": time.perf_counter() - 1.0})
    if engine == "wgl":
        oj = jseq.check_opseq(sj, mj, **OFF, **kw)
        ot = tseq.check_opseq(st, mt, **OFF, **kw)
    else:
        oj = jlinear.check_opseq_linear(sj, mj, **OFF, **kw)
        ot = tlinear.check_opseq_linear(st, mt, **OFF, **kw)
    want = "cancelled" if stop == "cancel" else "exceeded deadline"
    assert ot["valid"] == "unknown" and ot["info"] == want
    assert {k: ot.get(k) for k in ("valid", "configs", "max_depth",
                                   "info")} == \
        {k: oj.get(k) for k in ("valid", "configs", "max_depth", "info")}


def test_linear_budget_and_refusals():
    _, _, st, mt = _pair("register", 4, corrupt=False)
    out = tlinear.check_opseq_linear(st, mt, max_configs=10)
    assert out["valid"] == "unknown"
    assert out["info"] == "exceeded max_configs=10"
    # decompose=True runs since the decomposition layer was ported, and
    # refuses a checkpoint beside it
    assert tlinear.check_opseq_linear(st, mt, decompose=True)["valid"] is \
        tlinear.check_opseq_linear(st, mt)["valid"]
    with pytest.raises(ValueError, match="checkpoint"):
        tlinear.check_opseq_linear(st, mt, decompose=True,
                                   checkpoint_path="never-written",
                                   checkpoint_every=1)
    # a checkpoint path without a period writes nothing; a missing
    # resume file raises (tests/test_torch_checkpoint.py resumes real ones)
    assert tlinear.check_opseq_linear(
        st, mt, checkpoint_path="never-written")["valid"] is True
    with pytest.raises(FileNotFoundError):
        tlinear.check_opseq_linear(st, mt, resume_from="no-such-file")
    # the passes of item A7 answer True and None alike
    for kw in ({"lint": True}, {"hb": True}, {"dpor": True},
               {"audit": True}, {"lint": False, "hb": None, "dpor": False,
                                 "audit": None, "decompose": False}):
        assert tlinear.check_opseq_linear(st, mt, **kw)["valid"] is True


def test_advance_matches_reference():
    for win in range(64):
        for bit in range(6):
            if (win >> bit) & 1:
                continue
            assert tlinear._advance(3, win, bit, 100) == \
                jlinear._advance(3, win, bit, 100)
