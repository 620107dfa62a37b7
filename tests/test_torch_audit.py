"""The port's certificate audit (``analyze/audit.py``) against the JAX
package's: equal reports on the certificates the port's engines emit
(witnesses, frontiers, drop reasons, happens-before cycles, queue
orders and evidence), the same W-codes on tampered ones, and the same
``maybe_audit`` policy (attach a summary; raise ``AuditError``)."""

import copy
import importlib
import random

import pytest

from jepsen_tpu import history as jh
from jepsen_tpu import synth as js
from jepsen_tpu_torch.analyze import audit as taudit
from jepsen_tpu_torch.checker import linear as tlinear
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import seq as tseq
from test_torch_hb import QUEUE_CASES, encoded, ops, to_port
from test_torch_search import reference_defaults

# the JAX package's ``analyze`` re-exports the function ``audit`` under
# the module's name
jaudit = importlib.import_module("jepsen_tpu.analyze.audit")


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    reference_defaults(monkeypatch)


def _report(a):
    out = dict(a)
    out["diagnostics"] = [d.to_dict() for d in a["diagnostics"]]
    return out


def assert_audits_equal(sj, mj, st, mt, result):
    """Both audits of ``result`` agree; returns the port's report."""
    rt = _report(taudit.audit(st, mt, result))
    assert rt == _report(jaudit.audit(sj, mj, result))
    return rt


def _histories():
    """(label, events, model factory, args): valid and invalid, every
    family, crashes."""
    out = []
    for seed in range(2):
        rng = random.Random(40 + seed)
        h = js.register_history(rng, n_ops=30, n_procs=4, crash_p=0.1,
                                n_values=3)
        out.append((f"cas-{seed}", h, "cas_register", ()))
        out.append((f"cas-bad-{seed}", js.corrupt_read(rng, h, at=0.6),
                    "cas_register", ()))
        h = js.register_history(rng, n_ops=30, n_procs=4, crash_p=0.0,
                                cas=False, unique_writes=True)
        out.append((f"unique-{seed}", h, "register", (0,)))
        out.append((f"unique-swap-{seed}", js.swap_read_values(rng, h),
                    "register", (0,)))
        out.append((f"mutex-{seed}", js.sim_mutex_history(
            rng, 24, 3, crash_p=0.1), "mutex", ()))
        for fifo in (False, True):
            h = js.sim_queue_history(rng, 24, 3, crash_p=0.1, fifo=fifo)
            f = "fifo_queue" if fifo else "unordered_queue"
            out.append((f"{f}-{seed}", h, f, (12,)))
            out.append((f"{f}-swap-{seed}", js.swap_dequeues(rng, h), f,
                        (12,)))
            out.append((f"{f}-thin-air-{seed}",
                        js.corrupt_dequeue(rng, h), f, (12,)))
    return out


HISTORIES = _histories()


def _engine_results(st, mt):
    return [("check_opseq", tseq.check_opseq(st, mt)),
            ("check_opseq(off)", tseq.check_opseq(st, mt, hb=False,
                                                  dpor=False)),
            ("check_opseq_linear", tlinear.check_opseq_linear(
                st, mt, witness_cap=100_000)),
            ("check_opseq_linear(no witness)",
             tlinear.check_opseq_linear(st, mt)),
            ("search_opseq", tlin.search_opseq(st, mt, device="cpu")),
            ("search_opseq(off)", tlin.search_opseq(
                st, mt, device="cpu", hb=False, dpor=False))]


@pytest.mark.parametrize("label,h,factory,args", HISTORIES,
                         ids=[c[0] for c in HISTORIES])
def test_engine_certificates_audit_like_reference(label, h, factory, args):
    sj, mj, st, mt = encoded(h, factory, *args)
    checked = set()
    for route, res in _engine_results(st, mt):
        rep = assert_audits_equal(sj, mj, st, mt, res)
        assert rep["ok"], (route, rep)
        checked.add(rep["checked"])
    # the engine's own audit=True attaches the same summary
    out = tseq.check_opseq(st, mt, audit=True)
    assert out["audit"] == jaudit._summary(jaudit.audit(sj, mj, out))
    assert checked


def test_histories_reach_every_certificate_kind():
    kinds = set()
    for _label, h, factory, args in HISTORIES:
        _, _, st, mt = encoded(h, factory, *args)
        for _route, res in _engine_results(st, mt):
            kinds.add(taudit.audit(st, mt, res)["checked"])
    assert kinds >= {"linearization", "witness_dropped", "final_ops",
                     "frontier_dropped", "hb_cycle", "queue_order",
                     "queue_evidence"}


def _tampered_witnesses(res, n):
    lin = res["linearization"]
    yield "swap", lin[:1] and [lin[-1]] + lin[1:-1] + [lin[0]]
    yield "drop", lin[:-1]
    yield "twice", lin + lin[:1]
    yield "out-of-range", lin + [n + 3]
    yield "not-an-int", lin + ["x"]


@pytest.mark.parametrize("label,h,factory,args",
                         [c for c in HISTORIES if "bad" not in c[0]
                          and "swap" not in c[0] and "thin" not in c[0]],
                         ids=lambda c: c if isinstance(c, str) else None)
def test_tampered_witnesses_flagged_like_reference(label, h, factory,
                                                   args):
    sj, mj, st, mt = encoded(h, factory, *args)
    res = tseq.check_opseq(st, mt, hb=False, dpor=False)
    assert res["valid"] is True
    codes = set()
    for _kind, lin in _tampered_witnesses(res, len(st)):
        bad = dict(res, linearization=lin)
        rep = assert_audits_equal(sj, mj, st, mt, bad)
        codes |= set(rep["codes"])
    assert {"W001", "W002"} <= codes


def test_tampered_cycles_and_queue_orders_flagged_like_reference():
    seen = set()
    cases = [encoded(h, f, *a) for label, h, f, a in HISTORIES
             if "swap" in label or "thin" in label]
    cases += [encoded(ops(jh, *specs), f, *(() if f == "mutex" else (8,)))
              for f, specs in QUEUE_CASES.values()]
    for sj, mj, st, mt in cases:
        res = tseq.check_opseq(st, mt)
        for key in ("hb_cycle", "queue_cycle"):
            if key not in res:
                continue
            cyc = res[key]
            tampers = [
                [{**cyc[0], "dst": (cyc[0]["dst"] + 1) % len(st)}]
                + cyc[1:],
                [{**cyc[0], "src": len(st) + 5}] + cyc[1:],
                [{**e, "kind": "rt"} for e in cyc],
                [{**e, "kind": "fifo", "via": [0]} for e in cyc],
                [{**e, "kind": "mystery"} for e in cyc],
                cyc[:1]]
            for t in tampers:
                rep = assert_audits_equal(sj, mj, st, mt,
                                          dict(res, **{key: t}))
                seen |= set(rep["codes"])
        if "queue_dup" in res:
            d = res["queue_dup"]
            for t in ({**d, "dequeues": d["dequeues"][:1]},
                      {**d, "enqueues": []},
                      {**d, "dequeues": [len(st) + 1]},
                      {"dequeues": [], "enqueues": []}):
                rep = assert_audits_equal(sj, mj, st, mt,
                                          dict(res, queue_dup=t))
                seen |= set(rep["codes"])
        if "queue_evidence" in res:
            ev = res["queue_evidence"]
            for t in ({**ev, "rows": [0]}, {**ev, "kind": "lost"},
                      {**ev, "rows": []}, {**ev, "rows": [len(st)]}):
                rep = assert_audits_equal(sj, mj, st, mt,
                                          dict(res, queue_evidence=t))
                seen |= set(rep["codes"])
        for t in ({"valid": True}, {"valid": False},
                  {"valid": False, "final_ops": [len(st) + 2]}):
            seen |= set(assert_audits_equal(sj, mj, st, mt, t)["codes"])
    assert {"W001", "W002", "W006", "W007", "W008"} <= seen


def test_hb_cycle_rejected_when_preconditions_fail():
    """A plausible cycle over duplicate writes must not audit."""
    h = ops(jh, ("invoke", 0, "write", 5), ("ok", 0, "write", 5),
            ("invoke", 1, "write", 5), ("ok", 1, "write", 5),
            ("invoke", 0, "read", 5), ("ok", 0, "read", 5))
    fake = {"valid": False, "configs": 0,
            "hb_cycle": [{"src": 0, "dst": 2, "kind": "rf"},
                         {"src": 2, "dst": 0, "kind": "rt"}]}
    for factory, args in (("register", (0,)), ("cas_register", ()),
                          ("mutex", ())):
        if factory == "mutex":
            h2 = ops(jh, ("invoke", 0, "acquire", None),
                     ("ok", 0, "acquire", None))
            sj, mj, st, mt = encoded(h2, factory, *args)
            bad = dict(fake, hb_cycle=[{"src": 0, "dst": 0, "kind": "rf"},
                                       {"src": 0, "dst": 0, "kind": "rt"}])
        else:
            sj, mj, st, mt = encoded(h, factory, *args)
            bad = fake
        rep = assert_audits_equal(sj, mj, st, mt, bad)
        assert not rep["ok"] and "W006" in rep["codes"]


def test_multi_register_stitch_w005():
    """A stitched multi-register witness that breaks cross-cell real
    time is W005, as in the reference."""
    h = ops(jh, ("invoke", 0, "write", (0, 1)), ("ok", 0, "write", (0, 1)),
            ("invoke", 1, "write", (1, 2)), ("ok", 1, "write", (1, 2)))
    sj, mj, st, mt = encoded(h, "multi_register", 2)
    bad = {"valid": True, "linearization": [1, 0],
           "decompose": {"stitched": True}}
    rep = assert_audits_equal(sj, mj, st, mt, bad)
    assert rep["codes"] == ["W005"]


def test_model_less_results_take_the_event_audit():
    rng = random.Random(5)
    h = js.corrupt_dequeue(rng, js.sim_queue_history(rng, 20, 3))
    ht = to_port(h)
    thin = [i for i, op in enumerate(h)
            if op.type == "ok" and op.f == "dequeue"
            and op.value == 999_983]
    enq = [i for i, op in enumerate(h)
           if op.type == "ok" and op.f == "enqueue"]
    for res in ({"valid": False, "queue_evidence": {
                    "kind": "unexpected-dequeue", "rows": thin}},
                {"valid": False, "queue_evidence": {
                    "kind": "lost-acked-enqueue", "rows": enq[:2]}},
                {"valid": False, "queue_evidence": {
                    "kind": "unexpected-member", "rows": [0]}},
                {"valid": False, "queue_evidence": {"kind": "?",
                                                    "rows": [0]}},
                {"valid": False, "queue_evidence": {
                    "kind": "lost-acked-enqueue", "rows": [10**6]}},
                {"valid": False}, {"valid": True}):
        assert _report(taudit.audit(ht, None, res)) == \
            _report(jaudit.audit(h, None, res))


def test_maybe_audit_policy_matches_reference():
    sj, mj, st, mt = encoded(HISTORIES[0][1], "cas_register")
    res = tseq.check_opseq(st, mt)
    for flag in (None, False):
        assert "audit" not in taudit.maybe_audit(st, mt, dict(res), flag)
    good = taudit.maybe_audit(st, mt, dict(res), True)
    assert good["audit"] == jaudit.maybe_audit(sj, mj, dict(res),
                                               True)["audit"]
    bad = dict(res, linearization=res["linearization"][:-1])
    with pytest.raises(taudit.AuditError) as et:
        taudit.maybe_audit(st, mt, copy.deepcopy(bad), True)
    with pytest.raises(jaudit.AuditError) as ej:
        jaudit.maybe_audit(sj, mj, copy.deepcopy(bad), True)
    assert str(et.value) == str(ej.value)
    assert _report(et.value.audit) == _report(ej.value.audit)
    assert taudit.AUDIT_CODES == jaudit.AUDIT_CODES


@pytest.mark.parametrize("algorithm", ["auto", "host", "linear", "device",
                                       "competition"])
def test_checker_audit_flag(algorithm, tmp_path):
    """``audit=True`` at the checker audits whatever route answered."""
    for label, h, factory, args in HISTORIES[:4]:
        sj, mj, st, mt = encoded(h, factory, *args)
        out = tlin.linearizable(mt, algorithm=algorithm, device="cpu",
                                host_threshold=10, audit=True).check(
            {"store_base": str(tmp_path)}, st)
        assert out["audit"]["ok"], (label, out["audit"])
