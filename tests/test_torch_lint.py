"""The port's history lint (``analyze/lint.py``) against the JAX
package's: the same diagnostics (code, severity, message, index,
process, f) and scan facts on well-formed and malformed event histories
and OpSeqs, the Q codes included, and ``HistoryLintError`` where the
reference raises it, at the lint's own entry points and at the
checkers' boundaries."""

import random

import numpy as np
import pytest

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.analyze import lint as jlint
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.analyze import lint as tlint
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import seq as tseq
from test_torch_search import reference_defaults

#: (label, model name, events as (type, process, f, value, index))
MALFORMED = [
    ("double-invoke", "register", [
        ("invoke", 0, "write", 1, None), ("invoke", 0, "write", 2, None),
        ("ok", 0, "write", 2, None)]),
    ("orphan-completion", "register", [
        ("ok", 1, "read", 3, None), ("invoke", 0, "read", None, None),
        ("ok", 0, "read", 0, None)]),
    ("unknown-type", "register", [
        ("invoke", 0, "read", None, None), ("bogus", 0, "read", 0, None),
        ("ok", 0, "read", 0, None)]),
    ("stale-index", "register", [
        ("invoke", 0, "write", 1, 5), ("ok", 0, "write", 1, 3),
        ("invoke", 1, "read", None, 1), ("ok", 1, "read", 1, 2)]),
    ("unhashable", "register", [
        ("invoke", 0, "write", [1, 2, 3], None),
        ("ok", 0, "write", [1, 2, 3], None),
        ("invoke", 1, "write", {"a": 1}, None)]),
    ("value-drift", "cas-register", [
        ("invoke", 0, "write", 1, None), ("ok", 0, "write", 2, None),
        ("invoke", 1, "cas", (1, None), None), ("ok", 1, "cas", (1, 4),
                                                None),
        ("invoke", 2, "read", None, None), ("ok", 2, "write", 4, None)]),
    ("unknown-f", "mutex", [
        ("invoke", 0, "acquire", None, None), ("ok", 0, "acquire", None,
                                               None),
        ("invoke", 1, "steal", None, None), ("ok", 1, "steal", None, None),
        ("invoke", 2, "peek", None, None)]),
    ("queue-codes", "unordered-queue", [
        ("invoke", 0, "enqueue", 1, None), ("ok", 0, "enqueue", 1, None),
        ("invoke", 1, "dequeue", None, None), ("ok", 1, "dequeue", 9,
                                               None),
        ("invoke", 1, "dequeue", None, None), ("ok", 1, "dequeue", 9,
                                               None),
        ("invoke", 2, "ack", 7, None), ("ok", 2, "ack", 7, None),
        ("invoke", 2, "ack", 7, None), ("ok", 2, "ack", 7, None),
        ("invoke", 3, "claim", None, None), ("ok", 3, "claim", 1, None),
        ("invoke", 3, "drain", None, None), ("ok", 3, "drain", [1, 8, 8],
                                             None)]),
    ("nemesis", "register", [
        ("info", "nemesis", "start", None, None),
        ("invoke", 0, "write", 1, None),
        ("info", "nemesis", "stop", None, None),
        ("ok", 0, "write", 1, None), ("invoke", 1, "read", None, None)]),
]

_MODELS = {"register": "register", "cas-register": "cas_register",
           "mutex": "mutex", "unordered-queue": "unordered_queue"}


def _events(mod, specs):
    return [mod.Op(process=p, type=t, f=f, value=v, index=i)
            for t, p, f, v, i in specs]


def _models(name):
    return getattr(jm, _MODELS[name])(), getattr(tm, _MODELS[name])()


def _dicts(diags):
    return [d.to_dict() for d in diags]


def _scan_facts(sc):
    return (sc.n_events, sc.n_invoke, sc.n_ok, sc.n_fail, sc.n_info,
            sc.n_crashed, sc.concurrency, sc.processes, sc.has_nemesis,
            sc.pairs)


@pytest.mark.parametrize("label,name,specs", MALFORMED,
                         ids=[m[0] for m in MALFORMED])
def test_event_lint_matches_reference(label, name, specs):
    jmodel, tmodel = _models(name)
    hj, ht = _events(jh, specs), _events(th, specs)
    for model_j, model_t in ((None, None), (jmodel, tmodel)):
        sj = jlint.scan_events(hj, model_j)
        st = tlint.scan_events(ht, model_t)
        assert _dicts(st.diagnostics) == _dicts(sj.diagnostics)
        assert _scan_facts(st) == _scan_facts(sj)
        assert _dicts(st.errors) == _dicts(sj.errors)
        assert _dicts(st.warnings) == _dicts(sj.warnings)
    for codes in (tlint.QUEUE_CODES, ("H001", "H002")):
        assert _dicts(tlint.scan_events(ht, tmodel, codes=codes)
                      .diagnostics) == _dicts(
            jlint.scan_events(hj, jmodel, codes=codes).diagnostics)
    raised = []
    for mod, h, model in ((jlint, hj, jmodel), (tlint, ht, tmodel)):
        try:
            raised.append(("ok", _dicts(mod.check_history(h, model))))
        except mod.HistoryLintError as e:
            raised.append(("raised", str(e), _dicts(e.diagnostics)))
    assert raised[1] == raised[0]


def test_malformed_cases_cover_every_event_code():
    seen = set()
    for _label, name, specs in MALFORMED:
        _, tmodel = _models(name)
        seen |= {d.code for d in tlint.lint_history(_events(th, specs),
                                                    tmodel)}
    want = set(tlint.ERROR_CODES) - {"H007"}
    assert want <= seen, want - seen
    assert tlint.ERROR_CODES == jlint.ERROR_CODES
    assert tlint.EVENT_TYPES == jlint.EVENT_TYPES


def _synth_pair(kind, seed):
    """(jax history, jax model, port history, port model)."""
    out = []
    for synth, models in ((js, jm), (ts, tm)):
        rng = random.Random(seed)
        if kind == "mutex":
            h = synth.sim_mutex_history(rng, n_ops=40, n_procs=4,
                                        crash_p=0.1)
            model = models.mutex()
        elif kind == "queue":
            h = synth.corrupt_dequeue(rng, synth.sim_queue_history(
                rng, 30, 4, crash_p=0.1))
            model = models.unordered_queue(16)
        else:
            h = synth.register_history(rng, n_ops=40, n_procs=4,
                                       crash_p=0.1, n_values=3)
            model = models.cas_register()
        out += [h, model]
    return out


@pytest.mark.parametrize("kind", ["register", "mutex", "queue"])
@pytest.mark.parametrize("seed", [1, 2])
def test_synth_histories_lint_like_reference(kind, seed):
    hj, mj, ht, mt = _synth_pair(kind, seed)
    assert _dicts(tlint.lint_history(ht, mt)) == \
        _dicts(jlint.lint_history(hj, mj))
    sj = jh.encode_ops(hj, mj.f_codes)
    st = th.encode_ops(ht, mt.f_codes)
    assert _dicts(tlint.lint_opseq(st, mt)) == \
        _dicts(jlint.lint_opseq(sj, mj)) == []


def _opseq_pair(mutation):
    """A well-formed register OpSeq in both packages, then broken."""
    seqs = []
    for mod, models, synth in ((jh, jm, js), (th, tm, ts)):
        m = models.register(0)
        h = synth.register_history(random.Random(4), n_ops=20, n_procs=3,
                                   crash_p=0.1, n_values=3, cas=False)
        s = mod.encode_ops(h, m.f_codes)
        mutation(s)
        seqs += [s, m]
    return seqs


def _short_column(s):
    s.v2 = s.v2[:-1]


def _swap_inv(s):
    s.inv = s.inv.copy()
    s.inv[[2, 3]] = s.inv[[3, 2]]


def _early_ret(s):
    s.ret = s.ret.copy()
    i = int(np.nonzero(s.ok)[0][1])
    s.ret[i] = s.inv[i]


def _ok_never_returns(s):
    s.ok = s.ok.copy()
    s.ok[np.nonzero(~np.asarray(s.ok))[0]] = True


def _bad_f(s):
    s.f = s.f.copy()
    s.f[[1, 5]] = 7


@pytest.mark.parametrize("mutation", [_short_column, _swap_inv,
                                      _early_ret, _ok_never_returns,
                                      _bad_f, lambda s: None],
                         ids=["H007", "H004-inv", "H004-ret", "H002",
                              "M001", "clean"])
def test_opseq_lint_matches_reference(mutation):
    sj, mj, st, mt = _opseq_pair(mutation)
    assert _dicts(tlint.lint_opseq(st, mt)) == _dicts(jlint.lint_opseq(sj,
                                                                       mj))
    raised = []
    for mod, s, m in ((jlint, sj, mj), (tlint, st, mt)):
        try:
            raised.append(("ok", _dicts(mod.maybe_lint(s, m, None))))
        except mod.HistoryLintError as e:
            raised.append(("raised", str(e)))
        assert mod.maybe_lint(s, m, False) == []
    assert raised[1] == raised[0]


@pytest.mark.parametrize("label,name,specs", MALFORMED,
                         ids=[m[0] for m in MALFORMED])
def test_checker_boundary_matches_reference(label, name, specs,
                                            monkeypatch, tmp_path):
    """``Linearizable.check`` lints the events before encoding: errors
    raise, warnings ride the result as ``lint_warnings``."""
    reference_defaults(monkeypatch)
    jmodel, tmodel = _models(name)
    got = []
    for checker, h in ((lin.linearizable(jmodel, algorithm="host"),
                        _events(jh, specs)),
                       (tlin.linearizable(tmodel, algorithm="host",
                                          device="cpu"),
                        _events(th, specs))):
        try:
            out = checker.check({"store_base": str(tmp_path)}, h)
            got.append(("ok", out["valid"], out.get("lint_warnings")))
        except ValueError as e:
            got.append(("raised", type(e).__name__, str(e)))
    assert got[1] == got[0]


def test_opseq_lint_at_every_entry_point():
    _, _, st, mt = _opseq_pair(_swap_inv)
    calls = [lambda **kw: tseq.check_opseq(st, mt, **kw),
             lambda **kw: tlin.search_opseq(st, mt, device="cpu", **kw),
             lambda **kw: tlin.check_competition(st, mt, device="cpu",
                                                 **kw),
             lambda **kw: tlin.linearizable(mt, device="cpu", **kw).check(
                 {}, st)]
    for call in calls:
        with pytest.raises(tlint.HistoryLintError, match="H004"):
            call()
        call(lint=False, hb=False)  # the search still answers
