"""The port's failure report against the JAX package's: the shrink of
invalid verdicts (``analyze/shrink.py``), the row projection it
searches (``decompose/partition.subseq``), the store paths and
``linear.html`` (``checker/linear_report.py``), byte for byte; and the
report that ``Linearizable.check`` writes under the test's store
directory.  The engines' passes are off on both sides (``OFF``); the
shrink's re-checks run their defaults in both packages."""

import os

import numpy as np
import pytest

from jepsen_tpu import store as jstore
from jepsen_tpu.analyze import shrink as jshrink
from jepsen_tpu.checker import linear_report as jreport
from jepsen_tpu.checker import seq as jseq
from jepsen_tpu.decompose import canonical as jcanon
from jepsen_tpu.decompose import partition as jpart
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.analyze import shrink as tshrink
from jepsen_tpu_torch.checker import linear_report as treport
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import seq as tseq
from jepsen_tpu_torch.decompose import canonical as tcanon
from jepsen_tpu_torch.decompose import partition as tpart
from test_torch_search import CASES, OFF, _pair, reference_defaults

INVALID = [c for c in CASES if c[2]]

SHRINK_KEYS = ("rows", "n_from", "n_to", "checks", "minimal",
               "brute_force")


@pytest.fixture(autouse=True)
def _reference_defaults(monkeypatch):
    """The JAX shrink's bounded re-checks read the pass knobs from the
    environment: unset, they run the defaults, as the port's do."""
    reference_defaults(monkeypatch)
    monkeypatch.setenv("JEPSEN_TPU_SHRINK", "1")


@pytest.mark.parametrize("kind,seed,corrupt", INVALID)
def test_shrink_matches_reference(kind, seed, corrupt):
    sj, mj, st, mt = _pair(kind, seed, corrupt=corrupt)
    oj = jshrink.shrink_invalid(sj, mj)
    ot = tshrink.shrink_invalid(st, mt)
    assert {k: ot[k] for k in SHRINK_KEYS} == {k: oj[k] for k in SHRINK_KEYS}
    assert ot["n_to"] < ot["n_from"] and ot["brute_force"] is False
    assert tshrink.shrink_summary(st, ot) == jshrink.shrink_summary(sj, oj)


def test_shrink_of_a_valid_history_keeps_it():
    sj, mj, st, mt = _pair("register", 4, corrupt=False)
    ot = tshrink.shrink_invalid(st, mt)
    assert ot == jshrink.shrink_invalid(sj, mj)
    assert ot["checks"] == 1 and ot["n_to"] == ot["n_from"]


@pytest.mark.parametrize("kind,seed,corrupt", CASES)
def test_brute_force_matches_reference(kind, seed, corrupt):
    sj, mj, st, mt = _pair(kind, seed, corrupt=corrupt)
    rows = list(range(0, len(st), max(1, len(st) // 14)))[:14]
    assert tshrink.brute_force_check(tpart.subseq(st, rows), mt) == \
        jshrink.brute_force_check(jpart.subseq(sj, rows), mj)
    assert tshrink.brute_force_check(st, mt) is None


@pytest.mark.parametrize("kind,seed,corrupt", CASES[:3])
def test_subseq_matches_reference(kind, seed, corrupt):
    sj, _, st, _ = _pair(kind, seed, corrupt=corrupt)
    rows = list(range(1, len(st), 3))
    pj, pt = jpart.subseq(sj, rows), tpart.subseq(st, rows)
    for col in ("process", "f", "v1", "v2", "inv", "ret", "ok"):
        np.testing.assert_array_equal(getattr(pt, col), getattr(pj, col))
    assert [o.to_dict() for o in pt.ops] == [o.to_dict() for o in pj.ops]
    assert tcanon.event_ranks(st.inv, st.ret) == \
        jcanon.event_ranks(sj.inv, sj.ret)


def test_store_paths_match_reference(tmp_path):
    test = {"name": "etcd cas/register", "start_time": "20260101T000000",
            "store_base": str(tmp_path)}
    assert tstore.path(test, "a", "linear.html") == \
        jstore.path(test, "a", "linear.html")
    assert tstore.base_dir({}) == jstore.base_dir({}) == tstore.BASE
    assert tstore.time_str(0) == jstore.time_str(0)
    p = tstore.path_mkdirs(test, "linear.html")
    assert os.path.isdir(os.path.dirname(p))


@pytest.mark.parametrize("with_shrink", [False, True])
@pytest.mark.parametrize("kind,seed,corrupt", INVALID)
def test_render_matches_reference(kind, seed, corrupt, with_shrink):
    sj, mj, st, mt = _pair(kind, seed, corrupt=corrupt)
    rj = jseq.check_opseq(sj, mj, **OFF)
    rt = tseq.check_opseq(st, mt, **OFF)
    assert rj["valid"] is False and rt["valid"] is False
    if with_shrink:
        rj["shrink"] = jshrink.shrink_summary(
            sj, jshrink.shrink_invalid(sj, mj))
        rt["shrink"] = tshrink.shrink_summary(
            st, tshrink.shrink_invalid(st, mt))
    html = treport.render_linear_html(st, rt)
    assert html == jreport.render_linear_html(sj, rj)
    assert ("Minimal failing subhistory" in html) is with_shrink


@pytest.mark.parametrize("shrink", [None, False])
def test_check_writes_the_report(shrink, tmp_path):
    sj, mj, st, mt = _pair("register", 1, corrupt=True)
    test = {"name": "report", "start_time": "t0",
            "store_base": str(tmp_path)}
    out = tlin.linearizable(mt, algorithm="host", device="cpu",
                            shrink=shrink, **OFF).check(test, st)
    want = os.path.join(str(tmp_path), "report", "t0", "linear.html")
    assert out["valid"] is False and out["report_file"] == want
    assert ("shrink" in out) is (shrink is None)
    with open(want) as fh:
        assert fh.read() == treport.render_linear_html(st, out)
    # the JAX checker writes the same document for the same history
    jtest = dict(test, store_base=str(tmp_path / "jax"))
    jlin_out = _jax_checker(mj, shrink).check(jtest, sj)
    with open(jlin_out["report_file"]) as fh:
        assert fh.read() == treport.render_linear_html(st, out)


def _jax_checker(model, shrink):
    import jepsen_tpu.checker.linearizable as lin

    return lin.linearizable(model, algorithm="host", shrink=shrink, **OFF)


def test_per_key_report_and_unwritable_store(tmp_path):
    _, _, st, mt = _pair("register", 1, corrupt=True)
    res = tseq.check_opseq(st, mt, **OFF)
    test = {"name": "k", "start_time": "t0", "store_base": str(tmp_path)}
    p = treport.write_linear_html(test, st, res, {"history_key": 7,
                                                  "subdirectory": ["s"]})
    assert p == os.path.join(str(tmp_path), "k", "t0", "s", "linear-7.html")
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert treport.write_linear_html(
        {"store_base": str(blocker)}, st, res) is None


def test_large_histories_are_not_shrunk(tmp_path, monkeypatch):
    monkeypatch.setattr(tlin.Linearizable, "SHRINK_MAX_OPS", 10)
    _, _, st, mt = _pair("register", 1, corrupt=True)
    out = tlin.linearizable(mt, algorithm="host", device="cpu",
                            **OFF).check({"store_base": str(tmp_path)}, st)
    assert "shrink" not in out and os.path.exists(out["report_file"])
