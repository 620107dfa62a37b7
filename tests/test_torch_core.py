"""The port's test runner (``core.run``) and its fixtures against the JAX
package's: at concurrency 1 a seeded generator on the atom DB gives the
JAX package's ``(process, type, f, value)`` sequence; at concurrency 5,
and on 4 keys at 2 threads each, each package's checker gives the same
verdict on the port's history.  Then the reference's own runner cases
(``tests/test_core.py``) on the port, the stream sink on success and
on abort, the test-map knobs that replace the JAX package's environment
variables (``lint``, ``stream``, ``stream_cache``, ``device``), and the
one place where the port differs on purpose: a failed device fold
raises out of ``core.run`` instead of being logged."""

import os
import random
import sys
import threading
import types
from dataclasses import replace

import pytest
import torch

import jepsen_tpu.checker.linearizable as jlin
from jepsen_tpu import checker as jchecker
from jepsen_tpu import client as jclient
from jepsen_tpu import core as jcore
from jepsen_tpu import fixtures as jfixtures
from jepsen_tpu import generator as jgen
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu.models import cas_register as j_cas
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import client as tclient
from jepsen_tpu_torch import core as tcore
from jepsen_tpu_torch import fixtures as tfixtures
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.models import cas_register as t_cas
from jepsen_tpu_torch.stream.checker import StreamChecker
from jepsen_tpu_torch.stream.device import DeviceFoldError

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

PKGS = {
    "jax": types.SimpleNamespace(
        core=jcore, fixtures=jfixtures, gen=jgen, ind=jind, client=jclient,
        checker=jchecker, cas=j_cas),
    "torch": types.SimpleNamespace(
        core=tcore, fixtures=tfixtures, gen=tgen, ind=tind, client=tclient,
        checker=tchecker, cas=t_cas),
}
KNOBS = ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
         "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_BATCH_BUCKETS",
         "JEPSEN_TPU_SHRINK", "JEPSEN_TPU_STREAM",
         "JEPSEN_TPU_STREAM_CACHE", "JEPSEN_TPU_STREAM_LOOKAHEAD")


@pytest.fixture(autouse=True)
def _reference_defaults(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(jlin, "_SLICE_TARGET_S", 1e9)
    monkeypatch.setattr(tlin, "_SLICE_TARGET_S", 1e9)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def _write(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def _cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def cas_test(P, state, *, n_ops=60, concurrency=5, checker=None):
    """The reference's basic cas test (core_test.clj:18-30) from package
    ``P``; unnamed, so nothing is stored."""
    return P.fixtures.noop_test() | {
        "name": None,
        "db": P.fixtures.atom_db(state),
        "client": P.fixtures.atom_client(state),
        "model": P.cas(0),
        "checker": checker or P.checker.unbridled_dionysus,
        "generator": P.gen.clients(
            P.gen.limit(n_ops, P.gen.mix([_read, _write, _cas]))),
        "concurrency": concurrency,
    }


class LyingClient:
    """The atom client, but the ``lie_at``-th read answers 7 (a value no
    write gives); keyed reads carry their key back."""

    def __init__(self, inner, tuple_, lie_at=3):
        self.inner = inner
        self.tuple_ = tuple_
        self.reads = 0
        self.lie_at = lie_at
        self.lock = threading.Lock()

    def open(self, test, node):
        return self

    def setup(self, test):
        pass

    def teardown(self, test):
        pass

    def close(self, test):
        pass

    def invoke(self, test, op):
        out = self.inner.invoke(test, op)
        if op.f == "read":
            with self.lock:
                self.reads += 1
                lie = self.reads == self.lie_at
            if lie:
                v = op.value
                return replace(out, value=self.tuple_(v.key, 7)
                               if hasattr(v, "key") else 7)
        return out


def _seq(history):
    def plain(v):
        if hasattr(v, "key") and hasattr(v, "value"):
            return ("kv", v.key, v.value)
        return v
    return [(op.process, op.type, op.f, plain(op.value)) for op in history]


def _j(history):
    """The port's history as the JAX package's ops, keyed values
    included."""
    out = []
    for op in history:
        d = op.to_dict()
        if tind.is_tuple(op.value):
            d["value"] = jind.tuple_(op.value.key, op.value.value)
        out.append(jh.Op.from_dict(d))
    return out


# ---------------------------------------------------------------------------
# the two packages' runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_concurrency_one_sequence_equals_reference(seed):
    runs = {}
    for name, P in PKGS.items():
        random.seed(seed)
        state = P.fixtures.AtomRegister()
        runs[name] = P.core.run(cas_test(P, state, n_ops=40, concurrency=1))
    want, got = _seq(runs["jax"]["history"]), _seq(runs["torch"]["history"])
    assert got == want and len(got) == 80
    assert runs["torch"]["results"] == runs["jax"]["results"]


@pytest.mark.parametrize("lie", [False, True])
def test_concurrency_five_verdict_equals_reference(lie):
    random.seed(11)
    P = PKGS["torch"]
    state = P.fixtures.AtomRegister()
    test = cas_test(P, state, checker=tlin.linearizable(t_cas(0),
                                                        device="cpu"))
    if lie:
        test["client"] = LyingClient(test["client"], tind.tuple_)
    out = tcore.run(test)
    h = out["history"]
    assert len(h) == 120 and all(op.index == i for i, op in enumerate(h))
    want = jlin.linearizable(j_cas(0)).check({"name": None}, _j(h), {})
    assert out["results"]["valid"] is want["valid"] is (not lie)


def keyed_test(P, checker, *, lie=False, **kw):
    return P.fixtures.noop_test() | {
        "name": None,
        "client": chip_smoke.RegisterClient(P.ind.tuple_,
                                            liars={2} if lie else ()),
        "model": P.cas(0), "checker": checker, "concurrency": 4,
        "generator": P.gen.clients(P.ind.concurrent_generator(
            2, range(4),
            lambda k: P.gen.limit(30, P.gen.mix([_read, _write, _cas])))),
    } | kw


@pytest.mark.parametrize("lie", [False, True])
def test_keyed_verdicts_equal_reference(lie):
    random.seed(5)
    P = PKGS["torch"]
    out = tcore.run(keyed_test(P, tind.checker(
        tlin.linearizable(t_cas(0), device="cpu")), lie=lie))
    res = out["results"]
    assert sorted(res["results"]) == [0, 1, 2, 3]
    want = jind.checker(jlin.linearizable(j_cas(0))).check(
        {"name": None, "model": j_cas(0)}, _j(out["history"]), {})
    assert res["valid"] is want["valid"] is (not lie)
    assert {k: r["valid"] for k, r in res["results"].items()} \
        == {k: r["valid"] for k, r in want["results"].items()}
    assert res["failures"] == want["failures"] == ([2] if lie else [])


# ---------------------------------------------------------------------------
# the reference's runner cases (tests/test_core.py) on the port
# ---------------------------------------------------------------------------

P = PKGS["torch"]


def test_basic_cas_run():
    state = tfixtures.AtomRegister()
    test = tcore.run(cas_test(P, state, checker=tlin.linearizable(
        device="cpu")))
    assert test["results"]["valid"] is True
    h = test["history"]
    assert len(h) == 2 * 60
    assert all(op.index == i for i, op in enumerate(h))
    assert state.read() == "done"


class CrashyClient(tclient.Client):
    """Crashes on every other invoke."""

    def __init__(self, state):
        self.state = state
        self.n = 0
        self.lock = threading.Lock()

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        with self.lock:
            self.n += 1
            if self.n % 2 == 0:
                raise RuntimeError("client crashed!")
        return replace(op, type="ok", value=self.state.read())


def test_worker_recovery():
    state = tfixtures.AtomRegister()
    test = cas_test(P, state) | {
        "client": CrashyClient(state),
        "generator": tgen.clients(tgen.limit(40, {"type": "invoke",
                                                  "f": "read",
                                                  "value": None}))}
    test = tcore.run(test)
    h = test["history"]
    invokes = [op for op in h if op.type == "invoke"]
    assert len(invokes) == 40
    infos = [op for op in h if op.type == "info" and op.process != "nemesis"]
    assert infos and all(op.error.startswith("indeterminate") for op in infos)
    assert any(op.process >= test["concurrency"] for op in invokes)


class ExplodingGen(tgen.Generator):
    def __init__(self, n):
        self.n = n
        self.lock = threading.Lock()

    def op(self, test, process):
        with self.lock:
            self.n -= 1
            if self.n < 0:
                raise RuntimeError("generator exploded!")
        return {"type": "invoke", "f": "read", "value": None}


def _exploding(n=2, *, concurrency=3):
    return tgen.clients(tgen.phases(
        ExplodingGen(n), tgen.limit(10, {"type": "invoke", "f": "read",
                                         "value": None})))


def test_generator_recovery_unblocks_barriers():
    state = tfixtures.AtomRegister()
    test = cas_test(P, state) | {"generator": _exploding(), "concurrency": 3}
    with pytest.raises(RuntimeError, match="generator exploded"):
        tcore.run(test)


def test_nemesis_ops_in_history():
    state = tfixtures.AtomRegister()
    test = cas_test(P, state, n_ops=10) | {
        "generator": tgen.nemesis(
            tgen.limit(2, {"type": "info", "f": "start", "value": None}),
            tgen.limit(10, {"type": "invoke", "f": "read", "value": None}))}
    test = tcore.run(test)
    nem = [op for op in test["history"] if op.process == "nemesis"]
    assert len(nem) == 4 and all(op.type == "info" for op in nem)


def test_run_with_independent_workload_and_store(tmp_path):
    random.seed(3)
    base = str(tmp_path / "store")
    test = tcore.run(keyed_test(
        P, tind.checker(tlin.linearizable(device="cpu")),
        name="independent-cas", store_base=base))
    assert test["results"]["valid"] is True
    assert set(test["results"]["results"]) == {0, 1, 2, 3}
    d = os.path.join(base, "independent-cas", test["start_time"])
    for f in ("history.jsonl", "results.json", "test.json", "jepsen.log"):
        assert os.path.exists(os.path.join(d, f)), f
    assert os.path.islink(os.path.join(base, "latest"))
    loaded = tstore.load("independent-cas", test["start_time"], base)
    assert loaded["results"]["valid"] is True
    assert len(loaded["history"]) == len(test["history"])
    assert test["phase_s"]["workload"] > 0


# ---------------------------------------------------------------------------
# the stream sink and the test-map knobs
# ---------------------------------------------------------------------------


def test_stream_sink_on_success(tmp_path):
    random.seed(2)
    base = str(tmp_path)
    state = tfixtures.AtomRegister()
    test = cas_test(P, state, checker=tlin.linearizable(device="cpu")) | {
        "name": "streamed", "store_base": base, "stream": True,
        "device": "cpu"}
    out = tcore.run(test)
    assert "__stream_check__" not in out
    assert out["stream_results"]["valid"] is True
    assert out["results"]["stream"]["valid"] is out["results"]["valid"] \
        is True
    assert os.path.exists(tstore.path(out, "live.json"))
    saved = tstore.load("streamed", out["start_time"], base)["results"]
    assert saved["stream"]["valid"] is True


def test_stream_sink_on_abort(tmp_path):
    base = str(tmp_path)
    state = tfixtures.AtomRegister()
    test = cas_test(P, state) | {
        "generator": _exploding(20), "concurrency": 3, "name": "aborted",
        "store_base": base, "stream": True, "device": "cpu",
        "start_time": "20260101T000000"}
    with pytest.raises(RuntimeError, match="generator exploded") as e:
        tcore.run(test)
    sres = e.value.stream_results
    assert sres["aborted"] is True and sres["valid"] is True
    saved = tstore.load("aborted", "20260101T000000", base)
    assert saved["results"] == sres
    assert len(saved["history"]) >= 2 * 20 - 6


def test_lint_knob_installs_the_stream_linter():
    base = cas_test(P, tfixtures.AtomRegister())
    assert isinstance(tcore.prepare_test(base)["__stream_lint__"],
                      tgen.StreamLinter)
    assert isinstance(tcore.prepare_test(base | {"lint": True})
                      ["__stream_lint__"], tgen.StreamLinter)
    assert "__stream_lint__" not in tcore.prepare_test(base | {"lint": False})
    assert "__stream_check__" not in tcore.prepare_test(base)


def test_lint_off_lets_a_double_invoke_through():
    """With the linter on, a generator that emits a completion for a
    process with no open invoke fails the run; with ``lint`` False the
    op reaches the client."""
    g = tgen.clients(tgen.limit(1, {"type": "ok", "f": "read",
                                    "value": None}))
    state = tfixtures.AtomRegister()
    test = cas_test(P, state) | {"generator": g, "concurrency": 1}
    from jepsen_tpu_torch.analyze.lint import HistoryLintError

    with pytest.raises(HistoryLintError, match="H002"):
        tcore.run(test)
    out = tcore.run(test | {"generator": tgen.clients(tgen.limit(
        1, {"type": "ok", "f": "read", "value": None})), "lint": False})
    assert [op.type for op in out["history"]] == ["ok", "ok"]


def test_stream_knobs(tmp_path):
    base = cas_test(P, tfixtures.AtomRegister()) | {
        "stream": True, "device": "cpu"}
    t = tcore.prepare_test(base)
    sink = t["__stream_check__"]
    assert isinstance(sink, StreamChecker) and sink.cache is None
    assert str(sink.device) == "cpu"
    sink.close()
    path = str(tmp_path / "v.jsonl")
    t = tcore.prepare_test(base | {"stream_cache": path,
                                   "stream_lookahead": 3})
    sink = t["__stream_check__"]
    assert sink.cache is not None and sink.info_lookahead == 3
    sink.close()
    t = tcore.prepare_test(base | {"stream": False})
    assert "__stream_check__" not in t
    t = tcore.prepare_test(base | {"model": None})
    assert "__stream_check__" not in t


def test_stream_cache_store_resolves_the_default_path(monkeypatch):
    from jepsen_tpu_torch.decompose import cache as dcache

    seen = []
    monkeypatch.setattr(dcache, "default_cache_path",
                        lambda base=None: seen.append(1) or "v.jsonl")
    base = cas_test(P, tfixtures.AtomRegister()) | {
        "stream": True, "device": "cpu", "stream_cache": "store"}
    sink = tcore.prepare_test(base)["__stream_check__"]
    assert seen == [1] and sink.cache.path == "v.jsonl"
    sink.close()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the card is present: the default device runs")
def test_stream_without_device_raises_without_the_card():
    test = cas_test(P, tfixtures.AtomRegister()) | {"stream": True}
    with pytest.raises(RuntimeError, match="is_available"):
        tcore.prepare_test(test)
    with pytest.raises(RuntimeError, match="is_available"):
        tcore.run(test)


# ---------------------------------------------------------------------------
# a failed device fold: the port raises, the JAX package logs
# ---------------------------------------------------------------------------


class FailingSink:
    """A stream sink whose device fold failed: raised by ``finalize``
    (the async route) or by ``ingest`` (inline)."""

    def __init__(self, *, inline=False):
        self.inline = inline
        self.events = 0

    def ingest(self, op):
        self.events += 1
        if self.inline and self.events == 5:
            raise DeviceFoldError("fold of segment 0 failed on the card")

    def finalize(self):
        raise DeviceFoldError("fold of segment 3 failed on the card")

    def close(self):
        pass


@pytest.mark.parametrize("inline", [False, True])
def test_device_fold_error_propagates_where_reference_logs(inline):
    runs = {}
    for name, Q in PKGS.items():
        random.seed(4)
        test = cas_test(Q, Q.fixtures.AtomRegister(), n_ops=20) | {
            "__stream_check__": FailingSink(inline=inline)}
        try:
            runs[name] = Q.core.run(test)
        except DeviceFoldError as e:
            runs[name] = e
    # the JAX package logs "stream checker finalize failed" and finishes
    assert runs["jax"]["results"]["valid"] is True
    assert "stream_results" not in runs["jax"]
    assert isinstance(runs["torch"], DeviceFoldError)


def test_device_fold_error_propagates_on_abort():
    test = cas_test(P, tfixtures.AtomRegister()) | {
        "generator": _exploding(), "concurrency": 3,
        "__stream_check__": FailingSink()}
    with pytest.raises(DeviceFoldError) as e:
        tcore.run(test)
    assert "generator exploded" in str(e.value.__context__)


# ---------------------------------------------------------------------------
# report and repl
# ---------------------------------------------------------------------------


def test_report_to_tees_like_the_reference(tmp_path, capsys):
    from jepsen_tpu import report as jreport
    from jepsen_tpu_torch import report as treport

    for name, R in (("jax", jreport), ("torch", treport)):
        with R.to(str(tmp_path / f"{name}.txt")):
            print("checked", 3, "keys")
            print("valid?", True)
    assert (tmp_path / "torch.txt").read_text() \
        == (tmp_path / "jax.txt").read_text() == "checked 3 keys\nvalid? True\n"
    assert capsys.readouterr().out == "checked 3 keys\nvalid? True\n" * 2


def test_repl_last_test_reloads_the_latest_run(tmp_path):
    from jepsen_tpu import repl as jrepl
    from jepsen_tpu_torch import repl as trepl

    base = str(tmp_path)
    assert trepl.last_test(base) is None is jrepl.last_test(base)
    random.seed(8)
    out = tcore.run(cas_test(P, tfixtures.AtomRegister(), n_ops=10) | {
        "name": "repl", "store_base": base})
    last = trepl.last_test(base)
    assert last["name"] == "repl" and last["start_time"] == out["start_time"]
    assert last["results"]["valid"] is True
    assert len(last["history"]) == len(out["history"]) == 20
    ref = jrepl.last_test(base)
    assert ref["results"] == last["results"]
    assert [op.to_dict() for op in ref["history"]] == \
        [op.to_dict() for op in last["history"]]
