"""The port's independent-keys checker against the JAX package's: the
same ``[k v]`` history, split per key, gives the same verdict, the same
failing keys and, per key, the same verdict, configs, depth and engine.
Keys above the checker's host threshold ride one ``search_batch``; an
invalid one is checked again on its own.  The tolerance is exact
equality."""

import random
from dataclasses import replace

import pytest

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.checker import core as jcore
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.checker import core as tcore
from jepsen_tpu_torch.checker import linearizable as tlin

#: (key, ops, corrupt): keys at or below the host threshold (48) are
#: checked on the host one by one, the rest in one batch
KEYS = (("a", 30, False), ("b", 80, True), ("c", 80, False), (7, 70, False),
        ("d", 24, True), ("e", 90, True), ("f", 70, False), ("i", 80, False))
FIELDS = ("valid", "configs", "max_depth", "engine")


@pytest.fixture(autouse=True)
def _reference_knobs(monkeypatch):
    for knob in ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
                 "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_BATCH_BUCKETS",
                 "JEPSEN_TPU_SHRINK"):
        monkeypatch.delenv(knob, raising=False)


def _keyed(synth, hist, ind):
    """One keyed history: every key's register history in turn, a
    nemesis op without a key between the first two."""
    out = []
    for i, (k, n_ops, corrupt) in enumerate(KEYS):
        rng = random.Random(f"ind-{k}")
        h = synth.register_history(rng, n_ops=n_ops, n_procs=4, overlap=3,
                                   crash_p=0.04, max_crashes=2, n_values=3)
        if corrupt:
            h = synth.corrupt_read(rng, h, at=0.8)
        out += [replace(op, process=op.process + 10 * i,
                        value=ind.tuple_(k, op.value)) for op in h]
        if i == 0:
            out.append(hist.Op(process="nemesis", type="info", f="start",
                               value=None))
    return out


@pytest.fixture(scope="module")
def histories():
    return _keyed(js, jh, jind), _keyed(ts, th, tind)


def _results(histories, tmp_path, algorithm, batch_device=True):
    hj, ht = histories
    cj = jind.checker(lin.linearizable(jm.cas_register(), shrink=False,
                                       algorithm=algorithm),
                      batch_device=batch_device)
    ct = tind.checker(tlin.linearizable(tm.cas_register(), shrink=False,
                                        algorithm=algorithm, device="cpu"),
                      batch_device=batch_device)
    rj = cj.check({"store_base": str(tmp_path / "jax")}, hj)
    rt = ct.check({"store_base": str(tmp_path / "port")}, ht)
    return rj, rt


@pytest.mark.parametrize("algorithm", ["auto", "linear"])
def test_independent_checker_matches_reference(histories, tmp_path,
                                               algorithm):
    rj, rt = _results(histories, tmp_path, algorithm)
    assert rt["valid"] is rj["valid"] is False
    assert rt["failures"] == rj["failures"]
    assert list(rt["results"]) == list(rj["results"])
    assert set(rt["results"]) == {k for k, *_ in KEYS}
    engines = set()
    for k in rj["results"]:
        a, b = rj["results"][k], rt["results"][k]
        engines.add(b["engine"])
        if a["valid"] is False and algorithm == "auto":
            # checked again on its own: the race's winner may differ
            assert b["valid"] is False, k
        else:
            assert {f: b.get(f) for f in FIELDS} == \
                {f: a.get(f) for f in FIELDS}, k
    assert any(e.startswith("device-batch") for e in engines), engines


def test_independent_checker_without_the_batch(histories, tmp_path):
    """``batch_device=False`` checks each key on its own, in parallel."""
    rj, rt = _results(histories, tmp_path, "linear", batch_device=False)
    assert rt["valid"] is rj["valid"]
    assert rt["failures"] == rj["failures"]
    for k in rj["results"]:
        a, b = rj["results"][k], rt["results"][k]
        assert {f: b.get(f) for f in FIELDS} == \
            {f: a.get(f) for f in FIELDS}, k


def test_keys_and_subhistories(histories):
    hj, ht = histories
    assert tind.history_keys(ht) == jind.history_keys(hj)
    for k, *_ in KEYS:
        sj, st = jind.subhistory(k, hj), tind.subhistory(k, ht)
        assert [(o.process, o.type, o.f, o.value) for o in st] == \
            [(o.process, o.type, o.f, o.value) for o in sj]
    assert tind.is_tuple(tind.tuple_(1, 2)) and not tind.is_tuple((1, 2))
    assert tind.tuple_(1, 2) == tind.tuple_(1, 2) != tind.tuple_(1, 3)
    assert list(tind.tuple_("k", 5)) == ["k", 5]


def test_core_combinators_match_reference():
    for vals in ([], [True], [True, "unknown"], [True, None],
                 [True, False, "unknown"], ["unknown", True]):
        assert tcore.merge_valid(vals) == jcore.merge_valid(vals)

    class Boom(tcore.Checker):
        def check(self, test, history, opts=None):
            raise RuntimeError("boom")

    out = tcore.check_safe(Boom(), {}, [])
    assert out["valid"] == "unknown" and "boom" in out["error"]
    assert tind.bounded_pmap(lambda x: x * x, range(5), 2) == \
        [0, 1, 4, 9, 16]
