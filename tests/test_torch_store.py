"""The port's store round trip against the JAX package's: ``save_1``,
``save_2``, ``load``, ``latest``, ``tests`` and the run log.  The same
test map and history, saved by each package under the same base path,
give the same bytes in ``history.jsonl``, ``test.json`` and
``results.json``; each package loads the other's run.  The start time,
the one field a clock would set, is pinned in the test map."""

import json
import logging
import os
import random

import numpy as np
import pytest

from jepsen_tpu import independent as jind
from jepsen_tpu import store as jstore
from jepsen_tpu import synth as jsynth
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch.models import cas_register

FILES = ("history.jsonl", "test.json", "results.json")
START = "20260102T030405"


def _test(base, seed):
    return {"name": f"store test/{seed}", "start_time": START,
            "store_base": str(base), "nodes": ["n1", "n2", "n3"],
            "concurrency": 5, "model": cas_register(), "client": object(),
            "checker": object(), "sets": {3, 1, 2}, "np": np.int64(seed),
            "nested": {1: (2, 3), "x": None}}


def _history(synth, seed, keyed):
    h = synth.register_history(random.Random(seed), n_ops=30, n_procs=4,
                               overlap=3, crash_p=0.1, max_crashes=3)
    if keyed:
        ind = jind if synth is jsynth else tind
        h = [type(op)(**{**op.__dict__,
                         "value": ind.tuple_(i % 3, op.value)})
             for i, op in enumerate(h)]
    return h


def _results(seed):
    return {"valid": seed % 2 == 0, "configs": 10 * seed,
            "linearization": [2, 0, 1], "stats": {"t": 0.5, 3: [None]},
            "np": np.int32(seed), "fs": frozenset({"b", "a"})}


def _save(store, test, history, results):
    store.save_1(test, history)
    store.save_2(test, results)


def _save_both(tmp_path, seed, keyed=False):
    """Save the same run with each package under one base path (the
    test map records it), moved aside after each save: the JAX package's
    to ``j``, the port's to ``t``."""
    base = tmp_path / "s"
    for store, synth, to in ((jstore, jsynth, "j"), (tstore, tsynth, "t")):
        _save(store, _test(base, seed), _history(synth, seed, keyed),
              _results(seed))
        os.rename(base, tmp_path / to)
    return str(tmp_path / "j"), str(tmp_path / "t")


def _bytes(base, name):
    d = os.path.join(base, name, START)
    out = {}
    for f in FILES:
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


@pytest.mark.parametrize("seed,keyed", [(0, False), (1, False), (2, True),
                                        (3, True)])
def test_saved_bytes_equal_the_reference(tmp_path, seed, keyed):
    jb, tb = _save_both(tmp_path, seed, keyed)
    name = tstore._sanitize(f"store test/{seed}")
    assert _bytes(tb, name) == _bytes(jb, name)
    for base in (jb, tb):
        assert os.path.islink(os.path.join(base, "latest"))
        assert os.path.islink(os.path.join(base, name, "latest"))


def _loaded(run):
    run = dict(run)
    run["history"] = [op.to_dict() for op in run.get("history", [])]
    return run


@pytest.mark.parametrize("seed", range(3))
def test_load_latest_tests_across_packages(tmp_path, seed):
    jb, tb = _save_both(tmp_path, seed)
    h = json.loads(json.dumps([op.to_dict()
                               for op in _history(tsynth, seed, False)]))
    name = tstore._sanitize(f"store test/{seed}")
    # each package reads the other's run, and its own, alike
    for base in (jb, tb):
        mine = _loaded(tstore.load(name, START, base))
        theirs = _loaded(jstore.load(name, START, base))
        assert mine == theirs
        assert mine["history"] == h
        assert mine["results"]["valid"] is (seed % 2 == 0)
        assert "model" not in mine and "client" not in mine
        assert _loaded(tstore.latest(base)) == _loaded(jstore.latest(base))
        got_t = {n: sorted(r) for n, r in tstore.tests(base=base).items()}
        got_j = {n: sorted(r) for n, r in jstore.tests(base=base).items()}
        assert got_t == got_j == {name: [START]}
    assert tstore.tests(name="other", base=tb) == {}
    assert tstore.latest(str(tmp_path / "none")) is None
    assert tstore.tests(base=str(tmp_path / "none")) == {}


def test_a_second_run_moves_latest(tmp_path):
    base = str(tmp_path)
    first = _test(base, 0)
    _save(tstore, first, _history(tsynth, 0, False), _results(0))
    second = {**first, "start_time": "20260102T030406"}
    _save(tstore, second, _history(tsynth, 1, False), _results(1))
    assert tstore.latest(base)["results"]["configs"] == 10
    name = tstore._sanitize(first["name"])
    assert sorted(tstore.tests(base=base)[name]) == [
        START, "20260102T030406"]
    assert os.path.realpath(os.path.join(base, name, "latest")).endswith(
        "20260102T030406")


def test_serializable_test_drops_live_objects():
    t = _test("b", 5)
    assert tstore.serializable_test(t) == jstore.serializable_test(t)
    assert set(tstore.NONSERIALIZABLE_KEYS) == set(
        jstore.NONSERIALIZABLE_KEYS)


def test_run_log(tmp_path):
    test = _test(tmp_path, 7)
    tstore.start_logging(test)
    try:
        logging.getLogger("jepsen").info("hello from the run")
    finally:
        tstore.stop_logging(test)
    p = tstore.path(test, "jepsen.log")
    with open(p) as f:
        assert "hello from the run" in f.read()
    logging.getLogger("jepsen").info("after the run")
    with open(p) as f:
        assert "after the run" not in f.read()
    # an unnamed test persists nothing
    tstore.start_logging({"store_base": str(tmp_path / "u")})
    tstore.stop_logging()
    assert not os.path.exists(tmp_path / "u")
