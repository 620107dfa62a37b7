"""The port's default checker route against the JAX package's:
``search_opseq`` stopped by ``stop``/``deadline`` and past the device
encoding, the competition race, and ``Linearizable`` with every
algorithm name.  The deterministic parts are compared exactly; of the
race only the verdict and the engine's prefix, since the winner depends
on timing.  The passes are off on both sides (``OFF``) where the counts
are compared; the default route with the passes on is compared in
tests/test_torch_default_route.py.  Also the port's own rules: a CUDA
device without a card raises before any host leg starts, and a failing
device leg propagates instead of letting a host leg win."""

import threading
import time

import pytest
import torch

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import seq as tseq
from test_torch_linear import CRASH_HEAVY, crash_heavy
from test_torch_search import CASES, OFF, _pair, reference_defaults

SEARCH_KEYS = ("valid", "configs", "max_depth", "engine", "info",
               "final_ops", "linearization")


@pytest.fixture(autouse=True)
def _pinned_level_cap(monkeypatch):
    """Pin the adaptive level cap on both sides (the width ladder
    follows wall time), and the JAX package's pass knobs unset."""
    monkeypatch.setattr(lin, "_SLICE_TARGET_S", 1e9)
    monkeypatch.setattr(tlin, "_SLICE_TARGET_S", 1e9)
    reference_defaults(monkeypatch)


def _store(tmp_path):
    return {"name": "port-test", "store_base": str(tmp_path)}


def _race_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("competition-") and t.is_alive()]


@pytest.mark.parametrize("how", ["stop", "deadline"])
@pytest.mark.parametrize("kind,seed,corrupt", CASES)
def test_search_opseq_stopped_matches_reference(kind, seed, corrupt, how):
    """A preset ``stop`` or a passed ``deadline`` ends the search after
    its first slice, as "unknown" with the reference's counts."""
    sj, mj, st, mt = _pair(kind, seed, corrupt=corrupt)
    if how == "stop":
        ev_j, ev_t = threading.Event(), threading.Event()
        ev_j.set()
        ev_t.set()
        kj, kt = {"stop": ev_j}, {"stop": ev_t}
    else:
        kj = kt = {"deadline": time.perf_counter() - 1.0}
    oj = lin.search_opseq(sj, mj, **OFF, **kj)
    ot = tlin.search_opseq(st, mt, device="cpu", **OFF, **kt)
    assert {k: ot.get(k) for k in SEARCH_KEYS} == \
        {k: oj.get(k) for k in SEARCH_KEYS}


def test_stopped_cases_end_unknown():
    """Some stopped search above ends "unknown" mid-search (the cases
    are not all decided by the greedy witness or the first slice)."""
    seen = set()
    for kind, seed, corrupt in CASES:
        _, _, st, mt = _pair(kind, seed, corrupt=corrupt)
        ev = threading.Event()
        ev.set()
        seen.add(tlin.search_opseq(st, mt, device="cpu", stop=ev,
                                   **OFF)["valid"])
    assert "unknown" in seen


@pytest.mark.parametrize("seed,corrupt", CRASH_HEAVY)
def test_search_opseq_fallback_matches_reference(seed, corrupt):
    sj, mj, st, mt = crash_heavy(seed, corrupt=corrupt)
    oj = lin.search_opseq(sj, mj, **OFF)
    ot = tlin.search_opseq(st, mt, device="cpu", **OFF)
    assert {k: ot.get(k) for k in SEARCH_KEYS} == \
        {k: oj.get(k) for k in SEARCH_KEYS}
    if not corrupt:
        return
    assert ot["engine"] == "host-linear(fallback)"
    # stopped before it starts, the sweep ends at its first check
    ev = threading.Event()
    ev.set()
    out = tlin.search_opseq(st, mt, device="cpu", stop=ev, **OFF)
    assert out["valid"] == "unknown" and out["info"] == "cancelled"


@pytest.mark.parametrize("kind,seed,corrupt", CASES)
def test_competition_agrees_with_oracle(kind, seed, corrupt):
    _, _, st, mt = _pair(kind, seed, corrupt=corrupt)
    want = tseq.check_opseq(st, mt, **OFF)["valid"]
    out = tlin.check_competition(st, mt, device="cpu", **OFF)
    assert out["valid"] == want
    assert out["engine"].startswith("competition(")
    assert not _race_threads()


def test_competition_host_wins_when_device_stalls():
    """With a budget of one configuration the device leg gives up and a
    host leg carries the race."""
    sj, mj, st, mt = _pair("register", 1, corrupt=True)
    oj = lin.check_competition(sj, mj, budget=1, **OFF)
    ot = tlin.check_competition(st, mt, budget=1, device="cpu", **OFF)
    assert ot["valid"] is False and oj["valid"] is False
    assert ot["engine"] in ("competition(host-wgl)",
                            "competition(host-linear)")


@pytest.mark.parametrize("seed,corrupt", CRASH_HEAVY)
def test_competition_past_the_encoding(seed, corrupt):
    sj, mj, st, mt = crash_heavy(seed, corrupt=corrupt)
    oj = lin.check_competition(sj, mj, **OFF)
    ot = tlin.check_competition(st, mt, device="cpu", **OFF)
    assert ot["valid"] is (not corrupt) and oj["valid"] is ot["valid"]
    assert ot["engine"].startswith("competition(host-")
    assert ot["engine"].endswith("+device-skipped(encoding limits)")
    assert not _race_threads()


@pytest.mark.parametrize("seed,corrupt", CRASH_HEAVY)
def test_competition_max_configs_caps_the_host_legs(seed, corrupt):
    """Past the encoding the host legs race alone; capped at a handful
    of configurations each gives up, and the race ends exhausted in both
    packages (with the default cap they decide: the test above)."""
    sj, mj, st, mt = crash_heavy(seed, corrupt=corrupt)
    oj = lin.check_competition(sj, mj, max_configs=5, **OFF)
    ot = tlin.check_competition(st, mt, max_configs=5, device="cpu", **OFF)
    assert ot == oj
    assert ot["valid"] == "unknown"
    assert ot["engine"] == "competition(exhausted; device encoding limits)"


def test_competition_clamps_max_configs_as_the_reference(monkeypatch):
    """The cap each host leg gets: ``max_configs``, at most the ~4 GB
    memo bound for the history's length, the reference's default
    otherwise."""
    from jepsen_tpu.checker import linear as jlinear
    from jepsen_tpu.checker import seq as jseq

    sj, mj, st, mt = _pair("register", 1, corrupt=True)
    seen = {"port": [], "jax": []}
    for key, owner, name in (("port", tseq, "check_opseq"),
                             ("port", tlin, "check_opseq_linear"),
                             ("jax", jseq, "check_opseq"),
                             ("jax", jlinear, "check_opseq_linear")):
        def leg(*a, max_configs, key=key, name=name, **kw):
            seen[key].append((name, max_configs))
            return {"valid": "unknown", "configs": 0}
        monkeypatch.setattr(owner, name, leg)
    for cap in (None, 1000, 10**12):
        kw = {} if cap is None else {"max_configs": cap}
        lin.check_competition(sj, mj, budget=1, **OFF, **kw)
        tlin.check_competition(st, mt, budget=1, device="cpu", **OFF, **kw)
    assert sorted(seen["port"]) == sorted(seen["jax"])
    per_cfg = 2 * (len(st) // 8 + 200)
    assert sorted(c for _, c in seen["port"]) == sorted(
        2 * [min(50_000_000, 4_000_000_000 // per_cfg), 1000,
             4_000_000_000 // per_cfg])


@pytest.mark.parametrize("kind,seed,corrupt", CASES[:4])
def test_default_route_matches_reference(kind, seed, corrupt, tmp_path):
    """``linearizable(model)`` with its defaults above ``host_threshold``
    runs the race and gives the reference's verdict."""
    sj, mj, st, mt = _pair(kind, seed, corrupt=corrupt)
    assert len(st) > 48
    oj = lin.linearizable(mj, **OFF).check(_store(tmp_path / "j"), sj)
    ot = tlin.linearizable(mt, device="cpu", **OFF).check(
        _store(tmp_path / "t"), st)
    assert ot["valid"] == oj["valid"]
    assert ot["engine"].startswith("competition(")
    assert ("report_file" in ot) is (ot["valid"] is False)


@pytest.mark.parametrize("algorithm", ["auto", "host", "wgl", "device",
                                       "linear", "competition"])
def test_every_algorithm_finds_the_violation(algorithm, tmp_path):
    sj, mj, st, mt = _pair("cas-register", 3, corrupt=True)
    oj = lin.linearizable(mj, algorithm=algorithm, **OFF).check(
        _store(tmp_path / "j"), sj)
    ot = tlin.linearizable(mt, algorithm=algorithm, device="cpu",
                           host_threshold=10, **OFF).check(
        _store(tmp_path / "t"), st)
    assert ot["valid"] is False and oj["valid"] is False
    with pytest.raises(ValueError):
        tlin.linearizable(mt, algorithm="quantum", device="cpu")


@pytest.mark.parametrize("algorithm", ["auto", "linear", "device"])
def test_past_the_encoding_through_the_checker(algorithm, tmp_path):
    _, _, st, mt = crash_heavy(1, corrupt=False)
    out = tlin.linearizable(mt, algorithm=algorithm, device="cpu",
                            **OFF).check(_store(tmp_path), st)
    assert out["valid"] is True
    want = {"auto": "competition(host-", "linear": "host-linear",
            "device": "greedy-witness"}[algorithm]
    assert out["engine"].startswith(want)


def test_cuda_without_a_card_raises_before_the_race(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, st, mt = _pair("register", 1, corrupt=True)
    with pytest.raises(RuntimeError, match="is_available"):
        tlin.check_competition(st, mt)
    with pytest.raises(RuntimeError, match="is_available"):
        tlin.linearizable(mt).check({}, st)
    assert not _race_threads()


def test_device_leg_failure_propagates(monkeypatch):
    """A device leg that fails (here: its slice function cannot be
    built) raises out of the race; no host leg wins in its place."""
    def broken(*a, **kw):
        raise RuntimeError("level_loop build failed")

    monkeypatch.setattr(tlin, "get_kernel", broken)
    _, _, st, mt = _pair("register", 1, corrupt=True)
    with pytest.raises(RuntimeError, match="build failed"):
        tlin.check_competition(st, mt, device="cpu", **OFF)
    with pytest.raises(RuntimeError, match="build failed"):
        tlin.linearizable(mt, device="cpu", **OFF).check({}, st)
    deadline = time.monotonic() + 10
    while _race_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _race_threads()
