"""The port's bounded model checker (``analyze/modelcheck.py``) against
the JAX package's.

For all 17 family x mode pairs at their default scope, ``explore``
gives the same ``explored`` block and the same violation set (codes,
schedules and ``state`` ids, which hash ``repr`` of the fingerprint).
``run_mc`` gives the same certificates (shrunk schedule, ``shrunk``
stats, ``history``, ``confirm``, ``banked`` counts) and banks the same
pool, entry for entry but the bank timestamp.  Certificates replay
across packages both ways.  Then the counterparts of
``tests/test_modelcheck.py``'s DPOR soundness and reduction-biting
cases, the ``jtpu_mc_*`` metrics, ``chip_smoke.MC_SWEEP`` held to the
JAX package's own sweep, and the JAX package's MC201 bank fault, which
the port's pool keeps."""

import json
import os
import sys

import pytest
import torch

from jepsen_tpu.analyze import modelcheck as jmc
from jepsen_tpu.live import corpus as jcorpus
from jepsen_tpu_torch.analyze import modelcheck as tmc
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.live import corpus as tcorpus
from jepsen_tpu_torch.obs.metrics import REGISTRY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import chip_smoke  # noqa: E402
import fuzz as fuzz_tool  # noqa: E402  (the JAX package's corpus replay)

PAIRS = [(f, m) for f in jmc.ALL_FAMILIES for m in jmc.ALL_MODES[f]]
SEEDED = [(f, m) for f, m in PAIRS if m != "clean"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def violation_set(result: dict) -> set:
    return {(v["code"], v["state"]) for v in result["violations"]}


def test_constants_match_reference():
    assert tmc.MC_CODES == jmc.MC_CODES
    assert tmc.ALL_MODES == jmc.ALL_MODES
    assert (tmc.FAMILIES, tmc.SHELL_FAMILIES) \
        == (jmc.FAMILIES, jmc.SHELL_FAMILIES)
    assert (tmc.KEY, tmc.ABSENT, tmc.EPS) == (jmc.KEY, jmc.ABSENT, jmc.EPS)
    for f, m in PAIRS:
        assert tmc.default_scope(f, m).to_dict() \
            == jmc.default_scope(f, m).to_dict()
        assert tmc.mc_plan_block(f, m) == jmc.mc_plan_block(f, m)
    s = tmc.scope_from_args("lock", "clean", crashes=2, max_events=9)
    assert s.to_dict() == jmc.scope_from_args(
        "lock", "clean", crashes=2, max_events=9).to_dict()
    assert tmc.Scope.from_dict(s.to_dict()) == s


@pytest.mark.parametrize("family,mode", PAIRS)
def test_explore_matches_reference(family, mode):
    t = tmc.explore(family, mode, tmc.default_scope(family, mode))
    j = jmc.explore(family, mode, jmc.default_scope(family, mode))
    assert t["explored"] == j["explored"]
    assert violation_set(t) == violation_set(j)
    assert t["violations"] == j["violations"]
    # chip_smoke holds the card's sweep to the JAX package's blocks
    assert chip_smoke.MC_SWEEP[f"{family}/{mode}"] == tuple(
        j["explored"][k] for k in chip_smoke.MC_SWEEP_KEYS)


def _pool(base):
    pool = tcorpus.load_pool(tcorpus.corpus_dir(str(base)))
    return [{k: v for k, v in e.items() if k != "banked"} for e in pool]


@pytest.mark.parametrize("family,mode", SEEDED)
def test_run_mc_certificates_match_reference(tmp_path, family, mode):
    t = tmc.run_mc(family, mode, bank_base=str(tmp_path / "t"))
    j = jmc.run_mc(family, mode, bank_base=str(tmp_path / "j"))
    assert json.dumps(t, sort_keys=True, default=str) \
        == json.dumps(j, sort_keys=True, default=str)
    assert t["violations"] and not t["ok"]
    assert all(v["replayed"] for v in t["violations"])
    assert _pool(tmp_path / "t") == _pool(tmp_path / "j")


def test_run_mc_clean_matches_reference():
    for family in tmc.ALL_FAMILIES:
        t = tmc.run_mc(family, "clean")
        j = jmc.run_mc(family, "clean")
        assert t == j and t["ok"] and t["explored"]["complete"]


@pytest.mark.parametrize("family,mode", [("lock", "volatile"),
                                         ("shell-queue", "volatile"),
                                         ("replicated", "split-brain")])
def test_certificates_replay_across_packages(family, mode):
    j_cert = jmc.run_mc(family, mode, confirm=False)["violations"][0]
    t_cert = tmc.run_mc(family, mode, confirm=False)["violations"][0]
    for cert in (j_cert, t_cert):
        cert = json.loads(json.dumps(cert))  # as a file would carry it
        for mod in (jmc, tmc):
            rep = mod.replay_certificate(cert)
            assert rep["reproduced"] and rep["code"] == cert["code"]
        broken = dict(cert, schedule=cert["schedule"][:1])
        assert not tmc.replay_certificate(broken)["reproduced"]
        assert not jmc.replay_certificate(broken)["reproduced"]


def test_load_certificate_round_trip(tmp_path):
    cert = tmc.run_mc("lock", "volatile", confirm=False)["violations"][0]
    p = tmp_path / "cert.json"
    p.write_text(json.dumps(cert))
    assert tmc.load_certificate(str(p)) == jmc.load_certificate(str(p))
    assert tmc.replay_certificate(tmc.load_certificate(str(p)))[
        "reproduced"]


# ---------------------------------------------------------------------------
# tests/test_modelcheck.py's soundness and reduction cases, in the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,mode", [("replicated", "volatile"),
                                         ("lock", "volatile"),
                                         ("rqueue", "volatile")])
def test_dpor_soundness_seeded(family, mode):
    scope = tmc.default_scope(family, mode)
    on = tmc.explore(family, mode, scope, dpor=True, max_violations=10_000)
    off = tmc.explore(family, mode, scope, dpor=False,
                      max_violations=10_000)
    assert on["explored"]["complete"] and off["explored"]["complete"]
    assert violation_set(on) == violation_set(off)
    assert on["violations"]
    assert on["explored"]["sleep_prunes"] > 0
    assert on["explored"]["events"] <= off["explored"]["events"]
    j = jmc.explore(family, mode, jmc.default_scope(family, mode),
                    dpor=False, max_violations=10_000)
    assert off["explored"] == j["explored"]
    assert violation_set(off) == violation_set(j)


@pytest.mark.parametrize("family", tmc.FAMILIES)
def test_dpor_soundness_clean(family):
    scope = tmc.default_scope(family, "clean")
    on = tmc.explore(family, "clean", scope, dpor=True)
    off = tmc.explore(family, "clean", scope, dpor=False)
    assert not on["violations"] and not off["violations"]
    assert on["explored"]["complete"] and off["explored"]["complete"]


@pytest.mark.parametrize("family", tmc.FAMILIES)
def test_clean_mode_passes_with_reduction_biting(family):
    r = tmc.run_mc(family, "clean", dpor=True)
    assert r["ok"] and r["explored"]["complete"]
    assert r["explored"]["prune_ratio"] > 0
    assert r["explored"]["states"] > 10


def test_dpor_none_means_on():
    assert tmc.run_mc("lock", "volatile", confirm=False)["dpor"] is True
    assert tmc.run_mc("lock", "volatile", dpor=False,
                      confirm=False)["dpor"] is False


@pytest.mark.parametrize("family,mode,code,route", [
    ("replicated", "volatile", "MC102", "engine"),
    ("replicated", "split-brain", "MC101", "engine"),
    ("rqueue", "volatile", "MC104", "queue"),
    ("lock", "volatile", "MC106", "engine")])
def test_seeded_core_caught(tmp_path, family, mode, code, route):
    r = tmc.run_mc(family, mode, bank_base=str(tmp_path / "corpus"))
    v = next(v for v in r["violations"] if v["code"] == code)
    assert v["replayed"]
    assert len(v["schedule"]) == v["shrunk"]["n_to"] <= v["shrunk"]["n_from"]
    c = v["confirm"]
    assert c["route"] == route and c["engine_valid"] is False
    assert c["audit_ok"] is True and c["audit_checked"]
    assert v["banked"]["banked"] >= 1


def test_mc_metrics_registered_under_the_reference_names():
    names = ("jtpu_mc_states_total", "jtpu_mc_schedules_total",
             "jtpu_mc_violations_total", "jtpu_mc_sleep_prunes_total",
             "jtpu_mc_prune_ratio")
    def total(name):
        s = REGISTRY.get(name).snapshot()
        return sum(s.values()) if isinstance(s, dict) else s

    before = total("jtpu_mc_states_total")
    r = tmc.run_mc("lock", "clean")
    for name in names:
        assert REGISTRY.get(name) is not None, name
    assert total("jtpu_mc_states_total") - before == r["explored"]["states"]
    assert REGISTRY.get("jtpu_mc_violations_total").labelnames == ("code",)


def test_chip_smoke_sweep_covers_every_pair():
    assert list(chip_smoke.MC_SWEEP) == [f"{f}/{m}" for f, m in PAIRS]


def test_mc201_bank_fault_kept_from_the_reference(tmp_path, capsys):
    """The JAX package banks an MC201 certificate (one job delivered
    twice) as a total-queue entry expected invalid; total-queue admits
    a duplicate delivery, so its own replay reports a regression.  The
    port's pool is the same, and so is its replay's answer."""
    for mod, name in ((jmc, "j"), (tmc, "t")):
        mod.run_mc("shell-queue", "volatile",
                   bank_base=str(tmp_path / name))
    assert _pool(tmp_path / "t") == _pool(tmp_path / "j")
    rc = fuzz_tool.corpus_replay(jcorpus.corpus_dir(str(tmp_path / "j")))
    assert rc == 1 and "REGRESSION mc-shell-queue" in capsys.readouterr().err
    out = tcorpus.corpus_replay(tcorpus.corpus_dir(str(tmp_path / "t")),
                                device="cpu")
    assert len(out["failures"]) == 1
    assert out["failures"][0].startswith(
        "REGRESSION mc-shell-queue×mc-volatile seeded")
    assert "{'total-queue': True, 'constraints': True}" in out["failures"][0]
    # the same history through the engine route its confirm took is
    # invalid: the certificate is right, its bank expectation is not
    cert = next(c for c in tmc.run_mc("shell-queue", "volatile")[
        "violations"] if c["code"] == "MC201")
    assert cert["confirm"]["route"] == "engine"
    assert cert["confirm"]["engine_valid"] is False
    assert [Op.from_dict(d).f for d in cert["history"]][-1] == "drain"
