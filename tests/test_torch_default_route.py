"""The default route, flags left alone: ``linearizable(model,
device="cpu")`` against the JAX package's ``linearizable(model)`` with
no ``JEPSEN_TPU_*`` variable set.  Both run the lint, the prepass and
DPOR.  Where the route is deterministic (at or under ``host_threshold``,
``algorithm`` host, linear or device) everything is compared: verdict,
engine, counts, certificate, ``lint_warnings``, the ``hb`` or
``constraints`` stats and the ``dpor`` stats.  Above the threshold the
race decides, and its winner depends on timing: there the verdict, the
engine's prefix and the ``lint_warnings`` are compared, and the rest
wherever both packages' races ended with the same engine."""

import dataclasses
import random

import pytest

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import history as jh
from jepsen_tpu import synth as js
from jepsen_tpu_torch.checker import linearizable as tlin
from test_torch_hb import encoded, to_port
from test_torch_search import reference_defaults

KEYS = ("valid", "engine", "configs", "max_depth", "final_ops",
        "linearization", "witness_dropped", "frontier_dropped",
        "device_configs", "witness_prefix_ops", "lint_warnings", "hb",
        "constraints", "dpor", "hb_cycle", "queue_cycle", "queue_dup",
        "queue_evidence", "shrink")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    monkeypatch.setattr(lin, "_SLICE_TARGET_S", 1e9)
    monkeypatch.setattr(tlin, "_SLICE_TARGET_S", 1e9)
    reference_defaults(monkeypatch)
    monkeypatch.delenv("JEPSEN_TPU_SHRINK", raising=False)
    monkeypatch.delenv("JEPSEN_TPU_LIN_ALGORITHM", raising=False)


def _stale_index(h):
    """The same history with one event's index stale (an H004 warning
    that rides the result)."""
    h = [dataclasses.replace(op, index=i) for i, op in enumerate(h)]
    h[3] = dataclasses.replace(h[3], index=0)
    return h


def _cases(n_ops):
    """(label, events, model factory, args) at about ``n_ops`` ops:
    every family, valid and corrupted, with and without lint
    warnings."""
    out = []
    for seed in range(2):
        rng = random.Random(70 + seed)
        h = js.register_history(rng, n_ops=n_ops, n_procs=4, overlap=4,
                                crash_p=0.05, max_crashes=3, n_values=3)
        out.append((f"cas-{seed}", h, "cas_register", ()))
        out.append((f"cas-bad-{seed}", js.corrupt_read(rng, h, at=0.7),
                    "cas_register", ()))
        h = js.register_history(rng, n_ops=n_ops, n_procs=4, overlap=4,
                                cas=False, unique_writes=True)
        out.append((f"register-{seed}", _stale_index(h), "register", (0,)))
        out.append((f"register-swap-{seed}", js.swap_read_values(rng, h),
                    "register", (0,)))
        out.append((f"mutex-{seed}", js.sim_mutex_history(
            rng, n_ops, 4, crash_p=0.05, max_crashes=3), "mutex", ()))
        for fifo in (False, True):
            f = "fifo_queue" if fifo else "unordered_queue"
            h = js.sim_queue_history(rng, n_ops, 4, crash_p=0.02, fifo=fifo)
            out.append((f"{f}-{seed}", h, f, (16,)))
            out.append((f"{f}-thin-air-{seed}",
                        js.corrupt_dequeue(rng, h), f, (16,)))
            out.append((f"{f}-swap-{seed}", js.swap_dequeues(rng, h), f,
                        (16,)))
    return out


SMALL = _cases(18)
LARGE = _cases(70)
#: the deterministic routes above the threshold, on every other case;
#: the queue histories' device search (the torch step at state width
#: 16) is compared at a smaller size in tests/test_torch_dpor.py
DETERMINISTIC = [c for c in LARGE[::2] if "queue" not in c[0]]


def _check_both(h, factory, args, tmp_path, **kw):
    mj, mt = encoded(h, factory, *args)[1::2]
    oj = lin.linearizable(mj, **kw).check(
        {"name": "j", "store_base": str(tmp_path / "j")}, h)
    ot = tlin.linearizable(mt, device="cpu", **kw).check(
        {"name": "t", "store_base": str(tmp_path / "t")}, to_port(h))
    return oj, ot


@pytest.mark.parametrize("label,h,factory,args", SMALL,
                         ids=[c[0] for c in SMALL])
def test_default_route_under_the_threshold(label, h, factory, args,
                                           tmp_path):
    oj, ot = _check_both(h, factory, args, tmp_path)
    assert len(encoded(h, factory, *args)[2]) <= 48
    assert {k: ot.get(k) for k in KEYS} == {k: oj.get(k) for k in KEYS}


@pytest.mark.parametrize("algorithm", ["device", "linear", "host"])
@pytest.mark.parametrize("label,h,factory,args", DETERMINISTIC,
                         ids=[c[0] for c in DETERMINISTIC])
def test_deterministic_routes_above_the_threshold(label, h, factory, args,
                                                  algorithm, tmp_path):
    oj, ot = _check_both(h, factory, args, tmp_path, algorithm=algorithm)
    assert {k: ot.get(k) for k in KEYS} == {k: oj.get(k) for k in KEYS}


@pytest.mark.parametrize("label,h,factory,args", LARGE,
                         ids=[c[0] for c in LARGE])
def test_race_above_the_threshold(label, h, factory, args, tmp_path):
    oj, ot = _check_both(h, factory, args, tmp_path)
    assert len(encoded(h, factory, *args)[2]) > 48
    assert ot["valid"] == oj["valid"]
    assert ot["engine"].startswith("competition(") \
        or ot["engine"] == oj["engine"]
    assert ot.get("lint_warnings") == oj.get("lint_warnings")
    assert ("hb" in ot, "constraints" in ot) == \
        ("hb" in oj, "constraints" in oj)
    if ot["engine"] == oj["engine"]:
        assert {k: ot.get(k) for k in KEYS if k != "configs"} == \
            {k: oj.get(k) for k in KEYS if k != "configs"}


def test_cases_reach_each_outcome(tmp_path):
    """The cases above cover the prepass's decisions, its undecided
    prune, and warnings riding the result."""
    seen = set()
    for label, h, factory, args in SMALL + LARGE[::2]:
        mt = encoded(h, factory, *args)[3]
        out = tlin.linearizable(mt, device="cpu", algorithm="linear").check(
            {"store_base": str(tmp_path)}, to_port(h))
        stats = out.get("hb") or out.get("constraints") or {}
        seen.add(("decided", stats.get("decided")))
        if out.get("lint_warnings"):
            seen.add("warnings")
    assert {("decided", True), ("decided", False), ("decided", None),
            "warnings"} <= seen


def test_opseq_input_lints_its_columns(tmp_path):
    """An OpSeq passed to the checker is linted by columns, as in the
    reference; its result carries no event-level warnings."""
    label, h, factory, args = SMALL[2]
    sj, mj, st, mt = encoded(h, factory, *args)
    oj = lin.linearizable(mj).check({"store_base": str(tmp_path)}, sj)
    ot = tlin.linearizable(mt, device="cpu").check(
        {"store_base": str(tmp_path)}, st)
    assert {k: ot.get(k) for k in KEYS} == {k: oj.get(k) for k in KEYS}
    assert "lint_warnings" not in ot


def test_invalid_decided_history_reports_like_reference(tmp_path):
    """A history the prepass decides invalid, above the threshold with
    ``algorithm="device"``: the reference confirms on the failure
    prefix, and the port does the same (no search configs)."""
    h = js.sim_mutex_history(random.Random(3), 60, 4)
    h = h + [jh.invoke_op(9, "acquire", None), jh.ok_op(9, "acquire", None),
             jh.invoke_op(10, "acquire", None),
             jh.ok_op(10, "acquire", None)]
    oj, ot = _check_both(h, "mutex", (), tmp_path, algorithm="device")
    assert {k: ot.get(k) for k in KEYS} == {k: oj.get(k) for k in KEYS}
    assert ot["valid"] is False
    assert ("report_file" in ot) == ("report_file" in oj)
