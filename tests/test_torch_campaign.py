"""The port's live campaigns (``jepsen_tpu_torch/live/{backend,matrix,
campaign,__main__}.py``) against the JAX package's: the cases of
``tests/test_live.py`` that use the backends, the matrix, the campaign
or the links, ``tests/test_obs.py``'s phase times and
``tests/test_constraints.py``'s total-queue grading, as differentials.

Plans, rendered plans, the matrix, the seeded table, the families'
command lines, ``cell_budget`` and the graders (detection, latency,
phases, recovery) are compared exactly.  A live campaign runs both
packages at once, each on ports of its own drawn below the kernel's
ephemeral range (outside the JAX package's 18000-18799) and a data root
under ``tmp_path``; real processes differ run to run, so their verdicts,
audits and grades are compared, not their op counts or walls.  The
port's cells check on the CPU (``device: cpu``).  No test here changes
the host's network: each package's engine pick is seeded (no ``tc``
probe), and the link cell runs a recording engine in both packages."""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from dataclasses import replace as dc_replace
from types import SimpleNamespace

import pytest

from jepsen_tpu import history as jhistory
from jepsen_tpu.live import backend as jbackend
from jepsen_tpu.live import campaign as jcampaign
from jepsen_tpu.live import links as jlinks
from jepsen_tpu.live import matrix as jmatrix
from jepsen_tpu_torch import history as thistory
from jepsen_tpu_torch.live import backend as tbackend
from jepsen_tpu_torch.live import campaign as tcampaign
from jepsen_tpu_torch.live import links as tlinks
from jepsen_tpu_torch.live import matrix as tmatrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": SimpleNamespace(backend=jbackend, campaign=jcampaign,
                               links=jlinks, matrix=jmatrix,
                               history=jhistory, name="jepsen_tpu"),
        "torch": SimpleNamespace(backend=tbackend, campaign=tcampaign,
                                 links=tlinks, matrix=tmatrix,
                                 history=thistory,
                                 name="jepsen_tpu_torch")}
NO_ENGINE = "no link rule engine here (seeded)"


@pytest.fixture(autouse=True)
def _seeded_engine_pick(monkeypatch):
    """Both packages' link-engine pick seeded alike, so that no planner
    here runs the ``tc`` probe (it adds and deletes a qdisc on ``lo``),
    and the JAX package's pass knobs unset."""
    for P in PKGS.values():
        monkeypatch.setattr(P.links, "_pick_cache", {
            "drop": (None, NO_ENGINE), "degrade": (None, NO_ENGINE)})
    for knob in ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
                 "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_SHRINK"):
        monkeypatch.delenv(knob, raising=False)


def _same(fn):
    out = {name: fn(P) for name, P in PKGS.items()}
    assert out["torch"] == out["jax"], out
    return out["torch"]


# ---------------------------------------------------------------------------
# the plan, the matrix and the command line: nothing spawned
# ---------------------------------------------------------------------------


def test_plan_covers_full_matrix_with_skip_reasons():
    cells = _same(lambda P: P.campaign.plan())
    fams = set(tbackend.FAMILIES)
    nems = set(tmatrix.standard_matrix())
    assert len(fams) >= 3 and len(nems) >= 4
    base = [c for c in cells if not c["seeded"]]
    assert {(c["family"], c["nemesis"]) for c in base} \
        == {(f, n) for f in fams for n in nems}
    for c in cells:
        assert c["skip"] is None or isinstance(c["skip"], str)
    assert all(c["skip"] is None for c in base
               if c["nemesis"] == "kill-restart")
    out = _same(lambda P: P.campaign.render_plan(P.campaign.plan()))
    for name in fams | nems:
        assert name in out


@pytest.mark.parametrize("args", [
    [], ["--no-seeded"], ["--families", "register,replicated", "--nemeses",
                          "kill-restart"],
    ["--families", "kv,lock", "--nemeses", "pause,clock-skew"]])
def test_campaign_cli_dry_run_spawns_nothing(capsys, args):
    """``--dry-run`` (JSON and text) prints the JAX package's plan and its
    rendering, in process; nothing starts and no card is needed."""
    from jepsen_tpu.live import __main__ as jcli
    from jepsen_tpu_torch.live import __main__ as tcli

    for fmt in (["--json"], []):
        out = {}
        for name, cli in (("jax", jcli), ("torch", tcli)):
            assert cli.main(["--dry-run", *fmt, *args]) == 0
            out[name] = capsys.readouterr().out
        assert out["torch"] == out["jax"]
    cells = json.loads(_dry(tcli, capsys, args))
    assert {"family", "nemesis", "skip"} <= set(cells[0])


def _dry(cli, capsys, args):
    assert cli.main(["--dry-run", "--json", *args]) == 0
    return capsys.readouterr().out


def test_campaign_plan_constant_is_the_reference_plan(capsys):
    """``chip_smoke.CAMPAIGN_PLAN``: the (family, nemesis, seeded) cells
    of the card phase's command, as the JAX package's ``plan()`` and the
    port's ``--dry-run`` give them (skip reasons aside: they follow the
    host)."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from jepsen_tpu_torch.live import __main__ as tcli

    cmd = list(cs.CAMPAIGN_CMD)
    fams = cmd[cmd.index("--families") + 1].split(",")
    nems = cmd[cmd.index("--nemeses") + 1].split(",")
    ref = tuple((c["family"], c["nemesis"], c["seeded"])
                for c in jcampaign.plan(fams, nems))
    assert ref == cs.CAMPAIGN_PLAN
    cells = json.loads(_dry(tcli, capsys, cmd))
    assert tuple((c["family"], c["nemesis"], c["seeded"])
                 for c in cells) == cs.CAMPAIGN_PLAN
    assert all(c["skip"] is None for c in cells)


def test_unknown_nemesis_probe_reason_rendering():
    import shutil

    cells = _same(lambda P: P.campaign.plan(
        families=["kv"], nemeses=["clock-skew"], seeded=False))
    assert len(cells) == 1
    if shutil.which("faketime") is None:
        assert "faketime" in cells[0]["skip"]
    else:
        assert cells[0]["skip"] is None
    for P in PKGS.values():
        with pytest.raises(ValueError):
            P.campaign.plan(families=["nope"])
        with pytest.raises(ValueError):
            P.campaign.plan(nemeses=["nope"])


def test_cli_flags_are_the_reference_flags_and_four_more(capsys):
    from jepsen_tpu.live import __main__ as jcli
    from jepsen_tpu_torch.live import __main__ as tcli

    flags = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        with pytest.raises(SystemExit):
            cli.main(["--help"])
        flags[name] = {w.strip(",[") for w in capsys.readouterr().out.split()
                       if w.startswith("--")}
    assert flags["torch"] - flags["jax"] == {
        "--device", "--lin-algorithm", "--data-root", "--base-port"}
    assert flags["jax"] <= flags["torch"]


def test_cli_without_a_card_exits_254_and_starts_nothing(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.live", "--families",
         "register", "--nemeses", "kill-restart", "--time-limit", "1",
         "--store-base", str(tmp_path / "store"), "--data-root",
         str(tmp_path / "nodes")], capture_output=True, text=True,
        cwd=REPO, timeout=120)
    assert r.returncode == 254, (r.stdout, r.stderr)
    assert "--device cuda" in r.stderr and "is_available" in r.stderr
    assert not (tmp_path / "store").exists()
    assert not (tmp_path / "nodes").exists()


def test_matrix_and_seeded_table_as_reference():
    rows = _same(lambda P: [
        (n, e.final, e.probe.__name__, e.name)
        for n, e in P.matrix.standard_matrix().items()])
    assert [r[0] for r in rows][:5] == ["kill-restart", "pause",
                                        "clock-skew", "partition",
                                        "disk-faults"]
    assert tcampaign.SEEDED == jcampaign.SEEDED
    fams = _same(lambda P: [
        (n, type(b).__name__, b.base_port, list(b.nodes), b.peer_linked,
         getattr(b, "status_port_offset", None),
         getattr(b, "oplog_name", None))
        for n, b in P.backend.FAMILIES.items()])
    assert [f[0] for f in fams] == ["register", "lock", "kv", "queue",
                                    "replicated", "replicated-queue",
                                    "pgwire"]
    # each row applies to the families the reference's does
    _same(lambda P: [[e.available(b) for b in P.backend.FAMILIES.values()]
                     for e in P.matrix.standard_matrix().values()])
    _same(lambda P: [P.campaign._fault_fs(n)
                     for n in P.matrix.standard_matrix()])


def test_matrix_cadences_as_reference():
    """Each row's nemesis ops during the workload and its healing op:
    the same (f, sleep) sequence from both packages' generators."""
    def cadence(P, opts):
        out = {}
        for name, e in P.matrix.standard_matrix().items():
            it = e.during(opts)._iter
            steps = []
            for _ in range(8):
                x = next(it)
                steps.append(x if isinstance(x, dict)
                             else (type(x).__name__, x.f()))
            out[name] = (steps, e.final)
        return out

    for opts in ({}, {"kill_every": 1.2, "part_every": 1.5,
                      "pause_every": 3, "skew_every": 4, "disk_every": 5}):
        _same(lambda P: cadence(P, opts))


def test_assembled_cells_as_reference(tmp_path):
    """``matrix.assemble`` of every family and row: the same test map
    (its name, nodes, ports, concurrency, model, stream route and
    nemesis), the port's with ``audit`` in it as the cell sets it."""
    def shape(P, root):
        out = []
        for fname, fam in P.backend.FAMILIES.items():
            for nname, e in P.matrix.standard_matrix().items():
                t = P.matrix.assemble(fam, e, {
                    "data_root": os.path.join(root, fname), "audit": True,
                    "time_limit": 3})
                m = t.get("model")
                out.append((t["name"], t["nodes"], t["base_port"],
                            t["concurrency"], t.get("stream_fold"),
                            type(t["nemesis"]).__name__,
                            type(t["client"]).__name__,
                            sorted(t["checker"].checkers)
                            if hasattr(t["checker"], "checkers") else None,
                            None if m is None else (m.name, m.init),
                            t["audit"]))
        return out

    got = {n: shape(P, str(tmp_path / n)) for n, P in PKGS.items()}
    assert got["torch"] == got["jax"]


def test_every_family_spawns_a_port_daemon(tmp_path):
    """Each family's server command line names a ``jepsen_tpu_torch``
    module, and is the JAX package's with that one word changed (seeded
    modes on)."""
    test = {"nodes": ["n1", "n2", "n3"], "data_root": str(tmp_path),
            "lock_volatile": True, "kv_volatile": True,
            "queue_volatile": True, "replicated_volatile": True,
            "replicated_split_brain": True, "rqueue_volatile": True}
    for name, fam in tbackend.FAMILIES.items():
        for node in test["nodes"]:
            argv = fam.server_argv(test, node)
            ref = jbackend.FAMILIES[name].server_argv(test, node)
            mod = argv[argv.index("-m") + 1]
            assert mod.startswith("jepsen_tpu_torch."), (name, argv)
            assert mod.split(".", 1)[1] == \
                ref[ref.index("-m") + 1].split(".", 1)[1]
            assert argv[:argv.index("-m") + 1] == [sys.executable, "-m"]
            assert [a for a in argv if a != mod] == \
                [a for a in ref if a != ref[ref.index("-m") + 1]]
            __import__(mod)


def test_faketime_wrap_unwrap_idempotent(tmp_path):
    from jepsen_tpu import control as jcontrol
    from jepsen_tpu import faketime as jft
    from jepsen_tpu_torch import control as tcontrol
    from jepsen_tpu_torch import faketime as tft

    out = {}
    for name, control, faketime in (("jax", jcontrol, jft),
                                    ("torch", tcontrol, tft)):
        d = tmp_path / name
        d.mkdir()
        sess = control.Session(node="n1", remote=control.LocalRemote())
        cmd = str(d / "server.sh")
        with open(cmd, "w") as f:
            f.write("#!/bin/sh\necho original\n")
        os.chmod(cmd, 0o755)
        steps = []
        faketime.wrap(sess, cmd, 120, 1.5)
        steps.append((faketime.wrapped(sess, cmd),
                      open(cmd).read().replace(str(d), "D"),
                      open(f"{cmd}.no-faketime").read()))
        faketime.wrap(sess, cmd, 240, 2.0)
        steps.append((open(cmd).read().replace(str(d), "D"),
                      open(f"{cmd}.no-faketime").read()))
        steps.append((faketime.unwrap(sess, cmd), faketime.wrapped(sess, cmd),
                      open(cmd).read()))
        steps.append((faketime.unwrap(sess, cmd), open(cmd).read()))
        out[name] = steps
    assert out["torch"] == out["jax"]
    assert out["torch"][0][0] is True and "faketime" in out["torch"][0][1]
    assert out["torch"][2] == (True, False, "#!/bin/sh\necho original\n")
    assert out["torch"][3] == (False, "#!/bin/sh\necho original\n")


def test_cell_budget_scales_with_time_limit():
    for opts in ({}, {"cell_budget": 42}, {"time_limit": 8},
                 {"time_limit": 60}, {"time_limit": 2.5},
                 {"cell_budget": 0, "time_limit": 30}):
        assert tcampaign.cell_budget(opts) == jcampaign.cell_budget(opts)
    assert tcampaign.cell_budget({"time_limit": 60}) == 690.0


# ---------------------------------------------------------------------------
# the graders on the same histories
# ---------------------------------------------------------------------------


def _nem(P, f, t, value=None):
    return P.history.Op(process="nemesis", type="info", f=f, value=value,
                        time=int(t * 1e9))


def test_phase_times_from_history():
    def run(P):
        test = {"phase_s": {"setup": 2.0, "workload": 9.0, "check": 1.0},
                "history": [_nem(P, "kill", 1.0), _nem(P, "kill", 1.5),
                            _nem(P, "restart", 2.0),
                            _nem(P, "restart", 2.25)]}
        return (P.campaign._phase_times(test, "kill-restart"),
                P.campaign._phase_times({"history": []}, "pause"),
                P.campaign._phase_times(test, "link-bridge"))

    ph = _same(run)[0]
    assert (ph["setup"], ph["workload"], ph["check"]) == (2.0, 9.0, 1.0)
    assert ph["nemesis"] == pytest.approx(0.5)
    assert ph["heal"] == pytest.approx(0.25)


def _client_history(P, seed, n=60):
    """A history of client ops on a register around two kills, with the
    nemesis' completions carrying the killed nodes."""
    rng = random.Random(seed)
    h, t = [], 0.0
    for i in range(n):
        t += rng.uniform(0.01, 0.2)
        if i in (10, 35):
            h.append(_nem(P, "kill", t))
            h.append(_nem(P, "kill", t + 0.01, ["n1"]))
            t += 0.02
        p = rng.randrange(6)
        key = rng.randrange(3)
        v = P.history.Op(process=p, type="invoke", f="write",
                         value=rng.randrange(5), time=int(t * 1e9))
        h.append(v)
        t += rng.uniform(0.001, 0.05)
        h.append(dc_replace(v, type=rng.choice(["ok", "ok", "info", "fail"]),
                            time=int(t * 1e9)))
        if rng.random() < 0.3:
            from jepsen_tpu import independent as ji
            from jepsen_tpu_torch import independent as ti

            ind = ji if P is PKGS["jax"] else ti
            h[-1] = dc_replace(h[-1], value=ind.tuple_(key, h[-1].value))
    return h


@pytest.mark.parametrize("seed", range(4))
def test_detection_recovery_grades_as_reference(seed):
    def grade(P):
        h = _client_history(P, seed)
        inv = 20 + seed
        sres = {"valid": False, "stream": {"invalid_event": inv,
                                           "events": len(h),
                                           "first_verdict_event": 3,
                                           "family": "total-queue"}}
        fin = {"valid": False, "stream": {"events": len(h)}}
        out = []
        for nem in ("kill-restart", "link-bridge", "pause"):
            out.append(P.campaign._detection(
                {"history": h, "stream_results": sres}, nem))
            out.append(P.campaign._detection(
                {"history": h, "stream_results": fin}, nem))
            out.append(P.campaign._detection(
                {"history": h, "results": {"valid": False}}, nem))
            out.append(P.campaign._detection(
                {"history": h, "results": {"valid": True}}, nem))
        for fam in ("register", "replicated", "kv"):
            out.append(P.campaign._recovery(
                {"history": h, "nodes": ["n1", "n2", "n3"],
                 "concurrency": 6,
                 "__live_backend__": P.backend.FAMILIES[fam]}))
        out.append(P.campaign._recovery({"history": h}))
        return out

    got = _same(grade)
    assert got[0]["at"] == "streamed" and "latency_s" in got[0]
    assert got[1]["at"] == "finalize"
    assert got[2] == {**got[2], "at": "finalize", "source": "post-hoc"}


def test_seeded_replicated_queue_cell_grades_streamed():
    """A lost-acked-enqueue history (acked ADDJOBs missing from the final
    drain) through each package's total-queue fold and the campaign's
    grader: ``streamed`` at the drain event, the same detection."""
    from jepsen_tpu.checker import basic as jbasic
    from jepsen_tpu.stream.checker import TotalFoldStream as JFold
    from jepsen_tpu_torch.checker import basic as tbasic
    from jepsen_tpu_torch.stream.checker import TotalFoldStream as TFold

    def run(P, Fold, basic):
        H = P.history
        sink = Fold("total-queue")
        hist = []
        t = 0

        def feed(op):
            nonlocal t
            t += 100_000_000
            op = dc_replace(op, index=len(hist), time=t)
            hist.append(op)
            sink.ingest(op)

        for j in range(30):
            feed(H.invoke_op(j % 4, "enqueue", j))
            feed(H.ok_op(j % 4, "enqueue", j))
        feed(H.info_op("nemesis", "start", None))
        feed(H.info_op("nemesis", "start", ["n1", "n2"]))
        feed(H.invoke_op(0, "drain", None))
        feed(H.ok_op(0, "drain", [j for j in range(30) if j not in (4, 9)]))
        final = sink.finalize(audit=True)
        post = basic.total_queue().check(
            {}, [op for op in hist if isinstance(op.process, int)])
        det = P.campaign._detection(
            {"history": hist, "stream_results": final, "results": post},
            "link-bridge")
        return (final["valid"], post["valid"], sorted(post["lost"]),
                final["queue_evidence"]["kind"], final["audit"]["ok"], det)

    got = {"jax": run(PKGS["jax"], JFold, jbasic),
           "torch": run(PKGS["torch"], TFold, tbasic)}
    assert got["torch"] == got["jax"]
    det = got["torch"][-1]
    assert det["at"] == "streamed" and det["fold"] == "total-queue"
    assert det["fault_event"] < det["invalid_event"]


def test_queue_backends_declare_fold_route(tmp_path):
    for fam in ("queue", "replicated-queue"):
        got = _same(lambda P: (
            P.backend.FAMILIES[fam].workload({}).get("stream_fold"),
            P.backend.FAMILIES[fam].build_test(
                {"data_root": str(tmp_path / P.name)}).get("stream_fold")))
        assert got == ("total-queue", "total-queue"), fam


# ---------------------------------------------------------------------------
# the campaign runner over fake cells
# ---------------------------------------------------------------------------


def _resume_case(P, tmp_path, monkeypatch):
    executed = []
    arm = {"die_at": 2}

    def fake_run_cell(cell, opts):
        executed.append((cell["family"], cell["nemesis"]))
        if len(executed) == arm["die_at"]:
            raise KeyboardInterrupt("campaign killed")
        return {**cell, "status": "ok", "valid": True, "ops": 1}

    monkeypatch.setattr(P.campaign, "run_cell", fake_run_cell)
    opts = {"store_base": str(tmp_path / P.name), "campaign_id": "c1",
            "cell_retries": 0}
    fams = ["register", "kv", "lock"]
    with pytest.raises(KeyboardInterrupt):
        P.campaign.run_campaign(opts, families=fams,
                                nemeses=["kill-restart"], seeded=False)
    d = os.path.join(opts["store_base"], "campaigns", "c1")
    with open(os.path.join(d, "cells.jsonl")) as f:
        recorded = [json.loads(x) for x in f if x.strip()]
    first = list(executed)
    executed.clear()
    arm["die_at"] = -1
    record = P.campaign.run_campaign(opts, families=fams,
                                     nemeses=["kill-restart"], seeded=False,
                                     resume=True)
    second = list(executed)
    with open(os.path.join(d, "cells.jsonl"), "a") as f:
        f.write(json.dumps({"family": "register", "nemesis": "kill-restart",
                            "seeded": False, "skip": None,
                            "status": "failed",
                            "reason": "RuntimeError: transient"}) + "\n")
    executed.clear()
    record2 = P.campaign.run_campaign(opts, families=fams,
                                      nemeses=["kill-restart"],
                                      seeded=False, resume=True)
    return (recorded, first, second, list(executed),
            {k: v for k, v in record.items() if k != "id"},
            {k: v for k, v in record2.items() if k != "id"})


def test_campaign_resume_skips_completed_cells(tmp_path, monkeypatch):
    got = _same(lambda P: _resume_case(P, tmp_path, monkeypatch))
    recorded, first, second, third, record, record2 = got
    assert len(recorded) == 1 and len(first) == 2 and len(second) == 2
    assert recorded[0]["family"] not in {f for f, _ in second}
    assert record["resumed_cells"] == 1 and len(record["cells"]) == 3
    assert third == [("register", "kill-restart")]
    assert record2["resumed_cells"] == 2


def test_campaign_retries_harness_errors_not_verdicts(tmp_path,
                                                      monkeypatch):
    def case(P):
        calls = {"register": 0, "kv": 0}

        def fake_run_cell(cell, opts):
            calls[cell["family"]] += 1
            if cell["family"] == "register" and calls["register"] == 1:
                return {**cell, "status": "failed",
                        "reason": "RuntimeError: transient"}
            if cell["family"] == "kv":
                return {**cell, "status": "ok", "valid": False}
            return {**cell, "status": "ok", "valid": True}

        monkeypatch.setattr(P.campaign, "run_cell", fake_run_cell)
        record = P.campaign.run_campaign(
            {"store_base": str(tmp_path / P.name), "cell_retries": 2},
            families=["register", "kv"], nemeses=["kill-restart"],
            seeded=False)
        return calls, [(c["family"], c["status"], c.get("valid"),
                        c["attempts"]) for c in record["cells"]], \
            record["summary"]

    calls, cells, _summary = _same(case)
    assert calls == {"register": 2, "kv": 1}
    assert cells == [("register", "ok", True, 2), ("kv", "ok", False, 1)]


def test_completed_cells_and_retry_policy_as_reference(tmp_path):
    lines = [{"family": "kv", "nemesis": "pause", "seeded": False,
              "skip": None, "status": s, **extra}
             for s, extra in (("failed", {}), ("skipped", {}),
                              ("skipped", {"skip": "no faketime"}),
                              ("ok", {"valid": False}))]
    d = tmp_path / "c"
    d.mkdir()
    for i in range(len(lines) + 1):
        with open(d / "cells.jsonl", "w") as f:
            for x in lines[:i]:
                f.write(json.dumps(x) + "\n")
            f.write("{torn")
        _same(lambda P: P.campaign.completed_cells(str(d)))
    _same(lambda P: [P.campaign._retryable(x, x) for x in lines])


def test_watchdog_escalates_on_wedged_backend(tmp_path):
    """A backend process wedged past the budget (SIGSTOP'd) is thawed,
    terminated and, if need be, SIGKILLed; the watchdog records it."""
    d = tmp_path / "nodes" / "n1"
    d.mkdir(parents=True)
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(600)"])
    (d / "server.pid").write_text(str(p.pid))
    os.kill(p.pid, signal.SIGSTOP)
    try:
        wd = tcampaign._Watchdog(0.2, str(tmp_path / "nodes"),
                                 grace_s=0.3, resweep_s=0.2,
                                 label="wedged").start()
        deadline = time.monotonic() + 15
        while p.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        wd.stop()
        assert p.poll() is not None, "watchdog never killed the pid"
        assert wd.fired and p.pid in wd.killed
    finally:
        try:
            os.kill(p.pid, signal.SIGKILL)
        except OSError:
            pass
        p.wait(timeout=5)
    # a watchdog stopped inside its budget never fires
    wd = tcampaign._Watchdog(60, str(tmp_path / "nodes")).start()
    wd.stop()
    assert not wd.fired and wd.killed == []


# ---------------------------------------------------------------------------
# run_cell's outcomes: the skip narrowing and the audit key
# ---------------------------------------------------------------------------


def _raising_core(exc):
    def run(test):
        raise exc
    return run


_DEVICE_CASES = ("device-fold", "cuda-launch", "kernel-launch", "chained")


@pytest.mark.parametrize("case", [
    *_DEVICE_CASES, "never-came-up", "worker-abort", "remote", "other"])
def test_run_cell_skips_only_a_backend_that_never_came_up(
        tmp_path, monkeypatch, case):
    """A failed device fold or a CUDA launch error (both RuntimeErrors)
    is the cell's failure, with its traceback; only a server that never
    came up (``BackendStartError``), a worker abort and the control
    plane's error skip.  A failure of the device, wherever it lies in
    the exception's chain, is marked ``device_error`` and never
    retried.  The JAX package skips every RuntimeError
    (``campaign.py:465-470``) and retries every failure: the
    differences are in ``ROADMAP.md`` §C."""
    from jepsen_tpu_torch import control, core
    from jepsen_tpu_torch.stream.device import DeviceFoldError
    from jepsen_tpu_torch.util import WorkerAbort

    def chained():
        try:
            raise RuntimeError("CUDA error: unspecified launch failure")
        except RuntimeError as e:
            try:
                raise KeyError("results") from e
            except KeyError as k:
                return k

    exc = {"device-fold": DeviceFoldError("fold of segment 3 failed on "
                                          "the card"),
           "cuda-launch": RuntimeError("CUDA error: an illegal memory "
                                       "access was encountered"),
           "kernel-launch": RuntimeError("level_loop launch failed: "
                                         "too many resources requested "
                                         "for launch (7)"),
           "chained": chained(),
           "never-came-up": tbackend.BackendStartError(
               "live register server on n1 (:1) never came up"),
           "worker-abort": WorkerAbort("worker aborted"),
           "remote": control.RemoteError("start-stop-daemon", 127, "",
                                         "not found"),
           "other": ValueError("bad")}[case]
    monkeypatch.setattr(core, "run", _raising_core(exc))
    cell = {"family": "register", "nemesis": "kill-restart",
            "seeded": False, "skip": None}
    out = tcampaign.run_cell(cell, {"data_root": str(tmp_path / "n"),
                                    "store_base": str(tmp_path / "s"),
                                    "device": "cpu"})
    skipped = case in ("never-came-up", "worker-abort", "remote")
    assert out["status"] == ("skipped" if skipped else "failed"), out
    if skipped:
        assert "traceback" not in out
    else:
        assert out["reason"].startswith(type(exc).__name__)
        assert type(exc).__name__ in out["traceback"]
    # the retry policy re-runs a harness failure and a runtime skip
    # alike, and never a failure of the device
    device = case in _DEVICE_CASES
    assert out.get("device_error", False) is device, out
    assert tcampaign._retryable(cell, out) is not device
    if case in ("device-fold", "cuda-launch"):
        from jepsen_tpu import core as jcore

        monkeypatch.setattr(jcore, "run", _raising_core(RuntimeError(
            str(exc))))
        ref = jcampaign.run_cell(cell, {"data_root": str(tmp_path / "j"),
                                        "store_base": str(tmp_path / "s")})
        assert ref["status"] == "skipped"  # the reference hides it


def test_campaign_never_retries_a_device_failure(tmp_path, monkeypatch):
    """A cell whose device fold failed runs once, with retries left, and
    stays ``failed``; a harness failure beside it is retried."""
    from jepsen_tpu_torch import core
    from jepsen_tpu_torch.stream.device import DeviceFoldError

    calls = []

    def run(test):
        calls.append(test["name"])
        if "register" in test["name"]:
            raise DeviceFoldError("fold of segment 3 failed on the card")
        raise ValueError("harness")

    monkeypatch.setattr(core, "run", run)
    record = tcampaign.run_campaign(
        {"store_base": str(tmp_path / "s"), "data_root": str(tmp_path / "n"),
         "cell_retries": 2, "device": "cpu"},
        families=["register", "kv"], nemeses=["kill-restart"], seeded=False)
    assert calls == ["live-register-kill-restart",
                     *["live-kv-kill-restart"] * 3]
    assert [(c["family"], c["status"], c.get("device_error", False),
             c["attempts"]) for c in record["cells"]] == [
        ("register", "failed", True, 1), ("kv", "failed", False, 3)]


@pytest.mark.parametrize("pinned", [True, False])
def test_campaign_start_sweeps_only_its_own_root(tmp_path, monkeypatch,
                                                 pinned):
    """A campaign given a data root sweeps that root's journal at start
    and leaves the shared default tree alone; one given none sweeps the
    default tree.  The JAX package sweeps the default tree always
    (``ROADMAP.md`` §C)."""
    swept = []
    monkeypatch.setattr(tcampaign.links_mod, "sweep",
                        lambda root, engine=None: swept.append(
                            ("root", root)) or 0)
    monkeypatch.setattr(tcampaign.links_mod, "sweep_tree",
                        lambda *a, **k: swept.append(("tree",) + a) or 0)
    monkeypatch.setattr(tcampaign, "run_cell",
                        lambda cell, opts: {**cell, "status": "ok",
                                            "valid": True})
    opts = {"store_base": str(tmp_path / "s")}
    if pinned:
        opts["data_root"] = str(tmp_path / "n")
    tcampaign.run_campaign(opts, families=["register"],
                           nemeses=["kill-restart"], seeded=False)
    assert swept == ([("root", str(tmp_path / "n"))] if pinned
                     else [("tree",)])


def test_run_cell_carries_audit_in_the_test_map(tmp_path, monkeypatch):
    """The cell's ``audit`` (default on) rides the test map that every
    checker reads; no environment variable is written."""
    from jepsen_tpu_torch import core

    seen = []

    def run(test):
        seen.append({k: test.get(k) for k in ("audit", "stream", "device",
                                              "lin_algorithm")})
        raise ValueError("stop here")

    monkeypatch.setattr(core, "run", run)
    env = dict(os.environ)
    cell = {"family": "kv", "nemesis": "pause", "seeded": False,
            "skip": None}
    for opts in ({}, {"audit": False}, {"lin_algorithm": "device"}):
        tcampaign.run_cell(cell, {"data_root": str(tmp_path),
                                  "device": "cpu", **opts})
    assert seen == [
        {"audit": True, "stream": True, "device": "cpu",
         "lin_algorithm": None},
        {"audit": False, "stream": True, "device": "cpu",
         "lin_algorithm": None},
        {"audit": True, "stream": True, "device": "cpu",
         "lin_algorithm": "device"}]
    assert dict(os.environ) == env


def test_web_campaign_grid(tmp_path):
    """The campaign pages of both packages' web servers, byte for byte,
    on one store."""
    from jepsen_tpu import web as jweb
    from jepsen_tpu_torch import web as tweb

    base = str(tmp_path / "store")
    d = os.path.join(base, "campaigns", "20260804T000000")
    os.makedirs(d)
    record = {
        "id": "20260804T000000",
        "summary": {"ok": 2, "skipped": 1, "failed": 0, "detected": 1,
                    "audited_ok": 2},
        "cells": [
            {"family": "register", "nemesis": "kill-restart",
             "seeded": False, "status": "ok", "valid": True,
             "store": base + "/live-register/20260804T000001"},
            {"family": "lock", "nemesis": "kill-restart",
             "seeded": True, "status": "ok", "valid": False,
             "detection": {"latency_s": 1.5},
             "store": base + "/live-lock/20260804T000002"},
            {"family": "lock", "nemesis": "clock-skew",
             "seeded": False, "status": "skipped",
             "reason": "no `faketime` binary on PATH"},
        ],
    }
    with open(os.path.join(d, "campaign.json"), "w") as f:
        json.dump(record, f)
    pages = {}
    for name, web in (("jax", jweb), ("torch", tweb)):
        srv = web.make_server(host="127.0.0.1", port=0, base=base)
        port = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            pages[name] = [urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30).read().decode()
                for path in ("/", "/campaigns",
                             "/campaigns/20260804T000000")]
        finally:
            srv.shutdown()
            srv.server_close()
    assert pages["torch"] == pages["jax"]
    home, idx, grid = pages["torch"]
    assert "/campaigns" in home and "20260804T000000" in idx
    assert "kill-restart" in grid and "clock-skew" in grid
    assert "valid-true" in grid and "valid-false" in grid
    assert "detected in 1.5s" in grid and "faketime" in grid
    assert "seeded" in grid
    assert "jtpu_link_rules_swept_total" in tweb.campaigns_html(base)


# ---------------------------------------------------------------------------
# live campaigns: both packages at once, real processes
# ---------------------------------------------------------------------------


def _free_base(n: int, offset: int = 0) -> int:
    """A base port with ``n`` consecutive ports (and each ``+offset``)
    free on the nodes' loopback addresses and on 127.0.0.1, below the
    kernel's ephemeral range and outside the JAX package's 18000-18799
    band."""
    rng = random.Random()
    while True:
        base = rng.randrange(20000, 31000 - n)
        ports = [(f"127.0.1.{i + 1}", base + i) for i in range(n)]
        if offset:
            ports += [(h, p + offset) for h, p in ports]
        ports += [("127.0.0.1", p) for _, p in ports]
        socks = []
        try:
            for addr in ports:
                s = socket.socket()
                socks.append(s)
                s.bind(addr)
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
        return base


def _couldnt_start(record) -> bool:
    return any(c["status"] == "skipped" and c.get("skip") is None
               for c in record["cells"])


def _twin_campaigns(tmp_path, opts, families, nemeses, *, seeded=False,
                    nodes=3, offset=0, attempts=3):
    """Both packages' ``run_campaign`` at once, in two threads, each on
    its own ports, data root and store; a run whose node could not bind
    its port is run again on other ports."""
    out = {}

    def one(name, P):
        for i in range(attempts):
            o = dict(opts, base_port=_free_base(nodes, offset),
                     store_base=str(tmp_path / name / f"store{i}"),
                     data_root=str(tmp_path / name / f"nodes{i}"))
            if name == "torch":
                o["device"] = "cpu"
            try:
                rec = P.campaign.run_campaign(o, families=families,
                                              nemeses=nemeses,
                                              seeded=seeded)
            except BaseException as e:  # noqa: BLE001 — raised below
                out[name] = e
                return
            out[name] = (rec, o)
            if not _couldnt_start(rec):
                return

    threads = [threading.Thread(target=one, args=(n, P))
               for n, P in PKGS.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in PKGS:
        if isinstance(out[name], BaseException):
            raise out[name]
    return out


def _grades(cell) -> dict:
    """What a live cell's outcome must share across the packages."""
    audit = cell.get("audit") or {}
    return {"status": cell["status"], "valid": cell.get("valid"),
            "stream_valid": cell.get("stream_valid"),
            "audit_ok": audit.get("ok"), "audit_codes": audit.get("codes"),
            "faulted": (cell.get("faults") or 0) >= 1,
            "detected": cell.get("detection") is not None}


def test_campaign_smoke_register_kill_restart(tmp_path):
    runs = _twin_campaigns(
        tmp_path, {"time_limit": 2.5, "rate": 12, "ops_per_key": 8,
                   "group_size": 2, "nodes": ["n1", "n2"],
                   "kill_every": 1.0},
        ["register"], ["kill-restart"], nodes=2)
    grades = {}
    for name, (record, opts) in runs.items():
        assert record["summary"].get("ok") == 1, (name, record)
        [cell] = record["cells"]
        assert cell["valid"] is True, (name, cell)
        assert cell["audit"]["ok"] is True and \
            cell["audit"]["certificates"] >= 1, (name, cell)
        assert cell["faults"] >= 1 and cell["ops"] > 20, (name, cell)
        d = os.path.join(opts["store_base"], "campaigns", record["id"])
        assert os.path.isfile(os.path.join(d, "campaign.json"))
        with open(os.path.join(d, "cells.jsonl")) as f:
            lines = [json.loads(x) for x in f if x.strip()]
        assert len(lines) == 1 and lines[0]["family"] == "register"
        assert os.path.isfile(os.path.join(cell["store"], "results.json"))
        grades[name] = _grades(cell)
    assert grades["torch"] == grades["jax"]
    # the port's stored test map carries the audit key its checkers read
    with open(os.path.join(runs["torch"][0]["cells"][0]["store"],
                           "test.json")) as f:
        assert json.load(f)["audit"] is True


def test_campaign_smoke_pgwire_kill_restart(tmp_path):
    runs = _twin_campaigns(
        tmp_path, {"time_limit": 2.5, "rate": 12, "ops_per_key": 8,
                   "group_size": 2, "kill_every": 1.0},
        ["pgwire"], ["kill-restart"], nodes=1)
    grades = {}
    for name, (record, _o) in runs.items():
        assert record["summary"].get("ok") == 1, (name, record)
        [cell] = record["cells"]
        assert cell["valid"] is True, (name, cell)
        assert cell["audit"] and cell["audit"]["ok"] is True, (name, cell)
        assert cell["faults"] >= 1 and cell["ops"] > 10, (name, cell)
        grades[name] = _grades(cell)
    assert grades["torch"] == grades["jax"]


def test_campaign_smoke_replicated_partition(tmp_path):
    """replicated x partition where the host can drop a port (iptables);
    the same capability skip in both packages elsewhere."""
    reason = tmatrix.probe_iptables()
    assert reason == jmatrix.probe_iptables()
    runs = _twin_campaigns(
        tmp_path, {"time_limit": 4, "rate": 12, "lease_ms": 400,
                   "part_every": 1.5},
        ["replicated"], ["partition"])
    cells = {}
    for name, (record, _o) in runs.items():
        [cell] = [c for c in record["cells"] if not c.get("seeded")]
        if reason is not None:
            assert cell["status"] == "skipped" and cell["reason"] == reason
        else:
            assert cell["status"] == "ok", cell
            assert cell["valid"] in (True, "unknown"), cell
        cells[name] = (cell["status"], cell.get("reason"))
    assert cells["torch"] == cells["jax"]


class RecordingEngine:
    """A link engine that records its rules and installs none: a link
    cell's harness (journal, heal, sweep, verdict, corpus) without a
    change to the host's network."""

    name = "iptables"

    def __init__(self):
        self.installed = []
        self.removed = []

    def supports(self, mode):
        return None

    def install(self, rule):
        self.installed.append(dict(rule))

    def remove(self, rule):
        self.removed.append(dict(rule))
        return True

    def sweep_engine(self):
        pass


def test_campaign_smoke_replicated_link_split_one(tmp_path, monkeypatch):
    engines = {}
    for name, P in PKGS.items():
        engines[name] = RecordingEngine()
        monkeypatch.setattr(P.links, "_pick_cache", {
            "drop": ("iptables", None), "degrade": ("iptables", None)})
        monkeypatch.setitem(P.links._ENGINES, "iptables",
                            lambda e=engines[name]: e)
    runs = _twin_campaigns(
        tmp_path, {"time_limit": 3, "rate": 12, "lease_ms": 400,
                   "part_every": 1.0},
        ["replicated"], ["link-split-one"])
    grades = {}
    for name, (record, opts) in runs.items():
        [cell] = [c for c in record["cells"] if not c.get("seeded")]
        assert cell["status"] == "ok", (name, cell)
        assert cell["valid"] in (True, "unknown"), (name, cell)
        assert cell["faults"] >= 1, (name, cell)
        assert cell.get("corpus") and cell["corpus"]["pool"] >= 1, cell
        assert PKGS[name].links.journal_rules(opts["data_root"]) == []
        eng = engines[name]
        assert eng.installed and all(r["kind"] == "link"
                                     for r in eng.installed)
        assert len(eng.removed) >= len(eng.installed)
        grades[name] = _grades(cell)
    assert grades["torch"]["status"] == grades["jax"]["status"] == "ok"
    assert grades["torch"]["faulted"] and grades["jax"]["faulted"]
    from jepsen_tpu_torch.live import corpus

    pool = corpus.load_pool(corpus.corpus_dir(
        runs["torch"][1]["store_base"]))
    assert any(e["family"] == "replicated" for e in pool)


# ---------------------------------------------------------------------------
# slow: the full matrix and the seeded cells
# ---------------------------------------------------------------------------


#: the matrix rows the full-matrix twin runs: those that change nothing
#: of the host (no port rule, no FUSE mount; the link rows are in the
#: plan, skipped by the seeded engine pick)
HOST_SAFE_ROWS = [n for n in tmatrix.standard_matrix()
                  if n not in ("partition", "disk-faults")]


@pytest.mark.slow
def test_full_matrix_campaign(tmp_path):
    """Every family under every row that leaves the host as it is, in
    both packages: every executed cell an audited verdict, skipped cells
    with the same reasons, the seeded cells where their stage landed."""
    runs = _twin_campaigns(
        tmp_path, {"time_limit": 4, "rate": 15, "ops_per_key": 10},
        None, HOST_SAFE_ROWS, seeded=True)
    status = {}
    for name, (record, _o) in runs.items():
        assert len(record["families"]) >= 3
        assert len(record["nemeses"]) >= 4
        for cell in record["cells"]:
            if cell["status"] == "ok" and not cell.get("seeded"):
                assert cell["valid"] in (True, "unknown"), cell
                if cell["valid"] is True and cell.get("audit"):
                    assert cell["audit"]["ok"], cell
            elif cell["status"] == "skipped":
                assert cell["reason"], cell
        assert not [c for c in record["cells"] if c["status"] == "failed"]
        status[name] = [(c["family"], c["nemesis"], c["seeded"],
                         c["status"], c.get("reason") if c.get("skip")
                         else None) for c in record["cells"]]
    assert status["torch"] == status["jax"]


@pytest.mark.slow
@pytest.mark.parametrize("family,nemesis", [
    ("replicated", "kill-restart"), ("lock", "kill-restart")])
def test_seeded_cells_detected_as_reference(tmp_path, family, nemesis):
    """The seeded cells at the reference's settings: the port's and the
    JAX package's both ok, and an invalid verdict carries a detection
    (replicated: streamed, by the :info lookahead)."""
    runs = _twin_campaigns(tmp_path, {}, [family], [nemesis], seeded=True,
                           nodes=3 if family == "replicated" else 1)
    for name, (record, _o) in runs.items():
        [sc] = [c for c in record["cells"] if c.get("seeded")]
        assert sc["status"] == "ok", (name, sc)
        if sc["valid"] is False:
            assert sc["detection"] is not None
            if family == "replicated":
                assert sc["stream_valid"] is False
                assert sc["detection"]["at"] == "streamed", sc
        else:
            assert sc["valid"] is not None


@pytest.mark.slow
@pytest.mark.parametrize("family,nemesis", [
    ("replicated", "link-isolate-leader"),
    ("replicated-queue", "link-bridge")])
def test_seeded_link_cells_harness_as_reference(tmp_path, monkeypatch,
                                                family, nemesis):
    """The seeded link cells over a recording engine (no rule reaches the
    host, so the fault's stage is the harness only): both packages ok,
    every journaled rule swept."""
    for P in PKGS.values():
        eng = RecordingEngine()
        monkeypatch.setattr(P.links, "_pick_cache", {
            "drop": ("iptables", None), "degrade": ("iptables", None)})
        monkeypatch.setitem(P.links._ENGINES, "iptables", lambda e=eng: e)
    runs = _twin_campaigns(tmp_path, {}, [family], [nemesis], seeded=True,
                           offset=500 if family == "replicated-queue"
                           else 0)
    for name, (record, opts) in runs.items():
        [sc] = [c for c in record["cells"] if c.get("seeded")]
        assert sc["status"] == "ok", (name, sc)
        assert sc["valid"] is not None
        assert PKGS[name].links.journal_rules(opts["data_root"]) == []
