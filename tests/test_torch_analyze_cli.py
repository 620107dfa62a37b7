"""``python -m jepsen_tpu_torch.analyze`` against ``python -m
jepsen_tpu.analyze``: the same argv through both CLIs in process (the
port's with ``--device cpu``) must give the same exit code and the same
``--json`` output, for the lint of a good and a bad history, the plan on
the host, the audit of a clean and a tampered result, ``--mc`` on a
clean and a seeded pair, ``--mc --explain`` and the bad arguments that
exit 254.  Then the port's own: a real subprocess's exit code and
``--replay`` of its certificate, ``--devlint`` (not ported: 254 with its
message), and ``--device cuda`` without a card (254, with the reason)."""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

from jepsen_tpu.analyze import __main__ as jcli
from jepsen_tpu_torch import store, synth
from jepsen_tpu_torch.analyze import __main__ as tcli
from jepsen_tpu_torch.checker.seq import check_opseq
from jepsen_tpu_torch.history import encode_ops, invoke_op, ok_op
from jepsen_tpu_torch.models import cas_register

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(capsys, *argv) -> tuple:
    """(exit code, stdout) of each CLI on ``argv``; the port's gets
    ``--device cpu``."""
    rc_j = jcli.main(list(argv))
    out_j = capsys.readouterr().out
    rc_t = tcli.main([*argv, "--device", "cpu"])
    out_t = capsys.readouterr().out
    return (rc_j, out_j), (rc_t, out_t)


def same(capsys, *argv) -> tuple:
    (rc_j, out_j), (rc_t, out_t) = both(capsys, *argv)
    assert rc_t == rc_j
    if "--json" in argv:
        assert json.loads(out_t) == json.loads(out_j)
    return rc_t, out_t


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A valid register history, a corrupted one, a malformed one, a
    valid result with its linearization and that result tampered."""
    d = tmp_path_factory.mktemp("cli")
    rng = random.Random(1201)
    good = synth.register_history(rng, n_ops=60, n_procs=4, overlap=3,
                                  n_values=3)
    bad = synth.corrupt_read(rng, list(good), at=0.7)
    malformed = [ok_op(0, "read", 1), invoke_op(1, "write", 2),
                 invoke_op(1, "write", 3)]
    out = {}
    for name, h in (("good", good), ("bad", bad), ("malformed", malformed)):
        out[name] = store.write_history({"store_base": str(d),
                                         "name": name, "start_time": "t"}, h)
    model = cas_register()
    res = check_opseq(encode_ops(good, model.f_codes), model)
    assert res["valid"] is True and res["linearization"]
    tampered = dict(res, linearization=list(res["linearization"]))
    lin = tampered["linearization"]
    lin[0], lin[-1] = lin[-1], lin[0]
    for name, r in (("result", res), ("tampered", tampered)):
        out[name] = str(d / f"{name}.json")
        with open(out[name], "w") as f:
            json.dump(store._jsonable(r), f)
    return out


def test_lint_good_and_bad_history(capsys, files):
    rc, out = same(capsys, files["good"], "--json")
    assert rc == 0 and json.loads(out)["errors"] == 0
    rc, out = same(capsys, files["malformed"], "--json")
    assert rc == 1 and json.loads(out)["errors"] > 0
    rc, out = same(capsys, files["good"])
    assert rc == 0 and "0 error(s)" in out


def test_explain_on_the_host(capsys, files):
    for h in ("good", "bad"):
        rc, out = same(capsys, files[h], "--model", "cas-register",
                       "--explain", "--json")
        assert rc == 0 and json.loads(out)["plan"]["engine"]
    (_, out_j), (_, out_t) = both(capsys, files["good"], "--model",
                                  "register", "--model-arg", "0",
                                  "--explain")
    assert out_t == out_j


def test_audit_clean_and_tampered(capsys, files):
    rc, out = same(capsys, files["good"], "--model", "cas-register",
                   "--audit", files["result"], "--json")
    assert rc == 0 and json.loads(out)["audit"]["ok"]
    rc, out = same(capsys, files["good"], "--model", "cas-register",
                   "--audit", files["tampered"], "--json")
    audit = json.loads(out)["audit"]
    assert rc == 1 and not audit["ok"] and audit["codes"]
    assert all(c.startswith("W") for c in audit["codes"])


@pytest.mark.parametrize("family,mode,want", [
    ("lock", "clean", 0), ("shell-kv", "clean", 0),
    ("lock", "volatile", 1), ("shell-queue", "session-leak", 1)])
def test_mc_pairs(capsys, tmp_path, family, mode, want):
    rc, out = same(capsys, "--mc", "--mc-family", family, "--mc-mode", mode,
                   "--json")
    assert rc == want and json.loads(out)["ok"] is (want == 0)
    (rc_j, out_j), (rc_t, out_t) = both(
        capsys, "--mc", "--mc-family", family, "--mc-mode", mode)
    assert (rc_t, out_t) == (rc_j, out_j)


def test_mc_explain(capsys):
    for scope in ("core", "shell", "all"):
        rc, out = same(capsys, "--mc", "--mc-scope", scope, "--explain",
                       "--json")
        assert rc == 0 and json.loads(out)["mc_plan"]
    (_, out_j), (_, out_t) = both(capsys, "--mc", "--explain")
    assert out_t == out_j


@pytest.mark.parametrize("argv", [
    ("--no-such-flag",),
    ("--mc", "--mc-family", "lock", "--mc-mode", "split-brain"),
    ("--mc", "--mc-family", "shell-kv", "--mc-mode", "split-brain"),
    ("--mc", "--replay", "/nonexistent/cert.json"),
    (),
    ("/nonexistent/history.jsonl",),
    ("HISTORY", "--explain"),
    ("HISTORY", "--audit", "RESULT"),
    ("HISTORY", "--model", "cas-register", "--audit", "/nonexistent.json"),
    ("HISTORY", "--model", "no-such-model"),
])
def test_bad_arguments_exit_254(capsys, files, argv):
    argv = [files["good"] if a == "HISTORY" else files["result"]
            if a == "RESULT" else a for a in argv]
    (rc_j, _), (rc_t, _) = both(capsys, *argv)
    assert rc_j == rc_t == 254


def test_malformed_certificate_exits_254(capsys, tmp_path):
    p = tmp_path / "cert.json"
    p.write_text(json.dumps({"code": "MC106", "mode": "volatile"}))
    (rc_j, _), (rc_t, _) = both(capsys, "--mc", "--replay", str(p))
    assert rc_j == rc_t == 254


def test_subprocess_exit_code_and_replay(capsys, tmp_path):
    """The seeded pair pins the real process's exit code; its
    certificate replays through the port's ``--replay`` and the JAX
    package's."""
    p = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.analyze", "--mc",
         "--mc-family", "lock", "--mc-mode", "volatile", "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert p.returncode == 1, p.stderr
    out = json.loads(p.stdout)
    assert out["ok"] is False
    cert = tmp_path / "cert.json"
    cert.write_text(json.dumps(out["runs"][0]["violations"][0]))
    rc_t, out_t = tcli.main(["--mc", "--replay", str(cert)]), \
        capsys.readouterr().out
    rc_j, out_j = jcli.main(["--mc", "--replay", str(cert)]), \
        capsys.readouterr().out
    assert rc_t == rc_j == 0 and out_t == out_j
    assert "reproduced MC106" in out_t


def test_devlint_is_not_ported_yet(capsys):
    assert tcli.main(["--devlint"]) == 254
    err = capsys.readouterr().err
    assert "K001-K006" in err and "not ported" in err
    assert err.strip() == tcli.DEVLINT_MISSING


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card")
def test_device_cuda_without_a_card_fails(capsys, files):
    rc = tcli.main([files["good"], "--model", "cas-register", "--explain"])
    assert rc == 254
    err = capsys.readouterr().err
    assert "--device cuda" in err and "is_available() is False" in err
    assert tcli.main([files["good"], "--device", "cuda"]) == 254
