"""The port's differential fuzzer (``jepsen_tpu_torch/fuzz.py``, ``python
-m jepsen_tpu_torch.fuzz``) against the JAX package's ``tools/fuzz.py``:
the same seeds give the same histories, the same three verdicts and the
same encode-error rounds; the shrinker gives the same minimal history
under the same stand-in predicate; ``--replay``, a clean run and
``--corpus --max-entries`` print the same lines.  Then the teeth: a
device leg that flips a verdict fails the run with a repro that
replays as a divergence, a W-code fails it, a failed kernel launch
and an engine's ``KeyError`` propagate (neither is an encode-error),
and ``--device cuda`` without a card exits 254.  The port runs with
``device="cpu"``; the JAX legs stay at 20 ops or fewer and three seeds
per model."""

import ast
import json
import os
import random
import re
import sys

import pytest
import torch

from jepsen_tpu import synth as js
from jepsen_tpu.live import corpus as jcorpus
from jepsen_tpu.models import cas_register as j_cas
from jepsen_tpu_torch import fuzz as tf
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker.seq import check_opseq
from jepsen_tpu_torch.history import Op, encode_ops
from jepsen_tpu_torch.live import corpus as tcorpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import fuzz as ref  # noqa: E402  (the JAX package's fuzzer)

#: the JAX package's knobs its engines read; unset, each is on
KNOBS = ("JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR", "JEPSEN_TPU_LINT",
         "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_BATCH_BUCKETS")
MODEL_NAMES = sorted(tf.MODELS)
#: the JAX legs' history size
N_OPS = 20


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    torch.set_num_threads(1)
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _dicts(h):
    return [op.to_dict() for op in h]


def _round(pkg, model_name, seed, n_ops, n_procs=4):
    """One round's history as the fuzzers' loops draw it, and whether
    the 0.7 draw corrupted it."""
    rng = random.Random(seed)
    crash_p = rng.choice([0.0, 0.0, 0.1, 0.25])
    h = pkg.gen_history(rng, model_name, n_ops, n_procs, crash_p)
    corrupted = rng.random() < 0.7
    if corrupted:
        h = pkg.corrupt(rng, h)
    return h, corrupted


def _port_ops(h):
    return [Op.from_dict(op.to_dict()) for op in h]


def _no_seconds(text):
    return re.sub(r"\(\d+s\)", "(Ns)", text)


# ---------------------------------------------------------------------------
# constants, generation, verdicts
# ---------------------------------------------------------------------------


def test_constants_are_the_reference_constants():
    assert sorted(tf.MODELS) == sorted(ref.MODELS)
    for name in tf.MODELS:
        a, b = ref.MODELS[name](), tf.MODELS[name]()
        assert (a.name, a.f_codes, a.state_width, tuple(a.init)) \
            == (b.name, b.f_codes, b.state_width, tuple(b.init)), name
    assert (tf.QUEUE_MAX_OPS, tf.ORACLE_CAP, tf.DEVICE_BUDGET) \
        == (ref.QUEUE_MAX_OPS, ref.ORACLE_CAP, ref.DEVICE_BUDGET)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("model_name", MODEL_NAMES)
def test_generation_matches_reference(model_name, seed):
    """``gen_history`` and ``corrupt`` draw from the generator in the
    JAX package's order: the same ops, the same corrupt draw, at the
    fuzzer's default size."""
    a, ca = _round(ref, model_name, seed, 60)
    b, cb = _round(tf, model_name, seed, 60)
    assert ca == cb
    assert _dicts(b) == _dicts(a)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("model_name", MODEL_NAMES)
def test_verdicts_match_reference(model_name, seed):
    h, _ = _round(ref, model_name, seed, N_OPS)
    want = ref.verdicts(h, ref.MODELS[model_name]())
    got = tf.verdicts(_port_ops(h), tf.MODELS[model_name](), device="cpu")
    assert got == want


@pytest.mark.parametrize("model_name,other", [
    ("cas-register", "fifo-queue"), ("mutex", "register")])
def test_encode_error_rounds_match_reference(model_name, other):
    """A history whose ops the model has no code for is an encode-error
    round in both packages, with the same message."""
    h, _ = _round(ref, other, 1, N_OPS)
    want = ref.verdicts(h, ref.MODELS[model_name]())
    got = tf.verdicts(_port_ops(h), tf.MODELS[model_name](), device="cpu")
    assert want[0][0] == "encode-error"
    assert got == want


def test_lint_error_is_an_encode_error_round(monkeypatch):
    """An OpSeq the lint refuses (rows out of invocation order) is an
    encode-error round in both packages."""
    from jepsen_tpu.history import encode_ops as j_encode

    def swapped(encode):
        def enc(h, f_codes):
            s = encode(h, f_codes)
            s.inv = s.inv[::-1].copy()
            return s
        return enc

    monkeypatch.setattr(ref, "encode_ops", swapped(j_encode))
    monkeypatch.setattr(tf, "encode_ops", swapped(encode_ops))
    h, _ = _round(ref, "cas-register", 1, N_OPS)
    want = ref.verdicts(h, ref.MODELS["cas-register"]())
    got = tf.verdicts(_port_ops(h), tf.MODELS["cas-register"](),
                      device="cpu")
    assert want[0][0] == got[0][0] == "encode-error"
    assert "H004" in got[0][1]


# ---------------------------------------------------------------------------
# shrink
# ---------------------------------------------------------------------------


def _invalid(pkg_encode, pkg_check, model):
    def pred(hh, m, **_kw):
        try:
            s = pkg_encode(hh, m.f_codes)
        except Exception:
            return False
        return pkg_check(s, m, max_configs=ref.ORACLE_CAP)["valid"] \
            is False
    return pred


def test_shrink_matches_reference(monkeypatch):
    """The "oracle says invalid" predicate stood in for ``diverges`` on
    both sides: the same minimal history, op for op, of 12 ops or
    fewer."""
    from jepsen_tpu.checker import seq as joracle
    from jepsen_tpu.history import encode_ops as j_encode

    jm, tmodel = ref.MODELS["cas-register"](), tf.MODELS["cas-register"]()
    jpred = _invalid(j_encode, joracle.check_opseq, jm)
    tpred = _invalid(encode_ops, check_opseq, tmodel)
    h = None
    for seed in range(30):
        rng = random.Random(seed)
        cand = ref.corrupt(rng, ref.gen_history(rng, "cas-register", 30,
                                                3, 0.0))
        if jpred(cand, jm):
            h = cand
            break
    assert h is not None, "no invalid corruption in 30 seeds"
    monkeypatch.setattr(ref, "diverges", jpred)
    monkeypatch.setattr(tf, "diverges", tpred)
    want = ref.shrink(h, jm)
    got = tf.shrink(_port_ops(h), tmodel, device="cpu")
    assert _dicts(got) == _dicts(want)
    assert len(got) < len(h) and len(got) <= 12
    assert tpred(got, tmodel)


# ---------------------------------------------------------------------------
# the command line against the JAX package's
# ---------------------------------------------------------------------------


def _ref_main(monkeypatch, capsys, *argv):
    monkeypatch.setattr(sys, "argv", ["fuzz.py", *argv])
    rc = ref.main()
    return rc, capsys.readouterr().out


def _port_main(capsys, *argv):
    rc = tf.main([*argv, "--device", "cpu"])
    return rc, capsys.readouterr().out


def _flags(parser_src: str) -> set:
    """The option strings of every ``add_argument`` call in a source."""
    out = set()
    for node in ast.walk(ast.parse(parser_src)):
        if isinstance(node, ast.Call) \
                and getattr(node.func, "attr", None) == "add_argument":
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant)}
    return out


def test_flags_are_the_reference_flags_plus_device():
    with open(os.path.join(REPO, "tools", "fuzz.py")) as f:
        want = _flags(f.read())
    got = {s for a in tf.build_parser()._actions for s in a.option_strings}
    assert got - {"-h", "--help"} == want | {"--device"}


@pytest.mark.parametrize("model_name,seed", [
    ("cas-register", 0), ("mutex", 2), ("fifo-queue", 1)])
def test_replay_line_matches_reference(monkeypatch, capsys, tmp_path,
                                       model_name, seed):
    h, _ = _round(ref, model_name, seed, N_OPS)
    path = tmp_path / "h.json"
    path.write_text(json.dumps(_dicts(h)))
    want = _ref_main(monkeypatch, capsys, "--replay", str(path),
                     "--model", model_name)
    got = _port_main(capsys, "--replay", str(path), "--model", model_name)
    assert got == want
    assert got[1].rstrip().endswith("(agree)")


def test_clean_audit_run_prints_the_reference_lines(monkeypatch, capsys,
                                                    tmp_path):
    argv = ("--rounds", "3", "--n-ops", "16", "--model", "register",
            "--audit", "--out", str(tmp_path / "r.json"))
    want = _ref_main(monkeypatch, capsys, *argv)
    got = _port_main(capsys, *argv)
    assert (got[0], _no_seconds(got[1])) == (want[0], _no_seconds(want[1]))
    assert got[1].startswith("fuzz: 3 rounds, no divergence (")
    assert not (tmp_path / "r.json").exists()


def _bank(tmp_path):
    """A pool of register cells banked alike by both packages."""
    jbase, tbase = str(tmp_path / "jax"), str(tmp_path / "torch")
    for seed in range(4):
        rng = random.Random(100 + seed)
        h = js.sim_register_history(rng, 3, 10, crash_p=0.1, cas=True)
        if seed % 2:
            h = js.mutate(rng, h)
        from jepsen_tpu.checker import seq as joracle
        from jepsen_tpu.history import encode_ops as j_encode

        valid = joracle.check_opseq(j_encode(h, j_cas().f_codes),
                                    j_cas())["valid"]
        outcome = {"family": "kv", "nemesis": "partition", "valid": valid}
        a = jcorpus.bank_cell({"model": j_cas(), "history": h}, outcome,
                              base=jbase)
        b = tcorpus.bank_cell({"model": tm.cas_register(),
                               "history": _port_ops(h)}, outcome,
                              base=tbase)
        assert a == b
    return jcorpus.corpus_dir(jbase), tcorpus.corpus_dir(tbase)


def test_corpus_max_entries_matches_reference(monkeypatch, capsys,
                                              tmp_path):
    """``--corpus DIR --max-entries 2`` replays the pool's first two
    entries, as the JAX package's ``corpus_replay(max_entries=2)``
    does, and prints the same summary line."""
    jdir, tdir = _bank(tmp_path)
    assert len(tcorpus.load_pool(tdir)) == 4
    rc = ref.corpus_replay(jdir, max_entries=2)
    want = capsys.readouterr().out
    got = _port_main(capsys, "--corpus", tdir, "--max-entries", "2")
    assert (got[0], _no_seconds(got[1])) == (rc, _no_seconds(want))
    assert got[0] == 0 and "corpus: 2 entries replayed" in got[1]
    out = tcorpus.corpus_replay(tdir, max_entries=3, device="cpu")
    assert out["entries"] == 3 and out["ok"]


def test_corpus_of_an_empty_dir_says_so(capsys, tmp_path):
    assert _port_main(capsys, "--corpus", str(tmp_path)) \
        == (0, f"corpus: no entries under {tmp_path}\n")


# ---------------------------------------------------------------------------
# teeth
# ---------------------------------------------------------------------------


def _flipping(monkeypatch):
    real = tlin.search_opseq

    def flipped(*a, **kw):
        r = dict(real(*a, **kw))
        if isinstance(r["valid"], bool):
            r["valid"] = not r["valid"]
        return r

    monkeypatch.setattr(tlin, "search_opseq", flipped)


def test_flipped_device_verdict_fails_the_run_and_replays(monkeypatch,
                                                          capsys, tmp_path):
    out = tmp_path / "repro.json"
    _flipping(monkeypatch)
    rc = tf.main(["--rounds", "3", "--n-ops", "12", "--out", str(out),
                  "--device", "cpu"])
    text, err = capsys.readouterr()
    assert rc == 1
    assert text.startswith("minimal repro: ")
    assert err.startswith("DIVERGENCE at round 0 (seed 0): oracle=")
    assert err.rstrip().endswith("; shrinking...")
    ops = json.loads(out.read_text())
    assert 0 < len(ops) <= 2, ops
    rc, line = _port_main(capsys, "--replay", str(out))
    assert rc == 1 and line.rstrip().endswith("(DIVERGES)")
    rec = tf.fuzz("cas-register", rounds=3, n_ops=12, out=None,
                  device="cpu")
    d = rec["divergence"]
    assert d["round"] == 0 and d["n_ops_after"] <= 2 < d["n_ops_before"]
    assert d["verdicts"][0] != d["verdicts"][1]


def test_w_code_fails_the_run(monkeypatch, capsys, tmp_path):
    out = tmp_path / "h.json"
    monkeypatch.setattr(tf, "audit_results",
                        lambda s, m, rs: [("device", "W001 planted")])
    rc = tf.main(["--rounds", "2", "--n-ops", "12", "--audit", "--out",
                  str(out), "--device", "cpu"])
    text, err = capsys.readouterr()
    assert rc == 1 and text == f"history -> {out}\n"
    assert err == ("AUDIT FAILURE at round 0 (seed 0):\n"
                   "  [device] W001 planted\n")
    assert len(json.loads(out.read_text())) > 0
    rec = tf.fuzz("cas-register", rounds=2, n_ops=12, audit=True,
                  out=None, device="cpu")
    assert rec["rounds"] == 1 and rec["audit_failures"] == [{
        "round": 0, "seed": 0, "engine": "device",
        "diagnostic": "W001 planted"}]


def test_failed_kernel_launch_propagates(monkeypatch, capsys):
    """A failed B1 launch is no encode-error round: it propagates out of
    ``fuzz`` and ``main``."""
    def failed(*a, **kw):
        raise RuntimeError("level_loop single-key failed: an illegal "
                           "memory access was encountered")

    monkeypatch.setattr(tlin, "search_opseq", failed)
    with pytest.raises(RuntimeError, match="level_loop"):
        tf.fuzz("mutex", rounds=2, n_ops=12, out=None, device="cpu")
    with pytest.raises(RuntimeError, match="level_loop"):
        tf.main(["--rounds", "2", "--audit", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="level_loop"):
        tf.verdicts(_port_ops(_round(tf, "mutex", 0, 12)[0]),
                    tf.MODELS["mutex"](), device="cpu")


def test_engine_key_error_propagates(monkeypatch):
    """A ``KeyError`` of an engine (a lookup on the device path) is no
    encode-error round either: only ``encode_ops``'s is."""
    def failed(*a, **kw):
        raise KeyError("engine")

    monkeypatch.setattr(tlin, "search_opseq", failed)
    with pytest.raises(KeyError, match="engine"):
        tf.fuzz("cas-register", rounds=2, n_ops=12, audit=True, out=None,
                device="cpu")
    with pytest.raises(KeyError, match="engine"):
        tf.main(["--rounds", "2", "--device", "cpu"])
    with pytest.raises(KeyError, match="engine"):
        tf.verdicts(_port_ops(_round(tf, "register", 0, 12)[0]),
                    tf.MODELS["register"](), device="cpu")


def test_device_cuda_without_a_card_exits_254(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--replay", "x.json"], ["--corpus", "d"]):
        assert tf.main([*argv, "--device", "cuda"]) == 254
        err = capsys.readouterr().err
        assert err.startswith("--device cuda: ") and "is_available" in err


def test_round_record_counts_engines_and_frontier():
    rec = tf.fuzz("cas-register", rounds=6, n_ops=N_OPS, audit=True,
                  out=None, device="cpu")
    assert rec["rounds"] == 6 and rec["divergence"] is None
    assert sum(rec["engines"].values()) + rec["encode_errors"] == 6
    assert "device-bfs" in rec["engines"] and rec["frontier"] >= 16
    seed = rec["frontier_seed"]
    assert 0 <= seed < 6
    one = tf.fuzz("cas-register", rounds=1, seed=seed, n_ops=N_OPS,
                  out=None, device="cpu")
    assert one["frontier"] == rec["frontier"]


def test_cli_runs_as_a_module(tmp_path):
    import subprocess

    p = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.fuzz", "--rounds", "2",
         "--n-ops", "10", "--model", "mutex", "--device", "cpu",
         "--out", str(tmp_path / "r.json")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert _no_seconds(p.stdout) == "fuzz: 2 rounds, no divergence (Ns)\n"


# ---------------------------------------------------------------------------
# the ported history and model helpers
# ---------------------------------------------------------------------------


def test_value_encoder_decode_matches_reference():
    from jepsen_tpu.history import ValueEncoder as JEnc
    from jepsen_tpu_torch.history import NIL, ValueEncoder as TEnc

    values = [None, 0, 7, -3, 2**31, "a", ("k", 1), "a", 2**30, -(2**30)]
    je, te = JEnc(), TEnc()
    ids = [te.encode(v) for v in values]
    assert ids == [je.encode(v) for v in values]
    assert [te.decode(i) for i in ids] == [je.decode(i) for i in ids] \
        == values
    assert te.decode(NIL) is None and te.decode(12345) == 12345


@pytest.mark.parametrize("model_name", MODEL_NAMES)
def test_model_step_matches_reference(model_name):
    a, b = ref.MODELS[model_name](), tf.MODELS[model_name]()
    rng = random.Random(5)
    h, _ = _round(ref, model_name, 3, 40)
    state_a = state_b = tuple(a.init)
    for op in h:
        if op.type != "ok" or op.f not in a.f_codes:
            continue
        value = op.value if op.f != "read" or rng.random() < 0.5 else None
        want = a.step(state_a, op.f, value)
        got = b.step(state_b, op.f, value)
        assert (None if got is None else tuple(got)) \
            == (None if want is None else tuple(want)), (op, value)
        if want is not None:
            state_a, state_b = want, got
