"""The port's command line (``jepsen_tpu_torch.cli``) against the JAX
package's: the option helpers, the dict ``test_opt_fn`` makes of every
flag, the exit-code contract of ``cli.run``, and each checker flag
reaching a ``Linearizable`` that a suite builds with no arguments.

The JAX package carries its flags in ``JEPSEN_TPU_*`` environment
variables, which its checkers read; the port carries them as test-map
keys, which ``Linearizable.resolved`` reads.  So each flag's case parses
the same command line in both packages, checks one seeded history with
``linearizable(model)`` under the JAX package's environment and under
the port's options as the test map, and requires the same result.  The
JAX package's side sets process state outside the test's monkeypatch
(environment variables, its trace and telemetry switches); every case
puts them back, so later tests in the worker see the defaults."""

import argparse
import dataclasses
import os
import random

import pytest
import torch

import jepsen_tpu.checker.linearizable as jlin
from jepsen_tpu import cli as jcli
from jepsen_tpu import fixtures as jfixtures
from jepsen_tpu import generator as jgen
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.obs import telemetry as jtele
from jepsen_tpu.obs import trace as jtrace
from jepsen_tpu_torch import _build
from jepsen_tpu_torch import cli as tcli
from jepsen_tpu_torch import fixtures as tfixtures
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.obs import trace as ttrace
from test_torch_hb import to_port

#: every variable the JAX package's CLI sets, and the one its checker
#: reads that the CLI has no flag for
ENV = ("JEPSEN_TPU_LIN_DECOMPOSE", "JEPSEN_TPU_STREAM", "JEPSEN_TPU_EXPLAIN",
       "JEPSEN_TPU_TRACE", "JEPSEN_TPU_LINT", "JEPSEN_TPU_HB",
       "JEPSEN_TPU_DPOR", "JEPSEN_TPU_SHRINK", "JEPSEN_TPU_TELEMETRY",
       "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_COMPILE_CACHE_DIR",
       "JEPSEN_TPU_LIN_ALGORITHM")

#: the result keys a flag can move
KEYS = ("valid", "engine", "configs", "max_depth", "final_ops",
        "linearization", "witness_dropped", "frontier_dropped",
        "device_configs", "witness_prefix_ops", "lint_warnings", "hb",
        "constraints", "dpor", "shrink", "explain", "decompose", "audit")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """The JAX package's process state as the defaults before and after
    each case; the port's trace switch put back; one torch thread."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jlin, "_SLICE_TARGET_S", 1e9)
    monkeypatch.setattr(tlin, "_SLICE_TARGET_S", 1e9)
    saved = (jtrace._forced, jtrace._env_on, jtele._forced, jtele._env_on,
             ttrace._on, _build.BUILD_DIR)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        # plain pops: test_opt_fn set these outside monkeypatch's ledger
        for k in ENV:
            os.environ.pop(k, None)
        (jtrace._forced, jtrace._env_on, jtele._forced, jtele._env_on,
         ttrace._on, _build.BUILD_DIR) = saved
        torch.set_num_threads(n)


def _parse(cli, argv):
    p = argparse.ArgumentParser()
    cli.add_test_opts(p)
    return cli.test_opt_fn(p.parse_args(argv))


def _flags(cli) -> dict:
    p = argparse.ArgumentParser()
    cli.add_test_opts(p)
    return {a.option_strings[-1]: a for a in p._actions
            if a.option_strings and a.dest != "help"}


# ---------------------------------------------------------------------------
# option helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("conc,nodes", [("3n", ["a", "b", "c"]),
                                        ("7", ["a"]), ("1n", ["a", "b"]),
                                        ("0", [])])
def test_parse_concurrency_equals_reference(conc, nodes):
    want = jcli.parse_concurrency({"concurrency": conc, "nodes": nodes})
    assert tcli.parse_concurrency({"concurrency": conc,
                                   "nodes": nodes}) == want


def test_parse_concurrency_refuses_as_reference():
    for c in ("x2", "n", "3m", ""):
        with pytest.raises(ValueError) as je:
            jcli.parse_concurrency({"concurrency": c, "nodes": []})
        with pytest.raises(ValueError) as te:
            tcli.parse_concurrency({"concurrency": c, "nodes": []})
        assert str(te.value) == str(je.value)


def test_parse_nodes_equals_reference(tmp_path):
    f = tmp_path / "nodes"
    f.write_text("h1\nh2\n\n  h3 \n")
    for opts in ({"nodes_file": str(f), "nodes": ["ignored"]},
                 {"nodes": None, "nodes_file": None},
                 {"nodes": ["x", "y"], "nodes_file": None}, {}):
        assert tcli.parse_nodes(dict(opts)) == jcli.parse_nodes(dict(opts))
    assert tcli.DEFAULT_NODES == jcli.DEFAULT_NODES


def test_rename_ssh_options_equals_reference():
    for opts in ({"username": "admin", "password": "pw",
                  "strict_host_key_checking": True,
                  "ssh_private_key": "/k", "other": 1}, {}):
        assert tcli.rename_ssh_options(dict(opts)) == \
            jcli.rename_ssh_options(dict(opts))


def test_exit_codes_and_one_of_equal_reference():
    assert (tcli.EXIT_OK, tcli.EXIT_INVALID, tcli.EXIT_BAD_ARGS,
            tcli.EXIT_ERROR) == (jcli.EXIT_OK, jcli.EXIT_INVALID,
                                 jcli.EXIT_BAD_ARGS, jcli.EXIT_ERROR)
    for coll in ({"b": 1, "a": 2}, ["z", "y"]):
        assert tcli.one_of(coll) == jcli.one_of(coll)


def test_the_port_has_every_reference_flag_and_two_more():
    jflags, tflags = _flags(jcli), _flags(tcli)
    # --dummy-responses: the dummy remote's canned answers, without which
    # a DB that installs an archive spins in both packages' tmp_dir
    assert set(tflags) - set(jflags) == {"--device", "--lin-algorithm",
                                         "--dummy-responses"}
    assert set(jflags) <= set(tflags)
    for name, a in jflags.items():
        b = tflags[name]
        assert (b.dest, b.default, b.option_strings, type(b).__name__) == \
            (a.dest, a.default, a.option_strings, type(a).__name__), name
    assert tflags["--lin-algorithm"].choices == \
        sorted(tlin.Linearizable.ALGORITHMS)


def test_tarball_opt_equals_reference():
    for kw in ({}, {"default": "file:///x.tgz", "name": "package"}):
        pj, pt = argparse.ArgumentParser(), argparse.ArgumentParser()
        jcli.add_tarball_opt(pj, **kw)
        tcli.add_tarball_opt(pt, **kw)
        assert vars(pt.parse_args([])) == vars(pj.parse_args([]))
        flag = f"--{kw.get('name', 'tarball')}"
        assert vars(pt.parse_args([flag, "u"])) == \
            vars(pj.parse_args([flag, "u"]))


# ---------------------------------------------------------------------------
# test_opt_fn: the reference's dict plus the port's test-map keys
# ---------------------------------------------------------------------------

#: (the flags, the keys the port adds beside the reference's dict)
OPT_CASES = {
    "none": ([], {}),
    "nodes": (["-n", "a", "-n", "b", "--concurrency", "3n"], {}),
    "ssh": (["--username", "u", "--password", "p",
             "--strict-host-key-checking", "--ssh-private-key", "/k"], {}),
    "counts": (["--test-count", "3", "--time-limit", "7", "--dummy"], {}),
    "lin-decompose": (["--lin-decompose"], {}),
    "stream": (["--stream"], {}),
    "explain": (["--explain"], {}),
    "trace": (["--trace"], {}),
    "no-lint": (["--no-lint"], {"lint": False}),
    "no-hb": (["--no-hb"], {"hb": False}),
    "no-dpor": (["--no-dpor"], {"dpor": False}),
    "no-shrink": (["--no-shrink"], {"shrink": False}),
    "no-telemetry": (["--no-telemetry"], {"telemetry": False}),
    "audit": (["--audit"], {"audit": True}),
    "all": (["--lin-decompose", "--stream", "--explain", "--no-lint",
             "--no-hb", "--no-dpor", "--no-shrink", "--no-telemetry",
             "--audit"], {"lint": False, "hb": False, "dpor": False,
                          "shrink": False, "telemetry": False,
                          "audit": True}),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_opt_dict_is_the_reference_dict_plus_test_map_keys(case):
    argv, extra = OPT_CASES[case]
    want = _parse(jcli, argv)
    got = _parse(tcli, argv + ["--device", "cpu"])
    assert got == want | extra | {"device": "cpu"}


def test_trace_turns_both_recorders_on():
    _parse(jcli, ["--trace"])
    assert jtrace.enabled() is True
    assert ttrace.enabled() is False
    _parse(tcli, ["--trace", "--device", "cpu"])
    assert ttrace.enabled() is True


def test_no_telemetry_sets_no_process_state():
    """The JAX package turns its telemetry off process-wide; the port
    only leaves ``telemetry: False`` in the options."""
    _parse(tcli, ["--no-telemetry", "--device", "cpu"])
    assert os.environ.get("JEPSEN_TPU_TELEMETRY") is None
    assert jtele.enabled() is True


def test_lin_algorithm_and_device_keys():
    for algo in sorted(tlin.Linearizable.ALGORITHMS):
        got = _parse(tcli, ["--lin-algorithm", algo, "--device", "cpu"])
        assert got["lin_algorithm"] == algo
    assert "lin_algorithm" not in _parse(tcli, ["--device", "cpu"])
    p = argparse.ArgumentParser()
    tcli.add_test_opts(p)
    with pytest.raises(SystemExit):
        p.parse_args(["--lin-algorithm", "quantum"])


def test_compile_cache_dir_names_the_kernel_build_dir(tmp_path):
    got = _parse(tcli, ["--compile-cache-dir", str(tmp_path / "cc"),
                        "--device", "cpu"])
    assert got["compile_cache_dir"] == str(tmp_path / "cc")
    assert _build.BUILD_DIR == (tmp_path / "cc").resolve()
    assert not (tmp_path / "cc").exists()  # nothing built at parse time


def test_device_without_a_card_is_a_bad_argument():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(ValueError, match="torch.cuda.is_available"):
        _parse(tcli, [])
    with pytest.raises(ValueError, match="--device cuda:0"):
        _parse(tcli, ["--device", "cuda:0"])


def test_no_process_environment_written():
    before = dict(os.environ)
    _parse(tcli, OPT_CASES["all"][0] + ["--trace", "--device", "cpu",
                                        "--lin-algorithm", "host"])
    assert dict(os.environ) == before


# ---------------------------------------------------------------------------
# cli.run: the exit-code contract on the same fixture test function
# ---------------------------------------------------------------------------


def _test_fn(pkg, store_base, *, valid=True, boom=False):
    fixtures, gen = (jfixtures, jgen) if pkg == "jax" else \
        (tfixtures, tgen)
    lin = jlin if pkg == "jax" else tlin
    cas = (jm if pkg == "jax" else tm).cas_register

    def test_fn(opts):
        if boom:
            raise RuntimeError("internal error")
        state = fixtures.AtomRegister()
        if not valid:
            state.read = lambda: 99  # a value no write gives
        return fixtures.noop_test() | {
            "name": "cli-demo", "store_base": store_base,
            "nodes": opts["nodes"],
            "concurrency": min(opts["concurrency"], 4),
            "db": fixtures.atom_db(state),
            "client": fixtures.atom_client(state),
            "model": cas(0), "checker": lin.linearizable(),
            "device": opts.get("device"),
            "generator": gen.clients(gen.limit(20, gen.cas))}
    return test_fn


@pytest.mark.parametrize("what", ["valid", "invalid", "bad-subcommand",
                                  "no-subcommand", "bad-flag",
                                  "bad-concurrency", "internal-error",
                                  "help"])
def test_run_exit_codes_equal_reference(what, tmp_path, capsys):
    random.seed(5)
    argv = {"valid": ["test", "-n", "a", "-n", "b", "--concurrency", "2n",
                      "--dummy"],
            "invalid": ["test", "-n", "a", "--concurrency", "4",
                        "--dummy"],
            "bad-subcommand": ["bogus-subcommand"],
            "no-subcommand": [],
            "bad-flag": ["test", "--no-such-flag"],
            "bad-concurrency": ["test", "--concurrency", "x"],
            "internal-error": ["test", "--dummy"],
            "help": ["test", "--help"]}[what]
    codes = {}
    for pkg, cli in (("jax", jcli), ("torch", tcli)):
        random.seed(5)
        fn = _test_fn(pkg, str(tmp_path / pkg), valid=what != "invalid",
                      boom=what == "internal-error")
        extra = ["--device", "cpu"] if pkg == "torch" and argv[:1] == \
            ["test"] and what != "help" else []
        codes[pkg] = cli.run(cli.single_test_cmd(fn), argv + extra)
        capsys.readouterr()
    want = {"valid": 0, "invalid": 1, "bad-subcommand": 254,
            "no-subcommand": 254, "bad-flag": 254, "bad-concurrency": 254,
            "internal-error": 255, "help": 0}[what]
    assert codes == {"jax": want, "torch": want}


def test_run_without_a_card_exits_254_naming_it(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = tcli.run(tcli.single_test_cmd(_test_fn("torch", str(tmp_path))),
                  ["test", "--dummy"])
    assert rc == tcli.EXIT_BAD_ARGS
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not (tmp_path / "cli-demo").exists()  # nothing ran


# ---------------------------------------------------------------------------
# each flag reaches a Linearizable a suite built with no arguments
# ---------------------------------------------------------------------------


def _history(kind):
    rng = random.Random(1515)
    h = js.register_history(rng, n_ops=30, n_procs=4, overlap=4,
                            crash_p=0.05, max_crashes=2, n_values=3)
    if kind == "invalid":
        return js.corrupt_read(rng, h, at=0.6)
    if kind == "warned":
        h = [dataclasses.replace(op, index=i) for i, op in enumerate(h)]
        h[3] = dataclasses.replace(h[3], index=0)  # an H004 warning
    return h


#: (the flags, the JAX package's JEPSEN_TPU_LIN_ALGORITHM or None)
FLAG_CASES = {
    "none": ([], None),
    "lin-decompose": (["--lin-decompose"], None),
    "explain": (["--explain"], None),
    "audit": (["--audit"], None),
    "no-lint": (["--no-lint"], None),
    "no-hb": (["--no-hb"], None),
    "no-dpor": (["--no-dpor"], None),
    "no-shrink": (["--no-shrink"], None),
    "no-telemetry": (["--no-telemetry", "--lin-algorithm", "device"],
                     "device"),
    "trace": (["--trace"], None),
    "stream": (["--stream"], None),
    "algorithm-host": (["--lin-algorithm", "host"], "host"),
    "algorithm-wgl": (["--lin-algorithm", "wgl"], "wgl"),
    "algorithm-linear": (["--lin-algorithm", "linear"], "linear"),
    "algorithm-device": (["--lin-algorithm", "device"], "device"),
    "algorithm-tpu": (["--lin-algorithm", "tpu"], "tpu"),
    "algorithm-auto": (["--lin-algorithm", "auto"], "auto"),
    "device-audit-no-hb": (["--lin-algorithm", "device", "--audit",
                            "--no-hb"], "device"),
    "decompose-no-dpor": (["--lin-decompose", "--no-dpor",
                           "--lin-algorithm", "host"], "host"),
}


def _both(flags, algo, h, tmp_path, monkeypatch):
    """The JAX package's result under its CLI's environment, and the
    port's with the port's options as the test map; both checkers built
    as a suite builds them."""
    if "--lin-algorithm" in flags:  # the JAX package has no such flag
        i = flags.index("--lin-algorithm")
        flags_j = flags[:i] + flags[i + 2:]
    else:
        flags_j = flags
    _parse(jcli, flags_j)
    if algo:
        monkeypatch.setenv("JEPSEN_TPU_LIN_ALGORITHM", algo)
    want = jlin.linearizable(jm.cas_register()).check(
        {"name": "j", "store_base": str(tmp_path / "j")}, h)
    for k in ENV:
        os.environ.pop(k, None)
    jtele.enable(None)
    opts = _parse(tcli, flags + ["--device", "cpu"])
    got = tlin.linearizable(tm.cas_register()).check(
        opts | {"name": "t", "store_base": str(tmp_path / "t")},
        to_port(h))
    return want, got


@pytest.mark.parametrize("kind", ["valid", "invalid", "warned"])
@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_flag_reaches_a_suite_built_checker(case, kind, tmp_path,
                                            monkeypatch, capsys):
    flags, algo = FLAG_CASES[case]
    want, got = _both(flags, algo, _history(kind), tmp_path, monkeypatch)
    for k in KEYS:
        assert got.get(k) == want.get(k), (k, got.get(k), want.get(k))
    assert ("search_telemetry" in got) == ("search_telemetry" in want)
    assert ("report_file" in got) == ("report_file" in want)
    if "--explain" in flags:
        assert got["valid"] == "unknown" and got["configs"] == 0
    if "--lin-decompose" in flags:
        assert got["decompose"]
    if "--audit" in flags:
        assert got["audit"]["ok"] is True
    if case == "no-telemetry":
        assert "search_telemetry" not in got
    if case == "algorithm-device" and kind == "invalid":
        assert got["engine"].startswith("device-bfs")
    if kind == "invalid" and case not in ("explain", "no-shrink"):
        assert got["shrink"]
    if case == "no-shrink":
        assert "shrink" not in got
    if case == "no-lint":
        assert "lint_warnings" not in got
    capsys.readouterr()


def test_an_argument_given_beats_the_test_map(tmp_path):
    h = to_port(_history("invalid"))
    m = tm.cas_register()
    test = {"name": "t", "store_base": str(tmp_path), "device": "cuda",
            "explain": True, "hb": False, "dpor": False, "shrink": False,
            "lint": False, "audit": True, "lin_algorithm": "device",
            "telemetry": False}
    chk = tlin.linearizable(m, device="cpu", explain=False, hb=True,
                            dpor=True, shrink=True, lint=True, audit=False,
                            algorithm="host", telemetry=True)
    eff = chk.resolved(test)
    for k in tlin.Linearizable.TEST_MAP_KEYS + ("device", "algorithm",
                                                "decompose"):
        assert getattr(eff, k) == getattr(chk, k), k
    got = chk.check(test, h)
    want = tlin.linearizable(m, device="cpu", algorithm="host").check(
        {"name": "u", "store_base": str(tmp_path)}, h)
    for k in KEYS:
        assert got.get(k) == want.get(k), k
    assert got["engine"] == "host-oracle" and got["shrink"]


def test_decompose_false_still_follows_the_flag():
    """As ``JEPSEN_TPU_LIN_DECOMPOSE`` turns on a checker built with
    ``decompose=False``, so does ``lin_decompose`` in the test map."""
    chk = tlin.linearizable(tm.cas_register(), decompose=False,
                            device="cpu")
    assert chk.resolved({"lin_decompose": True}).decompose is True
    assert chk.resolved({}) is chk
    assert chk.decompose is False


def test_device_none_is_the_test_maps_else_cuda():
    chk = tlin.linearizable(tm.cas_register())
    assert chk.device is None
    assert chk.resolved({"device": "cpu"}).device == "cpu"
    assert chk.resolved({}).device == "cuda"
    assert tlin.linearizable(device="cpu").resolved(
        {"device": "cuda"}).device == "cpu"


def test_unknown_lin_algorithm_in_the_test_map_raises():
    chk = tlin.linearizable(tm.cas_register(), device="cpu")
    with pytest.raises(ValueError, match="lin_algorithm"):
        chk.resolved({"lin_algorithm": "quantum"})


def test_resolved_copies_share_the_verdict_cache(tmp_path):
    chk = tlin.linearizable(tm.cas_register(), algorithm="linear",
                            decompose=True,
                            verdict_cache=str(tmp_path / "v.jsonl"))
    h = to_port(_history("valid"))
    r1 = chk.check({"device": "cpu"}, h)
    obj = chk._cache_obj
    r2 = chk.check({"device": "cpu"}, h)
    assert obj is not None and chk._cache_obj is obj
    assert r1["valid"] is r2["valid"] is True
    assert r2["decompose"]["methods"] == ["cache"]


def test_the_independent_batch_runs_on_the_resolved_device():
    """``IndependentChecker``'s batch reads the device (and the flags)
    the lifted checker resolves: on the CPU from the test map, and
    without a card the default raises rather than checking on the
    host."""
    hist = []
    for k in range(2):
        h = to_port(js.register_history(random.Random(k), n_ops=60,
                                        n_procs=3, overlap=3, n_values=3))
        hist += [dataclasses.replace(op, process=op.process + 10 * k,
                                     value=tind.tuple_(k, op.value))
                 for op in h]
    chk = tind.checker(tlin.linearizable(tm.cas_register()))
    out = chk.check({"device": "cpu", "hb": False}, hist)
    assert out["valid"] is True and sorted(out["results"]) == [0, 1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            chk.check({}, hist)


def _keyed(pkg_tuple, n_keys=2, n_ops=60):
    """``n_keys`` keys of ``n_ops`` register ops each, lifted with
    ``pkg_tuple`` (past the host threshold: the independent checker's
    batch)."""
    out = []
    for k in range(n_keys):
        h = js.register_history(random.Random(40 + k), n_ops=n_ops,
                                n_procs=3, overlap=3, n_values=3,
                                crash_p=0.05, max_crashes=2)
        if k == 1:
            h = js.corrupt_read(random.Random(k), h, at=0.5)
        out += [dataclasses.replace(op, process=op.process + 10 * k,
                                    value=pkg_tuple(k, op.value))
                for op in h]
    return out


@pytest.mark.parametrize("flags", [[], ["--no-hb", "--no-dpor", "--audit"],
                                   ["--no-lint", "--no-telemetry"]],
                         ids=["none", "no-hb-no-dpor-audit",
                              "no-lint-no-telemetry"])
def test_flags_reach_the_independent_batch(flags, tmp_path):
    """A suite's lifted ``independent.checker(linearizable())`` on keys
    past the host threshold: the batch and each key's recheck follow the
    flags as the JAX package's follow its environment."""
    from jepsen_tpu import independent as jind

    _parse(jcli, flags)
    want = jind.checker(jlin.linearizable(jm.cas_register())).check(
        {"name": "j", "store_base": str(tmp_path / "j")},
        _keyed(jind.tuple_))
    for k in ENV:
        os.environ.pop(k, None)
    jtele.enable(None)
    opts = _parse(tcli, flags + ["--device", "cpu"])
    got = tind.checker(tlin.linearizable(tm.cas_register())).check(
        opts | {"name": "t", "store_base": str(tmp_path / "t")},
        to_port(_keyed(tind.tuple_)))
    assert got["valid"] is want["valid"] is False
    assert got["failures"] == want["failures"] == [1]
    # key 0 is decided inside the batch; key 1's recheck is a race, whose
    # winner follows wall time: there the verdict and what every leg
    # shares are compared
    for k, r in want["results"].items():
        for key in KEYS if k == 0 else ("valid", "lint_warnings"):
            assert got["results"][k].get(key) == r.get(key), (k, key)
        for key in ("search_telemetry", "audit", "hb", "dpor"):
            assert (key in got["results"][k]) == (key in r), (k, key)
