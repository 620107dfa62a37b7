"""Command-line toolkit (reference L8).

Reference: jepsen/src/jepsen/cli.clj.  Provides the subcommand framework
suites build their mains from: shared test options (test-opt-spec,
cli.clj:52-87 — --node/--nodes-file/--username/--password/--concurrency
"3n"/--time-limit/--test-count/--tarball), option post-processing
(parse-concurrency cli.clj:125-140, rename-ssh-options 159-174,
nodes-file 176-189), the exit-code contract (cli.clj:103-114):

  0    all tests passed
  1    some test failed
  254  invalid arguments
  255  internal error

and the stock subcommands: `test` (single-test-cmd, cli.clj:297-331,
honoring --test-count) and `serve` (cli.clj:280-295, the results web UI).

The port reads no environment variable: each checker flag becomes a key
of the options, which every suite merges into its test map, and the
suites' ``Linearizable`` checkers read those keys at check time
(``Linearizable.resolved``).  ``--device`` (default ``cuda``) is the
device every checker and the streaming checker run on; without a card
``--device cuda`` exits 254 and says why, it never runs on the host
quietly.
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import sys
import traceback
from typing import Callable

log = logging.getLogger("jepsen")

DEFAULT_NODES = ["n1", "n2", "n3", "n4", "n5"]

EXIT_OK = 0
EXIT_INVALID = 1
EXIT_BAD_ARGS = 254
EXIT_ERROR = 255

#: each boolean flag of add_test_opts -> (the option it leaves, the test
#: map key and value the port's checkers read)
CHECKER_FLAGS = {
    "lin_decompose": ("lin_decompose", True),
    "stream": ("stream", True),
    "explain": ("explain", True),
    "trace": ("trace", True),
    "no_lint": ("lint", False),
    "no_hb": ("hb", False),
    "no_dpor": ("dpor", False),
    "no_shrink": ("shrink", False),
    "no_telemetry": ("telemetry", False),
    "audit": ("audit", True),
}


def one_of(coll) -> str:
    keys = sorted(coll.keys() if isinstance(coll, dict) else coll)
    return "Must be one of " + ", ".join(map(str, keys))


def add_test_opts(p: argparse.ArgumentParser) -> None:
    """The shared test option surface (cli.clj:52-87)."""
    from .checker.linearizable import Linearizable

    p.add_argument("-n", "--node", action="append", dest="nodes",
                   metavar="HOSTNAME", default=None,
                   help="Node(s) to run the test on; repeatable.")
    p.add_argument("--nodes-file", metavar="FILENAME",
                   help="File with node hostnames, one per line.")
    p.add_argument("--username", default="root", help="Username for logins")
    p.add_argument("--password", default="root",
                   help="Password for sudo access")
    p.add_argument("--strict-host-key-checking", action="store_true",
                   default=False, help="Whether to check host keys")
    p.add_argument("--ssh-private-key", metavar="FILE",
                   help="Path to an SSH identity file")
    p.add_argument("--concurrency", default="1n",
                   help="Worker count; an integer, optionally followed by "
                        "n to multiply by the node count (e.g. 3n).")
    p.add_argument("--test-count", type=int, default=1,
                   help="How many times to repeat the test")
    p.add_argument("--time-limit", type=int, default=60,
                   help="Test duration excluding setup/teardown, seconds")
    p.add_argument("--dummy", action="store_true", default=False,
                   help="Use the dummy remote (no SSH; harness testing)")
    p.add_argument("--dummy-responses", metavar="FILE", default=None,
                   help="With --dummy: a JSON object mapping a command "
                        "substring to the dummy remote's answer, [exit, "
                        "out, err] or out; the first match wins, and any "
                        "other command exits 0 with no output.  A DB "
                        "whose setup installs an archive needs one (the "
                        "default answers every stat, so no fresh "
                        "temporary directory is ever found).")
    p.add_argument("--lin-decompose", action="store_true", default=False,
                   help="Run linearizability checks through the "
                        "decomposition layer (jepsen_tpu_torch/decompose/):"
                        " per-key/per-value splits, quiescence cuts, the "
                        "persisted verdict cache.  Verdict-identical; "
                        "every suite-built checker honors it.")
    p.add_argument("--stream", action="store_true", default=False,
                   help="Check the history incrementally while the test "
                        "runs (jepsen_tpu_torch/stream/): a live "
                        "provisional verdict (web UI /api/live, store "
                        "live.json); final verdicts equal the post-hoc "
                        "checker's.")
    p.add_argument("--explain", action="store_true", default=False,
                   help="Print the static search plan instead of running "
                        "the linearizability search "
                        "(jepsen_tpu_torch.analyze.plan); the verdict "
                        "reports as \"unknown\" with the plan attached.")
    p.add_argument("--trace", action="store_true", default=False,
                   help="Record flight-recorder spans for the whole run "
                        "(jepsen_tpu_torch.obs), exported as Chrome-trace "
                        "JSON to the run's store dir (trace.json).")
    p.add_argument("--no-lint", action="store_true", default=False,
                   help="Disable the history well-formedness linter in "
                        "front of every linearizability check.")
    p.add_argument("--no-hb", action="store_true", default=False,
                   help="Disable the happens-before pre-pass "
                        "(jepsen_tpu_torch.analyze.hb); verdict-identical "
                        "either way.")
    p.add_argument("--no-dpor", action="store_true", default=False,
                   help="Disable the partial-order reductions "
                        "(jepsen_tpu_torch.analyze.dpor); verdict-"
                        "identical either way.")
    p.add_argument("--no-shrink", action="store_true", default=False,
                   help="Disable counterexample minimization in failure "
                        "reports (reporting only, never verdicts).")
    p.add_argument("--no-telemetry", action="store_true", default=False,
                   help="Disable the device-search telemetry block "
                        "(jepsen_tpu_torch.obs.telemetry); verdicts are "
                        "the same either way.")
    p.add_argument("--audit", action="store_true", default=False,
                   help="Independently audit every verdict's certificate "
                        "(jepsen_tpu_torch.analyze.audit); a W-code "
                        "raises AuditError.")
    p.add_argument("--compile-cache-dir", metavar="DIR", default=None,
                   help="Directory the port's CUDA kernels are built "
                        "into and loaded from (default "
                        "build/jepsen_tpu_torch/ beside the package), so "
                        "repeat runs do not rebuild them.")
    p.add_argument("--device", default="cuda",
                   help="Device the checkers run on (default cuda; cpu "
                        "runs them on the host).")
    p.add_argument("--lin-algorithm", default=None,
                   choices=sorted(Linearizable.ALGORITHMS),
                   help="The linearizability route of every suite-built "
                        "checker left at algorithm=\"auto\" (device: the "
                        "device search on every checked key).")


def add_tarball_opt(p: argparse.ArgumentParser, default: str | None = None,
                    name: str = "tarball") -> None:
    """cli.clj:89-101."""
    p.add_argument(f"--{name}", default=default, metavar="URL",
                   help="URL of the DB package (file://, http://, or "
                        "https://, ending .tar/.tgz/.zip)")


def parse_concurrency(opts: dict) -> dict:
    """'3n' -> 3 × node count (cli.clj:125-140)."""
    c = str(opts.get("concurrency", "1n"))
    m = re.fullmatch(r"(\d+)(n?)", c)
    if not m:
        raise ValueError(
            f"--concurrency {c} should be an integer optionally "
            f"followed by n")
    unit = len(opts["nodes"]) if m.group(2) == "n" else 1
    opts["concurrency"] = int(m.group(1)) * unit
    return opts


def parse_nodes(opts: dict) -> dict:
    """--nodes-file wins over -n; default n1..n5 (cli.clj:176-189)."""
    if opts.get("nodes_file"):
        with open(opts["nodes_file"]) as f:
            opts["nodes"] = [ln.strip() for ln in f if ln.strip()]
    elif not opts.get("nodes"):
        opts["nodes"] = list(DEFAULT_NODES)
    return opts


def rename_ssh_options(opts: dict) -> dict:
    """Pack flat ssh flags into the test's ssh map (cli.clj:159-174)."""
    opts["ssh"] = {
        "username": opts.pop("username", "root"),
        "password": opts.pop("password", None),
        "strict_host_key_checking": opts.pop("strict_host_key_checking",
                                             False),
        "private_key_path": opts.pop("ssh_private_key", None),
    }
    return opts


def test_opt_fn(parsed: argparse.Namespace) -> dict:
    """The standard post-processing chain (cli.clj:191-198).  A checker
    flag given leaves its option (``no_lint: True``, ...) and the test map
    key the port's checkers read (``lint: False``, ...; see
    :data:`CHECKER_FLAGS`); a flag not given leaves neither.  ``--trace``
    also turns this process's span recorder on.  Raises ValueError when
    ``--device`` names a device this machine lacks."""
    from .checker.linearizable import _resolve_device

    opts = vars(parsed).copy()
    opts = parse_nodes(opts)
    opts = parse_concurrency(opts)
    opts = rename_ssh_options(opts)
    for flag, (key, value) in CHECKER_FLAGS.items():
        if opts.pop(flag, False):
            opts[flag] = True
            opts[key] = value
    if opts.get("trace"):
        from .obs import trace as _trace

        _trace.enable(True)
    if opts.get("lin_algorithm") is None:
        opts.pop("lin_algorithm", None)
    if opts.get("dummy_responses") is None:
        opts.pop("dummy_responses", None)
    else:
        opts["dummy_responses"] = load_dummy_responses(
            opts["dummy_responses"])
    try:
        _resolve_device(opts["device"])
    except RuntimeError as e:
        raise ValueError(f"--device {opts['device']}: {e}") from None
    ccd = opts.get("compile_cache_dir")
    if ccd:
        from . import _build

        _build.use_build_dir(ccd)
    return opts


def load_dummy_responses(path: str) -> dict:
    """``--dummy-responses``: the JSON file as ``DummyRemote``'s
    responses, each ``[exit, out, err]`` a tuple.  Raises ValueError on
    a file that is not such an object."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"--dummy-responses {path}: {e}") from None
    if not isinstance(raw, dict):
        raise ValueError(f"--dummy-responses {path}: not a JSON object")
    out = {}
    for k, v in raw.items():
        if isinstance(v, list) and len(v) == 3 \
                and isinstance(v[0], int) \
                and all(isinstance(x, str) for x in v[1:]):
            out[k] = tuple(v)
        elif isinstance(v, str):
            out[k] = v
        else:
            raise ValueError(f"--dummy-responses {path}: {k!r} maps to "
                             f"{v!r}, not [exit, out, err] or out")
    return out


def run_test_cmd(test_fn: Callable[[dict], dict], opts: dict) -> int:
    """Run test-count tests; exit 1 on the first invalid result
    (cli.clj:325-331)."""
    from . import core

    for i in range(opts.get("test_count", 1)):
        test = test_fn(opts)
        if opts.get("dummy"):
            from .control import DummyRemote

            test.setdefault("remote", DummyRemote(
                opts.get("dummy_responses")))
        test = core.run(test)
        valid = test.get("results", {}).get("valid")
        if valid is not True:
            return EXIT_INVALID
    return EXIT_OK


def serve_cmd(opts: dict) -> int:
    """Results web server (cli.clj:280-295)."""
    from . import web

    web.serve(host=opts.get("host", "0.0.0.0"),
              port=int(opts.get("port", 8080)))
    return EXIT_OK


def run(subcommands: dict, argv: list[str] | None = None,
        prog: str | None = None) -> int:
    """Dispatch a CLI built from {name: {opt_fn?, run, add_opts?, help?}}
    (cli.clj:203-278).  Returns the exit code; `main` wraps this in
    sys.exit."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog=prog or "jepsen")
    subs = parser.add_subparsers(dest="subcommand")
    for name, spec in subcommands.items():
        sp = subs.add_parser(name, help=spec.get("help"))
        add = spec.get("add_opts")
        if add:
            add(sp)
    try:
        parsed = parser.parse_args(argv)
    except SystemExit as e:
        return EXIT_BAD_ARGS if e.code not in (0, None) else EXIT_OK
    if not parsed.subcommand:
        parser.print_help()
        return EXIT_BAD_ARGS
    spec = subcommands[parsed.subcommand]
    try:
        opt_fn = spec.get("opt_fn", lambda p: vars(p).copy())
        opts = opt_fn(parsed)
        return spec["run"](opts)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return EXIT_BAD_ARGS
    except Exception:
        traceback.print_exc()
        return EXIT_ERROR


def single_test_cmd(test_fn: Callable[[dict], dict], *,
                    add_opts: Callable | None = None) -> dict:
    """A {test, serve} subcommand map around one test function
    (cli.clj:297-331)."""

    def add(p: argparse.ArgumentParser):
        add_test_opts(p)
        if add_opts:
            add_opts(p)

    def add_serve(p: argparse.ArgumentParser):
        p.add_argument("--host", default="0.0.0.0")
        p.add_argument("--port", default=8080, type=int)

    return {
        "test": {"add_opts": add, "opt_fn": test_opt_fn,
                 "run": lambda opts: run_test_cmd(test_fn, opts),
                 "help": "Run a test"},
        "serve": {"add_opts": add_serve, "run": serve_cmd,
                  "help": "Serve the results web UI"},
    }


def main(subcommands: dict, argv: list[str] | None = None) -> None:
    sys.exit(run(subcommands, argv))
