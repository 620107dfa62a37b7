"""The suite and service lint (:mod:`.suites`) as a command.

    python -m jepsen_tpu_torch.analyze.lint_suites   # suites/, live/, tiers
    python -m jepsen_tpu_torch.analyze.lint_suites path/to/suite.py dir/
    python -m jepsen_tpu_torch.analyze.lint_suites --json

The JAX package's ``tools/lint_suites.py``, with the same flags, JSON
keys and exit codes, over the port's tree.  Files under a ``live/``
directory additionally get the B-code backend lint (LiveBackend
protocol conformance, crash-to-:fail swallowing, fsync-before-rename
journal ordering).

The default sweep (no paths) also runs the T-code thread/lock-
discipline lint over the service tiers (``jepsen_tpu_torch/fleet/``,
``stream/``, ``obs/``, ``decompose/cache.py``, ``checker/bucket.py``),
the N-code knob lint (every test-map knob key the port reads is written
by a ``cli.py`` flag where it is a switch, documented in the README's
port section, and no module reads the environment), the O-code
metrics-contract lint and the R-code retry-idempotency lint.  Skip one
with ``--no-threads`` / ``--no-knobs`` / ``--no-metrics`` /
``--no-retry``; run one alone with ``--threads`` / ``--knobs`` /
``--metrics`` / ``--retry``.

Exit code 0 when no ERROR-severity findings (warnings don't fail the
run), 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys

from .suites import (
    SUITE_CODES,
    lint_knobs,
    lint_metrics,
    lint_paths,
    lint_retry,
    lint_thread_tier,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.analyze.lint_suites",
        description="AST protocol lint over jepsen suites, live "
                    "backends, and the threaded service tiers "
                    "(S-/B-/T-/N-/O-/R-codes; --codes lists them)")
    p.add_argument("paths", nargs="*",
                   help="suite files or directories (default: "
                        "jepsen_tpu_torch/suites + jepsen_tpu_torch/live)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--codes", action="store_true",
                   help="list the S-/B-/T-/N-/O-/R-codes and exit")
    p.add_argument("--threads", action="store_true",
                   help="run ONLY the T-code thread/lock lint")
    p.add_argument("--no-threads", action="store_true",
                   help="skip the T-code lint in the default sweep")
    p.add_argument("--knobs", action="store_true",
                   help="run ONLY the N-code knob-threading lint")
    p.add_argument("--no-knobs", action="store_true",
                   help="skip the N-code lint in the default sweep")
    p.add_argument("--metrics", action="store_true",
                   help="run ONLY the O-code metrics-contract lint")
    p.add_argument("--no-metrics", action="store_true",
                   help="skip the O-code lint in the default sweep")
    p.add_argument("--retry", action="store_true",
                   help="run ONLY the R-code retry-idempotency lint")
    p.add_argument("--no-retry", action="store_true",
                   help="skip the R-code lint in the default sweep")
    opts = p.parse_args(argv)
    if opts.codes:
        for code, desc in sorted(SUITE_CODES.items()):
            print(f"{code}  {desc}")
        return 0

    only = opts.threads or opts.knobs or opts.metrics or opts.retry
    findings: dict = {}
    if not only:
        findings = lint_paths(opts.paths)
    # tier-wide passes: part of the default sweep (explicit paths mean
    # the caller scoped the run to specific suites, so leave them out
    # unless their --flag asked for them)
    sweep = not opts.paths and not only
    for on, off, lint in ((opts.threads, opts.no_threads, lint_thread_tier),
                          (opts.knobs, opts.no_knobs, lint_knobs),
                          (opts.metrics, opts.no_metrics, lint_metrics),
                          (opts.retry, opts.no_retry, lint_retry)):
        if on or (sweep and not off):
            for f, ds in lint().items():
                findings.setdefault(f, []).extend(ds)
    n_err = sum(1 for ds in findings.values()
                for d in ds if d.severity == "error")
    n_warn = sum(1 for ds in findings.values()
                 for d in ds if d.severity == "warning")
    if opts.as_json:
        print(json.dumps({
            "errors": n_err,
            "warnings": n_warn,
            "files": {f: [d.to_dict() for d in ds]
                      for f, ds in findings.items()},
        }, indent=2))
    else:
        for _f, ds in sorted(findings.items()):
            for d in ds:
                print(f"{d.severity.upper()} {d.code} {d.message}")
        print(f"{n_err} error(s), {n_warn} warning(s)")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
