"""``python -m jepsen_tpu_torch.obs``: the flight recorder's command line.

  trace <run>     print a run's Chrome trace JSON
                  (``<base>/<name>/<time>/trace.json``; a bare test name
                  reads its ``latest`` run, a file path is used as it
                  is), for Perfetto or chrome://tracing.
  report <run>    the phase-time table of the same trace (device against
                  host against idle); ``--json`` prints the dict.
  metrics         this process's Prometheus text.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def resolve_trace(run: str, base: str | None = None) -> str:
    """The trace path of a run: an existing file, ``name/time`` under
    ``base`` (default ``store.BASE``), or a bare test name (its
    ``latest`` run)."""
    from .. import store

    if os.path.isfile(run):
        return run
    base = base or store.BASE
    p = os.path.join(base, run, "trace.json")
    if os.path.isfile(p):
        return p
    latest = os.path.join(base, run, "latest", "trace.json")
    if os.path.isfile(latest):
        return latest
    raise FileNotFoundError(
        f"no trace.json for run {run!r} (looked at {p} and {latest}; "
        f"was the run traced?)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.obs",
        description="Flight recorder: export traces, summarize them, "
                    "dump metrics.")
    sub = p.add_subparsers(dest="cmd")
    tp = sub.add_parser("trace", help="print a run's Chrome trace JSON")
    tp.add_argument("run", help="store run (name/time), test name "
                                "(latest run), or a trace.json path")
    tp.add_argument("--base", default=None, help="store base dir")
    rp = sub.add_parser("report", help="phase-time table for a trace")
    rp.add_argument("run")
    rp.add_argument("--base", default=None)
    rp.add_argument("--json", action="store_true",
                    help="emit the table as JSON")
    sub.add_parser("metrics", help="this process's Prometheus metrics text")
    args = p.parse_args(argv)

    if args.cmd == "trace":
        with open(resolve_trace(args.run, args.base)) as f:
            sys.stdout.write(f.read())
        return 0
    if args.cmd == "report":
        from .report import load_trace, phase_table, render_report

        rep = phase_table(load_trace(resolve_trace(args.run, args.base)))
        print(json.dumps(rep, indent=1) if args.json
              else render_report(rep))
        return 0
    if args.cmd == "metrics":
        from . import metrics

        sys.stdout.write(metrics.render())
        return 0
    p.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
