"""``python -m jepsen_tpu_torch.live`` — run (or plan) a nemesis campaign.

  python -m jepsen_tpu_torch.live --dry-run
  python -m jepsen_tpu_torch.live --families register,lock --nemeses \\
      kill-restart,pause --time-limit 8

The JAX package's flags and output, plus four: ``--device`` (default
``cuda``: without a card the command exits 254 and says why; ``cpu``
checks every cell on the host), ``--lin-algorithm`` (the route of every
cell's linearizability checker, as the suites' command line takes it),
and ``--data-root``/``--base-port`` (where every cell's nodes keep their
data and the port its node 0 listens on; by default each cell's under
``/tmp/jepsen-live/<cell>`` and each family's own port).  ``--dry-run``
and ``--sweep`` start nothing and need no card.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def _split(v: str | None) -> list[str] | None:
    return [x.strip() for x in v.split(",") if x.strip()] if v else None


def main(argv=None) -> int:
    from .backend import FAMILIES
    from .campaign import plan, render_plan, run_campaign
    from ..checker.linearizable import Linearizable
    from .matrix import standard_matrix

    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.live",
        description="Live fault-injection campaign: backend families "
                    "× nemesis matrix, each cell a real-process run "
                    "with streaming checking and certificate audit.")
    p.add_argument("--families", default=None,
                   help="Comma list (default: all of "
                        f"{','.join(FAMILIES)}).")
    p.add_argument("--nemeses", default=None,
                   help="Comma list (default: all of "
                        f"{','.join(standard_matrix())}).")
    p.add_argument("--time-limit", type=int, default=8,
                   help="Seconds of workload per cell.")
    p.add_argument("--rate", type=float, default=None,
                   help="Client op rate per cell.")
    p.add_argument("--no-seeded", action="store_true",
                   help="Skip the seeded-bug cells (volatile lock "
                        "under kill -9).")
    p.add_argument("--no-stream", action="store_true",
                   help="Post-hoc checking only (no live verdicts, no "
                        "detection latency).")
    p.add_argument("--no-audit", action="store_true",
                   help="Skip the certificate audit pass.")
    p.add_argument("--store-base", default=None,
                   help="Store root (default: store/).")
    p.add_argument("--resume", metavar="CAMPAIGN_ID", default=None,
                   help="Resume an interrupted campaign: skip every "
                        "cell already recorded in store/campaigns/"
                        "CAMPAIGN_ID/cells.jsonl, run the rest, and "
                        "rewrite its campaign.json complete.")
    p.add_argument("--cell-budget", type=float, default=None,
                   metavar="S",
                   help="Per-cell wall-clock watchdog budget in "
                        "seconds (default: scaled from --time-limit). "
                        "Past it the watchdog SIGKILLs the cell's "
                        "wedged backend processes so the campaign "
                        "degrades one cell, never hangs.")
    p.add_argument("--cell-retries", type=int, default=None,
                   metavar="N",
                   help="Bounded retries per cell on harness (not "
                        "verdict) errors (default 1).")
    p.add_argument("--dry-run", action="store_true",
                   help="Print the matrix with per-cell skip reasons; "
                        "spawn nothing.")
    p.add_argument("--no-corpus", action="store_true",
                   help="Don't bank completed cell histories into "
                        "store/corpus/ (the differential-fuzz "
                        "regression pool).")
    p.add_argument("--sweep", nargs="?", const="/tmp/jepsen-live",
                   default=None, metavar="DATA_ROOT",
                   help="Remove every partition/link rule journaled "
                        "under DATA_ROOT (default /tmp/jepsen-live) "
                        "and exit — restores connectivity after a "
                        "SIGKILL'd runner.")
    p.add_argument("--json", action="store_true",
                   help="Emit the plan/record as JSON.")
    p.add_argument("--device", default="cuda",
                   help="Device every cell's checkers run on (default "
                        "cuda; exits 254 without a card) or cpu.")
    p.add_argument("--data-root", default=None, metavar="DIR",
                   help="Data root of every cell's nodes (default: "
                        "/tmp/jepsen-live/<cell>); the cells run one "
                        "after another and share it.")
    p.add_argument("--base-port", type=int, default=None, metavar="N",
                   help="Port of every family's node 0, node i at N+i "
                        "(default: each family's own).")
    p.add_argument("--lin-algorithm", default=None,
                   choices=sorted(Linearizable.ALGORITHMS),
                   help="The linearizability route of every cell's "
                        "checker (device: the device search on every "
                        "checked history or key).")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    if args.sweep is not None:
        from .links import sweep_tree

        n = sweep_tree(args.sweep)
        print(f"swept {n} journaled rule(s) under {args.sweep}")
        return 0

    opts: dict = {"time_limit": args.time_limit}
    if args.rate is not None:
        opts["rate"] = args.rate
    if args.store_base:
        opts["store_base"] = args.store_base
    if args.no_stream:
        opts["stream"] = False
    if args.no_audit:
        opts["audit"] = False
    if args.no_corpus:
        opts["corpus"] = False
    if args.resume:
        opts["campaign_id"] = args.resume
    if args.cell_budget is not None:
        opts["cell_budget"] = args.cell_budget
    if args.cell_retries is not None:
        opts["cell_retries"] = args.cell_retries
    opts["device"] = args.device
    if args.data_root is not None:
        opts["data_root"] = args.data_root
    if args.base_port is not None:
        opts["base_port"] = args.base_port
    if args.lin_algorithm is not None:
        opts["lin_algorithm"] = args.lin_algorithm

    families = _split(args.families)
    nemeses = _split(args.nemeses)
    if args.dry_run:
        cells = plan(families, nemeses, opts,
                     seeded=not args.no_seeded)
        if args.json:
            print(json.dumps(cells, indent=1))
        else:
            print(render_plan(cells))
        return 0

    from ..checker.linearizable import _resolve_device

    try:
        _resolve_device(args.device)
    except RuntimeError as e:
        print(f"--device {args.device}: {e}", file=sys.stderr)
        return 254

    def progress(outcome: dict) -> None:
        tag = f"{outcome['family']} × {outcome['nemesis']}" \
            + (" [seeded]" if outcome.get("seeded") else "")
        if outcome.get("attempts", 1) > 1:
            tag += f" [attempt {outcome['attempts']}]"
        if (outcome.get("watchdog") or {}).get("fired"):
            tag += " [watchdog]"
        if outcome["status"] == "ok":
            extra = ""
            det = outcome.get("detection")
            if det and "latency_s" in det:
                extra = (f", detected in {det['latency_s']}s "
                         f"({det.get('at')})")
            print(f"  {tag}: valid={outcome.get('valid')} "
                  f"({outcome.get('ops')} ops{extra})", flush=True)
        else:
            print(f"  {tag}: {outcome['status']} — "
                  f"{outcome.get('reason')}", flush=True)

    record = run_campaign(opts, families, nemeses,
                          seeded=not args.no_seeded,
                          progress=progress,
                          resume=bool(args.resume))
    if args.json:
        print(json.dumps(record, indent=1, default=str))
    else:
        s = record["summary"]
        resumed = record.get("resumed_cells") or 0
        print(f"campaign {record['id']}: "
              f"{s.get('ok', 0)} ok / {s.get('skipped', 0)} skipped / "
              f"{s.get('failed', 0)} failed"
              + (f" / {resumed} resumed" if resumed else "")
              + f"; {s.get('detected', 0)} violations detected "
              f"({s.get('streamed_detections', 0)} streamed), "
              f"{s.get('audited_ok', 0)} cells audited ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
