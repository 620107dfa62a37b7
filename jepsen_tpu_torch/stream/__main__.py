"""``python -m jepsen_tpu_torch.stream``: the checking service's front
door.

stdin mode (the default) reads history JSONL from stdin and writes
verdict lines to stdout; ``--listen HOST:PORT`` serves the same line
protocol over TCP, one connection per run namespace, and drains on
SIGTERM (every open run answers its final, then the process exits 0).
``--device`` says where device-routed segment folds search (``cuda``,
the default, or ``cpu``).  See ``stream/service.py`` for the protocol.

As a fleet worker (``python -m jepsen_tpu_torch.fleet`` starts them so):
``--fleet-cache DIR`` puts the verdict cache in the fleet's shared store
at DIR, this worker appending to its own segment (``--worker-id``
names it; ``fleet/cachestore.py``), and ``--warmup MANIFEST`` warms the
steady-state slice functions on ``--device`` before serving
(``fleet/warmup.py``: on the card it builds B1 and launches it at every
shape).  The warm boot prints ``stream service warmup: shapes=N
compiled=N verified=true|false persistent_cache=true|false wall_s=S`` on
stderr before the ``stream service listening on`` line, so the fleet's
admission gate reads it before it can route a run here; a shape whose
coordinates drifted from the cache-key model (K007) or a failed verify
prints ``verified=false``.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.stream",
        description="Streaming incremental checking service: ingest "
                    "history JSONL from concurrent runs, answer with "
                    "live verdicts.")
    p.add_argument("--model", default=None,
                   help="Default model for runs that send no header "
                        "(register, cas-register, mutex, "
                        "multi-register, unordered-queue-N, "
                        "fifo-queue-N).")
    p.add_argument("--init", type=int, default=0,
                   help="Default model's initial value.")
    p.add_argument("--width", type=int, default=1,
                   help="Default model's state width (multi-register).")
    p.add_argument("--cache", metavar="PATH", default=None,
                   help="Shared verdict-cache jsonl; 'store' selects "
                        "the store-persisted default path.  Omit for "
                        "an in-memory per-process cache.")
    p.add_argument("--no-cache", action="store_true",
                   help="Disable the verdict cache entirely.")
    p.add_argument("--no-witness", action="store_true",
                   help="Skip witness chains (verdicts only; faster).")
    p.add_argument("--audit", action="store_true",
                   help="Replay every final certificate through the "
                        "independent audit (analyze/audit.py).")
    p.add_argument("--host-fold-max", type=int, default=None,
                   help="Override the plan gate's host-fold cost cap "
                        "(analyze.plan.STREAM_HOST_FOLD_MAX).")
    p.add_argument("--listen", metavar="HOST:PORT", default=None,
                   help="Serve the line protocol over TCP instead of "
                        "stdin/stdout.")
    p.add_argument("--op-budget", type=int, default=None, metavar="N",
                   help="Per-run admitted-op ceiling: past it, ops are "
                        "shed with an 'overloaded' reply and the run "
                        "finalizes on the admitted prefix.")
    p.add_argument("--ingest-queue", type=int, default=0, metavar="N",
                   help="Bounded per-connection ingest queue (0 = "
                        "process inline): when the checker falls this "
                        "many lines behind, further lines are shed "
                        "with an 'overloaded' reply instead of "
                        "stalling the socket.")
    p.add_argument("--info-lookahead", type=int, default=None,
                   metavar="N",
                   help="Bounded :info lookahead horizon: after N "
                        "post-crash ok ops at a pseudo-quiescent "
                        "point, speculatively fork-check the crashed "
                        "segment so kill-seeded violations flip the "
                        "live verdict mid-stream (default: "
                        "analyze.plan.STREAM_INFO_LOOKAHEAD; 0 "
                        "disables — finalize-only).")
    p.add_argument("--persist-dir", metavar="DIR", default=None,
                   help="Persist each run's live snapshot and final "
                        "verdict to DIR/<run>.json — a run whose "
                        "connection drops mid-history still leaves "
                        "its prefix verdict on disk.")
    p.add_argument("--idle-timeout", type=float, default=None,
                   metavar="S",
                   help="Reap (finalize) runs silent for S seconds: a "
                        "vanished client can't pin an open checker "
                        "forever.  Default: never.")
    p.add_argument("--device", default="cuda",
                   help="Where device-routed segment folds search: "
                        "cuda (the default; raises without a card) or "
                        "cpu.")
    p.add_argument("--fleet-cache", metavar="DIR", default=None,
                   help="Use the fleet's shared verdict-cache store "
                        "rooted at DIR (fleet/cachestore.py: one "
                        "write-ahead segment per worker, merged on "
                        "spill) instead of the single jsonl --cache.")
    p.add_argument("--worker-id", default=None,
                   help="Stable worker id naming this worker's "
                        "--fleet-cache segment (default: w<pid>).")
    p.add_argument("--warmup", metavar="MANIFEST", default=None,
                   help="Warm the steady-state slice functions on "
                        "--device before serving (fleet/warmup.py): "
                        "MANIFEST is a shape-manifest JSON or a "
                        "recorded trace (BENCH_trace_*.json); prints "
                        "the 'stream service warmup:' line the fleet's "
                        "admission gate parses.")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    from ..decompose.cache import VerdictCache, default_cache_path
    from ..decompose.schedule import model_from_descriptor
    from .service import StreamService, make_server, serve_stdio

    model = None
    if args.model:
        model = model_from_descriptor(
            (args.model, (args.init,), args.width))
    cache = None
    if args.fleet_cache and not args.no_cache:
        from ..fleet.cachestore import FleetCacheStore

        cache = FleetCacheStore(args.fleet_cache,
                                worker_id=args.worker_id)
    elif not args.no_cache:
        path = args.cache
        if path == "store":
            path = default_cache_path()
        cache = VerdictCache(path)

    if args.warmup:
        # before the listen line: the fleet's admission gate must never
        # route a run at a worker still building its kernels
        from ..fleet.warmup import load_shapes, warm_boot

        k007: list = []
        report = warm_boot(load_shapes(args.warmup, diagnostics=k007),
                           device=args.device)
        verified = report["verified"] and not k007
        print("stream service warmup: shapes=%d compiled=%d "
              "verified=%s persistent_cache=%s wall_s=%.3f"
              % (report["shapes"], report["compiled"],
                 str(verified).lower(),
                 str(report["persistent_cache"]).lower(),
                 report["wall_s"]),
              file=sys.stderr, flush=True)
        for d in k007:
            print(f"stream service {d.code}: {d.message}",
                  file=sys.stderr, flush=True)

    if args.listen:
        import signal
        import threading

        from .service import drain_server

        host, _, port = args.listen.rpartition(":")
        srv = make_server(host or "127.0.0.1", int(port), model=model,
                          cache=cache,
                          witness=not args.no_witness,
                          audit=True if args.audit else None,
                          host_fold_max=args.host_fold_max,
                          info_lookahead=args.info_lookahead,
                          op_budget=args.op_budget,
                          ingest_max=args.ingest_queue,
                          persist_dir=args.persist_dir,
                          idle_timeout=args.idle_timeout,
                          device=args.device)

        def _sigterm(_signo, _frame):
            # graceful drain: finalize every open run (finals still
            # answered on their own connections), refuse new ones,
            # then stop serve_forever — the process exits 0.  Run off
            # the signal frame: drain_server joins handler work and
            # shutdown() must not be called from the main loop's own
            # interrupt context.
            threading.Thread(target=drain_server, args=(srv,),
                             name="stream-drain", daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _sigterm)
        except ValueError:
            pass  # not the main thread (embedded use)
        print(f"stream service listening on "
              f"{srv.server_address[0]}:{srv.server_address[1]}",
              file=sys.stderr, flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            srv.shutdown()
        if cache is not None:
            cache.close()
        return 0

    service = StreamService(model=model, cache=cache,
                            witness=not args.no_witness,
                            audit=True if args.audit else None,
                            host_fold_max=args.host_fold_max,
                            info_lookahead=args.info_lookahead,
                            op_budget=args.op_budget,
                            persist_dir=args.persist_dir,
                            idle_timeout=args.idle_timeout,
                            device=args.device)
    serve_stdio(service, sys.stdin, sys.stdout,
                ingest_max=args.ingest_queue)
    return 0


if __name__ == "__main__":
    sys.exit(main())
