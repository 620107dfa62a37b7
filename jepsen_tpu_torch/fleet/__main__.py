"""``python -m jepsen_tpu_torch.fleet``: boot a routed checking fleet.

Spawns N ``python -m jepsen_tpu_torch.stream --listen`` worker processes
(each with its own fleet-cache segment, the shared persist dir and
``--device``), admits each one once its warm-boot report verifies (with
``--warmup``), then serves the stream line protocol on the router port.
When the admission controller says "spawn-worker", the supervisor starts
another worker (up to ``--max-workers``), warms it and adds it to the
ring.  Workers of one host share its card; two workers that find the
kernels unbuilt each build them (``_build.py`` writes to a temporary
file and renames it), which costs a second nvcc run and nothing else.

SIGTERM drains the tier: workers get SIGTERM (their drain finalizes
every open run and exits 0), then the router stops and the process
exits 0.  The counterpart of the JAX package's ``fleet/__main__.py``.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import subprocess
import sys
import threading

log = logging.getLogger("jepsen_tpu_torch.fleet")

_LISTEN_MARK = "stream service listening on "
_WARMUP_MARK = "stream service warmup:"


class WorkerProc:
    """One supervised worker subprocess + its parsed boot lines."""

    def __init__(self, wid: str, args, cmd: list[str]):
        self.wid = wid
        self.proc = subprocess.Popen(
            cmd, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
            text=True)
        self.address: tuple[str, int] | None = None
        self.warmup: dict | None = None
        self._boot(timeout=args.boot_timeout)

    def _boot(self, *, timeout: float) -> None:
        from .warmup import parse_warmup_line

        def read_stderr():
            for line in self.proc.stderr:
                line = line.strip()
                if _WARMUP_MARK in line:
                    self.warmup = parse_warmup_line(line)
                elif line.startswith(_LISTEN_MARK):
                    host, _, port = line[len(_LISTEN_MARK):]\
                        .rpartition(":")
                    self.address = (host, int(port))
                    booted.set()
                else:
                    log.info("worker %s: %s", self.wid, line)
            booted.set()  # stderr closed: the worker exited

        booted = threading.Event()
        t = threading.Thread(target=read_stderr, daemon=True,
                             name=f"fleet-stderr-{self.wid}")
        t.start()
        if not booted.wait(timeout) or self.address is None:
            self.proc.kill()
            raise RuntimeError(
                f"worker {self.wid} did not report a listen address "
                f"within {timeout}s (exit code {self.proc.poll()})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.fleet",
        description="Routed multi-worker checking fleet: N stream "
                    "workers behind a rendezvous-hash router with "
                    "health probes, dead-worker salvage, a shared "
                    "verdict-cache store, and warm-boot admission.")
    p.add_argument("--workers", type=int, default=2,
                   help="Initial worker count.")
    p.add_argument("--max-workers", type=int, default=8,
                   help="Scale-out ceiling for spawn-worker signals.")
    p.add_argument("--listen", metavar="HOST:PORT",
                   default="127.0.0.1:7777",
                   help="Router listen address (the client-facing "
                        "protocol + aggregated /metrics port).")
    p.add_argument("--cache-root", metavar="DIR", default=None,
                   help="Fleet verdict-cache store root "
                        "(fleet/cachestore.py layout); default: "
                        "store-managed.")
    p.add_argument("--persist-dir", metavar="DIR", default=None,
                   help="Shared persist dir for run snapshots — the "
                        "dead-worker salvage source.  Default: "
                        "<cache-root>/persist.")
    p.add_argument("--warmup", metavar="MANIFEST", default=None,
                   help="Warm-boot manifest or BENCH_trace_*.json "
                        "handed to every worker; admission requires "
                        "a verified report.")
    p.add_argument("--model", default=None,
                   help="Default model workers open headerless runs "
                        "with.")
    p.add_argument("--device", default="cuda",
                   help="Where the workers' device-routed segment folds "
                        "search and their warm boot runs: cuda (the "
                        "default; a worker raises without a card) or "
                        "cpu.")
    p.add_argument("--probe-interval", type=float, default=0.25)
    p.add_argument("--op-budget", type=int, default=None)
    p.add_argument("--idle-timeout", type=float, default=None)
    args = p.parse_args(argv)
    args.boot_timeout = 120.0
    logging.basicConfig(level=logging.INFO)

    from .. import store
    from .admission import AdmissionController
    from .router import FleetRouter, WorkerSpec, make_router_server

    cache_root = args.cache_root or os.path.join(
        store.BASE, "fleet_cache")
    persist = args.persist_dir or os.path.join(cache_root, "persist")
    os.makedirs(persist, exist_ok=True)

    state = {"n": 0, "procs": {}}
    lock = threading.Lock()

    def worker_cmd(wid: str) -> list[str]:
        cmd = [sys.executable, "-m", "jepsen_tpu_torch.stream",
               "--listen", "127.0.0.1:0",
               "--fleet-cache", cache_root,
               "--worker-id", wid,
               "--persist-dir", persist,
               "--device", args.device]
        if args.warmup:
            cmd += ["--warmup", args.warmup]
        if args.model:
            cmd += ["--model", args.model]
        if args.op_budget is not None:
            cmd += ["--op-budget", str(args.op_budget)]
        if args.idle_timeout is not None:
            cmd += ["--idle-timeout", str(args.idle_timeout)]
        return cmd

    def spawn_worker() -> bool:
        with lock:
            if len(state["procs"]) >= args.max_workers:
                log.info("fleet: at max-workers=%d, not spawning",
                         args.max_workers)
                return False
            state["n"] += 1
            wid = f"w{state['n']}"
        log.info("fleet: spawning worker %s", wid)
        try:
            wp = WorkerProc(wid, args, worker_cmd(wid))
        except RuntimeError:
            log.warning("fleet: worker %s failed to boot", wid,
                        exc_info=True)
            return False
        spec = WorkerSpec(wid, wp.address[0], wp.address[1], persist)
        if not router.admit_worker(spec, warmup_report=wp.warmup):
            wp.proc.terminate()
            return False
        with lock:
            state["procs"][wid] = wp
        log.info("fleet: worker %s admitted at %s:%d (warmup=%s)",
                 wid, spec.host, spec.port, wp.warmup)
        return True

    router = FleetRouter(
        admission=AdmissionController(),
        probe_interval=args.probe_interval,
        require_warmup=bool(args.warmup),
        on_spawn=lambda: threading.Thread(
            target=spawn_worker, daemon=True).start())
    for _ in range(max(1, args.workers)):
        spawn_worker()
    if not router.workers():
        log.error("fleet: no worker passed admission; giving up")
        return 1
    router.start_probes()

    host, _, port = args.listen.rpartition(":")
    srv = make_router_server(host or "127.0.0.1", int(port), router)

    def _sigterm(_signo, _frame):
        def drain():
            log.info("fleet: draining %d workers",
                     len(state["procs"]))
            with lock:
                procs = dict(state["procs"])
            for wid, wp in procs.items():
                try:
                    wp.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
            for wid, wp in procs.items():
                try:
                    wp.proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    wp.proc.kill()
            srv.shutdown()
        threading.Thread(target=drain, name="fleet-drain",
                         daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass
    print(f"fleet router listening on "
          f"{srv.server_address[0]}:{srv.server_address[1]} with "
          f"{len(router.workers())} worker(s)",
          file=sys.stderr, flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
        _sigterm(None, None)
    router.stop_probes()
    return 0


if __name__ == "__main__":
    sys.exit(main())
