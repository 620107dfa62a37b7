"""The fleet bench tier: a routed two-worker tier in one process.

:func:`run_fleet_tier` boots two stream workers and the router in
process (real TCP between router and workers, real sockets from the
clients), warms the steady-state slice functions first, then drives a
synthetic client swarm at the router in rungs of 1, 2, 4 and 8
concurrent clients and finds the **throughput knee**: the rung past
which more clients stop buying events per second.  The pieces
(:class:`Fleet`, :func:`run_swarm`, :func:`throughput_knee`,
:func:`parity_check`, :func:`record_traffic_shapes`) are also what
``chip_smoke.py`` drives on the card.

Three gates ride on the numbers:

  * **parity**: routed finals are checked again through one in-process
    ``StreamService`` on the same device and fold gate; verdict, engine
    and stream stats (less the cache counters) must be equal;
  * **warmup verified**: the warm boot's zero-miss second request held;
  * **zero steady-state compiles**: the kernel cache's miss count does
    not move while the swarm runs.

It writes only where it is told: ``out_path`` (the numbers) and
``trace_path`` (the flight recording, its ``device.compile`` spans
those of the warm boot).  The counterpart of the JAX package's
``fleet/bench.py``.
"""

from __future__ import annotations

import json
import os
import random
import socket
import tempfile
import threading
import time
from pathlib import Path

#: parity re-checks are a full second check each: sample, don't sweep
_PARITY_SAMPLE = 8

#: the committed trace whose compile spans seed the warm set
_REPO = Path(__file__).resolve().parents[2]


def _mk_history(seed: int, n_ops: int):
    from ..synth import register_history

    rng = random.Random(seed)
    return register_history(rng, n_ops=n_ops, n_procs=6, overlap=4,
                            quiesce_every=8, n_values=5, cas=False)


def _op_lines(run_id: str, h) -> list[str]:
    lines = [json.dumps({"run": run_id, "model": "register"})]
    lines += [json.dumps({"run": run_id, "op": op.to_dict()})
              for op in h]
    lines.append(json.dumps({"run": run_id, "end": True}))
    return lines


def _strip_cache(summary: dict) -> dict:
    """A final summary with the cache counters dropped: they depend on
    what else the fleet checked, not on this history."""
    out = dict(summary)
    stream = dict(out.get("stream") or {})
    for k in list(stream):
        if k.startswith("cache_"):
            stream.pop(k)
    out["stream"] = stream
    out.pop("finalized_by", None)
    return out


def _single_service_final(h, *, device="cuda",
                          host_fold_max: int | None = None,
                          lines=None) -> dict:
    """The oracle: the same history (or protocol ``lines``) through ONE
    in-process service with a fresh in-memory cache, on ``device``
    under the same fold gate."""
    from ..stream.service import StreamService

    svc = StreamService(device=device, host_fold_max=host_fold_max)
    replies: list[dict] = []
    for line in lines if lines is not None else _op_lines("parity", h):
        svc.handle_line(line, replies.append)
    final = [d for d in replies if "final" in d]
    if not final:
        raise RuntimeError("the single service never finalized the "
                           "parity run")
    return _strip_cache(final[-1]["final"])


def _stream_via_router(port: int, runs: list) -> dict:
    """One synthetic client: stream every (run_id, history) over one
    router connection; returns finals and shed/error counts."""
    out = {"finals": {}, "overloaded": 0, "errors": 0}
    with socket.create_connection(("127.0.0.1", port), timeout=600) as s:
        w = s.makefile("w", encoding="utf-8")
        r = s.makefile("r", encoding="utf-8")
        for rid, h in runs:
            for line in _op_lines(rid, h):
                w.write(line + "\n")
            w.flush()
        s.shutdown(socket.SHUT_WR)
        for raw in r:
            raw = raw.strip()
            if not raw:
                continue
            d = json.loads(raw)
            if "final" in d:
                out["finals"][d["run"]] = d["final"]
            elif "overloaded" in d:
                out["overloaded"] += 1
            elif "error" in d:
                out["errors"] += 1
    return out


def _default_warm_shapes():
    """The steady-state shape set: the committed 1k trace's compile
    spans (read, never written), plus the small-segment shapes of short
    quiescence runs, as the JAX package's tier warms them."""
    from .warmup import WarmShape, load_shapes

    shapes = []
    trace = os.path.join(_REPO, "BENCH_trace_1k.json")
    if os.path.exists(trace):
        shapes = load_shapes(trace)
    seen = set(shapes)
    for n_det_pad in (64, 128, 256):
        for frontier in (64, 128):
            s = WarmShape(n_det_pad=n_det_pad, frontier=frontier)
            if s not in seen:
                seen.add(s)
                shapes.append(s)
    return shapes


def record_traffic_shapes(hists, *, device="cuda",
                          host_fold_max: int | None = None):
    """The slice-function shapes a sample of the traffic builds: the
    histories run through one in-process ``StreamService`` with tracing
    on, and the ``device.compile`` spans of the run become warm shapes
    (``warmup.shapes_from_trace``).  The kernel cache is then put back
    as it was, so that a warm boot builds those functions itself."""
    from .. import obs
    from ..checker import linearizable as lin
    from .warmup import shapes_from_trace

    keys0 = set(lin._STEP_CACHE)
    was_on, run0 = obs.enabled(), obs.current_run()
    run = "fleet-traffic-shapes"
    obs.enable(True)
    obs.set_run(run)
    try:
        for h in hists:
            _single_service_final(h, device=device,
                                  host_fold_max=host_fold_max)
        doc = obs.chrome_trace(run)
    finally:
        obs.set_run(run0)
        obs.enable(was_on)
        obs.drop_recorder(run)
        for k in set(lin._STEP_CACHE) - keys0:
            del lin._STEP_CACHE[k]
    return shapes_from_trace(doc)


class Fleet:
    """An in-process tier: ``n`` stream workers, each on its own segment
    of one ``FleetCacheStore`` root with a shared persist dir, and the
    router (probes started) in front.  :meth:`close` stops it all."""

    def __init__(self, root: str, *, n: int = 2, device="cuda",
                 host_fold_max: int | None = None,
                 probe_interval: float = 0.25, backoff_factory=None):
        from ..stream.service import make_server
        from .cachestore import FleetCacheStore
        from .router import FleetRouter, WorkerSpec, make_router_server

        self.persist = os.path.join(root, "persist")
        self.servers, self.specs, self.caches = [], [], []
        for i in range(n):
            cache = FleetCacheStore(os.path.join(root, "cache"),
                                    worker_id=f"w{i}")
            self.caches.append(cache)
            srv = make_server("127.0.0.1", 0, cache=cache,
                              persist_dir=self.persist, device=device,
                              host_fold_max=host_fold_max)
            threading.Thread(target=srv.serve_forever, daemon=True,
                             name=f"fleet-worker-w{i}").start()
            self.servers.append(srv)
            self.specs.append(WorkerSpec(f"w{i}", "127.0.0.1",
                                         srv.server_address[1],
                                         self.persist))
        kw = {} if backoff_factory is None else {
            "backoff_factory": backoff_factory}
        self.router = FleetRouter(self.specs,
                                  probe_interval=probe_interval, **kw)
        self.router.start_probes()
        self.rsrv = make_router_server("127.0.0.1", 0, self.router)
        threading.Thread(target=self.rsrv.serve_forever, daemon=True,
                         name="fleet-router").start()
        self.port = self.rsrv.server_address[1]

    def kill(self, wid: str) -> None:
        """Stop worker ``wid`` answering (its probes then fail): the
        router's dead-worker path takes its runs."""
        for srv, spec in zip(self.servers, self.specs):
            if spec.wid == wid:
                srv.shutdown()
                srv.server_close()

    def close(self) -> None:
        self.router.stop_probes()
        self.rsrv.shutdown()
        self.rsrv.server_close()
        for srv in self.servers:
            try:
                srv.shutdown()
                srv.server_close()
            except OSError:
                pass
        for cache in self.caches:
            cache.close()


def run_swarm(port: int, rungs, runs_per_client: int, n_ops: int, *,
              seed: int = 1000):
    """The client swarm at the router, rung by rung: ``clients``
    concurrent clients, each streaming ``runs_per_client`` runs of
    ``n_ops`` ops.  Returns ``(ramp, finals, histories)``, finals and
    histories by run id."""
    ramp = []
    all_finals: dict = {}
    all_hist: dict = {}
    for clients in rungs:
        plans = []
        for _c in range(clients):
            runs = []
            for _j in range(runs_per_client):
                seed += 1
                rid = f"s{seed}"
                h = _mk_history(seed, n_ops)
                all_hist[rid] = h
                runs.append((rid, h))
            plans.append(runs)
        results: list = [None] * clients
        t0 = time.perf_counter()
        threads = [threading.Thread(
            target=lambda i=i, p=p: results.__setitem__(
                i, _stream_via_router(port, p)))
            for i, p in enumerate(plans)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        events = sum(len(h) for p in plans for _rid, h in p)
        finals = {}
        shed = errors = 0
        for res in results:
            finals.update(res["finals"])
            shed += res["overloaded"]
            errors += res["errors"]
        all_finals.update(finals)
        ramp.append({
            "clients": clients,
            "runs": clients * runs_per_client,
            "finals": len(finals),
            "events_total": events,
            "wall_s": round(wall, 4),
            "events_per_sec": round(events / wall, 1) if wall else None,
            "overloaded": shed,
            "errors": errors,
            "shed_rate": round(shed / max(1, shed + events), 4),
        })
    return ramp, all_finals, all_hist


def throughput_knee(ramp: list) -> dict:
    """The last rung whose events/s beat the one before by 15%, and the
    peak."""
    best = max(ramp, key=lambda r: r["events_per_sec"] or 0)
    knee = ramp[0]
    for prev, cur in zip(ramp, ramp[1:]):
        if (cur["events_per_sec"] or 0) \
                < 1.15 * (prev["events_per_sec"] or 1):
            knee = prev
            break
        knee = cur
    return {"clients": knee["clients"],
            "events_per_sec": knee["events_per_sec"],
            "peak_clients": best["clients"],
            "peak_events_per_sec": best["events_per_sec"]}


def parity_check(finals: dict, hists: dict, *, device="cuda",
                 host_fold_max: int | None = None,
                 sample: int | None = _PARITY_SAMPLE) -> dict:
    """Routed finals against the single service, on ``sample`` runs
    drawn with a fixed seed (``None``: every run)."""
    rids = sorted(finals)
    if sample is not None:
        rids = random.Random(7).sample(rids, min(sample, len(rids)))
    out = {"parity": True, "checked": len(rids), "runs": len(finals)}
    for rid in rids:
        want = _single_service_final(hists[rid], device=device,
                                     host_fold_max=host_fold_max)
        got = _strip_cache(finals[rid])
        if got != want:
            out["parity"] = False
            out.setdefault("diffs", []).append(
                {"run": rid, "routed": got, "single": want})
    return out


def run_fleet_tier(*, quick: bool = False, out_path: str | None = None,
                   trace_path: str | None = None, device="cuda") -> dict:
    """The tier at 400-op runs, 3 per client, rungs 1 to 8 (120 ops, 2
    per client, rungs 1 to 4 with ``quick``), its workers folding on
    ``device`` under the service's default gate, as the JAX package's
    tier runs.  Returns the numbers; writes them to ``out_path`` and the
    trace to ``trace_path`` when given."""
    from .. import obs as _obs

    was_on = _obs.enabled()
    _obs.enable(True)
    try:
        return _run_fleet_tier(quick, out_path, trace_path, device)
    finally:
        _obs.enable(was_on)


def _run_fleet_tier(quick, out_path, trace_path, device):
    from .. import obs as _obs
    from ..checker import linearizable as lin
    from .warmup import warm_boot

    n_ops = 120 if quick else 400
    runs_per_client = 2 if quick else 3
    rungs = [1, 2, 4] if quick else [1, 2, 4, 8]
    out: dict = {"metric": "fleet tier: routed multi-worker checking",
                 "quick": quick, "workers": 2, "n_ops": n_ops,
                 "runs_per_client": runs_per_client,
                 "device": str(lin._resolve_device(device))}

    # the warm set: the JAX package's, and the shapes a sample of the
    # traffic (seeds the swarm does not use) builds
    shapes = _default_warm_shapes()
    seen = set(shapes)
    shapes += [s for s in record_traffic_shapes(
        [_mk_history(seed, n_ops) for seed in (2001, 2002)],
        device=device) if s not in seen]
    out["warmup"] = warm_boot(shapes, device=device)

    with tempfile.TemporaryDirectory(prefix="fleet-bench-") as tmp:
        fleet = Fleet(tmp, device=device)
        try:
            misses0 = lin.KERNEL_CACHE_STATS["misses"]
            ramp, finals, hists = run_swarm(fleet.port, rungs,
                                            runs_per_client, n_ops)
            out["steady_state_compile_misses"] = (
                lin.KERNEL_CACHE_STATS["misses"] - misses0)
            out["ramp"] = ramp
            out["knee"] = throughput_knee(ramp)
            par = parity_check(finals, hists, device=device)
            out["parity"] = par["parity"]
            out["parity_sampled"] = par["checked"]
            out["parity_total_runs"] = par["runs"]
            if "diffs" in par:
                out["parity_diffs"] = par["diffs"]
            stats = fleet.router.aggregate_stats()
            out["scrape"] = {
                "n_workers": stats.get("n_workers"),
                "has_routed_counter": "jtpu_fleet_routed_total" in stats,
                "has_stream_ops":
                    "jtpu_stream_ops_ingested_total" in stats,
            }
        finally:
            fleet.close()

    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    if trace_path is not None:
        _obs.write_trace(trace_path)
    return out
