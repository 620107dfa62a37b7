"""Fleet router: one front door, N ``stream.service`` workers.

Clients speak the unchanged stream line protocol to the router; the
router rendezvous-hashes each ``run_id`` onto a worker and forwards
the run's lines over a per-worker upstream connection, pumping worker
replies straight back.  What the fleet adds over one big service:

**Routing** (:func:`route_run`) is rendezvous (highest-random-weight)
hashing: every (run, worker) pair gets a deterministic score and the
run goes to its max.  Adding a worker moves only the runs that now
score higher on it (~1/N of the keyspace); removing one moves ONLY its
own runs — no re-shuffle of survivors, which matters because a moved
run means a re-checked prefix.

**Health** — a probe loop per worker on a ``reconnect.Backoff``
schedule: probe, on failure sleep the jittered backoff step and probe
again, and when the schedule is exhausted declare the worker dead and
take it out of the ring.  A success resets the schedule, so a worker
that recovers re-ramps from the base delay.

**Salvage** — a dead worker's open runs are not lost: workers run
with ``--persist-dir`` on shared storage, and the existing
abandon/persist path (stream/service.py) lands every open run's
prefix verdict in ``<persist>/<run>.json`` when the upstream
connection drops.  The router reads that snapshot back, answers the
client with a ``final`` (``finalized_by: "salvage"``), and re-routes
the run's future lines onto the survivors by replaying its header.

**One scrape** — the router's own ``/metrics`` and ``/api/stats``
answer with the MERGED view: every live worker is scraped and the
series are relabelled with ``worker="<id>"`` (text) / summed
(snapshot), so a fleet dashboard needs one target, not N.

The JAX package's ``fleet/router.py`` over the port's stream service:
the same hashing (so both packages place a run on the same worker id),
probes, salvage and merges.  The workers' folds run on their own
``device``; the router runs none.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import socket
import socketserver
import threading
import time

from ..obs import metrics as obs_metrics
from ..reconnect import Backoff
from ..stream.service import _safe_run_id

log = logging.getLogger(__name__)

_M_ROUTED = obs_metrics.REGISTRY.counter(
    "jtpu_fleet_routed_total",
    "Run headers routed to a worker, by worker id", ("worker",))
_M_REROUTED = obs_metrics.REGISTRY.counter(
    "jtpu_fleet_rerouted_total",
    "Runs re-routed off their worker, by reason", ("reason",))
_M_SALVAGED = obs_metrics.REGISTRY.counter(
    "jtpu_fleet_salvaged_total",
    "Dead-worker open runs finalized from the persist-dir salvage "
    "path")
_M_PROBES = obs_metrics.REGISTRY.counter(
    "jtpu_fleet_probe_total",
    "Worker health probes, by result (ok/failed/dead)", ("result",))
_M_WORKERS = obs_metrics.REGISTRY.gauge(
    "jtpu_fleet_workers",
    "Live (admitted, probe-passing) workers behind the router")


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One checking-service worker the router can route at."""

    wid: str
    host: str
    port: int
    persist_dir: str | None = None


# ---------------------------------------------------------------------------
# rendezvous hashing
# ---------------------------------------------------------------------------


def rendezvous_score(wid: str, run_id: str) -> int:
    """Deterministic (worker, run) weight — blake2b over both ids, so
    the ring needs no virtual nodes and no shared state."""
    h = hashlib.blake2b(f"{wid}\x00{run_id}".encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


def route_run(run_id: str, workers) -> WorkerSpec | None:
    """Highest-random-weight choice over ``workers`` (iterable of
    WorkerSpec); ties break on wid so the choice is total."""
    best = None
    best_key = None
    for w in workers:
        key = (rendezvous_score(w.wid, str(run_id)), w.wid)
        if best_key is None or key > best_key:
            best, best_key = w, key
    return best


# ---------------------------------------------------------------------------
# scrape plumbing
# ---------------------------------------------------------------------------


def _http_get(host: str, port: int, target: str, *,
              timeout: float = 2.0) -> bytes:
    """Minimal HTTP/1.0 GET against a worker's protocol port (the
    stream service answers scrapes on the same socket)."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(f"GET {target} HTTP/1.0\r\n\r\n".encode())
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    head, _, body = buf.partition(b"\r\n\r\n")
    if not head.startswith(b"HTTP/") or b" 200 " not in head.split(
            b"\r\n", 1)[0] + b" ":
        raise OSError(f"scrape {target} failed: "
                      f"{head.splitlines()[:1]!r}")
    return body


_SERIES_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


def merge_metrics_texts(texts: dict) -> str:
    """Merge per-worker Prometheus texts into one exposition: every
    series gains a ``worker="<id>"`` label; HELP/TYPE lines are
    deduplicated by metric name.  Worker ids come from the dict keys
    (ordered), so the output is deterministic for a given scrape."""
    helps: list[str] = []
    seen_meta = set()
    series: list[str] = []
    for wid, text in texts.items():
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                # keep each (HELP|TYPE, metric) line the first time
                parts = line.split(None, 3)
                if len(parts) >= 3:
                    key = (parts[1], parts[2])
                    if key in seen_meta:
                        continue
                    seen_meta.add(key)
                helps.append(line)
                continue
            m = _SERIES_RE.match(line)
            if not m:
                continue
            name, labels, value = m.groups()
            if labels:
                inner = labels[1:-1]
                labels = '{worker="%s",%s}' % (wid, inner)
            else:
                labels = '{worker="%s"}' % wid
            series.append(f"{name}{labels} {value}")
    return "\n".join(helps + series) + "\n"


def merge_snapshots(snaps: dict) -> dict:
    """Merge per-worker ``/api/stats`` snapshots: numeric values are
    summed across workers (labelled dicts key-wise), the ``derived``
    block is dropped (ratios do not sum), and the raw per-worker
    snapshots ride along under ``workers`` for drill-down."""

    def _merge_val(a, b):
        if isinstance(a, dict) or isinstance(b, dict):
            a = a if isinstance(a, dict) else {}
            b = b if isinstance(b, dict) else {}
            return {k: _merge_val(a.get(k, 0), b.get(k, 0))
                    for k in set(a) | set(b)}
        try:
            return (a or 0) + (b or 0)
        except TypeError:
            return b if b is not None else a

    merged: dict = {}
    for snap in snaps.values():
        for name, entry in snap.items():
            if name == "derived" or not isinstance(entry, dict):
                continue
            cur = merged.get(name)
            if cur is None:
                merged[name] = {"type": entry.get("type"),
                                "help": entry.get("help"),
                                "values": entry.get("values", 0)}
            else:
                cur["values"] = _merge_val(cur["values"],
                                           entry.get("values", 0))
    return {"workers": dict(snaps),
            "n_workers": len(snaps),
            **{name: e for name, e in merged.items()}}


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


def _default_backoff() -> Backoff:
    # probe ramp: 50ms .. 2s, 8 attempts ≈ a few seconds from first
    # failure to a dead verdict — fast enough that clients notice a
    # crash as one salvaged final, slow enough to ride out a GC pause
    return Backoff(base=0.05, cap=2.0, factor=2.0, max_attempts=8,
                   jitter=0.5)


class FleetRouter:
    """Worker ring + health + salvage — the policy object the TCP
    front end (:func:`make_router_server`) and the fleet supervisor
    (fleet/__main__.py) share."""

    def __init__(self, workers=(), *, admission=None,
                 probe_interval: float = 0.25,
                 backoff_factory=_default_backoff,
                 require_warmup: bool = False,
                 on_spawn=None):
        #: called (no args, any thread) when admission decides
        #: "spawn-worker" — the supervisor's scale-up hook
        self.on_spawn = on_spawn
        self._lock = threading.RLock()
        self._workers: dict[str, WorkerSpec] = {}
        self._dead: dict[str, WorkerSpec] = {}
        self._backoffs: dict[str, Backoff] = {}
        self._backoff_factory = backoff_factory
        self.admission = admission
        self.probe_interval = probe_interval
        self.require_warmup = require_warmup
        self._probe_stop = threading.Event()
        self._probe_thread = None
        for w in workers:
            self.admit_worker(w)

    # -- membership ----------------------------------------------------

    def admit_worker(self, spec: WorkerSpec,
                     warmup_report: dict | None = None) -> bool:
        """Add a worker to the ring.  With ``require_warmup`` the
        worker must present a verified warm-boot report
        (fleet/warmup.py) — a cold worker is NOT admitted: routing
        runs at it would spend their first seconds compiling."""
        if self.require_warmup and not (
                warmup_report and warmup_report.get("verified")):
            log.warning("fleet: worker %s refused admission "
                        "(warmup report %r not verified)",
                        spec.wid, warmup_report)
            return False
        with self._lock:
            self._workers[spec.wid] = spec
            self._dead.pop(spec.wid, None)
            self._backoffs[spec.wid] = self._backoff_factory()
            _M_WORKERS.set(len(self._workers))
        return True

    def remove_worker(self, wid: str, *, reason: str = "leave") -> None:
        log.info("fleet: worker %s leaves the ring (%s)", wid, reason)
        with self._lock:
            spec = self._workers.pop(wid, None)
            if spec is not None:
                self._dead[wid] = spec
            self._backoffs.pop(wid, None)
            _M_WORKERS.set(len(self._workers))

    def workers(self) -> list[WorkerSpec]:
        with self._lock:
            return list(self._workers.values())

    def worker(self, wid: str) -> WorkerSpec | None:
        with self._lock:
            return self._workers.get(wid) or self._dead.get(wid)

    def is_live(self, wid: str) -> bool:
        with self._lock:
            return wid in self._workers

    # -- routing -------------------------------------------------------

    def route(self, run_id: str) -> WorkerSpec | None:
        return route_run(run_id, self.workers())

    # -- health --------------------------------------------------------

    def probe_worker(self, spec: WorkerSpec, *,
                     timeout: float = 1.0) -> bool:
        """One liveness probe: scrape ``/api/stats`` (proves the
        protocol loop answers, not merely that the port accepts)."""
        try:
            body = _http_get(spec.host, spec.port, "/api/stats",
                             timeout=timeout)
            json.loads(body.decode() or "{}")
        except (OSError, ValueError):
            _M_PROBES.inc(result="failed")
            return False
        _M_PROBES.inc(result="ok")
        return True

    def worker_failed(self, wid: str) -> None:
        """A forwarder hit a hard send/connect error: treat as dead
        immediately (the probe loop would get there anyway; a client
        mid-run shouldn't wait for it)."""
        if self.is_live(wid):
            log.warning("fleet: worker %s failed mid-stream; "
                        "removing from ring", wid)
            _M_PROBES.inc(result="dead")
            self.remove_worker(wid, reason="worker-died")

    def probe_all_once(self, *, sleep=time.sleep) -> None:
        """One probe round: each live worker probed once; a failing
        worker is re-probed on its Backoff schedule within this round
        and declared dead when the schedule exhausts."""
        for spec in self.workers():
            bo = self._backoffs.get(spec.wid)
            if bo is None:
                continue
            if self.probe_worker(spec):
                bo.reset()
                continue
            while not bo.exhausted():
                sleep(bo.step())
                if self.probe_worker(spec):
                    bo.reset()
                    break
            else:
                _M_PROBES.inc(result="dead")
                self.remove_worker(spec.wid, reason="probe-exhausted")

    def start_probes(self) -> None:
        if self._probe_thread is not None:
            return

        def loop():
            while not self._probe_stop.wait(self.probe_interval):
                try:
                    self.probe_all_once(
                        sleep=lambda s: self._probe_stop.wait(s))
                except Exception:  # noqa: BLE001 — probe must survive
                    log.warning("fleet: probe round failed",
                                exc_info=True)

        self._probe_thread = threading.Thread(
            target=loop, name="fleet-probes", daemon=True)
        self._probe_thread.start()

    def stop_probes(self) -> None:
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
            self._probe_thread = None

    # -- salvage -------------------------------------------------------

    def salvage_final(self, wid: str, run_id: str, *,
                      wait_s: float = 2.0) -> dict | None:
        """A dead worker's persisted snapshot for ``run_id``: the
        worker's abandon path (stream/service.py) finalizes open runs
        when its connection drops and lands ``{"...", "final": ...}``
        in its persist dir; we poll briefly for the final to appear
        (the worker may still be flushing as we arrive)."""
        spec = self.worker(wid)
        if spec is None or not spec.persist_dir:
            return None
        path = os.path.join(spec.persist_dir,
                            f"{_safe_run_id(run_id)}.json")
        deadline = time.monotonic() + wait_s
        snap = None
        while time.monotonic() < deadline:
            try:
                with open(path) as f:
                    snap = json.load(f)
            except (OSError, ValueError):
                snap = None
            if snap and "final" in snap:
                break
            time.sleep(0.05)
        if snap is None:
            return None
        _M_SALVAGED.inc()
        return snap

    # -- aggregation ---------------------------------------------------

    def scrape_workers(self, target: str) -> dict:
        """target -> {wid: payload} over the live ring (failed scrapes
        skipped; the probe loop deals with the worker)."""
        out = {}
        for spec in self.workers():
            try:
                out[spec.wid] = _http_get(spec.host, spec.port,
                                          target)
            except OSError:
                log.debug("fleet: scrape of %s failed", spec.wid,
                          exc_info=True)
        return out

    def aggregate_metrics(self) -> str:
        texts = {wid: body.decode()
                 for wid, body in
                 self.scrape_workers("/metrics").items()}
        # the router's own registry (routing/probe/salvage counters)
        # joins the merge as a pseudo-worker
        texts["router"] = obs_metrics.render()
        return merge_metrics_texts(texts)

    def aggregate_stats(self) -> dict:
        snaps = {}
        for wid, body in self.scrape_workers("/api/stats").items():
            try:
                snaps[wid] = json.loads(body.decode())
            except ValueError:
                continue
        snaps["router"] = obs_metrics.snapshot()
        return merge_snapshots(snaps)


# ---------------------------------------------------------------------------
# the TCP front end
# ---------------------------------------------------------------------------


class _Upstream:
    """One router->worker connection inside a client session: a
    socket, a writer file, and a reader thread pumping worker replies
    back to the client."""

    def __init__(self, spec: WorkerSpec, emit):
        self.spec = spec
        self.sock = socket.create_connection((spec.host, spec.port),
                                             timeout=10.0)
        self.sock.settimeout(None)
        self.wfile = self.sock.makefile("w", encoding="utf-8")
        self.rfile = self.sock.makefile("r", encoding="utf-8")
        self.thread = threading.Thread(
            target=self._pump, args=(emit,),
            name=f"fleet-pump-{spec.wid}", daemon=True)
        self.thread.start()

    def _pump(self, emit):
        try:
            for line in self.rfile:
                line = line.strip()
                if line:
                    emit(line)
        except (OSError, ValueError):
            pass

    def send(self, line: str) -> None:
        self.wfile.write(line + "\n")
        self.wfile.flush()

    def close_write(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def close(self, *, join: bool = True, alive=None) -> None:
        """Close the write side and, with ``join``, wait for the pump:
        it ends when the worker closes its side after its last reply.
        ``alive()`` (the worker still in the ring) bounds the wait; a
        fixed timeout would cut off the finals of a worker that is
        still working through the session's backlog."""
        self.close_write()
        if join:
            while self.thread.is_alive() and (alive is None or alive()):
                self.thread.join(timeout=0.5)
        try:
            self.sock.close()
        except OSError:
            pass


class _Session:
    """One client connection's routing state: which worker each run
    went to, the header to replay on re-route, which runs are open."""

    def __init__(self, router: FleetRouter, emit):
        self.router = router
        self.emit = emit  # takes a RAW json line (str)
        self.lock = threading.Lock()
        self.upstreams: dict[str, _Upstream] = {}
        self.run_worker: dict[str, str] = {}
        self.run_header: dict[str, str] = {}
        self.open_runs: set[str] = set()

    def _emit_obj(self, d: dict) -> None:
        self.emit(json.dumps(d, separators=(",", ":")))

    def _upstream(self, spec: WorkerSpec) -> _Upstream:
        up = self.upstreams.get(spec.wid)
        if up is None:
            def emit_line(line: str, _wid=spec.wid):
                # a 'final' reply closes the run in our books
                try:
                    d = json.loads(line)
                except ValueError:
                    d = {}
                rid = d.get("run")
                if rid is not None and ("final" in d
                                        or "error" in d):
                    with self.lock:
                        self.open_runs.discard(str(rid))
                self.emit(line)
            up = _Upstream(spec, emit_line)
            self.upstreams[spec.wid] = up
        return up

    def _salvage_and_reroute(self, run_id: str, dead_wid: str,
                             *, reroute: bool) -> WorkerSpec | None:
        """The dead-worker path for one run: drop the dead upstream,
        emit the salvaged final, and (for a run with more lines
        coming) replay its header at the survivor so the suffix keeps
        streaming."""
        up = self.upstreams.pop(dead_wid, None)
        if up is not None:
            up.close(join=False)
        self.router.worker_failed(dead_wid)
        snap = self.router.salvage_final(dead_wid, run_id)
        final = (snap or {}).get("final")
        if final is not None:
            final = dict(final)
            final["finalized_by"] = "salvage"
            self._emit_obj({"run": run_id, "final": final})
        elif snap is not None:
            self._emit_obj({"run": run_id, "live": snap,
                            "salvaged": True})
        else:
            self._emit_obj(
                {"run": run_id,
                 "error": f"worker {dead_wid} died with no "
                          f"salvageable snapshot for this run"})
        with self.lock:
            self.open_runs.discard(run_id)
        if not reroute:
            return None
        spec = self.router.route(run_id)
        if spec is None:
            self._emit_obj({"run": run_id,
                            "error": "no live workers"})
            return None
        _M_REROUTED.inc(reason="rerouted-after-death")
        header = self.run_header.get(run_id)
        try:
            up2 = self._upstream(spec)
            if header:
                up2.send(header)
                _M_ROUTED.inc(worker=spec.wid)
            self.run_worker[run_id] = spec.wid
            with self.lock:
                self.open_runs.add(run_id)
        except OSError:
            self.router.worker_failed(spec.wid)
            return None
        return spec

    def handle_line(self, raw: str) -> None:
        try:
            d = json.loads(raw)
        except ValueError:
            self._emit_obj({"run": None,
                            "error": "line is not valid JSON"})
            return
        if d.get("drain") and "run" not in d:
            # broadcast: every worker this session touched drains
            for up in list(self.upstreams.values()):
                try:
                    up.send(raw)
                except OSError:
                    self.router.worker_failed(up.spec.wid)
            return
        run_id = str(d.get("run")) if d.get("run") is not None \
            else None
        if run_id is None:
            self._emit_obj({"run": None,
                            "error": "line carries no run id"})
            return
        is_header = "model" in d and "op" not in d
        if is_header and self.router.admission is not None:
            from .admission import scale_signal

            decision = self.router.admission.decide(
                scale_signal(self.router.aggregate_stats()))
            if decision == "shed":
                self._emit_obj({"run": run_id,
                                "overloaded": "admission"})
                return
            if decision == "spawn-worker" \
                    and self.router.on_spawn is not None:
                try:
                    self.router.on_spawn()
                except Exception:  # noqa: BLE001 — advisory only
                    log.warning("fleet: spawn hook failed",
                                exc_info=True)
        wid = self.run_worker.get(run_id)
        spec = self.router.worker(wid) if wid else None
        if wid is None or spec is None \
                or not self.router.is_live(wid):
            if wid is not None:
                # our worker died between lines: salvage, then route
                # the rest of this run at a survivor
                spec = self._salvage_and_reroute(run_id, wid,
                                                 reroute=True)
                if spec is None:
                    return
            else:
                spec = self.router.route(run_id)
                if spec is None:
                    self._emit_obj({"run": run_id,
                                    "error": "no live workers"})
                    return
                self.run_worker[run_id] = spec.wid
        if is_header:
            self.run_header[run_id] = raw
            with self.lock:
                self.open_runs.add(run_id)
            _M_ROUTED.inc(worker=spec.wid)
        try:
            self._upstream(spec).send(raw)
        except OSError:
            replacement = self._salvage_and_reroute(
                run_id, spec.wid, reroute=not d.get("end"))
            if replacement is not None and not is_header \
                    and "op" in d:
                # the op that hit the dead socket continues the run on
                # the survivor (the salvaged prefix is already final;
                # the survivor checks the suffix as its own run)
                try:
                    self._upstream(replacement).send(raw)
                except OSError:
                    pass

    def close(self) -> None:
        # EOF from the client: close write sides so workers finalize
        # (their serve_lines sees EOF -> end_all), then join pumps so
        # every final reaches the client before we hang up
        for up in self.upstreams.values():
            up.close_write()
        for up in self.upstreams.values():
            up.close(alive=lambda wid=up.spec.wid: self.router.is_live(wid))


class _RouterHandler(socketserver.StreamRequestHandler):
    def handle(self):
        from ..stream.service import _SCRAPE_RE

        srv = self.server
        router: FleetRouter = srv.router
        first = self.rfile.peek(16)
        m = _SCRAPE_RE.match(first)
        if m:
            try:
                while True:
                    line = self.rfile.readline()
                    if not line or line in (b"\r\n", b"\n"):
                        break
            except OSError:
                pass
            target = m.group(2).decode()
            if target == "/metrics":
                body = router.aggregate_metrics().encode()
                ctype = ("text/plain; version=0.0.4; "
                         "charset=utf-8")
            else:
                body = json.dumps(router.aggregate_stats()).encode()
                ctype = "application/json"
            try:
                self.wfile.write(
                    b"HTTP/1.0 200 OK\r\n"
                    + f"Content-Type: {ctype}\r\n".encode()
                    + f"Content-Length: {len(body)}\r\n".encode()
                    + b"Connection: close\r\n\r\n" + body)
            except OSError:
                pass
            return
        wlock = threading.Lock()

        def emit(line: str) -> None:
            with wlock:
                try:
                    self.wfile.write((line + "\n").encode())
                    self.wfile.flush()
                except OSError:
                    pass

        session = _Session(router, emit)
        try:
            for raw in self.rfile:
                raw = raw.decode("utf-8", "replace").strip()
                if raw:
                    session.handle_line(raw)
        except OSError:
            pass
        finally:
            session.close()


class _RouterServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def make_router_server(host: str, port: int,
                       router: FleetRouter) -> _RouterServer:
    srv = _RouterServer((host, port), _RouterHandler)
    srv.router = router
    return srv
