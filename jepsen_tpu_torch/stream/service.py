"""The long-running checking service: many runs, one warm cache.

``python -m jepsen_tpu_torch.stream`` turns the incremental checker into a
service that ingests history JSONL from many concurrent test runs (over
stdin or a TCP socket) and answers with live verdicts.  All runs share
one :class:`~jepsen_tpu_torch.decompose.cache.VerdictCache`, so a
segment any run has folded is never searched again: the service pays
only for novel segments.  Every run's device-routed folds search on the
service's ``device`` (``"cuda"`` by default).

Line protocol (one JSON object per line, newline-delimited):

  in   {"run": ID, "model": NAME, "init": N, "width": W}   open a run
  in   {"run": ID, "op": {process, type, f, value}}        one event
  in   {"process": .., "type": .., ...}                    single-run
                                                           shorthand
  in   {"run": ID, "end": true}                            finalize
  in   {"drain": true}                 graceful drain: finalize every
                                       open run, admit no new ones
  out  {"run": ID, "live": {...}}      status changed (open ->
                                       valid-so-far -> invalid)
  out  {"run": ID, "final": {...}}     the final verdict + stream stats
  out  {"run": ID, "error": "..."}     a malformed line / unknown run
  out  {"run": ID, "overloaded": ...}  backpressure: the op was SHED
                                       (per-run op budget exhausted, or
                                       the connection's bounded ingest
                                       queue is full)

Backpressure: thousands of concurrent connections must degrade
predictably, not by OOM or unbounded latency.  Two independent guards:

  * **per-run op budget** (``op_budget``): past the budget, further ops
    for that run are shed with an ``overloaded`` reply; the run still
    finalizes normally and its final summary reports ``shed`` — the
    verdict is for exactly the admitted prefix.
  * **bounded ingest queue** (``ingest_max`` in :func:`serve_lines`):
    each connection's reader never blocks on checking — lines queue up
    to the bound, and when the checker can't keep up the line is shed
    with an ``overloaded`` reply instead of stalling the socket (or
    buffering without limit).

Graceful drain (the fleet router's rolling-restart primitive): the
protocol ``{"drain": true}`` line — or ``SIGTERM`` in ``--listen``
mode (see __main__.py / :func:`drain_server`) — finalizes every open
run (finals carry ``finalized_by: "drain"``), then refuses new run
admissions with an ``{"overloaded": "draining"}`` reply; the process
exits 0 once drained.  Nothing admitted is ever discarded: every open
run yields its prefix verdict on the way out, exactly the
disconnect/EOF salvage contract.

A line that fails on the host answers ``error`` and the service goes
on; a device-routed fold that raises (``stream.device.DeviceFoldError``)
is not answered away: it propagates out of :meth:`StreamService.
handle_line` and :func:`serve_lines`.

Model names are the shard scheduler's descriptors
(``decompose.schedule.model_from_descriptor``): register,
cas-register, mutex, multi-register (width), unordered-queue-N,
fifo-queue-N.
"""

from __future__ import annotations

import json
import logging
import os
import re
import socketserver
import threading
import time

from .. import obs
from ..history import Op
from ..obs import metrics as obs_metrics
from .device import DeviceFoldError

log = logging.getLogger("jepsen")

#: flight-recorder handles: backpressure sheds by reason, and how many
#: runs this process currently multiplexes (the fleet-health gauge the
#: /metrics scrape and /api/stats snapshot expose)
_M_SHED = obs_metrics.REGISTRY.counter(
    "jtpu_shed_total", "Ops/lines shed under backpressure, by reason",
    ("reason",))
_M_RUNS_OPEN = obs_metrics.REGISTRY.gauge(
    "jtpu_stream_runs_open",
    "Streaming runs currently open in this process")

#: default run id for the single-run (bare-op) shorthand
DEFAULT_RUN = "default"


def _safe_run_id(run_id: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", str(run_id))[:120]


def result_summary(result: dict, *, max_frontier: int = 16) -> dict:
    """The JSON-line form of a final result: verdict, engine, stream
    stats, and a bounded certificate summary (a 10k-op linearization
    does not belong on a protocol line)."""
    out = {"valid": result.get("valid"),
           "engine": result.get("engine"),
           "configs": result.get("configs"),
           "stream": result.get("stream")}
    lin = result.get("linearization")
    if lin is not None:
        out["witness_ops"] = len(lin)
    elif result.get("witness_dropped"):
        out["witness_dropped"] = result["witness_dropped"]
    fr = result.get("final_ops")
    if fr is not None:
        out["final_ops"] = list(fr[:max_frontier])
        out["frontier_ops"] = len(fr)
    elif result.get("frontier_dropped"):
        out["frontier_dropped"] = result["frontier_dropped"]
    if result.get("audit") is not None:
        out["audit"] = result["audit"]
    return out


class StreamService:
    """Multiplexes JSONL lines onto per-run :class:`StreamChecker`\\ s.

    One instance per connection namespace; the verdict cache (and its
    lock-free append-only jsonl) is shared across every instance the
    process creates — that is the fleet-reuse story."""

    def __init__(self, *, model=None, cache=None, witness: bool = True,
                 audit: bool | None = None,
                 host_fold_max: int | None = None,
                 info_lookahead: int | None = None,
                 op_budget: int | None = None,
                 persist_dir: str | None = None,
                 idle_timeout: float | None = None,
                 conn: str | None = None,
                 drain_parent=None,
                 device="cuda",
                 device_budget: int = 2_000_000):
        from ..checker.linearizable import _resolve_device

        self.default_model = model
        #: where every run's device-routed folds search
        self.device = _resolve_device(device)
        #: config budget per device-routed fold's search: past it a
        #: variant is undecided and the fold goes to the host sweep.
        #: Not on the reference's service, nor on ``make_server`` or
        #: the CLI: it is here so that ``chip_smoke.py`` can run its
        #: forced device-fold stream through the service with the
        #: budget that decides every variant of that stream.
        self.device_budget = device_budget
        #: anything with a truthy ``.draining`` attribute (the TCP
        #: server in --listen mode): a process-level drain covers
        #: every connection's service without touching each one
        self._drain_parent = drain_parent
        self._draining = False
        #: connection label for log attribution (TCP peer address);
        #: every service log line carries run_id=/conn= via obs.log_ctx
        #: so a multiplexed-run failure names its run and socket
        self.conn = conn
        self.cache = cache
        self.witness = witness
        self.audit = audit
        self.host_fold_max = host_fold_max
        self.info_lookahead = info_lookahead
        #: per-run admitted-op ceiling; None = unlimited
        self.op_budget = op_budget
        #: when set, each run keeps a live snapshot at
        #: persist_dir/<run>.json — finalize (normal, reaped, or the
        #: dropped-connection salvage) lands the final verdict there,
        #: so a verdict survives even a client that vanished
        self.persist_dir = persist_dir
        #: seconds of per-run silence before the reaper finalizes it
        #: (None = never): a client that opened a run and went away
        #: must not leak an open checker forever
        self.idle_timeout = idle_timeout
        self._runs: dict = {}
        self._status: dict = {}
        self._ops: dict = {}   # run -> admitted ops
        self._shed: dict = {}  # run -> ops shed past the budget
        self._last: dict = {}  # run -> monotonic last-activity
        self._lock = threading.RLock()  # handler vs reaper thread

    def _log(self, run_id: str | None = None) -> logging.LoggerAdapter:
        """The context-stamped logger for one run's lines."""
        return obs.log_ctx(log, run_id=run_id, conn=self.conn)

    @property
    def draining(self) -> bool:
        """New-run admission is closed — this namespace drained, or
        the owning server is draining process-wide."""
        return self._draining or bool(
            getattr(self._drain_parent, "draining", False))

    def drain(self, emit, *, reason: str = "drain") -> None:
        """Graceful drain: finalize every open run (finals labelled
        ``finalized_by: reason``) and stop admitting new ones.  The
        rolling-restart primitive — a drained worker owes nobody a
        verdict and can exit 0."""
        with self._lock:
            self._draining = True
        self.end_all(emit, reason=reason)

    def open_run(self, run_id: str, model) -> None:
        from .checker import StreamChecker

        if run_id not in self._runs:
            # re-opening an existing run replaces its checker below;
            # the open-runs gauge must count runs, not header lines
            _M_RUNS_OPEN.inc()
        live = None
        if self.persist_dir:
            live = os.path.join(self.persist_dir,
                                f"{_safe_run_id(run_id)}.json")
        self._runs[run_id] = StreamChecker(
            model, cache=self.cache, witness=self.witness,
            host_fold_max=self.host_fold_max,
            info_lookahead=self.info_lookahead, run_id=run_id,
            live_path=live, device=self.device,
            device_budget=self.device_budget)
        self._status[run_id] = "open"
        self._ops[run_id] = 0
        self._shed[run_id] = 0
        self._last[run_id] = time.monotonic()

    def _model_from(self, d: dict):
        from ..decompose.schedule import model_from_descriptor

        name = d["model"]
        init = int(d.get("init", 0))
        width = int(d.get("width", 1))
        return model_from_descriptor((name, (init,), width))

    def handle_line(self, line: str, emit) -> None:
        """Process one protocol line; ``emit(dict)`` writes a reply."""
        line = line.strip()
        if not line:
            return
        try:
            d = json.loads(line)
        except ValueError:
            emit({"run": None, "error": "malformed JSON line"})
            return
        if not isinstance(d, dict):
            emit({"run": None, "error": "expected a JSON object"})
            return
        with self._lock:
            self._handle(d, emit)

    def _handle(self, d: dict, emit) -> None:
        if d.get("drain") and "run" not in d and "op" not in d:
            self.drain(emit)
            return
        run_id = d.get("run", DEFAULT_RUN)
        self._last[run_id] = time.monotonic()
        try:
            if "model" in d:
                if self.draining:
                    _M_SHED.inc(reason="draining")
                    emit({"run": run_id, "overloaded": "draining"})
                    return
                self.open_run(run_id, self._model_from(d))
                return
            if d.get("end"):
                self.end_run(run_id, emit)
                return
            op = d.get("op")
            if op is None and "type" in d:
                op = d  # bare-op shorthand
            if op is None:
                emit({"run": run_id,
                      "error": "line carries neither model/op/end"})
                return
            chk = self._runs.get(run_id)
            if chk is None:
                if self.draining:
                    # a drained namespace admits nothing new — not even
                    # the bare-op shorthand's implicit open
                    _M_SHED.inc(reason="draining")
                    emit({"run": run_id, "overloaded": "draining"})
                    return
                if self.default_model is None:
                    emit({"run": run_id,
                          "error": f"unknown run {run_id!r} and no "
                                   f"default --model"})
                    return
                self.open_run(run_id, self.default_model)
                chk = self._runs[run_id]
            if self.op_budget is not None \
                    and self._ops.get(run_id, 0) >= self.op_budget:
                # shed, don't stall: the run keeps its verdict for the
                # admitted prefix; the client learns explicitly that
                # this op was dropped (first shed + every 1000th after,
                # so a hot run can't flood the reply stream either)
                shed = self._shed.get(run_id, 0) + 1
                self._shed[run_id] = shed
                _M_SHED.inc(reason="op-budget")
                if shed == 1 or shed % 1000 == 0:
                    emit({"run": run_id, "overloaded": "op-budget",
                          "budget": self.op_budget, "shed": shed})
                return
            self._ops[run_id] = self._ops.get(run_id, 0) + 1
            chk.ingest(Op.from_dict(op))
            v = chk.verdict()
            if v["status"] != self._status.get(run_id):
                self._status[run_id] = v["status"]
                emit({"run": run_id, "live": v})
        except DeviceFoldError:
            raise  # a device fault is not one bad line
        except Exception as e:  # noqa: BLE001 — one line, not the service
            self._log(run_id).warning("stream service: line failed: %s",
                                      e)
            emit({"run": run_id, "error": f"{type(e).__name__}: {e}"})

    def end_run(self, run_id: str, emit, *,
                reason: str | None = None,
                only_if_idle_for: float | None = None) -> None:
        with self._lock:
            if only_if_idle_for is not None:
                # the reaper decided on a stale snapshot; re-check
                # idleness under the SAME lock as the pop, so a run
                # whose client just resumed is never truncated
                t = self._last.get(run_id)
                if t is None or run_id not in self._runs \
                        or time.monotonic() - t <= only_if_idle_for:
                    return
            chk = self._runs.pop(run_id, None)
            if chk is not None:
                _M_RUNS_OPEN.dec()
            self._status.pop(run_id, None)
            self._ops.pop(run_id, None)
            self._last.pop(run_id, None)
            shed = self._shed.pop(run_id, 0)
        if chk is None:
            emit({"run": run_id, "error": f"unknown run {run_id!r}"})
            return
        result = chk.finalize(audit=self.audit)
        # with tracing on, every fold/fork span landed in this run's
        # ring buffer; the run is over, so the buffer must go — a
        # service multiplexing thousands of runs cannot keep one per
        # run id forever
        obs.drop_recorder(run_id)
        summary = result_summary(result)
        if shed:
            summary["shed"] = shed
        if reason:
            summary["finalized_by"] = reason
        emit({"run": run_id, "final": summary})

    def end_all(self, emit, *, reason: str | None = None) -> None:
        """EOF / disconnect: every still-open run yields its verdict for
        the prefix it recorded — nothing ingested is ever discarded.
        A run whose device fold failed does not stop the others: each
        is finalized, then the first device error is raised."""
        err = None
        for run_id in list(self._runs):
            try:
                self.end_run(run_id, emit, reason=reason)
            except DeviceFoldError as e:
                err = err or e
        if err is not None:
            raise err

    def abandon(self) -> None:
        """The connection died without finalizing (TCP reset, broken
        pipe): finalize every open run with NOBODY listening — the
        prefix verdict still lands in the verdict cache and, with
        ``persist_dir``, on disk — instead of leaking the run open."""
        self.end_all(lambda d: None, reason="connection-dropped")

    def reap_idle(self, emit, *, now: float | None = None) -> list:
        """Finalize runs silent for longer than ``idle_timeout``;
        returns the reaped run ids.  The idle-run reaper knob: a
        service holding thousands of concurrent runs must not let a
        vanished client pin a checker (and its memory) forever."""
        if self.idle_timeout is None:
            return []
        now = time.monotonic() if now is None else now
        with self._lock:
            stale = [r for r, t in self._last.items()
                     if r in self._runs and now - t > self.idle_timeout]
            for r in [r for r in self._last if r not in self._runs]:
                del self._last[r]
        reaped = []
        for run_id in stale:
            before = run_id in self._runs
            self.end_run(run_id, emit, reason="idle-reaper",
                         only_if_idle_for=self.idle_timeout)
            if before and run_id not in self._runs:
                self._log(run_id).info("stream service: reaped idle run")
                reaped.append(run_id)
        return reaped


def serve_lines(service: StreamService, lines, emit, *,
                ingest_max: int = 0) -> int:
    """Drain an iterable of protocol lines through the service; returns
    how many lines were shed.

    ``ingest_max=0`` processes inline (reader == checker: the socket
    itself is the backpressure).  ``ingest_max>0`` decouples them: the
    reader feeds a bounded queue a worker thread drains, and when the
    checker falls behind by more than the bound, the line is SHED with
    an explicit ``overloaded`` reply — bounded memory and a socket that
    never stalls, the degradation mode thousands of connections need.

    Every exit finalizes every open run: the normal EOF path emits the
    finals; an error path (reader died, client hung up mid-history)
    salvages them silently (:meth:`StreamService.abandon`) so the
    prefix verdict still lands in the cache/persist-dir instead of
    leaking the run open.  When the service carries an
    ``idle_timeout``, a reaper thread finalizes silent runs while the
    connection idles."""
    reaper_stop = None
    if service.idle_timeout is not None:
        reaper_stop = threading.Event()

        def _reap_loop() -> None:
            tick = max(0.05, min(1.0, service.idle_timeout / 4.0))
            while not reaper_stop.wait(tick):
                try:
                    service.reap_idle(emit)
                except Exception:  # noqa: BLE001 — reaper best-effort
                    log.debug("stream service: reaper failed",
                              exc_info=True)

        threading.Thread(target=_reap_loop, name="stream-reaper",
                         daemon=True).start()
    try:
        return _serve_lines(service, lines, emit,
                            ingest_max=ingest_max)
    except BaseException:
        # the connection died mid-history without finalizing: salvage
        # a prefix verdict for every open run, then surface the error
        service.abandon()
        raise
    finally:
        if reaper_stop is not None:
            reaper_stop.set()


def _serve_lines(service: StreamService, lines, emit, *,
                 ingest_max: int) -> int:
    if ingest_max <= 0:
        for line in lines:
            service.handle_line(line, emit)
        service.end_all(emit)
        return 0

    import queue as _queue

    q: _queue.Queue = _queue.Queue(maxsize=ingest_max)
    _EOF = object()
    broken: list = []  # the worker's fatal error, re-raised after join

    def worker() -> None:
        # a dead emit (client hung up) must not leave the reader
        # blocked on a full queue: keep draining, surface the error
        # after the join.  Lines already queued are still ADMITTED
        # (with nobody listening) — the client sent them before dying,
        # and the salvaged prefix verdict should cover them
        while True:
            item = q.get()
            if item is _EOF:
                return
            try:
                service.handle_line(
                    item, (lambda d: None) if broken else emit)
            except Exception as e:  # noqa: BLE001 — connection-fatal
                broken.append(e)

    t = threading.Thread(target=worker, name="stream-ingest",
                         daemon=True)
    t.start()
    shed = 0
    for line in lines:
        try:
            q.put_nowait(line)
        except _queue.Full:
            shed += 1
            _M_SHED.inc(reason="ingest-queue")
            if shed == 1 or shed % 1000 == 0:
                try:
                    emit({"run": None, "overloaded": "ingest-queue",
                          "queue": ingest_max, "shed": shed})
                except Exception as e:  # noqa: BLE001 — same contract
                    broken.append(e)
                    break
    q.put(_EOF)  # blocking put: drains behind whatever is queued
    t.join()
    if broken:
        raise broken[0]
    service.end_all(emit)
    return shed


def serve_stdio(service: StreamService, stdin, stdout, *,
                ingest_max: int = 0) -> None:
    """The stdin/stdout loop (one writer thread: replies are lines)."""
    lock = threading.Lock()

    def emit(d: dict) -> None:
        with lock:
            stdout.write(json.dumps(d, separators=(",", ":")) + "\n")
            stdout.flush()

    serve_lines(service, stdin, emit, ingest_max=ingest_max)


#: HTTP request lines the JSONL port also answers — a Prometheus
#: scraper (or curl) pointed at the service port gets its metrics
#: without a second listener to deploy
_SCRAPE_RE = re.compile(rb"^(GET|HEAD)\s+(/metrics|/api/stats)\b")


def _http_scrape(wfile, target: str) -> None:
    """One-shot HTTP/1.0 response on the protocol socket: the process
    registry as Prometheus text (``/metrics``) or the JSON snapshot
    (``/api/stats``)."""
    if target == "/metrics":
        body = obs_metrics.render().encode()
        ctype = "text/plain; version=0.0.4; charset=utf-8"
    else:
        body = json.dumps(obs_metrics.snapshot()).encode()
        ctype = "application/json"
    wfile.write(b"HTTP/1.0 200 OK\r\n"
                + f"Content-Type: {ctype}\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n".encode()
                + body)


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        # each connection is its own run namespace (two fleets may both
        # call their run "r1"); the verdict cache is the shared part
        srv: _TCPServer = self.server
        conn = "%s:%s" % self.client_address[:2]
        clog = obs.log_ctx(log, conn=conn)
        try:
            first = self.rfile.readline()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # a probe that connected and reset without a byte is not
            # worth a traceback (load balancers do this all day)
            clog.debug("stream service: connection reset before any "
                       "input")
            return
        m = _SCRAPE_RE.match(first)
        if m:
            # a metrics scrape, not a run: drain the request headers
            # (closing with unread bytes makes the kernel RST and can
            # truncate the reply mid-scrape), answer HTTP, hang up
            try:
                while True:
                    ln = self.rfile.readline()
                    if not ln or ln in (b"\r\n", b"\n"):
                        break
                _http_scrape(self.wfile, m.group(2).decode())
            except (BrokenPipeError, ConnectionResetError):
                pass
            return
        service = StreamService(model=srv.default_model,
                                cache=srv.cache, witness=srv.witness,
                                audit=srv.audit,
                                host_fold_max=srv.host_fold_max,
                                info_lookahead=srv.info_lookahead,
                                op_budget=srv.op_budget,
                                persist_dir=srv.persist_dir,
                                idle_timeout=srv.idle_timeout,
                                conn=conn, drain_parent=srv,
                                device=srv.device)
        lock = threading.Lock()

        def emit(d: dict) -> None:
            with lock:
                self.wfile.write(
                    (json.dumps(d, separators=(",", ":")) + "\n")
                    .encode())

        # registered so a process-level drain (SIGTERM ->
        # drain_server) can finalize THIS connection's open runs and
        # answer on its socket
        service._drain_emit = emit
        srv.services.add(service)

        import itertools

        lines = (raw.decode("utf-8", "replace")
                 for raw in itertools.chain([first] if first else [],
                                            self.rfile))
        try:
            serve_lines(service, lines, emit,
                        ingest_max=srv.ingest_max)
        except (BrokenPipeError, ConnectionResetError):
            # serve_lines already salvaged every open run's prefix
            # verdict (StreamService.abandon) before re-raising
            clog.debug("stream service: client dropped the connection")
        except OSError:
            # NOT a client hangup (disk trouble under --persist-dir,
            # socket weirdness): salvage still ran, but say so loudly
            clog.warning("stream service: connection failed",
                         exc_info=True)
        finally:
            srv.services.discard(service)
            service.abandon()  # no-op when end_all already ran


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    #: process-level drain flag every connection's StreamService reads
    #: (via drain_parent); flipped by drain_server
    draining = False


def drain_server(srv: "_TCPServer") -> int:
    """Gracefully drain a ``--listen`` server: stop admitting new runs
    on every connection (and every future one), finalize every open
    run with its final emitted on its own connection, then shut the
    server down.  Returns how many runs were finalized.  The SIGTERM
    handler (__main__.py) and the fleet router's rolling worker
    restarts call this; after it returns the process can exit 0."""
    srv.draining = True
    drained = 0
    for service in list(srv.services):
        emit = getattr(service, "_drain_emit", None) or (lambda d: None)
        before = len(service._runs)

        def safe_emit(d, _emit=emit):
            try:
                _emit(d)
            except Exception:  # noqa: BLE001 — client already gone
                pass

        try:
            service.drain(safe_emit)
        except Exception:  # noqa: BLE001 — drain is best-effort per conn
            log.warning("stream service: drain of one connection "
                        "failed", exc_info=True)
        drained += before - len(service._runs)
    srv.shutdown()
    return drained


def make_server(host: str, port: int, *, model=None, cache=None,
                witness: bool = True, audit: bool | None = None,
                host_fold_max: int | None = None,
                info_lookahead: int | None = None,
                op_budget: int | None = None,
                ingest_max: int = 0,
                persist_dir: str | None = None,
                idle_timeout: float | None = None,
                device="cuda") -> _TCPServer:
    from ..checker.linearizable import _resolve_device

    device = _resolve_device(device)
    srv = _TCPServer((host, port), _Handler)
    srv.draining = False
    srv.services = set()
    srv.default_model = model
    srv.cache = cache
    srv.witness = witness
    srv.audit = audit
    srv.host_fold_max = host_fold_max
    srv.info_lookahead = info_lookahead
    srv.op_budget = op_budget
    srv.ingest_max = ingest_max
    srv.persist_dir = persist_dir
    srv.idle_timeout = idle_timeout
    srv.device = device
    return srv
