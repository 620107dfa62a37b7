"""Test runner (reference L5) — orchestrates a whole run.

Reference: jepsen/src/jepsen/core.clj.  A test is a plain dict (schema
documented at core.clj:500-549).  `run` proceeds: logging → sessions →
OS setup → DB cycle (+ primary) → worker threads (one logically
single-threaded *process* per client thread + one nemesis) pulling ops
from the generator, journaling invocations and completions into the
history → log snarfing → checker → persistence.

Key semantics preserved exactly:

  * op shape invariants (core.clj:271-278): completions must be
    ok/fail/info with matching process and f;
  * client crash handling (core.clj:348-407): an invoke exception becomes
    an :info completion — the op *may* have happened — and the process id
    retires, its successor being process + concurrency, so the
    single-threaded-process invariant holds;
  * worker abort protocol (core.clj:155-245): any worker's setup/run
    failure aborts every worker; barrier-parked workers are released via
    the test's abort event;
  * nemesis ops journal into every active history (core.clj:315-327).
"""

from __future__ import annotations

import logging
import threading
import time
import traceback
from contextlib import contextmanager
from dataclasses import replace
from typing import Optional

from . import checker as checker_mod
from . import control, db as db_mod, obs, store
from . import generator as gen
from . import os as os_mod
from .history import Op, index as index_history
from .obs import metrics as obs_metrics
from .util import (AbortableBarrier, WithThreadName, WorkerAbort, fcatch,
                   real_pmap, relative_time, relative_time_nanos)

log = logging.getLogger("jepsen")

#: flight-recorder counters (module-scope handles: get-or-create per op
#: would put a registry lookup on the worker hot path)
_M_OPS = obs_metrics.REGISTRY.counter(
    "jtpu_ops_total", "Client worker op completions by type", ("type",))
_M_NEMESIS = obs_metrics.REGISTRY.counter(
    "jtpu_nemesis_ops_total", "Nemesis injections applied (completions)")


@contextmanager
def _phase(test: dict, name: str, cat: str):
    """One run phase: an obs span (the trace timeline) plus an always-on
    wall-clock entry in ``test["phase_s"]`` keyed by category — the
    cheap per-phase accounting campaign cells record even with tracing
    off."""
    t0 = time.perf_counter()
    with obs.span(name, cat=cat):
        try:
            yield
        finally:
            d = test.setdefault("phase_s", {})
            d[cat] = round(d.get(cat, 0.0)
                           + time.perf_counter() - t0, 4)


def synchronize(test: dict) -> None:
    """Block until all nodes arrive (core.clj:38-43)."""
    b = test.get("barrier")
    if b is not None and b != "no-barrier":
        b.wait()


def primary(test: dict):
    """The primary node (core.clj:51-54)."""
    return test["nodes"][0]


def _sink_op(test: dict, op: Op) -> None:
    """Feed the streaming op sink (stream/checker.py), when installed.

    Called under the history lock, so the sink sees events in exactly
    history order and its event counter equals the op's eventual
    :index.  A sink failure must never take down the run — the sink is
    an observer; it disarms itself and the post-hoc checker still
    decides.  A failed device fold (an inline sink's
    :class:`DeviceFoldError`) is kept and raised by
    :func:`_finalize_stream`, never dropped."""
    sink = test.get("__stream_check__")
    if sink is None:
        return
    try:
        sink.ingest(op)
    except Exception as e:  # noqa: BLE001 — observer, not the run
        from .stream.device import DeviceFoldError

        log.warning("stream checker sink failed; disabling",
                    exc_info=True)
        if isinstance(e, DeviceFoldError):
            test["__stream_error__"] = e
        test["__stream_check__"] = None
        try:
            sink.close()
        except Exception:  # noqa: BLE001
            pass


def conj_op(test: dict, op: Op) -> Op:
    """Append to the test's history (core.clj:45-49)."""
    hist = test["history"]
    with test["_history_lock"]:
        hist.append(op)
        _sink_op(test, op)
    return op


def log_op(op: Op) -> None:
    log.info("%s\t%s\t%s\t%s", op.process, op.type, op.f, op.value)


# ---------------------------------------------------------------------------
# Worker lifecycle (core.clj:145-245)
# ---------------------------------------------------------------------------


class Worker:
    """Synchronized setup/run/teardown with error recovery
    (core.clj:145-153)."""

    name = "worker"

    def abort(self) -> None:
        raise NotImplementedError

    def setup(self) -> None:
        pass

    def run(self) -> None:
        pass

    def teardown(self) -> None:
        pass


def do_worker(abort_all, worker: Worker) -> Optional[BaseException]:
    """setup → run → teardown; any phase's error aborts the fleet and is
    returned (core.clj:155-202)."""
    with WithThreadName(f"jepsen {worker.name}"):
        try:
            log.info("Starting %s", worker.name)
            worker.setup()
        except BaseException as t:
            log.warning("Error setting up %s: %s", worker.name, t)
            abort_all(worker)
            _teardown_quietly(worker)
            return t
        try:
            log.info("Running %s", worker.name)
            worker.run()
        except BaseException as t:
            if not isinstance(t, WorkerAbort):
                log.warning("Error running %s: %s", worker.name,
                            traceback.format_exc())
            abort_all(worker)
            _teardown_quietly(worker)
            return t
        return _teardown_quietly(worker)


def _teardown_quietly(worker: Worker) -> Optional[BaseException]:
    try:
        log.info("Stopping %s", worker.name)
        worker.teardown()
        return None
    except BaseException as t:
        log.warning("Error tearing down %s: %s", worker.name, t)
        return t


def run_workers(test: dict, workers: list[Worker]) -> None:
    """Spawn a thread per worker; if any crashed (other than via cascade
    abort), raise its error (core.clj:204-245)."""
    results: list = [None] * len(workers)
    aborting: dict = {}
    lock = threading.Lock()

    def abort_all(w):
        with lock:
            aborting.setdefault("worker", w)
        test["__abort__"].set()
        for other in workers:
            other.abort()

    # propagate the calling thread's *threads* binding into workers (the
    # reference's bound-fn, core.clj:219-224)
    bound_threads = getattr(gen._ctx, "threads", None)

    def run_one(i, w):
        if bound_threads is not None:
            with gen.with_threads(bound_threads):
                results[i] = do_worker(abort_all, w)
        else:
            results[i] = do_worker(abort_all, w)

    threads = [threading.Thread(target=run_one, args=(i, w), daemon=True)
               for i, w in enumerate(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    w = aborting.get("worker")
    if w is not None:
        err = results[workers.index(w)]
        if err is not None:
            raise err


# ---------------------------------------------------------------------------
# Client worker (core.clj:329-417)
# ---------------------------------------------------------------------------


def invoke_op(op: Op, test: dict, client, aborting) -> Op:
    """client.invoke with crash → :info conversion (core.clj:248-281)."""
    try:
        completion = client.invoke(test, op)
        completion = replace(completion, time=relative_time_nanos())
    except BaseException as e:
        if aborting.is_set():
            raise
        log.warning("Process %s crashed: %s", op.process, e)
        completion = replace(op, type="info", time=relative_time_nanos(),
                             error=f"indeterminate: {e}")
    assert completion.type in ("ok", "fail", "info"), (
        f"expected client invoke to return type ok/fail/info, got "
        f"{completion!r}")
    assert completion.process == op.process
    assert completion.f == op.f
    return completion


class ClientWorker(Worker):
    def __init__(self, test: dict, process: int, node):
        self.test = test
        self.node = node
        self.worker_number = process
        self.process = process
        self.client = None
        self.aborting = threading.Event()
        self.name = f"worker {process}"

    def abort(self):
        self.aborting.set()

    def setup(self):
        self.client = self.test["client"].open(self.test, self.node)
        self.client.setup(self.test)

    def run(self):
        test = self.test
        g = test["generator"]
        while True:
            if self.aborting.is_set():
                raise WorkerAbort("worker aborted")
            opd = gen.op_and_validate(g, test, self.process)
            if opd is None:
                return
            op = Op(process=self.process, type=opd.get("type", "invoke"),
                    f=opd.get("f"), value=opd.get("value"),
                    time=relative_time_nanos())
            log_op(op)

            stream_lint = test.get("__stream_lint__")
            if self.client is None:
                # lazily reopen after a crash (core.clj:362-377)
                try:
                    self.client = test["client"].open(test, self.node)
                except Exception as e:
                    log.warning("Error opening client: %s", e)
                    fail = replace(op, type="fail",
                                   error=["no-client", str(e)],
                                   time=relative_time_nanos())
                    conj_op(test, op)
                    conj_op(test, fail)
                    log_op(fail)
                    if stream_lint is not None:
                        stream_lint.on_complete(self.process)
                    self.client = None
                    continue

            conj_op(test, op)
            # gated, not just no-op'd: the span call itself would
            # build the f-string name and the attrs kwargs dict on
            # EVERY op even with tracing off — this is the per-op hot
            # path, and off must allocate nothing (tests/test_obs.py's
            # overhead guard)
            if obs.enabled():
                with obs.span(f"op:{op.f}", cat="op",
                              process=self.process):
                    completion = invoke_op(op, test, self.client,
                                           self.aborting)
            else:
                completion = invoke_op(op, test, self.client,
                                       self.aborting)
            _M_OPS.inc(type=completion.type)
            conj_op(test, completion)
            log_op(completion)
            if stream_lint is not None:
                # close the live-lint open-op entry for this process;
                # an :info retires the id below, so closing is right
                # for every completion type
                stream_lint.on_complete(self.process)
            if completion.type == "info":
                # indeterminate: this process is hung; cycle to a new
                # process id (core.clj:387-404)
                self.process += test["concurrency"]
                try:
                    self.client.close(test)
                except Exception:
                    pass
                self.client = None

    def teardown(self):
        if self.client is not None:
            self.client.teardown(self.test)
            self.client.close(self.test)


class NemesisWorker(Worker):
    """core.clj:419-441; ops journal into every active history."""

    name = "nemesis"

    def __init__(self, test: dict):
        self.test = test
        self.nemesis = None
        self.aborting = threading.Event()

    def abort(self):
        self.aborting.set()

    def setup(self):
        self.nemesis = self.test["nemesis"].setup(self.test) or \
            self.test["nemesis"]

    def _apply(self, op: Op) -> Op:
        test = self.test
        log_op(op)
        for hist, lock in list(test["active_histories"]):
            with lock:
                hist.append(op)
                if hist is test.get("history"):
                    _sink_op(test, op)
        try:
            with obs.span(f"nemesis:{op.f}", cat="nemesis"):
                completion = self.nemesis.invoke(test, op)
            _M_NEMESIS.inc()
            completion = replace(completion, time=relative_time_nanos())
        except BaseException as e:
            if self.aborting.is_set():
                raise
            log.warning("Nemesis crashed: %s", traceback.format_exc())
            completion = replace(op, type="info",
                                 time=relative_time_nanos(),
                                 error=f"indeterminate: {e}")
        assert completion.type == "info", (
            f"expected nemesis invoke to return type info, got "
            f"{completion!r}")
        for hist, lock in list(test["active_histories"]):
            with lock:
                hist.append(completion)
                if hist is test.get("history"):
                    _sink_op(test, completion)
        log_op(completion)
        return completion

    def run(self):
        test = self.test
        g = test["generator"]
        while True:
            if self.aborting.is_set():
                raise WorkerAbort("nemesis aborted")
            opd = gen.op_and_validate(g, test, "nemesis")
            if opd is None:
                return
            op = Op(process="nemesis", type=opd.get("type", "info"),
                    f=opd.get("f"), value=opd.get("value"),
                    time=relative_time_nanos())
            self._apply(op)

    def teardown(self):
        if self.nemesis is not None:
            self.nemesis.teardown(self.test)


# ---------------------------------------------------------------------------
# Environment scaffolding (core.clj:56-143)
# ---------------------------------------------------------------------------


def setup_primary(test: dict) -> None:
    """Primary protocol setup on node 1 (core.clj:88-94)."""
    d = test.get("db")
    if isinstance(d, db_mod.Primary):
        d.setup_primary(test, primary(test))


def snarf_logs(test: dict) -> None:
    """Download db log files into the store (core.clj:96-127)."""
    d = test.get("db")
    if not isinstance(d, db_mod.LogFiles):
        return
    log.info("Snarfing log files")

    def snarf(test, node):
        sess = control.session(node, test)
        for remote_path in d.log_files(test, node):
            local = store.path_mkdirs(
                test, str(node), remote_path.lstrip("/"))
            try:
                sess.download(remote_path, local)
            except Exception as e:
                log.info("%s couldn't be downloaded: %s", remote_path, e)

    control.on_nodes(test, snarf)


def with_os(test: dict):
    control.on_nodes(test,
                     lambda t, n: t["os"].setup(t, n))


def teardown_os(test: dict):
    control.on_nodes(test,
                     lambda t, n: t["os"].teardown(t, n))


def with_db(test: dict):
    control.on_nodes(test,
                     lambda t, n: db_mod.cycle(t["db"], t, n))
    setup_primary(test)


def teardown_db(test: dict):
    control.on_nodes(test,
                     lambda t, n: t["db"].teardown(t, n))


# ---------------------------------------------------------------------------
# run-case! and run! (core.clj:452-610)
# ---------------------------------------------------------------------------


def run_case(test: dict) -> list[Op]:
    """Spawn nemesis + clients, run one case, snarf logs, return history
    (core.clj:452-484)."""
    history: list[Op] = []
    lock = threading.RLock()
    test["history"] = history
    test["_history_lock"] = lock
    test["active_histories"].append((history, lock))

    nodes = test.get("nodes") or []
    client_nodes = ([None] * test["concurrency"] if not nodes else
                    [nodes[i % len(nodes)]
                     for i in range(test["concurrency"])])
    clients = [ClientWorker(test, i, n) for i, n in enumerate(client_nodes)]
    workers: list[Worker] = [NemesisWorker(test)] + clients
    try:
        run_workers(test, workers)
    finally:
        snarf_logs(test)
        test["active_histories"].remove((history, lock))
    return history


def prepare_test(test: dict) -> dict:
    """Fill in defaults (core.clj:550-566)."""
    test = dict(test)
    test.setdefault("start_time", store.time_str())
    test.setdefault("concurrency", len(test.get("nodes") or []) or 1)
    test.setdefault("os", os_mod.noop)
    from . import net as net_mod

    test.setdefault("net", net_mod.noop)
    test.setdefault("db", db_mod.noop)
    nodes = test.get("nodes") or []
    test.setdefault("barrier",
                    AbortableBarrier(len(nodes)) if nodes else "no-barrier")
    test["active_histories"] = []
    test["__abort__"] = threading.Event()
    lint = test.get("lint")
    if (lint is None or lint) and "__stream_lint__" not in test:
        # emit-time H001/H002 guard over the live generator stream: on
        # unless the test map's "lint" is False, the same opt-out as the
        # post-run history linter
        test["__stream_lint__"] = gen.StreamLinter()
    if test.get("stream") and "__stream_check__" not in test:
        # the streaming incremental checker (stream/checker.py): an op
        # sink next to the stream linter, folding quiescence segments
        # as they close so the verdict is live while workers still run.
        # Model-less multiset workloads (the queue families) get the
        # total-queue fold route instead; anything else stays post-hoc.
        model = test.get("model")
        if model is not None:
            from .stream.checker import StreamChecker

            cache = test.get("stream_cache")
            if cache == "store":
                from .decompose.cache import default_cache_path

                cache = default_cache_path()
            live = store.path(test, "live.json") if test.get("name") \
                else None
            # the checker resolves its device here, so a stream run
            # without the card fails before any worker starts
            test["__stream_check__"] = StreamChecker(
                model, async_folds=True, cache=cache, live_path=live,
                info_lookahead=test.get("stream_lookahead"),
                device=test.get("device", "cuda"),
                run_id=f"{test.get('name')}/{test['start_time']}"
                if test.get("name") else None)
        elif test.get("stream_fold") in ("total-queue", "set"):
            # the model-less multiset families (queue,
            # replicated-queue): the incremental total-queue/set fold
            # (stream/checker.py's TotalFoldStream) — the live verdict
            # flips at the deciding event (an unexpected delivery, a
            # short final drain) instead of waiting for the post-hoc
            # checker, and finalize stays bit-identical to it
            from .stream.checker import TotalFoldStream

            live = store.path(test, "live.json") if test.get("name") \
                else None
            test["__stream_check__"] = TotalFoldStream(
                test["stream_fold"], live_path=live,
                run_id=f"{test.get('name')}/{test['start_time']}"
                if test.get("name") else None)
        else:
            log.info("streaming requested but the test carries no "
                     "model; running post-hoc only")
    return test


def _finalize_stream(test: dict) -> Optional[dict]:
    """Flush + finalize the streaming op sink; returns its final result
    (the verdict of exactly the prefix the run recorded) or None.  A
    device fold that failed raises :class:`DeviceFoldError` out of here:
    a run whose device fold failed has no streamed verdict to hide
    behind.  Any other sink failure is logged and gives None."""
    from .stream.device import DeviceFoldError

    sink = test.pop("__stream_check__", None)
    err = test.pop("__stream_error__", None)
    if err is not None:
        raise err
    if sink is None:
        return None
    try:
        return sink.finalize()
    except DeviceFoldError:
        raise
    except Exception:  # noqa: BLE001 — the sink must not mask the run
        log.warning("stream checker finalize failed", exc_info=True)
        return None


def _export_trace(test: dict, run_id: str) -> None:
    """Land the run's span buffer as ``store/<run>/trace.json`` (the
    Chrome-trace file Perfetto and the web timeline panel load), then
    drop the buffer so a fleet process doesn't hold one per run."""
    if not obs.enabled():
        return
    try:
        if test.get("name"):
            obs.write_trace(store.path_mkdirs(test, "trace.json"),
                            run=run_id)
            obs.drop_recorder(run_id)
    except Exception:  # noqa: BLE001 — observer, not the run
        log.warning("trace export failed", exc_info=True)


def run(test: dict) -> dict:
    """Run a complete test; returns the test dict with :history and
    :results (core.clj:500-610)."""
    test = prepare_test(test)
    store.start_logging(test)
    # flight recorder: all spans below (workers, checkers, bucket
    # scheduler, stream folds) attribute to this run's ring buffer
    run_id = f"{test.get('name') or 'noname'}/{test['start_time']}"
    test["__obs_run__"] = run_id
    obs.set_run(run_id)
    run_span = obs.span("run", cat="run", run=run_id,
                        test_name=test.get("name"))
    run_span.__enter__()
    try:
        log.info("Running test: %s", test.get("name"))
        try:
            try:
                control.setup_sessions(test)
                with _phase(test, "os.setup", "setup"):
                    with_os(test)
                try:
                    with _phase(test, "db.setup", "setup"):
                        with_db(test)
                    try:
                        threads = list(range(test["concurrency"])) \
                            + ["nemesis"]
                        with gen.with_threads(threads):
                            with relative_time():
                                # wall-clock anchor of op :time = 0, for
                                # checkers that reason about absolute
                                # time (e.g. the chronos schedule
                                # checker)
                                test["start_wall_time"] = time.time()
                                with _phase(test, "workload",
                                            "workload"):
                                    test["history"] = run_case(test)
                        log.info("Run complete, writing")
                        if test.get("name"):
                            with obs.span("store.save", cat="store"):
                                store.save_1(test, test["history"])
                    finally:
                        teardown_db(test)
                finally:
                    teardown_os(test)
            finally:
                for s in (test.get("sessions") or {}).values():
                    try:
                        s.remote.disconnect(s.node)
                    except Exception:
                        pass
        except BaseException as e:
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                # the user is leaving NOW: finalizing could run a full
                # direct search (fallback path) — don't hold the exit
                raise
            # worker abort / setup / teardown failure: the op sink has
            # still recorded everything that reached the history, and a
            # crashed run owes its caller the verdict of that prefix
            # (open invokes finalize as the :info tail).  The streamed
            # result rides the exception AND the store, because this
            # path re-raises and the caller never sees the test dict.
            sres = _finalize_stream(test)
            if sres is not None:
                from .stream.service import result_summary

                results = {"valid": sres.get("valid"), "aborted": True,
                           "stream": result_summary(sres)}
                e.stream_results = results
                log.info("aborted run: streamed verdict for the "
                         "recorded prefix is %r", sres.get("valid"))
                if test.get("name"):
                    try:
                        store.save_1(test, test.get("history") or [])
                        store.save_2(test, results)
                    except Exception:  # noqa: BLE001 — already failing
                        log.warning("could not persist the aborted "
                                    "run's streamed verdict",
                                    exc_info=True)
            raise

        log.info("Analyzing")
        test["history"] = index_history(test["history"])
        sres = _finalize_stream(test)
        if sres is not None:
            test["stream_results"] = sres
        with _phase(test, "analyze", "check"):
            test["results"] = checker_mod.check_safe(
                test["checker"], test, test["history"], {})
        if sres is not None and isinstance(test["results"], dict):
            # the live verdict next to the authoritative one (plus the
            # cache counters the web result panel renders)
            from .stream.service import result_summary

            test["results"]["stream"] = result_summary(sres)
        log.info("Analysis complete")
        if test.get("name"):
            store.save_2(test, test["results"])
        log_results(test)
        return test
    finally:
        run_span.__exit__(None, None, None)
        _export_trace(test, run_id)
        obs.set_run(None)
        store.stop_logging(test)


def log_results(test: dict) -> dict:
    """core.clj:486-498, table flip included."""
    valid = test.get("results", {}).get("valid")
    if valid is True:
        log.info("Everything looks good! ヽ('ー`)ノ")
    elif valid == "unknown":
        log.info("Errors occurred during analysis, but no anomalies found. "
                 "ಠ~ಠ")
    else:
        log.info("Analysis invalid! (ﾉಥ益ಥ）ﾉ ┻━┻")
    return test
