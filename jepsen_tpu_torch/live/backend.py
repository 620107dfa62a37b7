"""LiveBackend — real-process backends the nemesis matrix runs against.

The generalization of the pgwire/localnode in-process-server pattern:
a :class:`LiveBackend` describes one protocol family as

  * a REAL OS process per logical node (`spawn` via the control plane's
    start-stop-daemon, through a **launcher script** so clock nemeses
    can faketime-wrap the node without touching the harness),
  * a health check with bounded exponential-backoff retries
    (:class:`reconnect.Backoff` — never a fixed-interval spin),
  * the family's wire protocol, reusing the *existing suite clients*
    (etcd's V2Client, disque's RESP client, localnode's register/lock
    clients) so the suite library's wire code executes instead of
    rotting as dead code,
  * and a crash-recover contract: kill -9 must lose at most un-acked
    ops (recorded :info), restart must replay durable state.

:class:`ProcessDB` implements the db lifecycle once for every family;
the generic nemeses at the bottom (kill/restart, SIGSTOP pause,
faketime clock skew, loopback port partitions) act through the same
pidfile/port surface, so a new family gets the whole matrix for free.
"""

from __future__ import annotations

import logging
import os
import random
import socket
import sys
from dataclasses import replace

from .. import checker as checker_mod, control, control_util as cu
from .. import db as db_mod, fixtures, generator as gen, independent
from .. import nemesis as nemesis_mod
from ..checker import basic, linearizable as lin, timeline
from ..models import cas_register, mutex
from ..reconnect import Backoff
from ..suites import disque as disque_suite, etcd as etcd_suite
from ..suites import localnode as localnode_suite
from . import links as links_mod

log = logging.getLogger("jepsen")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class BackendStartError(RuntimeError):
    """A live node's server never came up (:meth:`ProcessDB.setup`'s
    health budget ran out): a host capability problem such as port
    squatting or fork pressure, which the campaign reports as a
    skipped cell.  Every other error of a cell is its failure."""


def node_port(test: dict, node, base_port: int) -> int:
    return int(test.get("base_port", base_port)) + \
        test["nodes"].index(node)


def node_dir(test: dict, node) -> str:
    return os.path.join(
        test.get("data_root", "/tmp/jepsen-live"), str(node))


def launcher_path(test: dict, node) -> str:
    """The node's launcher script — the faketime wrap target."""
    return os.path.join(node_dir(test, node), "server.sh")


def pidfile_path(test: dict, node) -> str:
    return os.path.join(node_dir(test, node), "server.pid")


class LiveBackend:
    """One protocol family's live contract.  Subclasses fill in the
    server argv + the workload; the process lifecycle, health check,
    and nemesis surface are shared."""

    #: family name (campaign cell key)
    name = "?"
    #: default first port; node i listens on base_port + i
    base_port = 18000
    #: default node names (len = cluster size)
    nodes = ["n1"]
    #: True when the nodes talk to EACH OTHER (consensus families):
    #: the per-peer-link grudges (live/links.py) only apply here — a
    #: family whose nodes never exchange a packet has no links to cut
    peer_linked = False

    def available(self, opts: dict) -> str | None:
        """A skip reason when this family can't run here, else None."""
        return None

    def addr(self, test: dict, node) -> str:
        """The node's own loopback address (127.0.1.N — the link
        identity the per-peer partitioner matches on)."""
        return links_mod.node_addr(test, node)

    def leader(self, test: dict):
        """The node currently leading, for leader-aware grudges; None
        for leaderless families (the grudge falls back to a random
        victim)."""
        return None

    def server_argv(self, test: dict, node) -> list[str]:
        """The real command line of one node's server process."""
        raise NotImplementedError

    def workload(self, opts: dict) -> dict:
        """{client, generator, checker, model?, final_generator?}."""
        raise NotImplementedError

    # ------------------------------------------------------------------

    def db(self) -> "ProcessDB":
        return ProcessDB(self)

    def port(self, test: dict, node) -> int:
        return node_port(test, node, self.base_port)

    def health_check(self, test: dict, node) -> None:
        """One readiness probe; raise when the node is not up yet."""
        with socket.create_connection(
                (self.addr(test, node), self.port(test, node)),
                timeout=1.0):
            pass

    def op_node(self, test: dict, op):
        """The node a client op targets — recovery attribution: after
        a kill, only an acked op against a KILLED node proves that
        node recovered.  Single-node families route everything to
        nodes[0]; key-sharded families override."""
        return test["nodes"][0]

    def build_test(self, opts: dict) -> dict:
        """The family's test map, nemesis left to the matrix."""
        w = self.workload(opts)
        nodes = opts.get("nodes") or list(self.nodes)
        test = fixtures.noop_test() | dict(opts) | {
            "name": opts.get("name", f"live-{self.name}"),
            "nodes": nodes,
            "base_port": opts.get("base_port", self.base_port),
            "remote": control.LocalRemote(),
            "db": self.db(),
            "client": w["client"],
            "checker": w["checker"],
            "concurrency": opts.get("concurrency",
                                    w.get("concurrency", 4)),
            "__live_backend__": self,
        }
        if w.get("model") is not None:
            test["model"] = w["model"]
        if w.get("stream_fold"):
            # model-less families declare their streaming fold route
            # (core.prepare_test installs the matching sink)
            test.setdefault("stream_fold", w["stream_fold"])
        test["__workload__"] = w
        return test


class ProcessDB(db_mod.DB, db_mod.LogFiles):
    """One real server process per logical node, any family.

    The server starts through a launcher script (``server.sh``) so a
    clock nemesis can faketime-wrap the *script* and every restart —
    nemesis or recovery — inherits the skew until unwrapped."""

    def __init__(self, backend: LiveBackend,
                 health_backoff: Backoff | None = None):
        self.backend = backend
        # ~45s worst-case budget (3.5s exponential ramp + 21 capped 2s
        # retries), matching localnode's generous poll: a contended
        # single-core host forks daemons slowly
        self.health_backoff = health_backoff or Backoff(
            base=0.05, cap=2.0, factor=1.6, max_attempts=30, jitter=0.3)
        #: per-node STATEFUL health backoffs: reset() on success, so a
        #: node that recovers then re-fails re-ramps from the base
        #: delay; left exhausted, a node that never came up costs ONE
        #: probe per later restart attempt instead of a fresh 45s ramp
        self._node_health: dict = {}

    def _health_wait(self, test, node) -> None:
        """The health loop: probe until healthy (reset) or the node's
        stateful backoff budget runs out (fail fast next time)."""
        import time as _time

        b = self._node_health.get(node)
        if b is None:
            b = replace(self.health_backoff)
            self._node_health[node] = b
        while True:
            try:
                self.backend.health_check(test, node)
                b.reset()
                return
            except Exception as e:
                if b.exhausted():
                    raise RuntimeError(
                        f"health budget exhausted after "
                        f"{b.max_attempts} probes: {e}") from e
                _time.sleep(b.step())

    def _write_launcher(self, sess: control.Session, test, node) -> None:
        script = launcher_path(test, node)
        if cu.exists(sess, f"{script}.no-faketime"):
            # the script is currently a faketime wrapper; the original
            # lives at .no-faketime — rewriting would silently unwrap
            return
        argv = " ".join(control.escape(a)
                        for a in self.backend.server_argv(test, node))
        body = f"#!/bin/sh\nexec {argv} \"$@\"\n"
        sess.exec("mkdir", "-p", node_dir(test, node))
        sess.exec("printf", "%s", body, control.lit(">"), script)
        sess.exec("chmod", "a+x", script)

    def setup(self, test, node):
        sess = control.session(node, test)
        d = node_dir(test, node)
        sess.exec("mkdir", "-p", d)
        self._write_launcher(sess, test, node)
        log.info("%s starting live %s server on :%d", node,
                 self.backend.name, self.backend.port(test, node))
        cu.start_daemon(
            sess, launcher_path(test, node),
            logfile=os.path.join(d, "server.log"),
            pidfile=pidfile_path(test, node),
            chdir=REPO_ROOT,          # `-m` resolves against the repo
            match_executable=False,   # many nodes share one launcher sh
            match_process_name=False)
        # bounded-backoff health check: capped exponential + jitter
        # with a max-attempts budget, so a node that will never come up
        # fails the setup with the real reason instead of spinning.
        # The backoff is STATEFUL per node (reconnect.Backoff.step/
        # reset): success re-arms it, exhaustion makes the NEXT restart
        # of a still-dead node fail after one probe — a wedged node
        # degrades its cell fast instead of re-paying the ramp
        try:
            self._health_wait(test, node)
        except Exception as e:
            raise BackendStartError(
                f"live {self.backend.name} server on {node} "
                f"(:{self.backend.port(test, node)}) never came up "
                f"({e}); see {d}/server.log") from e

    def teardown(self, test, node):
        sess = control.session(node, test)
        self.kill(test, node)
        sess.exec("rm", "-rf", node_dir(test, node))

    def log_files(self, test, node):
        return [os.path.join(node_dir(test, node), "server.log")]

    # -- the nemesis surface (pidfile-level faults) --------------------

    def _signal(self, test, node, sig: str) -> None:
        pid = pidfile_path(test, node)
        control.session(node, test).exec_raw(
            f"kill -{sig} $(cat {pid}) 2>/dev/null || true")

    def kill(self, test, node) -> None:
        """kill -9 by pidfile — a crash, not a shutdown."""
        self._signal(test, node, "9")

    def pause(self, test, node) -> None:
        self._signal(test, node, "STOP")

    def resume(self, test, node) -> None:
        self._signal(test, node, "CONT")


# ---------------------------------------------------------------------------
# family implementations
# ---------------------------------------------------------------------------


class RegisterBackend(LiveBackend):
    """The existing localnode register family: oplog+fsync CAS-register
    processes, one key per node (key k -> nodes[k % N]), checked
    per-key linearizable — the executable seed this harness
    generalizes."""

    name = "register"
    base_port = 18100
    nodes = ["n1", "n2", "n3"]

    def server_argv(self, test, node):
        return [sys.executable, "-m",
                "jepsen_tpu_torch.suites.localnode_server",
                str(self.port(test, node)), node_dir(test, node),
                "--host", self.addr(test, node)]

    def op_node(self, test, op):
        # RegisterClient routes key k to nodes[k % N]
        v = op.value
        if independent.is_tuple(v):
            try:
                return test["nodes"][int(v.key) % len(test["nodes"])]
            except (TypeError, ValueError):
                return None
        return None  # un-keyed op: can't attribute

    def workload(self, opts):
        from ..checker import perf as perf_mod

        rate = opts.get("rate", 25)
        group = opts.get("group_size", 3)

        def naturals():
            k = 0
            while True:
                yield k
                k += 1

        generator = gen.stagger(
            1.0 / rate,
            independent.concurrent_generator(
                group, naturals(),
                lambda k: gen.limit(
                    opts.get("ops_per_key", 30),
                    gen.mix([localnode_suite.r, localnode_suite.w,
                             localnode_suite.cas]))))
        return {
            "client": _PortedRegisterClient(self),
            "generator": generator,
            "model": cas_register(),
            "concurrency": 2 * group,
            "checker": checker_mod.compose({
                "perf": perf_mod.perf(),
                "workload": independent.checker(checker_mod.compose({
                    "linear": lin.linearizable(),
                    "timeline": timeline.timeline(),
                })),
            }),
        }


class _PortedRegisterClient(localnode_suite.RegisterClient):
    """localnode's wire client, port base taken from the backend."""

    def __init__(self, backend: LiveBackend, timeout: float = 2.0):
        super().__init__(timeout)
        self.backend = backend

    def open(self, test, node):  # suite-lint: ok (inherits close)
        c = type(self)(self.backend, self.timeout)
        c.node = node
        return c

    def _sock(self, test, key):
        node = test["nodes"][int(key) % len(test["nodes"])]
        s = self.socks.get(node)
        if s is None:
            s = socket.create_connection(
                (self.backend.addr(test, node),
                 self.backend.port(test, node)),
                timeout=self.timeout)
            self.socks[node] = s
        return node, s


class LockBackend(LiveBackend):
    """The localnode lock family (hazelcast tryLock shape): one
    cluster-wide mutex on nodes[0].  ``lock_volatile`` arms the seeded
    bug — the server forgets its holder on kill -9, the double grant
    the mutex checker must catch."""

    name = "lock"
    base_port = 18200
    nodes = ["n1"]

    def server_argv(self, test, node):
        extra = ["volatile"] if test.get("lock_volatile") else []
        return [sys.executable, "-m",
                "jepsen_tpu_torch.suites.localnode_server",
                str(self.port(test, node)), node_dir(test, node),
                "--host", self.addr(test, node), *extra]

    def workload(self, opts):
        import itertools

        rate = opts.get("rate", 100)
        if opts.get("seeded_lock"):
            # the double-grant staging from the localnode regression
            # test: one HOLDER (acquire, hold, release) and one
            # acquire-ONLY process that never releases, so a volatile
            # server's forgotten holder yields an ok-acquire pair NO
            # :info release can explain — decisive, not timing luck
            holder = gen.stagger(0.01, localnode_suite.lock_gen(
                hold=opts.get("hold", 2.5)))
            acquirer = gen.stagger(0.05, gen.each(
                lambda: gen.seq(itertools.cycle(
                    [{"type": "invoke", "f": "acquire",
                      "value": None}]))))
            generator = gen.reserve(1, holder, acquirer)
            concurrency = 2
        else:
            generator = gen.stagger(
                1.0 / rate,
                localnode_suite.lock_gen(opts.get("hold", 0.0)))
            concurrency = opts.get("concurrency", 4)
        return {
            "client": _PortedLockClient(self),
            "generator": generator,
            "model": mutex(),
            "concurrency": concurrency,
            "checker": checker_mod.compose({
                "linear": lin.linearizable(mutex()),
                "timeline": timeline.timeline(),
            }),
        }


class _PortedLockClient(localnode_suite.LockWireClient):
    def __init__(self, backend: LiveBackend, timeout: float = 2.0):
        super().__init__(timeout)
        self.backend = backend

    def open(self, test, node):  # suite-lint: ok (inherits close)
        c = type(self)(self.backend, self.timeout)
        c.node = test["nodes"][0]
        c.owner = f"c{id(c):x}"
        return c

    def _round_trip(self, test, line):
        if self.sock is None:
            try:
                self.sock = socket.create_connection(
                    (self.backend.addr(test, self.node),
                     self.backend.port(test, self.node)),
                    timeout=self.timeout)
            except OSError as e:
                raise self._NeverReached(repr(e)) from e
        return super()._round_trip(test, line)


class KVBackend(LiveBackend):
    """The KV/CAS family: etcd-v2-shaped HTTP nodes
    (live/kv_server.py), spoken to by the etcd suite's own V2Client —
    a single shared register under quorum-read semantics, checked
    linearizable."""

    name = "kv"
    base_port = 18300
    nodes = ["n1"]

    def server_argv(self, test, node):
        extra = ["volatile"] if test.get("kv_volatile") else []
        return [sys.executable, "-m",
                "jepsen_tpu_torch.live.kv_server",
                str(self.port(test, node)), node_dir(test, node),
                "--host", self.addr(test, node), *extra]

    def health_check(self, test, node):
        import urllib.error
        import urllib.request

        url = (f"http://{self.addr(test, node)}:"
               f"{self.port(test, node)}/v2/keys/__health__")
        try:
            urllib.request.urlopen(url, timeout=1.0).close()
        except urllib.error.HTTPError:
            pass  # a 404 IS a healthy reply (missing key)

    def workload(self, opts):
        rate = opts.get("rate", 25)
        model = cas_register(_PortedV2Client.MISSING)
        return {
            "client": _PortedV2Client(self),
            "generator": gen.stagger(
                1.0 / rate,
                gen.mix([etcd_suite.r, etcd_suite.w, etcd_suite.cas])),
            "model": model,
            "concurrency": opts.get("concurrency", 4),
            "checker": checker_mod.compose({
                "linear": lin.linearizable(model),
                "timeline": timeline.timeline(),
            }),
        }


class _PortedV2Client(etcd_suite.V2Client):
    """The etcd suite's v2 wire client, aimed at 127.0.0.1:port —
    invoke/error mapping reused verbatim, with one live-harness
    sharpening: on loopback there is no middlebox, so a connection
    REFUSED (the node is dead, nothing accepted the bytes) or an
    explicit 503 rejection (the replicated family's "not leader":
    refused before any mutation) proves the op never happened — those
    become ``:fail`` instead of ``:info``.  Crash-heavy cells stay
    checkable: every spurious ``:info`` widens the search's crash
    frontier exponentially, and a kill-restart campaign cell would
    otherwise drown its own post-hoc analysis.  Genuine indeterminacy
    (timeouts, resets mid-flight, the replicated 504 no-quorum reply)
    keeps riding ``:info``."""

    #: error substrings that prove the request died before any server
    #: processed it
    _NEVER_HAPPENED = ("Connection refused", "HTTP Error 503")

    #: what a 404 read means: the UNSET register — mapped to the
    #: model's initial value instead of the suite's None, because None
    #: encodes as NIL ("unknown-value read") which the checker treats
    #: as unconstrained; a volatile cluster's amnesia (acked writes
    #: un-written back to the unset state) would then be invisible.
    #: The live workloads' models init at this value.
    MISSING = -1

    def __init__(self, backend: LiveBackend, node=None,
                 timeout: float = 2.0):
        super().__init__(node, timeout)
        self.backend = backend
        self.base = None

    def open(self, test, node):  # suite-lint: ok (holds no socket)
        c = type(self)(self.backend, node, self.timeout)
        c.base = (f"http://{self.backend.addr(test, node)}:"
                  f"{self.backend.port(test, node)}")
        return c

    def invoke(self, test, op):
        out = super().invoke(test, op)
        if out.type == "info" and out.error is not None \
                and any(s in str(out.error)
                        for s in self._NEVER_HAPPENED):
            return replace(out, type="fail")
        if op.f == "read" and out.type == "ok" and out.value is None:
            return replace(out, value=self.MISSING)
        return out

    def _url(self, query=None):
        import urllib.parse

        q = f"?{urllib.parse.urlencode(query)}" if query else ""
        return f"{self.base}/v2/keys/{self.key}{q}"


class QueueBackend(LiveBackend):
    """The queue family: disque-shaped RESP nodes
    (live/queue_server.py) spoken to by the disque suite's own RESP
    client; enqueue/dequeue+ack with a final drain, checked with
    total-queue (at-least-once: lost acked jobs are the violation,
    redelivered un-acked jobs are legal)."""

    name = "queue"
    base_port = 18400
    nodes = ["n1"]

    def server_argv(self, test, node):
        extra = ["volatile"] if test.get("queue_volatile") else []
        return [sys.executable, "-m",
                "jepsen_tpu_torch.live.queue_server",
                str(self.port(test, node)), node_dir(test, node),
                "--host", self.addr(test, node), *extra]

    def workload(self, opts):
        return {
            "client": _PortedDisqueClient(backend=self),
            "generator": gen.delay(1.0 / opts.get("rate", 25),
                                   gen.queue()),
            "final_generator": gen.each(lambda: gen.once(
                {"type": "invoke", "f": "drain", "value": None})),
            "model": None,  # multiset semantics: no per-op model
            # the streaming total-queue fold route: the live verdict
            # flips at the deciding event (stream/checker.py's
            # TotalFoldStream); the post-hoc total_queue stays the
            # authoritative cross-check
            "stream_fold": "total-queue",
            "concurrency": opts.get("concurrency", 4),
            "checker": checker_mod.compose({
                "queue": basic.total_queue(),
            }),
        }


class _PortedDisqueClient(disque_suite.DisqueClient):
    """The disque suite's RESP wire client against 127.0.0.1:port.
    enqueue/dequeue/ack/drain logic and the indeterminacy mapping are
    inherited unchanged."""

    def __init__(self, node=None, queue: str = "jepsen",
                 timeout_ms: int = 100, retry: int = 1,
                 replicate: int = 1, backend: LiveBackend | None = None):
        super().__init__(node, queue, timeout_ms, retry, replicate)
        self.backend = backend
        self.host = None
        self.port = None

    def open(self, test, node):  # suite-lint: ok (inherits close)
        c = type(self)(node, self.queue, self.timeout_ms, self.retry,
                       1, backend=self.backend)
        c.host = self.backend.addr(test, node)
        c.port = self.backend.port(test, node)
        return c

    def _conn(self):
        if self.conn is None:
            self.conn = disque_suite.RespConn(
                self.host or "127.0.0.1", self.port, timeout=5.0)
        return self.conn


class ConsensusBackend(LiveBackend):
    """The shared shape of the replicated families: N real replicas
    over one shared fsync'd oplog, a ``/_repl/status`` surface (on
    ``status_port_offset`` above the client port), per-node loopback
    addresses with source-bound peer traffic, and round-robin client
    binding — everything a consensus family needs besides its own
    server argv and workload."""

    nodes = ["n1", "n2", "n3"]
    peer_linked = True
    #: the /_repl/status surface's offset from the client port (the
    #: RESP queue family serves consensus on a separate HTTP port)
    status_port_offset = 0
    #: shared-oplog filename under <data_root>/_shared/
    oplog_name = "oplog"

    def shared_oplog(self, test: dict) -> str:
        return os.path.join(
            test.get("data_root", "/tmp/jepsen-live"), "_shared",
            self.oplog_name)

    def peers_spec(self, test: dict) -> str:
        """host:port per replica — each node's OWN loopback address,
        so peer traffic is distinguishable per link."""
        return ",".join(f"{self.addr(test, n)}:{self.port(test, n)}"
                        for n in test["nodes"])

    def leader(self, test):
        """The replica currently claiming leadership (status surface;
        client-side request, so a partitioned leader still answers) —
        what the isolate-leader grudge targets."""
        from .replicated_server import http_json

        for node in test["nodes"]:
            try:
                _st, out = http_json(
                    self.addr(test, node),
                    self.port(test, node) + self.status_port_offset,
                    "/_repl/status", timeout=0.5)
                if out.get("role") == "leader":
                    return node
            except OSError:
                pass
        return None

    def op_node(self, test, op):
        # clients are bound round-robin to nodes (core.run_case) and a
        # crashed process id cycles by +concurrency, so the worker's
        # node is process % concurrency, mod the ring
        try:
            conc = int(test.get("concurrency") or 1)
            return test["nodes"][(int(op.process) % conc)
                                 % len(test["nodes"])]
        except (TypeError, ValueError):
            return None

    def build_test(self, opts: dict) -> dict:
        test = super().build_test(opts)
        # a fresh cell must not replay a previous run's shared oplog
        # (node dirs are wiped by teardown; the shared dir is not).
        # build_test is the ONE safe place to wipe it: exactly once,
        # before any node starts — a teardown-side wipe would race
        # the per-node parallel teardown+setup cycle and could unlink
        # an oplog a freshly started replica already opened
        import shutil

        shutil.rmtree(os.path.dirname(self.shared_oplog(test)),
                      ignore_errors=True)
        return test


class ReplicatedBackend(ConsensusBackend):
    """The replicated KV family: a 3-replica etcd-v2 cluster
    (live/replicated_server.py) — leader lease, majority-ack writes
    over the loopback wire, follower catch-up from the shared oplog —
    driven through the etcd suite's ``V2Client`` unchanged, so the
    partition and kill-restart nemeses exercise *consensus* (elections,
    quorum loss, catch-up), not just single-node availability.

    Seeded modes: ``replicated_volatile`` (no durable log + elections
    skip the completeness check: a restarted empty replica can win and
    un-write acked data — the kill-seeded violation the streaming
    checker's `:info` lookahead flips mid-stream) and
    ``replicated_split_brain`` (a leader never steps down: partition
    it away and it serves stale reads beside its successor)."""

    name = "replicated"
    base_port = 18500
    oplog_name = "replicated-oplog"

    def server_argv(self, test, node):
        idx = test["nodes"].index(node)
        argv = [sys.executable, "-m",
                "jepsen_tpu_torch.live.replicated_server",
                str(self.port(test, node)), node_dir(test, node),
                "--id", str(idx),
                "--peers", self.peers_spec(test),
                "--host", self.addr(test, node),
                "--oplog", self.shared_oplog(test),
                "--lease-ms", str(test.get("lease_ms", 700))]
        if test.get("replicated_volatile"):
            argv.append("volatile")
        if test.get("replicated_split_brain"):
            argv.append("split-brain")
        return argv

    def health_check(self, test, node):
        import urllib.request

        urllib.request.urlopen(
            f"http://{self.addr(test, node)}:{self.port(test, node)}"
            f"/_repl/status", timeout=1.0).close()

    def workload(self, opts):
        rate = opts.get("rate", 25)
        # seeded cells stage an INVALID crash-heavy history on
        # purpose; the post-hoc checker gets a tighter budget and no
        # ddmin shrink there (opts via SEEDED) so an expected-invalid
        # cell reports in seconds, not minutes — the streamed verdict
        # is the detection story, the post-hoc one the cross-check
        # read_weight > 1 biases the mix toward reads — the seeded
        # kill_all cell uses it so the first op a freshly amnesiac
        # volatile cluster accepts is very likely a READ of the
        # forgotten register (the client-visible violation), not a
        # write that would quietly re-initialize it
        reads = [etcd_suite.r] * max(1, int(opts.get("read_weight", 1)))
        model = cas_register(_PortedV2Client.MISSING)
        return {
            "client": _PortedV2Client(self),
            "generator": gen.stagger(
                1.0 / rate,
                gen.mix([*reads, etcd_suite.w, etcd_suite.cas])),
            "model": model,
            "concurrency": opts.get("concurrency", 6),
            "checker": checker_mod.compose({
                "linear": lin.linearizable(
                    model,
                    budget=int(opts.get("lin_budget", 20_000_000)),
                    shrink=opts.get("lin_shrink")),
                "timeline": timeline.timeline(),
            }),
        }


class ReplicatedQueueBackend(ConsensusBackend):
    """The replicated QUEUE family: a 3-node disque-RESP cluster
    (live/replicated_queue.py) over the shared-oplog consensus core,
    driven by the disque suite's ``DisqueClient`` unchanged — the
    family where redelivery-under-partition bugs live.  Claims are
    leader-local, so every leader change redelivers un-acked jobs
    (at-least-once, which ``total_queue`` tolerates); ADDJOB/ACKJOB
    are majority-ack commits, so losing an acked enqueue is the
    violation it must catch.

    Seeded mode ``rqueue_volatile``: no durable log + completeness-
    free elections + blind adoption — under a bridge grudge a cut-off
    replica wins an election through the overlap node and serves a
    pending set missing acked ADDJOBs (the lost-enqueue violation the
    seeded redelivery cell stages)."""

    name = "replicated-queue"
    base_port = 18600
    oplog_name = "rqueue-oplog"
    #: consensus/status rides a separate HTTP port above the RESP one
    from .replicated_queue import PEER_OFFSET as status_port_offset

    def server_argv(self, test, node):
        idx = test["nodes"].index(node)
        argv = [sys.executable, "-m",
                "jepsen_tpu_torch.live.replicated_queue",
                str(self.port(test, node)), node_dir(test, node),
                "--id", str(idx),
                "--peers", self.peers_spec(test),
                "--host", self.addr(test, node),
                "--oplog", self.shared_oplog(test),
                "--lease-ms", str(test.get("lease_ms", 700))]
        if test.get("rqueue_volatile"):
            argv.append("volatile")
        return argv

    def workload(self, opts):
        return {
            "client": _PortedDisqueClient(backend=self),
            "generator": gen.delay(1.0 / opts.get("rate", 25),
                                   gen.queue()),
            "final_generator": gen.each(lambda: gen.once(
                {"type": "invoke", "f": "drain", "value": None})),
            "model": None,  # multiset semantics: no per-op model
            # streamed lost-ack detection: the bridge-election seeded
            # cell's short final drain flips the live verdict at the
            # drain event, grading detection.at="streamed"
            "stream_fold": "total-queue",
            "concurrency": opts.get("concurrency", 4),
            "checker": checker_mod.compose({
                "queue": basic.total_queue(),
            }),
        }


class PgwireBackend(LiveBackend):
    """The SQL family the campaign was missing: the pg-wire register
    server (suites/pgwire.py's MiniPGServer + engine, made durable by
    live/pgwire_server.py) as a real OS process, driven by the
    cockroach suite's own ``RegisterClient`` — the psycopg2-shaped txn
    machinery (BEGIN/COMMIT/ROLLBACK, retries, reconnects) finally
    executes under the whole nemesis matrix."""

    name = "pgwire"
    base_port = 18700
    nodes = ["n1"]

    def server_argv(self, test, node):
        return [sys.executable, "-m",
                "jepsen_tpu_torch.live.pgwire_server",
                str(self.port(test, node)), node_dir(test, node),
                "--host", self.addr(test, node)]

    def workload(self, opts):
        rate = opts.get("rate", 25)
        group = opts.get("group_size", 3)

        def naturals():
            k = 0
            while True:
                yield k
                k += 1

        generator = gen.stagger(
            1.0 / rate,
            independent.concurrent_generator(
                group, naturals(),
                lambda k: gen.limit(
                    opts.get("ops_per_key", 30),
                    gen.mix([localnode_suite.r, localnode_suite.w,
                             localnode_suite.cas]))))
        model = cas_register(_PortedPGClient.MISSING)
        return {
            "client": _PortedPGClient(backend=self),
            "generator": generator,
            "model": model,
            "concurrency": 2 * group,
            "checker": checker_mod.compose({
                "workload": independent.checker(checker_mod.compose({
                    "linear": lin.linearizable(),
                    "timeline": timeline.timeline(),
                })),
            }),
        }


class _PortedPGClient:
    """The cockroach suite's RegisterClient aimed at the live pgwire
    node, with the same two live-harness sharpenings as the V2 shim:
    a read of a missing row maps to the model's initial value (a None
    read encodes as NIL — unconstrained — and amnesia would be
    invisible), and a connection refused on loopback maps to ``:fail``
    (the op definitely never happened)."""

    MISSING = -1

    def __init__(self, backend: LiveBackend | None = None, node=None):
        from ..suites import cockroach as cockroach_suite

        self.backend = backend
        self._inner = cockroach_suite.RegisterClient(node)

    def open(self, test, node):
        from ..suites import pgwire as pgwire_mod

        node = test["nodes"][0]  # single gateway node
        c = type(self)(self.backend, node)
        c._inner.conn = pgwire_mod.connect(
            host=self.backend.addr(test, node),
            port=self.backend.port(test, node),
            user="root", dbname="jepsen", connect_timeout=5)
        c._inner.conn.autocommit = False
        return c

    def setup(self, test):
        self._inner.setup(test)

    def teardown(self, test):
        self._inner.teardown(test)

    def invoke(self, test, op):
        out = self._inner.invoke(test, op)
        if out.type == "info" and out.error is not None \
                and "Connection refused" in str(out.error):
            out = replace(out, type="fail")
        v = out.value
        if op.f == "read" and out.type == "ok" \
                and independent.is_tuple(v) and v.value is None:
            out = replace(out, value=independent.tuple_(v.key,
                                                        self.MISSING))
        return out

    def close(self, test):
        self._inner.close(test)


#: the campaign's family roster
FAMILIES: dict[str, LiveBackend] = {
    b.name: b for b in (RegisterBackend(), LockBackend(), KVBackend(),
                        QueueBackend(), ReplicatedBackend(),
                        ReplicatedQueueBackend(), PgwireBackend())
}


# ---------------------------------------------------------------------------
# generic nemeses over the ProcessDB surface
# ---------------------------------------------------------------------------


class KillRestartNemesis(nemesis_mod.Nemesis):
    """{:f kill | restart, :value [nodes] | None}: kill -9 the real
    server process(es); restart re-runs the daemon start (durable
    oplogs replay, so acked state survives).  With ``test["kill_all"]``
    a valueless kill takes the WHOLE cluster — the correlated
    power-failure fault replicated families must survive from their
    durable log alone (and the volatile seeded mode must visibly
    fail)."""

    def __init__(self, db: ProcessDB):
        self.db = db

    def invoke(self, test, op):
        if op.f == "kill":
            nodes = op.value or (
                list(test["nodes"]) if test.get("kill_all")
                else [random.choice(test["nodes"])])
            for n in nodes:
                self.db.kill(test, n)
            return replace(op, type="info", value=list(nodes))
        if op.f == "restart":
            nodes = op.value or test["nodes"]
            errs = {}
            for n in nodes:
                # a restart that fails (health-check budget, RemoteError
                # from a loaded host's start-stop-daemon, exec timeout)
                # must not crash the nemesis: ops keep failing
                # :fail/:info until a later restart lands, which the
                # checker handles
                try:
                    self.db.setup(test, n)
                except Exception as e:  # noqa: BLE001 — best-effort
                    log.warning("restart of %s failed: %s", n, e)
                    errs[n] = str(e)
            return replace(op, type="info",
                           value={"restarted": list(nodes),
                                  "errors": errs} if errs
                           else list(nodes))
        raise ValueError(f"kill-restart nemesis: unknown f {op.f!r}")


class PauseNemesis(nemesis_mod.Nemesis):
    """{:f pause | resume}: SIGSTOP/SIGCONT the server process — the
    hammer-time fault (nemesis.clj:250-264), by pidfile instead of
    killall so only the targeted node freezes."""

    def __init__(self, db: ProcessDB):
        self.db = db
        self._paused: list = []

    def invoke(self, test, op):
        if op.f == "pause":
            nodes = op.value or [random.choice(test["nodes"])]
            for n in nodes:
                self.db.pause(test, n)
            self._paused = list(nodes)
            return replace(op, type="info",
                           value=["paused", list(nodes)])
        if op.f == "resume":
            nodes = op.value or self._paused or test["nodes"]
            for n in nodes:
                self.db.resume(test, n)
            self._paused = []
            return replace(op, type="info",
                           value=["resumed", list(nodes)])
        raise ValueError(f"pause nemesis: unknown f {op.f!r}")

    def teardown(self, test):
        # a still-frozen node would wedge teardown's kill/rm
        for n in test.get("nodes") or []:
            try:
                self.db.resume(test, n)
            except Exception:  # noqa: BLE001 — best-effort thaw
                pass


class ClockSkewNemesis(nemesis_mod.Nemesis):
    """{:f skew | unskew}: faketime-wrap the node's launcher script
    (faketime.wrap — idempotent) and crash-restart it, so the server
    runs under a skewed/fast clock until unskewed.  The wrap survives
    nemesis restarts because every restart execs the launcher."""

    def __init__(self, db: ProcessDB, offset_s: int = 120,
                 rate: float = 1.5):
        self.db = db
        self.offset_s = offset_s
        self.rate = rate

    def invoke(self, test, op):
        from .. import faketime

        if op.f == "skew":
            nodes = op.value or [random.choice(test["nodes"])]
            for n in nodes:
                sess = control.session(n, test)
                faketime.wrap(sess, launcher_path(test, n),
                              self.offset_s, self.rate)
                self.db.kill(test, n)
                self.db.setup(test, n)
            return replace(op, type="info",
                           value=["skewed", list(nodes),
                                  {"offset_s": self.offset_s,
                                   "rate": self.rate}])
        if op.f == "unskew":
            nodes = op.value or test["nodes"]
            for n in nodes:
                sess = control.session(n, test)
                if faketime.unwrap(sess, launcher_path(test, n)):
                    self.db.kill(test, n)
                    self.db.setup(test, n)
            return replace(op, type="info",
                           value=["unskewed", list(nodes)])
        raise ValueError(f"clock-skew nemesis: unknown f {op.f!r}")

    def teardown(self, test):
        from .. import faketime

        for n in test.get("nodes") or []:
            try:
                faketime.unwrap(control.session(n, test),
                                launcher_path(test, n))
            except Exception:  # noqa: BLE001 — best-effort unwrap
                pass


class PortPartitionNemesis(nemesis_mod.Nemesis):
    """{:f start | stop}: whole-port partition grudges — the blunt
    cut that takes a node away from clients AND peers: :start picks a
    victim component with the grudge topology math (nemesis.split_one)
    and DROPs inbound traffic to its ports via iptables; :stop heals.
    (The surgical per-peer-link grudges live in
    :class:`links.LinkPartitionNemesis`.)

    Every rule is journaled to the data root BEFORE install
    (live/links.py's journal) and heal is a journal sweep — the old
    in-process ``_rules`` list leaked live DROP rules whenever a
    watchdog SIGKILL'd the runner mid-partition; the journal survives
    the runner, so campaign start, the watchdog, and ``--sweep`` can
    always restore connectivity."""

    def __init__(self, backend: LiveBackend,
                 grudge=nemesis_mod.split_one):
        self.backend = backend
        self.grudge = grudge
        # the availability probe required euid 0 + iptables, so the
        # engine runs the binary directly (the container this runs in
        # may not even ship a sudo binary)
        self._engine = links_mod.IptablesEngine()
        self._cut: list[str] = []  # victim nodes, for the op value

    def invoke(self, test, op):
        data_root = test.get("data_root", "/tmp/jepsen-live")
        if op.f == "start":
            if self._cut:
                return replace(op, type="info",
                               value="already-partitioned")
            victims, _rest = self.grudge(list(test["nodes"]))
            # every port the node serves on: the client port AND the
            # consensus/status surface where the family splits them
            # (replicated-queue's peer HTTP rides port + offset) — a
            # "partitioned" node that still heartbeats isn't one
            offset = int(getattr(self.backend,
                                 "status_port_offset", 0) or 0)
            for n in victims:
                ports = [self.backend.port(test, n)]
                if offset:
                    ports.append(ports[0] + offset)
                for port in ports:
                    rule = {"kind": "port", "port": port,
                            "node": str(n),
                            "engine": self._engine.name}
                    links_mod.journal_append(data_root, rule)
                    self._engine.install(rule)
                self._cut.append(str(n))
            return replace(op, type="info",
                           value=["isolated", sorted(self._cut)])
        if op.f == "stop":
            self._heal(test)
            return replace(op, type="info", value="network-healed")
        raise ValueError(f"port-partition nemesis: unknown f {op.f!r}")

    def _heal(self, test) -> None:
        links_mod.sweep(test.get("data_root", "/tmp/jepsen-live"),
                        engine=self._engine)
        self._cut = []

    def teardown(self, test):
        self._heal(test)
