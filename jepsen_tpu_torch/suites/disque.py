"""Disque suite — distributed job queue.

Reference: disque/ (339 LoC).  Db automation clones + builds disque from
source, starts it under start-stop-daemon, and joins the cluster with
``disque cluster meet <primary-ip>`` (disque.clj:39-117); the workload
is the queue test: enqueue/dequeue+ack with a final drain, checked with
``total-queue`` against the unordered-queue model (disque.clj:298-311).

The client speaks RESP (the redis wire protocol disque uses) directly
over a stdlib socket — ADDJOB/GETJOB/ACKJOB
(disque.clj:141-155's jedisque calls) — so it needs no driver package,
and reconnects on connection errors like the reference's
reconnecting-client (disque.clj:164-193).
"""

from __future__ import annotations

import logging
import socket
import time
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures,
                generator as gen, net as net_mod, nemesis as nemesis_mod)
from ..checker import basic, perf as perf_mod
from ..os import debian

log = logging.getLogger("jepsen")

DIR = "/opt/disque"
DATA_DIR = "/var/lib/disque"
PIDFILE = "/var/run/disque.pid"
BINARY = f"{DIR}/src/disque-server"
CONTROL_BIN = f"{DIR}/src/disque"
CONFIG = f"{DIR}/disque.conf"
LOG_FILE = f"{DATA_DIR}/log"
PORT = 7711
REPO = "https://github.com/antirez/disque.git"


def install(sess, version: str) -> None:
    """git clone + make (disque.clj:39-53)."""
    debian.install(sess, ["git-core", "build-essential"])
    su = sess.su()
    if not cu.exists(su, DIR):
        su.cd("/opt").exec("git", "clone", REPO)
    d = su.cd(DIR)
    d.exec("git", "pull")
    d.exec("git", "reset", "--hard", version)
    d.exec("make")


def configure(sess) -> None:
    """disque.clj:55-63."""
    conf = "\n".join([
        f"port {PORT}",
        f"dir {DATA_DIR}",
        "appendonly yes",
        ""])
    sess.su().exec("echo", conf, control.lit(">"), CONFIG)


def start(test, node) -> None:
    """disque.clj:74-92."""
    sess = control.session(node, test).su()
    sess.exec("mkdir", "-p", DATA_DIR)
    cu.start_daemon(sess, BINARY, CONFIG,
                    logfile=LOG_FILE, pidfile=PIDFILE, chdir=DIR)


def stop(test, node) -> None:
    """disque.clj:104-110."""
    sess = control.session(node, test).su()
    cu.grepkill(sess, "disque-server")
    sess.exec("rm", "-rf", PIDFILE)


class DisqueDB(db_mod.DB, db_mod.LogFiles):
    """install + configure + start + cluster-meet join
    (disque.clj:122-136)."""

    def __init__(self, version: str):
        self.version = version

    def setup(self, test, node):
        from .. import core as core_mod

        sess = control.session(node, test)
        install(sess, self.version)
        configure(sess)
        start(test, node)
        core_mod.synchronize(test)  # everyone up before meeting
        p = core_mod.primary(test)
        if node != p:
            ip = net_mod.ip(sess, str(p)) or str(p)
            out = sess.exec(CONTROL_BIN, "-p", str(PORT),
                            "cluster", "meet", ip, str(PORT))
            assert "OK" in str(out), f"cluster meet failed: {out!r}"

    def teardown(self, test, node):
        stop(test, node)
        sess = control.session(node, test).su()
        sess.exec("rm", "-rf", control.lit(f"{DATA_DIR}/*"), LOG_FILE)

    def log_files(self, test, node):
        return [LOG_FILE]


def db(version: str = "f00dd0704128707f7a5effccd5837d796f2c01e3") -> DisqueDB:
    return DisqueDB(version)


# ---------------------------------------------------------------------------
# RESP wire client
# ---------------------------------------------------------------------------


class RespError(Exception):
    pass


class RespConn:
    """Minimal RESP (redis protocol) connection."""

    def __init__(self, host: str, port: int = PORT, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.buf = self.sock.makefile("rb")

    def close(self):
        try:
            self.buf.close()
            self.sock.close()
        except OSError:
            pass

    def command(self, *args):
        """Send one command, read one reply."""
        out = [f"*{len(args)}\r\n".encode()]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out.append(f"${len(b)}\r\n".encode() + b + b"\r\n")
        self.sock.sendall(b"".join(out))
        return self._read_reply()

    def _read_reply(self):
        line = self.buf.readline()
        if not line:
            raise ConnectionError("connection closed")
        kind, rest = line[:1], line[1:].strip()
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self.buf.read(n + 2)[:-2]
            return data.decode()
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RespError(f"bad reply line {line!r}")


class DisqueClient(client_mod.Client):
    """enqueue → ADDJOB, dequeue → GETJOB+ACKJOB, drain → dequeue until
    empty (disque.clj:195-246).  Connection errors are indeterminate
    :info; the conn is replaced on the next op (reconnecting-client,
    disque.clj:164-193)."""

    def __init__(self, node=None, queue: str = "jepsen",
                 timeout_ms: int = 100, retry: int = 1, replicate: int = 3):
        self.node = node
        self.queue = queue
        self.timeout_ms = timeout_ms
        self.retry = retry
        self.replicate = replicate
        self.conn = None

    def open(self, test, node):
        c = type(self)(node, self.queue, self.timeout_ms, self.retry,
                       min(self.replicate, len(test["nodes"])))
        c.conn = None  # lazily opened; reopens after errors
        return c

    def _conn(self):
        if self.conn is None:
            self.conn = RespConn(str(self.node))
        return self.conn

    def _drop_conn(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def _enqueue(self, value) -> None:
        self._conn().command(
            "ADDJOB", self.queue, str(value), self.timeout_ms,
            "RETRY", self.retry, "REPLICATE", self.replicate)

    def _dequeue(self, op, timeout_ms: int | None = None):
        """GETJOB + ACKJOB (disque.clj:195-207)."""
        jobs = self._conn().command(
            "GETJOB", "TIMEOUT", timeout_ms or self.timeout_ms,
            "COUNT", 1, "FROM", self.queue)
        if not jobs:
            return replace(op, type="fail")
        _q, job_id, body = jobs[0][:3]
        self._conn().command("ACKJOB", job_id)
        return replace(op, type="ok", value=int(body))

    def invoke(self, test, op):
        try:
            if op.f == "enqueue":
                self._enqueue(op.value)
                return replace(op, type="ok")
            if op.f == "dequeue":
                return self._dequeue(op)
            if op.f == "drain":
                # Dequeue until the queue stays empty across the retry
                # window: unacked jobs are redelivered after RETRY (1s),
                # so a single fast empty poll is not "drained".  Two
                # consecutive empty GETJOBs with a >RETRY timeout each
                # guarantee nothing is pending redelivery
                # (disque.clj:221-240 journals each sub-dequeue; we
                # keep the drain op atomic).
                # the ok value is the LIST of drained elements —
                # checker.expand_queue_drain_ops turns each into a
                # dequeue invoke/ok pair (checker.clj:213-244); a bare
                # count would crash the total-queue checker (found the
                # first time this client ran against a live server)
                deadline = time.time() + 10
                drain_timeout_ms = max(1000 * self.retry + 200,
                                       self.timeout_ms)
                drained: list = []
                empties = 0
                while time.time() < deadline:
                    sub = self._dequeue(replace(op, f="dequeue"),
                                        timeout_ms=drain_timeout_ms)
                    if sub.type == "fail":
                        empties += 1
                        if empties >= 2:
                            return replace(op, type="ok", value=drained)
                    else:
                        empties = 0
                        drained.append(sub.value)
                return replace(op, type="info", error="drain timeout")
            raise ValueError(f"unknown f {op.f!r}")
        except RespError as e:
            if str(e).startswith("NOREPL"):
                return replace(op, type="info",
                               error="not-fully-replicated")
            return replace(op, type="fail", error=str(e))
        except OSError as e:
            self._drop_conn()
            return replace(op, type="fail" if op.f == "dequeue" else "info",
                           error=str(e))

    def close(self, test):
        self._drop_conn()


# ---------------------------------------------------------------------------
# nemeses + tests
# ---------------------------------------------------------------------------


def killer() -> nemesis_mod.Nemesis:
    """Kill a random node on start, restart on stop
    (disque.clj:260-266)."""
    import random

    return nemesis_mod.node_start_stopper(
        random.choice,
        lambda t, n: (stop(t, n), "killed")[1],
        lambda t, n: (start(t, n), "restarted")[1])


def std_gen(opts, client_gen) -> gen.Generator:
    """10s/10s nemesis cadence, recover, 10s of ops, drain
    (disque.clj:271-295)."""
    import itertools

    return gen.phases(
        gen.time_limit(opts.get("time_limit", 100),
                       gen.nemesis(
                           gen.seq(itertools.cycle(
                               [gen.sleep(10), {"type": "info",
                                                "f": "start"},
                                gen.sleep(10), {"type": "info",
                                                "f": "stop"}])),
                           client_gen)),
        gen.nemesis(gen.once({"type": "info", "f": "stop"})),
        gen.clients(gen.time_limit(10, client_gen)),
        gen.log("Draining"),
        gen.clients(gen.each(lambda: gen.once(
            {"type": "invoke", "f": "drain", "value": None}))))


def disque_test(opts: dict) -> dict:
    """disque.clj:298-311 + the partitions/single-node-restarts
    variants (313-339)."""
    nem = opts.get("nemesis", "partitions")
    nemesis = killer() if nem == "killer" else \
        nemesis_mod.partition_random_halves()
    return fixtures.noop_test() | {
        "os": debian.os,
        "db": db(opts.get("version",
                          "f00dd0704128707f7a5effccd5837d796f2c01e3")),
        "name": f"disque {nem}",
        "client": DisqueClient(),
        "nemesis": nemesis,
        "checker": checker_mod.compose({
            "queue": basic.total_queue(),
            # opt-in (--queue-linear): device linearizability over
            # the multiset model, beyond the model-reduce
            **basic.queue_linear_entry(opts),
            "perf": perf_mod.perf(),
        }),
        "generator": std_gen(opts, gen.delay(1, gen.queue())),
    } | {k: v for k, v in opts.items() if k != "nemesis"}


def add_opts(p):
    p.add_argument("--nemesis", default="partitions",
                   choices=["partitions", "killer"])
    basic.add_queue_linear_opts(p)
    p.add_argument("--version",
                   default="f00dd0704128707f7a5effccd5837d796f2c01e3")


def main(argv=None):
    cli.main(cli.single_test_cmd(disque_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
