"""Hazelcast suite — in-memory data grid; lock/queue/ids/map workloads.

Reference: hazelcast/src/jepsen/hazelcast.clj.  Db automation uploads a
server jar, installs jdk8, and daemonizes ``java -jar server.jar
--members ip,...`` (hazelcast.clj:51-113).  Workloads
(hazelcast.clj:364-399): lock-as-mutex (BASELINE config #4), queue with
final drain, unique-ids, and the map/crdt-map CAS set.

Transports, real first:

  * queue — Hazelcast's REST endpoint (`/hazelcast/rest/queues/<name>`;
    POST=offer, DELETE=poll) over stdlib urllib: a real distributed
    workload with zero driver dependencies.
  * unique-ids — atomic ``incr`` over Hazelcast's memcache-compatible
    text protocol (port 5701), a stdlib socket client.
  * lock / map / crdt-map — need entry processors & CP locks only the
    binary client protocol exposes; gated on the `hazelcast`
    python driver (hazelcast.clj's embedded Java client equivalent).
  * lock-fixture / unique-ids-fixture — the in-process demo fixtures
    (NOT Hazelcast; harness self-tests and demos only — the breakable
    lock shows how the mutex checker catches double grants).
"""

from __future__ import annotations

import http.client
import logging
import random
import socket
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures, generator as gen,
                nemesis, net as net_mod)
from ..checker import basic, linearizable as lin, perf as perf_mod, timeline
from ..models import mutex
from ..os import debian

log = logging.getLogger("jepsen")

DIR = "/opt/hazelcast"
JAR = f"{DIR}/server.jar"
LOG_FILE = f"{DIR}/server.log"
PIDFILE = f"{DIR}/server.pid"
PORT = 5701


# ---------------------------------------------------------------------------
# db automation (hazelcast.clj:51-113)
# ---------------------------------------------------------------------------


class HazelcastDB(db_mod.DB, db_mod.LogFiles):
    """jdk8 + uploaded server jar + --members peer list."""

    def __init__(self, server_jar: str):
        self.server_jar = server_jar

    def setup(self, test, node):
        import time

        sess = control.session(node, test)
        debian.install_jdk8(sess)
        su = sess.su()
        su.exec("mkdir", "-p", DIR)
        sess.upload(self.server_jar, JAR)
        def peer_ip(n):
            # fall back to the hostname when the peer is not yet
            # resolvable (net.ip raises rather than returning empty)
            try:
                return net_mod.ip(sess, str(n))
            except (control.RemoteError, IndexError):
                return str(n)

        members = ",".join(peer_ip(n)
                           for n in test["nodes"] if n != node)
        cu.start_daemon(su, "/usr/bin/java", "-jar", JAR,
                        "--members", members,
                        logfile=LOG_FILE, pidfile=PIDFILE, chdir=DIR)
        time.sleep(15)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        try:
            cu.stop_daemon(sess, PIDFILE, cmd="java")
        except control.RemoteError:
            pass
        sess.exec("rm", "-rf", LOG_FILE, PIDFILE)

    def log_files(self, test, node):
        return [LOG_FILE]


def db(server_jar: str = "server/target/hazelcast-server.jar"
       ) -> HazelcastDB:
    return HazelcastDB(server_jar)


# ---------------------------------------------------------------------------
# REST queue client (hazelcast REST API; queue semantics of
# hazelcast.clj:211-237)
# ---------------------------------------------------------------------------


class RestQueueClient(client_mod.Client):
    """POST offers, DELETE polls.  Network errors on enqueue AND dequeue
    are indeterminate :info (a timed-out DELETE may have popped the
    element server-side); empty polls are :fail."""

    queue = "jepsen.queue"

    def __init__(self, node=None, timeout: float = 5.0):
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return type(self)(node, self.timeout)

    def _url(self, suffix: str = "") -> str:
        return (f"http://{self.node}:{PORT}/hazelcast/rest/queues/"
                f"{self.queue}{suffix}")

    def _offer(self, value) -> bool:
        req = urllib.request.Request(
            self._url(), data=str(value).encode(), method="POST",
            headers={"Content-Type": "text/plain"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return r.status in (200, 204)

    def _poll(self, timeout_s: int = 0):
        req = urllib.request.Request(self._url(f"/{timeout_s}"),
                                     method="DELETE")
        with urllib.request.urlopen(req, timeout=self.timeout + timeout_s) \
                as r:
            body = r.read().decode().strip()
            if r.status == 204 or not body:
                return None
            return int(body)

    def invoke(self, test, op):
        try:
            if op.f == "enqueue":
                ok = self._offer(op.value)
                return replace(op, type="ok" if ok else "fail")
            if op.f == "dequeue":
                v = self._poll()
                if v is None:
                    return replace(op, type="fail", error="empty")
                return replace(op, type="ok", value=v)
            if op.f == "drain":
                # Retry transient errors inside the drain window; each
                # accumulated value came from a successful poll, so
                # reporting them as dequeued stays sound.  The checker
                # (deliberately, matching checker.clj:255) cannot digest
                # a crashed drain, so this op never returns :info.
                import time

                values = []
                deadline = time.time() + 10
                empties = 0
                while time.time() < deadline:
                    try:
                        v = self._poll(timeout_s=1)
                    except (urllib.error.URLError, OSError,
                            http.client.HTTPException, ValueError):
                        empties = 0
                        time.sleep(0.5)
                        continue
                    if v is None:
                        empties += 1
                        if empties >= 2:
                            return replace(op, type="ok", value=values)
                    else:
                        empties = 0
                        values.append(v)
                if values:
                    return replace(op, type="ok", value=values,
                                   error="drain-window-exhausted")
                return replace(op, type="fail", error="drain timeout")
            raise ValueError(f"unknown f {op.f!r}")
        except (urllib.error.URLError, OSError,
                http.client.HTTPException) as e:
            return replace(op, type="info", error=str(e))


def queue_workload(opts: dict) -> dict:
    """hazelcast.clj:239-258: sequential-int enqueues mixed with
    dequeues; final drain; total-queue checker."""
    counter = __import__("itertools").count()

    def enq(test, process):
        return {"type": "invoke", "f": "enqueue", "value": next(counter)}

    deq = {"type": "invoke", "f": "dequeue", "value": None}
    return {
        "client": RestQueueClient(),
        "checker": basic.total_queue(),
        "generator": gen.mix([enq, deq]),  # test-level --rate governs
        "final_generator": gen.each(lambda: gen.once(
            {"type": "invoke", "f": "drain", "value": None})),
        "model": None,
    }


# ---------------------------------------------------------------------------
# memcache-protocol unique-ids client (atomic incr on port 5701)
# ---------------------------------------------------------------------------


class MemcacheIdClient(client_mod.Client):
    """`incr` over Hazelcast's memcache-compatible endpoint is atomic —
    each response value is a freshly-claimed id (the IdGenerator analog,
    hazelcast.clj:191-209)."""

    key = "jepsen-ids"

    def __init__(self, node=None, timeout: float = 5.0):
        self.node = node
        self.timeout = timeout
        self.sock = None
        self.buf = None

    def open(self, test, node):
        return type(self)(node, self.timeout)

    def _conn(self):
        if self.sock is None:
            self.sock = socket.create_connection(
                (str(self.node), PORT), timeout=self.timeout)
            self.buf = self.sock.makefile("rb")
            # seed the counter; "STORED" or racing is fine
            self.sock.sendall(
                f"add {self.key} 0 0 1\r\n0\r\n".encode())
            self.buf.readline()
        return self.sock

    def _drop(self):
        if self.sock is not None:
            try:
                self.buf.close()
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def invoke(self, test, op):
        assert op.f == "generate"
        try:
            s = self._conn()
            s.sendall(f"incr {self.key} 1\r\n".encode())
            line = self.buf.readline().decode().strip()
            if not line or not line.isdigit():
                return replace(op, type="info", error=line or "closed")
            return replace(op, type="ok", value=int(line))
        except (TimeoutError, OSError) as e:
            self._drop()
            return replace(op, type="info", error=str(e) or "timeout")

    def close(self, test):
        self._drop()


def unique_ids_workload(opts: dict) -> dict:
    return {
        "client": MemcacheIdClient(),
        "checker": basic.unique_ids(),
        "generator": {"type": "invoke", "f": "generate", "value": None},
        "model": None,
    }


# ---------------------------------------------------------------------------
# binary-protocol clients (gated on the `hazelcast` python driver)
# ---------------------------------------------------------------------------


def driver_client(node):
    try:
        import hazelcast  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "hazelcast lock/map workloads need the `hazelcast` python "
            "driver (binary client protocol)") from e
    return hazelcast.HazelcastClient(
        cluster_members=[f"{node}:{PORT}"],
        connection_timeout=10.0)


class HzLockClient(client_mod.Client):
    """Real distributed lock via the CP subsystem
    (hazelcast.clj:260-292: tryLock/unlock, 'not lock owner' → fail)."""

    def __init__(self, node=None):
        self.node = node
        self.conn = None
        self.lock = None

    def open(self, test, node):
        c = type(self)(node)
        c.conn = driver_client(node)
        c.lock = c.conn.cp_subsystem.get_lock("jepsen").blocking()
        return c

    def invoke(self, test, op):
        try:
            if op.f == "acquire":
                ok = self.lock.try_lock(timeout=5)
                return replace(op, type="ok" if ok else "fail")
            if op.f == "release":
                try:
                    self.lock.unlock()
                    return replace(op, type="ok")
                except Exception as e:
                    if "not locked" in str(e).lower() or \
                            "owner" in str(e).lower():
                        return replace(op, type="fail",
                                       error="not-lock-owner")
                    raise
            raise ValueError(f"unknown f {op.f!r}")
        except (OSError, RuntimeError) as e:
            # lock ops are indeterminate under connection loss
            return replace(op, type="info", error=str(e)[:200])

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.shutdown()
            except Exception:
                pass


class HzMapClient(client_mod.Client):
    """CAS-maintained sorted set under one map key
    (hazelcast.clj:306-346): replace(k, old, new) or putIfAbsent."""

    def __init__(self, crdt: bool = False, node=None):
        self.crdt = crdt
        self.node = node
        self.conn = None
        self.map = None

    def open(self, test, node):
        c = type(self)(self.crdt, node)
        c.conn = driver_client(node)
        name = "jepsen.crdt-map" if self.crdt else "jepsen.map"
        c.map = c.conn.get_map(name).blocking()
        return c

    def invoke(self, test, op):
        try:
            if op.f == "add":
                cur = self.map.get("hi")
                if cur is not None:
                    new = sorted(set(cur) | {op.value})
                    if self.map.replace_if_same("hi", cur, new):
                        return replace(op, type="ok")
                    return replace(op, type="fail", error="cas-failed")
                if self.map.put_if_absent("hi", [op.value]) is None:
                    return replace(op, type="ok")
                return replace(op, type="fail", error="cas-failed")
            if op.f == "read":
                cur = self.map.get("hi")
                return replace(op, type="ok",
                               value=sorted(cur or []))
            raise ValueError(f"unknown f {op.f!r}")
        except (OSError, RuntimeError) as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e)[:200])

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.shutdown()
            except Exception:
                pass


def lock_gen():
    return gen.each(
        lambda: gen.seq(__import__("itertools").cycle(
            [{"type": "invoke", "f": "acquire", "value": None},
             {"type": "invoke", "f": "release", "value": None}])))


def lock_workload(opts: dict) -> dict:
    """hazelcast.clj:379-386: alternating acquire/release per process,
    checked against the mutex model (BASELINE config #4)."""
    return {
        "client": HzLockClient(),
        "checker": checker_mod.compose({
            "linear": lin.linearizable(mutex()),
            "timeline": timeline.timeline(),
        }),
        "generator": lock_gen(),
        "model": mutex(),
    }


def map_workload(opts: dict, crdt: bool = False) -> dict:
    """hazelcast.clj:348-362."""
    counter = __import__("itertools").count()

    def add(test, process):
        return {"type": "invoke", "f": "add", "value": next(counter)}

    return {
        "client": HzMapClient(crdt=crdt),
        "checker": basic.set_checker(),
        "generator": gen.stagger(0.1, add),
        "final_generator": gen.each(lambda: gen.once(
            {"type": "invoke", "f": "read", "value": None})),
        "model": None,
    }


# ---------------------------------------------------------------------------
# in-process fixtures (NOT hazelcast — harness demos/self-tests)
# ---------------------------------------------------------------------------


class InProcessLockService:
    """A deliberately imperfect lock service for harness demos: honors
    lock/unlock, but (like real Hazelcast under partitions) can be made
    to grant two holders via `break_()`.  Fixture only — proves the
    mutex checker, not Hazelcast."""

    def __init__(self):
        self._lock = threading.Lock()
        self.holder = None
        self.broken = False

    def try_lock(self, owner) -> bool:
        with self._lock:
            if self.holder is None or self.broken:
                self.holder = owner
                return True
            return False

    def unlock(self, owner) -> bool:
        with self._lock:
            if self.holder == owner:
                self.holder = None
                return True
            return False  # not the owner


class LockClient(client_mod.Client):
    """Fixture client for InProcessLockService."""

    def __init__(self, service: InProcessLockService | None = None,
                 owner=None):
        self.service = service or InProcessLockService()
        self.owner = owner

    def open(self, test, node):
        return LockClient(self.service, owner=object())

    def invoke(self, test, op):
        if op.f == "acquire":
            return replace(
                op, type="ok" if self.service.try_lock(self.owner)
                else "fail")
        if op.f == "release":
            if self.service.unlock(self.owner):
                return replace(op, type="ok")
            return replace(op, type="fail", error="not-lock-owner")
        raise ValueError(f"unknown f {op.f!r}")


def lock_fixture_workload(opts: dict, service=None) -> dict:
    """The lock workload against the in-process fixture (no cluster
    needed; demonstrates the checker catching double grants)."""
    wl = lock_workload(opts)
    wl["client"] = LockClient(service)
    return wl


class UniqueIdClient(client_mod.Client):
    """Fixture id generator (an in-process itertools.count)."""

    def __init__(self, counter=None):
        self.counter = counter if counter is not None else \
            __import__("itertools").count()
        self._lock = threading.Lock()

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        assert op.f == "generate"
        with self._lock:
            return replace(op, type="ok", value=next(self.counter))


def unique_ids_fixture_workload(opts: dict) -> dict:
    return {
        "client": UniqueIdClient(),
        "checker": basic.unique_ids(),
        "generator": {"type": "invoke", "f": "generate", "value": None},
        "model": None,
    }


WORKLOADS = {
    "lock": lock_workload,
    "queue": queue_workload,
    "unique-ids": unique_ids_workload,
    "map": lambda opts: map_workload(opts, crdt=False),
    "crdt-map": lambda opts: map_workload(opts, crdt=True),
    "lock-fixture": lock_fixture_workload,
    "unique-ids-fixture": unique_ids_fixture_workload,
}

#: workloads that run against a real cluster (everything else is an
#: in-process fixture demo)
CLUSTER_WORKLOADS = {"lock", "queue", "unique-ids", "map", "crdt-map"}


def hazelcast_test(opts: dict) -> dict:
    """hazelcast.clj:401-430: majorities-ring partitions while the
    workload runs; fixture workloads skip db automation."""
    import itertools

    name = opts.get("workload", "lock")
    workload = WORKLOADS[name](opts)
    final = workload.get("final_generator")
    main_phase = gen.time_limit(
        opts.get("time_limit", 60),
        gen.nemesis(
            gen.seq(itertools.cycle(
                [gen.sleep(5), {"type": "info", "f": "start"},
                 gen.sleep(5), {"type": "info", "f": "stop"}])),
            gen.stagger(1.0 / opts.get("rate", 10),
                        workload["generator"])))
    cluster = name in CLUSTER_WORKLOADS
    t = fixtures.noop_test() | {
        "name": f"hazelcast {name}",
        "client": workload["client"],
        # fixture demos have no cluster to partition
        "nemesis": (nemesis.partition_majorities_ring() if cluster
                    else nemesis.noop),
        "model": workload.get("model"),
        "checker": checker_mod.compose({
            "perf": perf_mod.perf(),
            "workload": workload["checker"],
        }),
        "generator": (gen.phases(
            main_phase,
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(5), gen.clients(final)) if final
            else main_phase),
    }
    if cluster:
        t["os"] = debian.os
        t["db"] = db(opts.get("server_jar",
                              "server/target/hazelcast-server.jar"))
    return t | {k: v for k, v in opts.items() if k != "workload"}


def add_opts(p):
    p.add_argument("-w", "--workload", choices=sorted(WORKLOADS),
                   default="lock")
    p.add_argument("-r", "--rate", type=float, default=10)
    p.add_argument("--server-jar",
                   default="server/target/hazelcast-server.jar")


def main(argv=None):
    cli.main(cli.single_test_cmd(hazelcast_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
