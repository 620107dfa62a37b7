"""localnode suite — EXECUTED Tier-3 on a host with no sshd or docker.

The reference validates its whole stack against real remote processes
(core_test.clj:32-86 ssh-test; the docker harness, docker/README.md).
This image has neither sshd nor docker, so this suite deploys the same
shape with what the host *does* have: every logical node n1..nN is a
REAL OS process — the durable register server in localnode_server.py —
started and killed through the control plane (`LocalRemote`, which
execs real shells), spoken to over real TCP sockets, crashed with real
`kill -9`, and restarted mid-test by the nemesis.  End to end it
exercises:

  control plane -> db lifecycle (start-stop-daemon, pidfiles, logs)
  -> generator -> real wire-protocol clients -> kill/restart nemesis
  -> indeterminate (:info) ops from in-flight crashes
  -> linearizable checker (device engine, batched per key) -> store.

Key->node routing: key k lives on nodes[k % N], so each key's history
is against a single server and must be linearizable; the oplog fsync
in the server makes acked writes survive kill -9 (un-acked in-flight
ops are recorded :info — the checker's may-have-happened case).

    python -m jepsen_tpu_torch.suites.localnode test --time-limit 10
"""

from __future__ import annotations

import itertools
import logging
import os
import random
import socket
import sys
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures,
                generator as gen, independent, nemesis as nemesis_mod)
from ..checker import linearizable as lin, perf as perf_mod, timeline
from ..models import cas_register

log = logging.getLogger("jepsen")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BASE_PORT = 17850


def node_port(test, node) -> int:
    return int(test.get("base_port", BASE_PORT)) + \
        test["nodes"].index(node)


def node_dir(test, node) -> str:
    return os.path.join(test.get("data_root", "/tmp/jepsen-localnode"),
                        str(node))


class LocalNodeDB(db_mod.DB, db_mod.LogFiles):
    """One real register-server process per logical node."""

    def setup(self, test, node):
        sess = control.session(node, test)
        d = node_dir(test, node)
        port = node_port(test, node)
        sess.exec("mkdir", "-p", d)
        log.info("%s starting localnode server on :%d", node, port)
        extra = (["volatile"] if test.get("lock_volatile") else [])
        cu.start_daemon(
            sess, sys.executable,
            "-m", "jepsen_tpu_torch.suites.localnode_server", str(port), d,
            *extra,
            logfile=os.path.join(d, "server.log"),
            pidfile=os.path.join(d, "server.pid"),
            chdir=REPO_ROOT,          # `-m` resolves against the repo
            match_executable=False,   # many nodes share one python
            match_process_name=False)
        def up() -> bool:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=1.0):
                return True

        # generous: a contended single-core host forks daemons slowly
        cu.poll_until(up, timeout_s=45.0, interval=0.05,
                      desc=f"localnode server on {node} (:{port}) never "
                           f"came up; see {d}/server.log")

    def teardown(self, test, node):
        sess = control.session(node, test)
        d = node_dir(test, node)
        _kill(sess, test, node)
        sess.exec("rm", "-rf", d)

    def log_files(self, test, node):
        return [os.path.join(node_dir(test, node), "server.log")]


def db() -> LocalNodeDB:
    return LocalNodeDB()


def _kill(sess: control.Session, test, node) -> None:
    """kill -9 by pidfile — a crash, not a shutdown."""
    pid = os.path.join(node_dir(test, node), "server.pid")
    sess.exec_raw(f"kill -9 $(cat {pid}) 2>/dev/null || true")


class KillRestartNemesis(nemesis_mod.Nemesis):
    """Ops: {:f kill | restart, :value [nodes] | None (= one random /
    all)}.  kill -9s the real server process; restart re-runs the
    daemon start (the durable oplog replays, so acked state survives)."""

    def __init__(self):
        self.db = LocalNodeDB()

    def setup(self, test):
        return self

    def invoke(self, test, op):
        if op.f == "kill":
            nodes = op.value or [random.choice(test["nodes"])]
            for n in nodes:
                _kill(control.session(n, test), test, n)
            return replace(op, type="info", value=list(nodes))
        if op.f == "restart":
            nodes = op.value or test["nodes"]
            errs = {}
            for n in nodes:
                # a restart that times out (loaded host) must not crash
                # the nemesis: ops on that node keep failing :fail/:info
                # until a later restart lands, which the checker handles
                try:
                    self.db.setup(test, n)
                except RuntimeError as e:
                    log.warning("restart of %s failed: %s", n, e)
                    errs[n] = str(e)
            return replace(op, type="info",
                           value={"restarted": list(nodes),
                                  "errors": errs} if errs
                           else list(nodes))
        raise ValueError(f"localnode nemesis: unknown f {op.f!r}")

    def teardown(self, test):
        pass


# ---------------------------------------------------------------------------
# client — real TCP, one server per key
# ---------------------------------------------------------------------------


class RegisterClient(client_mod.Client):
    """CAS-register ops over the text protocol.  Error mapping follows
    etcdemo.clj:146-155: an op that demonstrably never reached the
    server is :fail; anything in-flight when the connection died is
    :fail for reads, :info for writes/cas (it may have applied)."""

    def __init__(self, timeout: float = 2.0):
        self.timeout = timeout
        self.socks: dict = {}

    def open(self, test, node):
        c = RegisterClient(self.timeout)
        c.node = node
        return c

    def _sock(self, test, key):
        node = test["nodes"][int(key) % len(test["nodes"])]
        s = self.socks.get(node)
        if s is None:
            s = socket.create_connection(
                ("127.0.0.1", node_port(test, node)),
                timeout=self.timeout)
            self.socks[node] = s
        return node, s

    def _round_trip(self, test, key, line: str) -> str:
        node, s = self._sock(test, key)
        try:
            s.sendall((line + "\n").encode("ascii"))
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(4096)
                if not chunk:
                    raise ConnectionResetError("server closed")
                buf += chunk
            return buf.decode("ascii").strip()
        except OSError:
            self.socks.pop(node, None)
            try:
                s.close()
            except OSError:
                pass
            raise

    def invoke(self, test, op):
        k, v = op.value.key, op.value.value
        try:
            if op.f == "read":
                out = self._round_trip(test, k, f"R {k}")
                val = None if out == "OK nil" else int(out.split()[1])
                return replace(op, type="ok",
                               value=independent.tuple_(k, val))
            if op.f == "write":
                out = self._round_trip(test, k, f"W {k} {v}")
                if out != "OK":
                    return replace(op, type="info", error=out)
                return replace(op, type="ok")
            if op.f == "cas":
                old, new = v
                out = self._round_trip(test, k, f"CAS {k} {old} {new}")
                if out == "OK":
                    return replace(op, type="ok")
                if out == "FAIL":
                    return replace(op, type="fail")
                return replace(op, type="info", error=out)
            raise ValueError(f"unknown f {op.f!r}")
        except ConnectionRefusedError:
            # never reached a server: definitely did not happen
            return replace(op, type="fail", error="refused")
        except OSError as e:
            # in-flight when the server died: reads certainly returned
            # nothing; writes may have applied
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=repr(e))

    def close(self, test):
        for s in self.socks.values():
            try:
                s.close()
            except OSError:
                pass


class LockWireClient(client_mod.Client):
    """tryLock/unlock over the live text protocol — the executed wire
    path for BASELINE config #4 (the reference's hazelcast lock
    workload, hazelcast.clj:260-292 + 379-386).  The op mapping
    mirrors HzLockClient: grant -> :ok, BUSY -> :fail, wrong-owner
    release -> :fail not-lock-owner, connection refused (never reached
    the server) -> :fail, in-flight connection loss -> :info (the op
    may have applied — the checker's indeterminate case).

    The lock is a single cluster-wide resource (hazelcast's CP
    subsystem shape), so every client talks to nodes[0]."""

    def __init__(self, timeout: float = 2.0):
        self.timeout = timeout
        self.sock = None
        self.owner = None
        self.node = None

    def open(self, test, node):
        c = LockWireClient(self.timeout)
        c.node = test["nodes"][0]
        c.owner = f"c{id(c):x}"
        return c

    class _NeverReached(Exception):
        """Connect-phase failure: the request provably never reached
        the server, so the op is a definite :fail — mapping it :info
        would inject spurious indeterminate ops into the mutex history
        (an :info release is exactly what lets the checker explain
        away a real double grant)."""

    def _round_trip(self, test, line: str) -> str:
        if self.sock is None:
            try:
                self.sock = socket.create_connection(
                    ("127.0.0.1", node_port(test, self.node)),
                    timeout=self.timeout)
            except OSError as e:
                raise self._NeverReached(repr(e)) from e
        s = self.sock
        try:
            s.sendall((line + "\n").encode("ascii"))
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(4096)
                if not chunk:
                    raise ConnectionResetError("server closed")
                buf += chunk
            return buf.decode("ascii").strip()
        except OSError:
            self.sock = None
            try:
                s.close()
            except OSError:
                pass
            raise

    def invoke(self, test, op):
        try:
            if op.f == "acquire":
                out = self._round_trip(test, f"LOCK {self.owner}")
                return replace(op, type="ok" if out == "OK" else "fail")
            if op.f == "release":
                out = self._round_trip(test, f"UNLOCK {self.owner}")
                if out == "OK":
                    return replace(op, type="ok")
                return replace(op, type="fail", error="not-lock-owner")
            raise ValueError(f"unknown f {op.f!r}")
        except self._NeverReached as e:
            return replace(op, type="fail", error=str(e)[:120])
        except OSError as e:
            # in-flight when the connection died: the grant/release may
            # have been applied (hazelcast.clj:288-291's indeterminate
            # case)
            return replace(op, type="info", error=repr(e))

    def close(self, test):
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass


def lock_gen(hold: float = 0.0):
    """Alternating acquire/release per process (hazelcast.clj:
    379-383).  ``hold`` sleeps between the two, so the lock spends
    real wall time held — a nemesis that fires mid-test then lands
    inside a held window instead of the microsecond grant gap."""
    cycle = [{"type": "invoke", "f": "acquire", "value": None}]
    if hold > 0:
        cycle.append(gen.sleep(hold))
    cycle.append({"type": "invoke", "f": "release", "value": None})
    return gen.each(lambda: gen.seq(itertools.cycle(cycle)))


def locknode_test(opts: dict) -> dict:
    """BASELINE config #4, executed live: a real lock-server process,
    real TCP clients, kill -9 / restart nemesis, mutex-model verdict
    through the full runner.  With `lock_volatile`, the server forgets
    the holder on crash and the checker must CATCH the double grant —
    the reference's hazelcast finding, reproduced end to end."""
    from ..models import mutex

    kill_every = opts.get("kill_every", 2)
    # staggered ops keep the in-flight window per process tiny, so a
    # kill -9 rarely catches a release mid-flight: a volatile server's
    # forgotten holder then shows up as an ok-acquire pair NO :info
    # release can explain — the checker's invalid verdict is decisive,
    # not timing luck
    rate = opts.get("rate", 100)
    main_phase = gen.nemesis(
        gen.seq(itertools.cycle(
            [gen.sleep(kill_every), {"type": "info", "f": "kill"},
             gen.sleep(0.5), {"type": "info", "f": "restart"}])),
        gen.stagger(1.0 / rate, lock_gen(opts.get("hold", 0.0))))
    phases = [gen.time_limit(opts.get("time_limit", 8), main_phase),
              gen.log("Healing: restarting all servers"),
              gen.nemesis(gen.once({"type": "info", "f": "restart"})),
              gen.sleep(0.5)]
    nodes = opts.get("nodes") or ["n1"]
    return fixtures.noop_test() | dict(opts) | {
        "name": "locknode",
        "nodes": nodes,
        "concurrency": opts.get("concurrency", 4),
        "remote": control.LocalRemote(),
        "db": db(),
        "client": LockWireClient(),
        "nemesis": KillRestartNemesis(),
        "model": mutex(),
        "checker": checker_mod.compose({
            "linear": lin.linearizable(mutex()),
            "timeline": timeline.timeline(),
        }),
        "generator": gen.phases(*phases),
    }


# ---------------------------------------------------------------------------
# workload + test map
# ---------------------------------------------------------------------------


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def _naturals():
    k = 0
    while True:
        yield k
        k += 1


def localnode_test(opts: dict) -> dict:
    rate = opts.get("rate", 25)
    group = opts.get("group_size", 3)
    main_phase = gen.nemesis(
        gen.seq(itertools.cycle(
            [gen.sleep(3), {"type": "info", "f": "kill"},
             gen.sleep(2), {"type": "info", "f": "restart"}])),
        gen.stagger(1.0 / rate, independent.concurrent_generator(
            group, _naturals(),
            lambda k: gen.limit(opts.get("ops_per_key", 30),
                                gen.mix([r, w, cas])))))
    phases = [gen.time_limit(opts.get("time_limit", 12), main_phase),
              gen.log("Healing: restarting all servers"),
              gen.nemesis(gen.once({"type": "info", "f": "restart"})),
              gen.sleep(1)]
    nodes = opts.get("nodes") or ["n1", "n2", "n3"]
    conc = opts.get("concurrency", 2 * group)
    conc -= conc % group  # groups must divide concurrency
    return fixtures.noop_test() | dict(opts) | {
        "name": "localnode",
        "nodes": nodes,
        "concurrency": max(group, conc),
        "remote": control.LocalRemote(),
        "db": db(),
        "client": RegisterClient(),
        "nemesis": KillRestartNemesis(),
        "model": cas_register(),
        "checker": checker_mod.compose({
            "perf": perf_mod.perf(),
            "workload": independent.checker(checker_mod.compose({
                "linear": lin.linearizable(),
                "timeline": timeline.timeline(),
            })),
        }),
        "generator": gen.phases(*phases),
    }


def add_opts(p):
    p.add_argument("-r", "--rate", type=float, default=25)
    p.add_argument("--ops-per-key", type=int, default=30)
    p.add_argument("--group-size", type=int, default=3)
    p.add_argument("--base-port", type=int, default=BASE_PORT)


def main(argv=None):
    cli.main(cli.single_test_cmd(localnode_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
