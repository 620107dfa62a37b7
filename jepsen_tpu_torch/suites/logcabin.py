"""LogCabin suite — the original Raft implementation's tree store.

Reference: logcabin/ (246 LoC, logcabin/src/jepsen/logcabin.clj).  Db
automation builds LogCabin from source with scons, bootstraps the Raft
log on the primary, starts every daemon, then grows the cluster with the
Reconfigure tool (logcabin.clj:24-150).  The CAS-register client is
unusual: it shells out to the on-node **TreeOps** binary over SSH
(logcabin.clj:162-209's c/on), so the whole suite — client included —
exercises the L0 control plane and is DummyRemote-testable end to end.
"""

from __future__ import annotations

import json
import logging
import random
import re
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures, generator as gen,
                nemesis as nemesis_mod)
from ..checker import linearizable as lin, perf as perf_mod, timeline
from ..models import cas_register
from ..os import debian

log = logging.getLogger("jepsen")

CONFIG = "/root/logcabin.conf"
LOG_FILE = "/root/logcabin.log"
PIDFILE = "/root/logcabin.pid"
STORE_DIR = "/root/storage"
BIN = "/root/LogCabin"
RECONFIGURE = "/root/Reconfigure"
TREEOPS = "/root/TreeOps"
PORT = 5254
OP_TIMEOUT = 3

CAS_MSG = re.compile(
    r"Exiting due to LogCabin::Client::Exception: Path '.*' has value "
    r"'.*', not '.*' as required")
TIMEOUT_MSG = re.compile(
    r"Exiting due to LogCabin::Client::Exception: Client-specified "
    r"timeout elapsed")


def server_id(node) -> str:
    """n1 -> 1 (logcabin.clj:50-52)."""
    return re.sub(r"^\D+", "", str(node)) or "1"


def server_addr(node) -> str:
    return f"{node}:{PORT}"


def server_addrs(test) -> str:
    return ",".join(server_addr(n) for n in test["nodes"])


def install(sess) -> None:
    """git clone + scons build (logcabin.clj:24-47)."""
    debian.install(sess, ["git-core", "protobuf-compiler",
                          "libprotobuf-dev", "libcrypto++-dev", "g++",
                          "scons"])
    su = sess.su()
    if not cu.exists(su, "/logcabin"):
        su.cd("/").exec("git", "clone", "--depth", "1",
                        "https://github.com/logcabin/logcabin.git")
        su.cd("/logcabin").exec("git", "submodule", "update", "--init")
    su.cd("/logcabin").exec("scons")
    for f in ("LogCabin", "Examples/Reconfigure", "Examples/TreeOps"):
        su.exec("cp", "-f", f"/logcabin/build/{f}", "/root")


def configure(sess, node) -> None:
    """logcabin.clj:66-77."""
    conf = (f"serverId = {server_id(node)}\n"
            f"listenAddresses = {server_addr(node)}")
    sess.su().exec("echo", conf, control.lit(">"), CONFIG)


def bootstrap(sess) -> None:
    """logcabin.clj:79-85."""
    sess.su().cd("/root").exec(BIN, "-c", CONFIG, "-l", LOG_FILE,
                               "--bootstrap")


def start(sess) -> None:
    """logcabin.clj:87-93."""
    sess.su().cd("/root").exec(BIN, "-c", CONFIG, "-d", "-l", LOG_FILE,
                               "-p", PIDFILE)


def stop(sess) -> None:
    """logcabin.clj:95-101."""
    su = sess.su()
    cu.grepkill(su, "LogCabin")
    su.exec("rm", "-rf", PIDFILE)


def reconfigure(sess, test) -> None:
    """Grow the cluster to every node (logcabin.clj:103-116)."""
    argv = [RECONFIGURE, "-c", control.lit(server_addrs(test)), "set"]
    argv += [control.lit(server_addr(n)) for n in test["nodes"]]
    sess.su().cd("/root").exec(*argv)


class LogCabinDB(db_mod.DB, db_mod.LogFiles):
    """logcabin.clj:118-150: bootstrap on primary, start all,
    reconfigure from primary."""

    def setup(self, test, node):
        import time

        from .. import core as core_mod

        sess = control.session(node, test)
        install(sess)
        configure(sess, node)
        sess.su().exec("rm", "-rf", LOG_FILE)
        if node == core_mod.primary(test):
            bootstrap(sess)
        core_mod.synchronize(test)
        start(sess)
        core_mod.synchronize(test)
        if node == core_mod.primary(test):
            reconfigure(sess, test)
        core_mod.synchronize(test)
        time.sleep(2)

    def teardown(self, test, node):
        sess = control.session(node, test)
        stop(sess)
        sess.su().exec("rm", "-rf", STORE_DIR)

    def log_files(self, test, node):
        return [LOG_FILE]


def db() -> LogCabinDB:
    return LogCabinDB()


# ---------------------------------------------------------------------------
# TreeOps client over SSH (logcabin.clj:162-240)
# ---------------------------------------------------------------------------


class CASClient(client_mod.Client):
    """read/write/cas against one tree path, shelling to TreeOps on the
    node.  CAS misses surface as a recognizable exception message;
    timeouts map to :fail with :timed-out (logcabin.clj:210-240)."""

    def __init__(self, key: str = "/jepsen", node=None, test=None):
        self.key = key
        self.node = node
        self.test = test

    def open(self, test, node):
        return type(self)(self.key, node, test)

    def setup(self, test):
        self._set(json.dumps(None))

    def _sess(self):
        return control.session(self.node, self.test).su().cd("/root")

    def _get(self) -> str:
        return str(self._sess().exec(
            TREEOPS, "-c", server_addrs(self.test), "-q",
            "-t", str(OP_TIMEOUT), "read", control.lit(self.key)))

    def _set(self, value: str) -> None:
        self._sess().exec(
            "echo", "-n", value, control.lit("|"),
            TREEOPS, "-c", server_addrs(self.test), "-q",
            "-t", str(OP_TIMEOUT), "write", control.lit(self.key))

    def _cas(self, v1: str, v2: str) -> bool:
        """logcabin.clj:190-209: -p path:expected guard."""
        try:
            self._sess().exec(
                "echo", "-n", v2, control.lit("|"),
                TREEOPS, "-c", server_addrs(self.test), "-q",
                "-p", control.lit(f"{self.key}:{v1}"),
                "-t", str(OP_TIMEOUT), "write", control.lit(self.key))
            return True
        except control.RemoteError as e:
            if CAS_MSG.search(str(e)):
                return False
            raise

    def invoke(self, test, op):
        self.test = test
        try:
            if op.f == "read":
                return replace(op, type="ok",
                               value=json.loads(self._get().strip()
                                                or "null"))
            if op.f == "write":
                self._set(json.dumps(op.value))
                return replace(op, type="ok")
            if op.f == "cas":
                frm, to = op.value
                ok = self._cas(json.dumps(frm), json.dumps(to))
                return replace(op, type="ok" if ok else "fail")
            raise ValueError(f"unknown f {op.f!r}")
        except control.RemoteError as e:
            # timeouts are indeterminate for writes/cas: the server may
            # have applied the op after the client gave up
            kind = "fail" if op.f == "read" else "info"
            if TIMEOUT_MSG.search(str(e)):
                return replace(op, type=kind, error="timed-out")
            return replace(op, type=kind, error=str(e)[:200])


# ---------------------------------------------------------------------------
# test
# ---------------------------------------------------------------------------


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randint(0, 4), random.randint(0, 4))}


def logcabin_test(opts: dict) -> dict:
    tl = opts.get("time_limit", 60)
    return fixtures.noop_test() | {
        "name": "logcabin",
        "os": debian.os,
        "db": db(),
        "client": CASClient(),
        "model": cas_register(),
        "nemesis": nemesis_mod.partition_random_halves(),
        "checker": checker_mod.compose({
            "linear": lin.linearizable(cas_register()),
            "timeline": timeline.timeline(),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.time_limit(tl, gen.nemesis(
            gen.start_stop(5, 5),
            gen.stagger(0.5, gen.mix([r, w, cas])))),
    } | dict(opts)


def main(argv=None):
    cli.main(cli.single_test_cmd(logcabin_test), argv)


if __name__ == "__main__":
    main()
