"""Raftis suite — redis protocol over the floyd Raft library.

Reference: raftis/ (138 LoC, raftis/src/jepsen/raftis.clj).  Db
automation installs a release tarball and daemonizes the binary with an
initial-cluster string (raftis.clj:75-105); the client is a single
register over redis GET/SET on port 6379 (raftis.clj:28-57), with
raftis's "no leader" / socket errors mapped to :fail (writes that time
out are indeterminate :info).  The RESP socket client is shared with the
disque suite.
"""

from __future__ import annotations

import logging
import random
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures, generator as gen,
                nemesis as nemesis_mod)
from ..checker import linearizable as lin, perf as perf_mod, timeline
from ..models import register as register_model
from ..os import debian
from .disque import RespConn, RespError

log = logging.getLogger("jepsen")

DIR = "/opt/raftis"
LOG_FILE = f"{DIR}/raftis.log"
PIDFILE = f"{DIR}/raftis.pid"
BINARY = "raftis"
RAFT_PORT = 8901
REDIS_PORT = 6379


def initial_cluster(test) -> str:
    """n1:8901,n2:8901,... (raftis.clj:66-73)."""
    return ",".join(f"{n}:{RAFT_PORT}" for n in test["nodes"])


class RaftisDB(db_mod.DB, db_mod.LogFiles):
    """raftis.clj:75-105."""

    def __init__(self, version: str):
        self.version = version

    def setup(self, test, node):
        import time

        sess = control.session(node, test).su()
        url = (f"https://github.com/Qihoo360/floyd/releases/download/"
               f"{self.version}/raftis-{self.version}.tar.gz")
        cu.install_archive(sess, url, DIR)
        cu.start_daemon(
            sess, BINARY,
            initial_cluster(test), str(node), str(RAFT_PORT), "data",
            str(REDIS_PORT),
            logfile=LOG_FILE, pidfile=PIDFILE, chdir=DIR)
        time.sleep(10)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        try:
            cu.stop_daemon(sess, PIDFILE, cmd=BINARY)
        except control.RemoteError:
            pass
        sess.exec("rm", "-rf", DIR)

    def log_files(self, test, node):
        return [f"{DIR}/data/LOG", LOG_FILE]


def db(version: str = "v2.0.4") -> RaftisDB:
    return RaftisDB(version)


class RegisterClient(client_mod.Client):
    """GET/SET register (raftis.clj:28-57): "no leader" and closed
    sockets are determinate :fail; write timeouts are :info."""

    key = "r"

    def __init__(self, node=None):
        self.node = node
        self.conn = None

    def open(self, test, node):
        c = type(self)(node)
        return c

    def _conn(self):
        if self.conn is None:
            self.conn = RespConn(str(self.node), port=REDIS_PORT)
        return self.conn

    def _drop(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def invoke(self, test, op):
        try:
            if op.f == "read":
                raw = self._conn().command("GET", self.key)
                return replace(op, type="ok",
                               value=int(raw) if raw not in (None, "")
                               else None)
            if op.f == "write":
                self._conn().command("SET", self.key, op.value)
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        except RespError as e:
            msg = str(e)
            determinate = ("no leader" in msg or op.f == "read")
            return replace(op, type="fail" if determinate else "info",
                           error=msg)
        except (TimeoutError, OSError) as e:
            self._drop()
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e) or "timeout")

    def close(self, test):
        self._drop()


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def raftis_test(opts: dict) -> dict:
    """raftis.clj:107-131."""
    import itertools

    tl = opts.get("time_limit", 60)
    return fixtures.noop_test() | {
        "name": "raftis",
        "os": debian.os,
        "db": db(opts.get("version", "v2.0.4")),
        "client": RegisterClient(),
        "model": register_model(initial=0),
        "nemesis": nemesis_mod.partition_random_halves(),
        "checker": checker_mod.compose({
            "linear": lin.linearizable(register_model(initial=0)),
            "timeline": timeline.timeline(),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.time_limit(tl, gen.nemesis(
            gen.seq(itertools.cycle(
                [gen.sleep(5), {"type": "info", "f": "start"},
                 gen.sleep(5), {"type": "info", "f": "stop"}])),
            gen.stagger(0.1, gen.mix([r, w])))),
    } | dict(opts)


def add_opts(p):
    p.add_argument("--version", default="v2.0.4")


def main(argv=None):
    cli.main(cli.single_test_cmd(raftis_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
