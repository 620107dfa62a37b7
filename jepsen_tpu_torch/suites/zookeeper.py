"""ZooKeeper suite — a single linearizable CAS register.

Reference: zookeeper/src/jepsen/zookeeper.clj: node-id/zoo.cfg generation
(19-38), apt install + myid + service restart (40-71), avout zk-atom CAS
client (78-104), test map with partition-random-halves, cas-register
model, linearizable + perf checkers (106-129).

The client uses kazoo when installed; without it, construction raises an
informative error (the rest of the suite — db automation, workload,
checker wiring — is fully functional and unit-tested).
"""

from __future__ import annotations

import logging
import random
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                fixtures, generator as gen, nemesis, net as net_mod)
from ..checker import linearizable as lin, perf as perf_mod
from ..control import lit
from ..models import cas_register
from ..os import debian
from ..util import timeout as timeout_call

log = logging.getLogger("jepsen")

ZOO_CFG = """tickTime=2000
initLimit=10
syncLimit=5
dataDir=/var/lib/zookeeper
clientPort=2181
"""


def zk_node_ids(test) -> dict:
    """node -> id (zookeeper.clj:19-25)."""
    return {node: i for i, node in enumerate(test["nodes"])}


def zk_node_id(test, node) -> int:
    return zk_node_ids(test)[node]


def zoo_cfg_servers(test) -> str:
    """server.N=host:2888:3888 lines (zookeeper.clj:32-38)."""
    return "\n".join(f"server.{i}={node}:2888:3888"
                     for node, i in zk_node_ids(test).items())


class ZKDB:
    """zookeeper.clj:40-71."""

    def __init__(self, version: str = "3.4.13-2"):
        self.version = version

    def setup(self, test, node):
        log.info("%s installing ZK %s", node, self.version)
        sess = control.session(node, test)
        debian.install(sess, {"zookeeper": self.version,
                              "zookeeper-bin": self.version,
                              "zookeeperd": self.version})
        su = sess.su()
        su.exec("echo", str(zk_node_id(test, node)), lit(">"),
                "/etc/zookeeper/conf/myid")
        su.exec("echo", ZOO_CFG + "\n" + zoo_cfg_servers(test), lit(">"),
                "/etc/zookeeper/conf/zoo.cfg")
        log.info("%s ZK restarting", node)
        su.exec("service", "zookeeper", "restart")
        log.info("%s ZK ready", node)

    def teardown(self, test, node):
        log.info("%s tearing down ZK", node)
        su = control.session(node, test).su()
        su.exec("service", "zookeeper", "stop")
        su.exec("rm", "-rf", lit("/var/lib/zookeeper/version-*"),
                lit("/var/log/zookeeper/*"))

    def log_files(self, test, node):
        return ["/var/log/zookeeper/zookeeper.log"]


def db(version: str = "3.4.13-2") -> ZKDB:
    return ZKDB(version)


class ZKClient(client_mod.Client):
    """CAS register at znode /jepsen via kazoo (the avout zk-atom analog,
    zookeeper.clj:78-104)."""

    PATH = "/jepsen"

    def __init__(self, node=None):
        self.node = node
        self.conn = None

    def open(self, test, node):
        try:
            from kazoo.client import KazooClient
        except ImportError as e:
            raise RuntimeError(
                "the zookeeper suite's client needs the kazoo library; "
                "pip install kazoo on the control node") from e
        c = ZKClient(node)
        c.conn = KazooClient(hosts=f"{node}:2181", timeout=5)
        c.conn.start(timeout=10)
        c.conn.ensure_path(self.PATH)
        try:
            c.conn.create(self.PATH, b"0")
        except Exception:
            pass
        return c

    def invoke(self, test, op):
        def work():
            if op.f == "read":
                data, _stat = self.conn.get(self.PATH)
                return replace(op, type="ok", value=int(data or b"0"))
            if op.f == "write":
                self.conn.set(self.PATH, str(op.value).encode())
                return replace(op, type="ok")
            if op.f == "cas":
                old, new = op.value
                data, stat = self.conn.get(self.PATH)
                if int(data or b"0") != old:
                    return replace(op, type="fail")
                from kazoo.exceptions import BadVersionError

                try:
                    self.conn.set(self.PATH, str(new).encode(),
                                  version=stat.version)
                    return replace(op, type="ok")
                except BadVersionError:
                    return replace(op, type="fail")
            raise ValueError(f"unknown f {op.f!r}")

        return timeout_call(
            5.0, work,
            default=replace(op, type="info", error="timeout"))

    def close(self, test):
        if self.conn is not None:
            self.conn.stop()
            self.conn.close()


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def zk_test(opts: dict) -> dict:
    """zookeeper.clj:106-129."""
    import itertools

    return fixtures.noop_test() | dict(opts) | {
        "name": "zookeeper",
        "os": debian.os,
        "db": db(),
        "net": net_mod.iptables,
        "client": ZKClient(),
        "nemesis": nemesis.partition_random_halves(),
        "model": cas_register(0),
        "checker": checker_mod.compose({
            "perf": perf_mod.perf(),
            "linear": lin.linearizable(),
        }),
        "generator": gen.time_limit(
            opts.get("time_limit", 15),
            gen.nemesis(
                gen.seq(itertools.cycle(
                    [gen.sleep(5), {"type": "info", "f": "start"},
                     gen.sleep(5), {"type": "info", "f": "stop"}])),
                gen.stagger(1, gen.mix([r, w, cas])))),
    }


def main(argv=None):
    cli.main(cli.single_test_cmd(zk_test), argv)


if __name__ == "__main__":
    main()
