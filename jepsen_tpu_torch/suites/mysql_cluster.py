"""MySQL Cluster (NDB) suite — three-role shared-nothing cluster.

Reference: mysql-cluster/ (227 LoC,
mysql-cluster/src/jepsen/mysql_cluster.clj).  Every node runs up to
three roles with disjoint NodeId ranges: the management daemon
(ndb_mgmd, ids 1+), the storage engine (ndbd, ids 11+, first four nodes
only), and the SQL frontend (mysqld, ids 21+)
(mysql_cluster.clj:56-96).  Db automation templates /etc/my.cnf and the
cluster-wide /etc/my.config.ini from per-role config snippets, then
starts the roles in dependency order with a synchronize barrier between
each (mysql_cluster.clj:119-205).  The reference ships only the db
automation + a noop simple-test (mysql_cluster.clj:222-227); the bank
client from the percona suite plugs in unchanged for a real workload.
"""

from __future__ import annotations

import logging
from dataclasses import replace  # noqa: F401  (parity import)

from .. import (cli, control, control_util as cu, db as db_mod, fixtures,
                generator as gen, nemesis as nemesis_mod)
from ..os import debian

log = logging.getLogger("jepsen")

USER = "mysql"
MGMD_DIR = "/var/lib/mysql/cluster"
NDBD_DIR = "/var/lib/mysql/data"
MYSQLD_DIR = "/var/lib/mysql/mysql"
SERVER = "/opt/mysql/server-5.6"

MGMD_ID_OFFSET = 1
NDBD_ID_OFFSET = 11
MYSQLD_ID_OFFSET = 21


def node_idx(test, node) -> int:
    return list(test["nodes"]).index(node)


def mgmd_node_id(test, node) -> int:
    return MGMD_ID_OFFSET + node_idx(test, node)


def ndbd_node_id(test, node) -> int:
    return NDBD_ID_OFFSET + node_idx(test, node)


def mysqld_node_id(test, node) -> int:
    return MYSQLD_ID_OFFSET + node_idx(test, node)


def ndbd_nodes(test) -> list:
    """Storage role runs on the first four nodes
    (mysql_cluster.clj:99-103)."""
    return sorted(test["nodes"])[:4]


def mgmd_conf(test, node) -> str:
    return (f"[ndb_mgmd]\nNodeId={mgmd_node_id(test, node)}\n"
            f"hostname={node}\ndatadir={MGMD_DIR}\n")


def ndbd_conf(test, node) -> str:
    return (f"[ndbd]\nNodeId={ndbd_node_id(test, node)}\n"
            f"hostname={node}\ndatadir={NDBD_DIR}\n")


def mysqld_conf(test, node) -> str:
    return f"[mysqld]\nNodeId={mysqld_node_id(test, node)}\nhostname={node}\n"


def nodes_conf(test) -> str:
    """All roles on all nodes (mysql_cluster.clj:105-116)."""
    parts = [mgmd_conf(test, n) for n in test["nodes"]]
    parts += [ndbd_conf(test, n) for n in ndbd_nodes(test)]
    parts += [mysqld_conf(test, n) for n in test["nodes"]]
    return "\n".join(parts)


def ndb_connect_string(test) -> str:
    return ",".join(str(n) for n in test["nodes"])


def my_cnf(test, node) -> str:
    """/etc/my.cnf template (mysql_cluster.clj:119-131)."""
    return "\n".join([
        "[mysqld]",
        f"ndb-nodeid={mysqld_node_id(test, node)}",
        "ndbcluster",
        f"ndb-connectstring={ndb_connect_string(test)}",
        f"datadir={MYSQLD_DIR}",
        f"user={USER}",
        "",
        "[mysql_cluster]",
        f"ndb-connectstring={ndb_connect_string(test)}",
        ""])


def config_ini(test) -> str:
    """/etc/my.config.ini: global defaults + per-role sections
    (mysql_cluster.clj:133-138)."""
    return "\n".join([
        "[ndbd default]",
        "NoOfReplicas=2",
        "DataMemory=128M",
        "IndexMemory=32M",
        "",
        nodes_conf(test)])


def install(sess, version: str) -> None:
    """One fat deb (mysql_cluster.clj:41-51)."""
    debian.install(sess, {"libaio1": "0.3.110-1"})
    su = sess.su()
    url = (f"https://dev.mysql.com/get/Downloads/MySQL-Cluster-7.4/"
           f"mysql-cluster-gpl-{version}-debian7-x86_64.deb")
    deb = cu.cached_wget(su.cd("/tmp"), url)
    su.exec("dpkg", "-i", "--force-confask", "--force-confnew", deb)
    try:
        su.exec("adduser", "--disabled-password", "--gecos", "", USER)
    except control.RemoteError:
        pass


def configure(sess, test, node) -> None:
    """mysql_cluster.clj:119-138."""
    su = sess.su()
    su.exec("echo", my_cnf(test, node), control.lit(">"), "/etc/my.cnf")
    su.exec("mkdir", "-p", MGMD_DIR)
    su.exec("echo", config_ini(test), control.lit(">"),
            "/etc/my.config.ini")


def start_mgmd(sess, test, node) -> None:
    """mysql_cluster.clj:140-147."""
    sess.su().exec(f"{SERVER}/bin/ndb_mgmd",
                   f"--ndb-nodeid={mgmd_node_id(test, node)}",
                   "-f", "/etc/my.config.ini")


def start_ndbd(sess, test, node) -> None:
    """mysql_cluster.clj:149-157 (storage nodes only)."""
    if node not in ndbd_nodes(test):
        return
    su = sess.su()
    su.exec("mkdir", "-p", NDBD_DIR)
    su.exec(f"{SERVER}/bin/ndbd",
            f"--ndb-nodeid={ndbd_node_id(test, node)}")


def start_mysqld(sess, test, node) -> None:
    """mysql_cluster.clj:159-168."""
    su = sess.su()
    su.exec("mkdir", "-p", MYSQLD_DIR)
    su.exec("chown", "-R", f"{USER}:{USER}", MYSQLD_DIR)
    sess.su(USER).exec(f"{SERVER}/bin/mysqld_safe",
                       "--defaults-file=/etc/my.cnf")


class MySQLClusterDB(db_mod.DB, db_mod.LogFiles):
    """mysql_cluster.clj:188-220: mgmd -> ndbd -> mysqld with barriers."""

    def __init__(self, version: str):
        self.version = version

    def setup(self, test, node):
        import time

        from .. import core as core_mod

        sess = control.session(node, test)
        install(sess, self.version)
        configure(sess, test, node)
        time.sleep(5)
        start_mgmd(sess, test, node)
        core_mod.synchronize(test)
        start_ndbd(sess, test, node)
        core_mod.synchronize(test)
        start_mysqld(sess, test, node)
        time.sleep(60)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        for pat in ("mysqld", "ndbd", "ndb_mgmd"):
            cu.grepkill(sess, pat)
        sess.exec("rm", "-rf", control.lit(f"{MGMD_DIR}/*"),
                  control.lit(f"{NDBD_DIR}/*"),
                  control.lit(f"{MYSQLD_DIR}/*"))

    def log_files(self, test, node):
        return [f"{MGMD_DIR}/ndb_{mgmd_node_id(test, node)}_cluster.log"]


def db(version: str = "7.4.6") -> MySQLClusterDB:
    return MySQLClusterDB(version)


def simple_test(opts: dict) -> dict:
    """mysql_cluster.clj:222-227 (noop workload: db automation only).
    Plug the percona BankClient into `client` for a real workload."""
    return fixtures.noop_test() | {
        "name": "mysql-cluster",
        "os": debian.os,
        "db": db(opts.get("version", "7.4.6")),
        "nemesis": nemesis_mod.partition_random_halves(),
        "generator": gen.void,
    } | dict(opts)


def add_opts(p):
    p.add_argument("--version", default="7.4.6")


def main(argv=None):
    cli.main(cli.single_test_cmd(simple_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
