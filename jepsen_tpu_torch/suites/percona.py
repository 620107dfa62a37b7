"""Percona XtraDB Cluster suite — galera-replicated MySQL bank test.

Reference: percona/ (482 LoC, percona/src/jepsen/percona.clj).  Db
automation adds the percona apt repo, pre-seeds debconf root passwords,
installs the pinned package, templates jepsen.cnf with the gcomm://
cluster address, bootstraps the primary with ``service mysql start
bootstrap-pxc`` and joins the rest (percona.clj:34-150).  The workload
is the bank test with selectable row-lock mode: ``select ... for
update`` vs ``lock in share mode`` — the latter exposes lost updates
under galera (percona.clj:231-343).  SQL rides pymysql (gated), same as
the galera suite.
"""

from __future__ import annotations

import logging
import random
import threading
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures, generator as gen,
                nemesis as nemesis_mod)
from ..checker import basic, perf as perf_mod
from ..os import debian

log = logging.getLogger("jepsen")

DIR = "/var/lib/mysql"
STOCK_DIR = "/var/lib/mysql-stock"
PKG = "percona-xtradb-cluster-56"

DEBCONF_LINES = [
    f"{PKG} mysql-server/root_password password jepsen",
    f"{PKG} mysql-server/root_password_again password jepsen",
    f"{PKG} mysql-server-5.1/start_on_boot boolean false",
    "percona-xtradb-cluster-server-5.6 percona-xtradb-cluster-server/"
    "root_password_again password jepsen",
    "percona-xtradb-cluster-server-5.6 percona-xtradb-cluster-server/"
    "root_password password jepsen",
]


def cluster_address(test, node) -> str:
    """gcomm:// on the primary; the full node list elsewhere
    (percona.clj:73-78)."""
    from .. import core as core_mod

    if node == core_mod.primary(test):
        return "gcomm://"
    return "gcomm://" + ",".join(str(n) for n in test["nodes"])


def config_cnf(test, node) -> str:
    """jepsen.cnf analog (percona.clj:80-89's template)."""
    return "\n".join([
        "[mysqld]",
        f"wsrep_cluster_address={cluster_address(test, node)}",
        "wsrep_provider=/usr/lib/libgalera_smm.so",
        "wsrep_sst_method=rsync",
        "wsrep_cluster_name=jepsen",
        "binlog_format=ROW",
        "default_storage_engine=InnoDB",
        "innodb_autoinc_lock_mode=2",
        ""])


def install(sess, version: str) -> None:
    """percona.clj:34-71."""
    debian.add_repo(sess, "percona",
                    "deb http://repo.percona.com/apt jessie main",
                    "keys.gnupg.net", "1C4CBDCDCD2EFD2A")
    su = sess.su()
    debian.install(sess, ["rsync"])
    if debian.installed_version(sess, PKG) != version:
        for line in DEBCONF_LINES:
            su.exec("echo", line, control.lit("|"),
                    "debconf-set-selections")
        su.exec("rm", "-rf", "/etc/mysql/conf.d/jepsen.cnf")
        su.exec("rm", "-rf", DIR)
        debian.install(sess, {PKG: version})
        su.exec("service", "mysql", "stop")
        su.exec("rm", "-rf", STOCK_DIR)
        su.exec("cp", "-rp", DIR, STOCK_DIR)


def sql_eval(sess, stmt: str) -> str:
    """mysql CLI escape hatch (percona.clj:97-100)."""
    return str(sess.su().exec("mysql", "-u", "root", "--password=jepsen",
                              "-e", stmt))


def setup_db(sess) -> None:
    """percona.clj:111-116."""
    sql_eval(sess, "create database if not exists jepsen;")
    sql_eval(sess, "GRANT ALL PRIVILEGES ON jepsen.* TO 'jepsen'@'%' "
                   "IDENTIFIED BY 'jepsen';")


class PerconaDB(db_mod.DB, db_mod.LogFiles):
    """percona.clj:118-150: bootstrap-pxc on primary, plain start on the
    rest."""

    def __init__(self, version: str):
        self.version = version

    def setup(self, test, node):
        from .. import core as core_mod

        sess = control.session(node, test)
        install(sess, self.version)
        su = sess.su()
        su.exec("echo", config_cnf(test, node), control.lit(">"),
                "/etc/mysql/conf.d/jepsen.cnf")
        primary = core_mod.primary(test)
        if node == primary:
            su.exec("service", "mysql", "start", "bootstrap-pxc")
        core_mod.synchronize(test)
        if node != primary:
            su.exec("service", "mysql", "start")
        core_mod.synchronize(test)
        if node == primary:
            setup_db(sess)
        core_mod.synchronize(test)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        cu.grepkill(sess, "mysqld")
        # restore the squirreled-away stock data dir
        sess.exec("rm", "-rf", DIR)
        sess.exec("cp", "-rp", STOCK_DIR, DIR)

    def log_files(self, test, node):
        return ["/var/log/syslog", "/var/log/mysql.log",
                "/var/log/mysql.err"]


def db(version: str = "5.6.25-25.12-1.jessie") -> PerconaDB:
    return PerconaDB(version)


# ---------------------------------------------------------------------------
# bank client (percona.clj:231-313; pymysql-gated)
# ---------------------------------------------------------------------------


class BankClient(client_mod.Client):
    """Transfers with a configurable lock clause; reads grab every
    balance in one statement."""

    ddl_lock = threading.Lock()

    def __init__(self, node=None, n: int = 5, starting_balance: int = 10,
                 lock_type: str = " FOR UPDATE", in_place: bool = False):
        self.node = node
        self.n = n
        self.starting_balance = starting_balance
        self.lock_type = lock_type
        self.in_place = in_place
        self.conn = None

    def _connect(self, node):
        try:
            import pymysql
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "percona clients need pymysql (mysql wire "
                "protocol)") from e
        return pymysql.connect(host=str(node), port=3306, user="jepsen",
                               password="jepsen", database="jepsen",
                               autocommit=False, connect_timeout=10,
                               read_timeout=10, write_timeout=10)

    def open(self, test, node):
        c = type(self)(node, self.n, self.starting_balance,
                       self.lock_type, self.in_place)
        c.conn = self._connect(node)
        return c

    def setup(self, test):
        with BankClient.ddl_lock:
            done = test.setdefault("_percona_ddl_done", False)
            if done:
                return
            test["_percona_ddl_done"] = True
            conn = self._connect(test["nodes"][0])
            try:
                with conn.cursor() as cur:
                    cur.execute(
                        "create table if not exists accounts"
                        " (id int not null primary key,"
                        "  balance bigint not null)")
                    for i in range(self.n):
                        cur.execute("insert ignore into accounts"
                                    " values (%s, %s)",
                                    (i, self.starting_balance))
                conn.commit()
            finally:
                conn.close()

    def invoke(self, test, op):
        import pymysql

        try:
            with self.conn.cursor() as cur:
                cur.execute("begin")
                out = self._body(cur, op)
                self.conn.commit()
                return out
        except pymysql.err.MySQLError as e:
            try:
                self.conn.rollback()
            except Exception:
                pass
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))

    def _body(self, cur, op):
        from ..bank import sql_bank_body

        return sql_bank_body(cur, op, self.n, lock_type=self.lock_type,
                             in_place=self.in_place)

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            except Exception:
                pass
            self.conn = None


# ---------------------------------------------------------------------------
# test (percona.clj:343-380)
# ---------------------------------------------------------------------------


from ..bank import bank_read, bank_transfer  # noqa: E402  (shared workload)


def bank_test(opts: dict) -> dict:
    import itertools

    n = opts.get("accounts", 5)
    lock_type = (" LOCK IN SHARE MODE"
                 if opts.get("lock_type") == "share" else " FOR UPDATE")
    tl = opts.get("time_limit", 30)
    return fixtures.noop_test() | {
        "name": f"percona bank{' share-lock' if 'SHARE' in lock_type else ''}",
        "os": debian.os,
        "db": db(opts.get("version", "5.6.25-25.12-1.jessie")),
        "client": BankClient(n=n, lock_type=lock_type,
                             in_place=opts.get("in_place", False)),
        "total_amount": n * 10,
        "nemesis": nemesis_mod.partition_random_halves(),
        "checker": checker_mod.compose({
            "bank": basic.bank(),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.phases(
            gen.time_limit(tl, gen.nemesis(
                gen.seq(itertools.cycle(
                    [gen.sleep(0), {"type": "info", "f": "start"},
                     gen.sleep(10), {"type": "info", "f": "stop"}])),
                gen.stagger(0.1, gen.mix(
                    [bank_read, bank_transfer(n), bank_transfer(n)])))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(5),
            gen.clients(gen.each(lambda: gen.once(
                {"type": "invoke", "f": "read", "value": None})))),
    } | dict(opts)


def add_opts(p):
    p.add_argument("--lock-type", default="update",
                   choices=["update", "share"])
    p.add_argument("--in-place", action="store_true")
    p.add_argument("--accounts", type=int, default=5)
    p.add_argument("--version", default="5.6.25-25.12-1.jessie")


def main(argv=None):
    cli.main(cli.single_test_cmd(bank_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
