"""MariaDB Galera Cluster suite.

Reference: galera/ (529 LoC).  Db automation adds the mariadb-galera apt
repo with debconf-preseeded root passwords, writes a wsrep config with a
``gcomm://n1,n2,...`` cluster address, bootstraps the primary with
``--wsrep-new-cluster`` and then joins the rest
(galera/src/jepsen/galera.clj:34-121); workloads: the dirty-reads race
(galera/src/jepsen/galera/dirty_reads.clj) and a bank-style set test.

SQL clients speak the mysql wire protocol and are gated on pymysql;
db automation, generators, and checkers run without it.
"""

from __future__ import annotations

import itertools
import logging
import random
import threading
import time
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures,
                generator as gen, nemesis as nemesis_mod)
from ..checker import basic, dirty, perf as perf_mod
from ..os import debian

log = logging.getLogger("jepsen")

DIR = "/var/lib/mysql"
STOCK_DIR = "/var/lib/mysql-stock"
LOG_FILES = ["/var/log/syslog", "/var/log/mysql.log", "/var/log/mysql.err",
             f"{DIR}/queries.log"]


def apt_line(version: str) -> str:
    return (f"deb http://sfo1.mirrors.digitalocean.com/mariadb/repo/"
            f"{version}/debian jessie main")


def cluster_address(test) -> str:
    """gcomm://n1,n2,... (galera.clj:59-62)."""
    return "gcomm://" + ",".join(str(n) for n in test["nodes"])


def install(sess, version: str) -> None:
    """Repo + preseeded package install (galera.clj:33-57)."""
    debian.add_repo(sess, "galera", apt_line(version),
                    keyserver="keyserver.ubuntu.com",
                    key="0xcbcb082a1bb943db")
    pkg = f"mariadb-galera-server-{version}"
    for sel in (
            f"{pkg} mysql-server/root_password password jepsen",
            f"{pkg} mysql-server/root_password_again password jepsen",
            f"{pkg} mysql-server-5.1/start_on_boot boolean false"):
        sess.su().exec("echo", sel, control.lit("|"), "debconf-set-selections")
    debian.install(sess.su(), ["rsync", "mariadb-galera-server"])
    sess.su().exec("service", "mysql", "stop")
    # squirrel away stock data files for teardown restore
    sess.su().exec("rm", "-rf", STOCK_DIR)
    sess.su().exec("cp", "-rp", DIR, STOCK_DIR)


def configure(sess, test) -> None:
    """wsrep config with the gcomm address (galera.clj:64-74)."""
    cnf = "\n".join([
        "[mysqld]",
        "binlog_format=ROW",
        "innodb_autoinc_lock_mode=2",
        "wsrep_provider=/usr/lib/galera/libgalera_smm.so",
        f"wsrep_cluster_address={cluster_address(test)}",
        "wsrep_sst_method=rsync",
        ""])
    sess.su().exec("echo", cnf, control.lit(">"),
                   "/etc/mysql/conf.d/jepsen.cnf")


def eval_sql(sess, s: str) -> None:
    """mysql one-liner as root (galera.clj:81-84)."""
    sess.su().exec("mysql", "-u", "root", "--password=jepsen", "-e", s)


def setup_db(sess) -> None:
    """jepsen database + user grant (galera.clj:96-101)."""
    eval_sql(sess, "create database if not exists jepsen;")
    eval_sql(sess, "GRANT ALL PRIVILEGES ON jepsen.* TO 'jepsen'@'%' "
                   "IDENTIFIED BY 'jepsen';")


class GaleraDB(db_mod.DB, db_mod.LogFiles):
    """galera.clj:103-131: primary bootstraps a new cluster, the rest
    join, synchronized in phases."""

    def __init__(self, version: str = "10.0"):
        self.version = version

    def setup(self, test, node):
        from .. import core as core_mod

        sess = control.session(node, test)
        install(sess, self.version)
        configure(sess, test)
        if node == core_mod.primary(test):
            sess.su().exec("service", "mysql", "start",
                           "--wsrep-new-cluster")
        core_mod.synchronize(test)
        if node != core_mod.primary(test):
            sess.su().exec("service", "mysql", "start")
        core_mod.synchronize(test)
        setup_db(sess)
        log.info("%s galera install complete", node)
        time.sleep(5)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        cu.grepkill(sess, "mysqld")
        for f in LOG_FILES:
            try:
                sess.exec("truncate", "-c", "--size", "0", f)
            except control.RemoteError:
                pass
        sess.exec("rm", "-rf", DIR)
        sess.exec("cp", "-rp", STOCK_DIR, DIR)

    def log_files(self, test, node):
        return LOG_FILES


def db(version: str = "10.0") -> GaleraDB:
    return GaleraDB(version)


# ---------------------------------------------------------------------------
# clients (pymysql-gated)
# ---------------------------------------------------------------------------


class MySQLClient(client_mod.Client):
    """Serializable-txn client over the mysql wire protocol."""

    def __init__(self, node=None):
        self.node = node
        self.conn = None

    def open(self, test, node):
        try:
            import pymysql
        except ImportError as e:
            raise RuntimeError(
                "galera clients need pymysql (mysql wire protocol); "
                "pip install pymysql on the control node") from e
        c = type(self)(node)
        c.conn = pymysql.connect(host=str(node), port=3306, user="jepsen",
                                 password="jepsen", database="jepsen",
                                 connect_timeout=5)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def txn(self, f):
        """One serializable transaction; deadlock aborts raise."""
        with self.conn.cursor() as cur:
            cur.execute("SET TRANSACTION ISOLATION LEVEL SERIALIZABLE")
        try:
            result = None
            with self.conn.cursor() as cur:
                self.conn.begin()
                result = f(cur)
            self.conn.commit()
            return result
        except Exception:
            self.conn.rollback()
            raise


#: mysql error codes that guarantee the txn rolled back
#: (galera.clj:133-135 matches the driver's deadlock message)
ABORT_CODES = {1213,  # ER_LOCK_DEADLOCK
               1205}  # ER_LOCK_WAIT_TIMEOUT


def _is_abort(e: Exception) -> bool:
    code = e.args[0] if getattr(e, "args", None) else None
    return isinstance(code, int) and code in ABORT_CODES


class DirtyReadsClient(MySQLClient):
    """dirty_reads.clj:29-67: n-row table; writes set every row to the
    op's unique value (read-then-update, shuffled order); reads snapshot
    all rows."""

    def __init__(self, node=None, n: int = 4):
        super().__init__(node)
        self.n = n

    def open(self, test, node):
        c = super().open(test, node)
        c.n = self.n
        return c

    def setup(self, test):
        def f(cur):
            cur.execute("create table if not exists dirty ("
                        "id int not null primary key, x bigint not null)")
            for i in range(self.n):
                try:
                    cur.execute("insert into dirty (id, x) "
                                "values (%s, -1)", (i,))
                except Exception:
                    pass  # row exists
        self.txn(f)

    def invoke(self, test, op):
        try:
            if op.f == "read":
                def f(cur):
                    cur.execute("select x from dirty")
                    return [row[0] for row in cur.fetchall()]
                return replace(op, type="ok", value=self.txn(f))
            if op.f == "write":
                x = op.value

                def f(cur):
                    order = random.sample(range(self.n), self.n)
                    for i in order:
                        cur.execute("select * from dirty where id = %s",
                                    (i,))
                        cur.fetchall()
                    for i in order:
                        cur.execute("update dirty set x = %s "
                                    "where id = %s", (x, i))
                self.txn(f)
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            # Known txn aborts are definite: their effects must never be
            # visible (dirty_reads.clj with-txn-aborts → :fail).  Anything
            # else — connection drop mid-commit, timeout — is
            # indeterminate and must be :info, or the checker would count
            # a possibly-committed write as failed and flag legitimate
            # reads of it as dirty.
            return replace(op,
                           type="fail" if _is_abort(e) else "info",
                           error=str(e))


class SetClient(MySQLClient):
    """Bank-style lost-updates set test (galera/set.clj semantics):
    adds insert unique values; the final read returns them all."""

    def setup(self, test):
        def f(cur):
            cur.execute("create table if not exists sets "
                        "(val bigint not null primary key)")
        self.txn(f)

    def invoke(self, test, op):
        try:
            if op.f == "add":
                def f(cur):
                    cur.execute("insert into sets (val) values (%s)",
                                (op.value,))
                self.txn(f)
                return replace(op, type="ok")
            if op.f == "read":
                def f(cur):
                    cur.execute("select val from sets")
                    return sorted(row[0] for row in cur.fetchall())
                return replace(op, type="ok", value=self.txn(f))
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))


# ---------------------------------------------------------------------------
# workloads + test maps
# ---------------------------------------------------------------------------


def dirty_reads_generator():
    """Unique write values vs reads, 50/50 (dirty_reads.clj:97-103)."""
    counter = itertools.count()
    lock = threading.Lock()

    def write(test, process):
        with lock:
            v = next(counter)
        return {"type": "invoke", "f": "write", "value": v}

    def read(test, process):
        return {"type": "invoke", "f": "read", "value": None}

    return gen.mix([read, write])


def dirty_reads_test(opts: dict) -> dict:
    return basic_test(opts) | {
        "name": "galera dirty-reads",
        "client": DirtyReadsClient(n=opts.get("rows", 4)),
        "generator": gen.time_limit(opts.get("time_limit", 60),
                                    gen.clients(dirty_reads_generator())),
        "nemesis": nemesis_mod.noop,
        "checker": checker_mod.compose({
            "perf": perf_mod.perf(),
            "dirty-reads": dirty.dirty_reads(),
        }),
    }


def set_generator():
    counter = itertools.count()
    lock = threading.Lock()

    def add(test, process):
        with lock:
            v = next(counter)
        return {"type": "invoke", "f": "add", "value": v}
    return add


def set_test(opts: dict) -> dict:
    return basic_test(opts) | {
        "name": "galera set",
        "client": SetClient(),
        "generator": gen.phases(
            gen.time_limit(opts.get("time_limit", 60),
                           gen.nemesis(gen.start_stop(5, 5),
                                       set_generator())),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(5),
            gen.clients(gen.once({"type": "invoke", "f": "read",
                                  "value": None}))),
        "checker": checker_mod.compose({
            "perf": perf_mod.perf(),
            "set": basic.set_checker(),
        }),
    }


WORKLOADS = {"dirty-reads": dirty_reads_test, "set": set_test}


def basic_test(opts: dict) -> dict:
    """galera.clj:188-196."""
    return fixtures.noop_test() | {
        "os": debian.os,
        "db": db(opts.get("version", "10.0")),
        "nemesis": nemesis_mod.partition_random_halves(),
    } | dict(opts)


def add_opts(p):
    p.add_argument("--workload", default="dirty-reads",
                   choices=sorted(WORKLOADS))
    p.add_argument("--version", default="10.0")
    p.add_argument("--rows", type=int, default=4)


def galera_test(opts: dict) -> dict:
    return WORKLOADS[opts.get("workload", "dirty-reads")](opts)


def main(argv=None):
    cli.main(cli.single_test_cmd(galera_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
