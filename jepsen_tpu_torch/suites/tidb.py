"""TiDB suite — distributed SQL on TiKV/Raft with placement-driver.

Reference: tidb/ (882 LoC).  Db automation installs one tarball holding
three binaries and starts them in dependency order on every node: the
placement driver (pd-server, etcd-style peer/client URLs and an
initial-cluster string), then the raft KV store (tikv-server pointed at
every pd), then the SQL layer (tidb-server)
(tidb/src/tidb/db.clj:79-140); teardown stops them in reverse
(db.clj:123-128).  Workloads (SQL over the mysql protocol, gated on
pymysql like the galera suite):

  * register — independent-key CAS register via select-for-update +
    conditional update, linearizability-checked on the device engine
    (tidb/src/tidb/register.clj:20-79)
  * bank — snapshot-isolation transfer invariant
    (tidb/src/tidb/bank.clj:17-120)
  * sets — unique inserts, final read, set checker
    (tidb/src/tidb/sets.clj)

Nemesis menu mirrors tidb/src/tidb/nemesis.clj:110-140: none, parts
(random halves), startstop / startkill on pd+tikv+tidb daemons.
"""

from __future__ import annotations

import logging
import random
import threading
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures, generator as gen,
                independent, nemesis as nemesis_mod)
from ..checker import basic, linearizable as lin, perf as perf_mod, timeline
from ..models import cas_register
from ..os import debian

log = logging.getLogger("jepsen")

DIR = "/opt/tidb"
CLIENT_PORT = 2379
PEER_PORT = 2380
KV_PORT = 20160
SQL_PORT = 4000
TARBALL = ("http://download.pingcap.org/tidb-latest-linux-amd64.tar.gz")

PD_LOG = f"{DIR}/jepsen-pd.log"
PD_PID = f"{DIR}/jepsen-pd.pid"
KV_LOG = f"{DIR}/jepsen-kv.log"
KV_PID = f"{DIR}/jepsen-kv.pid"
DB_LOG = f"{DIR}/jepsen-db.log"
DB_PID = f"{DIR}/jepsen-db.pid"
PD_CONF = f"{DIR}/pd.conf"
KV_CONF = f"{DIR}/tikv.conf"


def pd_name(node) -> str:
    """n1 -> pd-n1 (db.clj:33-41's tidb-map, generalized to any node
    names)."""
    return f"pd-{node}"


def kv_name(node) -> str:
    return f"tikv-{node}"


def client_url(node) -> str:
    return f"http://{node}:{CLIENT_PORT}"


def peer_url(node) -> str:
    return f"http://{node}:{PEER_PORT}"


def initial_cluster(test) -> str:
    """pd-n1=http://n1:2380,... (db.clj:60-67)."""
    return ",".join(f"{pd_name(n)}={peer_url(n)}" for n in test["nodes"])


def pd_endpoints(test) -> str:
    """n1:2379,n2:2379,... (db.clj:69-76)."""
    return ",".join(f"{n}:{CLIENT_PORT}" for n in test["nodes"])


def start_pd(sess, test, node) -> None:
    """db.clj:81-96."""
    cu.start_daemon(
        sess, "./bin/pd-server",
        "--name", pd_name(node),
        "--data-dir", pd_name(node),
        "--client-urls", f"http://0.0.0.0:{CLIENT_PORT}",
        "--peer-urls", f"http://0.0.0.0:{PEER_PORT}",
        "--advertise-client-urls", client_url(node),
        "--advertise-peer-urls", peer_url(node),
        "--initial-cluster", initial_cluster(test),
        "--log-file", "pd.log",
        "--config", PD_CONF,
        logfile=PD_LOG, pidfile=PD_PID, chdir=DIR)


def start_kv(sess, test, node) -> None:
    """db.clj:98-109."""
    cu.start_daemon(
        sess, "./bin/tikv-server",
        "--pd", pd_endpoints(test),
        "--addr", f"0.0.0.0:{KV_PORT}",
        "--advertise-addr", f"{node}:{KV_PORT}",
        "--data-dir", kv_name(node),
        "--log-file", "tikv.log",
        "--config", KV_CONF,
        logfile=KV_LOG, pidfile=KV_PID, chdir=DIR)


def start_db(sess, test, node) -> None:
    """db.clj:111-121."""
    cu.start_daemon(
        sess, "./bin/tidb-server",
        "--store", "tikv",
        "--path", pd_endpoints(test),
        "--log-file", "tidb.log",
        logfile=DB_LOG, pidfile=DB_PID, chdir=DIR)


def stop_all(sess) -> None:
    """Reverse order (db.clj:123-128)."""
    for binary, pidfile in (("tidb-server", DB_PID),
                            ("tikv-server", KV_PID),
                            ("pd-server", PD_PID)):
        try:
            cu.stop_daemon(sess, pidfile, cmd=binary)
        except control.RemoteError:
            pass


class TiDB(db_mod.DB, db_mod.LogFiles):
    """db.clj:130-160: install tarball, write configs, start the three
    layers in order with settle pauses."""

    def __init__(self, tarball: str = TARBALL):
        self.tarball = tarball

    def setup(self, test, node):
        import time

        from .. import core as core_mod

        sess = control.session(node, test).su()
        cu.install_archive(sess, self.tarball, DIR)
        sess.exec("echo", "[replication]\nmax-replicas=5",
                  control.lit(">"), PD_CONF)
        sess.exec("echo",
                  '[raftstore]\npd-heartbeat-tick-interval="5s"',
                  control.lit(">"), KV_CONF)
        start_pd(sess, test, node)
        core_mod.synchronize(test)
        time.sleep(10)
        start_kv(sess, test, node)
        core_mod.synchronize(test)
        time.sleep(10)
        start_db(sess, test, node)
        core_mod.synchronize(test)
        time.sleep(10)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        stop_all(sess)
        sess.exec("rm", "-rf", control.lit(f"{DIR}/pd-*"),
                  control.lit(f"{DIR}/tikv-*"),
                  control.lit(f"{DIR}/jepsen-*.log"))

    def log_files(self, test, node):
        return [PD_LOG, KV_LOG, DB_LOG,
                f"{DIR}/pd.log", f"{DIR}/tikv.log", f"{DIR}/tidb.log"]


def db(tarball: str = TARBALL) -> TiDB:
    return TiDB(tarball)


# ---------------------------------------------------------------------------
# SQL clients (pymysql-gated; sql.clj's conn-spec/with-txn)
# ---------------------------------------------------------------------------


class TiDBClient(client_mod.Client):
    """Autocommit-off transactions against the tidb-server SQL port
    (tidb/src/tidb/sql.clj)."""

    ddl_lock = threading.Lock()

    def __init__(self, node=None):
        self.node = node
        self.conn = None

    def _connect(self, node):
        try:
            import pymysql
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "tidb clients need pymysql (mysql wire protocol)") from e
        return pymysql.connect(host=str(node), port=SQL_PORT, user="root",
                               database="test", autocommit=False,
                               connect_timeout=10, read_timeout=10,
                               write_timeout=10)

    def open(self, test, node):
        c = type(self)(node)
        c.conn = self._connect(node)
        return c

    def once_ddl(self, test, stmts: list[str]) -> None:
        # guard lives in the per-run test map so a --test-count rerun
        # (fresh db after teardown) re-creates its tables
        with TiDBClient.ddl_lock:
            done = test.setdefault("_tidb_ddl_done", set())
            key = type(self).__name__
            if key in done:
                return
            done.add(key)
            conn = self._connect(test["nodes"][0])
            try:
                with conn.cursor() as cur:
                    for s in stmts:
                        cur.execute(s)
                conn.commit()
            finally:
                conn.close()

    def txn(self, op, body):
        """Run body(cursor) in a transaction; map errors like
        sql.clj's with-txn: conflicts :fail, connection loss :info."""
        import pymysql

        try:
            with self.conn.cursor() as cur:
                cur.execute("begin")
                out = body(cur)
                self.conn.commit()
                return out
        except pymysql.err.OperationalError as e:
            try:
                self.conn.rollback()
            except Exception:
                pass
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))
        except pymysql.err.MySQLError as e:
            try:
                self.conn.rollback()
            except Exception:
                pass
            return replace(op, type="fail", error=str(e))

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            except Exception:
                pass
            self.conn = None


class RegisterClient(TiDBClient):
    """register.clj:20-52: select ... for update, then write/cas."""

    def setup(self, test):
        self.once_ddl(test, [
            "drop table if exists test",
            "create table if not exists test"
            " (id int primary key, val int)"])

    def invoke(self, test, op):
        k, v = op.value

        def body(cur):
            cur.execute("select val from test where id = %s for update",
                        (k,))
            row = cur.fetchone()
            val = row[0] if row else None
            if op.f == "read":
                return replace(op, type="ok",
                               value=independent.tuple_(k, val))
            if op.f == "write":
                if row is None:
                    cur.execute(
                        "insert into test (id, val) values (%s, %s)",
                        (k, v))
                else:
                    cur.execute("update test set val = %s where id = %s",
                                (v, k))
                return replace(op, type="ok")
            if op.f == "cas":
                frm, to = v
                if val != frm:
                    return replace(op, type="fail",
                                   error="value-mismatch")
                cur.execute("update test set val = %s where id = %s",
                            (to, k))
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")

        return self.txn(op, body)


class BankClient(TiDBClient):
    """bank.clj:17-90: read all balances / conditional transfer."""

    def __init__(self, node=None, n: int = 5, starting_balance: int = 10):
        super().__init__(node)
        self.n = n
        self.starting_balance = starting_balance

    def open(self, test, node):
        c = type(self)(node, self.n, self.starting_balance)
        c.conn = self._connect(node)
        return c

    def setup(self, test):
        self.once_ddl(test, [
            "create table if not exists accounts"
            " (id int not null primary key, balance bigint not null)"]
            + [f"insert ignore into accounts values ({i},"
               f" {self.starting_balance})" for i in range(self.n)])

    def invoke(self, test, op):
        from ..bank import sql_bank_body

        return self.txn(op, lambda cur: sql_bank_body(
            cur, op, self.n, lock_type=" for update",
            lock_reads=False))


class SetsClient(TiDBClient):
    """sets.clj: unique inserts + one final read."""

    def setup(self, test):
        self.once_ddl(test, [
            "create table if not exists sets"
            " (id int not null auto_increment primary key,"
            "  value bigint not null)"])

    def invoke(self, test, op):
        def body(cur):
            if op.f == "add":
                cur.execute("insert into sets (value) values (%s)",
                            (op.value,))
                return replace(op, type="ok")
            if op.f == "read":
                cur.execute("select value from sets")
                return replace(op, type="ok",
                               value=sorted(r[0] for r in cur.fetchall()))
            raise ValueError(f"unknown f {op.f!r}")

        return self.txn(op, body)


# ---------------------------------------------------------------------------
# nemeses (tidb/src/tidb/nemesis.clj:110-140)
# ---------------------------------------------------------------------------


def restarter(kill: bool = False) -> nemesis_mod.Nemesis:
    """startstop/startkill over the full pd+tikv+tidb stack."""

    def stop_fn(test, node):
        sess = control.session(node, test).su()
        if kill:
            for pat in ("tidb-server", "tikv-server", "pd-server"):
                cu.grepkill(sess, pat)
            return "killed"
        stop_all(sess)
        return "stopped"

    def start_fn(test, node):
        sess = control.session(node, test).su()
        start_pd(sess, test, node)
        start_kv(sess, test, node)
        start_db(sess, test, node)
        return "restarted"

    return nemesis_mod.node_start_stopper(
        lambda nodes: [random.choice(nodes)], stop_fn, start_fn)


NEMESES = {
    "none": lambda: (nemesis_mod.noop, gen.void),
    "parts": lambda: (nemesis_mod.partition_random_halves(),
                      gen.start_stop(5, 5)),
    "startstop": lambda: (restarter(kill=False), gen.start_stop(5, 5)),
    "startkill": lambda: (restarter(kill=True), gen.start_stop(5, 5)),
}


# ---------------------------------------------------------------------------
# workloads + tests (register.clj:54-79, bank.clj:92-120, basic.clj)
# ---------------------------------------------------------------------------


def register_workload(opts) -> dict:
    import itertools

    def r(t, p):
        return {"type": "invoke", "f": "read", "value": None}

    def w(t, p):
        return {"type": "invoke", "f": "write",
                "value": random.randint(0, 4)}

    def cas(t, p):
        return {"type": "invoke", "f": "cas",
                "value": (random.randint(0, 4), random.randint(0, 4))}

    return {
        "client": RegisterClient(),
        "model": cas_register(),
        "checker": checker_mod.compose({
            "indep": independent.checker(checker_mod.compose({
                "linear": lin.linearizable(cas_register()),
                "timeline": timeline.timeline(),
            })),
            "perf": perf_mod.perf(),
        }),
        "generator": independent.concurrent_generator(
            10, itertools.count(),
            lambda k: gen.limit(100, gen.stagger(
                0.1, gen.delay_til(0.5,
                                   gen.reserve(5, gen.mix([w, cas, cas]),
                                               r))))),
    }


def bank_workload(opts) -> dict:
    n = opts.get("accounts", 5)

    from ..bank import bank_read, bank_transfer

    read, transfer = bank_read, bank_transfer(n, min_amount=1,
                                              max_amount=5)
    return {
        "client": BankClient(n=n),
        "total_amount": n * 10,
        "checker": checker_mod.compose({
            "bank": basic.bank(),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.stagger(
            0.1, gen.mix([read, transfer, transfer])),
    }


def sets_workload(opts) -> dict:
    import itertools

    adds = gen.seq({"type": "invoke", "f": "add", "value": x}
                   for x in itertools.count())
    return {
        "client": SetsClient(),
        "checker": checker_mod.compose({
            "set": basic.set_checker(),
            "perf": perf_mod.perf(),
        }),
        "generator": adds,
        "final_generator": gen.clients(gen.once(
            {"type": "invoke", "f": "read", "value": None})),
    }


WORKLOADS = {
    "register": register_workload,
    "bank": bank_workload,
    "sets": sets_workload,
}


def tidb_test(opts: dict) -> dict:
    workload = WORKLOADS[opts.get("workload", "register")](opts)
    nemesis, nem_gen = NEMESES[opts.get("nemesis", "parts")]()
    tl = opts.get("time_limit", 60)
    final = workload.get("final_generator")
    main_phase = gen.time_limit(tl, gen.nemesis(
        nem_gen, workload["generator"]))
    t = fixtures.noop_test() | {
        "name": f"tidb {opts.get('workload', 'register')} "
                f"{opts.get('nemesis', 'parts')}",
        "os": debian.os,
        "db": db(opts.get("tarball", TARBALL)),
        "client": workload["client"],
        "model": workload.get("model"),
        "nemesis": nemesis,
        "checker": workload["checker"],
        "generator": (gen.phases(main_phase, final) if final
                      else main_phase),
    }
    if "total_amount" in workload:
        t["total_amount"] = workload["total_amount"]
    # CLI strings must not clobber the constructed objects they selected
    return t | {k: v for k, v in opts.items()
                if k not in ("nemesis", "workload")}


def add_opts(p):
    p.add_argument("--workload", default="register",
                   choices=sorted(WORKLOADS))
    p.add_argument("--nemesis", default="parts", choices=sorted(NEMESES))
    p.add_argument("--tarball", default=TARBALL)
    p.add_argument("--accounts", type=int, default=5)


def main(argv=None):
    cli.main(cli.single_test_cmd(tidb_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
