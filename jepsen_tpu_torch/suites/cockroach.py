"""CockroachDB suite — the registry-runner application.

Reference: cockroachdb/ (the largest suite, 2,495 LoC).  Workload registry
(runner.clj:25-34): bank, register (independent CAS), monotonic, sets,
sequential, g2; composable named nemeses with :during/:final generators
(nemesis.clj:63-151) including clock skews of graded severity driven by
an on-node bumptime binary (nemesis.clj:153-271 — ours rides
jepsen_tpu_torch.nemesis_time); db automation installs the official tarball and
runs `cockroach start` per node (auto.clj).

SQL clients are gated on psycopg2 (cockroach speaks the postgres wire
protocol); everything else — db automation, generators, checkers,
nemeses — is importable and unit-tested without it.
"""

from __future__ import annotations

import itertools
import logging
import random
import threading
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, generator as gen, independent,
                nemesis as nemesis_mod, nemesis_time)
from ..checker import basic, extra, linearizable as lin, timeline
from ..models import cas_register
from ..os import debian
from . import registry as registry_mod

log = logging.getLogger("jepsen")

DIR = "/opt/cockroach"
BINARY = f"{DIR}/cockroach"
PIDFILE = f"{DIR}/cockroach.pid"
LOGFILE = f"{DIR}/cockroach.log"
STORE = f"{DIR}/data"
TARBALL = ("https://binaries.cockroachdb.com/"
           "cockroach-v2.0.0.linux-amd64.tgz")


def start_node(test, node):
    """(Re)start the cockroach daemon on one node (auto.clj start!)."""
    sess = control.session(node, test).su()
    join = ",".join(str(n) for n in test["nodes"])
    cu.start_daemon(
        sess, BINARY, "start", "--insecure",
        f"--store={STORE}", f"--host={node}", f"--join={join}",
        "--cache=.25", "--max-sql-memory=.25",
        logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)
    return "started"


def kill_node(test, node):
    """kill -9 the daemon (auto.clj kill!)."""
    sess = control.session(node, test).su()
    cu.grepkill(sess, "cockroach", signal=9)
    sess.exec("rm", "-f", PIDFILE)
    return "killed"


class CockroachDB:
    """Tarball install + cockroach start with a join list (auto.clj)."""

    def __init__(self, tarball: str = TARBALL):
        self.tarball = tarball

    def setup(self, test, node):
        from .. import core as core_mod

        sess = control.session(node, test).su()
        cu.install_archive(sess, self.tarball, DIR)
        start_node(test, node)
        if node == core_mod.primary(test):
            import time

            time.sleep(5)
            # the SQL clients all connect to dbname=jepsen
            # (auto.clj creates it the same way, via `cockroach sql`)
            sess.exec(BINARY, "sql", "--insecure", f"--host={node}",
                      "-e", "CREATE DATABASE IF NOT EXISTS jepsen")

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        cu.stop_daemon(sess, PIDFILE, cmd="cockroach")
        sess.exec("rm", "-rf", STORE)

    def log_files(self, test, node):
        return [LOGFILE]


def db(tarball: str = TARBALL) -> CockroachDB:
    return CockroachDB(tarball)


def pg_driver():
    """The postgres wire driver: psycopg2 when a wheel exists, else the
    stdlib pg-wire shim (suites/pgwire.py) — same protocol, same DB-API
    subset, so the txn machinery below executes identically (and runs
    LIVE in tests/test_torch_suites_sql.py against the in-process pg-wire
    server)."""
    try:
        import psycopg2

        return psycopg2
    except ImportError:
        from . import pgwire

        return pgwire


class SQLClient(client_mod.Client):
    """Base: a postgres-wire connection to the local gateway node with
    reconnect + retry (cockroach client.clj semantics)."""

    #: test-map override for the SQL port (cockroach's default)
    PORT = 26257

    def __init__(self, node=None):
        self.node = node
        self.conn = None

    def open(self, test, node):
        c = type(self)(node)
        c.conn = pg_driver().connect(
            host=str(node), port=test.get("sql_port", self.PORT),
            user="root", dbname="jepsen", connect_timeout=5)
        c.conn.autocommit = False
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def txn(self, f):
        try:
            with self.conn:
                with self.conn.cursor() as cur:
                    return f(cur)
        except Exception:
            self.conn.rollback()
            raise


class RegisterClient(SQLClient):
    """Independent-key CAS registers in one table (register.clj)."""

    def setup(self, test):
        def f(cur):
            cur.execute("CREATE TABLE IF NOT EXISTS registers "
                        "(id INT PRIMARY KEY, value INT)")
        self.txn(f)

    def invoke(self, test, op):
        k, v = op.value.key, op.value.value
        try:
            if op.f == "read":
                def f(cur):
                    cur.execute("SELECT value FROM registers WHERE id=%s",
                                (k,))
                    row = cur.fetchone()
                    return row[0] if row else None
                return replace(op, type="ok",
                               value=independent.tuple_(k, self.txn(f)))
            if op.f == "write":
                def f(cur):
                    cur.execute("UPSERT INTO registers (id, value) "
                                "VALUES (%s, %s)", (k, v))
                self.txn(f)
                return replace(op, type="ok")
            if op.f == "cas":
                old, new = v

                def f(cur):
                    cur.execute("UPDATE registers SET value=%s "
                                "WHERE id=%s AND value=%s", (new, k, old))
                    return cur.rowcount == 1
                return replace(op, type="ok" if self.txn(f) else "fail")
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))


class BankClient(SQLClient):
    """Random transfers, total-preserving reads (bank.clj)."""

    def setup(self, test):
        accounts = test.get("accounts", list(range(8)))
        total = test.get("total_amount", 100)
        per = total // len(accounts)

        def f(cur):
            cur.execute("CREATE TABLE IF NOT EXISTS accounts "
                        "(id INT PRIMARY KEY, balance INT)")
            for a in accounts:
                cur.execute("UPSERT INTO accounts (id, balance) "
                            "VALUES (%s, %s)", (a, per))
        self.txn(f)

    def invoke(self, test, op):
        try:
            if op.f == "read":
                def f(cur):
                    cur.execute("SELECT id, balance FROM accounts")
                    return dict(cur.fetchall())
                return replace(op, type="ok", value=self.txn(f))
            if op.f == "transfer":
                v = op.value

                def f(cur):
                    cur.execute("SELECT balance FROM accounts WHERE id=%s",
                                (v["from"],))
                    b = cur.fetchone()[0]
                    if b < v["amount"]:
                        return False
                    cur.execute("UPDATE accounts SET balance=balance-%s "
                                "WHERE id=%s", (v["amount"], v["from"]))
                    cur.execute("UPDATE accounts SET balance=balance+%s "
                                "WHERE id=%s", (v["amount"], v["to"]))
                    return True
                return replace(op,
                               type="ok" if self.txn(f) else "fail")
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))


def bank_generator(test, process):
    """tests/bank.clj:20-38: transfers between distinct accounts + reads."""
    accounts = test.get("accounts", list(range(8)))
    if random.random() < 0.5:
        return {"type": "invoke", "f": "read", "value": None}
    a, b = random.sample(accounts, 2)
    return {"type": "invoke", "f": "transfer",
            "value": {"from": a, "to": b,
                      "amount": 1 + random.randrange(
                          test.get("max_transfer", 5))}}


def _naturals():
    k = 0
    while True:
        yield k
        k += 1


_KEYRANGE_LOCK = threading.Lock()


def update_keyrange(test, table, k):
    """Record a written primary key so the split nemesis can split just
    below it (cockroach.clj update-keyrange!)."""
    with _KEYRANGE_LOCK:
        test.setdefault("keyrange", {}).setdefault(table, set()).add(k)


class MonotonicClient(SQLClient):
    """Monotonic timestamp-ordered inserts over several tables
    (monotonic.clj:83-141): `add` reads the max val across the tables and
    the db's logical timestamp in one txn, then inserts
    {val: max+1, sts, node, proc, tb}; `read` returns every row ordered
    by sts.  The checker (checker/extra.py monotonic) then verifies
    global sts order, value order, and lost/dup accounting."""

    TABLE_COUNT = 2

    def _tables(self):
        return [f"mono{i}" for i in range(self.TABLE_COUNT)]

    def setup(self, test):
        def f(cur):
            for t in self._tables():
                cur.execute(
                    f"CREATE TABLE IF NOT EXISTS {t} (val INT, sts STRING,"
                    " node INT, process INT, tb INT)")
        self.txn(f)

    def invoke(self, test, op):
        from decimal import Decimal

        nodenum = list(test["nodes"]).index(self.node) \
            if self.node in list(test["nodes"]) else -1
        tables = self._tables()
        try:
            if op.f == "add":
                def f(cur):
                    cur_max = 0
                    for t in random.sample(tables, len(tables)):
                        cur.execute(f"SELECT max(val) FROM {t}")
                        m = cur.fetchone()[0]
                        cur_max = max(cur_max, m or 0)
                    cur.execute("SELECT cluster_logical_timestamp()"
                                "::string")
                    sts = cur.fetchone()[0]
                    tb = random.randrange(len(tables))
                    cur.execute(
                        f"INSERT INTO {tables[tb]} (val, sts, node, "
                        "process, tb) VALUES (%s, %s, %s, %s, %s)",
                        (cur_max + 1, sts, nodenum, op.process, tb))
                    return {"val": cur_max + 1, "sts": Decimal(sts),
                            "node": nodenum, "proc": op.process, "tb": tb}
                return replace(op, type="ok", value=self.txn(f))
            if op.f == "read":
                def f(cur):
                    rows = []
                    for tb, t in enumerate(tables):
                        cur.execute(f"SELECT val, sts, node, process, tb "
                                    f"FROM {t}")
                        for val, sts, node, proc, tb_ in cur.fetchall():
                            rows.append({"val": val, "sts": Decimal(sts),
                                         "node": node, "proc": proc,
                                         "tb": tb_})
                    rows.sort(key=lambda r: r["sts"])
                    return rows
                return replace(op, type="ok", value=self.txn(f))
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))


class SequentialClient(SQLClient):
    """Sequential-consistency workload (sequential.clj:53-105): a write
    inserts subkeys k_0..k_{kc-1} in order, each in its OWN transaction
    (client order); a read queries them in reverse.  Keys hash onto
    `TABLE_COUNT` tables so they land in different shard ranges."""

    TABLE_COUNT = 5

    def _table_for(self, subkey: str) -> str:
        import zlib

        return f"seq_{zlib.crc32(str(subkey).encode()) % self.TABLE_COUNT}"

    @staticmethod
    def _subkeys(key_count: int, k) -> list:
        return [f"{k}_{i}" for i in range(key_count)]

    def setup(self, test):
        def f(cur):
            for i in range(self.TABLE_COUNT):
                cur.execute(f"CREATE TABLE IF NOT EXISTS seq_{i} "
                            "(key STRING PRIMARY KEY)")
        self.txn(f)

    def invoke(self, test, op):
        key_count = test.get("key_count", 5)
        try:
            if op.f == "write":
                for sk in self._subkeys(key_count, op.value):
                    table = self._table_for(sk)

                    def f(cur, sk=sk, table=table):
                        cur.execute(f"INSERT INTO {table} (key) "
                                    "VALUES (%s)", (sk,))
                    self.txn(f)
                    update_keyrange(test, table, sk)
                return replace(op, type="ok")
            if op.f == "read":
                reads = []
                for sk in reversed(self._subkeys(key_count, op.value)):
                    def f(cur, sk=sk):
                        cur.execute(
                            f"SELECT key FROM {self._table_for(sk)} "
                            "WHERE key = %s", (sk,))
                        row = cur.fetchone()
                        return row[0] if row else None
                    reads.append(self.txn(f))
                return replace(op, type="ok", value=[op.value, reads])
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))


class G2Client(SQLClient):
    """Adya G2 anti-dependency-cycle txns (adya.clj:24-80 in the
    cockroach suite; semantics documented in jepsen/src/jepsen/adya.clj):
    in one txn, select rows with value%3=0 under the key from both
    tables (random order); if either query sees a row, fail; else insert
    {id, key, value:30} into table a or b per the op's [a_id, b_id]."""

    def setup(self, test):
        def f(cur):
            for t in ("a", "b"):
                cur.execute(f"CREATE TABLE IF NOT EXISTS {t} "
                            "(id INT PRIMARY KEY, key INT, value INT)")
        self.txn(f)

    def invoke(self, test, op):
        k = op.value.key if hasattr(op.value, "key") else op.value[0]
        ids = op.value.value if hasattr(op.value, "value") else op.value[1]
        a_id, b_id = ids
        try:
            if op.f != "insert":
                raise ValueError(f"unknown f {op.f!r}")

            def f(cur):
                first, second = ("a", "b") if random.random() < 0.5 \
                    else ("b", "a")
                for t in (first, second):
                    cur.execute(f"SELECT id FROM {t} WHERE key = %s "
                                "AND value %% 3 = 0", (k,))
                    if cur.fetchone() is not None:
                        return False
                table, row_id = ("a", a_id) if a_id is not None \
                    else ("b", b_id)
                cur.execute(
                    f"INSERT INTO {table} (id, key, value) "
                    "VALUES (%s, %s, 30)", (row_id, k))
                update_keyrange(test, table, row_id)
                return True
            ok = self.txn(f)
            return replace(op, type="ok" if ok else "fail")
        except Exception as e:
            return replace(op, type="info", error=str(e))


REGISTRY = registry_mod.Registry()


@REGISTRY.workload("register")
def register_workload(opts):
    def r(t, p):
        return {"type": "invoke", "f": "read", "value": None}

    def w(t, p):
        return {"type": "invoke", "f": "write",
                "value": random.randrange(5)}

    def cas(t, p):
        return {"type": "invoke", "f": "cas",
                "value": (random.randrange(5), random.randrange(5))}

    return {
        "client": RegisterClient(),
        "model": cas_register(),
        "checker": independent.checker(checker_mod.compose({
            "linear": lin.linearizable(cas_register()),
            "timeline": timeline.timeline(),
        })),
        "generator": independent.concurrent_generator(
            min(4, opts.get("concurrency", 4)), _naturals(),
            lambda k: gen.limit(opts.get("ops_per_key", 100),
                                gen.mix([r, w, cas]))),
    }


@REGISTRY.workload("bank")
def bank_workload(opts):
    return {
        "client": BankClient(),
        "checker": basic.bank(),
        "generator": bank_generator,
    }


@REGISTRY.workload("monotonic")
def monotonic_workload(opts):
    def add(test, process):
        return {"type": "invoke", "f": "add", "value": None}

    return {
        "client": MonotonicClient(),
        "checker": extra.monotonic(
            global_order=opts.get("linearizable", False)),
        "generator": gen.stagger(0.1, add),
        "final_generator": gen.once({"type": "invoke", "f": "read",
                                     "value": None}),
    }


@REGISTRY.workload("sequential")
def sequential_workload(opts):
    # writes emit sequential keys into a 2n ring buffer; reads pick a
    # recently-written key (sequential.clj:107-135)
    n = max(1, opts.get("concurrency", 4) // 2)
    import collections

    last_written = collections.deque([None] * (2 * n), maxlen=2 * n)
    counter = itertools.count()
    lock = threading.Lock()

    def writes(test, process):
        with lock:
            k = next(counter)
            last_written.append(k)
        return {"type": "invoke", "f": "write", "value": k}

    def reads(test, process):
        with lock:
            k = random.choice(list(last_written))
        return {"type": "invoke", "f": "read", "value": k}

    return {
        "client": SequentialClient(),
        "checker": extra.sequential(),
        "generator": gen.reserve(
            n, gen.stagger(0.05, writes),
            gen.filter(lambda op: op["value"] is not None,
                       gen.stagger(0.05, reads))),
    }


@REGISTRY.workload("g2")
def g2_workload(opts):
    # one [a_id nil] + one [nil b_id] insert per key, globally unique
    # ids (jepsen/src/jepsen/adya.clj g2-gen)
    ids = {"n": 0}
    lock = threading.Lock()

    def fgen(k):
        def a(t, p):
            with lock:
                ids["n"] += 1
                return {"type": "invoke", "f": "insert",
                        "value": (None, ids["n"])}

        def b(t, p):
            with lock:
                ids["n"] += 1
                return {"type": "invoke", "f": "insert",
                        "value": (ids["n"], None)}
        return gen.seq([a, b])

    return {
        "client": G2Client(),
        "checker": basic.g2(),
        "generator": independent.concurrent_generator(
            2, _naturals(), fgen),
    }


# ---------------------------------------------------------------------------
# Nemesis menu (cockroach nemesis.clj:110-317)
# ---------------------------------------------------------------------------


def _reset_gen(test, process):
    return {"type": "info", "f": "reset", "value": list(test["nodes"])}


REGISTRY.nemesis(registry_mod.NamedNemesis(
    "skews", nemesis_time.clock_nemesis(),
    during=gen.seq(itertools.cycle(
        [gen.sleep(5), nemesis_time.bump_gen, gen.sleep(5), _reset_gen])),
    final=gen.once(_reset_gen)))
REGISTRY.nemesis(registry_mod.NamedNemesis(
    "strobe-skews", nemesis_time.clock_nemesis(),
    during=gen.seq(itertools.cycle(
        [gen.sleep(5), nemesis_time.strobe_gen])),
    final=gen.once(_reset_gen)))


class BumpTimeNemesis(nemesis_mod.Nemesis):
    """Graded clock skew (nemesis.clj:232-255): on :start each node
    independently bumps its clock by dt seconds with p=0.5; on :stop,
    clocks reset and the db restarts (the `restarting` wrapper,
    nemesis.clj:178-199 — clock jumps can crash cockroach).  When
    slow_dt is set, the network slows by slow_dt seconds around the skew
    (the `slowing` wrapper, nemesis.clj:153-176)."""

    def __init__(self, dt: float, slow_dt: float | None = None):
        self.dt = dt
        self.slow_dt = slow_dt

    def setup(self, test):
        control.on_nodes(
            test, lambda t, n: nemesis_time.install(control.session(n, t)))
        control.on_nodes(
            test,
            lambda t, n: nemesis_time.reset_time(control.session(n, t)))
        return self

    def invoke(self, test, op):
        from dataclasses import replace as rep

        if op.f == "start":
            if self.slow_dt is not None:
                test["net"].slow(test, mean_ms=int(self.slow_dt * 1000),
                                 variance_ms=1)

            def bump(t, n):
                if random.random() < 0.5:
                    nemesis_time.bump_time(control.session(n, t),
                                           int(self.dt * 1000))
                    return self.dt
                return 0
            return rep(op, type="info",
                       value=control.on_nodes(test, bump))
        if op.f == "stop":
            def heal(t, n):
                nemesis_time.reset_time(control.session(n, t))
                return start_node(t, n)
            value = control.on_nodes(test, heal)
            if self.slow_dt is not None:
                test["net"].fast(test)
            return rep(op, type="info", value=value)
        raise ValueError(f"bump-time: unknown f {op.f!r}")

    def teardown(self, test):
        control.on_nodes(
            test,
            lambda t, n: nemesis_time.reset_time(control.session(n, t)))
        if self.slow_dt is not None:
            test["net"].fast(test)


def _skew(name: str, dt: float, slow_dt: float | None = None):
    REGISTRY.nemesis(registry_mod.start_stop_nemesis(
        name, BumpTimeNemesis(dt, slow_dt)))


# graded severities (nemesis.clj:258-271): small < subcritical <
# critical < big < huge; big/huge also slow the network so the skew
# outruns message delivery
_skew("small-skews", 0.100)
_skew("subcritical-skews", 0.200)
_skew("critical-skews", 0.250)
_skew("big-skews", 0.5, slow_dt=0.5)
_skew("huge-skews", 5.0, slow_dt=5.0)


def _take_n(n):
    return lambda nodes: random.sample(list(nodes), min(n, len(nodes)))


for _n in (1, 2):
    _sfx = "" if _n == 1 else str(_n)
    REGISTRY.nemesis(registry_mod.start_stop_nemesis(
        f"startstop{_sfx}",
        nemesis_mod.hammer_time("cockroach", targeter=_take_n(_n))))
    REGISTRY.nemesis(registry_mod.start_stop_nemesis(
        f"startkill{_sfx}",
        nemesis_mod.node_start_stopper(_take_n(_n), kill_node,
                                       start_node)))
# "parts" ships in the stock menu already; "majring" is the reference's
# name for the stock "majority-ring" entry (nemesis.clj:146-151)
REGISTRY.nemeses["majring"] = REGISTRY.nemeses["majority-ring"]


class SplitNemesis(nemesis_mod.Nemesis):
    """Range-split nemesis (nemesis.clj:274-311): each :split op picks a
    recently-written key from test["keyrange"] (maintained by the SQL
    clients via update_keyrange) and runs ALTER TABLE .. SPLIT AT just
    below it, once per key."""

    def __init__(self):
        self._split: dict = {}

    def invoke(self, test, op):
        from dataclasses import replace as rep

        if op.f != "split":
            raise ValueError(f"split nemesis: unknown f {op.f!r}")
        with _KEYRANGE_LOCK:
            keyrange = {t: set(ks)
                        for t, ks in test.get("keyrange", {}).items()}
        candidates = [(t, k) for t, ks in keyrange.items()
                      for k in ks - self._split.get(t, set())]
        if not candidates:
            return rep(op, type="info", value="nothing-to-split")
        table, k = random.choice(candidates)
        node = random.choice(list(test["nodes"]))
        try:
            import psycopg2

            conn = psycopg2.connect(host=str(node), port=26257,
                                    user="root", dbname="jepsen",
                                    connect_timeout=5)
            try:
                conn.autocommit = True
                with conn.cursor() as cur:
                    cur.execute(
                        f"ALTER TABLE {table} SPLIT AT VALUES (%s)", (k,))
            finally:
                conn.close()
            self._split.setdefault(table, set()).add(k)
            return rep(op, type="info", value=["split", table, k])
        except Exception as e:
            if "already split" in str(e):
                self._split.setdefault(table, set()).add(k)
                return rep(op, type="info",
                           value=["already-split", table, k])
            return rep(op, type="info", value=["split-failed", str(e)])


REGISTRY.nemesis(registry_mod.NamedNemesis(
    "split", SplitNemesis(),
    during=gen.delay(2, {"type": "info", "f": "split", "value": None}),
    final=None))


def base_test(opts: dict) -> dict:
    from .. import fixtures

    return fixtures.noop_test() | {
        "os": debian.os,
        "db": db(opts.get("tarball", TARBALL)),
        "accounts": list(range(8)),
        "total_amount": 100,
        "max_transfer": 5,
    }


REGISTRY.base_test = base_test


def main(argv=None):
    REGISTRY.main(argv)


if __name__ == "__main__":
    main()
