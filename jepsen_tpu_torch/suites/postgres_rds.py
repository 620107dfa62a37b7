"""Postgres-RDS suite — bank test against a managed (unautomated) DB.

Reference: postgres-rds/ (294 LoC,
postgres-rds/src/jepsen/postgres_rds.clj).  Unique shape: there is NO db
automation — the "cluster" is one externally-provisioned RDS endpoint,
``nodes`` holds just that hostname, and nemeses are no-ops (you can't
SSH into RDS; postgres_rds.clj:262-268 uses noop-test's db).  The value
of the suite is the client + checker: the bank workload over real
postgres transactions with SERIALIZABLE isolation, mapping serialization
failures (SQLSTATE 40001) to :fail and connection drops to
indeterminate :info (postgres_rds.clj:40-131,133-232).

SQL rides psycopg2 (gated), like the cockroach suite.
"""

from __future__ import annotations

import logging
import random
import threading
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod,
                fixtures, generator as gen, nemesis as nemesis_mod)
from ..checker import basic, perf as perf_mod
from .. import os as os_mod

log = logging.getLogger("jepsen")


class BankClient(client_mod.Client):
    """postgres_rds.clj:133-204: serializable transactions; 40001
    (serialization_failure) → :fail, dropped conns → :info."""

    ddl_lock = threading.Lock()

    def __init__(self, node=None, n: int = 5, starting_balance: int = 10,
                 user: str = "jepsen", password: str = "jepsen",
                 database: str = "jepsen"):
        self.node = node
        self.n = n
        self.starting_balance = starting_balance
        self.user = user
        self.password = password
        self.database = database
        self.conn = None

    def _connect(self, node):
        try:
            import psycopg2
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "postgres-rds clients need psycopg2 (postgres wire "
                "protocol)") from e
        conn = psycopg2.connect(
            host=str(node), port=5432, user=self.user,
            password=self.password, dbname=self.database,
            connect_timeout=10)
        conn.autocommit = False
        with conn.cursor() as cur:
            cur.execute("set default_transaction_isolation ="
                        " 'serializable'")
        conn.commit()
        return conn

    def open(self, test, node):
        c = type(self)(node, self.n, self.starting_balance, self.user,
                       self.password, self.database)
        c.conn = self._connect(node)
        return c

    def setup(self, test):
        with BankClient.ddl_lock:
            if test.setdefault("_pgrds_ddl_done", False):
                return
            test["_pgrds_ddl_done"] = True
            conn = self._connect(test["nodes"][0])
            try:
                with conn.cursor() as cur:
                    cur.execute(
                        "create table if not exists accounts"
                        " (id int not null primary key,"
                        "  balance bigint not null)")
                    for i in range(self.n):
                        cur.execute(
                            "insert into accounts values (%s, %s)"
                            " on conflict (id) do nothing",
                            (i, self.starting_balance))
                conn.commit()
            finally:
                conn.close()

    def invoke(self, test, op):
        import psycopg2

        try:
            with self.conn.cursor() as cur:
                out = self._body(cur, op)
            self.conn.commit()
            return out
        except psycopg2.Error as e:
            try:
                self.conn.rollback()
            except Exception:
                pass
            code = getattr(e, "pgcode", None)
            if code == "40001":  # serialization_failure: determinate
                return replace(op, type="fail",
                               error="serialization-failure")
            if isinstance(e, psycopg2.OperationalError):
                # connection-level: outcome unknown for writes
                self._reopen()
                return replace(op,
                               type="fail" if op.f == "read" else "info",
                               error=str(e).strip())
            return replace(op, type="fail", error=str(e).strip())

    def _reopen(self):
        try:
            self.conn.close()
        except Exception:
            pass
        try:
            self.conn = self._connect(self.node)
        except Exception:
            self.conn = None

    def _body(self, cur, op):
        from ..bank import sql_bank_body

        return sql_bank_body(cur, op, self.n)

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            except Exception:
                pass
            self.conn = None


from ..bank import bank_read, bank_transfer  # noqa: E402  (shared workload)


def bank_test(opts: dict) -> dict:
    """postgres_rds.clj:262-294: no db automation, no nemesis (managed
    service), pure client+checker."""
    n = opts.get("accounts", 5)
    tl = opts.get("time_limit", 60)
    return fixtures.noop_test() | {
        "name": "postgres-rds bank",
        "os": os_mod.noop,
        "client": BankClient(n=n,
                             user=opts.get("db_user", "jepsen"),
                             password=opts.get("db_password", "jepsen"),
                             database=opts.get("database", "jepsen")),
        "total_amount": n * 10,
        "nemesis": nemesis_mod.noop,
        "checker": checker_mod.compose({
            "bank": basic.bank(),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.phases(
            gen.time_limit(tl, gen.clients(gen.stagger(
                0.1, gen.mix([bank_read, bank_transfer(n),
                              bank_transfer(n)])))),
            gen.clients(gen.each(lambda: gen.once(
                {"type": "invoke", "f": "read", "value": None})))),
    } | dict(opts)


def add_opts(p):
    p.add_argument("--accounts", type=int, default=5)
    # --user/--password would collide with the shared SSH options
    p.add_argument("--db-user", default="jepsen")
    p.add_argument("--db-password", default="jepsen")
    p.add_argument("--database", default="jepsen")


def main(argv=None):
    cli.main(cli.single_test_cmd(bank_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
