"""Shared bank workload pieces (reference jepsen/src/jepsen/tests/bank.clj).

The reference hoists the bank generators into a reusable namespace
(bank.clj:36-66); the percona/postgres-rds/mysql-cluster/tidb suites all
re-plug the same read-all/conditional-transfer SQL body with tiny dialect
differences (lock clause, in-place vs read-modify-write).  This module is
that shared core: generators + the transaction body, parameterized by
cursor dialect, so an error-mapping fix lands once.
"""

from __future__ import annotations

import random
from dataclasses import replace


def bank_read(test, process):
    """bank.clj:36-39."""
    return {"type": "invoke", "f": "read", "value": None}


def bank_transfer(n: int, min_amount: int = 0, max_amount: int = 4):
    """Transfer between two *different* accounts (bank.clj:41-55's
    diff-transfer).  Default amount range matches bank.clj's
    (rand-int 5)."""

    def op(test, process):
        frm, to = random.sample(range(n), 2)
        return {"type": "invoke", "f": "transfer",
                "value": {"from": frm, "to": to,
                          "amount": random.randint(min_amount,
                                                   max_amount)}}

    return op


def sql_bank_body(cur, op, n: int, *, lock_type: str = "",
                  in_place: bool = False, lock_reads: bool = True):
    """One bank op against a DB-API cursor inside an open transaction
    (percona.clj:247-287 / postgres_rds.clj:163-204 / tidb bank.clj:33-90).

    read: every balance in one locked select.  transfer: read both
    balances (with the dialect's lock clause), refuse negatives
    (:fail — determinate), then write back either in place or by
    absolute value."""
    if op.f == "read":
        # percona locks its bank reads (percona.clj:247-250) but tidb
        # deliberately snapshot-reads (tidb bank.clj:36-38) — a locked
        # read would serialize against transfers and mask exactly the
        # fractured-total anomalies the checker hunts
        cur.execute("select id, balance from accounts"
                    + (lock_type if lock_reads else ""))
        rows = dict(cur.fetchall())
        return replace(op, type="ok",
                       value={i: rows.get(i) for i in range(n)})
    if op.f == "transfer":
        frm = op.value["from"]
        to = op.value["to"]
        amount = op.value["amount"]
        cur.execute("select balance from accounts where id = %s"
                    + lock_type, (frm,))
        b1 = cur.fetchone()[0] - amount
        cur.execute("select balance from accounts where id = %s"
                    + lock_type, (to,))
        b2 = cur.fetchone()[0] + amount
        if b1 < 0:
            return replace(op, type="fail", error=f"negative {frm} {b1}")
        if b2 < 0:
            return replace(op, type="fail", error=f"negative {to} {b2}")
        if in_place:
            cur.execute("update accounts set balance = balance - %s"
                        " where id = %s", (amount, frm))
            cur.execute("update accounts set balance = balance + %s"
                        " where id = %s", (amount, to))
        else:
            cur.execute("update accounts set balance = %s where id = %s",
                        (b1, frm))
            cur.execute("update accounts set balance = %s where id = %s",
                        (b2, to))
        return replace(op, type="ok")
    raise ValueError(f"unknown f {op.f!r}")
