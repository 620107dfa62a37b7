"""Dgraph suite — distributed graph database on Raft groups.

Reference: dgraph/ (1,060 LoC).  Db automation installs one tarball and
runs two daemons per node: `dgraph zero` (cluster coordinator; primary
first, others --peer to it) and `dgraph server` (alpha, the data plane)
(dgraph/src/jepsen/dgraph/support.clj:51-112,157-205).  Workloads, each
probing a different anomaly class:

  * bank — transfers across uid-addressed accounts
    (dgraph/src/jepsen/dgraph/bank.clj)
  * upsert — concurrent index-read-then-insert; at most ONE upsert may
    ever succeed per key (upsert.clj:46-60's checker)
  * delete — create + delete an indexed record; index reads must never
    surface deleted records (delete.clj)
  * set — unique inserts read back via index (set.clj)
  * sequential — per-process monotonic reads of a counter that only
    grows (sequential.clj:1-50's argument); checked with the cockroach
    monotonic checker

Clients speak the alpha HTTP API (/alter, /query, /mutate, /commit)
with stdlib urllib — the reference uses the java grpc client
(dgraph/src/jepsen/dgraph/client.clj); the HTTP API exposes the same
transactions (start_ts + commit with touched keys).
"""

from __future__ import annotations

import json
import logging
import random
import threading
import urllib.error
import urllib.request
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures, generator as gen,
                independent, nemesis as nemesis_mod)
from ..checker import basic, extra, perf as perf_mod, timeline
from ..os import debian

log = logging.getLogger("jepsen")

DIR = "/opt/dgraph"
BINARY = "dgraph"
ZERO_LOG = f"{DIR}/zero.log"
ALPHA_LOG = f"{DIR}/alpha.log"
ZERO_PID = f"{DIR}/zero.pid"
ALPHA_PID = f"{DIR}/alpha.pid"
ZERO_INTERNAL = 5080
ALPHA_INTERNAL = 7080
ALPHA_PUBLIC = 8080
TARBALL = ("https://github.com/dgraph-io/dgraph/releases/download/"
           "v1.0.2/dgraph-linux-amd64.tar.gz")


def node_idx(test, node) -> int:
    """1-based (support.clj:44-49)."""
    return list(test["nodes"]).index(node) + 1


def start_zero(sess, test, node) -> None:
    """support.clj:51-65."""
    from .. import core as core_mod

    args = ["zero",
            "--idx", str(node_idx(test, node)),
            "--port_offset", "0",
            "--replicas", str(test.get("replicas", 3)),
            "--my", f"{node}:{ZERO_INTERNAL}"]
    if node != core_mod.primary(test):
        args += ["--peer",
                 f"{core_mod.primary(test)}:{ZERO_INTERNAL}"]
    cu.start_daemon(sess, BINARY, *args,
                    logfile=ZERO_LOG, pidfile=ZERO_PID, chdir=DIR)


def start_alpha(sess, test, node) -> None:
    """support.clj:67-80."""
    cu.start_daemon(sess, BINARY, "server",
                    "--memory_mb", "1024",
                    "--idx", str(node_idx(test, node)),
                    "--my", f"{node}:{ALPHA_INTERNAL}",
                    "--zero", f"{node}:{ZERO_INTERNAL}",
                    logfile=ALPHA_LOG, pidfile=ALPHA_PID, chdir=DIR)


class DgraphDB(db_mod.DB, db_mod.LogFiles):
    """support.clj:157-205: zero on primary first, then everyone."""

    def __init__(self, tarball: str = TARBALL):
        self.tarball = tarball

    def setup(self, test, node):
        import time

        from .. import core as core_mod

        sess = control.session(node, test).su()
        cu.install_archive(sess, self.tarball, DIR)
        primary = core_mod.primary(test)
        if node == primary:
            start_zero(sess, test, node)
        core_mod.synchronize(test)
        if node != primary:
            start_zero(sess, test, node)
        core_mod.synchronize(test)
        time.sleep(5)
        start_alpha(sess, test, node)
        core_mod.synchronize(test)
        time.sleep(10)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        for pid in (ALPHA_PID, ZERO_PID):
            try:
                cu.stop_daemon(sess, pid, cmd=BINARY)
            except control.RemoteError:
                pass
        sess.exec("rm", "-rf", control.lit(f"{DIR}/p"),
                  control.lit(f"{DIR}/w"), control.lit(f"{DIR}/zw"))

    def log_files(self, test, node):
        return [ZERO_LOG, ALPHA_LOG]


def db(tarball: str = TARBALL) -> DgraphDB:
    return DgraphDB(tarball)


# ---------------------------------------------------------------------------
# HTTP transaction client (client.clj over the grpc API; same txn shape)
# ---------------------------------------------------------------------------


class TxnConflict(Exception):
    pass


class DgraphHTTP:
    """Thin alpha HTTP wrapper: alter/query/mutate/commit."""

    def __init__(self, node, timeout: float = 10.0):
        self.node = str(node)
        self.timeout = timeout

    def _req(self, path: str, body: bytes, ctype: str) -> dict:
        req = urllib.request.Request(
            f"http://{self.node}:{ALPHA_PUBLIC}{path}", data=body,
            method="POST", headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            out = json.loads(r.read() or b"{}")
        errs = out.get("errors")
        if errs:
            msg = json.dumps(errs)
            if "conflict" in msg.lower() or "aborted" in msg.lower():
                raise TxnConflict(msg)
            raise RuntimeError(msg)
        return out

    def alter(self, schema: str) -> dict:
        return self._req("/alter", schema.encode(), "application/rdf")

    def query(self, q: str, start_ts: int | None = None) -> dict:
        path = "/query" + (f"?startTs={start_ts}" if start_ts else "")
        return self._req(path, q.encode(), "application/graphql+-")

    def mutate(self, mu: dict, start_ts: int | None = None,
               commit_now: bool = False) -> dict:
        qs = []
        if start_ts:
            qs.append(f"startTs={start_ts}")
        if commit_now:
            qs.append("commitNow=true")
        path = "/mutate" + ("?" + "&".join(qs) if qs else "")
        return self._req(path, json.dumps(mu).encode(),
                         "application/json")

    def commit(self, start_ts: int, keys: list, preds: list) -> dict:
        return self._req(f"/commit?startTs={start_ts}",
                         json.dumps({"keys": keys,
                                     "preds": preds}).encode(),
                         "application/json")


class DgraphClient(client_mod.Client):
    """Shared error mapping (client.clj's with-conflict-as-fail):
    conflicts/aborts are determinate :fail; network errors :info for
    writes."""

    schema_lock = threading.Lock()
    schema = ""

    def __init__(self, node=None):
        self.node = node
        self.http = None

    def open(self, test, node):
        c = type(self)(node)
        c.http = DgraphHTTP(node)
        return c

    def setup(self, test):
        with DgraphClient.schema_lock:
            key = f"_dgraph_schema_{type(self).__name__}"
            if test.setdefault(key, False):
                return
            test[key] = True
            if self.schema:
                self.http.alter(self.schema)

    def guard(self, op, body):
        try:
            return body()
        except TxnConflict as e:
            return replace(op, type="fail", error=f"conflict: {e}"[:120])
        except (urllib.error.URLError, OSError, RuntimeError) as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e)[:200])


class UpsertClient(DgraphClient):
    """upsert.clj:12-44: read the index inside a txn; insert only if
    empty; commit must observe the read keys so racing upserts
    conflict."""

    schema = "email: string @index(exact) ."

    def invoke(self, test, op):
        def body():
            if op.f == "upsert":
                q = ('{ q(func: eq(email, "bob@example.com"))'
                     " { uid } }")
                res = self.http.query(q)
                start_ts = res.get("extensions", {}).get(
                    "txn", {}).get("start_ts")
                uids = [r["uid"] for r in res.get("data", {})
                        .get("q", [])]
                if uids:
                    return replace(op, type="fail", error="exists")
                mu = {"set": [{"email": "bob@example.com"}]}
                out = self.http.mutate(mu, start_ts=start_ts)
                txn = out.get("extensions", {}).get("txn", {})
                self.http.commit(txn.get("start_ts", start_ts),
                                 txn.get("keys", []),
                                 txn.get("preds", []))
                new = list(out.get("data", {}).get("uids", {}).values())
                return replace(op, type="ok",
                               value=new[0] if new else None)
            if op.f == "read":
                q = ('{ q(func: eq(email, "bob@example.com"))'
                     " { uid } }")
                res = self.http.query(q)
                uids = sorted(r["uid"] for r in res.get("data", {})
                              .get("q", []))
                return replace(op, type="ok", value=uids)
            raise ValueError(f"unknown f {op.f!r}")

        return self.guard(op, body)


class UpsertChecker(checker_mod.Checker):
    """At most one uid ever visible; at most one upsert succeeds
    (upsert.clj:46-60)."""

    name = "upsert"

    def check(self, test, history, opts=None):
        reads = [op for op in history
                 if op.type == "ok" and op.f == "read"]
        oks = [op for op in history
               if op.type == "ok" and op.f == "upsert"]
        bad_reads = [op.to_dict() for op in reads
                     if op.value and len(op.value) > 1]
        return {"valid": not bad_reads and len(oks) <= 1,
                "ok_upserts": len(oks),
                "bad_reads": bad_reads}


def upsert_checker() -> UpsertChecker:
    return UpsertChecker()


class SetClient(DgraphClient):
    """set.clj: unique int inserts under an index, read-all."""

    schema = "value: int @index(int) ."

    def invoke(self, test, op):
        def body():
            if op.f == "add":
                self.http.mutate({"set": [{"value": op.value}]},
                                 commit_now=True)
                return replace(op, type="ok")
            if op.f == "read":
                res = self.http.query(
                    "{ q(func: has(value)) { value } }")
                vals = sorted(r["value"] for r in
                              res.get("data", {}).get("q", []))
                return replace(op, type="ok", value=vals)
            raise ValueError(f"unknown f {op.f!r}")

        return self.guard(op, body)


class SequentialClient(DgraphClient):
    """sequential.clj: read / increment-write a counter; per-process
    reads must be monotonic."""

    schema = "ctr_key: int @index(int) .\ncount: int ."

    def invoke(self, test, op):
        def body():
            k, _ = op.value
            q = ("{ q(func: eq(ctr_key, %d)) { uid count } }" % k)
            if op.f == "read":
                res = self.http.query(q)
                rows = res.get("data", {}).get("q", [])
                val = rows[0]["count"] if rows else 0
                return replace(op, type="ok",
                               value=independent.tuple_(k, val))
            if op.f == "inc":
                res = self.http.query(q)
                start_ts = res.get("extensions", {}).get(
                    "txn", {}).get("start_ts")
                rows = res.get("data", {}).get("q", [])
                if rows:
                    mu = {"set": [{"uid": rows[0]["uid"],
                                   "count": rows[0]["count"] + 1}]}
                    new = rows[0]["count"] + 1
                else:
                    mu = {"set": [{"ctr_key": k, "count": 1}]}
                    new = 1
                out = self.http.mutate(mu, start_ts=start_ts)
                txn = out.get("extensions", {}).get("txn", {})
                self.http.commit(txn.get("start_ts", start_ts),
                                 txn.get("keys", []),
                                 txn.get("preds", []))
                return replace(op, type="ok",
                               value=independent.tuple_(k, new))
            raise ValueError(f"unknown f {op.f!r}")

        return self.guard(op, body)


class DeleteClient(DgraphClient):
    """delete.clj: upsert/delete one indexed record per key; index reads
    must return at most one live record, never a deleted husk."""

    schema = "key: int @index(int) ."

    def invoke(self, test, op):
        def body():
            k, _ = op.value
            q = "{ q(func: eq(key, %d)) { uid key } }" % k
            if op.f == "read":
                res = self.http.query(q)
                rows = res.get("data", {}).get("q", [])
                vals = [r.get("key") for r in rows]
                return replace(op, type="ok",
                               value=independent.tuple_(k, vals))
            if op.f == "upsert":
                self.http.mutate({"set": [{"key": k}]}, commit_now=True)
                return replace(op, type="ok")
            if op.f == "delete":
                res = self.http.query(q)
                rows = res.get("data", {}).get("q", [])
                if not rows:
                    return replace(op, type="fail", error="not-found")
                self.http.mutate(
                    {"delete": [{"uid": rows[0]["uid"]}]},
                    commit_now=True)
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")

        return self.guard(op, body)


class DeleteChecker(checker_mod.Checker):
    """Reads must never see >1 record for a key, and every seen record
    must carry the right key (delete.clj's checker intent)."""

    name = "delete"

    def check(self, test, history, opts=None):
        bad = []
        for op in history:
            if op.type != "ok" or op.f != "read":
                continue
            vals = op.value
            if vals is None:
                continue
            if len(vals) > 1 or any(v is None for v in vals):
                bad.append(op.to_dict())
        return {"valid": not bad, "bad_reads": bad}


def delete_checker() -> DeleteChecker:
    return DeleteChecker()


class BankClient(DgraphClient):
    """bank.clj: uid-addressed accounts; read-all / conditional
    transfer inside one transaction."""

    schema = "acct_key: int @index(int) .\namount: int ."

    def __init__(self, node=None, n: int = 5, starting_balance: int = 10):
        super().__init__(node)
        self.n = n
        self.starting_balance = starting_balance

    def open(self, test, node):
        c = type(self)(node, self.n, self.starting_balance)
        c.http = DgraphHTTP(node)
        return c

    def setup(self, test):
        super().setup(test)
        with DgraphClient.schema_lock:
            if test.setdefault("_dgraph_bank_seed", False):
                return
            test["_dgraph_bank_seed"] = True
            self.http.mutate(
                {"set": [{"acct_key": i, "amount": self.starting_balance}
                         for i in range(self.n)]}, commit_now=True)

    def _accounts(self, start_ts=None):
        res = self.http.query(
            "{ q(func: has(acct_key)) { uid acct_key amount } }",
            start_ts=start_ts)
        txn = res.get("extensions", {}).get("txn", {})
        return res.get("data", {}).get("q", []), txn.get("start_ts")

    def invoke(self, test, op):
        def body():
            if op.f == "read":
                rows, _ = self._accounts()
                return replace(op, type="ok",
                               value={r["acct_key"]: r["amount"]
                                      for r in rows})
            if op.f == "transfer":
                frm = op.value["from"]
                to = op.value["to"]
                amount = op.value["amount"]
                rows, start_ts = self._accounts()
                by_key = {r["acct_key"]: r for r in rows}
                if frm not in by_key or to not in by_key:
                    return replace(op, type="fail", error="missing-acct")
                b1 = by_key[frm]["amount"] - amount
                b2 = by_key[to]["amount"] + amount
                if b1 < 0 or b2 < 0:
                    return replace(op, type="fail", error="negative")
                mu = {"set": [
                    {"uid": by_key[frm]["uid"], "amount": b1},
                    {"uid": by_key[to]["uid"], "amount": b2}]}
                out = self.http.mutate(mu, start_ts=start_ts)
                txn = out.get("extensions", {}).get("txn", {})
                self.http.commit(txn.get("start_ts", start_ts),
                                 txn.get("keys", []),
                                 txn.get("preds", []))
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")

        return self.guard(op, body)


# ---------------------------------------------------------------------------
# workloads + tests (dgraph/src/jepsen/dgraph/core.clj's workload map)
# ---------------------------------------------------------------------------


def _count_keys():
    import itertools

    return itertools.count()


def upsert_workload(opts) -> dict:
    def u(t, p):
        return {"type": "invoke", "f": "upsert", "value": None}

    def r(t, p):
        return {"type": "invoke", "f": "read", "value": None}

    return {
        "client": UpsertClient(),
        "checker": upsert_checker(),
        "generator": gen.limit(100, gen.stagger(0.1, gen.mix([u, r]))),
    }


def set_workload(opts) -> dict:
    adds = gen.seq({"type": "invoke", "f": "add", "value": x}
                   for x in _count_keys())
    return {
        "client": SetClient(),
        "checker": basic.set_checker(),
        "generator": gen.stagger(0.1, adds),
        "final_generator": gen.clients(gen.once(
            {"type": "invoke", "f": "read", "value": None})),
    }


def sequential_workload(opts) -> dict:
    def r(t, p):
        return {"type": "invoke", "f": "read", "value": None}

    def inc(t, p):
        return {"type": "invoke", "f": "inc", "value": None}

    return {
        "client": SequentialClient(),
        "checker": independent.checker(
            extra.monotonic(global_order=False)),
        "generator": independent.concurrent_generator(
            5, _count_keys(),
            lambda k: gen.limit(50, gen.stagger(0.1,
                                                gen.mix([r, inc])))),
    }


def delete_workload(opts) -> dict:
    def r(t, p):
        return {"type": "invoke", "f": "read", "value": None}

    def u(t, p):
        return {"type": "invoke", "f": "upsert", "value": None}

    def d(t, p):
        return {"type": "invoke", "f": "delete", "value": None}

    return {
        "client": DeleteClient(),
        "checker": independent.checker(delete_checker()),
        "generator": independent.concurrent_generator(
            5, _count_keys(),
            lambda k: gen.limit(100, gen.mix([r, u, d]))),
    }


def bank_workload(opts) -> dict:
    n = opts.get("accounts", 5)

    def read(t, p):
        return {"type": "invoke", "f": "read", "value": None}

    def transfer(t, p):
        frm, to = random.sample(range(n), 2)
        return {"type": "invoke", "f": "transfer",
                "value": {"from": frm, "to": to,
                          "amount": 1 + random.randrange(4)}}

    return {
        "client": BankClient(n=n),
        "total_amount": n * 10,
        "checker": basic.bank(),
        "generator": gen.stagger(0.1, gen.mix([read, transfer,
                                               transfer])),
    }


WORKLOADS = {
    "bank": bank_workload,
    "upsert": upsert_workload,
    "set": set_workload,
    "sequential": sequential_workload,
    "delete": delete_workload,
}


def dgraph_test(opts: dict) -> dict:
    workload = WORKLOADS[opts.get("workload", "upsert")](opts)
    tl = opts.get("time_limit", 60)
    final = workload.get("final_generator")
    main_phase = gen.time_limit(tl, gen.nemesis(
        gen.start_stop(5, 5), workload["generator"]))
    t = fixtures.noop_test() | {
        "name": f"dgraph {opts.get('workload', 'upsert')}",
        "os": debian.os,
        "db": db(opts.get("tarball", TARBALL)),
        "client": workload["client"],
        "nemesis": nemesis_mod.partition_random_halves(),
        "checker": checker_mod.compose({
            "workload": workload["checker"],
            "perf": perf_mod.perf(),
        }),
        "generator": (gen.phases(main_phase,
                                 gen.nemesis(gen.once(
                                     {"type": "info", "f": "stop"})),
                                 final)
                      if final else main_phase),
    }
    if "total_amount" in workload:
        t["total_amount"] = workload["total_amount"]
    return t | dict(opts)


def add_opts(p):
    p.add_argument("--workload", default="upsert",
                   choices=sorted(WORKLOADS))
    p.add_argument("--tarball", default=TARBALL)
    p.add_argument("--accounts", type=int, default=5)
    p.add_argument("--replicas", type=int, default=3)


def main(argv=None):
    cli.main(cli.single_test_cmd(dgraph_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
