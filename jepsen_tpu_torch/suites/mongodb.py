"""MongoDB suite (replica sets on SmartOS).

Reference: mongodb-smartos/ (824 LoC).  Db automation installs mongod
via pkgin, writes a replSet config, manages the service with svcadm,
and drives replica-set formation — ``rs.initiate`` on the test primary,
then every node polls ``rs.status`` until all members have joined and a
mongo PRIMARY is elected, phase-locked with cluster barriers
(mongodb_smartos/core.clj:123-301).  Formation runs through the mongo
shell over SSH (core.clj:88-92's ``mongo --quiet --eval printjson(..)``)
so it is fully testable against DummyRemote.

Workloads (write-concern matrix, document_cas.clj:100-140):

  * doc-cas  — CAS against a single document, one test per write
    concern (majority / journaled / acknowledged / unacknowledged),
    optionally excluding reads (mongo had no linearizable reads);
    checked linearizable against the cas-register model.
  * transfer — two-phase-commit bank transfers (transfer.clj), checked
    with the bank checker.

The op client is gated on pymongo; db automation and generators are
importable without it.
"""

from __future__ import annotations

import json
import logging
import random
import time
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures,
                generator as gen, nemesis as nemesis_mod, net as net_mod)
from ..checker import basic, linearizable as lin, perf as perf_mod, timeline
from ..models import cas_register
from ..os import smartos

log = logging.getLogger("jepsen")

DATA_DIR = "/var/lib/mongodb"
CONF = "/opt/local/etc/mongod.conf"
LOGS = ["/var/log/mongodb/mongod.log"]

WRITE_CONCERNS = ["majority", "journaled", "acknowledged",
                  "unacknowledged"]


def mongo_eval(sess, cmd: str):
    """Run a mongo-shell expression, JSON back (core.clj:88-92)."""
    out = sess.exec("mongo", "--quiet", "--eval",
                    f"printjson({cmd})")
    text = out if isinstance(out, str) else getattr(out, "out", "")
    try:
        return json.loads(text)
    except (json.JSONDecodeError, TypeError):
        return text


def target_replica_set_config(test) -> dict:
    """{_id jepsen, members [{_id i, host n:27017}...]}
    (core.clj:249-257)."""
    return {"_id": "jepsen",
            "members": [{"_id": i, "host": f"{n}:27017"}
                        for i, n in enumerate(test["nodes"])]}


def replica_set_status(sess) -> dict:
    return mongo_eval(sess, "rs.status()")


def _member_nodes(status: dict) -> set:
    return {m["name"].split(":")[0]
            for m in (status or {}).get("members", [])}


def _has_primary(status: dict) -> bool:
    return any(m.get("stateStr") == "PRIMARY"
               for m in (status or {}).get("members", []))


def await_join(test, sess, timeout_s: float = 100) -> None:
    """Poll rs.status until every node is a member (core.clj:235-247)."""
    deadline = time.time() + timeout_s
    while _member_nodes(replica_set_status(sess)) != \
            {str(n) for n in test["nodes"]}:
        if time.time() > deadline:
            raise TimeoutError("replica set never converged")
        time.sleep(1)


def await_primary(sess, timeout_s: float = 100) -> None:
    """Poll until some member is PRIMARY (core.clj:229-233)."""
    deadline = time.time() + timeout_s
    while not _has_primary(replica_set_status(sess)):
        if time.time() > deadline:
            raise TimeoutError("no mongo primary elected")
        time.sleep(1)


class MongoDB(db_mod.DB, db_mod.LogFiles):
    """core.clj:40-86 + join! (core.clj:259-295)."""

    def __init__(self, version: str = "3.0.4"):
        self.version = version

    def setup(self, test, node):
        from .. import core as core_mod

        sess = control.session(node, test)
        su = sess.su()
        smartos.install(su, {"mongodb": self.version})
        su.exec("mkdir", "-p", DATA_DIR)
        su.exec("chown", "-R", "mongodb:mongodb", DATA_DIR)
        conf = "\n".join([
            "systemLog:",
            "  destination: file",
            f"  path: {LOGS[0]}",
            "storage:",
            f"  dbPath: {DATA_DIR}",
            "replication:",
            "  replSetName: jepsen",
            ""])
        su.exec("echo", conf, control.lit(">"), CONF)
        try:
            su.exec("svcadm", "clear", "mongodb")
        except control.RemoteError:
            pass  # nothing in maintenance state (core.clj:60 `meh`)
        su.exec("svcadm", "enable", "-r", "mongodb")
        self.join(test, node)

    def join(self, test, node):
        """Replica-set formation, phase-locked (core.clj:259-295)."""
        from .. import core as core_mod

        sess = control.session(node, test)
        core_mod.synchronize(test)  # all mongods up first
        if node == core_mod.primary(test):
            log.info("%s initiating replica set", node)
            cfg = json.dumps(target_replica_set_config(test))
            mongo_eval(sess, f"rs.initiate({cfg})")
            await_join(test, sess)
            await_primary(sess)
            log.info("%s replica set primary ready", node)
        core_mod.synchronize(test)  # others wait for initiate
        await_join(test, sess)
        await_primary(sess)
        core_mod.synchronize(test)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        try:
            sess.exec("svcadm", "disable", "mongodb")
        except control.RemoteError:
            pass
        cu.grepkill(sess, "mongod")
        sess.exec("rm", "-rf", control.lit(f"{DATA_DIR}/*"))
        sess.exec("rm", "-rf", control.lit("/var/log/mongodb/*"))

    def log_files(self, test, node):
        return LOGS


def db(version: str = "3.0.4") -> MongoDB:
    return MongoDB(version)


# ---------------------------------------------------------------------------
# clients (pymongo-gated)
# ---------------------------------------------------------------------------


def _pymongo():
    try:
        import pymongo
        return pymongo
    except ImportError as e:
        raise RuntimeError(
            "mongodb clients need pymongo; "
            "pip install pymongo on the control node") from e


def _write_concern(pymongo, name: str):
    """The write-concern matrix (document_cas.clj:100-140)."""
    from pymongo import WriteConcern

    return {
        "majority": WriteConcern(w="majority"),
        "journaled": WriteConcern(w=1, j=True),
        "acknowledged": WriteConcern(w=1),
        "unacknowledged": WriteConcern(w=0),
    }[name]


class DocumentCASClient(client_mod.Client):
    """CAS against one document (document_cas.clj:40-96): read via
    primary read-preference; write = update-by-id; cas = conditional
    update, ok iff exactly one doc modified.  Reads are idempotent, so
    their errors are :fail; write/cas errors are indeterminate :info
    unless the server rejected them outright (with-errors,
    core.clj:333-357)."""

    def __init__(self, write_concern: str = "majority", node=None):
        self.write_concern = write_concern
        self.node = node
        self.conn = None
        self.coll = None

    def open(self, test, node):
        pymongo = _pymongo()
        c = type(self)(self.write_concern, node)
        hosts = ",".join(str(n) for n in test["nodes"])
        c.conn = pymongo.MongoClient(
            f"mongodb://{hosts}/?replicaSet=jepsen",
            serverSelectionTimeoutMS=20000, connectTimeoutMS=5000,
            socketTimeoutMS=10000)
        c.coll = c.conn["jepsen"].get_collection(
            "jepsen",
            write_concern=_write_concern(pymongo, self.write_concern),
            read_preference=pymongo.ReadPreference.PRIMARY)
        return c

    def setup(self, test):
        self.coll.update_one({"_id": 0}, {"$set": {"value": None}},
                             upsert=True)

    def invoke(self, test, op):
        try:
            if op.f == "read":
                doc = self.coll.find_one({"_id": 0})
                return replace(op, type="ok",
                               value=doc.get("value") if doc else None)
            if op.f == "write":
                r = self.coll.update_one({"_id": 0},
                                         {"$set": {"value": op.value}})
                assert r.acknowledged is False or r.matched_count == 1
                return replace(op, type="ok")
            if op.f == "cas":
                old, new = op.value
                r = self.coll.update_one({"_id": 0, "value": old},
                                         {"$set": {"value": new}})
                if not r.acknowledged:
                    return replace(op, type="info", error="unacknowledged")
                return replace(op, type="ok" if r.modified_count == 1
                               else "fail")
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            idempotent = op.f == "read"
            kind = type(e).__name__
            if kind in ("ServerSelectionTimeoutError", "NotPrimaryError"):
                return replace(op, type="fail", error=str(e))
            return replace(op, type="fail" if idempotent else "info",
                           error=str(e))

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


class TransferClient(client_mod.Client):
    """Bank transfers via the two-phase-commit recipe (transfer.clj):
    read = sum snapshot of account docs; transfer = pending-txn doc,
    debit/credit, commit."""

    def __init__(self, write_concern: str = "majority", node=None):
        self.write_concern = write_concern
        self.node = node
        self.conn = None
        self.db = None

    def open(self, test, node):
        pymongo = _pymongo()
        c = type(self)(self.write_concern, node)
        hosts = ",".join(str(n) for n in test["nodes"])
        c.conn = pymongo.MongoClient(
            f"mongodb://{hosts}/?replicaSet=jepsen",
            serverSelectionTimeoutMS=20000)
        c.db = c.conn["jepsen"]
        return c

    def setup(self, test):
        accounts = test.get("accounts", list(range(8)))
        per = test.get("total_amount", 100) // len(accounts)
        for a in accounts:
            self.db["accounts"].update_one(
                {"_id": a}, {"$setOnInsert": {"balance": per}},
                upsert=True)

    def invoke(self, test, op):
        try:
            if op.f == "read":
                docs = {d["_id"]: d["balance"]
                        for d in self.db["accounts"].find()}
                return replace(op, type="ok", value=docs)
            if op.f == "transfer":
                v = op.value
                txn = {"state": "pending", "from": v["from"],
                       "to": v["to"], "amount": v["amount"]}
                tid = self.db["txns"].insert_one(txn).inserted_id
                r = self.db["accounts"].update_one(
                    {"_id": v["from"],
                     "balance": {"$gte": v["amount"]}},
                    {"$inc": {"balance": -v["amount"]}})
                if r.modified_count != 1:
                    self.db["txns"].delete_one({"_id": tid})
                    return replace(op, type="fail", error="insufficient")
                self.db["accounts"].update_one(
                    {"_id": v["to"]}, {"$inc": {"balance": v["amount"]}})
                self.db["txns"].update_one(
                    {"_id": tid}, {"$set": {"state": "committed"}})
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


# ---------------------------------------------------------------------------
# generators + tests
# ---------------------------------------------------------------------------


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def std_gen(opts: dict, client_gen) -> gen.Generator:
    """Failover schedule: 60s nemesis cadence, recover, 30s of normal
    ops (core.clj:359-377)."""
    return gen.phases(
        gen.time_limit(
            opts.get("time_limit", 600),
            gen.nemesis(
                gen.seq(_cycle_stop_start()),
                gen.delay(1, client_gen))),
        gen.nemesis(gen.once({"type": "info", "f": "stop"})),
        gen.clients(gen.time_limit(30, gen.delay(1, client_gen))))


def _cycle_stop_start():
    import itertools

    return itertools.cycle([gen.sleep(60),
                            {"type": "info", "f": "stop"},
                            {"type": "info", "f": "start"}])


def doc_cas_test(opts: dict) -> dict:
    wc = opts.get("write_concern", "majority")
    mix = [w, cas, cas] if opts.get("no_reads") else [r, w, cas, cas]
    return base_test(opts) | {
        "name": f"mongodb doc-cas {wc}"
                + (" no-read" if opts.get("no_reads") else ""),
        "client": DocumentCASClient(wc),
        "model": cas_register(),
        "checker": checker_mod.compose({
            "linear": lin.linearizable(cas_register()),
            "timeline": timeline.timeline(),
            "perf": perf_mod.perf(),
        }),
        "generator": std_gen(opts, gen.mix(mix)),
    }


def transfer_test(opts: dict) -> dict:
    from .cockroach import bank_generator

    return base_test(opts) | {
        "name": "mongodb transfer",
        "client": TransferClient(opts.get("write_concern", "majority")),
        "checker": checker_mod.compose({
            "bank": basic.bank(),
            "perf": perf_mod.perf(),
        }),
        "generator": std_gen(opts, bank_generator),
        "accounts": list(range(8)),
        "total_amount": 100,
        "max_transfer": 5,
    }


WORKLOADS = {"doc-cas": doc_cas_test, "transfer": transfer_test}


def base_test(opts: dict) -> dict:
    return fixtures.noop_test() | {
        "os": smartos.os,
        "net": net_mod.ipfilter,
        "db": db(opts.get("version", "3.0.4")),
        "nemesis": nemesis_mod.partition_random_halves(),
    } | dict(opts)


def add_opts(p):
    p.add_argument("--workload", default="doc-cas",
                   choices=sorted(WORKLOADS))
    p.add_argument("--write-concern", dest="write_concern",
                   default="majority", choices=WRITE_CONCERNS)
    p.add_argument("--no-reads", dest="no_reads", action="store_true",
                   help="exclude reads (mongo lacks linearizable reads)")
    p.add_argument("--version", default="3.0.4")


def mongo_test(opts: dict) -> dict:
    return WORKLOADS[opts.get("workload", "doc-cas")](opts)


def main(argv=None):
    cli.main(cli.single_test_cmd(mongo_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
