"""RethinkDB suite — document store with per-table replication control.

Reference: rethinkdb/ (529 LoC).  Db automation adds the apt repo,
installs the pinned package, optionally wraps the binary in faketime,
writes /etc/rethinkdb/instances.d/jepsen.conf with join= lines for every
node, and starts the service (rethinkdb/src/jepsen/rethinkdb.clj:52-96).
The workload is document-cas: a register on a single document, run under
every combination of ``write_acks`` (majority/single) and ``read_mode``
(majority/single/outdated) (document_cas.clj:30-138).

The signature capability is the *reconfigure* nemesis pair
(rethinkdb.clj:196-330): plain `reconfigure-nemesis` randomly reassigns
the table's primary + replica set through the system tables;
`aggressive-reconfigure-nemesis` additionally computes a network grudge
aimed at separating old and new primaries, heals, reconfigures, and
re-partitions in one atomic nemesis op.  The grudge math is pure and
unit-tested host-side; driver calls are gated on the `rethinkdb` python
driver.
"""

from __future__ import annotations

import logging
import random
import threading
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                db as db_mod, faketime, fixtures, generator as gen,
                independent, nemesis as nemesis_mod, net as net_mod)
from ..checker import linearizable as lin, perf as perf_mod, timeline
from ..models import cas_register
from ..os import debian

log = logging.getLogger("jepsen")

LOG_FILE = "/var/log/rethinkdb"
CONF = "/etc/rethinkdb/instances.d/jepsen.conf"
DB = "jepsen"
TABLE = "cas"


# ---------------------------------------------------------------------------
# db automation (rethinkdb.clj:52-163)
# ---------------------------------------------------------------------------


def join_lines(test) -> str:
    """join=<node>:29015 for every node (rethinkdb.clj:67-73)."""
    return "\n".join(f"join={n}:29015" for n in test["nodes"])


def config(test, node) -> str:
    """rethinkdb.clj:75-87."""
    return "\n".join([
        "runuser=rethinkdb",
        "rungroup=rethinkdb",
        f"log-file={LOG_FILE}/jepsen.log",
        "bind=all",
        "",
        join_lines(test),
        "",
        f"server-name={node}",
        f"server-tag={node}",
        ""])


class RethinkDB(db_mod.DB, db_mod.LogFiles):
    """rethinkdb.clj:122-163."""

    def __init__(self, version: str, wrap_faketime: bool = False):
        self.version = version
        self.wrap_faketime = wrap_faketime

    def setup(self, test, node):
        sess = control.session(node, test)
        su = sess.su()
        debian.add_repo(
            sess, "rethinkdb",
            "deb http://download.rethinkdb.com/apt jessie main")
        su.exec("wget", "-qO", "-",
                "https://download.rethinkdb.com/apt/pubkey.gpg",
                control.lit("|"), "apt-key", "add", "-")
        debian.install(sess, {"rethinkdb": self.version})
        if self.wrap_faketime:
            faketime.wrap(su, "/usr/bin/rethinkdb",
                          init_offset=random.randint(0, 20),
                          rate=1.0 + random.random() / 10)
        su.exec("mkdir", "-p", LOG_FILE)
        su.exec("touch", f"{LOG_FILE}/jepsen.log")
        su.exec("chown", "-R", "rethinkdb:rethinkdb", LOG_FILE)
        su.exec("echo", config(test, node), control.lit(">"), CONF)
        su.exec("service", "rethinkdb", "start")

    def teardown(self, test, node):
        su = control.session(node, test).su()
        try:
            su.exec("service", "rethinkdb", "stop")
        except control.RemoteError:
            pass
        from .. import control_util as cu

        cu.grepkill(su, "rethinkdb")
        su.exec("rm", "-rf", control.lit("/var/lib/rethinkdb/*"),
                control.lit(f"{LOG_FILE}/*"))

    def log_files(self, test, node):
        return [f"{LOG_FILE}/jepsen.log"]


def db(version: str = "2.3.5~0jessie", **kw) -> RethinkDB:
    return RethinkDB(version, **kw)


# ---------------------------------------------------------------------------
# driver plumbing (gated)
# ---------------------------------------------------------------------------


def driver():
    try:
        from rethinkdb import r  # type: ignore

        return r
    except ImportError:
        try:
            import rethinkdb  # type: ignore

            return rethinkdb.r
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "rethinkdb workloads need the `rethinkdb` python driver "
                "on the control node") from e


def connect(node, timeout: float = 10.0):
    r = driver()
    return r.connect(host=str(node), port=28015, timeout=timeout)


def wait_table(conn, db_name: str, table: str) -> None:
    """rethinkdb.clj:117-120."""
    r = driver()
    r.db(db_name).table(table).wait().run(conn)


def set_write_acks(conn, test, write_acks: str) -> None:
    """Single shard spanning all nodes with the configured ack mode
    (document_cas.clj:30-40)."""
    from .. import core as core_mod

    r = driver()
    r.db("rethinkdb").table("table_config").update(
        {"write_acks": write_acks,
         "shards": [{"primary_replica": str(core_mod.primary(test)),
                     "replicas": [str(n) for n in test["nodes"]]}]}
    ).run(conn)


def set_heartbeat(conn, dt_s: int) -> None:
    """document_cas.clj:42-48."""
    r = driver()
    r.db("rethinkdb").table("cluster_config").get("heartbeat").update(
        {"heartbeat_timeout_secs": dt_s}).run(conn)


# ---------------------------------------------------------------------------
# document-cas client (document_cas.clj:52-110)
# ---------------------------------------------------------------------------


class DocumentCASClient(client_mod.Client):
    """Register on one document; independent-key lifted.  read_mode is
    applied per-read; CAS is a conditional branch update."""

    table_lock = threading.Lock()

    def __init__(self, write_acks: str = "majority",
                 read_mode: str = "majority", node=None):
        self.write_acks = write_acks
        self.read_mode = read_mode
        self.node = node
        self.conn = None

    def open(self, test, node):
        c = type(self)(self.write_acks, self.read_mode, node)
        c.conn = connect(node)
        return c

    def setup(self, test):
        r = driver()
        with DocumentCASClient.table_lock:
            # per-run guard (survives client reopens, resets per test)
            if not test.setdefault("_rethinkdb_table_made", False):
                test["_rethinkdb_table_made"] = True
                try:
                    r.db_create(DB).run(self.conn)
                except Exception:
                    pass
                r.db(DB).table_create(
                    TABLE, replicas=len(test["nodes"])).run(self.conn)
                set_write_acks(self.conn, test, self.write_acks)
                set_heartbeat(self.conn, 2)
                wait_table(self.conn, DB, TABLE)

    def _row(self, k):
        r = driver()
        return r.db(DB).table(TABLE, read_mode=self.read_mode).get(k)

    def invoke(self, test, op):
        r = driver()
        k, v = op.value
        try:
            if op.f == "read":
                val = self._row(k)["val"].default(None).run(self.conn)
                return replace(op, type="ok",
                               value=independent.tuple_(k, val))
            if op.f == "write":
                res = r.db(DB).table(TABLE).insert(
                    {"id": k, "val": v}, conflict="update").run(self.conn)
                ok = not res.get("errors")
                return replace(op, type="ok" if ok else "info",
                               error=None if ok else str(res))
            if op.f == "cas":
                frm, to = v
                res = self._row(k).update(
                    lambda row: r.branch(row["val"].eq(frm), {"val": to},
                                         r.error("abort"))
                ).run(self.conn)
                ok = (res.get("errors") == 0
                      and res.get("replaced") == 1)
                return replace(op, type="ok" if ok else "fail")
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            # driver/network errors: reads fail, writes indeterminate
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            except Exception:
                pass
            self.conn = None


# ---------------------------------------------------------------------------
# reconfigure nemeses (rethinkdb.clj:180-330)
# ---------------------------------------------------------------------------


def random_topology(nodes: list) -> tuple[str, list[str]]:
    """Random replica subset + primary among them
    (rethinkdb.clj:206-212)."""
    size = 1 + random.randrange(len(nodes))
    replicas = random.sample([str(n) for n in nodes], size)
    return random.choice(replicas), replicas


def reconfigure(conn, primary: str, replicas: list[str],
                db_name: str = DB, table: str = TABLE) -> dict:
    """One shard with the given primary tag (rethinkdb.clj:180-194)."""
    r = driver()
    res = r.db(db_name).table(table).reconfigure(
        shards=1,
        replicas={str(n): 1 for n in replicas},
        primary_replica_tag=str(primary)).run(conn)
    assert res.get("reconfigured") == 1, f"reconfigure failed: {res}"
    return res


def reconfigure_grudge(nodes: list, primary_new: str) -> dict:
    """Split the cluster so the new primary lands in a random half —
    half the time no grudge at all (rethinkdb.clj:234-249's
    "disregard that, pick randomly")."""
    if random.random() < 0.5:
        return {}
    shuffled = [str(n) for n in nodes]
    random.shuffle(shuffled)
    a, b = nemesis_mod.bisect(shuffled)
    return nemesis_mod.complete_grudge([a, b])


class ReconfigureNemesis(nemesis_mod.Nemesis):
    """:reconfigure ops randomly re-home the table
    (rethinkdb.clj:196-231)."""

    def invoke(self, test, op):
        assert op.f == "reconfigure"
        last_err = None
        for _ in range(10):
            primary, replicas = random_topology(list(test["nodes"]))
            try:
                conn = connect(primary)
                try:
                    reconfigure(conn, primary, replicas)
                finally:
                    conn.close()
                return replace(op, type="info",
                               value={"primary": primary,
                                      "replicas": replicas})
            except Exception as e:
                last_err = e
        return replace(op, type="info", value="timeout",
                       error=str(last_err))


class AggressiveReconfigureNemesis(nemesis_mod.Nemesis):
    """Heal → reconfigure → partition under a grudge chosen to divide
    old and new primaries (rethinkdb.clj:251-330)."""

    def __init__(self):
        self.state = {"grudge": {}}
        self._lock = threading.Lock()

    def invoke(self, test, op):
        assert op.f == "reconfigure"
        with self._lock:
            last_err = None
            for _ in range(10):
                primary, replicas = random_topology(list(test["nodes"]))
                grudge = reconfigure_grudge(list(test["nodes"]), primary)
                try:
                    conn = connect(primary)
                    try:
                        reconfigure(conn, primary, replicas)
                    finally:
                        conn.close()
                    test["net"].heal(test)
                    if grudge:
                        net_mod.drop_all(test, grudge)
                    self.state = {"primary": primary,
                                  "replicas": replicas, "grudge": grudge}
                    return replace(op, type="info", value=dict(self.state))
                except Exception as e:
                    last_err = e
                    try:
                        test["net"].heal(test)
                    except Exception:
                        pass
            return replace(op, type="info", value="timeout",
                           error=str(last_err))

    def teardown(self, test):
        try:
            test["net"].heal(test)
        except Exception:
            pass


def reconfigure_gen(test, process):
    return {"type": "info", "f": "reconfigure", "value": None}


# ---------------------------------------------------------------------------
# tests (document_cas.clj:113-138, rethinkdb.clj core/document-cas runner)
# ---------------------------------------------------------------------------


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def r_read(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randint(0, 4), random.randint(0, 4))}


NEMESES = {
    "partitions": lambda: (nemesis_mod.partition_random_halves(),
                           gen.start_stop(5, 5)),
    "reconfigure": lambda: (ReconfigureNemesis(),
                            gen.stagger(5, reconfigure_gen)),
    "aggressive-reconfigure": lambda: (AggressiveReconfigureNemesis(),
                                       gen.stagger(5, reconfigure_gen)),
}


def document_cas_test(opts: dict) -> dict:
    """cas register over a document, write_acks x read_mode matrix."""
    import itertools

    write_acks = opts.get("write_acks", "majority")
    read_mode = opts.get("read_mode", "majority")
    nem_name = opts.get("nemesis", "partitions")
    nemesis, nem_gen = NEMESES[nem_name]()
    tl = opts.get("time_limit", 120)
    return fixtures.noop_test() | {
        "name": f"rethinkdb document-cas w={write_acks} r={read_mode} "
                f"{nem_name}",
        "os": debian.os,
        "db": db(opts.get("version", "2.3.5~0jessie")),
        "client": DocumentCASClient(write_acks, read_mode),
        "model": cas_register(),
        "nemesis": nemesis,
        "checker": checker_mod.compose({
            "linear": independent.checker(checker_mod.compose({
                "linear": lin.linearizable(cas_register()),
                "timeline": timeline.timeline(),
            })),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.time_limit(tl, gen.nemesis(
            nem_gen,
            independent.concurrent_generator(
                10, itertools.count(),
                lambda k: gen.limit(
                    opts.get("ops_per_key", 100),
                    gen.stagger(0.1, gen.mix([w, cas, r_read])))))),
    } | {k: v for k, v in opts.items() if k != "nemesis"}


def add_opts(p):
    p.add_argument("--write-acks", default="majority",
                   choices=["majority", "single"])
    p.add_argument("--read-mode", default="majority",
                   choices=["majority", "single", "outdated"])
    p.add_argument("--nemesis", default="partitions",
                   choices=sorted(NEMESES))
    p.add_argument("--version", default="2.3.5~0jessie")


def main(argv=None):
    cli.main(cli.single_test_cmd(document_cas_test, add_opts=add_opts),
             argv)


if __name__ == "__main__":
    main()
