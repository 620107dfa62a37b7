"""CrateDB suite — distributed SQL over an elasticsearch-derived core.

Reference: crate/ (1,044 LoC).  Db automation installs openjdk8 + the
crate tarball, templates crate.yml (unicast hosts, minimum master nodes
= majority), raises vm.max_map_count, and daemonizes bin/crate
(crate/src/jepsen/crate/core.clj:278-343).  Three workloads, each a
distinct *capability*:

  * version-divergence — writes unique ints to a row while partitioning;
    every read carries the row's ``_version``; the checker demands each
    version maps to ONE value (version_divergence.clj:92-105).  Divergent
    versions are the Crate/ES split-brain signature.
  * lost-updates — optimistic concurrency via
    ``update ... where _version = ?``; a CAS-maintained set of added
    elements, checked with the set checker (lost_updates.clj:33-127).
  * dirty-read — the dirty-read checker family shared with galera and
    elasticsearch (crate/src/jepsen/crate/dirty_read.clj).

Clients speak CrateDB's HTTP ``/_sql`` endpoint with stdlib urllib (the
reference uses the crate JDBC shim over the pg protocol,
core.clj:156-231); no driver package needed.
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
from ..checker import basic, dirty, perf as perf_mod, timeline
from ..os import debian
from ..util import majority

log = logging.getLogger("jepsen")

BASE_DIR = "/opt/crate"
PIDFILE = "/tmp/crate.pid"
STDOUT_LOG = f"{BASE_DIR}/logs/stdout.log"
USER = "crate"
TARBALL = ("https://cdn.crate.io/downloads/releases/"
           "crate-2.1.6.tar.gz")
HTTP_PORT = 4200
TRANSPORT_PORT = 44300


# ---------------------------------------------------------------------------
# db automation (core.clj:278-343)
# ---------------------------------------------------------------------------


def config_yml(test, node) -> str:
    """crate.yml analog (core.clj:294-318's template)."""
    nodes = list(test["nodes"])
    unicast = ", ".join(f'"{n}:{TRANSPORT_PORT}"' for n in nodes)
    return "\n".join([
        "cluster.name: jepsen",
        f"node.name: {node}",
        "network.host: _site_",
        f"http.port: {HTTP_PORT}",
        f"transport.tcp.port: {TRANSPORT_PORT}",
        f"discovery.zen.ping.unicast.hosts: [{unicast}]",
        f"discovery.zen.minimum_master_nodes: {majority(len(nodes))}",
        f"gateway.recover_after_nodes: {len(nodes)}",
        f"gateway.expected_nodes: {len(nodes)}",
        ""])


class CrateDB(db_mod.DB, db_mod.LogFiles):
    """core.clj:336-377."""

    def __init__(self, tarball: str = TARBALL):
        self.tarball = tarball

    def setup(self, test, node):
        sess = control.session(node, test)
        su = sess.su()
        debian.install(sess, ["apt-transport-https"])
        debian.install_jdk8(sess)
        cu.ensure_user(su, USER)
        cu.install_archive(su, self.tarball, BASE_DIR)
        su.exec("chown", "-R", f"{USER}:{USER}", BASE_DIR)
        su.exec("echo", config_yml(test, node), control.lit(">"),
                f"{BASE_DIR}/config/crate.yml")
        su.exec("sysctl", "-w", "vm.max_map_count=262144")
        crate_sess = sess.su(USER)
        crate_sess.exec("mkdir", "-p", f"{BASE_DIR}/logs")
        cu.start_daemon(crate_sess.cd(BASE_DIR), "bin/crate",
                        logfile=STDOUT_LOG, pidfile=PIDFILE,
                        chdir=BASE_DIR)
        self.wait_green(node)

    def wait_green(self, node, timeout_s: float = 90):
        """core.clj:244-264 polls until the cluster reports healthy."""
        import time

        deadline = time.time() + timeout_s
        while time.time() < deadline:
            try:
                sql(node, "select 1", timeout=5)
                return
            except Exception:
                time.sleep(1)
        raise TimeoutError(f"crate on {node} never became healthy")

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        cu.grepkill(sess, "crate")
        sess.exec("rm", "-rf", control.lit(f"{BASE_DIR}/data"),
                  control.lit(f"{BASE_DIR}/logs"))

    def log_files(self, test, node):
        return [STDOUT_LOG, f"{BASE_DIR}/logs/jepsen.log"]


def db(tarball: str = TARBALL) -> CrateDB:
    return CrateDB(tarball)


# ---------------------------------------------------------------------------
# HTTP /_sql client plumbing
# ---------------------------------------------------------------------------


class SQLError(Exception):
    def __init__(self, message: str, code: int | None = None):
        super().__init__(message)
        self.code = code


def sql(node, stmt: str, args: list | None = None, *,
        timeout: float = 10.0) -> dict:
    """POST /_sql — returns {'cols': [...], 'rows': [...], ...}."""
    body = {"stmt": stmt}
    if args is not None:
        body["args"] = args
    req = urllib.request.Request(
        f"http://{node}:{HTTP_PORT}/_sql",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            detail = json.loads(e.read() or b"{}")
            err = detail.get("error", {})
            raise SQLError(str(err.get("message", e)),
                           err.get("code")) from e
        except SQLError:
            raise
        except Exception:
            raise SQLError(str(e), e.code) from e


class CrateClient(client_mod.Client):
    """Shared error mapping (version_divergence.clj:72-86): no-master →
    :fail, rejected-execution → :info with a backoff, network → :info
    for writes / :fail for reads."""

    table_lock = threading.Lock()

    def __init__(self, node=None):
        self.node = node

    def open(self, test, node):
        return type(self)(node)

    def setup_table(self, test, ddl: list[str]) -> None:
        # per-run guard in the test map: a --test-count rerun against a
        # freshly wiped cluster must re-create its tables
        with CrateClient.table_lock:
            done = test.setdefault("_crate_ddl_done", set())
            if type(self).__name__ in done:
                return
            done.add(type(self).__name__)
            for stmt in ddl:
                sql(self.node, stmt)

    def mapped(self, op, e: Exception):
        msg = str(e)
        if "no master" in msg:
            return replace(op, type="fail", error="no-master")
        if "rejected execution" in msg:
            import time

            time.sleep(1)
            return replace(op, type="info", error="rejected-execution")
        if isinstance(e, (OSError, urllib.error.URLError)):
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=msg)
        raise e


# ---------------------------------------------------------------------------
# version divergence (version_divergence.clj)
# ---------------------------------------------------------------------------


class VersionDivergenceClient(CrateClient):
    """Reads return (value, _version) pairs; writes upsert unique ints
    (version_divergence.clj:51-70)."""

    def setup(self, test):
        self.setup_table(test, [
            "drop table if exists registers",
            "create table if not exists registers ("
            " id integer primary key, value integer)",
            'alter table registers set (number_of_replicas = "0-all")'])

    def invoke(self, test, op):
        k, v = op.value
        try:
            if op.f == "read":
                res = sql(self.node,
                          'select value, "_version" from registers'
                          " where id = ?", [k])
                row = (res.get("rows") or [[None, None]])[0]
                return replace(op, type="ok", value=independent.tuple_(
                    k, {"value": row[0], "_version": row[1]}))
            if op.f == "write":
                sql(self.node,
                    "insert into registers (id, value) values (?, ?)"
                    " on duplicate key update value = VALUES(value)",
                    [k, v])
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        except SQLError as e:
            return self.mapped(op, e)
        except (OSError, urllib.error.URLError) as e:
            return self.mapped(op, e)


class MultiVersionChecker(checker_mod.Checker):
    """Every observed ``_version`` of the row must carry a single value
    (version_divergence.clj:92-105) — two values under one version is
    split-brain divergence."""

    name = "multiversion"

    def check(self, test, history, opts=None):
        by_version: dict = {}
        for op in history:
            if op.type != "ok" or op.f != "read":
                continue
            v = op.value
            if v is None or not isinstance(v, dict):
                continue
            ver = v.get("_version")
            if ver is None:
                continue
            by_version.setdefault(ver, set()).add(v.get("value"))
        multis = {ver: sorted(vals, key=repr)
                  for ver, vals in by_version.items() if len(vals) > 1}
        return {"valid": not multis, "multis": multis}


def multiversion_checker() -> MultiVersionChecker:
    return MultiVersionChecker()


def version_divergence_test(opts: dict) -> dict:
    """version_divergence.clj:112-137."""
    import itertools

    def reads(t, p):
        return {"type": "invoke", "f": "read", "value": None}

    def writes():
        return gen.seq({"type": "invoke", "f": "write", "value": x}
                       for x in itertools.count())

    tl = opts.get("time_limit", 360)
    return fixtures.noop_test() | {
        "name": "crate version-divergence",
        "os": debian.os,
        "db": db(opts.get("tarball", TARBALL)),
        "client": VersionDivergenceClient(),
        "concurrency": opts.get("concurrency", 100),
        "nemesis": nemesis_mod.partition_random_halves(),
        "checker": checker_mod.compose({
            "multi": independent.checker(multiversion_checker()),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.time_limit(tl, gen.nemesis(
            gen.seq(itertools.cycle(
                [gen.sleep(120), {"type": "info", "f": "start"},
                 gen.sleep(120), {"type": "info", "f": "stop"}])),
            independent.concurrent_generator(
                10, itertools.count(),
                lambda k: gen.reserve(5, reads, writes())))),
    } | dict(opts)


# ---------------------------------------------------------------------------
# lost updates (lost_updates.clj)
# ---------------------------------------------------------------------------


class LostUpdatesClient(CrateClient):
    """Optimistic add to a JSON-encoded set guarded by _version
    (lost_updates.clj:52-93): 0 rows updated → :fail, 1 → :ok."""

    def setup(self, test):
        self.setup_table(test, [
            "drop table if exists sets",
            "create table if not exists sets ("
            " id integer primary key, elements string)",
            'alter table sets set (number_of_replicas = "0-all")'])

    def invoke(self, test, op):
        k, v = op.value
        try:
            if op.f == "read":
                res = sql(self.node,
                          "select elements from sets where id = ?", [k])
                rows = res.get("rows") or []
                els = set(json.loads(rows[0][0])) if rows else set()
                return replace(op, type="ok",
                               value=independent.tuple_(k, sorted(els)))
            if op.f == "add":
                res = sql(self.node,
                          'select elements, "_version" from sets'
                          " where id = ?", [k])
                rows = res.get("rows") or []
                if rows:
                    els, ver = rows[0]
                    els2 = json.dumps(sorted(set(json.loads(els)) | {v}))
                    upd = sql(self.node,
                              "update sets set elements = ?"
                              ' where id = ? and "_version" = ?',
                              [els2, k, ver])
                    n = upd.get("rowcount", 0)
                    if n == 0:
                        return replace(op, type="fail",
                                       error="version-conflict")
                    if n == 1:
                        return replace(op, type="ok")
                    return replace(op, type="info",
                                   error=f"updated {n} rows!?")
                sql(self.node,
                    "insert into sets (id, elements) values (?, ?)",
                    [k, json.dumps([v])])
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        except SQLError as e:
            return self.mapped(op, e)
        except (OSError, urllib.error.URLError) as e:
            return self.mapped(op, e)


def lost_updates_test(opts: dict) -> dict:
    """lost_updates.clj:100-140: nemesis stops 20s before the end so the
    final reads run on a healed cluster."""
    import itertools

    def reads(t, p):
        return {"type": "invoke", "f": "read", "value": None}

    def adds():
        return gen.seq({"type": "invoke", "f": "add", "value": x}
                       for x in itertools.count())

    tl = opts.get("time_limit", 380)
    quiesce = 20
    return fixtures.noop_test() | {
        "name": "crate lost-updates",
        "os": debian.os,
        "db": db(opts.get("tarball", TARBALL)),
        "client": LostUpdatesClient(),
        "concurrency": opts.get("concurrency", 100),
        "nemesis": nemesis_mod.partition_random_halves(),
        "checker": checker_mod.compose({
            "set": independent.checker(basic.set_checker()),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.phases(
            gen.time_limit(tl - quiesce, gen.nemesis(
                gen.seq(itertools.cycle(
                    [gen.sleep(60), {"type": "info", "f": "start"},
                     gen.sleep(60), {"type": "info", "f": "stop"}])),
                independent.concurrent_generator(
                    10, itertools.count(),
                    lambda k: gen.reserve(5, reads, adds())))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.log("Quiescing"),
            gen.sleep(quiesce),
            gen.clients(gen.each(lambda: gen.once(
                {"type": "invoke", "f": "read", "value": None})))),
    } | dict(opts)


# ---------------------------------------------------------------------------
# dirty reads (crate/src/jepsen/crate/dirty_read.clj)
# ---------------------------------------------------------------------------


class DirtyReadClient(CrateClient):
    """Single-row reads racing writes; any read of a value that was
    never acknowledged is dirty (dirty_read.clj)."""

    def setup(self, test):
        self.setup_table(test, [
            "drop table if exists dirty",
            "create table if not exists dirty ("
            " id integer primary key, value integer)",
            'alter table dirty set (number_of_replicas = "0-all")'])

    def invoke(self, test, op):
        try:
            if op.f == "read":
                res = sql(self.node,
                          "select value from dirty where id = 0")
                rows = res.get("rows") or []
                return replace(op, type="ok",
                               value=rows[0][0] if rows else None)
            if op.f == "write":
                sql(self.node,
                    "insert into dirty (id, value) values (0, ?)"
                    " on duplicate key update value = VALUES(value)",
                    [op.value])
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        except SQLError as e:
            return self.mapped(op, e)
        except (OSError, urllib.error.URLError) as e:
            return self.mapped(op, e)


def dirty_read_test(opts: dict) -> dict:
    import itertools

    def reads(t, p):
        return {"type": "invoke", "f": "read", "value": None}

    def writes():
        return gen.seq({"type": "invoke", "f": "write", "value": x}
                       for x in itertools.count())

    tl = opts.get("time_limit", 120)
    return fixtures.noop_test() | {
        "name": "crate dirty-read",
        "os": debian.os,
        "db": db(opts.get("tarball", TARBALL)),
        "client": DirtyReadClient(),
        "nemesis": nemesis_mod.partition_random_halves(),
        "checker": checker_mod.compose({
            "dirty": dirty.dirty_reads(),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.time_limit(tl, gen.nemesis(
            gen.seq(itertools.cycle(
                [gen.sleep(30), {"type": "info", "f": "start"},
                 gen.sleep(30), {"type": "info", "f": "stop"}])),
            gen.reserve(2, reads, writes()))),
    } | dict(opts)


TESTS = {
    "version-divergence": version_divergence_test,
    "lost-updates": lost_updates_test,
    "dirty-read": dirty_read_test,
}


def crate_test(opts: dict) -> dict:
    return TESTS[opts.get("workload", "version-divergence")](opts)


def add_opts(p):
    p.add_argument("--workload", default="version-divergence",
                   choices=sorted(TESTS))
    p.add_argument("--tarball", default=TARBALL)


def main(argv=None):
    cli.main(cli.single_test_cmd(crate_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
