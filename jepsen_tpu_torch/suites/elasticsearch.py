"""Elasticsearch suite.

Reference: elasticsearch/ (929 LoC).  Db automation installs a tarball,
writes a unicast-host cluster config with minimum_master_nodes=majority,
and runs bin/elasticsearch as a daemon
(elasticsearch/src/jepsen/elasticsearch/core.clj:212-290); workloads:

  * dirty-read — writers index unique ids while readers chase the most
    recent in-flight id per node; after quiescence every process takes a
    "strong read" of the whole index and the strong_dirty_read checker
    looks for reads of never-committed ids and lost writes
    (dirty_read.clj:106-225).
  * set — unique integers indexed under partitions; a final read looks
    for lost updates (sets.clj).

The client speaks the ES REST API via stdlib urllib (the reference used
the Java transport client; REST needs no third-party library).
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures,
                generator as gen, nemesis as nemesis_mod, util)
from ..checker import basic, dirty, perf as perf_mod, timeline
from ..os import debian

log = logging.getLogger("jepsen")

USER = "elasticsearch"
DIR = "/opt/elasticsearch"
PIDFILE = "/tmp/elasticsearch.pid"
STDOUT_LOG = f"{DIR}/logs/stdout.log"
CLUSTER = "jepsen"
LOGS = [STDOUT_LOG, f"{DIR}/logs/{CLUSTER}.log"]
TARBALL = ("https://artifacts.elastic.co/downloads/elasticsearch/"
           "elasticsearch-5.0.0.tar.gz")
INDEX = "dirty_read"


def config_yml(test, node) -> str:
    """elasticsearch.yml with unicast hosts + majority master quorum
    (core.clj:221-245)."""
    hosts = json.dumps([str(n) for n in test["nodes"]])
    n = len(test["nodes"])
    return "\n".join([
        f"cluster.name: {CLUSTER}",
        f"node.name: {node}",
        "network.host: 0.0.0.0",
        f"discovery.zen.ping.unicast.hosts: {hosts}",
        f"discovery.zen.minimum_master_nodes: {util.majority(n)}",
        f"gateway.recover_after_nodes: {n}",
        ""])


class ElasticsearchDB(db_mod.DB, db_mod.LogFiles):
    """core.clj:283-300: install + configure + start, nuke on teardown."""

    def __init__(self, tarball: str = TARBALL):
        self.tarball = tarball

    def setup(self, test, node):
        sess = control.session(node, test).su()
        debian.install_jdk8(sess)
        cu.ensure_user(sess, USER)
        cu.install_archive(sess, self.tarball, DIR)
        sess.exec("chown", "-R", f"{USER}:{USER}", DIR)
        sess.exec("echo", config_yml(test, node), control.lit(">"),
                  f"{DIR}/config/elasticsearch.yml")
        sess.exec("sysctl", "-w", "vm.max_map_count=262144")
        sess.exec("mkdir", "-p", f"{DIR}/logs")
        cu.start_daemon(sess, f"{DIR}/bin/elasticsearch",
                        logfile=STDOUT_LOG, pidfile=PIDFILE, chdir=DIR)
        self.wait_healthy(node, timeout_s=60)

    def wait_healthy(self, node, timeout_s: float = 60,
                     color: str = "green") -> None:
        """Block until /_cluster/health reaches `color` (core.clj:161-178)."""
        deadline = time.time() + timeout_s
        url = (f"http://{node}:9200/_cluster/health/"
               f"?wait_for_status={color}&timeout={int(timeout_s)}s")
        while True:
            try:
                with urllib.request.urlopen(url, timeout=timeout_s) as r:
                    if r.status == 200:
                        return
            except OSError:
                pass
            if time.time() > deadline:
                raise TimeoutError(
                    f"elasticsearch on {node} not {color} "
                    f"after {timeout_s}s")
            time.sleep(1)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        cu.stop_daemon(sess, PIDFILE, cmd="java")
        sess.exec("rm", "-rf", control.lit(f"{DIR}/data/*"))
        for f in LOGS:
            try:
                sess.exec("truncate", "--size", "0", f)
            except control.RemoteError:
                pass

    def log_files(self, test, node):
        return LOGS


def db(tarball: str = TARBALL) -> ElasticsearchDB:
    return ElasticsearchDB(tarball)


# ---------------------------------------------------------------------------
# REST client
# ---------------------------------------------------------------------------


class ESClient(client_mod.Client):
    """Document index/get/search over the REST API."""

    def __init__(self, node=None, timeout: float = 10.0):
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return type(self)(node, self.timeout)

    def _req(self, method, path, body=None, timeout=None):
        url = f"http://{self.node}:9200{path}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(
                req, timeout=timeout or self.timeout) as r:
            return json.loads(r.read() or b"{}")

    def index_doc(self, doc_id, doc, refresh=False):
        q = "?refresh=true" if refresh else ""
        return self._req("PUT", f"/{INDEX}/default/{doc_id}{q}", doc)

    def get_doc(self, doc_id):
        try:
            return self._req("GET", f"/{INDEX}/default/{doc_id}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def refresh(self):
        return self._req("POST", f"/{INDEX}/_refresh", timeout=120)

    def search_ids(self) -> list:
        """Scroll the whole index (core.clj es-search)."""
        out = []
        r = self._req("GET", f"/{INDEX}/_search?scroll=1m&size=128",
                      {"query": {"match_all": {}}}, timeout=60)
        while True:
            hits = r.get("hits", {}).get("hits", [])
            if not hits:
                break
            out.extend(h["_id"] for h in hits)
            r = self._req("GET", "/_search/scroll",
                          {"scroll": "1m",
                           "scroll_id": r["_scroll_id"]}, timeout=60)
        return out


class DirtyReadClient(ESClient):
    """dirty_read.clj:32-104: write = index id; read = get id (ok iff
    found); refresh = index refresh; strong-read = full scroll."""

    def setup(self, test):
        try:
            self._req("PUT", f"/{INDEX}")
        except urllib.error.HTTPError as e:
            if e.code != 400:  # index exists
                raise

    def invoke(self, test, op):
        try:
            if op.f == "write":
                self.index_doc(op.value, {"id": op.value})
                return replace(op, type="ok")
            if op.f == "read":
                doc = self.get_doc(op.value)
                return replace(op, type="ok" if doc else "fail")
            if op.f == "refresh":
                r = self.refresh()
                sh = r.get("_shards", {})
                ok = sh.get("total") == sh.get("successful")
                return replace(op, type="ok" if ok else "fail", value=r)
            if op.f == "strong-read":
                return replace(op, type="ok",
                               value=sorted(self.search_ids()))
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))


class SetClient(ESClient):
    """sets.clj: adds index unique numbers; read scrolls them all."""

    def setup(self, test):
        try:
            self._req("PUT", f"/{INDEX}")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise

    def invoke(self, test, op):
        try:
            if op.f == "add":
                self.index_doc(op.value, {"num": op.value})
                return replace(op, type="ok")
            if op.f == "read":
                self.refresh()
                vals = sorted(int(i) for i in self.search_ids())
                return replace(op, type="ok", value=vals)
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))


# ---------------------------------------------------------------------------
# generators + tests
# ---------------------------------------------------------------------------


class RWGen(gen.Generator):
    """dirty_read.clj:160-186: the first w threads write ascending ids,
    recording the in-flight id per node; the rest read their node's most
    recent in-flight id — aiming at the instant before a crash."""

    def __init__(self, writers: int):
        self.writers = writers
        self.write = itertools.count()
        self.in_flight: dict = {}
        self.lock = threading.Lock()

    def op(self, test, process):
        threads = gen.current_threads()
        thread = gen.process_to_thread(test, process)
        t = threads.index(thread) if thread in threads else 0
        n = process % len(test["nodes"])
        with self.lock:
            if t < self.writers:
                v = next(self.write)
                self.in_flight[n] = v
                return {"type": "invoke", "f": "write", "value": v}
            return {"type": "invoke", "f": "read",
                    "value": self.in_flight.get(n, 0)}


def dirty_read_test(opts: dict) -> dict:
    """dirty_read.clj:193-225: rw phase under partitions, heal, refresh
    everywhere, quiesce, strong-read everywhere."""
    concurrency = opts.get("concurrency", 6)
    return basic_test(opts) | {
        "name": "elasticsearch dirty-read",
        "client": DirtyReadClient(),
        "checker": checker_mod.compose({
            "dirty-read": dirty.strong_dirty_read(),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time_limit", 60),
                gen.nemesis(
                    gen.seq(itertools.cycle(
                        [gen.sleep(10), {"type": "info", "f": "start"},
                         gen.sleep(20), {"type": "info", "f": "stop"}])),
                    gen.stagger(0.1, RWGen(max(1, concurrency // 3))))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.clients(gen.each(lambda: gen.once(
                {"type": "invoke", "f": "refresh", "value": None}))),
            gen.log("Waiting for quiescence"),
            gen.sleep(10),
            gen.clients(gen.each(lambda: gen.once(
                {"type": "invoke", "f": "strong-read",
                 "value": None})))),
    }


def set_test(opts: dict) -> dict:
    counter = itertools.count()
    lock = threading.Lock()

    def add(test, process):
        with lock:
            v = next(counter)
        return {"type": "invoke", "f": "add", "value": v}

    return basic_test(opts) | {
        "name": "elasticsearch set",
        "client": SetClient(),
        "checker": checker_mod.compose({
            "set": basic.set_checker(),
            "perf": perf_mod.perf(),
            "timeline": timeline.timeline(),
        }),
        "generator": gen.phases(
            gen.time_limit(opts.get("time_limit", 60),
                           gen.nemesis(gen.start_stop(5, 5), add)),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(10),
            gen.clients(gen.once({"type": "invoke", "f": "read",
                                  "value": None}))),
    }


WORKLOADS = {"dirty-read": dirty_read_test, "set": set_test}


def basic_test(opts: dict) -> dict:
    return fixtures.noop_test() | {
        "os": debian.os,
        "db": db(opts.get("tarball", TARBALL)),
        "nemesis": nemesis_mod.partition_random_halves(),
    } | dict(opts)


def add_opts(p):
    p.add_argument("--workload", default="dirty-read",
                   choices=sorted(WORKLOADS))
    cli.add_tarball_opt(p, default=TARBALL)


def es_test(opts: dict) -> dict:
    return WORKLOADS[opts.get("workload", "dirty-read")](opts)


def main(argv=None):
    cli.main(cli.single_test_cmd(es_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
