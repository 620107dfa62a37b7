"""etcd suite (the older, pre-demo one) — CAS register over the v2 API.

Reference: etcd/ (188 LoC, etcd/src/jepsen/etcd.clj).  Distinct from
jepsen.etcdemo (suites/etcdemo.py): this suite drives the **v2** HTTP
API (/v2/keys with prevValue CAS — the verschlimmbesserung client,
etcd.clj:5,96-135) against a single shared register, with the
partition-random-halves nemesis and a 30s-cycle schedule
(etcd.clj:152-188).
"""

from __future__ import annotations

import json
import logging
import random
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures, generator as gen,
                nemesis as nemesis_mod)
from ..checker import linearizable as lin, perf as perf_mod, timeline
from ..models import cas_register
from ..os import debian

log = logging.getLogger("jepsen")

DIR = "/opt/etcd"
BINARY = "etcd"
LOG_FILE = f"{DIR}/etcd.log"
PIDFILE = f"{DIR}/etcd.pid"


def node_url(node, port: int) -> str:
    return f"http://{node}:{port}"


def peer_url(node) -> str:
    return node_url(node, 2380)


def client_url(node) -> str:
    return node_url(node, 2379)


def initial_cluster(test) -> str:
    """n1=http://n1:2380,... (etcd.clj:42-49)."""
    return ",".join(f"{n}={peer_url(n)}" for n in test["nodes"])


class EtcdDB(db_mod.DB, db_mod.LogFiles):
    """etcd.clj:51-86."""

    def __init__(self, version: str):
        self.version = version

    def setup(self, test, node):
        import time

        sess = control.session(node, test).su()
        url = (f"https://storage.googleapis.com/etcd/{self.version}/"
               f"etcd-{self.version}-linux-amd64.tar.gz")
        cu.install_archive(sess, url, DIR)
        cu.start_daemon(
            sess, BINARY,
            "--name", str(node),
            "--listen-peer-urls", peer_url(node),
            "--listen-client-urls", client_url(node),
            "--advertise-client-urls", client_url(node),
            "--initial-cluster-state", "new",
            "--initial-advertise-peer-urls", peer_url(node),
            "--initial-cluster", initial_cluster(test),
            "--log-output", "stdout",
            logfile=LOG_FILE, pidfile=PIDFILE, chdir=DIR)
        time.sleep(5)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        try:
            cu.stop_daemon(sess, PIDFILE, cmd=BINARY)
        except control.RemoteError:
            pass
        sess.exec("rm", "-rf", DIR)

    def log_files(self, test, node):
        return [LOG_FILE]


def db(version: str = "v2.1.1") -> EtcdDB:
    return EtcdDB(version)


# ---------------------------------------------------------------------------
# v2 API client (etcd.clj:93-135)
# ---------------------------------------------------------------------------


class V2Client(client_mod.Client):
    """GET/PUT /v2/keys/r with prevValue for CAS.  Values ride as JSON
    strings (codec parity with verschlimmbesserung)."""

    key = "jepsen"

    def __init__(self, node=None, timeout: float = 5.0):
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return type(self)(node, self.timeout)

    def _url(self, query: dict | None = None) -> str:
        q = f"?{urllib.parse.urlencode(query)}" if query else ""
        return f"{client_url(self.node)}/v2/keys/{self.key}{q}"

    def _req(self, method: str, query: dict | None = None,
             form: dict | None = None) -> dict:
        data = urllib.parse.urlencode(form).encode() if form else None
        req = urllib.request.Request(self._url(query), data=data,
                                     method=method)
        if form:
            req.add_header("Content-Type",
                           "application/x-www-form-urlencoded")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read() or b"{}")

    def invoke(self, test, op):
        try:
            if op.f == "read":
                try:
                    out = self._req("GET", {"quorum": "true"})
                    val = json.loads(out["node"]["value"])
                except urllib.error.HTTPError as e:
                    if e.code == 404:
                        return replace(op, type="ok", value=None)
                    raise
                return replace(op, type="ok", value=val)
            if op.f == "write":
                self._req("PUT", form={"value": json.dumps(op.value)})
                return replace(op, type="ok")
            if op.f == "cas":
                frm, to = op.value
                try:
                    self._req("PUT",
                              {"prevValue": json.dumps(frm)},
                              {"value": json.dumps(to)})
                    return replace(op, type="ok")
                except urllib.error.HTTPError as e:
                    if e.code in (404, 412):  # missing / compare failed
                        return replace(op, type="fail")
                    raise
            raise ValueError(f"unknown f {op.f!r}")
        except (TimeoutError, urllib.error.URLError, OSError) as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))


# ---------------------------------------------------------------------------
# test (etcd.clj:140-188)
# ---------------------------------------------------------------------------


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randint(0, 4), random.randint(0, 4))}


def etcd_test(opts: dict) -> dict:
    import itertools

    tl = opts.get("time_limit", 60)
    return fixtures.noop_test() | {
        "name": "etcd",
        "os": debian.os,
        "db": db(opts.get("version", "v2.1.1")),
        "client": V2Client(),
        "model": cas_register(),
        "nemesis": nemesis_mod.partition_random_halves(),
        "checker": checker_mod.compose({
            "linear": lin.linearizable(cas_register()),
            "timeline": timeline.timeline(),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.time_limit(tl, gen.nemesis(
            gen.seq(itertools.cycle(
                [gen.sleep(30), {"type": "info", "f": "start"},
                 gen.sleep(30), {"type": "info", "f": "stop"}])),
            gen.stagger(1, gen.mix([r, w, cas])))),
    } | dict(opts)


def add_opts(p):
    p.add_argument("--version", default="v2.1.1")


def main(argv=None):
    cli.main(cli.single_test_cmd(etcd_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
