"""Consul suite — a CAS register over Consul's KV HTTP API.

Reference: consul/src/jepsen/consul.clj.  Consul agent bring-up with
bootstrap-on-primary + join (start-consul!, consul.clj:22-44), and an
index-based CAS client: read the key, compare the decoded value, then PUT
with ?cas=<ModifyIndex> (consul-cas!, consul.clj:100-110).  The register
test composes timeline + linearizable checkers under
partition-random-halves with a phased final read (consul_test.clj:19-45).
"""

from __future__ import annotations

import base64
import itertools
import json
import logging
import random
import urllib.error
import urllib.request
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, core, fixtures, generator as gen,
                nemesis, net as net_mod)
from ..checker import linearizable as lin, timeline
from ..models import cas_register
from ..os import debian

log = logging.getLogger("jepsen")

BINARY = "/usr/bin/consul"
PIDFILE = "/var/run/consul.pid"
DATA_DIR = "/var/lib/consul"
LOG_FILE = "/var/log/consul.log"


class ConsulDB:
    """consul.clj:22-57."""

    def setup(self, test, node):
        log.info("%s starting consul", node)
        sess = control.session(node, test).su()
        args = ["agent", "-server", "-log-level", "debug",
                "-client", "0.0.0.0",
                "-bind", net_mod.ip(sess, str(node)),
                "-data-dir", DATA_DIR, "-node", str(node)]
        if node == core.primary(test):
            args.append("-bootstrap")
        else:
            args += ["-join", net_mod.ip(sess, str(core.primary(test)))]
        cu.start_daemon(sess, BINARY, *args, logfile=LOG_FILE,
                        pidfile=PIDFILE, chdir="/opt/consul")
        import time

        time.sleep(1)
        log.info("%s consul ready", node)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        try:
            sess.exec("killall", "-9", "consul")
        except control.RemoteError:
            pass
        sess.exec("rm", "-rf", PIDFILE, DATA_DIR)
        log.info("%s consul nuked", node)


def db() -> ConsulDB:
    return ConsulDB()


class CASClient(client_mod.Client):
    """Index-based CAS over /v1/kv (consul.clj:59-146)."""

    def __init__(self, k: str = "jepsen", node=None, timeout: float = 5.0):
        self.k = k
        self.node = node
        self.timeout = timeout

    @property
    def url(self) -> str:
        return f"http://{self.node}:8500/v1/kv/{self.k}"

    def open(self, test, node):
        return CASClient(self.k, node, self.timeout)

    def setup(self, test):
        self._put(self.url, json.dumps(None))

    def _get(self):
        with urllib.request.urlopen(self.url, timeout=self.timeout) as r:
            rows = json.loads(r.read())
        row = rows[0]
        raw = row.get("Value")
        value = json.loads(base64.b64decode(raw)) if raw else None
        return value, row["ModifyIndex"]

    def _put(self, url, body: str) -> str:
        req = urllib.request.Request(url, data=body.encode(),
                                     method="PUT")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return r.read().decode()

    def invoke(self, test, op):
        try:
            if op.f == "read":
                value, _ = self._get()
                return replace(op, type="ok", value=value)
            if op.f == "write":
                self._put(self.url, json.dumps(op.value))
                return replace(op, type="ok")
            if op.f == "cas":
                old, new = op.value
                value, index = self._get()
                if value != old:
                    return replace(op, type="fail")
                out = self._put(f"{self.url}?cas={index}", json.dumps(new))
                return replace(op, type="ok" if out.strip() == "true"
                               else "fail")
            raise ValueError(f"unknown f {op.f!r}")
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            # reads have no side effects; writes/cas may have happened
            if op.f == "read":
                return replace(op, type="fail", error=str(e))
            return replace(op, type="info", error=str(e))


def cas_client(k: str = "jepsen") -> CASClient:
    return CASClient(k)


def consul_test(opts: dict) -> dict:
    """consul_test.clj:19-45."""
    return fixtures.noop_test() | dict(opts) | {
        "name": "consul",
        "os": debian.os,
        "db": db(),
        "client": cas_client(),
        "model": cas_register(),
        "checker": checker_mod.compose({
            "html": timeline.timeline(),
            "linear": lin.linearizable(),
        }),
        "nemesis": nemesis.partition_random_halves(),
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time_limit", 120),
                gen.nemesis(
                    gen.seq(itertools.cycle(
                        [gen.sleep(10), {"type": "info", "f": "start"},
                         gen.sleep(10), {"type": "info", "f": "stop"}])),
                    gen.delay(0.5, gen.cas))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.clients(gen.once({"type": "invoke", "f": "read",
                                  "value": None}))),
    }


def main(argv=None):
    cli.main(cli.single_test_cmd(consul_test), argv)


if __name__ == "__main__":
    main()
