"""etcd demo suite — the reference's tutorial test, rebuilt.

Reference: jepsen.etcdemo/src/jepsen/etcdemo.clj.  CAS register over
independent keys (register-workload, etcdemo.clj:171-185), a set
workload, partition-random-halves nemesis on a 5s on / 5s off cadence
with a phased heal + final read (etcdemo.clj:218-231), and CLI options
--quorum/--rate/--ops-per-key/--workload (etcdemo.clj:242-256).

The client speaks etcd's v3 JSON gateway (the reference used the
verschlimmbesserung v2 client; v3's gRPC-gateway with base64 keys is the
modern equivalent and needs no third-party library).
"""

from __future__ import annotations

import base64
import itertools
import json
import logging
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures,
                generator as gen, independent, nemesis, net as net_mod)
from ..checker import basic, linearizable as lin, perf as perf_mod, timeline
from ..models import cas_register
from ..os import debian

log = logging.getLogger("jepsen")

BINARY = "etcd"
DIR = "/opt/etcd"
LOGFILE = f"{DIR}/etcd.log"
PIDFILE = f"{DIR}/etcd.pid"


def peer_url(node) -> str:
    return f"http://{node}:2380"


def client_url(node) -> str:
    return f"http://{node}:2379"


def initial_cluster(test) -> str:
    """foo=http://foo:2380,... (etcdemo.clj:44-50)."""
    return ",".join(f"{n}={peer_url(n)}" for n in test["nodes"])


class EtcdDB(db_mod.DB, db_mod.LogFiles):
    """etcdemo.clj:66-100."""

    def __init__(self, version: str = "v3.1.5"):
        self.version = version

    def setup(self, test, node):
        log.info("%s installing etcd %s", node, self.version)
        sess = control.session(node, test).su()
        url = (f"https://storage.googleapis.com/etcd/{self.version}/"
               f"etcd-{self.version}-linux-amd64.tar.gz")
        cu.install_archive(sess, url, DIR)
        cu.start_daemon(
            sess, f"{DIR}/{BINARY}",
            "--log-output", "stderr",
            "--name", str(node),
            "--listen-peer-urls", peer_url(node),
            "--listen-client-urls", client_url(node),
            "--advertise-client-urls", client_url(node),
            "--initial-cluster-state", "new",
            "--initial-advertise-peer-urls", peer_url(node),
            "--initial-cluster", initial_cluster(test),
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)
        time.sleep(10)  # wait for cluster join (etcdemo.clj:93)

    def teardown(self, test, node):
        log.info("%s tearing down etcd", node)
        sess = control.session(node, test).su()
        cu.stop_daemon(sess, PIDFILE, cmd=BINARY)
        sess.exec("rm", "-rf", DIR)

    def log_files(self, test, node):
        return [LOGFILE]


def db(version: str = "v3.1.5") -> EtcdDB:
    return EtcdDB(version)


# ---------------------------------------------------------------------------
# v3 JSON-gateway client
# ---------------------------------------------------------------------------


def _b64(s) -> str:
    return base64.b64encode(str(s).encode()).decode()


def _unb64(s: str) -> str:
    return base64.b64decode(s).decode()


class EtcdClient(client_mod.Client):
    """CAS-register ops against one key via /v3alpha (etcd 3.1's gateway
    prefix).  Timeouts become :info for writes (they may have applied) and
    :fail for reads, matching etcdemo.clj:146-155."""

    def __init__(self, node=None, timeout: float = 5.0,
                 api_prefix: str = "/v3alpha"):
        self.node = node
        self.timeout = timeout
        self.api = api_prefix

    def open(self, test, node):
        return EtcdClient(node, self.timeout, self.api)

    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            client_url(self.node) + self.api + path,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def read(self, k, quorum: bool) -> int | None:
        out = self._post("/kv/range", {
            "key": _b64(k),
            "serializable": not quorum,
        })
        kvs = out.get("kvs") or []
        return int(_unb64(kvs[0]["value"])) if kvs else None

    def write(self, k, v) -> None:
        self._post("/kv/put", {"key": _b64(k), "value": _b64(v)})

    def cas(self, k, old, new) -> bool:
        out = self._post("/kv/txn", {
            "compare": [{"key": _b64(k), "target": "VALUE",
                         "value": _b64(old)}],
            "success": [{"requestPut": {"key": _b64(k),
                                        "value": _b64(new)}}],
        })
        return bool(out.get("succeeded"))

    def invoke(self, test, op):
        k, v = op.value.key, op.value.value
        try:
            if op.f == "read":
                val = self.read(k, test.get("quorum", False))
                return replace(op, type="ok",
                               value=independent.tuple_(k, val))
            if op.f == "write":
                self.write(k, v)
                return replace(op, type="ok")
            if op.f == "cas":
                old, new = v
                return replace(op,
                               type="ok" if self.cas(k, old, new)
                               else "fail")
            raise ValueError(f"unknown f {op.f!r}")
        except (socket.timeout, TimeoutError):
            return replace(op, type="fail" if op.f == "read" else "info",
                           error="timeout")
        except urllib.error.URLError as e:
            if isinstance(getattr(e, "reason", None),
                          (socket.timeout, TimeoutError)):
                return replace(op,
                               type="fail" if op.f == "read" else "info",
                               error="timeout")
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))


# ---------------------------------------------------------------------------
# workloads (etcdemo.clj:171-196 + set.clj)
# ---------------------------------------------------------------------------


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def register_workload(opts: dict) -> dict:
    """Linearizable r/w/cas on independent keys (etcdemo.clj:171-185):
    10 threads per key, checked per key — on device, batched."""
    return {
        "client": EtcdClient(),
        "checker": independent.checker(checker_mod.compose({
            "linear": lin.linearizable(),
            "timeline": timeline.timeline(),
        })),
        "generator": independent.concurrent_generator(
            10, _naturals(),
            lambda k: gen.limit(opts.get("ops_per_key", 100),
                                gen.mix([r, w, cas]))),
        "final_generator": None,
    }


class EtcdSetClient(client_mod.Client):
    """Set workload client: each add puts a unique member key under a
    prefix; the final read ranges over the prefix (set.clj analog)."""

    PREFIX = "/jepsen/set/"

    def __init__(self, node=None, timeout=5.0, api_prefix="/v3alpha"):
        self.inner = EtcdClient(node, timeout, api_prefix)

    def open(self, test, node):
        c = EtcdSetClient()
        c.inner = self.inner.open(test, node)
        return c

    def invoke(self, test, op):
        try:
            if op.f == "add":
                self.inner.write(self.PREFIX + str(op.value), op.value)
                return replace(op, type="ok")
            if op.f == "read":
                out = self.inner._post("/kv/range", {
                    "key": _b64(self.PREFIX),
                    "range_end": _b64(self.PREFIX + "\xff"),
                })
                vals = sorted(int(_unb64(kv["value"]))
                              for kv in out.get("kvs") or [])
                return replace(op, type="ok", value=vals)
            raise ValueError(f"unknown f {op.f!r}")
        except (socket.timeout, TimeoutError):
            return replace(op, type="fail" if op.f == "read" else "info",
                           error="timeout")
        except urllib.error.URLError as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))


def set_workload(opts: dict) -> dict:
    """Adds unique ints during faults; one final read after heal
    (jepsen.etcdemo set.clj:40-48)."""
    counter = {"n": -1}
    lock = threading.Lock()

    def add(test, process):
        with lock:
            counter["n"] += 1
            return {"type": "invoke", "f": "add", "value": counter["n"]}

    return {
        "client": EtcdSetClient(),
        "checker": basic.set_checker(),
        "generator": add,
        "final_generator": gen.once({"type": "invoke", "f": "read",
                                     "value": None}),
    }


WORKLOADS = {"register": register_workload, "set": set_workload}


def _naturals():
    k = 0
    while True:
        yield k
        k += 1


def etcd_test(opts: dict) -> dict:
    """Construct the test map (etcdemo.clj:195-233): phased generator —
    staggered client ops + 5s/5s nemesis cadence under a time limit, then
    heal, quiesce, and the workload's final generator."""
    quorum = bool(opts.get("quorum"))
    workload = WORKLOADS[opts.get("workload", "register")](opts)
    rate = opts.get("rate", 10)
    main_phase = gen.nemesis(
        gen.seq(itertools.cycle(
            [gen.sleep(5), {"type": "info", "f": "start"},
             gen.sleep(5), {"type": "info", "f": "stop"}])),
        gen.stagger(1.0 / rate, workload["generator"]))
    phases = [gen.time_limit(opts.get("time_limit", 60), main_phase),
              gen.log("Healing cluster"),
              gen.nemesis(gen.once({"type": "info", "f": "stop"})),
              gen.log("Waiting for recovery"),
              gen.sleep(10)]
    if workload.get("final_generator") is not None:
        phases.append(gen.clients(workload["final_generator"]))
    return fixtures.noop_test() | dict(opts) | {
        "name": f"etcd q={quorum} {opts.get('workload', 'register')}",
        "quorum": quorum,
        "os": debian.os,
        "db": db("v3.1.5"),
        "net": net_mod.iptables,
        "client": workload["client"],
        "nemesis": nemesis.partition_random_halves(),
        "model": cas_register(),
        "checker": checker_mod.compose({
            "perf": perf_mod.perf(),
            "workload": workload["checker"],
        }),
        "generator": gen.phases(*phases),
    }


def add_opts(p):
    """etcdemo.clj:242-256."""
    p.add_argument("-q", "--quorum", action="store_true",
                   help="Use quorum reads")
    p.add_argument("-r", "--rate", type=float, default=10,
                   help="Approximate requests per second, per thread")
    p.add_argument("--ops-per-key", type=int, default=100,
                   help="Maximum operations on any given key")
    p.add_argument("-w", "--workload", choices=sorted(WORKLOADS),
                   default="register", help="Workload to run")


def main(argv=None):
    cli.main(cli.single_test_cmd(etcd_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
