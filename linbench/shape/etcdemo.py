"""The shape of a jepsen.etcdemo register test, measured on the port's own
suite, beside the same figures of the benchmark's generator.

    python3 linbench/shape/etcdemo.py --dir DIR [--time-limit 60] [--seed N]

Runs ``jepsen_tpu_torch.suites.etcdemo``'s register test as a user types
it (``test -q --concurrency 40 --time-limit 60 --ops-per-key 100 --rate
10``, five nodes, partition-random-halves 5 s on and 5 s off) through the
port's command line, with the dummy remote, against five in-process etcd
v3 gateway stand-ins that share one store.  The stand-ins act out the
partitions: a request to a node on the minority side of a partition
waits for the heal, and where the client's 5 s timeout comes first it
gets no reply and takes effect on a coin flip, as a proposal that may or
may not commit.  Each reply waits up to 10 ms after its op applies.  The
suite's checker is replaced by one that accepts everything: only the
stored history is read.  The store goes under ``DIR``.

Prints one JSON line with the figures (:func:`shape`) of the suite's
history and of the tests that ``gen.py`` makes for the cell
``etcd-register.quorum`` from the same seed.  Imports the port; the
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import ast
import base64
import http.server
import json
import os
import random
import socket
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
LINBENCH = HERE.parent
ROOT = LINBENCH.parent

#: the client's timeout (``EtcdClient``'s default)
TIMEOUT_S = 5.0
#: each stand-in's reply waits a uniform draw up to this after its op
#: applies (the in-repo stand-in's)
LATENCY_S = 0.01
DUMMY_RESPONSES = {
    "stat /tmp/jepsen/": [1, "", "stat: No such file or directory"],
    "ls -A": [0, "etcd-v3.1.5-linux-amd64\n", ""]}


class Cluster:
    """The stand-ins' shared store and the partition: ``cut`` holds the
    nodes on a minority side."""

    def __init__(self, nodes):
        self.nodes = list(nodes)
        self.kv: dict = {}
        self.lock = threading.Lock()
        self.cond = threading.Condition()
        self.cut: set = set()

    def partition(self, grudge: dict) -> None:
        cut = set()
        for n in self.nodes:
            side = {n} | {m for m in self.nodes
                          if m not in grudge.get(n, ())}
            if len(side) <= len(self.nodes) // 2:
                cut.add(n)
        with self.cond:
            self.cut = cut
            self.cond.notify_all()

    def heal(self) -> None:
        with self.cond:
            self.cut = set()
            self.cond.notify_all()


class Gateway(http.server.BaseHTTPRequestHandler):
    """etcd's v3 JSON gateway (``/kv/put``, ``/kv/range``, ``/kv/txn``)
    over the cluster's store, for ``server.node``."""

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        srv = self.server
        c = srv.cluster
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        t0 = time.monotonic()
        with c.cond:
            c.cond.wait_for(lambda: srv.node not in c.cut,
                            timeout=TIMEOUT_S + 0.5)
        late = time.monotonic() - t0 >= TIMEOUT_S
        if late and random.random() < 0.5:
            return  # the client gave up; the proposal never committed

        def d(x):
            return base64.b64decode(x).decode()

        with c.lock:
            if self.path.endswith("/kv/put"):
                c.kv[d(body["key"])] = d(body["value"])
                out = {}
            elif self.path.endswith("/kv/range"):
                k = d(body["key"])
                out = {}
                if k in c.kv:
                    out["kvs"] = [{"key": body["key"], "value":
                                   base64.b64encode(c.kv[k].encode())
                                   .decode()}]
            else:
                cmp_ = body["compare"][0]
                k = d(cmp_["key"])
                ok = c.kv.get(k) == d(cmp_["value"])
                if ok:
                    req = body["success"][0]["requestPut"]
                    c.kv[d(req["key"])] = d(req["value"])
                out = {"succeeded": ok}
        if late:
            return
        time.sleep(random.uniform(0, LATENCY_S))
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class _Server(http.server.ThreadingHTTPServer):
    request_queue_size = 128
    daemon_threads = True


def gateways(cluster: Cluster) -> tuple[list, dict]:
    """A stand-in per node on 127.0.0.1 at free ports: (servers, node ->
    port)."""
    servers, ports = [], {}
    for n in cluster.nodes:
        srv = _Server(("127.0.0.1", 0), Gateway)
        srv.cluster, srv.node = cluster, n
        ports[n] = srv.server_address[1]
        servers.append(srv)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    return servers, ports


def suite_history(d: Path, time_limit: float, seed: int) -> list[tuple]:
    """The events of one etcdemo register run, as ``gen.py``'s tuples."""
    sys.path.insert(0, str(ROOT))
    from jepsen_tpu_torch import cli, net as net_mod, store
    from jepsen_tpu_torch.checker.core import CheckerFn
    from jepsen_tpu_torch.suites import etcdemo

    nodes = [f"n{i}" for i in range(1, 6)]
    cluster = Cluster(nodes)

    class Net(net_mod.Net, net_mod.PartitionAll):
        def drop_all(self, test, grudge):
            cluster.partition(grudge)

        def heal(self, test):
            cluster.heal()

        def drop(self, test, src, dest):
            pass

    def etcd_test(opts):
        t = etcdemo.etcd_test(opts)
        t["net"] = Net()
        t["checker"] = CheckerFn(lambda test, history, opts=None:
                                 {"valid": True})
        return t

    class _NoJoinWait:  # the DB's 10 s join wait: no cluster to join
        sleep = staticmethod(lambda s: None)

    servers, ports = gateways(cluster)
    etcdemo.time = _NoJoinWait
    etcdemo.client_url = lambda node: f"http://127.0.0.1:{ports[node]}"
    d.mkdir(parents=True, exist_ok=True)
    resp = d / "dummy-responses.json"
    resp.write_text(json.dumps(DUMMY_RESPONSES))
    os.chdir(d)
    random.seed(seed)
    try:
        argv = ["test", "--dummy", "--dummy-responses", str(resp),
                "--device", "cpu", "-q", "--concurrency", "40",
                "--time-limit", str(time_limit), "--ops-per-key", "100",
                "--rate", "10"]
        for n in nodes:
            argv += ["-n", n]
        cli.run(cli.single_test_cmd(etcd_test, add_opts=etcdemo.add_opts),
                argv)
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    run = store.latest(str(d / "store"))
    out = []
    for op in run["history"]:
        if op.process == "nemesis":
            out.append(("nemesis", op.type, op.f, None))
            continue
        # the store writes a [k v] value as its repr
        k, x = op.value[1:-1].split(" ", 1)
        out.append((op.process, op.type, op.f, ast.literal_eval(x),
                    ast.literal_eval(k)))
    return out


def shape(events: list[tuple]) -> dict:
    """A keyed history's figures: keys, ops a key, the ops of its key
    pending at each invocation (apart in and out of partitions), the
    share of ops crashed (``:info``) and of reads failed, and crashed
    ops a key."""
    pending: dict = {}
    ops: dict = {}
    crashes: dict = {}
    at_inv = {True: [], False: []}
    n_info = n_reads = n_read_fail = 0
    parted = False
    for e in events:
        if e[0] == "nemesis":
            if e[1] == "info" and e[2] in ("start", "stop"):
                parted = e[2] == "start"
            continue
        p, typ, f, _v, k = e
        if typ == "invoke":
            at_inv[parted].append(len(pending.get(k, ())))
            pending.setdefault(k, set()).add(p)
            ops[k] = ops.get(k, 0) + 1
            n_reads += f == "read"
            continue
        pending[k].discard(p)
        if typ == "info":
            n_info += 1
            crashes[k] = crashes.get(k, 0) + 1
        n_read_fail += typ == "fail" and f == "read"
    n = sum(ops.values())
    per = sorted(ops.values())

    def mean(xs):
        return round(sum(xs) / len(xs), 4) if xs else None

    return {"keys": len(ops), "ops": n,
            "ops_per_key": {"min": per[0], "median": per[len(per) // 2],
                            "max": per[-1],
                            "full": sum(x >= 100 for x in per)},
            "pending_at_invoke": {"partitioned": mean(at_inv[True]),
                                  "healed": mean(at_inv[False]),
                                  "all": mean(at_inv[True] + at_inv[False])},
            "invokes_partitioned_share": round(len(at_inv[True]) / n, 4),
            "info_share": round(n_info / n, 5),
            "read_fail_share": round(n_read_fail / max(1, n_reads), 5),
            "keys_with_crashes": len(crashes),
            "crashes_per_key_max": max(crashes.values(), default=0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dir", required=True, type=Path)
    p.add_argument("--time-limit", type=float, default=60)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, str(LINBENCH))
    import gen

    d = args.dir.resolve()
    suite = shape(suite_history(d, args.time_limit, args.seed))
    traffic = gen.load_traffic("etcd-register.quorum")
    with open(LINBENCH / "configs" / "etcd-register.json") as fh:
        config = json.load(fh)
    t = {**config, **traffic["params"], "time_limit_s": args.time_limit}
    made = [shape(c["events"]) for c in gen.make_pool(args.seed, t, 2)]
    print(json.dumps({"suite": suite, "generator": made}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
