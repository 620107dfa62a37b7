"""The port's register suites against the JAX package's: ``etcdemo``,
``etcd`` (v2), ``zookeeper``, ``consul``, ``logcabin``, ``disque``,
``raftis``, ``rethinkdb``, ``tidb`` and ``aerospike``.

The same inputs go through both packages and must give the same answer:
a DB's commands on a ``DummyRemote`` (the whole log, under one seeded
``random``), the test maps (keys, names, the classes of client, nemesis,
db and os, the model, the checkers), the op functions under one seeded
``random``, the clients against in-process stand-ins of each server's
wire protocol, and the helpers' strings and parsers.  Last, whole
``etcdemo`` register runs through the port's command line with
``--device cpu`` against three etcd gateway stand-ins that share one
store (``chip_smoke.etcd_gateways``): valid with a sound store, invalid
with one gateway serving stale reads, and in both the JAX package's
checker on the stored history gives the port's verdict on every key.

Stand-ins bind ports drawn below the kernel's ephemeral range (which
starts at 32768) and draw again when a port is taken."""

import collections
import importlib
import json
import random
import socket
import socketserver
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

import jepsen_tpu.checker.linearizable as jlin
from jepsen_tpu import control as jcontrol
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jm
from jepsen_tpu_torch import cli as tcli
from jepsen_tpu_torch import control as tcontrol
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import store as tstore

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SUITES = ("etcdemo", "etcd", "zookeeper", "consul", "logcabin", "disque",
          "raftis", "rethinkdb", "tidb", "aerospike")
KNOBS = ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
         "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_SHRINK", "JEPSEN_TPU_EXPLAIN",
         "JEPSEN_TPU_LIN_DECOMPOSE", "JEPSEN_TPU_LIN_ALGORITHM",
         "JEPSEN_TPU_STREAM")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mods(name):
    """(the JAX package's suite, the port's suite)."""
    return (importlib.import_module(f"jepsen_tpu.suites.{name}"),
            importlib.import_module(f"jepsen_tpu_torch.suites.{name}"))


# ---------------------------------------------------------------------------
# the DBs' commands on a dummy remote
# ---------------------------------------------------------------------------


def _dummy(control, nodes, responses):
    r = control.DummyRemote(dict(responses))
    return {"nodes": list(nodes),
            "sessions": {n: control.Session(node=n, remote=r)
                         for n in nodes}}, r


_ARCHIVE = {"stat /": (1, "", "no"), "dirname": (0, "/opt", "")}

#: case -> (suite, nodes, canned responses, extra test keys, the steps,
#: substrings the port's command log must hold, as the JAX package's
#: tests/test_suites*.py assert)
DB_CASES = {
    "etcdemo": ("etcdemo", ("n1", "n2", "n3"), {
        **_ARCHIVE, "ls -A": (0, "etcd-v3.1.5-linux-amd64\n", "")}, {},
        lambda m, t: (m.db("v3.1.5").setup(t, "n1"),
                      m.db("v3.1.5").teardown(t, "n1")),
        ["etcd-v3.1.5-linux-amd64.tar.gz", "start-stop-daemon --start",
         "--initial-cluster n1=http://n1:2380", "killall -9 -w etcd",
         "rm -rf /opt/etcd"]),
    "zookeeper": ("zookeeper", ("n1", "n2", "n3"), {
        "dpkg": (0, "ii  zookeeper  3.4.13-2  all  coordination\n", ""),
        "apt-cache": (0, "  Installed: 3.4.13-2\n", "")}, {},
        lambda m, t: m.db().setup(t, "n2"),
        ["echo 1 > /etc/zookeeper/conf/myid", "server.0=n1:2888:3888",
         "service zookeeper restart"]),
    "consul": ("consul", ("n1", "n2", "n3"), {
        "getent": (0, "10.1.1.1  STREAM x\n", "")}, {},
        lambda m, t: (m.db().setup(t, "n1"), m.db().setup(t, "n2"),
                      m.db().teardown(t, "n1")),
        ["-bootstrap", "-join 10.1.1.1", "killall -9 consul"]),
    "disque": ("disque", ("n1", "n2", "n3"), {
        "stat /opt/disque": (1, "", "no"),
        "getent ahosts n1": (0, "10.0.0.1 STREAM n1\n", ""),
        "cluster meet": (0, "OK", "")}, {"barrier": "no-barrier"},
        lambda m, t: m.db("abc123").setup(t, "n2"),
        ["git clone", "git reset --hard abc123", "disque-server",
         "cluster meet 10.0.0.1 7711"]),
    "aerospike": ("aerospike", ("n1",), {
        "ls /tmp/packages": (0, "aerospike-server.deb\n"
                             "aerospike-tools.deb\n", ""),
        "asinfo -v roster:namespace=jepsen":
            (0, "roster=n1:pending_roster=n1:observed_nodes=n1", ""),
        "asinfo -v statistics":
            (0, "migrate_allowed=true;migrate_partitions_remaining=0", ""),
        "getent ahosts n1": (0, "10.0.0.1 STREAM n1\n", "")},
        {"barrier": "no-barrier"}, lambda m, t: m.db().setup(t, "n1"),
        ["dpkg -i --force-confnew", "service aerospike start",
         "roster-set:namespace=jepsen", "recluster"]),
    "rethinkdb": ("rethinkdb", ("n1",), {"apt-get install": (0, "", "")},
                  {}, lambda m, t: m.db("2.3.5~0jessie").setup(t, "n1"),
                  ["apt-key add", "/etc/rethinkdb/instances.d/jepsen.conf",
                   "service rethinkdb start"]),
    "tidb": ("tidb", ("n1",), {
        **_ARCHIVE, "ls -A": (0, "tidb-latest-linux-amd64\n", "")},
        {"barrier": "no-barrier"},
        lambda m, t: m.db("file:///tmp/tidb.tar.gz").setup(t, "n1"),
        ["pd-server", "tikv-server", "tidb-server",
         "--initial-cluster pd-n1=http://n1:2380"]),
    "etcd": ("etcd", ("n1",), {
        **_ARCHIVE, "ls -A": (0, "etcd-v2.1.1-linux-amd64\n", "")}, {},
        lambda m, t: m.db("v2.1.1").setup(t, "n1"),
        ["--initial-cluster n1=http://n1:2380", "start-stop-daemon"]),
    "logcabin": ("logcabin", ("n1",), {"stat /logcabin": (1, "", "no")},
                 {"barrier": "no-barrier"},
                 lambda m, t: m.db().setup(t, "n1"),
                 ["git clone", "scons", "--bootstrap", "Reconfigure"]),
    "raftis": ("raftis", ("n1",), {
        **_ARCHIVE, "ls -A": (0, "raftis\n", "")}, {},
        lambda m, t: m.db("v2.0.4").setup(t, "n1"), ["n1:8901"]),
}


@pytest.mark.parametrize("case", sorted(DB_CASES))
def test_db_commands_equal_reference(case, monkeypatch):
    name, nodes, responses, extra, steps, want = DB_CASES[case]
    monkeypatch.setattr(time, "sleep", lambda s: None)  # the join waits
    logs = []
    for mod, control in zip(_mods(name), (jcontrol, tcontrol)):
        test, r = _dummy(control, nodes, responses)
        test.update(extra)
        random.seed(case)
        steps(mod, test)
        logs.append(r.log)
    assert logs[1] == logs[0]
    cmds = [e[2] for e in logs[1] if e[1] == "exec"]
    for w in want:
        assert any(w in c for c in cmds), w
    if name == "tidb":  # dependency order: pd -> tikv -> tidb
        first = [min(i for i, c in enumerate(cmds)
                     if d in c and "start-stop-daemon" in c)
                 for d in ("pd-server", "tikv-server", "tidb-server")]
        assert first == sorted(first)


def test_db_log_files_equal_reference():
    jm_, tm_ = _mods("etcdemo")
    assert tm_.db().log_files({}, "n1") == jm_.db().log_files({}, "n1") \
        == ["/opt/etcd/etcd.log"]


# ---------------------------------------------------------------------------
# test maps
# ---------------------------------------------------------------------------

_BASE = {"nodes": ["n1", "n2", "n3"], "concurrency": 10, "time_limit": 1,
         "rate": 100}

#: case -> (suite, test function, opts)
MAP_CASES = {
    "etcdemo-register": ("etcdemo", "etcd_test",
                         {"workload": "register", "ops_per_key": 10}),
    "etcdemo-set": ("etcdemo", "etcd_test", {"workload": "set"}),
    "etcd": ("etcd", "etcd_test", {}),
    "zookeeper": ("zookeeper", "zk_test", {}),
    "consul": ("consul", "consul_test", {}),
    "logcabin": ("logcabin", "logcabin_test", {}),
    "disque": ("disque", "disque_test", {}),
    "raftis": ("raftis", "raftis_test", {}),
    "tidb-bank": ("tidb", "tidb_test", {"workload": "bank"}),
}
for _n in ("partitions", "reconfigure", "aggressive-reconfigure"):
    MAP_CASES[f"rethinkdb-{_n}"] = (
        "rethinkdb", "document_cas_test",
        {"nemesis": _n, "write_acks": "single", "read_mode": "outdated"})
for _w in ("register", "bank", "sets"):
    for _n in ("none", "parts", "startstop", "startkill"):
        MAP_CASES[f"tidb-{_w}-{_n}"] = ("tidb", "tidb_test",
                                        {"workload": _w, "nemesis": _n})
for _w in ("cas-register", "counter", "set"):
    MAP_CASES[f"aerospike-{_w}"] = ("aerospike", "aerospike_test",
                                    {"workload": _w})


def _shape(t):
    def name(x):
        return None if x is None else type(x).__name__

    model = t.get("model")
    return {
        "keys": sorted(t), "name": t["name"],
        "classes": {k: name(t.get(k))
                    for k in ("client", "nemesis", "db", "os", "net",
                              "checker", "generator")},
        "model": None if model is None else (model.name, model.init),
        "checkers": sorted(getattr(t["checker"], "checkers", {}) or {}),
        "scalars": {k: v for k, v in t.items()
                    if isinstance(v, (int, float, str, bool))
                    and k != "start_time"},
    }


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_test_maps_equal_reference(case):
    name, fn, opts = MAP_CASES[case]
    jmod, tmod = _mods(name)
    want = _shape(getattr(jmod, fn)(_BASE | opts))
    got = _shape(getattr(tmod, fn)(_BASE | opts))
    assert got == want
    if name in ("rethinkdb",):
        assert "w=single" in got["name"] and "r=outdated" in got["name"]


def test_suite_tables_equal_reference():
    for name, attrs in (("tidb", ("WORKLOADS", "NEMESES")),
                        ("rethinkdb", ("NEMESES",)),
                        ("aerospike", ("WORKLOADS",)),
                        ("etcdemo", ("WORKLOADS",))):
        jmod, tmod = _mods(name)
        for a in attrs:
            assert sorted(getattr(tmod, a)) == sorted(getattr(jmod, a)), a
    jmod, tmod = _mods("tidb")
    assert tmod.tidb_test({"workload": "bank", "nodes": ["n1"]})[
        "total_amount"] == 50


#: the suites' op functions (test, process) -> op dict
OP_FNS = {"etcdemo": ("r", "w", "cas"), "etcd": ("r", "w", "cas"),
          "zookeeper": ("r", "w", "cas"), "logcabin": ("r", "w", "cas"),
          "raftis": ("r", "w"),
          "rethinkdb": ("w", "r_read", "cas", "reconfigure_gen"),
          "aerospike": ("w", "kill_gen", "restart_gen", "revive_gen",
                        "recluster_gen")}


@pytest.mark.parametrize("name", sorted(OP_FNS))
def test_op_functions_equal_reference_under_one_seed(name):
    jmod, tmod = _mods(name)
    test = {"nodes": ["n1", "n2", "n3", "n4", "n5"], "concurrency": 5}
    for fn in OP_FNS[name]:
        ops = []
        for mod in (jmod, tmod):
            random.seed(fn)
            ops.append([getattr(mod, fn)(test, p) for p in range(12)])
        assert ops[1] == ops[0], fn


def test_etcdemo_register_generator_first_ops_equal_reference():
    """The tutorial's workload generator: ten threads a key over the
    naturals, the first 40 ops under one seed."""
    from jepsen_tpu import generator as jgen
    from jepsen_tpu_torch import generator as tgen

    jmod, tmod = _mods("etcdemo")
    test = {"nodes": ["n1", "n2", "n3"], "concurrency": 20}
    ops = []
    for mod, gen in ((jmod, jgen), (tmod, tgen)):
        g = mod.register_workload({"ops_per_key": 6})["generator"]
        random.seed(5)
        with gen.with_threads(list(range(20))):
            got = [gen.gen_op(g, test, p % 20) for p in range(40)]
        ops.append([(o["f"], o["value"].key, o["value"].value)
                    if o else None for o in got])
    assert ops[1] == ops[0]
    per_key = collections.Counter(k for _f, k, _v in ops[1])
    assert len(per_key) > 2 and max(per_key.values()) <= 6


# ---------------------------------------------------------------------------
# helpers, parsers and nemeses
# ---------------------------------------------------------------------------


def test_urls_and_cluster_strings_equal_reference():
    test = {"nodes": ["n1", "n2"]}
    calls = {"etcdemo": [("peer_url", "n1"), ("client_url", "n2"),
                         ("initial_cluster", test)],
             "etcd": [("peer_url", "n1"), ("initial_cluster", test)],
             "tidb": [("initial_cluster", test), ("pd_endpoints", test)],
             "logcabin": [("server_id", "n3"), ("server_addr", "n1"),
                          ("server_addrs", test)],
             "raftis": [("initial_cluster", test)],
             "zookeeper": [("zk_node_id", {"nodes": ["a", "b", "c"]}),
                           ("zoo_cfg_servers", {"nodes": ["a", "b", "c"]})],
             "rethinkdb": [("config", {"nodes": ["n1", "n2"]})]}
    for name, fns in calls.items():
        jmod, tmod = _mods(name)
        for fn, arg in fns:
            args = (arg, "b") if fn == "zk_node_id" else \
                (arg, "n1") if fn == "config" else (arg,)
            assert getattr(tmod, fn)(*args) == getattr(jmod, fn)(*args), fn
    _jm, tmod = _mods("etcdemo")
    assert tmod.initial_cluster(test) == "n1=http://n1:2380,n2=http://n2:2380"


def test_aerospike_parsers_and_config_equal_reference():
    jmod, tmod = _mods("aerospike")
    s = "migrate_allowed=true;migrate_partitions_remaining=0"
    assert tmod.parse_kv(s) == jmod.parse_kv(s)
    resp = "roster=A,B,C:pending_roster=A,B,C:observed_nodes=A,B,C"
    ros = []
    for mod, control in ((jmod, jcontrol), (tmod, tcontrol)):
        r = control.DummyRemote(
            {"asinfo -v roster:namespace=jepsen": (0, resp, "")})
        ros.append(mod.roster(control.Session(node="n1", remote=r)))
    assert ros[1] == ros[0] and ros[1]["roster"] == ["A", "B", "C"]
    for kw in ({"replication_factor": 3, "heartbeat_interval": 150,
                "commit_to_device": False},
               {"replication_factor": 2, "heartbeat_interval": 150,
                "commit_to_device": True}):
        assert tmod.config_template("10.0.0.1", "10.0.0.9", **kw) == \
            jmod.config_template("10.0.0.1", "10.0.0.9", **kw)
    for args in (({"a"}, "b", 1), ({"a"}, "b", 2), ({"a"}, "a", 1)):
        assert tmod.capped_conj(*args) == jmod.capped_conj(*args)


def test_aerospike_capped_kill_equals_reference():
    outs = []
    for mod, control, h in zip(_mods("aerospike"), (jcontrol, tcontrol),
                               (jh, th)):
        test, r = _dummy(control, ("n1", "n2", "n3"), {})
        nem = mod.KillNemesis(max_dead=1)
        random.seed(11)
        out = nem.invoke(test, h.Op(index=0, type="info", f="kill",
                                    value=["n1", "n2"], process="nemesis",
                                    time=0))
        killed = [n for n, v in out.value.items() if v == "killed"][0]
        out2 = nem.invoke(test, h.Op(index=1, type="info", f="restart",
                                     value=[killed], process="nemesis",
                                     time=0))
        outs.append((out.value, out2.value, sorted(nem.dead), r.log))
    assert outs[1] == outs[0]
    assert sorted(outs[1][0].values()) == ["killed", "still-alive"]


def test_aerospike_tla_spec_is_the_repos():
    """The port holds no copy of the spec; both packages' suites name the
    one under ``native/spec``."""
    src = (REPO / "native" / "spec" / "aerospike_cp.tla").read_text()
    assert "NoSplitBrain" in src and "Revive" in src
    assert not list((REPO / "jepsen_tpu_torch").rglob("*.tla"))


def test_rethinkdb_topology_and_grudge_equal_reference():
    nodes = ["n1", "n2", "n3", "n4", "n5"]
    outs = []
    for mod in _mods("rethinkdb"):
        random.seed(5)
        tops = [mod.random_topology(nodes) for _ in range(20)]
        grudges = [{k: sorted(v) for k, v in
                    mod.reconfigure_grudge(nodes, "n1").items()}
                   for _ in range(50)]
        outs.append((tops, grudges))
    assert outs[1] == outs[0]
    tops, grudges = outs[1]
    for primary, replicas in tops:
        assert primary in replicas and set(replicas) <= set(nodes)
    assert any(not g for g in grudges) and any(grudges)
    for g in filter(None, grudges):
        assert set(g) == set(nodes)
        for dst, srcs in g.items():
            assert dst not in srcs and 0 < len(srcs) < len(nodes)


def test_logcabin_cas_client_over_the_remote_equals_reference():
    outs = []
    for mod, control, h in zip(_mods("logcabin"), (jcontrol, tcontrol),
                               (jh, th)):
        test, r = _dummy(control, ("n1",), {})
        c = mod.CASClient().open(test, "n1")

        def op(f, value=None):
            return h.Op(index=0, type="invoke", f=f, value=value,
                        process=0, time=0)

        r.responses["read /jepsen"] = (0, json.dumps(4), "")
        a = c.invoke(test, op("read"))
        r.responses["write /jepsen"] = (
            1, "", "Exiting due to LogCabin::Client::Exception: Path "
            "'/jepsen' has value '3', not '4' as required")
        b = c.invoke(test, op("cas", (4, 5)))
        outs.append([(o.type, o.value, o.error) for o in (a, b)] + [r.log])
    assert outs[1] == outs[0]
    assert outs[1][0][:2] == ("ok", 4) and outs[1][1][0] == "fail"


# ---------------------------------------------------------------------------
# clients against in-process stand-ins of their servers' wire protocols
# ---------------------------------------------------------------------------


def _serve(make):
    """``make(port)`` on a port drawn below the ephemeral range, drawn
    again while taken; the server serves on a daemon thread."""
    rng = random.Random()
    while True:
        port = rng.randrange(20000, 32000)
        try:
            srv = make(port)
        except OSError:
            continue
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, port


class _Resp(socketserver.StreamRequestHandler):
    """RESP: raftis's GET/SET register (``no leader`` while the server is
    leaderless) and disque's ADDJOB/GETJOB/ACKJOB queue."""

    def handle(self):
        srv = self.server
        while True:
            line = self.rfile.readline()
            if not line or not line.startswith(b"*"):
                return
            args = []
            for _ in range(int(line[1:])):
                n = int(self.rfile.readline()[1:])
                args.append(self.rfile.read(n + 2)[:-2].decode())
            cmd = args[0].upper()
            with srv.lock:
                if cmd == "SET" and srv.leaderless:
                    out = b"-ERR no leader\r\n"
                elif cmd == "SET":
                    srv.kv[args[1]] = args[2]
                    out = b"+OK\r\n"
                elif cmd == "GET":
                    v = srv.kv.get(args[1])
                    out = b"$-1\r\n" if v is None else \
                        b"$%d\r\n%s\r\n" % (len(v), v.encode())
                elif cmd == "ADDJOB":
                    srv.jobs.append(args[2])
                    out = b"+D-jobid1\r\n"
                elif cmd == "GETJOB" and not srv.jobs:
                    out = b"*-1\r\n"
                elif cmd == "GETJOB":
                    body = srv.jobs.pop(0)
                    out = (f"*1\r\n*3\r\n$6\r\njepsen\r\n$5\r\njob-1\r\n"
                           f"${len(body)}\r\n{body}\r\n").encode()
                elif cmd == "ACKJOB":
                    srv.acked.append(args[1])
                    out = b":1\r\n"
                else:
                    out = b"-ERR unknown\r\n"
            self.wfile.write(out)


def _resp_server():
    def make(port):
        srv = socketserver.ThreadingTCPServer(("127.0.0.1", port), _Resp)
        srv.daemon_threads = True
        srv.kv, srv.jobs, srv.acked = {}, [], []
        srv.lock, srv.leaderless = threading.Lock(), False
        return srv

    return _serve(make)


def test_raftis_register_live_equals_reference(monkeypatch):
    outs = []
    for mod, h in zip(_mods("raftis"), (jh, th)):
        srv, port = _resp_server()
        monkeypatch.setattr(mod, "REDIS_PORT", port)
        try:
            c = mod.RegisterClient().open({}, "127.0.0.1")
            got = [c.invoke({}, h.invoke_op(0, f, v)) for f, v in
                   (("read", None), ("write", 42), ("read", None))]
            srv.leaderless = True
            got.append(c.invoke({}, h.invoke_op(0, "write", 1)))
            c.close({})
        finally:
            srv.shutdown()
            srv.server_close()
        outs.append([(o.type, o.value, o.error) for o in got])
    assert outs[1] == outs[0]
    assert [o[:2] for o in outs[1][:3]] == [("ok", None), ("ok", 42),
                                            ("ok", 42)]
    assert outs[1][3][0] == "fail" and "no leader" in outs[1][3][2]


def test_disque_client_roundtrip_equals_reference(monkeypatch):
    outs = []
    for mod, h in zip(_mods("disque"), (jh, th)):
        srv, port = _resp_server()
        monkeypatch.setattr(mod, "PORT", port)
        try:
            c = mod.DisqueClient().open({"nodes": ["127.0.0.1"]},
                                        "127.0.0.1")
            c.conn = mod.RespConn("127.0.0.1", port)
            got = [c.invoke({}, h.invoke_op(0, f, v)) for f, v in
                   (("enqueue", 42), ("dequeue", None), ("dequeue", None),
                    ("enqueue", 7), ("drain", None))]
            c.close({})
        finally:
            srv.shutdown()
            srv.server_close()
        outs.append(([(o.type, o.value) for o in got], srv.acked))
    assert outs[1] == outs[0]
    assert outs[1][0] == [("ok", 42), ("ok", 42), ("fail", None),
                          ("ok", 7), ("ok", [7])]
    assert outs[1][1] == ["job-1", "job-1"]


def _gateways(n, **kw):
    """``n`` etcd gateway stand-ins on 127.0.0.1 (one store): (servers,
    node -> port)."""
    while True:
        ports = [random.randrange(20000, 32000) for _ in range(n)]
        try:
            servers = chip_smoke.etcd_gateways(
                [("127.0.0.1", p) for p in ports], **kw)
        except OSError:
            continue
        return servers, {f"n{i + 1}": p for i, p in enumerate(ports)}


def test_etcd_v3_gateway_live_equals_reference(monkeypatch):
    outs = []
    for mod, h, ind in zip(_mods("etcdemo"), (jh, th), (jind, tind)):
        servers, ports = _gateways(1, latency=0)
        monkeypatch.setattr(mod, "client_url",
                            lambda node: f"http://127.0.0.1:{ports['n1']}")
        kv = ind.tuple_
        try:
            c = mod.EtcdClient().open({}, "n1")
            got = [c.invoke({}, h.invoke_op(0, f, kv(5, v))) for f, v in
                   (("read", None), ("write", 3), ("read", None),
                    ("cas", (3, 4)), ("cas", (9, 1)), ("read", None))]
        finally:
            chip_smoke.stop_gateways(servers)
        outs.append([(o.type, o.value.key, o.value.value) for o in got])
    assert outs[1] == outs[0]
    assert [t for t, _k, _v in outs[1]] == ["ok", "ok", "ok", "ok", "fail",
                                            "ok"]
    assert [outs[1][i][2] for i in (0, 2, 5)] == [None, 3, 4]


def test_etcd_client_down_maps_to_info_or_fail(monkeypatch):
    """Nothing listens: reads complete :fail, writes :info."""
    outs = []
    with socket.socket() as s:  # a port nothing listens on
        while True:
            port = random.randrange(20000, 32000)
            try:
                s.bind(("127.0.0.1", port))
                break
            except OSError:
                continue
        for mod, h, ind in zip(_mods("etcdemo"), (jh, th), (jind, tind)):
            monkeypatch.setattr(mod, "client_url",
                                lambda node: f"http://127.0.0.1:{port}")
            c = mod.EtcdClient().open({}, "n1")
            outs.append([c.invoke({}, h.invoke_op(0, f, ind.tuple_(1, v)))
                         .type for f, v in (("read", None), ("write", 2))])
    assert outs[1] == outs[0] == ["fail", "info"]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SUITES)
def test_main_exit_codes_equal_reference(name, capsys):
    codes = []
    for mod in _mods(name):
        for argv in (["test", "--no-such-flag"], ["nosuch"]):
            with pytest.raises(SystemExit) as e:
                mod.main(argv)
            codes.append(e.value.code)
    capsys.readouterr()
    assert codes[2:] == codes[:2] == [tcli.EXIT_BAD_ARGS] * 2


def test_etcdemo_bad_workload_is_a_bad_argument(capsys):
    jmod, tmod = _mods("etcdemo")
    from jepsen_tpu import cli as jcli

    rcs = [cli.run(cli.single_test_cmd(mod.etcd_test,
                                       add_opts=mod.add_opts),
                   ["test", "-w", "nope"])
           for mod, cli in ((jmod, jcli), (tmod, tcli))]
    capsys.readouterr()
    assert rcs == [tcli.EXIT_BAD_ARGS] * 2


def test_dummy_responses_file_feeds_the_dummy_remote(tmp_path):
    p = tmp_path / "r.json"
    p.write_text(json.dumps({"stat /tmp": [1, "", "no"], "ls": "a\n"}))
    got = tcli.load_dummy_responses(str(p))
    assert got == {"stat /tmp": (1, "", "no"), "ls": "a\n"}
    for bad in ("[1, 2]", '{"x": [1, 2]}', '{"x": 3}', "{"):
        p.write_text(bad)
        with pytest.raises(ValueError, match="--dummy-responses"):
            tcli.load_dummy_responses(str(p))


# ---------------------------------------------------------------------------
# whole etcdemo register runs through the command line, on the CPU
# ---------------------------------------------------------------------------


def _to_ref(history):
    """The port's stored events as the JAX package's, ``[k v]`` values
    lifted back to its tuples."""
    out = []
    for op in history:
        v = op.value
        if isinstance(op.process, int):
            kv = chip_smoke.stored_kv(v)
            v = jind.tuple_(kv.key, kv.value)
        out.append(jh.Op(process=op.process, type=op.type, f=op.f, value=v,
                         time=op.time, index=op.index, error=op.error))
    return out


@pytest.mark.parametrize("stale", [False, True])
def test_etcdemo_register_run_on_the_cpu(stale, tmp_path, monkeypatch):
    """Three gateways share one store; with ``stale`` the third answers
    reads from a lagging copy.  The setup's 10 s join wait is patched out
    here (the suite keeps it); the 10 s recovery wait stays."""
    from jepsen_tpu_torch.suites import etcdemo

    class _NoWait:
        sleep = staticmethod(lambda s: None)

    monkeypatch.setattr(etcdemo, "time", _NoWait)
    servers, ports = _gateways(3, stale_last=stale)
    monkeypatch.setattr(etcdemo, "client_url",
                        lambda node: f"http://127.0.0.1:{ports[node]}")
    responses = tmp_path / "dummy-responses.json"
    responses.write_text(json.dumps(chip_smoke.ETCD_DUMMY_RESPONSES))
    monkeypatch.chdir(tmp_path)
    random.seed(f"etcdemo-{stale}")
    try:
        rc = tcli.run(tcli.single_test_cmd(etcdemo.etcd_test,
                                           add_opts=etcdemo.add_opts),
                      ["test", "--dummy", "--dummy-responses",
                       str(responses), "--device", "cpu", "-n", "n1", "-n",
                       "n2", "-n", "n3", "--time-limit", "1",
                       "--concurrency", "10", "--ops-per-key", "40"])
    finally:
        chip_smoke.stop_gateways(servers)
    run = tstore.latest(str(tmp_path / "store"))
    res = run["results"]
    keys = res["workload"]["results"]
    invalid = {k for k, r in keys.items() if r["linear"]["valid"] is False}
    assert rc == (tcli.EXIT_INVALID if stale else tcli.EXIT_OK)
    assert res["valid"] is (not stale) and len(keys) >= 2
    assert bool(invalid) is stale
    starts = [op for op in run["history"]
              if op.process == "nemesis" and op.f == "stop"]
    assert starts  # the heal after the main phase
    want = jind.checker(jlin.linearizable(jm.cas_register())).check(
        {"name": None}, _to_ref(run["history"]))
    assert {str(k): r["valid"] for k, r in want["results"].items()} == \
        {k: r["linear"]["valid"] for k, r in keys.items()}
