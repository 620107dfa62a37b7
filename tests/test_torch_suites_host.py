"""The port's suites whose checkers run on the host against the JAX
package's: ``chronos``, ``rabbitmq``, ``robustirc``, ``galera``,
``percona``, ``postgres_rds``, ``crate``, ``elasticsearch``, ``dgraph``
and ``mysql_cluster``.

The same inputs go through both packages and must give the same answer:
a DB's commands on a ``DummyRemote`` (the whole log, under one seeded
``random``), the test maps, the op functions and generators under one
seed, the helpers' strings and parsers, the clients' error mapping, the
command line's exit codes, and the suites' checkers on the same
histories (crate's and dgraph's lifted ones, chronos's schedule)."""

import importlib
import json
import random
import time

import pytest
import torch

from jepsen_tpu import control as jcontrol
from jepsen_tpu import generator as jgen
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu_torch import cli as tcli
from jepsen_tpu_torch import control as tcontrol
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind

SUITES = ("chronos", "rabbitmq", "robustirc", "galera", "percona",
          "postgres_rds", "crate", "elasticsearch", "dgraph",
          "mysql_cluster")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mods(name):
    """(the JAX package's suite, the port's suite)."""
    return (importlib.import_module(f"jepsen_tpu.suites.{name}"),
            importlib.import_module(f"jepsen_tpu_torch.suites.{name}"))


def _dummy(control, nodes, responses):
    r = control.DummyRemote(dict(responses))
    return {"nodes": list(nodes),
            "sessions": {n: control.Session(node=n, remote=r)
                         for n in nodes}}, r


# ---------------------------------------------------------------------------
# the DBs' commands on a dummy remote (tests/test_suites*.py,
# tests/test_dirty.py :94-153)
# ---------------------------------------------------------------------------

_ARCHIVE = {"stat /": (1, "", "no"), "dirname": (0, "/opt", "")}
_NO_BARRIER = {"barrier": "no-barrier"}


def _polled_setup(wait):
    """Setup and teardown on n1 with the DB's health poll (an HTTP
    request to the node) answered at once."""
    def steps(m, t):
        db = m.db()
        setattr(db, wait, lambda *a, **kw: None)
        db.setup(t, "n1")
        db.teardown(t, "n1")

    return steps


#: case -> (suite, nodes, canned responses, extra test keys, the steps,
#: substrings the port's command log must hold, as the JAX package's
#: tests assert)
DB_CASES = {
    "chronos": ("chronos", ("n1", "n2", "n3"), {
        "stat /etc/apt/sources.list.d/mesosphere.list": (1, "", "no"),
        "service chronos status": (1, "", "not running"),
        "dpkg-query": (1, "", "")}, {},
        lambda m, t: (m.db().setup(t, "n1"), m.db().teardown(t, "n1")),
        ["repos.mesosphere.io", "--quorum=2",
         "zk://n1:2181,n2:2181,n3:2181/mesos", "schedule_horizon",
         "service chronos start"]),
    "rabbitmq": ("rabbitmq", ("n1", "n2"), {"dpkg": (0, "", "")}, {},
                 lambda m, t: (m.db().setup(t, "n2"),
                               m.db().teardown(t, "n2")),
                 ["rabbitmqctl join_cluster rabbit@n1"]),
    "robustirc": ("robustirc", ("n1", "n2"), {}, _NO_BARRIER,
                  lambda m, t: (m.db().setup(t, "n1"),
                                m.db().setup(t, "n2"),
                                m.db().teardown(t, "n2")),
                  ["-singlenode", "-join=n1:13001"]),
    "galera": ("galera", ("n1",), {"stat /": (1, "", "no")}, {},
               lambda m, t: (m.db().setup(t, "n1"),
                             m.db().teardown(t, "n1")),
               ["debconf-set-selections", "wsrep_cluster_address=gcomm://n1",
                "service mysql start --wsrep-new-cluster",
                "GRANT ALL PRIVILEGES"]),
    "percona-primary": ("percona", ("n1", "n2"), {
        "dpkg-query": (1, "", "not installed"),
        "apt-get install": (0, "", "")}, _NO_BARRIER,
        lambda m, t: (m.db("5.6.25-25.12-1.jessie").setup(t, "n1"),
                      m.db().teardown(t, "n1")),
        ["debconf-set-selections", "service mysql start bootstrap-pxc",
         "create database if not exists jepsen"]),
    "percona-joiner": ("percona", ("n1", "n2"), {
        "dpkg-query": (1, "", "not installed")}, _NO_BARRIER,
        lambda m, t: m.db("5.6.25-25.12-1.jessie").setup(t, "n2"),
        ["service mysql start"]),
    "crate": ("crate", ("n1", "n2", "n3"), {
        **_ARCHIVE, "ls -A": (0, "crate-0.54.9\n", ""),
        "id -u": (1, "", "no such user")}, _NO_BARRIER,
        _polled_setup("wait_green"),
        ["vm.max_map_count=262144", "bin/crate", "crate.yml"]),
    "elasticsearch": ("elasticsearch", ("n1", "n2", "n3"), {
        **_ARCHIVE, "ls -A": (0, "elasticsearch-5.0.0\n", ""),
        "id -u": (1, "", "no such user")}, {},
        _polled_setup("wait_healthy"),
        ["vm.max_map_count=262144", "start-stop-daemon --start"]),
    "dgraph": ("dgraph", ("n1", "n2"), {
        **_ARCHIVE, "ls -A": (0, "dgraph\n", "")}, _NO_BARRIER,
        lambda m, t: (m.db().setup(t, "n2"), m.db().teardown(t, "n2")),
        ["--peer n1:5080", "--zero n2:5080"]),
    "mysql_cluster": ("mysql_cluster", ("n1",), {}, _NO_BARRIER,
                      lambda m, t: (m.db("7.4.6").setup(t, "n1"),
                                    m.db("7.4.6").teardown(t, "n1")),
                      ["ndb_mgmd", "/bin/ndbd", "mysqld_safe"]),
}


@pytest.mark.parametrize("case", sorted(DB_CASES))
def test_db_commands_equal_reference(case, monkeypatch):
    from jepsen_tpu.util import AbortableBarrier as JBarrier
    from jepsen_tpu_torch.util import AbortableBarrier as TBarrier

    name, nodes, responses, extra, steps, want = DB_CASES[case]
    monkeypatch.setattr(time, "sleep", lambda s: None)  # the setup waits
    logs = []
    for mod, control, barrier in zip(_mods(name), (jcontrol, tcontrol),
                                     (JBarrier, TBarrier)):
        test, r = _dummy(control, nodes, responses)
        test.update(extra)
        if name == "galera":
            test["barrier"] = barrier(1)
        random.seed(case)
        steps(mod, test)
        logs.append(r.log)
    assert logs[1] == logs[0]
    cmds = [e[2] for e in logs[1] if e[1] == "exec"]
    for w in want:
        assert any(w in c for c in cmds), w
    if name == "mysql_cluster":  # start order: mgmd -> ndbd -> mysqld
        first = [min(i for i, c in enumerate(cmds) if d in c)
                 for d in ("ndb_mgmd", "/bin/ndbd", "mysqld_safe")]
        assert first == sorted(first)
    if case == "percona-joiner":
        assert not any("bootstrap" in c for c in cmds)


@pytest.mark.parametrize("name", ["chronos", "galera", "percona", "crate",
                                  "elasticsearch", "dgraph",
                                  "mysql_cluster"])
def test_db_log_files_equal_reference(name):
    jmod, tmod = _mods(name)
    test = {"nodes": ["n1", "n2"]}
    assert tmod.db().log_files(test, "n1") == jmod.db().log_files(test,
                                                                  "n1")


# ---------------------------------------------------------------------------
# test maps
# ---------------------------------------------------------------------------


def _shape(t):
    def name(x):
        return None if x is None else type(x).__name__

    model = t.get("model")
    checkers = getattr(t.get("checker"), "checkers", None)
    return {
        "keys": sorted(t), "name": t["name"],
        "classes": {k: name(t.get(k))
                    for k in ("client", "nemesis", "db", "os", "net",
                              "checker", "generator")},
        "model": None if model is None else (
            type(model).__name__, getattr(model, "name", None),
            repr(getattr(model, "init", None))),
        "checkers": {k: name(v) for k, v in (checkers or {}).items()},
        "scalars": {k: v for k, v in t.items()
                    if isinstance(v, (int, float, str, bool))
                    and k != "start_time"},
    }


_BASE = {"nodes": ["n1", "n2", "n3"], "concurrency": 6, "time_limit": 1}

#: case -> (suite, test function, opts)
MAP_CASES = {
    "chronos": ("chronos", "chronos_test", {}),
    "rabbitmq": ("rabbitmq", "rabbit_test", {}),
    "robustirc": ("robustirc", "sets_test", {}),
    "percona-update": ("percona", "bank_test", {}),
    "percona-share": ("percona", "bank_test", {"lock_type": "share",
                                               "in_place": True}),
    "postgres_rds": ("postgres_rds", "bank_test", {"accounts": 7}),
    "mysql_cluster": ("mysql_cluster", "simple_test", {}),
}
for _w in ("dirty-reads", "set"):
    MAP_CASES[f"galera-{_w}"] = ("galera", "galera_test", {"workload": _w})
for _w in ("version-divergence", "lost-updates", "dirty-read"):
    MAP_CASES[f"crate-{_w}"] = ("crate", "crate_test", {"workload": _w})
for _w in ("dirty-read", "set"):
    MAP_CASES[f"elasticsearch-{_w}"] = ("elasticsearch", "es_test",
                                        {"workload": _w})
for _w in ("bank", "upsert", "set", "sequential", "delete"):
    MAP_CASES[f"dgraph-{_w}"] = ("dgraph", "dgraph_test", {"workload": _w})


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_test_maps_equal_reference(case):
    name, fn, opts = MAP_CASES[case]
    jmod, tmod = _mods(name)
    want = _shape(getattr(jmod, fn)(_BASE | opts))
    got = _shape(getattr(tmod, fn)(_BASE | opts))
    assert got == want
    if "workload" in opts:
        assert opts["workload"] in got["name"]


def test_suite_tables_and_clients_equal_reference():
    for name, attrs in (("galera", ("WORKLOADS",)),
                        ("crate", ("TESTS",)),
                        ("elasticsearch", ("WORKLOADS",)),
                        ("dgraph", ("WORKLOADS",))):
        jmod, tmod = _mods(name)
        for a in attrs:
            assert sorted(getattr(tmod, a)) == sorted(getattr(jmod, a)), a
    jmod, tmod = _mods("percona")
    for lock in ("share", "update"):
        ts = [m.bank_test({"lock_type": lock, "nodes": ["n1"]})
              for m in (jmod, tmod)]
        assert [(t["client"].lock_type, t["client"].n, t["total_amount"])
                for t in ts][1] == \
            [(t["client"].lock_type, t["client"].n, t["total_amount"])
             for t in ts][0]
    t = tmod.bank_test({"lock_type": "share", "nodes": ["n1"]})
    assert "share-lock" in t["name"]
    assert t["client"].lock_type == " LOCK IN SHARE MODE"
    assert t["total_amount"] == 50
    from jepsen_tpu_torch import nemesis as tnem

    _j, trds = _mods("postgres_rds")
    t = trds.bank_test({"nodes": ["rds.example.com"], "time_limit": 1})
    assert t["nemesis"] is tnem.noop and t["client"].n == 5
    _j, tgal = _mods("galera")
    assert isinstance(tgal.galera_test({"workload": "dirty-reads",
                                        "nodes": ["n1"]})["client"],
                      tgal.DirtyReadsClient)
    _j, tes = _mods("elasticsearch")
    assert isinstance(tes.es_test({"workload": "dirty-read",
                                   "nodes": ["n1"]})["client"],
                      tes.DirtyReadClient)


# ---------------------------------------------------------------------------
# helpers, parsers and generators
# ---------------------------------------------------------------------------


def test_helpers_and_config_strings_equal_reference():
    three = {"nodes": ["n1", "n2", "n3"]}
    five = {"nodes": ["n1", "n2", "n3", "n4", "n5"]}
    calls = {
        "chronos": [("zk_uri", (three,)), ("masters",
                                           ({"nodes": ["n5", "n1", "n3",
                                                       "n2", "n4"]},)),
                    ("interval_str", ({"name": "3", "start": 0.0,
                                       "count": 5, "duration": 2,
                                       "epsilon": 11, "interval": 30},)),
                    ("job_json", ({"name": "3", "start": 0.0, "count": 5,
                                   "duration": 2, "epsilon": 11,
                                   "interval": 30},)),
                    ("parse_file_time", ("2026-07-29T10:00:00,500000+00:00",)),
                    ("parse_file_time", ("garbage",)),
                    ("parse_run_file", ("n1", "7\n2026-07-29T10:00:00,500000"
                                        "+00:00\n2026-07-29T10:00:02.500000"
                                        "+00:00\n")),
                    ("parse_run_file", ("n2", "8\n2026-07-29T10:00:00"))],
        "robustirc": [("daemon_cmd", ("n1",), {"singlenode": True}),
                      ("daemon_cmd", ("n2",), {"join": "n1"}),
                      ("parse_topic",
                       ({"Data": ":n1!j@x TOPIC #jepsen :42"},)),
                      ("parse_topic", ({"Data": "PRIVMSG #jepsen :42"},)),
                      ("parse_topic", ({"Data": "PING"},))],
        "galera": [("apt_line", ("10.0",)), ("cluster_address", (three,))],
        "percona": [("cluster_address", (three, "n1")),
                    ("cluster_address", (three, "n2")),
                    ("config_cnf", (three, "n2"))],
        "crate": [("config_yml", (three, "n2"))],
        "elasticsearch": [("config_yml", (three, "n2"))],
        "dgraph": [("node_idx", (three, "n3"))],
        "mysql_cluster": [("mgmd_node_id", (five, "n1")),
                          ("ndbd_node_id", (five, "n2")),
                          ("mysqld_node_id", (five, "n5")),
                          ("ndbd_nodes", (five,)), ("nodes_conf", (five,)),
                          ("ndb_connect_string", (five,)),
                          ("my_cnf", (five, "n2")), ("config_ini", (five,))],
    }
    for name, fns in calls.items():
        jmod, tmod = _mods(name)
        for call in fns:
            fn, args = call[0], call[1]
            kw = call[2] if len(call) > 2 else {}
            assert getattr(tmod, fn)(*args, **kw) == \
                getattr(jmod, fn)(*args, **kw), (name, fn)
    _j, tchr = _mods("chronos")
    assert tchr.masters({"nodes": ["n5", "n1", "n3", "n2", "n4"]}) == \
        ["n1", "n2", "n3"]
    run = tchr.parse_run_file("n1", calls["chronos"][6][1][1])
    assert run["name"] == "7" and run["end"] - run["start"] == 2.0
    _j, tirc = _mods("robustirc")
    assert tirc.parse_topic({"Data": ":n1!j@x TOPIC #jepsen :42"}) == 42
    _j, tmc = _mods("mysql_cluster")
    assert tmc.nodes_conf(five).count("[ndbd]") == 4
    _j, tcr = _mods("crate")
    assert 'discovery.zen.minimum_master_nodes: 2' in \
        tcr.config_yml(three, "n2")


def test_robustirc_message_id_equals_reference():
    import hashlib

    jmod, tmod = _mods("robustirc")
    for msg in ("TOPIC #jepsen :1", "TOPIC #jepsen :2", ""):
        random.seed(msg)
        a = jmod.message_id(msg)
        random.seed(msg)
        b = tmod.message_id(msg)
        assert a == b
        tail = int(hashlib.md5(msg.encode()).hexdigest()[17:], 16)
        assert b & tail == tail


def test_generators_equal_reference_under_one_seed(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    test = {"nodes": ["n1", "n2"], "concurrency": 4}
    outs = []
    for name_mods in zip(*(_mods(n) for n in ("chronos", "galera",
                                              "elasticsearch"))):
        chronos, galera, es = name_mods
        gen = jgen if chronos.__name__.startswith("jepsen_tpu.") else tgen
        random.seed(7)
        g = chronos.AddJobGen()
        jobs = [g.op({}, 0) for _ in range(20)]
        g = galera.dirty_reads_generator()
        dirty = [gen.gen_op(g, test, p % 4) for p in range(20)]
        g = galera.set_generator()
        sets = [gen.gen_op(g, test, p % 4) for p in range(10)]
        g = es.RWGen(writers=1)
        with gen.with_threads([0, 1, 2, 3]):
            rw = [g.op(test, p) for p in (0, 2, 0, 1, 3, 0, 2)]
        outs.append((jobs, dirty, sets, rw))
    assert outs[1] == outs[0]
    jobs, dirty, sets, rw = outs[1]
    from jepsen_tpu_torch.checker.schedule import EPSILON_FORGIVENESS

    for op in jobs:
        v = op["value"]
        assert v["interval"] > v["duration"] + v["epsilon"] + \
            EPSILON_FORGIVENESS
    writes = [o["value"] for o in dirty if o["f"] == "write"]
    assert writes == sorted(writes) and len(set(writes)) == len(writes)
    assert rw[0] == {"type": "invoke", "f": "write", "value": 0}
    assert rw[1]["f"] == "read" and rw[1]["value"] == 0


def test_bank_ops_equal_reference_under_one_seed():
    from jepsen_tpu import bank as jbank
    from jepsen_tpu_torch import bank as tbank

    outs = []
    for bank in (jbank, tbank):
        random.seed(11)
        ops = [bank.bank_transfer(5)({}, p) for p in range(20)]
        outs.append((ops, bank.bank_read({}, 0)))
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# clients: error mapping without the servers
# ---------------------------------------------------------------------------


def test_chronos_crashed_ops_map_as_reference(monkeypatch):
    """A crashed add-job completes ``info`` (it may have applied), a
    crashed read ``fail``, in both packages."""
    import urllib.error

    outs = []
    for mod, h in zip(_mods("chronos"), (jh, th)):
        def boom(*a, **kw):
            raise urllib.error.URLError("connection refused")

        def read_boom(_test):
            raise OSError("ssh down")

        monkeypatch.setattr(mod.urllib.request, "urlopen", boom)
        monkeypatch.setattr(mod, "read_runs", read_boom)
        c = mod.ChronosClient().open({}, "n1")
        job = {"name": "j1", "start": 10.0, "count": 5, "interval": 60,
               "epsilon": 15, "duration": 5}
        got = [c.invoke({}, h.Op(process=0, type="invoke", f=f, value=v))
               for f, v in (("add-job", job), ("read", None))]
        outs.append([(o.type, o.error) for o in got])
    assert outs[1] == outs[0]
    assert [t for t, _e in outs[1]] == ["info", "fail"]


def test_chronos_read_runs_over_the_remote_equals_reference():
    outs = []
    for mod, control in zip(_mods("chronos"), (jcontrol, tcontrol)):
        test, r = _dummy(control, ("n1",), {
            "ls -A /tmp/chronos-test/": (0, "a\nb\n", ""),
            "cat /tmp/chronos-test/a": (0, "1\n2026-07-29T10:00:00+00:00\n"
                                        "2026-07-29T10:00:03+00:00\n", ""),
            "cat /tmp/chronos-test/b": (0, "2\n\n", "")})
        outs.append((mod.read_runs(test), r.log))
    assert outs[1] == outs[0]


def test_resurrection_hub_equals_reference():
    outs = []
    for mod, control, h in zip(_mods("chronos"), (jcontrol, tcontrol),
                               (jh, th)):
        test, r = _dummy(control, ("n1", "n2", "n3"), {})
        nem = mod.ResurrectionHub(type("N", (), {
            "setup": lambda self, t: self, "teardown": lambda self, t: None,
            "invoke": lambda self, t, op: op})())
        out = nem.invoke(test, h.Op(process="nemesis", type="info",
                                    f="resurrect", value=None))
        # the nodes revive on threads of their own: per node, in order
        outs.append((out.type, out.value,
                     {n: [e for e in r.log if e[0] == n]
                      for n in test["nodes"]}))
    assert outs[1] == outs[0]
    assert outs[1][1] == "resurrection-complete"


# ---------------------------------------------------------------------------
# the suites' checkers on the same histories
# ---------------------------------------------------------------------------


def _op(h, **kw):
    base = dict(index=0, type="ok", f="read", value=None, process=0,
                time=0)
    base.update(kw)
    return h.Op(**base)


def _histories(h):
    """name -> (checker maker's suite and name, history)."""
    good = [_op(h, index=0, value={"value": 1, "_version": 1}),
            _op(h, index=1, value={"value": 1, "_version": 1}),
            _op(h, index=2, value={"value": 2, "_version": 2})]
    ups = [_op(h, index=0, f="upsert", value="0x1"),
           _op(h, index=1, f="read", value=["0x1"])]
    dels = [_op(h, index=0, value=[5]), _op(h, index=1, value=[])]
    return {
        "crate-multiversion-good": ("crate", "multiversion_checker", good),
        "crate-multiversion-bad": (
            "crate", "multiversion_checker",
            good + [_op(h, index=3, value={"value": 9, "_version": 2})]),
        "dgraph-upsert-good": ("dgraph", "upsert_checker", ups),
        "dgraph-upsert-two-ok": (
            "dgraph", "upsert_checker",
            ups + [_op(h, index=2, f="upsert", value="0x2")]),
        "dgraph-upsert-multi-read": (
            "dgraph", "upsert_checker",
            ups + [_op(h, index=3, f="read", value=["0x1", "0x2"])]),
        "dgraph-delete-good": ("dgraph", "delete_checker", dels),
        "dgraph-delete-bad": ("dgraph", "delete_checker",
                              dels + [_op(h, index=2, value=[5, 5])]),
    }


@pytest.mark.parametrize("case", sorted(_histories(th)))
def test_suite_checkers_equal_reference(case):
    outs = []
    for h, i in ((jh, 0), (th, 1)):
        name, maker, hist = _histories(h)[case]
        ch = getattr(_mods(name)[i], maker)()
        outs.append(ch.check({}, hist))
    assert outs[1] == outs[0]
    assert outs[1]["valid"] is case.endswith("good")


def _keyed(h, ind, key_values):
    """A lifted history: per key, ``(f, type, value)`` events of one
    process each."""
    out = []
    for k, events in key_values.items():
        for p, (f, typ, v) in enumerate(events):
            out.append(h.Op(process=p, type=typ, f=f,
                            value=ind.tuple_(k, v), time=len(out),
                            index=len(out)))
    return out


def test_crate_lost_updates_lifted_checker_equals_reference(tmp_path):
    """crate's lost-updates composition (an independent set checker per
    key) on a keyed history with one lost add."""
    outs = []
    for mod, h, ind in zip(_mods("crate"), (jh, th), (jind, tind)):
        t = mod.crate_test({"workload": "lost-updates", "nodes": ["n1"]})
        hist = _keyed(h, ind, {
            0: [("add", "invoke", 1), ("add", "ok", 1),
                ("add", "invoke", 2), ("add", "ok", 2),
                ("read", "invoke", None), ("read", "ok", [1, 2])],
            1: [("add", "invoke", 3), ("add", "ok", 3),
                ("read", "invoke", None), ("read", "ok", [])]})
        res = t["checker"].check({"name": "crate", "start_time": "t",
                                  "store_base": str(tmp_path)}, hist)
        outs.append((res["valid"], {str(k): v["valid"] for k, v in
                                    res["set"]["results"].items()}))
    assert outs[1] == outs[0]
    assert outs[1][0] is False and outs[1][1]["1"] is False


def test_dgraph_sequential_checker_fault_kept_from_reference(tmp_path):
    """A reference fault the port copies: dgraph's sequential workload
    lifts ``extra.monotonic``, which reads a final list of rows, over a
    client whose reads complete with one count per key, so every key's
    check raises ``TypeError`` and the run is "unknown" in both
    packages."""
    outs = []
    for mod, h, ind in zip(_mods("dgraph"), (jh, th), (jind, tind)):
        t = mod.dgraph_test({"workload": "sequential", "nodes": ["n1"]})
        hist = _keyed(h, ind, {
            0: [("inc", "invoke", None), ("inc", "ok", 1),
                ("read", "invoke", None), ("read", "ok", 1)],
            1: [("read", "invoke", None), ("read", "ok", 2),
                ("read", "invoke", None), ("read", "ok", 1)]})
        res = t["checker"].check({"name": "dgraph", "start_time": "t",
                                  "store_base": str(tmp_path)}, hist)
        per_key = res["workload"]["results"]
        outs.append((res["valid"], res["workload"]["valid"],
                     {str(k): (r["valid"], r["error"].splitlines()[-1])
                      for k, r in per_key.items()}))
    assert outs[1] == outs[0]
    assert outs[1][:2] == ("unknown", "unknown")
    assert all(err.startswith("TypeError") for _v, err in
               outs[1][2].values())


def test_chronos_schedule_checker_equals_reference(tmp_path):
    """A job that ran on time, and one whose run is missing."""
    outs = []
    for mod, h in zip(_mods("chronos"), (jh, th)):
        job = {"name": "1", "start": 100.0, "count": 2, "duration": 1,
               "epsilon": 10, "interval": 40}
        job2 = dict(job, name="2")
        runs = [{"node": "n1", "name": "1", "start": 101.0, "end": 102.0},
                {"node": "n1", "name": "1", "start": 141.0, "end": 142.0},
                {"node": "n2", "name": "2", "start": 101.0, "end": 102.0}]
        hist = [h.Op(process=0, type="invoke", f="add-job", value=job,
                     time=0, index=0),
                h.Op(process=0, type="ok", f="add-job", value=job, time=1,
                     index=1),
                h.Op(process=1, type="invoke", f="add-job", value=job2,
                     time=2, index=2),
                h.Op(process=1, type="ok", f="add-job", value=job2, time=3,
                     index=3),
                h.Op(process=0, type="invoke", f="read", value=None,
                     time=200 * 10**9, index=4),
                h.Op(process=0, type="ok", f="read", value=runs,
                     time=200 * 10**9, index=5)]
        t = mod.chronos_test({"nodes": ["n1", "n2", "n3"]})
        res = t["checker"].checkers["schedule"].check(
            {"name": "chronos", "start_time": 0,
             "store_base": str(tmp_path)}, hist)
        outs.append(json.dumps(res, sort_keys=True, default=repr))
    assert outs[1] == outs[0]
    res = json.loads(outs[1])
    assert res["valid"] is False and res["jobs"]["1"]["valid"] is True
    assert res["jobs"]["2"]["valid"] is False


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


@pytest.mark.parametrize("name", ["galera", "crate", "elasticsearch",
                                  "dgraph"])
def test_bad_workload_is_a_bad_argument_as_reference(name, capsys):
    codes = []
    for mod in _mods(name):
        with pytest.raises(SystemExit) as e:
            mod.main(["test", "--workload", "nope"])
        codes.append(e.value.code)
    capsys.readouterr()
    assert codes[1] == codes[0] == tcli.EXIT_BAD_ARGS
