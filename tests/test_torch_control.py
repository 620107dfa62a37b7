"""The port's remote and fault layers against the JAX package's:
``control``, ``control_util``, ``os/*``, ``net``, ``nemesis``,
``nemesis_time``, ``faketime`` and ``faultfs`` run the same calls on
each package's ``DummyRemote``, with fixed grudges, node lists and
seeds.  The two command logs are equal (sorted where ``on_nodes`` fans
out over threads), and so are the return and completion values.  No
test opens a connection."""

import logging
import random
import time
import types

import pytest
import torch

import jepsen_tpu as J
import jepsen_tpu_torch as T
from jepsen_tpu import control as jcontrol
from jepsen_tpu import control_util as jcu
from jepsen_tpu import faketime as jfaketime
from jepsen_tpu import faultfs as jfaultfs
from jepsen_tpu import history as jhistory
from jepsen_tpu import nemesis as jnemesis
from jepsen_tpu import nemesis_time as jnemesis_time
from jepsen_tpu import net as jnet
from jepsen_tpu import util as jutil
from jepsen_tpu.os import debian as jdebian
from jepsen_tpu.os import smartos as jsmartos
from jepsen_tpu_torch import control as tcontrol
from jepsen_tpu_torch import control_util as tcu
from jepsen_tpu_torch import faketime as tfaketime
from jepsen_tpu_torch import faultfs as tfaultfs
from jepsen_tpu_torch import history as thistory
from jepsen_tpu_torch import nemesis as tnemesis
from jepsen_tpu_torch import nemesis_time as tnemesis_time
from jepsen_tpu_torch import net as tnet
from jepsen_tpu_torch import util as tutil
from jepsen_tpu_torch.os import debian as tdebian
from jepsen_tpu_torch.os import smartos as tsmartos

NODES = ["n1", "n2", "n3", "n4", "n5"]
SEEDS = (0, 3, 11)
#: getent answers one address per node (first matching substring wins)
GETENT = {f"getent ahosts {n}": (0, f"10.0.0.{i + 1} STREAM {n}\n", "")
          for i, n in enumerate(NODES)}

PKGS = {
    "jax": types.SimpleNamespace(
        control=jcontrol, cu=jcu, net=jnet, nemesis=jnemesis,
        nemesis_time=jnemesis_time, faketime=jfaketime, faultfs=jfaultfs,
        debian=jdebian, smartos=jsmartos, history=jhistory, util=jutil,
        os=J.os),
    "torch": types.SimpleNamespace(
        control=tcontrol, cu=tcu, net=tnet, nemesis=tnemesis,
        nemesis_time=tnemesis_time, faketime=tfaketime, faultfs=tfaultfs,
        debian=tdebian, smartos=tsmartos, history=thistory, util=tutil,
        os=T.os),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(v):
    if isinstance(v, BaseException):
        return ("raised", type(v).__name__, str(v))
    if hasattr(v, "type") and hasattr(v, "process") and hasattr(v, "f"):
        return ("op", v.process, v.type, v.f, _plain(v.value),
                getattr(v, "error", None))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return sorted(map(_plain, v), key=repr)
    return v


def _test(P, responses=None, nodes=NODES, net=None):
    r = P.control.DummyRemote(dict(GETENT, **(responses or {})))
    return {"nodes": list(nodes), "net": net or P.net.iptables,
            "remote": r,
            "sessions": {n: P.control.Session(node=n, remote=r)
                         for n in nodes}}, r


def _sess(P, responses=None, node="n1"):
    r = P.control.DummyRemote(responses)
    return P.control.Session(node=node, remote=r), r


def _calls(fns):
    """Run each thunk, keeping its value or its exception."""
    out = []
    for fn in fns:
        try:
            out.append(fn())
        except Exception as e:  # noqa: BLE001 — compared across packages
            out.append(e)
    return out


# ---------------------------------------------------------------------------
# scenarios: P -> (values, command log); each run after random.seed(seed)
# ---------------------------------------------------------------------------


def sc_control_session(P):
    s, r = _sess(P, {"echo": (0, "  hello\n", ""), "false": (1, "", "boom"),
                     "who": "root\n"})
    vals = _calls([
        lambda: s.exec("echo", "hello world"),
        lambda: s.exec("false"),
        lambda: s.su().exec("whoami"),
        lambda: s.cd("/tmp").exec("ls"),
        lambda: s.su("admin").cd("/x y").exec("ls", "-l"),
        lambda: s.exec("ls", P.control.lit("|"), "wc"),
        lambda: s.exec_raw("echo raw").out,
        lambda: [P.control.escape(a) for a in
                 ("", "a b", "it's", 3, "$HOME", "plain")],
        lambda: s.upload("/local/f", "/remote/f"),
        lambda: s.download("/remote/g", "/local/g"),
    ])
    return vals, r.log


def sc_control_trace(P):
    s, r = _sess(P)
    records = []

    class H(logging.Handler):
        def emit(self, rec):
            records.append(rec.getMessage())

    h = H()
    logger = logging.getLogger("jepsen")
    old = logger.level
    logger.addHandler(h)
    logger.setLevel(logging.INFO)
    try:
        s.exec("echo", "untraced")
        with P.control.trace():
            s.exec("echo", "traced-cmd")
        s.exec("echo", "after")
    finally:
        logger.removeHandler(h)
        logger.setLevel(old)
    return [m for m in records if "trace" in m], r.log


def sc_control_sessions(P):
    test = {"nodes": ["a", "b", "c"]}
    sessions = P.control.setup_sessions(test)
    vals = [sorted(sessions), type(test["remote"]).__name__,
            P.control.session("a", test).node,
            P.control.session("zz", test).node]
    out = P.control.on_nodes(
        test, lambda t, n: P.control.session(n, t).exec("hostname"))
    vals.append(sorted(out.items()))
    out = P.control.on_many(
        test, ["b", "c"], lambda t, n: P.control.session(n, t).su()
        .exec("id", n))
    vals.append(sorted(out.items()))
    ssh_test = {"nodes": ["a"], "ssh": {"username": "admin", "port": 2222}}
    P.control.setup_sessions(ssh_test)
    remote = ssh_test["remote"]
    base = remote._base("a")
    # the control socket lives in a per-remote temporary directory
    base = [a if "ControlPath=" not in a else "ControlPath=<dir>"
            for a in base]
    scp = [a if "ControlPath=" not in a else "ControlPath=<dir>"
           for a in remote._scp_base()]
    vals += [type(remote).__name__, base, scp,
             vars(P.control.SSHConfig(private_key_path="/k"))]
    return vals, test["remote"].log


def sc_control_util(P):
    s, r = _sess(P, {"stat /there": (0, "", ""), "stat": (1, "", "nope"),
                     "ls -A": (0, "a\nb\n\n c\n", ""),
                     "readlink": (0, "/home/u/x\n", ""),
                     "adduser": (1, "", "user already exists"),
                     "cat /var/run/p.pid": (0, "1234\n", ""),
                     "dirname": (0, "/opt\n", "")})
    vals = _calls([
        lambda: P.cu.exists(s, "/there"),
        lambda: P.cu.exists(s, "/nowhere"),
        lambda: P.cu.ls(s, "/d"),
        lambda: P.cu.ls_full(s, "/d"),
        lambda: P.cu.tmp_dir(s),
        lambda: P.cu.wget(s, "https://x.example/v1/foo.tar"),
        lambda: P.cu.wget(s, "https://x.example/v1/foo.tar", force=True),
        lambda: P.cu.cached_wget(s, "https://x.example/v1.2/foo.tar"),
        lambda: P.cu.cached_wget(s, "https://x.example/bar.zip",
                                 force=True),
        lambda: P.cu.expand_path(s, "~/x"),
        lambda: P.cu.expand_path(s, "/abs"),
        lambda: P.cu.install_archive(s, "https://x.example/a.tar.gz",
                                     "/opt/a"),
        lambda: P.cu.install_archive(s.su(), "file:///tmp/b.zip", "/opt/b"),
        lambda: P.cu.ensure_user(s, "jepsen"),
        lambda: P.cu.grepkill(s, "etcd"),
        lambda: P.cu.grepkill(s, "etcd", signal=15),
        lambda: P.cu.start_daemon(
            s, "/opt/etcd/etcd", "--name", "n1", 7,
            logfile="/var/log/etcd.log", pidfile="/var/run/etcd.pid",
            chdir="/opt/etcd"),
        lambda: P.cu.start_daemon(
            s, "/bin/d", logfile="/l", pidfile="/p", background=False,
            make_pidfile=False, match_executable=False,
            match_process_name=True),
        lambda: P.cu.stop_daemon(s, "/var/run/p.pid"),
        lambda: P.cu.stop_daemon(s, "/var/run/q.pid", cmd="etcd"),
        lambda: P.cu.daemon_running(s, "/var/run/p.pid"),
        lambda: P.cu.start_tcpdump(s, "/tmp/j.pcap", port=26257),
        lambda: P.cu.start_tcpdump(s, "/tmp/k.pcap",
                                   filter_expr="tcp and port 80",
                                   iface="eth0"),
        lambda: P.cu.stop_tcpdump(s),
        lambda: P.cu.poll_until(lambda: 5, timeout_s=1.0, desc="x"),
    ])
    return vals, r.log


def sc_control_util_errors(P):
    s, r = _sess(P, {"adduser": (1, "", "disk full"),
                     "ps aux": (1, "", "broken pipe"),
                     "stat /tmp/jepsen/": (1, "", "nope"),
                     "stat": (0, "", ""), "ls -A": (0, "", ""),
                     "tar": (2, "", "Unexpected EOF in archive")})
    calls = iter(range(3))
    vals = _calls([
        lambda: P.cu.ensure_user(s, "jepsen"),
        lambda: P.cu.grepkill(s, "etcd"),
        lambda: P.cu.install_archive(s, "file:///tmp/c.tgz", "/opt/c"),
        lambda: P.cu.poll_until(lambda: next(calls) > 1, timeout_s=5.0,
                                desc="never", interval=0.001),
        lambda: P.cu.poll_until(lambda: 1 / 0, timeout_s=0.01,
                                desc="gave up", interval=0.001),
    ])
    return vals, r.log


def sc_debian(P):
    listing = ("ii  wget  1.21  amd64  retrieves files\n"
               "ii  curl:amd64  7.88  amd64  transfers data\n"
               "rc  vim  9  amd64  removed\n")
    s, r = _sess(P, {"dpkg": (0, listing, ""),
                     "apt-cache policy etcd": (0, "  Installed: 3.1.4\n", ""),
                     "apt-cache": (0, "  Installed: 1.0\n", ""),
                     "hostname": "n1\n", "cat /etc/hosts": "127.0.0.1 x\n",
                     "stat /etc/apt/sources.list.d/old.list": (0, "", ""),
                     "stat -c": (0, "1000\n", ""), "date +%s": "90000\n",
                     "stat": (1, "", "nope")})
    vals = _calls([
        lambda: P.debian.installed(s, ["wget", "curl", "vim"]),
        lambda: P.debian.installed_version(s, "etcd"),
        lambda: P.debian.install(s, ["wget", "curl", "vim"]),
        lambda: P.debian.install(s, {"etcd": "3.1.5", "wget": "1.0"}),
        lambda: P.debian.setup_hostfile(s),
        lambda: P.debian.update(s),
        lambda: P.debian.maybe_update(s),
        lambda: P.debian.add_key(s, "hkp://k", "ABCD"),
        lambda: P.debian.add_repo(s, "new", "deb http://x stable main",
                                  keyserver="hkp://k", key="EF01"),
        lambda: P.debian.add_repo(s, "old", "deb http://y stable main"),
        lambda: P.debian.install_jdk8(s),
        lambda: P.debian.BASE_PACKAGES,
    ])
    return vals, r.log


def sc_os_setup(P):
    test, r = _test(P, {"dpkg": (0, "ii  wget  1  a  b\n", ""),
                        "pkgin list": (0, "wget-1.2 x\ncurl-7.1 y\n", ""),
                        "hostname": "h\n"})
    vals = []
    for os_ in (P.debian.os, P.smartos.os, P.os.noop):
        P.control.on_nodes(test, lambda t, n: os_.setup(t, n))
        P.control.on_nodes(test, lambda t, n: os_.teardown(t, n))
        vals.append(type(os_).__name__)
    s = P.control.Session(node="n1", remote=r)
    vals += _calls([
        lambda: P.smartos.installed(s, ["wget", "vim"]),
        lambda: P.smartos.install(s, ["wget", "vim", "tar"]),
        lambda: P.smartos.install(s, {"etcd": "3.1"}),
    ])
    return vals, r.log


def sc_net(P):
    test, r = _test(P, {"ping -w 1 -c 1 n9": (1, "", "unreachable"),
                        "qdisc del": (2, "", "No such file or directory")})
    s = P.control.Session(node="n1", remote=r)
    it = P.net.iptables
    vals = _calls([
        lambda: P.net.ip(s, "n2"),
        lambda: P.net.reachable(s, "n3"),
        lambda: P.net.reachable(s, "n9"),
        lambda: it.drop(test, "n2", "n1"),
        lambda: it.heal(test),
        lambda: it.slow(test),
        lambda: it.slow(test, mean_ms=5, variance_ms=1,
                        distribution="pareto"),
        lambda: it.flaky(test),
        lambda: it.fast(test),
        lambda: P.net.drop_all(test, {"n1": ["n2", "n3"], "n4": [],
                                      "n5": ["n1"]}),
        lambda: P.net.ipfilter.drop(test, "n2", "n1"),
        lambda: P.net.ipfilter.heal(test),
        lambda: P.net.ipfilter.slow(test),
        lambda: P.net.ipfilter.flaky(test),
        lambda: P.net.ipfilter.fast(test),
        lambda: P.net.drop_all(dict(test, net=P.net.ipfilter),
                               {"n3": ["n1", "n2"]}),
        lambda: [P.net.noop.drop(test, "n1", "n2"), P.net.noop.heal(test),
                 P.net.noop.slow(test), P.net.noop.flaky(test),
                 P.net.noop.fast(test)],
    ])
    return vals, r.log


def sc_net_no_answer(P):
    """The default dummy remote answers getent with nothing: ``ip``
    raises the same IndexError in both packages."""
    r = P.control.DummyRemote()
    s = P.control.Session(node="n1", remote=r)
    return _calls([lambda: P.net.ip(s, "n2")]), r.log


def sc_grudges(P):
    N = P.nemesis
    vals = [N.bisect([1, 2, 3, 4, 5]), N.bisect([]),
            N.split_one(NODES, loner="n3"), N.split_one(NODES),
            N.complete_grudge(N.bisect(NODES)),
            N.complete_grudge([]), N.bridge(NODES)]
    for n in (3, 5, 7, 9):
        vals.append(N.majorities_ring([f"m{i}" for i in range(n)]))
    vals += [N.grudge_links(N.bridge(NODES)),
             N.bidirectional({("a", "b"), ("c", "a")}),
             N.isolate_links(NODES, "n2"),
             N.isolate_links(NODES, "n2", inbound=False),
             N.isolate_links(NODES, "n4", outbound=False),
             N.split_one_links(NODES), N.split_one_links(NODES, "n1"),
             N.bridge_links(NODES), N.random_halves_links(NODES),
             N.all_peer_links(NODES[:3]), P.util.majority(5)]
    return vals, []


def _op(P, f, value=None):
    return P.history.info_op("nemesis", f, value)


def sc_partitioners(P):
    test, r = _test(P)
    vals = []
    for make in (P.nemesis.partition_halves,
                 P.nemesis.partition_random_halves,
                 P.nemesis.partition_random_node,
                 P.nemesis.partition_majorities_ring,
                 lambda: P.nemesis.partitioner(
                     lambda ns: P.nemesis.complete_grudge(
                         P.nemesis.split_one(ns, ns[-1])))):
        p = make().setup(test)
        vals += _calls([lambda: p.invoke(test, _op(P, "start")),
                        lambda: p.invoke(test, _op(P, "start")),
                        lambda: p.invoke(test, _op(P, "stop")),
                        lambda: p.invoke(test, _op(P, "bogus"))])
        p.teardown(test)
    return vals, r.log


def sc_compose(P):
    seen = []

    class Recorder(P.nemesis.Nemesis):
        def __init__(self, tag):
            self.tag = tag

        def setup(self, test):
            seen.append(("setup", self.tag))
            return self

        def invoke(self, test, op):
            seen.append((self.tag, op.f))
            return P.history.info_op(op.process, op.f, self.tag)

        def teardown(self, test):
            seen.append(("teardown", self.tag))

    comp = P.nemesis.compose([
        (frozenset({"start", "stop"}), Recorder("a")),
        ({"kill-start": "start", "kill-stop": "stop"}, Recorder("b")),
        (lambda f: f[4:] if f.startswith("clk-") else None, Recorder("c")),
    ]).setup({})
    vals = _calls([lambda f=f: comp.invoke({}, _op(P, f))
                   for f in ("start", "kill-start", "kill-stop",
                             "clk-bump", "stop", "what")])
    comp.teardown({})
    d = P.nemesis.compose({frozenset({"x"}): P.nemesis.noop})
    vals += _calls([lambda: d.invoke({}, _op(P, "x", 3))])
    return vals + [seen], []


def sc_node_faults(P):
    test, r = _test(P)
    h = P.nemesis.hammer_time("mongod")
    h2 = P.nemesis.hammer_time("etcd", targeter=lambda ns: ns[:2])
    none = P.nemesis.node_start_stopper(lambda ns: None, None, None)
    vals = _calls([lambda f=f: h.invoke(test, _op(P, f))
                   for f in ("start", "start", "stop", "stop", "pause")])
    vals += _calls([lambda f=f: h2.invoke(test, _op(P, f))
                    for f in ("start", "stop")])
    vals += _calls([lambda: none.invoke(test, _op(P, "start"))])
    tr = P.nemesis.truncate_file()
    vals += _calls([lambda: tr.invoke(test, _op(
        P, "truncate", {"n2": {"file": "/var/lib/db/wal", "drop": 64},
                        "n4": {"file": "/x", "drop": 1}}))])
    return vals, r.log


def sc_clock_scrambler(P, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    one, r1 = _test(P, nodes=["n1"])
    sc = P.nemesis.clock_scrambler(30)
    vals = _calls([lambda: sc.invoke(one, _op(P, "scramble")),
                   lambda: sc.invoke(one, _op(P, "scramble"))])
    test, r = _test(P)
    sc.teardown(test)
    P.nemesis.set_time(P.control.Session(node="n2", remote=r), 12.9)
    return vals, r1.log + r.log


def sc_clock_nemesis(P):
    test, r = _test(P, {"strobe-time-experiment": (0, "x\n21\n", "")})
    cn = P.nemesis_time.clock_nemesis().setup(test)
    vals = _calls([
        lambda: cn.invoke(test, _op(P, "bump", {"n1": 8000, "n3": -4000})),
        lambda: cn.invoke(test, _op(P, "strobe", {
            "n2": {"delta": 100, "period": 5, "duration": 10}})),
        lambda: cn.invoke(test, _op(P, "reset", ["n4"])),
        lambda: cn.invoke(test, _op(P, "strobe-pin", {
            "n5": {"delta": 200, "period": 10, "duration": 5.4}})),
        lambda: cn.invoke(test, _op(P, "melt", None)),
    ])
    cn.teardown(test)
    s = P.control.Session(node="n1", remote=P.control.DummyRemote())
    vals.append(P.nemesis_time.strobe_time_pinned(s, 1, 2, 0.2))
    gens = [P.nemesis_time.reset_gen(test, "nemesis"),
            P.nemesis_time.bump_gen(test, "nemesis"),
            P.nemesis_time.strobe_gen(test, "nemesis")]
    g = P.nemesis_time.clock_gen()
    gens += [g.op(test, "nemesis") for _ in range(6)]
    return vals + gens, r.log + s.remote.log


def sc_faketime(P):
    s, r = _sess(P, {"stat /usr/bin/etcd.no-faketime": (1, "", "nope")})
    s2, r2 = _sess(P, {"stat": (0, "", "")})
    vals = _calls([
        lambda: P.faketime.script("/usr/bin/etcd", -30, 1.5),
        lambda: P.faketime.script("/bin/x", 12, 2.0),
        lambda: P.faketime.wrap(s, "/usr/bin/etcd", 10, 2.0),
        lambda: P.faketime.wrapped(s, "/usr/bin/etcd"),
        lambda: P.faketime.unwrap(s, "/usr/bin/etcd"),
        lambda: P.faketime.wrap(s2, "/usr/bin/etcd", -5, 0.5),
        lambda: P.faketime.wrapped(s2, "/usr/bin/etcd"),
        lambda: P.faketime.unwrap(s2, "/usr/bin/etcd"),
    ])
    return vals, r.log + r2.log


def sc_faultfs(P):
    test, r = _test(P, {f"stat {P.faultfs.RAW_BIN}": (1, "", "nope"),
                        f"stat {P.faultfs.BIN}": (1, "", "nope"),
                        "dpkg -l libfuse3": (1, "", "no packages"),
                        "install -y --force-yes fuse3": (100, "", "E:"),
                        "install -y --force-yes libfuse3": (100, "", "E:"),
                        "faultfsctl": (0, "ok\n", "")})
    s = P.control.Session(node="n1", remote=r)
    vals = _calls([
        lambda: P.faultfs.break_all(s), lambda: P.faultfs.break_one_percent(s),
        lambda: P.faultfs.break_methods(s, ["write", "fsync"], "ENOSPC", 0.5),
        lambda: P.faultfs.slow(s, 250, 0.1), lambda: P.faultfs.clear(s),
        lambda: P.faultfs.status(s),
    ])
    nem = P.faultfs.nemesis().setup(test)
    vals += _calls([lambda: nem.invoke(test, _op(P, "break-all", ["n2"])),
                    lambda: nem.invoke(test, _op(P, "clear")),
                    lambda: nem.invoke(test, _op(P, "melt"))])
    nem.teardown(test)
    return vals, r.log


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_control_session, sc_control_trace, sc_control_sessions,
    sc_control_util, sc_control_util_errors, sc_debian, sc_os_setup, sc_net,
    sc_net_no_answer, sc_grudges, sc_partitioners, sc_compose,
    sc_node_faults, sc_clock_nemesis, sc_faketime, sc_faultfs)}


def _run(pkg, scenario, seed, *args):
    random.seed(seed)
    vals, log = scenario(PKGS[pkg], *args)
    # on_nodes fans out over one thread per node: the log's order is the
    # scheduler's, its content is not
    return _plain(vals), sorted(map(repr, log))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_commands_and_values_equal_reference(name, seed):
    want = _run("jax", SCENARIOS[name], seed)
    got = _run("torch", SCENARIOS[name], seed)
    assert got == want
    assert got[0] or got[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_clock_scrambler_equal_reference(seed, monkeypatch):
    want = _run("jax", sc_clock_scrambler, seed, monkeypatch)
    got = _run("torch", sc_clock_scrambler, seed, monkeypatch)
    assert got == want and len(got[1]) == 2 + 5 + 1


def test_native_sources_resolve_to_the_shared_directory():
    assert tnemesis_time.NATIVE_DIR == jnemesis_time.NATIVE_DIR
    assert tfaultfs.NATIVE_DIR == jfaultfs.NATIVE_DIR
    import os

    for src in ("bump_time.cc", "strobe_time.cc",
                "strobe_time_experiment.cc"):
        assert os.path.isfile(os.path.join(tnemesis_time.NATIVE_DIR, src))
    for src in tfaultfs.SOURCES:
        assert os.path.isfile(os.path.join(tfaultfs.NATIVE_DIR, src))


def test_local_remote_runs_real_commands(tmp_path):
    s = tcontrol.Session(node="local", remote=tcontrol.LocalRemote())
    assert s.exec("echo", "hi") == "hi"
    p = tmp_path / "f.txt"
    s.exec("sh", "-c", f"echo data > {p}")
    assert tcu.exists(s, str(p))
    assert not tcu.exists(s, str(tmp_path / "nope"))
    assert "f.txt" in tcu.ls(s, str(tmp_path))
    s.download(str(p), str(tmp_path / "g.txt"))
    assert (tmp_path / "g.txt").read_text() == "data\n"
