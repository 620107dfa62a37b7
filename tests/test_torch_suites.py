"""The port's suites (``jepsen_tpu_torch.suites``) against the JAX
package's: ``atomdemo`` through the command line with ``--device cpu``,
``registry``'s test maps, ``hazelcast``'s lock fixture (BASELINE config
4), clients and database commands, and ``localnode`` with its real server
processes.  Each whole run stores its history; the JAX package's checker
on that stored history gives the port's verdict.

The localnode tests spawn the port's server (``python -m
jepsen_tpu_torch.suites.localnode_server``) on ports drawn below the
kernel's ephemeral range (which starts at 32768), so six workers never
race the kernel's own picks; a draw that finds a port taken draws
again."""

import glob
import http.server
import itertools
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

import jepsen_tpu.checker.linearizable as jlin
from jepsen_tpu import cli as jcli
from jepsen_tpu import control as jcontrol
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jm
from jepsen_tpu.suites import hazelcast as jhz
from jepsen_tpu.suites import registry as jreg
from jepsen_tpu_torch import cli as tcli
from jepsen_tpu_torch import control as tcontrol
from jepsen_tpu_torch import core as tcore
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import suites
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.history import invoke_op
from jepsen_tpu_torch.suites import (atomdemo, hazelcast, localnode,
                                     localnode_server, registry)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
         "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_SHRINK", "JEPSEN_TPU_EXPLAIN",
         "JEPSEN_TPU_LIN_DECOMPOSE", "JEPSEN_TPU_LIN_ALGORITHM",
         "JEPSEN_TPU_STREAM")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jlin, "_SLICE_TARGET_S", 1e9)
    monkeypatch.setattr(tlin, "_SLICE_TARGET_S", 1e9)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_ref(history):
    """The port's events as the JAX package's, stored ``[k v]`` values
    lifted back to the JAX package's tuples."""
    import ast

    out = []
    for op in history:
        v = op.value
        if isinstance(v, str) and v.startswith("[") and v.endswith("]"):
            k, x = v[1:-1].split(" ", 1)
            v = jind.tuple_(ast.literal_eval(k), ast.literal_eval(x))
        out.append(jh.Op(process=op.process, type=op.type, f=op.f, value=v,
                         time=op.time, index=op.index, error=op.error))
    return out


def _stored(base, name):
    """The one stored run of ``name`` under ``base``: (test map, history,
    results) as the port's store loads them."""
    (d,) = [d for d in glob.glob(os.path.join(base, name, "2*"))]
    run = tstore.load(name, os.path.basename(d), base)
    return run, run["history"], run["results"]


# ---------------------------------------------------------------------------
# suites/__init__.py
# ---------------------------------------------------------------------------


def test_suites_list_the_ported_suites_and_import_them():
    from jepsen_tpu import suites as jsuites

    assert suites.SUITES == ["atomdemo", "etcdemo", "zookeeper",
                             "hazelcast", "registry", "consul", "disque",
                             "aerospike", "rethinkdb", "tidb", "etcd",
                             "logcabin", "raftis", "localnode"]
    # the JAX package's order: SUITES is a subsequence of its list
    rest = iter(jsuites.SUITES)
    assert all(name in rest for name in suites.SUITES)
    for name in suites.SUITES:
        mod = suites.suite(name)
        assert mod.__name__ == f"jepsen_tpu_torch.suites.{name}"
        assert callable(getattr(mod, "main", None)) or name == "registry"


# ---------------------------------------------------------------------------
# atomdemo through the command line
# ---------------------------------------------------------------------------

ATOM_CASES = {
    "plain": [],
    "stream-trace-device": ["--stream", "--trace", "--lin-algorithm",
                            "device", "-r", "200", "--group-size", "4",
                            "--concurrency", "8"],
}


@pytest.mark.parametrize("case", sorted(ATOM_CASES))
def test_atomdemo_command_line_run(case, tmp_path, monkeypatch):
    from jepsen_tpu_torch.obs import trace as ttrace

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ttrace, "_on", ttrace._on)
    random.seed(case)
    rc = tcli.run(tcli.single_test_cmd(atomdemo.atom_test,
                                       add_opts=atomdemo.add_opts),
                  ["test", "--dummy", "--device", "cpu", "-n", "n1", "-n",
                   "n2", "-n", "n3", "--time-limit", "2"]
                  + ATOM_CASES[case])
    assert rc == tcli.EXIT_OK
    base = str(tmp_path / "store")
    assert os.path.isdir(os.path.join(base, "latest"))
    assert os.path.isdir(os.path.join(base, "atomdemo", "latest"))
    run, hist, res = _stored(base, "atomdemo")
    assert res["valid"] is True and res["workload"]["valid"] is True
    keys = res["workload"]["results"]
    assert len(keys) >= 2
    assert run["device"] == "cpu"
    # the JAX package's checker on the stored history, key by key
    want = jind.checker(jlin.linearizable(jm.cas_register(0))).check(
        {"name": None}, _to_ref(hist))
    assert {str(k) for k in want["results"]} == set(keys)
    for k, r in want["results"].items():
        assert keys[str(k)]["linear"]["valid"] is r["valid"] is True
    d = os.path.join(base, "atomdemo", "latest")
    if case != "plain":
        assert res["stream"]["valid"] is True
        assert os.path.isfile(os.path.join(d, "live.json"))
        with open(os.path.join(d, "trace.json")) as f:
            assert json.load(f)["traceEvents"]
        engines = {r["linear"]["engine"] for r in keys.values()}
        assert engines <= {"device-bfs", "greedy-witness", "hb-decide",
                           "constraint-decide", "trivial"}, engines
    else:
        assert not os.path.exists(os.path.join(d, "live.json"))


def test_atomdemo_module_without_a_card_names_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.suites.atomdemo", "test",
         "--dummy", "-n", "n1", "--time-limit", "1"], cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == tcli.EXIT_BAD_ARGS
    assert "torch.cuda.is_available() is False" in out.stderr
    assert not (tmp_path / "store").exists()


def test_atomdemo_test_map_equals_reference():
    from jepsen_tpu.suites import atomdemo as jatom

    opts = {"nodes": ["n1", "n2"], "concurrency": 5, "time_limit": 2,
            "rate": 300, "ops_per_key": 20, "group_size": 2}
    t, j = atomdemo.atom_test(dict(opts)), jatom.atom_test(dict(opts))
    assert set(t) == set(j)
    for k in ("name", "concurrency", "nodes", "time_limit"):
        assert t[k] == j[k]
    assert type(t["client"]).__name__ == type(j["client"]).__name__
    assert sorted(t["checker"].checkers) == sorted(j["checker"].checkers)
    for f in (atomdemo.r, atomdemo.w, atomdemo.cas):
        random.seed(3)
        got = f({}, 0)
        random.seed(3)
        assert got == getattr(jatom, f.__name__)({}, 0)


def test_atomdemo_reply_latency_keeps_runs_valid_past_the_witness(
        tmp_path, monkeypatch):
    """``--latency`` delays each reply after its op applies: the run stays
    valid (the JAX package's checker agrees key by key), and completion
    order no longer witnesses every key, so the device search decides
    some (about four keys in five here; ``chip_smoke.py`` holds the
    card's run to most of its 50 or more keys)."""
    monkeypatch.chdir(tmp_path)
    random.seed("latency")
    rc = tcli.run(tcli.single_test_cmd(atomdemo.atom_test,
                                       add_opts=atomdemo.add_opts),
                  ["test", "--dummy", "--device", "cpu", "-n", "n1",
                   "--time-limit", "1", "--lin-algorithm", "device", "-r",
                   "40", "--group-size", "4", "--concurrency", "4",
                   "--ops-per-key", "20", "--latency", "40"])
    assert rc == tcli.EXIT_OK
    run, hist, res = _stored(str(tmp_path / "store"), "atomdemo")
    assert run["latency"] == 40 and res["valid"] is True
    keys = res["workload"]["results"]
    engines = [r["linear"]["engine"] for r in keys.values()]
    assert "device-bfs" in engines and len(engines) >= 3, engines
    want = jind.checker(jlin.linearizable(jm.cas_register(0))).check(
        {"name": None}, _to_ref(hist))
    assert {str(k) for k in want["results"]} == set(keys)
    for k, r in want["results"].items():
        assert keys[str(k)]["linear"]["valid"] is r["valid"] is True


def test_atomdemo_client_replies_after_applying(monkeypatch):
    """The op applies before the reply's delay, which is drawn in
    ``[0, latency]``; no delay at the default."""
    from jepsen_tpu_torch import independent as tind

    slept = []
    monkeypatch.setattr(atomdemo.time, "sleep", slept.append)
    c = atomdemo.AtomMapClient(latency=0.01)
    op = invoke_op(0, "write", tind.tuple_(1, 3))
    assert c.invoke({}, op).type == "ok"
    assert c.registers[1].read() == 3 and len(slept) == 1
    assert 0 <= slept[0] <= 0.01
    atomdemo.AtomMapClient().invoke({}, op)
    assert len(slept) == 1


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _registry(mod, fixtures, lin, gen, cas):
    reg = mod.Registry()
    state = fixtures.AtomRegister(0)

    @reg.workload("demo")
    def demo(opts):
        return {"client": fixtures.atom_client(state), "model": cas(0),
                "generator": gen.limit(10, gen.cas),
                "checker": lin.linearizable(),
                "final_generator": gen.once(
                    {"type": "invoke", "f": "read", "value": None})}
    return reg


def _both_registries():
    from jepsen_tpu import fixtures as jfix
    from jepsen_tpu import generator as jgen
    from jepsen_tpu_torch import fixtures as tfix
    from jepsen_tpu_torch.models import cas_register as tcas

    return (_registry(jreg, jfix, jlin, jgen, jm.cas_register),
            _registry(registry, tfix, tlin, tgen, tcas))


@pytest.mark.parametrize("nem", ["none", "parts", "majority-ring", "split",
                                 "single-node"])
def test_registry_builds_the_reference_tests(nem):
    jr, tr = _both_registries()
    assert sorted(tr.nemeses) == sorted(jr.nemeses)
    opts = {"workload": "demo", "nemesis": nem, "nodes": ["n1", "n2"],
            "concurrency": 2, "time_limit": 1}
    t, j = tr.build_test(dict(opts)), jr.build_test(dict(opts))
    assert t["name"] == j["name"] == f"demo nemesis={nem}"
    assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
    assert set(t) == set(j)
    named_t, named_j = tr.nemeses[nem], jr.nemeses[nem]
    assert (named_t.final is None) == (named_j.final is None)


def test_registry_options_and_main_exit_codes(tmp_path, monkeypatch,
                                              capsys):
    import argparse

    jr, tr = _both_registries()
    pj, pt = argparse.ArgumentParser(), argparse.ArgumentParser()
    jr.add_opts(pj)
    tr.add_opts(pt)
    argv = ["-w", "demo", "--nemesis", "split"]
    assert vars(pt.parse_args(argv)) == vars(pj.parse_args(argv))
    monkeypatch.chdir(tmp_path)
    rc = {}
    for name, reg, cli, extra in (("jax", jr, jcli, []),
                                  ("torch", tr, tcli, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            reg.main(["test", "-w", "demo", "-n", "n1", "--time-limit",
                      "1", "--dummy"] + extra)
        rc[name] = e.value.code
        with pytest.raises(SystemExit) as e:
            reg.main(["test", "-w", "nosuch", "--dummy"] + extra)
        rc[name + "-bad"] = e.value.code
    capsys.readouterr()
    assert rc == {"jax": 0, "torch": 0, "jax-bad": 254, "torch-bad": 254}


# ---------------------------------------------------------------------------
# hazelcast: BASELINE config 4 and the cluster workloads' clients
# ---------------------------------------------------------------------------


def test_lock_service_and_client():
    svc = hazelcast.InProcessLockService()
    c1 = hazelcast.LockClient(svc).open({}, "n1")
    c2 = hazelcast.LockClient(svc).open({}, "n2")
    assert c1.invoke({}, invoke_op(0, "acquire", None)).type == "ok"
    assert c2.invoke({}, invoke_op(1, "acquire", None)).type == "fail"
    rel = c2.invoke({}, invoke_op(1, "release", None))
    assert rel.type == "fail" and rel.error == "not-lock-owner"
    assert c1.invoke({}, invoke_op(0, "release", None)).type == "ok"
    assert c2.invoke({}, invoke_op(1, "acquire", None)).type == "ok"
    svc.broken = True
    assert c1.invoke({}, invoke_op(0, "acquire", None)).type == "ok"


@pytest.mark.parametrize("broken", [False, True])
def test_lock_fixture_verdicts_equal_reference(broken, tmp_path):
    """BASELINE config 4: the in-process lock under the mutex model,
    valid with a sound service and invalid with a broken one; the JAX
    package's checker gives the same verdict on the stored history."""
    random.seed(f"lock-{broken}")
    svc = hazelcast.InProcessLockService()
    svc.broken = broken
    opts = {"nodes": ["n1", "n2"], "concurrency": 3, "time_limit": 1,
            "rate": 100, "workload": "lock-fixture", "device": "cpu",
            "store_base": str(tmp_path)}
    test = hazelcast.hazelcast_test(opts)
    test["client"] = hazelcast.LockClient(svc)
    test["name"] = "hazelcast-lock"
    test["checker"] = hazelcast.lock_fixture_workload(opts, svc)["checker"]
    out = tcore.run(test)
    assert out["results"]["valid"] is (not broken)
    assert out["results"]["linear"]["valid"] is (not broken)
    _, hist, res = _stored(str(tmp_path), "hazelcast-lock")
    want = jlin.linearizable(jm.mutex()).check(
        {"name": "j", "store_base": str(tmp_path / "j")}, _to_ref(hist))
    assert res["linear"]["valid"] is want["valid"] is (not broken)


def test_unique_id_fixture_equals_reference():
    t = hazelcast.unique_ids_fixture_workload({})
    j = jhz.unique_ids_fixture_workload({})
    assert t["generator"] == j["generator"] and t["model"] is j["model"]
    ct, cj = t["client"].open({}, "n1"), j["client"].open({}, "n1")
    from jepsen_tpu.history import invoke_op as jinvoke

    got = [ct.invoke({}, invoke_op(0, "generate", None)).value
           for _ in range(10)]
    assert got == [cj.invoke({}, jinvoke(0, "generate", None)).value
                   for _ in range(10)] == list(range(10))
    assert type(t["checker"]).__name__ == type(j["checker"]).__name__


def _queue_server():
    q = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            q.append(int(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def do_DELETE(self):
            if q:
                body = str(q.pop(0)).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(204)
                self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _queue_script(mod, invoke):
    srv = _queue_server()
    old = mod.PORT
    mod.PORT = srv.server_address[1]
    try:
        c = mod.RestQueueClient().open({}, "127.0.0.1")
        out = []
        for f, v in (("enqueue", 7), ("dequeue", None), ("dequeue", None),
                     ("enqueue", 8), ("enqueue", 9), ("drain", None)):
            r = c.invoke({}, invoke(0, f, v))
            out.append((r.type, r.f, r.value, r.error))
        return out
    finally:
        mod.PORT = old
        srv.shutdown()
        srv.server_close()


def test_rest_queue_client_equals_reference():
    from jepsen_tpu.history import invoke_op as jinvoke

    got = _queue_script(hazelcast, invoke_op)
    assert got == _queue_script(jhz, jinvoke)
    assert got[-1] == ("ok", "drain", [8, 9], None)


def _memcache_script(mod, invoke):
    state = {"n": 0}
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            f = conn.makefile("rb")

            def one(conn=conn, f=f):
                while True:
                    line = f.readline()
                    if not line:
                        return
                    parts = line.decode().split()
                    if parts and parts[0] == "add":
                        f.readline()
                        conn.sendall(b"STORED\r\n")
                    elif parts and parts[0] == "incr":
                        state["n"] += int(parts[2])
                        conn.sendall(f"{state['n']}\r\n".encode())
            threading.Thread(target=one, daemon=True).start()

    threading.Thread(target=serve, daemon=True).start()
    old = mod.PORT
    mod.PORT = srv.getsockname()[1]
    try:
        c = mod.MemcacheIdClient().open({}, "127.0.0.1")
        vals = [c.invoke({}, invoke(0, "generate", None)).value
                for _ in range(5)]
        c.close({})
        return vals
    finally:
        mod.PORT = old
        srv.close()


def test_memcache_id_client_equals_reference():
    from jepsen_tpu.history import invoke_op as jinvoke

    assert _memcache_script(hazelcast, invoke_op) == \
        _memcache_script(jhz, jinvoke) == [1, 2, 3, 4, 5]


def _db_log(mod, control, tmp_path):
    nodes = ("n1", "n2", "n3")
    r = control.DummyRemote({"getent ahosts n2": (0, "10.0.0.2 STREAM n2\n",
                                                  "")})
    test = {"nodes": list(nodes),
            "sessions": {n: control.Session(node=n, remote=r)
                         for n in nodes}}
    jar = tmp_path / "server.jar"
    jar.write_bytes(b"jar")
    orig = time.sleep
    time.sleep = lambda s: None
    try:
        db = mod.db(str(jar))
        db.setup(test, "n1")
        db.teardown(test, "n1")
        files = db.log_files(test, "n1")
    finally:
        time.sleep = orig
    return r.log, files


def test_hazelcast_db_commands_equal_reference(tmp_path):
    got, files = _db_log(hazelcast, tcontrol, tmp_path)
    want, jfiles = _db_log(jhz, jcontrol, tmp_path)
    assert got == want and files == jfiles == ["/opt/hazelcast/server.log"]
    cmds = [e[2] for e in got if e[1] == "exec"]
    assert any("start-stop-daemon" in c and "-jar /opt/hazelcast/server.jar"
               in c and "--members 10.0.0.2,n3" in c for c in cmds)


@pytest.mark.parametrize("name", sorted(jhz.WORKLOADS))
def test_hazelcast_test_maps_equal_reference(name):
    assert sorted(hazelcast.WORKLOADS) == sorted(jhz.WORKLOADS)
    assert hazelcast.CLUSTER_WORKLOADS == jhz.CLUSTER_WORKLOADS
    opts = {"workload": name, "nodes": ["n1", "n2", "n3"],
            "concurrency": 3, "time_limit": 5, "rate": 10}
    t, j = hazelcast.hazelcast_test(dict(opts)), jhz.hazelcast_test(
        dict(opts))
    assert set(t) == set(j) and t["name"] == j["name"]
    for k in ("client", "nemesis", "db", "os"):
        assert type(t.get(k)).__name__ == type(j.get(k)).__name__, k
    assert sorted(t["checker"].checkers) == sorted(j["checker"].checkers)
    wt = hazelcast.WORKLOADS[name]({})
    wj = jhz.WORKLOADS[name]({})
    assert type(wt["checker"]).__name__ == type(wj["checker"]).__name__
    assert ("final_generator" in wt) == ("final_generator" in wj)


# ---------------------------------------------------------------------------
# localnode: the server, then whole runs of real processes
# ---------------------------------------------------------------------------


def _free_ports(n: int) -> int:
    """The first of ``n`` consecutive ports, drawn below the ephemeral
    range and free now."""
    rng = random.Random()
    while True:
        base = rng.randrange(20000, 32000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
        return base


def _spawn(module, port, data, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", module, str(port), data, *extra], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)


def _connect(port, proc, deadline_s=20.0):
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=2)
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _script(sock, lines) -> list:
    """Each line's raw reply bytes."""
    f = sock.makefile("rb")
    out = []
    for ln in lines:
        sock.sendall(ln)
        out.append(f.readline())
    return out


SCRIPT = [b"W a 3\n", b"CAS a 3 4\n", b"CAS a 9 7\n", b"R a\n", b"R nope\n",
          b"W b -2\n", b"R b\n", b"LOCK c1\n", b"LOCK c2\n",
          b"UNLOCK c2\n", b"UNLOCK c1\n", b"LOCK c2\n", b"\n",
          b"W a x\n", b"CAS a\n", b"BOGUS 1 2\n", b"R\n", b"r a\n",
          b"  R   a  \n"]


@pytest.mark.parametrize("volatile", [False, True])
def test_server_answers_as_the_reference_and_survives_kill_9(volatile,
                                                             tmp_path):
    extra = ("volatile",) if volatile else ()
    replies = {}
    for pkg in ("jepsen_tpu", "jepsen_tpu_torch"):
        port = _free_ports(1)
        data = str(tmp_path / pkg)
        proc = _spawn(f"{pkg}.suites.localnode_server", port, data, *extra)
        try:
            with _connect(port, proc) as s:
                replies[pkg] = _script(s, SCRIPT)
            if pkg == "jepsen_tpu_torch":
                os.kill(proc.pid, signal.SIGKILL)
                proc.wait(timeout=10)
                proc = _spawn(f"{pkg}.suites.localnode_server", port, data,
                              *extra)
                with _connect(port, proc) as s:
                    after = _script(s, [b"R a\n", b"R b\n", b"LOCK c3\n"])
        finally:
            proc.kill()
            proc.wait(timeout=10)
    assert replies["jepsen_tpu_torch"] == replies["jepsen_tpu"]
    assert replies["jepsen_tpu"][:4] == [b"OK\n", b"OK\n", b"FAIL\n",
                                         b"OK 4\n"]
    # acked writes replay from the oplog; the holder c2 is durable only
    # when the server is not volatile
    assert after == [b"OK 4\n", b"OK -2\n",
                     b"OK\n" if volatile else b"BUSY\n"]


def test_server_loads_neither_numpy_nor_torch():
    """A node's server process starts on the standard library alone."""
    code = ("import sys; import jepsen_tpu_torch.suites.localnode_server; "
            "bad = [m for m in ('numpy', 'torch') if m in sys.modules]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]


def test_server_usage_and_store_equal_reference(tmp_path):
    from jepsen_tpu.suites import localnode_server as jserver

    for argv in ([], ["1"], ["1", "d", "fast"], ["1", "d", "x", "y"]):
        with pytest.raises(SystemExit) as e:
            localnode_server.main(list(argv))
        assert e.value.code == 2
    replies = []
    for cls, d in ((localnode_server.Store, tmp_path / "t"),
                   (jserver.Store, tmp_path / "j")):
        st = cls(str(d))
        replies.append([st.apply(parts) for parts in (
            ["W", "k", "1"], ["CAS", "k", "1", "2"], ["CAS", "k", "1", "3"],
            ["LOCK", "o"], ["LOCK", "p"], ["UNLOCK", "p"], ["UNLOCK", "o"],
            ["LOCK", "p"], ["R", "k"], ["X"])])
        st.log.close()
    assert replies[0] == replies[1]
    assert (tmp_path / "t" / "oplog").read_bytes() == \
        (tmp_path / "j" / "oplog").read_bytes()
    t, j = localnode_server.Store(str(tmp_path / "t")), jserver.Store(
        str(tmp_path / "j"))
    t.log.close()
    j.log.close()
    assert (t.state, t.holder) == (j.state, j.holder) == ({"k": 2}, "p")


def _lock_test(tmp_path, label, *, volatile, staged, **kw):
    base = _free_ports(1)
    test = localnode.locknode_test({
        "base_port": base, "data_root": str(tmp_path / f"nodes-{label}"),
        "store_base": str(tmp_path / f"store-{label}"), "device": "cpu",
        "lock_volatile": volatile, "concurrency": 2 if staged else 4,
        "time_limit": 3, "kill_every": 1, **kw})
    if staged:
        test["generator"] = chip_smoke.double_grant_generator(tgen)
    return test


@pytest.mark.parametrize("volatile,staged", [(False, False), (False, True),
                                             (True, True)])
def test_locknode_verdicts_equal_reference(volatile, staged, tmp_path):
    """The lock workload on a real server process under kill -9 and
    restart: valid when the holder is durable; with a volatile server,
    the staged double grant (:func:`chip_smoke.double_grant_generator`)
    is invalid.  The JAX package's checker agrees on the stored
    history."""
    label = f"{volatile}-{staged}"
    out = tcore.run(_lock_test(tmp_path, label, volatile=volatile,
                               staged=staged))
    res = out["results"]
    assert res["valid"] is (not volatile), res
    hist = out["history"]
    assert any(op.process == "nemesis" and op.f == "kill" for op in hist)
    _, stored, sres = _stored(str(tmp_path / f"store-{label}"), "locknode")
    want = jlin.linearizable(jm.mutex()).check(
        {"name": "j", "store_base": str(tmp_path / "j")}, _to_ref(stored))
    assert sres["linear"]["valid"] is want["valid"] is (not volatile)
    if staged:
        acquires = [op.type for op in hist if op.f == "acquire"
                    and op.type != "invoke"]
        assert acquires == (["ok", "ok"] if volatile else ["ok", "fail"])


def test_localnode_run_with_kill_and_restart(tmp_path):
    """A 3-second ``localnode_test``: three server processes, a kill -9
    and a restart, every key valid, the JAX package's checker giving the
    same verdict per key on the stored history, every server gone after
    teardown."""
    random.seed("localnode")
    base = _free_ports(3)
    test = localnode.localnode_test({
        "nodes": ["n1", "n2", "n3"], "base_port": base,
        "data_root": str(tmp_path / "nodes"),
        "store_base": str(tmp_path / "store"), "time_limit": 3,
        "rate": 40, "concurrency": 6, "ops_per_key": 20, "device": "cpu"})
    out = tcore.run(test)
    res = out["results"]
    assert res["valid"] is True, res
    hist = out["history"]
    assert any(op.process == "nemesis" and op.f == "kill" for op in hist)
    assert any(op.process == "nemesis" and op.f == "restart" for op in hist)
    _, stored, sres = _stored(str(tmp_path / "store"), "localnode")
    want = jind.checker(jlin.linearizable(jm.cas_register())).check(
        {"name": None}, _to_ref(stored))
    keys = sres["workload"]["results"]
    assert {str(k) for k in want["results"]} == set(keys)
    for k, r in want["results"].items():
        assert keys[str(k)]["linear"]["valid"] is r["valid"] is True
    for i in range(3):
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", base + i),
                                     timeout=0.3).close()


def test_localnode_spawns_the_ports_server(monkeypatch):
    """The daemon command names the port's module, run from the repo
    root, never the JAX package's."""
    r = tcontrol.DummyRemote()
    test = {"nodes": ["n1"], "base_port": 1, "data_root": "/d",
            "sessions": {"n1": tcontrol.Session(node="n1", remote=r)}}
    monkeypatch.setattr(localnode.cu, "poll_until", lambda *a, **kw: None)
    localnode.LocalNodeDB().setup(test, "n1")
    start = [e[2] for e in r.log
             if e[1] == "exec" and "start-stop-daemon --start" in e[2]]
    assert len(start) == 1
    assert "-m jepsen_tpu_torch.suites.localnode_server 1 /d/n1" in start[0]
    assert f"--chdir {localnode.REPO_ROOT}" in start[0]
    assert localnode.REPO_ROOT == REPO
    assert localnode.BASE_PORT == 17850


def test_kill_restart_nemesis_and_clients_equal_reference():
    from jepsen_tpu.suites import localnode as jlocal

    for name in ("KillRestartNemesis", "RegisterClient", "LockWireClient",
                 "LocalNodeDB"):
        t, j = getattr(localnode, name), getattr(jlocal, name)
        assert sorted(n for n in vars(t) if not n.startswith("__")) == \
            sorted(n for n in vars(j) if not n.startswith("__")), name
    opts = {"nodes": ["n1", "n2", "n3"], "time_limit": 2}
    for fn in ("localnode_test", "locknode_test"):
        t, j = getattr(localnode, fn)(dict(opts)), getattr(jlocal, fn)(
            dict(opts))
        assert set(t) == set(j) and t["name"] == j["name"]
        assert (t["nodes"], t["concurrency"]) == (j["nodes"],
                                                  j["concurrency"])
        assert type(t["model"]).__name__ == type(j["model"]).__name__
    for f in ("r", "w", "cas"):
        random.seed(4)
        got = getattr(localnode, f)({}, 0)
        random.seed(4)
        assert got == getattr(jlocal, f)({}, 0)
    assert list(itertools.islice(localnode._naturals(), 4)) == \
        list(itertools.islice(jlocal._naturals(), 4))


def test_graphs_not_drawn_without_matplotlib_keep_the_run_valid(
        tmp_path, monkeypatch):
    """Where matplotlib does not import (the card's host), ``perf``'s
    graph checkers draw nothing and say so in a valid result, so a
    suite's verdict stays its workload's; the JAX package's raise (its
    run turns "unknown").  Where it imports, nothing changes."""
    from jepsen_tpu.checker import perf as jperf
    from jepsen_tpu_torch.checker import perf as tperf
    from jepsen_tpu_torch.checker.core import check_safe

    h = [invoke_op(0, "read", None)]
    test = {"name": "p", "start_time": "20260101T000000",
            "store_base": str(tmp_path)}
    assert tperf.can_draw() is True
    monkeypatch.setattr(tperf, "can_draw", lambda: False)

    def refuse():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(jperf, "_mpl", refuse)
    got = tperf.perf().check(test, h)
    assert got["valid"] is True
    assert got["latency-graph"] == got["rate-graph"] == {
        "valid": True, "graphs": tperf.NOT_DRAWN}
    assert not (tmp_path / "p").exists()
    from jepsen_tpu.checker.core import check_safe as jcheck_safe

    want = jcheck_safe(jperf.perf(), test, [])
    assert want["valid"] == "unknown"
    assert check_safe(tperf.perf(), test, [])["valid"] is True
