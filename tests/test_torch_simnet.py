"""The port's shell-layer model checking (``analyze/simnet.py`` and the
MC2xx codes) against the JAX package's: the counterparts of
``tests/test_modelcheck_shell.py``'s fast cases.

* **Parity**: a fault-free simnet schedule gives the same client-visible
  history in both packages, and the same as the port's real daemon
  (spawned on ephemeral ports) serving the same op program, for all four
  shell families.
* **Reduction soundness** over the transport worlds, and the clean
  shells clearing their scope with the reduction biting.
* **Seeded MC201 to MC205**: each caught with a replaying, shrunk
  certificate equal to the JAX package's, confirmed on its route.
* **Wire-level regressions**: a GETJOB whose reply dies releases its
  claim, a retransmitted PUT with the same reqId gets the same reply,
  and the proxy's error classes."""

import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from jepsen_tpu.analyze import modelcheck as jmc
from jepsen_tpu.suites.disque import RespConn, RespError
from jepsen_tpu_torch.analyze import modelcheck as mc
from jepsen_tpu_torch.analyze import simnet
from jepsen_tpu_torch.live import queue_server
from jepsen_tpu_torch.live.replicated_queue import PEER_OFFSET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def triples(history):
    return [(op.type, op.f, op.value) for op in history]


def violation_set(result):
    return {(v["code"], v["state"]) for v in result["violations"]}


# ---------------------------------------------------------------------------
# fault-free drivers and real daemons
# ---------------------------------------------------------------------------


def _fault_free_transport(mod, family, ops):
    """A transport world with no fault enabled: only send/deliver, so
    the first enabled event is the one schedule."""
    scope = mod.Scope(nodes=3, ops=tuple(ops), crashes=0, partitions=0,
                      max_events=99)
    w = mod.make_world(family, "clean", scope)
    while True:
        evs = w.enabled()
        if not evs:
            return w
        assert w.execute(evs[0]) is None


def _fault_free_repl(mod, ops, via_node):
    scope = mod.Scope(nodes=3, ops=tuple(ops), crashes=0, partitions=0,
                      max_events=99)
    w = mod.make_world("shell-replicated", "clean", scope)
    for _ in ops:
        assert w.execute(("op", via_node)) is None
    return w


def _sim(family, ops, via_node=None):
    """The port's fault-free history, held to the JAX package's."""
    if family == "shell-replicated":
        t, j = (_fault_free_repl(m, ops, via_node) for m in (mc, jmc))
    else:
        t, j = (_fault_free_transport(m, family, ops) for m in (mc, jmc))
    assert triples(t.history) == triples(j.history)
    return triples(t.history)


def _free_ports(n, offset=0):
    """``n`` ports drawn at random below the kernel's ephemeral range
    (which starts at 32768), so that no port the kernel hands another
    socket meanwhile can be one of them, each free now with ``port +
    offset`` free too."""
    rng = random.Random()
    out: list = []
    while len(out) < n:
        port = rng.randrange(20000, 32000)
        held = []
        try:
            for q in {port, port + offset} - set(out):
                s = socket.socket()
                held.append(s)
                s.bind(("127.0.0.1", q))
            out.append(port)
        except OSError:
            pass
        finally:
            for s in held:
                s.close()
    return out


class _Exited(Exception):
    """A daemon exited before it listened (its port was taken)."""


def _spawn(module, port, *args):
    p = subprocess.Popen(
        [sys.executable, "-m", f"jepsen_tpu_torch.live.{module}",
         str(port), *map(str, args)], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 20
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return p
        except OSError:
            if p.poll() is not None:
                raise _Exited(f"{module} on {port} exited {p.returncode}")
            assert time.monotonic() < deadline
            time.sleep(0.05)


def _cluster(module, n, args, offset=0):
    """(ports, processes) of ``n`` daemons, ``args(i, ports)`` each;
    drawn again, up to three times, when one finds its port taken."""
    for attempt in range(3):
        ports = _free_ports(n, offset)
        procs = []
        try:
            for i, port in enumerate(ports):
                procs.append(_spawn(module, port, *args(i, ports)))
            return ports, procs
        except _Exited:
            _stop(procs)
            if attempt == 2:
                raise


def _stop(procs):
    for p in procs:
        p.kill()
    for p in procs:
        p.wait(timeout=10)


def _http(method, url, body=None, timeout=5):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _leader(status_port, deadline_s=25.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        leaders = []
        for i, port in enumerate(status_port):
            try:
                if _http("GET", f"http://127.0.0.1:{port}/_repl/status",
                         timeout=1)[1].get("role") == "leader":
                    leaders.append(i)
            except OSError:
                pass
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.1)
    raise AssertionError("no single leader")


# ---------------------------------------------------------------------------
# parity: the fault-free simnet history is the real daemon's
# ---------------------------------------------------------------------------

#: CAS hit, read, blind write, CAS miss, read
KV_OPS = (("cas", 1, 2), ("r",), ("w", 5), ("cas", 9, 7), ("r",))
QUEUE_OPS = (("add", 7), ("add", 8), ("get",), ("get",), ("get",))
REPL_OPS = (("w", 1), ("r",), ("w", 2), ("r",))


def _kv_client_history(port):
    base = f"http://127.0.0.1:{port}/v2/keys/{simnet.KEY}"
    hist = []
    for i, verb in enumerate(KV_OPS):
        if verb[0] == "r":
            hist.append(("invoke", "read", None))
            st, b = _http("GET", base)
            hist.append(("ok", "read", int(b["node"]["value"])
                         if st == 200 else simnet.ABSENT))
            continue
        if verb[0] == "cas":
            f, value, new = "cas", [verb[1], verb[2]], verb[2]
            qs = f"prevValue={verb[1]}&reqId=op{i}"
        else:
            f, value, new = "write", verb[1], verb[1]
            qs = f"reqId=op{i}"
        hist.append(("invoke", f, value))
        st, _b = _http("PUT", f"{base}?{qs}",
                       urllib.parse.urlencode({"value": new}).encode())
        hist.append(("ok" if st == 200 else "fail", f, value))
    return hist


def _queue_client_history(conn):
    hist = []
    for i, verb in enumerate(QUEUE_OPS):
        if verb[0] == "add":
            hist.append(("invoke", "enqueue", verb[1]))
            jid = conn.command("ADDJOB", "jepsen", str(verb[1]), 0,
                               "REQID", f"op{i}")
            hist.append(("ok" if jid else "fail", "enqueue", verb[1]))
        else:
            hist.append(("invoke", "dequeue", None))
            got = conn.command("GETJOB", "TIMEOUT", 0, "COUNT", 1,
                               "FROM", "jepsen")
            hist.append(("fail", "dequeue", None) if got is None
                        else ("ok", "dequeue", int(got[0][2])))
    return hist


def test_parity_shell_kv(tmp_path):
    sim = _sim("shell-kv", KV_OPS)
    (port,), (p,) = _cluster("kv_server", 1,
                             lambda i, ports: (tmp_path / "kv",))
    try:
        # the register the simulated world starts with
        _http("PUT", f"http://127.0.0.1:{port}/v2/keys/{simnet.KEY}",
              b"value=1")
        real = _kv_client_history(port)
    finally:
        _stop([p])
    assert sim == real


def test_parity_shell_queue(tmp_path):
    sim = _sim("shell-queue", QUEUE_OPS)
    (port,), (p,) = _cluster("queue_server", 1,
                             lambda i, ports: (tmp_path / "q",))
    try:
        real = _queue_client_history(RespConn("127.0.0.1", port, timeout=5))
    finally:
        _stop([p])
    assert sim == real


def test_parity_shell_rqueue(tmp_path):
    """The queue program through the replicated queue's JPROXY relay:
    the simulated client enters at a follower, the real one connects to
    a node that is not the leader."""
    sim = _sim("shell-rqueue", QUEUE_OPS)
    ports, procs = _cluster(
        "replicated_queue", 3, lambda i, ports: (
            tmp_path / f"n{i}", "--id", i, "--peers",
            ",".join(f"127.0.0.1:{p}" for p in ports),
            "--oplog", tmp_path / "shared" / "oplog", "--lease-ms", 350),
        offset=PEER_OFFSET)
    try:
        follower = (_leader([p + PEER_OFFSET for p in ports]) + 1) % 3
        # the follower must know the leader before the first proxied
        # command, or it answers -NOLEADER (a fault this schedule omits)
        deadline = time.monotonic() + 25
        while True:
            try:
                conn = RespConn("127.0.0.1", ports[follower], timeout=5)
                assert conn.command("GETJOB", "TIMEOUT", 0, "COUNT", 1,
                                    "FROM", "jepsen") is None
                break
            except (RespError, OSError):
                assert time.monotonic() < deadline
                time.sleep(0.15)
        real = _queue_client_history(conn)
    finally:
        _stop(procs)
    assert sim == real


def test_parity_shell_replicated(tmp_path):
    """Writes and reads through a follower: every request takes the
    proxy decision of ``handle_client_request``, simulated and real."""
    sim = _sim("shell-replicated", REPL_OPS, via_node=1)
    ports, procs = _cluster(
        "replicated_server", 3, lambda i, ports: (
            tmp_path / f"n{i}", "--id", i, "--peers",
            ",".join(map(str, ports)), "--oplog",
            tmp_path / "shared" / "oplog", "--lease-ms", 350))
    try:
        follower = (_leader(ports) + 1) % 3
        url = f"http://127.0.0.1:{ports[follower]}/v2/keys/{simnet.KEY}"
        real = []
        for verb in REPL_OPS:
            if verb[0] == "w":
                real.append(("invoke", "write", verb[1]))
                deadline = time.monotonic() + 25
                while _http("PUT", url, urllib.parse.urlencode(
                        {"value": verb[1]}).encode())[0] != 200:
                    assert time.monotonic() < deadline
                    time.sleep(0.15)
                real.append(("ok", "write", verb[1]))
            else:
                real.append(("invoke", "read", None))
                st, b = _http("GET", url)
                assert st == 200, (st, b)
                real.append(("ok", "read", int(b["node"]["value"])))
    finally:
        _stop(procs)
    assert sim == real


# ---------------------------------------------------------------------------
# reduction soundness and clean shells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,mode", [
    ("shell-kv", "volatile"),
    ("shell-queue", "volatile"),
    ("shell-replicated", "stale-proxy"),
])
def test_dpor_soundness_shell_seeded(family, mode):
    scope = mc.default_scope(family, mode)
    on = mc.explore(family, mode, scope, dpor=True, max_violations=10_000)
    off = mc.explore(family, mode, scope, dpor=False,
                     max_violations=10_000)
    assert on["explored"]["complete"] and off["explored"]["complete"]
    assert violation_set(on) == violation_set(off)
    assert on["violations"]
    assert on["explored"]["sleep_prunes"] > 0
    assert on["explored"]["events"] <= off["explored"]["events"]
    j = jmc.explore(family, mode, jmc.default_scope(family, mode),
                    dpor=False, max_violations=10_000)
    assert off["explored"] == j["explored"]


@pytest.mark.parametrize("family", mc.SHELL_FAMILIES)
def test_clean_shell_passes_with_reduction_biting(family):
    r = mc.run_mc(family, "clean", dpor=True)
    assert r["ok"], r["violations"][:1]
    assert r["explored"]["complete"] and r["explored"]["states"] > 0
    assert r["explored"]["prune_ratio"] > 0


def test_sweep_api_shell_families():
    s = mc.run_mc_sweep(mc.SHELL_FAMILIES)
    assert s["ok"], [(r["family"], r["mode"], r["ok"]) for r in s["runs"]]
    j = jmc.run_mc_sweep(jmc.SHELL_FAMILIES)
    assert [r["explored"] for r in s["runs"]] \
        == [r["explored"] for r in j["runs"]]


# ---------------------------------------------------------------------------
# seeded MC201 to MC205: the certificate lifecycle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,mode,code,route,fs,banked", [
    ("shell-kv", "volatile", "MC202", "engine", {"read", "cas"}, True),
    ("shell-queue", "volatile", "MC201", "engine", {"enqueue", "drain"},
     True),
    ("shell-rqueue", "volatile", "MC201", "engine", {"enqueue", "drain"},
     True),
    ("shell-queue", "session-leak", "MC204", "queue", {"drain"}, True),
    ("shell-replicated", "stale-proxy", "MC205", "engine", set(), True),
    ("shell-replicated", "proxy-loop", "MC203", "loop", set(), False),
])
def test_seeded_shell_caught(tmp_path, family, mode, code, route, fs,
                             banked):
    r = mc.run_mc(family, mode, dpor=True,
                  bank_base=str(tmp_path / "corpus"))
    j = jmc.run_mc(family, mode, dpor=True,
                   bank_base=str(tmp_path / "jcorpus"))
    assert json.dumps(r, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert not r["ok"]
    v = next(v for v in r["violations"] if v["code"] == code)
    assert v["replayed"]
    assert len(v["schedule"]) == v["shrunk"]["n_to"] <= v["shrunk"]["n_from"]
    c = v["confirm"]
    assert c["route"] == route and c["engine_valid"] is False
    assert c["audit_ok"] is True and c["audit_checked"]
    assert fs <= {op["f"] for op in v["history"]}
    if banked:
        assert v["banked"]["banked"] >= 1
    else:
        assert c["audit_checked"] == "loop-replay"
        assert v["banked"]["banked"] == 0


def test_shell_certificate_replays_via_module_api():
    r = mc.run_mc("shell-queue", "volatile", dpor=True)
    v = next(x for x in r["violations"] if x["code"] == "MC201")
    rep = mc.replay_certificate(v)
    assert rep["reproduced"] and rep["code"] == v["code"]
    assert jmc.replay_certificate(v)["reproduced"]
    broken = dict(v, schedule=v["schedule"][:1])
    assert not mc.replay_certificate(broken)["reproduced"]


# ---------------------------------------------------------------------------
# wire-level regressions for the bugs the seeded modes encode
# ---------------------------------------------------------------------------


def test_queue_reply_failure_releases_claim(tmp_path):
    """MC204's fix on the wire: a GETJOB whose reply dies on the socket
    returns its claim to pending, so a reconnecting consumer sees the
    job at once instead of after the retry window."""

    class FlakyHandler(queue_server.Handler):
        def _send(self, payload):
            # drop exactly one job reply
            if payload.startswith(b"*") \
                    and not payload.startswith(b"*-1") \
                    and not getattr(self.server, "dropped", False):
                self.server.dropped = True
                raise OSError("injected reply-send failure")
            super()._send(payload)

    srv = queue_server.Server(("127.0.0.1", 0), FlakyHandler)
    srv.store = queue_server.Store(str(tmp_path / "q"))
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c = RespConn("127.0.0.1", port, timeout=5)
        assert c.command("ADDJOB", "jepsen", "7", 0, "RETRY", 600)
        try:
            c.command("GETJOB", "TIMEOUT", 0, "COUNT", 1, "FROM", "jepsen")
        except Exception:  # noqa: BLE001 — the connection just died
            pass
        got = RespConn("127.0.0.1", port, timeout=5).command(
            "GETJOB", "TIMEOUT", 0, "COUNT", 1, "FROM", "jepsen")
        assert got is not None and got[0][2] == "7"
    finally:
        srv.shutdown()
        srv.server_close()


def test_kv_reqid_dedup_on_the_wire(tmp_path):
    """MC202's fix on the wire: a retransmitted PUT with the same reqId
    gets the same reply instead of re-running the CAS."""
    (port,), (p,) = _cluster("kv_server", 1,
                             lambda i, ports: (tmp_path / "kv",))
    base = f"http://127.0.0.1:{port}/v2/keys/x"
    try:
        assert _http("PUT", base, b"value=1")[0] == 200
        url = f"{base}?prevValue=1&reqId=opA"
        st1, b1 = _http("PUT", url, b"value=2")
        st2, b2 = _http("PUT", url, b"value=2")
        assert (st1, st2) == (200, 200) and b1 == b2
        # the same CAS without the idempotency key re-runs and fails
        assert _http("PUT", f"{base}?prevValue=1", b"value=2")[0] == 412
    finally:
        _stop([p])


def test_replicated_proxy_forward_error_classes():
    """A refused forward falls back to the local 503 (the op did not
    happen); any other socket error is a 504; a proxied request is
    answered locally."""
    from jepsen_tpu_torch.live.replicated_server import (
        PREFIX, handle_client_request)

    class Follower:
        id = 1
        lock = threading.Lock()
        leader_id = 0

        def put(self, key, value, prev=None):
            return 503, {"errorCode": 300, "message": "not leader"}

        def get(self, key):
            return 503, {"errorCode": 300, "message": "not leader"}

    def refused(lid, m, p, b):
        raise ConnectionRefusedError("leader down")

    def torn(lid, m, p, b):
        raise OSError("connection reset mid-reply")

    def looping(lid, m, p, b):
        raise AssertionError("a proxied request must not re-forward")

    for fwd, proxied, want in ((refused, False, 503), (torn, False, 504),
                               (looping, True, 503)):
        st, _ = handle_client_request(Follower(), "PUT", PREFIX + "x",
                                      b"value=1", proxied=proxied,
                                      forward=fwd)
        assert st == want
