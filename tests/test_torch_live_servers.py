"""The port's daemons (``jepsen_tpu_torch/live``: ``oplog``,
``kv_server``, ``queue_server``, ``replicated_server``,
``replicated_queue``) against the JAX package's.

Seeded request sequences go through both packages' request logic
(``kv_server.dispatch``, ``queue_server.dispatch``,
``replicated_server.handle_client_request`` and
``replicated_queue.dispatch_resp``, each over its real store or replica)
and must give the same replies and leave the same state; the pure cores
(``ReplicaCore``, ``QueueCore``) driven by one event sequence must give
the same ``snapshot()`` after every event; ``DurableLog`` round-trips.
Then each server does one socket round trip from a thread on port 0,
the kv daemon survives a SIGKILL as a real process on an ephemeral port,
and importing any daemon loads neither numpy nor torch."""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from jepsen_tpu.live import kv_server as jkv
from jepsen_tpu.live import oplog as joplog
from jepsen_tpu.live import queue_server as jq
from jepsen_tpu.live import replicated_queue as jrq
from jepsen_tpu.live import replicated_server as jrs
from jepsen_tpu_torch.live import kv_server as tkv
from jepsen_tpu_torch.live import oplog as toplog
from jepsen_tpu_torch.live import queue_server as tq
from jepsen_tpu_torch.live import replicated_queue as trq
from jepsen_tpu_torch.live import replicated_server as trs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAEMONS = ("oplog", "kv_server", "queue_server", "replicated_server",
           "replicated_queue")


# ---------------------------------------------------------------------------
# seeded request sequences
# ---------------------------------------------------------------------------


def kv_requests(seed: int, n: int = 120) -> list:
    """(method, path, body) triples over two keys: reads, blind writes,
    CAS hits and misses, retransmissions of a reqId, a bad path and a
    bad form."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        key = rng.choice(("x", "y"))
        roll = rng.random()
        if roll < 0.3:
            out.append(("GET", f"/v2/keys/{key}", b""))
        elif roll < 0.9:
            q = {}
            if rng.random() < 0.5:
                q["prevValue"] = str(rng.randint(1, 4))
            if rng.random() < 0.6:
                q["reqId"] = f"r{rng.randint(0, i // 3 + 1)}"
            body = urllib.parse.urlencode(
                {"value": str(rng.randint(1, 4))}).encode()
            path = f"/v2/keys/{key}"
            if q:
                path += "?" + urllib.parse.urlencode(q)
            out.append(("PUT", path, body))
        elif roll < 0.95:
            out.append(("PUT", f"/v2/keys/{key}", b"nothing=1"))
        else:
            out.append((rng.choice(("GET", "DELETE")), "/elsewhere", b""))
    return out


@pytest.mark.parametrize("volatile", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_kv_dispatch_matches_reference(tmp_path, seed, volatile):
    stores = [mod.Store(str(tmp_path / name), volatile=volatile)
              for mod, name in ((jkv, "j"), (tkv, "t"))]
    for method, path, body in kv_requests(seed):
        assert jkv.dispatch(stores[0], method, path, body) \
            == tkv.dispatch(stores[1], method, path, body)
    assert stores[0].state == stores[1].state
    assert stores[0].replies == stores[1].replies
    # recovery replays the oplog into the same state
    again = [mod.Store(str(tmp_path / name), volatile=volatile)
             for mod, name in ((jkv, "j"), (tkv, "t"))]
    assert again[0].state == again[1].state
    assert again[0].replies == again[1].replies
    assert (again[1].state == stores[1].state) is (not volatile
                                                   or not stores[1].state)
    with open(tmp_path / "j" / "oplog") as a, \
            open(tmp_path / "t" / "oplog") as b:
        assert a.read() == b.read()


def queue_commands(seed: int, n: int = 150) -> list:
    """(clock, args) pairs: ADDJOB with and without RETRY/REQID, GETJOB,
    ACKJOB of a recent or unknown id, an unknown command; the clock
    moves so that claims expire and redeliver."""
    rng = random.Random(seed)
    out, t = [], 0.0
    for i in range(n):
        t += rng.choice((0.0, 0.1, 0.5, 2.5))
        roll = rng.random()
        if roll < 0.4:
            args = ["ADDJOB", "jepsen", str(rng.randint(1, 9)), "0"]
            if rng.random() < 0.5:
                args += ["RETRY", str(rng.choice((1, 2)))]
            if rng.random() < 0.5:
                args += ["REQID", f"q{rng.randint(0, i // 4 + 1)}"]
        elif roll < 0.75:
            args = ["GETJOB", "TIMEOUT", "0", "COUNT", "1", "FROM",
                    "jepsen"]
        elif roll < 0.95:
            args = ["ACKJOB", f"D-{rng.randint(0, i // 2 + 1)}"]
        else:
            args = [rng.choice(("PING", "ADDJOB"))]
        out.append((t, args))
    return out


@pytest.mark.parametrize("volatile", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_queue_dispatch_matches_reference(tmp_path, seed, volatile):
    clock = [0.0]
    stores = []
    for mod, name in ((jq, "j"), (tq, "t")):
        s = mod.Store(str(tmp_path / name), volatile=volatile)
        s.now = lambda: clock[0]
        stores.append(s)
    for t, args in queue_commands(seed):
        clock[0] = t
        assert jq.dispatch(stores[0], list(args)) \
            == tq.dispatch(stores[1], list(args))
    for attr in ("next_id", "pending", "claimed", "replies"):
        assert getattr(stores[0], attr) == getattr(stores[1], attr), attr
    again = [mod.Store(str(tmp_path / name), volatile=volatile)
             for mod, name in ((jq, "j"), (tq, "t"))]
    assert again[0].pending == again[1].pending
    assert again[0].replies == again[1].replies


def test_resp_codec_matches_reference():
    import io

    for args in (["ADDJOB", "jepsen", "7", "0", "REQID", "op1"],
                 ["GETJOB", "TIMEOUT", "0"], ["x" * 300, "ü"]):
        wire = tq.encode_resp_command(args)
        assert wire == jq.encode_resp_command(args)
        assert tq.read_resp_command(io.BytesIO(wire)) \
            == jq.read_resp_command(io.BytesIO(wire)) == args
    assert tq.encode_resp_job("jepsen", "D-3", "9") \
        == jq.encode_resp_job("jepsen", "D-3", "9")
    for args in (["ADDJOB", "q", "b", "0", "retry", "3", "REQID", "r"],
                 ["ADDJOB", "q", "b", "0"]):
        assert tq.parse_addjob(args) == jq.parse_addjob(args)
    assert tq.read_resp_command(io.BytesIO(b"")) is None
    with pytest.raises(ValueError):
        tq.read_resp_command(io.BytesIO(b"+OK\r\n"))


# ---------------------------------------------------------------------------
# the replicated shells over real one-node replicas
# ---------------------------------------------------------------------------


def _leader(mod, tmp_path, name, cls="Replica"):
    """A one-node replica of ``mod`` that has won its election (a
    one-node group needs no peer), with a lease long enough for a test;
    its ticker never starts."""
    rep = getattr(mod, cls)(0, [("127.0.0.1", 1)],
                            str(tmp_path / name / "oplog"), lease_s=600.0)
    rep._campaign()
    assert rep.role == "leader" and rep.leader_serving()
    return rep


def _view(rep) -> tuple:
    """A replica's state without its wall-clock lease."""
    return rep.role, rep.term, rep.seq, rep.leader_id, dict(rep.state)


class _Forward:
    """A follower's forward leg with seeded outcomes: the leader's
    answer, a refused connection, or an indeterminate error."""

    def __init__(self, seed):
        self.rng = random.Random(seed)
        self.calls = []

    def __call__(self, lid, *req):
        self.calls.append((lid, *req))
        roll = self.rng.random()
        if roll < 0.2:
            raise ConnectionRefusedError("leader down")
        if roll < 0.4:
            raise OSError("reset mid-reply")
        return 200, {"via": lid, "req": [str(x) for x in req]}


class _Follower:
    """Duck-types the replica surface ``handle_client_request`` reads,
    as a follower that knows leader 2."""

    id = 1
    leader_id = 2

    def __init__(self):
        self.lock = threading.Lock()

    def get(self, key):
        return 503, {"errorCode": 300, "message": "not leader"}

    def put(self, key, value, prev=None):
        return 503, {"errorCode": 300, "message": "not leader"}


@pytest.mark.parametrize("seed", [1, 2])
def test_handle_client_request_matches_reference(tmp_path, seed):
    reps = [_leader(jrs, tmp_path, "j"), _leader(trs, tmp_path, "t")]
    fwd = [_Forward(seed), _Forward(seed)]
    for method, path, body in kv_requests(seed):
        got = [mod.handle_client_request(rep, method, path, body,
                                         proxied=False, forward=f)
               for mod, rep, f in zip((jrs, trs), reps, fwd)]
        assert got[0] == got[1]
    assert _view(reps[0]) == _view(reps[1])
    assert not fwd[0].calls and not fwd[1].calls
    # a follower proxies, and a proxied request is never re-proxied
    for proxied in (False, True):
        for method, path, body in kv_requests(seed + 10, 40):
            got = [mod.handle_client_request(
                _Follower(), method, path, body, proxied=proxied,
                forward=f) for mod, f in zip((jrs, trs), fwd)]
            assert got[0] == got[1]
    assert fwd[0].calls == fwd[1].calls and fwd[1].calls


def rqueue_commands(seed: int, n: int = 100) -> list:
    return [args for _t, args in queue_commands(seed, n)]


@pytest.mark.parametrize("seed", [1, 2])
def test_dispatch_resp_matches_reference(tmp_path, seed):
    reps = [_leader(jrq, tmp_path, "j", "QueueReplica"),
            _leader(trq, tmp_path, "t", "QueueReplica")]
    for args in rqueue_commands(seed):
        got = [mod.dispatch_resp(rep, list(args), proxied=False,
                                 forward=_Forward(seed))
               for mod, rep in zip((jrq, trq), reps)]
        assert got[0] == got[1]
    assert _view(reps[0]) == _view(reps[1])
    assert list(reps[0].pending.items()) == list(reps[1].pending.items())
    assert sorted(reps[0].claimed) == sorted(reps[1].claimed)
    assert reps[0].reply_cache == reps[1].reply_cache


# ---------------------------------------------------------------------------
# the pure cores under one event sequence
# ---------------------------------------------------------------------------


def core_events(seed: int, n: int = 300) -> list:
    rng = random.Random(seed)
    out, now = [], 0.0
    for _ in range(n):
        now += rng.choice((0.0, 0.05, 0.3, 1.1))
        out.append((now, rng.randrange(12), rng.randrange(3),
                    rng.randint(0, 6), rng.random()))
    return out


def drive_core(core, events, queue: bool) -> list:
    """Feed one core the event sequence; the snapshot after each event
    and every reply."""
    log: list = []
    snaps = []
    for now, kind, peer, n, jitter in events:
        if kind == 0:
            r = core.step_leader_expiry(now)
        elif kind == 1:
            r = core.election_due(now) and core.begin_campaign()
        elif kind == 2:
            r = core.win_campaign(core.term, now)
        elif kind == 3:
            r = core.lose_campaign(now, jitter)
        elif kind == 4:
            r = core.heartbeat_ack(core.term, now)
        elif kind == 5:
            r = core.on_ping(core.term + n % 2, peer, n, now)
        elif kind == 6:
            r = core.on_vote(core.term + n % 3, peer, n, now)
        elif kind == 7:
            e = log[n % len(log)] if log else {"seq": 1, "op": "set",
                                               "k": "x", "v": "1"}
            r = core.on_append(dict(e), now)
        elif kind == 8 and not queue:
            r = core.put_prepare("x", str(n), None if n % 2 else str(n - 1),
                                 now)
            if r[2] is not None:
                log.append(r[2])
                core.apply(r[2])
        elif kind == 8:
            r = core.addjob_prepare(str(n), 1.0, now)
            if r[2] is not None:
                log.append(r[2])
                core.apply(r[2])
        elif kind == 9 and not queue:
            r = core.get("x", now)
        elif kind == 9:
            core.expire_claims(now)
            r = core.claim(now)
        elif kind == 10 and queue:
            jids = sorted(core.pending) + sorted(core.claimed)
            r = core.ackjob_prepare(jids[n % len(jids)] if jids else "D-0-1",
                                    now)
            if r[2] is not None:
                log.append(r[2])
                core.apply(r[2])
        else:
            r = (core.leader_serving(now), core.status(now))
        snaps.append((core.snapshot(), repr(r)))
    return snaps


@pytest.mark.parametrize("mode", ["clean", "volatile", "split-brain"])
@pytest.mark.parametrize("seed", [1, 2])
def test_replica_core_snapshots_match(seed, mode):
    kw = {"volatile": mode == "volatile",
          "split_brain": mode == "split-brain", "lease_s": 1.0}
    events = core_events(seed)
    got = [drive_core(mod.ReplicaCore(0, 3, now=0.0, **kw), events, False)
           for mod in (jrs, trs)]
    assert got[0] == got[1]


@pytest.mark.parametrize("volatile", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_queue_core_snapshots_match(seed, volatile):
    events = core_events(seed)
    got = [drive_core(mod.QueueCore(0, 3, now=0.0, volatile=volatile,
                                    lease_s=1.0), events, True)
           for mod in (jrq, trq)]
    assert got[0] == got[1]


def test_durable_log_round_trips(tmp_path):
    for mod, name in ((joplog, "j"), (toplog, "t")):
        log = mod.DurableLog(str(tmp_path / name)).open()
        for line in ("a 1", "b 2\n", "c 3"):
            log.append(line)
        with open(log.path, "ab") as f:
            f.write(b"torn tail")  # a crashed writer's half line
        assert list(log.replay()) == ["a 1", "b 2", "c 3"]
        lines, off = log.tail(0)
        assert lines == ["a 1", "b 2", "c 3"]
        assert log.tail(off) == ([], off)
        assert log.tail(4) == (["b 2", "c 3"], off)
        vol = mod.DurableLog(str(tmp_path / f"{name}v"), volatile=True)
        vol.open().append("x")
        assert list(vol.replay()) == [] and vol.tail(0) == ([], 0)
    with open(tmp_path / "j" / "oplog", "rb") as a, \
            open(tmp_path / "t" / "oplog", "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# one socket round trip per server, served from a thread on port 0
# ---------------------------------------------------------------------------


def _serve(srv):
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv.server_address[1]


def _http(method, url, body=None, headers=None, timeout=5):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _resp(port, *args):
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(tq.encode_resp_command(list(args)))
        return s.recv(4096)


def test_kv_server_round_trip(tmp_path):
    srv = tkv.Server(("127.0.0.1", 0), tkv.Handler)
    srv.store = tkv.Store(str(tmp_path))
    port = _serve(srv)
    try:
        url = f"http://127.0.0.1:{port}/v2/keys/x"
        assert _http("GET", url)[0] == 404
        assert _http("PUT", url, b"value=3") == (
            200, {"action": "set", "node": {"key": "/x", "value": "3"}})
        assert _http("PUT", url + "?prevValue=2", b"value=4")[0] == 412
        assert _http("GET", url)[1]["node"]["value"] == "3"
    finally:
        srv.shutdown()
        srv.server_close()


def test_queue_server_round_trip(tmp_path):
    srv = tq.Server(("127.0.0.1", 0), tq.Handler)
    srv.store = tq.Store(str(tmp_path))
    port = _serve(srv)
    try:
        assert _resp(port, "ADDJOB", "jepsen", "7", "0") == b"+D-0\r\n"
        assert _resp(port, "GETJOB", "TIMEOUT", "0", "COUNT", "1", "FROM",
                     "jepsen") == tq.encode_resp_job("jepsen", "D-0", "7")
        assert _resp(port, "ACKJOB", "D-0") == b":1\r\n"
    finally:
        srv.shutdown()
        srv.server_close()


def test_replicated_server_round_trip(tmp_path):
    srv = trs.Server(("127.0.0.1", 0), trs.Handler)
    port = srv.server_address[1]
    srv.replica = trs.Replica(0, [("127.0.0.1", port)],
                              str(tmp_path / "oplog"), lease_s=600.0)
    srv.replica._campaign()
    _serve(srv)
    try:
        url = f"http://127.0.0.1:{port}"
        st, status = _http("GET", url + "/_repl/status")
        assert st == 200 and status["role"] == "leader"
        assert _http("PUT", url + "/v2/keys/x", b"value=5",
                     {"Content-Type": "application/x-www-form-urlencoded"}
                     )[0] == 200
        assert _http("GET", url + "/v2/keys/x")[1]["node"]["value"] == "5"
        with open(tmp_path / "oplog") as f:
            assert json.loads(f.readline())["v"] == "5"
    finally:
        srv.shutdown()
        srv.server_close()


def test_replicated_queue_round_trip(tmp_path):
    srv = trq.RespServer(("127.0.0.1", 0), trq.RespHandler)
    port = srv.server_address[1]
    srv.replica = trq.QueueReplica(0, [("127.0.0.1", port)],
                                   str(tmp_path / "oplog"), lease_s=600.0)
    srv.replica._campaign()
    _serve(srv)
    try:
        jid = _resp(port, "ADDJOB", "jepsen", "8", "0", "REQID", "a")
        assert jid.startswith(b"+D-")
        assert _resp(port, "ADDJOB", "jepsen", "8", "0", "REQID", "a") \
            == jid
        got = _resp(port, "GETJOB", "TIMEOUT", "0", "COUNT", "1", "FROM",
                    "jepsen")
        assert got == tq.encode_resp_job("jepsen", jid[1:-2].decode(), "8")
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# a real process: SIGKILL loses only what was never acked
# ---------------------------------------------------------------------------


def _free_port():
    """A port drawn at random below the kernel's ephemeral range (which
    starts at 32768) and free now: the daemon binds it twice, across a
    SIGKILL, and the kernel hands no other socket a port from there."""
    rng = random.Random()
    while True:
        port = rng.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def _spawn_kv(port, data):
    p = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.live.kv_server",
         str(port), data], cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 20
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return p
        except OSError:
            assert p.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)


def test_kv_server_kill9_loses_only_unacked(tmp_path):
    """Acked PUTs are fsynced before the reply: after a SIGKILL with a
    write in flight, the recovered value is the last acked write or the
    in-flight one, never an older one."""
    port, data = _free_port(), str(tmp_path / "kv")
    p = _spawn_kv(port, data)
    url = f"http://127.0.0.1:{port}/v2/keys/r"
    try:
        for v in ("1", "2", "3"):
            assert _http("PUT", url, urllib.parse.urlencode(
                {"value": v}).encode())[0] == 200
        s = socket.create_connection(("127.0.0.1", port), timeout=2)
        body = b"value=99"
        s.sendall(b"PUT /v2/keys/r HTTP/1.1\r\nHost: x\r\nContent-Type: "
                  b"application/x-www-form-urlencoded\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=10)
        s.close()
        p = _spawn_kv(port, data)
        st, out = _http("GET", url)
        assert st == 200 and out["node"]["value"] in ("3", "99")
    finally:
        p.kill()
        p.wait(timeout=10)


def test_daemons_start_with_the_standard_library_alone():
    """Every daemon module imports without numpy or torch (the package
    ``live/__init__.py`` resolves its corpus exports lazily), and the
    corpus exports still resolve."""
    code = ("import sys\n"
            + "".join(f"import jepsen_tpu_torch.live.{m}\n" for m in DAEMONS)
            + "bad = [m for m in ('numpy', 'torch') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "from jepsen_tpu_torch.live import corpus_replay, bank\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
