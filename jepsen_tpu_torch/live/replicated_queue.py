"""live replicated queue node — a 3-replica disque-RESP cluster.
A copy of the JAX package's ``live/replicated_queue.py``, stdlib-only.

One logical node of the live **replicated-queue** family: the same
disque RESP subset as ``live/queue_server.py`` (ADDJOB/GETJOB/ACKJOB,
driven by the disque suite's ``DisqueClient`` unchanged), but as one
replica of the consensus group from ``live/replicated_server.py`` —
this is where redelivery-under-partition bugs live, and the single-node
queue could never stage them.

Split of responsibilities over the shared :class:`~.replicated_server.
Replica` core (leader lease, majority-ack commit, catch-up — reused,
not reimplemented):

  * **ADDJOB / ACKJOB are replicated commits** — the leader appends
    the entry to the shared oplog (fsync, the commit record), fans it
    out to peers, and acks the client only on majority.  No quorum →
    ``-NOREPL`` (the reply ``DisqueClient`` already maps to ``:info``:
    a successor may adopt the entry).
  * **claims are leader-local** — GETJOB moves a job from pending to a
    claimed set with a retry deadline on the leader only.  A claim
    that expires un-acked is redelivered; a leader that dies or is
    deposed loses its claims entirely, so the NEW leader redelivers
    every un-acked job from its own pending set — at-least-once by
    construction, the duplicate-delivery case ``total_queue`` must
    tolerate (and the lost-acked-enqueue case it must catch).
  * **followers proxy** — a non-leader forwards the raw RESP command
    to its believed leader (source-bound, so the forward rides the
    same per-peer links the partitioner cuts) and relays the reply.
    A refused connection maps to ``-ERR NOLEADER`` (definitely didn't
    happen → ``:fail``); anything indeterminate maps to ``-NOREPL``
    (→ ``:info``).  Forwards are wrapped in a ``JPROXY`` envelope so
    a confused leadership view can't proxy in a loop.

Like the KV node, the queue brain is a pure core —
:class:`QueueCore`, the consensus machine of
:class:`~.replicated_server.ReplicaCore` plus the pending/claimed job
state — and :class:`QueueReplica` is its daemon shell.
``analyze/modelcheck.py`` schedules the same core deterministically.

Peer consensus traffic rides the HTTP surface of the base class on
``port + PEER_OFFSET`` (vote/ping/append/status), the client surface
is RESP on ``port`` — both bound to the node's own loopback address.

Seeded mode ``volatile`` (inherited): no durable log, elections skip
the completeness check, appends blind-adopt — under a bridge grudge a
cut-off replica wins an election through the overlap node and serves
a pending set missing acked ADDJOBs: the lost-enqueue violation the
campaign's seeded redelivery cell exists to detect.

Usage::

  python -m jepsen_tpu_torch.live.replicated_queue PORT DATA_DIR \
      --id I --peers H1:P1,H2:P2,H3:P3 --oplog PATH \
      [--lease-ms MS] [--host H] [volatile]

``--peers`` are the RESP ``host:port`` of every replica (self
included); each peer's HTTP surface is derived at ``port +
PEER_OFFSET``.
"""

from __future__ import annotations

import socket
import socketserver
import sys
import threading
import time
from collections import OrderedDict

from .queue_server import (encode_resp_command, encode_resp_job,
                           parse_addjob, read_resp_command)
from .replicated_server import Handler as PeerHandler
from .replicated_server import Replica, ReplicaCore
from .replicated_server import Server as PeerServer
from .replicated_server import parse_peers

#: the peer/consensus HTTP surface lives this far above the RESP port
PEER_OFFSET = 500


class QueueCore(ReplicaCore):
    """The pure queue state machine over the pure consensus core:
    committed jobs (pending), leader-local claims with redelivery
    deadlines, and the prepare half of every client verb.  No clock
    reads, no wire — the shell (and the model checker) drive it."""

    REPLAY_OPS = ("add", "ack")

    def __init__(self, *args, **kwargs):
        #: job id -> (body, retry_s): committed, deliverable
        self.pending: OrderedDict[str, tuple[str, float]] = OrderedDict()
        #: job id -> (body, retry_s, redeliver-at): leader-local claims
        self.claimed: dict[str, tuple[str, float, float]] = {}
        super().__init__(*args, **kwargs)

    def apply(self, e: dict) -> None:
        if e.get("op") == "add":
            if e["jid"] not in self.claimed:
                self.pending[e["jid"]] = (e["body"],
                                          float(e.get("retry", 1.0)))
        elif e.get("op") == "ack":
            self.pending.pop(e["jid"], None)
            self.claimed.pop(e["jid"], None)
        self.seq = e["seq"]

    def expire_claims(self, now: float) -> None:
        """Claims past their redelivery deadline go back to pending —
        at-least-once, by construction."""
        for jid in [j for j, (_, _, t) in self.claimed.items()
                    if t <= now]:
            body, retry_s, _ = self.claimed.pop(jid)
            self.pending[jid] = (body, retry_s)

    def claim(self, now: float) -> tuple[str, str] | None:
        """Move the oldest pending job to claimed (leader-local, not
        replicated) -> (jid, body), or None when nothing is pending."""
        if not self.pending:
            return None
        jid, (body, retry_s) = self.pending.popitem(last=False)
        self.claimed[jid] = (body, retry_s, now + retry_s)
        return jid, body

    def addjob_prepare(self, body: str, retry_s: float, now: float
                       ) -> tuple[str, str | None, dict | None]:
        """ADDJOB up to the commit -> (status, jid, entry); the owner
        runs the commit protocol when ``entry`` is non-None."""
        if not self.leader_serving(now):
            return "noleader", None, None
        # adopt the shared-oplog tail first: a deposed leader's
        # un-acked append must not share a seq (or a jid) with this
        # commit
        seq = self.next_seq()
        jid = f"D-{self.term}-{seq}"
        entry = {"op": "add", "seq": seq,
                 "term": self.term, "leader": self.id,
                 "jid": jid, "body": body, "retry": retry_s}
        return "ok", jid, entry

    def ackjob_prepare(self, jid: str, now: float
                       ) -> tuple[str, int | None, dict | None]:
        """ACKJOB up to the commit -> (status, count, entry); a jid
        this replica has never heard of acks 0 with no commit."""
        if not self.leader_serving(now):
            return "noleader", None, None
        seq = self.next_seq()  # tail first, like addjob
        if jid not in self.claimed and jid not in self.pending:
            return "ok", 0, None
        entry = {"op": "ack", "seq": seq,
                 "term": self.term, "leader": self.id, "jid": jid}
        return "ok", 1, entry

    def snapshot(self) -> tuple:
        return super().snapshot() + (
            tuple(self.pending.items()),
            tuple(sorted((j, b, r, round(t, 9))
                         for j, (b, r, t) in self.claimed.items())))


class QueueReplica(Replica):
    """The queue daemon shell: RESP wire + condvar around a
    :class:`QueueCore`."""

    CORE_CLS = QueueCore

    def __init__(self, node_id: int, resp_peers: list, oplog_path: str,
                 lease_s: float = 0.7, volatile: bool = False,
                 host: str = "127.0.0.1"):
        self.resp_peers = [p if isinstance(p, tuple)
                           else ("127.0.0.1", p) for p in resp_peers]
        super().__init__(
            node_id,
            [(h, p + PEER_OFFSET) for h, p in self.resp_peers],
            oplog_path, lease_s=lease_s, volatile=volatile, host=host)
        self.cv = threading.Condition(self.lock)
        #: ADDJOB REQID -> the exact reply bytes it earned; a client
        #: retransmission after a lost reply relays the original ack
        #: instead of committing a second copy (volatile skips it —
        #: the seeded MC201 mode)
        self.reply_cache: dict[str, bytes] = {}

    @property
    def pending(self):
        return self.core.pending

    @property
    def claimed(self):
        return self.core.claimed

    # -- the client surface (leader path) -----------------------------

    def addjob(self, body: str, retry_s: float) -> tuple[str, str | None]:
        if not self.leader_serving():
            return "noleader", None
        with self.lock:
            st, jid, entry = self.core.addjob_prepare(
                body, retry_s, time.monotonic())
            if st != "ok":
                return st, None
            if not self.commit_locked(entry):
                return "noquorum", None
            self.cv.notify_all()
            return "ok", jid

    def getjob(self, timeout_ms: int) -> tuple[str, tuple | None]:
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self.cv:
            while True:
                now = time.monotonic()
                if not self.core.leader_serving(now):
                    return "noleader", None
                self.core.expire_claims(now)
                got = self.core.claim(now)
                if got is not None:
                    return "ok", got
                left = deadline - time.monotonic()
                if left <= 0:
                    return "ok", None
                nxt = min([t for _, _, t in self.core.claimed.values()],
                          default=deadline) - time.monotonic()
                # bounded poll: a freshly committed add (or a lost
                # lease) is noticed within 100ms even with no notify
                self.cv.wait(max(0.01, min(left, nxt, 0.1)))

    def ackjob(self, jid: str) -> tuple[str, int | None]:
        if not self.leader_serving():
            return "noleader", None
        with self.lock:
            st, n, entry = self.core.ackjob_prepare(
                jid, time.monotonic())
            if st != "ok":
                return st, None
            if entry is not None and not self.commit_locked(entry):
                return "noquorum", None
            return "ok", n

    def status(self) -> dict:
        out = super().status()
        with self.lock:
            out["pending"] = len(self.core.pending)
            out["claimed"] = len(self.core.claimed)
        return out


# ---------------------------------------------------------------------------
# the RESP front
# ---------------------------------------------------------------------------


def read_raw_reply(buf) -> bytes:
    """One RESP reply, raw bytes (structure parsed only for framing) —
    what the follower->leader proxy relays verbatim."""
    line = buf.readline()
    if not line:
        raise ConnectionError("peer closed mid-reply")
    kind, rest = line[:1], line[1:].strip()
    if kind in (b"+", b"-", b":"):
        return line
    if kind == b"$":
        n = int(rest)
        if n == -1:
            return line
        return line + buf.read(n + 2)
    if kind == b"*":
        n = int(rest)
        if n == -1:
            return line
        return line + b"".join(read_raw_reply(buf) for _ in range(n))
    raise ValueError(f"bad reply line {line!r}")


def _forward_to_leader(rep: QueueReplica, args: list[str],
                       forward) -> bytes:
    """The proxy decision around a transport-supplied ``forward(lid,
    args) -> raw reply bytes``.  Exception mapping is the protocol:
    ``ConnectionRefusedError`` means nothing accepted the bytes
    (definitely didn't happen → NOLEADER, DisqueClient maps to
    :fail); any other ``OSError``/``ValueError`` means the leader may
    have processed the command (indeterminate → NOREPL → :info)."""
    with rep.lock:
        lid = rep.leader_id
    if lid is None or lid == rep.id:
        return b"-ERR NOLEADER no leader known\r\n"
    try:
        return forward(lid, args)
    except ConnectionRefusedError:
        return b"-ERR NOLEADER leader refused\r\n"
    except (OSError, ValueError):
        return b"-NOREPL proxy indeterminate\r\n"


def dispatch_resp(rep: QueueReplica, args: list[str], *,
                  proxied: bool, forward) -> bytes:
    """One RESP command against the replica: the raw reply payload.
    Pure in (args, replica, forward) — the real handler and the model
    checker's simnet both call it, so the proxy relay AND the REQID
    dedup run inside the verified boundary.  ``proxied`` commands
    (JPROXY-wrapped forwards) are answered locally no matter what, so
    confused leadership views can't loop."""
    cmd = args[0].upper() if args else ""
    if cmd == "ADDJOB" and len(args) >= 4:
        body, retry_s, reqid = parse_addjob(args)
        if reqid is not None and not rep.volatile:
            with rep.lock:
                cached = rep.reply_cache.get(reqid)
            if cached is not None:
                return cached
        st, jid = rep.addjob(body, retry_s)
        if st == "ok":
            payload = f"+{jid}\r\n".encode()
            if reqid is not None and not rep.volatile:
                with rep.lock:
                    rep.reply_cache[reqid] = payload
            return payload
        if st == "noquorum":
            return b"-NOREPL no quorum\r\n"
        return b"-ERR NOLEADER not the leader\r\n" if proxied \
            else _forward_to_leader(rep, args, forward)
    if cmd == "GETJOB":
        u = [a.upper() for a in args]
        timeout_ms = int(args[u.index("TIMEOUT") + 1]) \
            if "TIMEOUT" in u else 0
        queue = args[u.index("FROM") + 1] if "FROM" in u \
            else "jepsen"
        st, got = rep.getjob(timeout_ms)
        if st == "ok":
            if got is None:
                return b"*-1\r\n"
            jid, body = got
            return encode_resp_job(queue, jid, body)
        return b"-ERR NOLEADER not the leader\r\n" if proxied \
            else _forward_to_leader(rep, args, forward)
    if cmd == "ACKJOB" and len(args) >= 2:
        st, n = rep.ackjob(args[1])
        if st == "ok":
            return f":{n}\r\n".encode()
        if st == "noquorum":
            return b"-NOREPL no quorum\r\n"
        return b"-ERR NOLEADER not the leader\r\n" if proxied \
            else _forward_to_leader(rep, args, forward)
    return f"-ERR unknown command {cmd!r}\r\n".encode()


class RespHandler(socketserver.StreamRequestHandler):
    """Dispatch RespConn commands onto the replica; proxy when not
    leader."""

    def _send(self, payload: bytes) -> None:
        self.wfile.write(payload)
        self.wfile.flush()

    def _forward(self, lid: int, args: list[str]) -> bytes:
        """The real-TCP forward leg dispatch_resp drives: JPROXY
        envelope over a socket source-bound to the node's own address
        (the forward rides the same per-peer links the partitioner
        cuts); exceptions propagate — _forward_to_leader owns the
        refused-vs-indeterminate mapping."""
        rep: QueueReplica = self.server.replica
        host, port = rep.resp_peers[lid]
        s = None
        try:
            s = socket.socket()
            s.settimeout(1.5)
            s.bind((rep.host, 0))
            s.connect((host, port))
            s.sendall(encode_resp_command(["JPROXY", *args]))
            return read_raw_reply(s.makefile("rb"))
        finally:
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    def handle(self):
        rep: QueueReplica = self.server.replica
        while True:
            try:
                args = read_resp_command(self.rfile)
            except (ValueError, ConnectionError, OSError):
                return
            if args is None:
                return
            proxied = bool(args) and args[0].upper() == "JPROXY"
            if proxied:
                args = args[1:]
            try:
                self._send(dispatch_resp(rep, args, proxied=proxied,
                                         forward=self._forward))
            except (BrokenPipeError, ConnectionResetError):
                return
            except Exception as e:  # noqa: BLE001 — one command, not
                # the server: a malformed arg must not kill the node
                try:
                    self._send(f"-ERR {type(e).__name__}: {e}\r\n"
                               .encode())
                except OSError:
                    return


class RespServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True  # rebind fast after kill -9
    daemon_threads = True


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {"volatile": False}
    opts = {"--id": None, "--peers": None, "--oplog": None,
            "--lease-ms": "700", "--host": "127.0.0.1"}
    pos: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in flags:
            flags[a] = True
        elif a in opts and i + 1 < len(argv):
            opts[a] = argv[i + 1]
            i += 1
        else:
            pos.append(a)
        i += 1
    if len(pos) != 2 or opts["--id"] is None or opts["--peers"] is None \
            or opts["--oplog"] is None:
        print("usage: replicated_queue PORT DATA_DIR --id I "
              "--peers H1:P1,H2:P2,.. --oplog PATH [--lease-ms MS] "
              "[--host H] [volatile]", file=sys.stderr)
        raise SystemExit(2)
    port, host = int(pos[0]), opts["--host"]
    rep = QueueReplica(int(opts["--id"]),
                       parse_peers(opts["--peers"]), opts["--oplog"],
                       lease_s=int(opts["--lease-ms"]) / 1000.0,
                       volatile=flags["volatile"], host=host)
    peer_srv = PeerServer((host, port + PEER_OFFSET), PeerHandler)
    peer_srv.replica = rep
    threading.Thread(target=peer_srv.serve_forever,
                     name="peer-http", daemon=True).start()
    srv = RespServer((host, port), RespHandler)
    srv.replica = rep
    rep.start()
    print(f"replicated_queue: id={rep.id} RESP on {host}:{port}, "
          f"peer http on {host}:{port + PEER_OFFSET}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
