"""live queue node — a disque-shaped RESP job queue, for real.
A copy of the JAX package's ``live/queue_server.py``, stdlib-only.

One logical node of the live queue family: a REAL OS process speaking
the RESP subset the disque suite's wire client (suites/disque.py:
``RespConn``/``DisqueClient``) already uses —

  ADDJOB <queue> <body> <timeout_ms> [RETRY s] [REPLICATE n]
         [REQID id]                            -> +id
  GETJOB TIMEOUT <ms> COUNT <n> FROM <queue>  -> [[queue id body]] | nil
  ACKJOB <id>                                 -> :n

so the live harness reuses that client unchanged.  Semantics mirror
disque's at-least-once contract: a GETJOB claims a job for RETRY
seconds; un-ACKed claims are *redelivered* once the retry window
expires (the duplicate-delivery case the total-queue checker must
tolerate), ACKJOB retires the job for good.

Durability is the localnode_server contract: ADDJOB and ACKJOB append
to an oplog and ``fsync()`` BEFORE the reply leaves, so acked state
survives kill -9 (in-flight ops are the checker's :info case) and
startup replays adds minus acks back into the pending set.  With
``volatile``, nothing is logged — enqueues acked to the client vanish
on crash: the seeded data-loss bug a queue checker exists to catch.

Retry idempotency: ADDJOB may carry ``REQID <id>``; the store
remembers which jid each reqid minted (durably) and answers a
retransmission with the SAME jid instead of enqueueing a second copy —
the MC201 double-commit class.  ``volatile`` skips the cache (the
seeded MC201 mode).

Two shell-layer pieces are deliberately factored for the model
checker (``analyze/simnet.py``): :func:`dispatch` is the pure
per-command request logic (args in, reply payload out, no socket),
and the connection handler's claim-release path — a GETJOB whose
reply never reached the client returns its claim to pending instead
of leaving the job invisibly claimed for the whole retry window (the
disque-drain defect class; MC204).

Usage:  python -m jepsen_tpu_torch.live.queue_server PORT DATA_DIR [volatile]
"""

from __future__ import annotations

import sys
import threading
import time
import socketserver
from collections import OrderedDict


class Store:
    """Pending/claimed job sets with oplog+fsync durability."""

    def __init__(self, data_dir: str, volatile: bool = False):
        from .oplog import DurableLog

        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        #: injectable clock (the model checker freezes it; claims then
        #: never expire inside a bounded schedule, keeping redelivery
        #: an explicit event instead of a wall-clock race)
        self.now = time.monotonic
        self.volatile = volatile
        self.next_id = 0
        #: job id -> (body, retry_s), FIFO-ish delivery order
        #: (redeliveries rejoin at the tail, like disque's best-effort
        #: ordering)
        self.pending: OrderedDict[str, tuple[str, float]] = OrderedDict()
        #: job id -> (body, retry_s, redeliver-at-monotonic)
        self.claimed: dict[str, tuple[str, float, float]] = {}
        #: ADDJOB reqid -> jid it minted (idempotent retry dedup)
        self.replies: dict[str, str] = {}
        self.log = DurableLog(data_dir, volatile=volatile)
        acked: set = set()
        adds: OrderedDict[str, str] = OrderedDict()
        for line in self.log.replay():
            parts = line.split(" ", 2)
            if len(parts) == 3 and parts[0] == "A":
                adds[parts[1]] = parts[2]
                n = int(parts[1].split("-")[-1])
                self.next_id = max(self.next_id, n + 1)
            elif len(parts) >= 2 and parts[0] == "K":
                acked.add(parts[1])
            elif len(parts) == 3 and parts[0] == "R":
                self.replies[parts[1]] = parts[2]
        for jid, body in adds.items():
            if jid not in acked:
                self.pending[jid] = (body, 1.0)
        self.log.open()

    def _durable(self, line: str) -> None:
        self.log.append(line)

    def _expire_claims(self) -> None:
        """Redeliver claims whose retry window lapsed (caller holds
        the lock)."""
        now = self.now()
        for jid in [j for j, (_, _, t) in self.claimed.items()
                    if t <= now]:
            body, retry_s, _ = self.claimed.pop(jid)
            self.pending[jid] = (body, retry_s)

    def addjob(self, body: str, retry_s: float,
               reqid: str | None = None) -> str:
        with self.cv:
            if reqid is not None and not self.volatile \
                    and reqid in self.replies:
                return self.replies[reqid]
            jid = f"D-{self.next_id}"
            self.next_id += 1
            # durable BEFORE the reply: the linearization point
            self._durable(f"A {jid} {body}\n")
            if reqid is not None and not self.volatile:
                self._durable(f"R {reqid} {jid}\n")
                self.replies[reqid] = jid
            self.pending[jid] = (body, retry_s)
            self.cv.notify()
            return jid

    def getjob(self, timeout_ms: int) -> tuple[str, str] | None:
        deadline = self.now() + timeout_ms / 1000.0
        with self.cv:
            while True:
                self._expire_claims()
                if self.pending:
                    jid, (body, retry_s) = \
                        self.pending.popitem(last=False)
                    self.claimed[jid] = (
                        body, retry_s, self.now() + retry_s)
                    return jid, body
                left = deadline - self.now()
                if left <= 0:
                    return None
                # wake early enough to notice an expiring claim
                nxt = min([t for _, _, t in self.claimed.values()],
                          default=deadline)
                self.cv.wait(max(0.01, min(left, nxt - self.now())))

    def ackjob(self, jid: str) -> int:
        with self.cv:
            known = jid in self.claimed or jid in self.pending
            self._durable(f"K {jid}\n")
            self.claimed.pop(jid, None)
            self.pending.pop(jid, None)
            return 1 if known else 0

    def unclaim(self, jid: str) -> None:
        """Return a claim to pending NOW — the delivery provably never
        reached the client (its connection died before the reply was
        sent), so holding the claim for the retry window only makes
        the job invisible to every consumer for no reason."""
        with self.cv:
            if jid in self.claimed:
                body, retry_s, _ = self.claimed.pop(jid)
                self.pending[jid] = (body, retry_s)
                self.cv.notify()


# -- RESP framing, shared with live/replicated_queue.py ---------------


def read_resp_command(rfile) -> list[str] | None:
    """One RespConn-shaped command: an array of bulk strings."""
    line = rfile.readline()
    if not line:
        return None
    if not line.startswith(b"*"):
        raise ValueError(f"bad array header {line!r}")
    n = int(line[1:].strip())
    args = []
    for _ in range(n):
        hdr = rfile.readline()
        if not hdr.startswith(b"$"):
            raise ValueError(f"bad bulk header {hdr!r}")
        size = int(hdr[1:].strip())
        data = rfile.read(size + 2)[:-2]
        args.append(data.decode("utf-8", "replace"))
    return args


def encode_resp_command(args: list[str]) -> bytes:
    """Re-encode a command for forwarding (the follower->leader
    proxy)."""
    out = [f"*{len(args)}\r\n".encode()]
    for a in args:
        b = str(a).encode()
        out.append(f"${len(b)}\r\n".encode() + b + b"\r\n")
    return b"".join(out)


def encode_resp_job(queue: str, jid: str, body: str) -> bytes:
    """The GETJOB single-job reply: [[queue id body]]."""
    out = [b"*1\r\n*3\r\n"]
    for s in (queue, jid, body):
        b = s.encode()
        out.append(f"${len(b)}\r\n".encode() + b + b"\r\n")
    return b"".join(out)


def parse_addjob(args: list[str]) -> tuple[str, float, str | None]:
    """ADDJOB options: (body, retry_s, reqid).  Shared with the
    replicated queue's dispatch."""
    retry_s = 1.0
    reqid = None
    rest = [a.upper() for a in args[4:]]
    if "RETRY" in rest:
        retry_s = float(args[4 + rest.index("RETRY") + 1])
    if "REQID" in rest:
        reqid = args[4 + rest.index("REQID") + 1]
    return args[2], retry_s, reqid


def dispatch(store: Store,
             args: list[str]) -> tuple[bytes, str | None]:
    """One command against the store: (reply payload, jid claimed by
    THIS command or None).  Pure in (args, store) — the real handler
    and the simnet transport share it; the claimed jid is what the
    caller must unclaim if the reply cannot be delivered."""
    cmd = args[0].upper() if args else ""
    if cmd == "ADDJOB" and len(args) >= 4:
        body, retry_s, reqid = parse_addjob(args)
        jid = store.addjob(body, retry_s, reqid)
        return f"+{jid}\r\n".encode(), None
    if cmd == "GETJOB":
        u = [a.upper() for a in args]
        timeout_ms = int(args[u.index("TIMEOUT") + 1]) \
            if "TIMEOUT" in u else 0
        queue = args[u.index("FROM") + 1] if "FROM" in u else "jepsen"
        got = store.getjob(timeout_ms)
        if got is None:
            return b"*-1\r\n", None
        jid, body = got
        return encode_resp_job(queue, jid, body), jid
    if cmd == "ACKJOB" and len(args) >= 2:
        return f":{store.ackjob(args[1])}\r\n".encode(), None
    return f"-ERR unknown command {cmd!r}\r\n".encode(), None


class Handler(socketserver.StreamRequestHandler):
    """The RESP framing RespConn emits: arrays of bulk strings in, one
    reply out per command."""

    def _read_command(self) -> list[str] | None:
        return read_resp_command(self.rfile)

    def _send(self, payload: bytes) -> None:
        self.wfile.write(payload)
        self.wfile.flush()

    def handle(self):
        store: Store = self.server.store
        while True:
            try:
                args = self._read_command()
            except (ValueError, ConnectionError, OSError):
                return
            if args is None:
                return
            claimed = None
            try:
                payload, claimed = dispatch(store, args)
            except Exception as e:  # noqa: BLE001 — one command, not
                # the server: a malformed arg must not kill the node
                payload = f"-ERR {type(e).__name__}: {e}\r\n".encode()
            try:
                self._send(payload)
            except OSError:
                # the reply never left: a job claimed by THIS command
                # was never delivered — release it now instead of
                # letting it sit invisibly claimed for the whole retry
                # window (the MC204 session-leak class)
                if claimed is not None:
                    store.unclaim(claimed)
                return


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True  # rebind fast after kill -9
    daemon_threads = True


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    host = "127.0.0.1"
    if "--host" in argv:  # per-node loopback address (live/links.py)
        i = argv.index("--host")
        host = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) not in (2, 3) or (len(argv) == 3
                                   and argv[2] != "volatile"):
        print("usage: queue_server PORT DATA_DIR [--host H] "
              "[volatile]", file=sys.stderr)
        raise SystemExit(2)
    port, data_dir = int(argv[0]), argv[1]
    srv = Server((host, port), Handler)
    srv.store = Store(data_dir, volatile=len(argv) == 3)
    print(f"queue_server: listening on {host}:{port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
