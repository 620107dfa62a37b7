"""live KV/CAS node — an etcd-v2-shaped HTTP server, for real.
A copy of the JAX package's ``live/kv_server.py``, stdlib-only.

One logical node of the live KV family: a REAL OS process serving the
etcd **v2 keys surface** (`GET/PUT /v2/keys/<k>` with ``prevValue``
CAS), exactly the wire protocol the etcd suite's ``V2Client``
(suites/etcd.py) already speaks — so the live harness reuses that
client unchanged and the suite's wire code stops being dead code.

Durability contract is the localnode_server one: every state-changing
op appends to an oplog and ``fsync()``\\ s BEFORE the reply leaves,
under one global lock (the linearization point), so a kill -9 loses at
most un-acked ops — the history's :info "maybe happened" case — and
startup replays the oplog.  With ``volatile``, mutations skip the log:
acked writes then vanish on crash, the seeded-bug mode a checker must
catch.

Status mapping (the v2 API shape V2Client's error handling relies on):

  GET  missing key                 -> 404 {"errorCode": 100}
  PUT  prevValue mismatch          -> 412 {"errorCode": 101}
  PUT  prevValue on a missing key  -> 404 {"errorCode": 100}

Retry idempotency: a PUT may carry a ``reqId`` query parameter; the
store remembers the reply it sent for each reqId (durably, alongside
the write) and answers a retransmission of the same reqId with the
SAME reply instead of re-running the op — the MC202 class of bug
(commit succeeded, reply lost, retry answers differently) is closed by
this cache.  ``volatile`` skips the cache too (the seeded MC202 mode).

The request-dispatch logic is a pure function of (method, path, body,
store) — :func:`dispatch` — that both the real HTTP handler below and
the model checker's simulated transport (`analyze/simnet.py`) call, so
the checked code path IS the served code path (the shell-lifting
contract, docs/analyze.md §12).

Usage:  python -m jepsen_tpu_torch.live.kv_server PORT DATA_DIR [volatile]
"""

from __future__ import annotations

import json
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PREFIX = "/v2/keys/"


class Store:
    """key -> value-string map; durability via live.oplog.DurableLog
    (fsync before the reply, torn tail line dropped on replay)."""

    def __init__(self, data_dir: str, volatile: bool = False):
        from .oplog import DurableLog

        self.lock = threading.Lock()
        self.volatile = volatile
        self.state: dict[str, str] = {}
        #: reqId -> (status, body) — the reply each idempotency key got
        self.replies: dict[str, tuple[int, dict]] = {}
        self.log = DurableLog(data_dir, volatile=volatile)
        for line in self.log.replay():
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if e.get("op") == "set":
                self.state[e["k"]] = e["v"]
            elif e.get("op") == "reply":
                self.replies[e["id"]] = (e["s"], e["b"])
        self.log.open()

    def _durable(self, entry: dict) -> None:
        self.log.append(json.dumps(entry))

    def get(self, key: str) -> str | None:
        with self.lock:
            return self.state.get(key)

    def put(self, key: str, value: str, prev: str | None = None,
            reqid: str | None = None) -> tuple[int, dict]:
        """(status, body) — durable before return (the reply follows).

        With ``reqid``, the reply is cached (durably) under that
        idempotency key: a client retransmission after a lost reply
        gets the ORIGINAL answer, not a second application (or a lying
        412).  Volatile mode skips the cache — the seeded MC202 bug."""
        with self.lock:
            if reqid is not None and not self.volatile \
                    and reqid in self.replies:
                return self.replies[reqid]
            if prev is not None:
                cur = self.state.get(key)
                if cur is None:
                    status, body = 404, {"errorCode": 100,
                                         "message": "Key not found",
                                         "cause": key}
                    return self._remember(reqid, status, body)
                if cur != prev:
                    status, body = 412, {"errorCode": 101,
                                         "message": "Compare failed",
                                         "cause": f"[{prev} != {cur}]"}
                    return self._remember(reqid, status, body)
            self._durable({"op": "set", "k": key, "v": value})
            self.state[key] = value
            status = 200
            body = {"action": "compareAndSwap" if prev is not None
                    else "set",
                    "node": {"key": f"/{key}", "value": value}}
            return self._remember(reqid, status, body)

    def _remember(self, reqid: str | None, status: int,
                  body: dict) -> tuple[int, dict]:
        """Cache the reply under the idempotency key (all statuses: a
        retried CAS must see its own 412 again, not a fresh compare
        against state its first attempt already moved).  Caller holds
        the lock."""
        if reqid is not None and not self.volatile:
            self._durable({"op": "reply", "id": reqid,
                           "s": status, "b": body})
            self.replies[reqid] = (status, body)
        return status, body


def _path_key(parsed) -> str | None:
    if not parsed.path.startswith(PREFIX):
        return None
    return urllib.parse.unquote(parsed.path[len(PREFIX):]) or None


def dispatch(store: Store, method: str, path: str,
             raw_body: bytes) -> tuple[int, dict]:
    """One request against the store: (status, reply body).  Pure in
    (method, path, body, store) — no socket, no wall clock — so the
    real HTTP handler and the simnet transport share it verbatim."""
    parsed = urllib.parse.urlparse(path)
    key = _path_key(parsed)
    if key is None:
        return 404, {"errorCode": 100, "message": "bad path"}
    if method == "GET":
        v = store.get(key)
        if v is None:
            return 404, {"errorCode": 100,
                         "message": "Key not found", "cause": key}
        return 200, {"action": "get",
                     "node": {"key": f"/{key}", "value": v}}
    if method == "PUT":
        try:
            form = urllib.parse.parse_qs(
                raw_body.decode("utf-8", "replace"))
            value = form["value"][0]
        except (ValueError, KeyError, IndexError):
            return 400, {"errorCode": 209, "message": "bad form"}
        query = urllib.parse.parse_qs(parsed.query)
        prev = query.get("prevValue", [None])[0]
        reqid = query.get("reqId", [None])[0]
        return store.put(key, value, prev, reqid)
    return 404, {"errorCode": 100, "message": "bad path"}


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (stdlib API)
        self._reply(*dispatch(self.server.store, "GET", self.path, b""))

    def do_PUT(self):  # noqa: N802 (stdlib API)
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n)
        self._reply(*dispatch(self.server.store, "PUT", self.path, body))


class Server(ThreadingHTTPServer):
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
        print("usage: kv_server PORT DATA_DIR [--host H] [volatile]",
              file=sys.stderr)
        raise SystemExit(2)
    port, data_dir = int(argv[0]), argv[1]
    srv = Server((host, port), Handler)
    srv.store = Store(data_dir, volatile=len(argv) == 3)
    print(f"kv_server: listening on {host}:{port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
