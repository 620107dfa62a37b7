"""localnode register server — a REAL database process for Tier-3.

A deliberately small but honest linearizable key->int register service:

  * text protocol over TCP (one line per op):
        R k            -> "OK <v>" | "OK nil"
        W k v          -> "OK"
        CAS k old new  -> "OK" | "FAIL"
        LOCK owner     -> "OK" | "BUSY"        (global tryLock)
        UNLOCK owner   -> "OK" | "NOT_OWNER"
  * the lock mirrors the shape of Hazelcast's tryLock/unlock service
    (reference hazelcast.clj:260-292) for the BASELINE config #4
    workload.  In `volatile` mode lock state is NOT logged — a kill -9
    forgets the holder, exactly the class of bug the reference's
    hazelcast analysis found under partitions (double grants), so the
    mutex checker has something real to catch.
  * durability: every state-changing op is appended to an oplog and
    fsync()ed BEFORE the reply is sent, under one global lock — the
    linearization point is inside the lock, and a kill -9 at any moment
    loses at most un-acked ops (which the harness records as :info,
    exactly the "maybe happened" semantics the checker must cope with,
    core.clj:387-397).
  * recovery: replays the oplog on startup.

This is the database the localnode suite (suites/localnode.py) deploys
as a real OS process per logical node — the executable analog of the
reference's ssh-test fixture cluster (jepsen/test/jepsen/
core_test.clj:32-86) for images with no sshd/docker.

Usage:  python -m jepsen_tpu_torch.suites.localnode_server PORT DATA_DIR
"""

from __future__ import annotations

import os
import socket
import socketserver
import sys
import threading


class Store:
    def __init__(self, data_dir: str, volatile_lock: bool = False):
        self.lock = threading.Lock()
        self.state: dict[str, int] = {}
        self.holder: str | None = None
        self.volatile_lock = volatile_lock
        os.makedirs(data_dir, exist_ok=True)
        self.path = os.path.join(data_dir, "oplog")
        self._recover()
        self.log = open(self.path, "ab")

    def _recover(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            for raw in f:
                parts = raw.decode("ascii", "replace").split()
                if len(parts) == 3 and parts[0] == "W":
                    self.state[parts[1]] = int(parts[2])
                elif len(parts) == 4 and parts[0] == "C":
                    if self.state.get(parts[1]) == int(parts[2]):
                        self.state[parts[1]] = int(parts[3])
                elif len(parts) == 2 and parts[0] == "L":
                    self.holder = parts[1]
                elif len(parts) == 2 and parts[0] == "U":
                    if self.holder == parts[1]:
                        self.holder = None

    def _durable(self, line: str) -> None:
        self.log.write(line.encode("ascii"))
        self.log.flush()
        os.fsync(self.log.fileno())

    def apply(self, parts: list[str]) -> str:
        with self.lock:
            if parts[0] == "R" and len(parts) == 2:
                v = self.state.get(parts[1])
                return f"OK {'nil' if v is None else v}"
            if parts[0] == "W" and len(parts) == 3:
                self._durable(f"W {parts[1]} {int(parts[2])}\n")
                self.state[parts[1]] = int(parts[2])
                return "OK"
            if parts[0] == "CAS" and len(parts) == 4:
                if self.state.get(parts[1]) != int(parts[2]):
                    return "FAIL"
                self._durable(f"C {parts[1]} {int(parts[2])} "
                              f"{int(parts[3])}\n")
                self.state[parts[1]] = int(parts[3])
                return "OK"
            if parts[0] == "LOCK" and len(parts) == 2:
                if self.holder is not None:
                    return "BUSY"
                # grant is durable BEFORE the reply (linearization
                # point inside the log lock) — unless volatile, where a
                # kill -9 forgets the holder and double grants become
                # possible, the bug class the mutex checker exists for
                if not self.volatile_lock:
                    self._durable(f"L {parts[1]}\n")
                self.holder = parts[1]
                return "OK"
            if parts[0] == "UNLOCK" and len(parts) == 2:
                if self.holder != parts[1]:
                    return "NOT_OWNER"
                if not self.volatile_lock:
                    self._durable(f"U {parts[1]}\n")
                self.holder = None
                return "OK"
            return "ERR bad command"


class Handler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            raw = self.rfile.readline()
            if not raw:
                return
            try:
                parts = raw.decode("ascii", "replace").split()
                reply = self.server.store.apply(parts) if parts \
                    else "ERR empty"
            except (ValueError, IndexError):
                reply = "ERR parse"
            self.wfile.write((reply + "\n").encode("ascii"))
            self.wfile.flush()


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
        print("usage: localnode_server PORT DATA_DIR [--host H] "
              "[volatile]", file=sys.stderr)
        raise SystemExit(2)
    port, data_dir = int(argv[0]), argv[1]
    srv = Server((host, port), Handler)
    srv.store = Store(data_dir, volatile_lock=len(argv) == 3)
    print(f"localnode_server: listening on {host}:{port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
