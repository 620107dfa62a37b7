"""DurableLog — the one copy of the oplog+fsync durability contract.
A copy of the JAX package's ``live/oplog.py``.

The live node servers (kv_server, queue_server) share the
localnode_server durability discipline: every state-changing op is
appended to an oplog and ``fsync()``\\ ed BEFORE the reply leaves
(under the caller's state lock — the linearization point), so a
kill -9 loses at most un-acked ops; startup replays the log, skipping
a torn final line from a crashed writer.  With ``volatile``, nothing
is logged — the deliberate seeded-bug mode.

Stdlib-only on purpose: the servers import it at daemon startup, and
dragging the checker stack (numpy, torch) into every spawned node would
multiply fork latency across a whole campaign.
"""

from __future__ import annotations

import os
from typing import Iterator


class DurableLog:
    def __init__(self, data_dir: str, name: str = "oplog",
                 volatile: bool = False):
        os.makedirs(data_dir, exist_ok=True)
        self.path = os.path.join(data_dir, name)
        self.volatile = volatile
        self._fh = None

    def replay(self) -> Iterator[str]:
        """Recovery: yield each complete logged line (decoded,
        newline-stripped).  A torn final line — no trailing newline,
        the crashed-mid-write case — is dropped: it was never acked."""
        lines, _pos = self.tail(0)
        yield from lines

    def tail(self, offset: int = 0) -> tuple[list[str], int]:
        """Complete lines from byte ``offset`` on, plus the offset of
        the end of the last complete line — so a shared-log reader
        (the replicated families' per-commit catch-up) scans only the
        tail instead of re-reading the whole file every call.  The
        torn-final-line rule is the same as :meth:`replay`'s."""
        if not os.path.exists(self.path):
            return [], offset
        with open(self.path, "rb") as f:
            f.seek(offset)
            data = f.read()
        end = data.rfind(b"\n") + 1
        if end == 0:
            return [], offset
        return ([raw.decode("utf-8", "replace")
                 for raw in data[:end].splitlines()], offset + end)

    def open(self) -> "DurableLog":
        """Open the append handle (after replay, before serving)."""
        self._fh = open(self.path, "ab")
        return self

    def append(self, line: str) -> None:
        """Durable BEFORE return — the caller replies only after."""
        if self.volatile:
            return
        if not line.endswith("\n"):
            line += "\n"
        self._fh.write(line.encode())
        self._fh.flush()
        os.fsync(self._fh.fileno())
