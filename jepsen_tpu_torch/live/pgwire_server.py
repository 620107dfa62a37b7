"""live pgwire node — the in-process MiniPGServer as a real process.

The pgwire family already had a live *server shape* (suites/pgwire.py's
``MiniPGServer`` + ``RegisterEngine``, exercised in-process by
tests/test_torch_suites_sql.py) but no campaign presence: nothing ever ran
it as a real OS process under the nemesis matrix.  This module is that
missing daemon entry — plus the one contract a kill -9 nemesis makes
non-optional: **durability**.  The in-process engine keeps its rows in
a dict, so a crash-restart cell would "lose" every acked write and the
checker would flag a bug that is really a harness artifact.

:class:`DurableRegisterEngine` therefore journals committed register
writes through the shared oplog discipline (live/oplog.py: append +
fsync BEFORE the reply leaves) and replays them at startup:

  * autocommit statements log at the write;
  * transactional writes buffer and log at COMMIT — before the
    COMMIT reply is released (the linearization point), so a kill -9
    mid-transaction loses exactly the un-acked transaction, never a
    committed one;
  * ROLLBACK and a connection dying mid-transaction discard the
    buffer alongside the engine's own undo log.

Usage:  python -m jepsen_tpu_torch.live.pgwire_server PORT DATA_DIR [--host H]
"""

from __future__ import annotations

import re
import sys
import threading

from ..suites import pgwire


class DurableRegisterEngine(pgwire.RegisterEngine):
    """RegisterEngine + oplog+fsync durability for committed writes."""

    def __init__(self, data_dir: str):
        from .oplog import DurableLog

        super().__init__()
        self.dlog = DurableLog(data_dir)
        #: writes applied inside the open transaction, logged at COMMIT
        self._txn_writes: list[tuple[str, int, int]] = []
        for line in self.dlog.replay():
            parts = line.split()
            if len(parts) == 3:
                table, k, v = parts
                self._table(table)[int(k)] = int(v)
        self.dlog.open()

    def _write(self, table: str, k: int, v: int) -> None:
        super()._write(table, k, v)
        if self._txn_owner is not None:
            self._txn_writes.append((table, k, v))
        else:
            self.dlog.append(f"{table} {k} {v}\n")

    def execute(self, sql: str):
        s = sql.strip().rstrip(";")
        me = threading.get_ident()
        if re.fullmatch(r"COMMIT", s, re.I) and self._txn_owner == me:
            # durable BEFORE the reply releases the lock: a kill -9
            # between here and the client reading "COMMIT" loses an
            # op the history records :info — never an acked one
            for table, k, v in self._txn_writes:
                self.dlog.append(f"{table} {k} {v}\n")
            self._txn_writes.clear()
        elif re.fullmatch(r"ROLLBACK", s, re.I) \
                and self._txn_owner == me:
            self._txn_writes.clear()
        return super().execute(s)

    def abort_connection(self) -> None:
        if self._txn_owner == threading.get_ident():
            self._txn_writes.clear()
        super().abort_connection()


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    host = "127.0.0.1"
    if "--host" in argv:  # per-node loopback address (live/links.py)
        i = argv.index("--host")
        host = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) != 2:
        print("usage: pgwire_server PORT DATA_DIR [--host H]",
              file=sys.stderr)
        raise SystemExit(2)
    port, data_dir = int(argv[0]), argv[1]
    srv = pgwire.MiniPGServer((host, port), pgwire._Handler)
    srv.engine = DurableRegisterEngine(data_dir)
    print(f"pgwire_server: listening on {host}:{port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
