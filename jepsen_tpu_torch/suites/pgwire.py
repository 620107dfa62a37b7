"""Minimal PostgreSQL v3 wire protocol — stdlib client shim + server.

The reference's SQL suites (cockroach/tidb/percona/galera) all ride one
client stack (cockroachdb/src/jepsen/cockroach/client.clj) over the
postgres wire protocol.  Where no psycopg2 wheel is installed, the SQL
clients' txn/retry/reconnect machinery runs over this module instead:

* ``connect(...)`` — a DB-API-shaped client speaking REAL pg-wire v3
  over a stdlib socket: StartupMessage -> AuthenticationOk ->
  Simple Query ('Q') -> RowDescription/DataRow/CommandComplete/
  ErrorResponse/ReadyForQuery.  It implements exactly the psycopg2
  surface `suites/cockroach.py`'s SQLClient uses (`with conn`,
  `conn.cursor()`, `%s` parameters, `rowcount`, `fetchone/fetchall`,
  `rollback`, `close`).  Against a real server (cockroach's SQL port
  speaks this same protocol, trust auth) the same bytes flow.
* ``MiniPGServer`` — an in-process pg-wire server with a tiny
  regex-dispatched SQL engine covering the statements the register
  workload issues (CREATE TABLE / SELECT / UPSERT / UPDATE / BEGIN /
  COMMIT / ROLLBACK), every statement linearized under one lock.  It
  exists so the SQL client path can execute end to end — sockets,
  protocol frames, error mapping, reconnects — in tests
  (tests/test_torch_suites_sql.py), the same pattern as the memcache/
  REST/RESP live fixtures.

The frames are the JAX package's byte for byte: either package's client
works against the other's server.
"""

from __future__ import annotations

import math
import re
import socket
import socketserver
import struct
import threading


class Error(Exception):
    """Server-reported SQL error (psycopg2.Error stand-in)."""


class _Die(Exception):
    """Test control: the handler drops the connection without a reply
    (simulates the server dying with the statement in flight)."""


def _quote_param(v) -> str:
    """Render one parameter as a SQL literal, psycopg2-style.

    Strings are quoted with ``''`` doubling; Decimal passes through as
    its exact text form; anything the shim cannot adapt raises a CLEAR
    error instead of emitting broken SQL (the psycopg2 behavior —
    ProgrammingError: can't adapt)."""
    from decimal import Decimal

    if v is None:
        return "NULL"
    if isinstance(v, bool):  # bool before int: bool IS an int
        return "TRUE" if v else "FALSE"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            raise Error(f"pgwire shim can't adapt non-finite float "
                        f"{v!r} (str() would emit invalid SQL)")
        return str(v)
    if isinstance(v, Decimal):
        if not v.is_finite():
            raise Error(f"pgwire shim can't adapt non-finite Decimal "
                        f"{v!r} (str() would emit invalid SQL)")
        return str(v)
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise Error(
        f"pgwire shim can't adapt parameter of type "
        f"{type(v).__name__!r}; supported: None/bool/int/float/"
        f"Decimal/str")


def _interpolate(sql: str, params) -> str:
    """psycopg2 %-format semantics: ``%s`` consumes a parameter, ``%%``
    is a literal ``%``, anything else after ``%`` (and a placeholder/
    parameter count mismatch) is an error."""
    it = iter(params)
    out: list[str] = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch != "%":
            out.append(ch)
            i += 1
            continue
        if i + 1 >= n:
            raise Error("pgwire shim: lone '%' at end of statement")
        nxt = sql[i + 1]
        if nxt == "s":
            try:
                out.append(_quote_param(next(it)))
            except StopIteration:
                raise Error("pgwire shim: not enough parameters for "
                            "query placeholders") from None
            i += 2
        elif nxt == "%":
            out.append("%")
            i += 2
        else:
            raise Error(f"pgwire shim: unsupported format character "
                        f"{nxt!r} (only %s and %% are supported)")
    if sum(1 for _ in it):
        raise Error("pgwire shim: more parameters than query "
                    "placeholders")
    return "".join(out)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


def _startup_payload(user: str, database: str) -> bytes:
    body = (b"user\x00" + user.encode() + b"\x00"
            b"database\x00" + database.encode() + b"\x00\x00")
    head = struct.pack("!ii", 8 + len(body), 196608)  # protocol 3.0
    return head + body


class Cursor:
    def __init__(self, conn: "Connection"):
        self.conn = conn
        self.rowcount = -1
        self._rows: list[tuple] = []
        self._i = 0

    def execute(self, sql: str, params: tuple | None = None) -> None:
        if params is not None:
            sql = _interpolate(sql, params)
        self.conn._maybe_begin()
        rows, tag = self.conn._query(sql)
        self._rows, self._i = rows, 0
        m = re.search(r"(\d+)\s*$", tag or "")
        self.rowcount = int(m.group(1)) if m else -1

    def fetchone(self):
        if self._i >= len(self._rows):
            return None
        row = self._rows[self._i]
        self._i += 1
        return row

    def fetchall(self):
        rows = self._rows[self._i:]
        self._i = len(self._rows)
        return rows

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False


class Connection:
    """psycopg2-shaped connection over a live pg-wire socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.autocommit = False
        self._buf = b""
        self._in_txn = False
        self._dead = False

    # -- wire ------------------------------------------------------------
    def _recv_msg(self) -> tuple[bytes, bytes]:
        while len(self._buf) < 5:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise OSError("pgwire: server closed connection")
            self._buf += chunk
        kind = self._buf[0:1]
        (ln,) = struct.unpack("!i", self._buf[1:5])
        while len(self._buf) < 1 + ln:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise OSError("pgwire: server closed mid-message")
            self._buf += chunk
        payload = self._buf[5:1 + ln]
        self._buf = self._buf[1 + ln:]
        return kind, payload

    def _query(self, sql: str) -> tuple[list[tuple], str]:
        # a connection whose protocol stream desynced (timeout or
        # reset mid-reply) must never be reused: a later query could
        # consume the previous statement's still-in-flight frames as
        # its own response and corrupt the recorded value
        if self._dead:
            raise OSError("pgwire: connection poisoned by an earlier "
                          "protocol error")
        try:
            return self._query_inner(sql)
        except (OSError, TimeoutError):
            self._dead = True
            try:
                self.sock.close()
            except OSError:
                pass
            raise

    def _query_inner(self, sql: str) -> tuple[list[tuple], str]:
        q = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + struct.pack("!i", 4 + len(q)) + q)
        rows: list[tuple] = []
        tag = ""
        err: str | None = None
        while True:
            kind, payload = self._recv_msg()
            if kind == b"T":
                pass  # RowDescription: types unused (all int4/text)
            elif kind == b"D":
                (ncols,) = struct.unpack("!h", payload[:2])
                off = 2
                row = []
                for _ in range(ncols):
                    (cl,) = struct.unpack("!i", payload[off:off + 4])
                    off += 4
                    if cl == -1:
                        row.append(None)
                    else:
                        raw = payload[off:off + cl]
                        off += cl
                        try:
                            row.append(int(raw))
                        except ValueError:
                            row.append(raw.decode())
                rows.append(tuple(row))
            elif kind == b"C":
                tag = payload.rstrip(b"\x00").decode()
            elif kind == b"E":
                fields = {}
                for part in payload.split(b"\x00"):
                    if part:
                        fields[chr(part[0])] = part[1:].decode(
                            "utf-8", "replace")
                err = fields.get("M", "server error")
            elif kind == b"Z":
                if err is not None:
                    raise Error(err)
                return rows, tag
            # ignore 'S' (ParameterStatus), 'K' (BackendKeyData), 'N'

    def _maybe_begin(self) -> None:
        """psycopg2 semantics: with autocommit off, the first statement
        implicitly opens a transaction (psycopg2 sends BEGIN under the
        hood); commit/rollback close it.  Against a real server the
        same statement flow must hold or multi-statement txns would run
        autocommit and interleave."""
        if not self.autocommit and not self._in_txn:
            self._in_txn = True
            self._query("BEGIN")

    # -- DB-API surface ---------------------------------------------------
    def cursor(self) -> Cursor:
        return Cursor(self)

    def commit(self) -> None:
        if self._in_txn:
            self._in_txn = False
            self._query("COMMIT")

    def rollback(self) -> None:
        self._in_txn = False
        try:
            self._query("ROLLBACK")
        except OSError:
            pass

    def close(self) -> None:
        try:
            self.sock.sendall(b"X" + struct.pack("!i", 4))
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        # psycopg2 semantics: entering opens/continues a transaction
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.commit()
        else:
            self.rollback()
        return False


def connect(host: str, port: int, user: str = "root",
            dbname: str = "jepsen", connect_timeout: float = 5,
            **_ignored) -> Connection:
    sock = socket.create_connection((host, port),
                                    timeout=connect_timeout)
    sock.settimeout(connect_timeout)
    sock.sendall(_startup_payload(user, dbname))
    conn = Connection(sock)
    while True:
        kind, payload = conn._recv_msg()
        if kind == b"R":
            (code,) = struct.unpack("!i", payload[:4])
            if code != 0:
                raise Error(f"pgwire: unsupported auth code {code}")
        elif kind == b"E":
            raise Error("pgwire: server refused startup")
        elif kind == b"Z":
            return conn


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


def _msg(kind: bytes, payload: bytes = b"") -> bytes:
    return kind + struct.pack("!i", 4 + len(payload)) + payload


def _row_desc(names: list[str]) -> bytes:
    body = struct.pack("!h", len(names))
    for n in names:
        body += (n.encode() + b"\x00"
                 + struct.pack("!ihihih", 0, 0, 23, 4, -1, 0))
    return _msg(b"T", body)


def _data_row(row: tuple) -> bytes:
    body = struct.pack("!h", len(row))
    for v in row:
        if v is None:
            body += struct.pack("!i", -1)
        else:
            raw = str(v).encode()
            body += struct.pack("!i", len(raw)) + raw
    return _msg(b"D", body)


def _complete(tag: str) -> bytes:
    return _msg(b"C", tag.encode() + b"\x00")


def _error(msg: str) -> bytes:
    body = (b"SERROR\x00" + b"CXX000\x00"
            + b"M" + msg.encode() + b"\x00\x00")
    return _msg(b"E", body)


_READY = _msg(b"Z", b"I")


class RegisterEngine:
    """The statements suites/cockroach.py's Register and Bank clients
    issue, with REAL transaction semantics: BEGIN takes the engine
    lock until COMMIT/ROLLBACK (strict serialization — cockroach's
    SERIALIZABLE, degenerately), writes keep an undo log so ROLLBACK
    (or a dead connection mid-txn) restores state.  `fail_next(n)`
    arms injected errors so the client's error->:fail/:info mapping
    executes live."""

    def __init__(self):
        self.lock = threading.RLock()
        self.rows: dict[int, int] = {}          # registers
        self.accounts: dict[int, int] = {}      # bank balances
        self._fail = 0
        self._die = 0
        # injected counters are scoped to the FIRST connection that
        # consumes them: a counter armed for one client's transaction
        # must not fire mid-statement on a concurrent connection
        self._fail_owner: int | None = None
        self._die_owner: int | None = None
        self._txn_owner: int | None = None      # thread id holding BEGIN
        self._undo: list = []                   # (table, key, old|None)

    def fail_next(self, n: int = 1) -> None:
        with self.lock:
            self._fail = n
            self._fail_owner = None

    def die_next(self, n: int = 1) -> None:
        """Arm a connection kill on the n-th DML/SELECT statement from
        now (n=1: the very next one).  Counting — rather than killing
        the next n — lets a test land the death AFTER a transaction
        already applied writes, so the undo log is non-empty when the
        abort hook replays it."""
        with self.lock:
            self._die = n
            self._die_owner = None

    def disarm(self) -> None:
        """Clear any armed (or partially-consumed) injection counters —
        a test whose scenario bailed early must not leak a live counter
        into later statements."""
        with self.lock:
            self._fail = self._die = 0
            self._fail_owner = self._die_owner = None

    # -- txn plumbing -----------------------------------------------------
    def _table(self, name: str) -> dict[int, int]:
        return self.rows if name == "registers" else self.accounts

    def _write(self, table: str, k: int, v: int) -> None:
        t = self._table(table)
        if self._txn_owner is not None:
            self._undo.append((table, k, t.get(k)))
        t[k] = v

    def _rollback_undo(self) -> None:
        """Replay the undo log newest-first (a key written twice in
        one txn restores its pre-txn value last)."""
        for table, k, old in reversed(self._undo):
            t = self._table(table)
            if old is None:
                t.pop(k, None)
            else:
                t[k] = old

    def _release(self) -> None:
        self._txn_owner = None
        self._undo.clear()
        self.lock.release()

    def abort_connection(self) -> None:
        """Handler hook: a connection died — roll back its open txn so
        a half-applied transfer can never leak (and release the lock
        other connections are blocked on).  Injection counters this
        connection had claimed die with it."""
        me = threading.get_ident()
        # reading _txn_owner unlocked is safe here: it can only equal
        # `me` if this thread set it (and then still holds the lock)
        if self._txn_owner == me:
            self._rollback_undo()
            self._release()
        with self.lock:
            if self._die_owner == me:
                self._die, self._die_owner = 0, None
            if self._fail_owner == me:
                self._fail, self._fail_owner = 0, None

    def execute(self, sql: str) -> tuple[list[tuple], list[str], str]:
        s = sql.strip().rstrip(";")
        me = threading.get_ident()
        if re.fullmatch(r"BEGIN", s, re.I):
            # _txn_owner transitions happen only while HOLDING the
            # lock: the old unlocked `owner != me` test read the field
            # mid-transition against a releasing thread.  Acquire
            # first (re-entrant when we already own the txn), then
            # decide — `owner == me` is stable under the lock.
            self.lock.acquire()              # blocks on other txns
            if self._txn_owner == me:
                self.lock.release()          # re-entrant BEGIN: no-op
            else:
                self._txn_owner = me
                self._undo.clear()
            return [], [], "BEGIN"
        if re.fullmatch(r"(COMMIT|ROLLBACK)", s, re.I):
            kind = s.upper()
            # `owner == me` implies this thread holds the lock (set
            # under it at BEGIN and cleared only by us), so the
            # transition below is already guarded
            if self._txn_owner == me:
                if kind == "ROLLBACK":
                    self._rollback_undo()
                self._release()
            return [], [], kind
        with self.lock:
            # inside a txn this re-enters (RLock); autocommit
            # statements serialize against open txns
            return self._stmt(s)

    def _stmt(self, s: str) -> tuple[list[tuple], list[str], str]:
        if re.match(r"CREATE TABLE", s, re.I):
            return [], [], "CREATE TABLE"
        # injected failures hit DML/SELECT only — never the txn
        # control statements the client's rollback path issues.  The
        # first connection to consume a counter claims it; concurrent
        # connections' statements pass through untouched.
        me = threading.get_ident()
        if self._die > 0 and self._die_owner in (None, me):
            self._die_owner = me
            self._die -= 1
            if self._die == 0:
                self._die_owner = None
                raise _Die()
        if self._fail > 0 and self._fail_owner in (None, me):
            self._fail_owner = me
            self._fail -= 1
            if self._fail == 0:
                self._fail_owner = None
            raise Error("restart transaction: injected conflict")
        m = re.fullmatch(
            r"SELECT value FROM registers WHERE id=(-?\d+)", s, re.I)
        if m:
            k = int(m.group(1))
            rows = ([(self.rows[k],)] if k in self.rows else [])
            return rows, ["value"], f"SELECT {len(rows)}"
        m = re.fullmatch(
            r"UPSERT INTO registers \(id, value\) "
            r"VALUES \((-?\d+), (-?\d+)\)", s, re.I)
        if m:
            self._write("registers", int(m.group(1)), int(m.group(2)))
            return [], [], "INSERT 0 1"
        m = re.fullmatch(
            r"UPDATE registers SET value=(-?\d+) "
            r"WHERE id=(-?\d+) AND value=(-?\d+)", s, re.I)
        if m:
            new, k, old = (int(m.group(1)), int(m.group(2)),
                           int(m.group(3)))
            if self.rows.get(k) == old:
                self._write("registers", k, new)
                return [], [], "UPDATE 1"
            return [], [], "UPDATE 0"
        # --- bank workload (suites/cockroach.py BankClient) -----------
        m = re.fullmatch(
            r"UPSERT INTO accounts \(id, balance\) "
            r"VALUES \((-?\d+), (-?\d+)\)", s, re.I)
        if m:
            self._write("accounts", int(m.group(1)), int(m.group(2)))
            return [], [], "INSERT 0 1"
        if re.fullmatch(r"SELECT id, balance FROM accounts", s, re.I):
            rows = sorted(self.accounts.items())
            return rows, ["id", "balance"], f"SELECT {len(rows)}"
        m = re.fullmatch(
            r"SELECT balance FROM accounts WHERE id=(-?\d+)", s, re.I)
        if m:
            k = int(m.group(1))
            rows = ([(self.accounts[k],)] if k in self.accounts
                    else [])
            return rows, ["balance"], f"SELECT {len(rows)}"
        m = re.fullmatch(
            r"UPDATE accounts SET balance=balance([+-])(\d+) "
            r"WHERE id=(-?\d+)", s, re.I)
        if m:
            sign, amt, k = (m.group(1), int(m.group(2)),
                            int(m.group(3)))
            if k not in self.accounts:
                return [], [], "UPDATE 0"
            delta = amt if sign == "+" else -amt
            self._write("accounts", k, self.accounts[k] + delta)
            return [], [], "UPDATE 1"
        raise Error(f"unsupported statement: {s[:80]}")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        buf = b""

        def read(n):
            nonlocal buf
            while len(buf) < n:
                chunk = sock.recv(65536)
                if not chunk:
                    raise OSError("client gone")
                buf += chunk
            out, buf = buf[:n], buf[n:]
            return out

        try:
            (ln,) = struct.unpack("!i", read(4))
            startup = read(ln - 4)
            (proto,) = struct.unpack("!i", startup[:4])
            if proto == 80877103:  # SSLRequest: refuse, expect retry
                sock.sendall(b"N")
                (ln,) = struct.unpack("!i", read(4))
                read(ln - 4)
            sock.sendall(_msg(b"R", struct.pack("!i", 0)) + _READY)
            while True:
                kind = read(1)
                (ln,) = struct.unpack("!i", read(4))
                payload = read(ln - 4)
                if kind == b"X":
                    return
                if kind != b"Q":
                    sock.sendall(_error("only simple query supported")
                                 + _READY)
                    continue
                sql = payload.rstrip(b"\x00").decode("utf-8", "replace")
                try:
                    rows, names, tag = self.server.engine.execute(sql)
                    out = b""
                    if names:
                        out += _row_desc(names)
                        for r in rows:
                            out += _data_row(r)
                    out += _complete(tag) + _READY
                    sock.sendall(out)
                except _Die:
                    return  # connection drops, statement unanswered
                except Error as e:
                    sock.sendall(_error(str(e)) + _READY)
        except OSError:
            return
        finally:
            # a dying connection rolls back its open transaction (and
            # releases the engine lock other connections block on) —
            # half-applied transfers must never leak
            abort = getattr(self.server.engine, "abort_connection",
                            None)
            if abort is not None:
                abort()


class MiniPGServer(socketserver.ThreadingTCPServer):
    """In-process pg-wire server: `MiniPGServer.start()` -> (srv, port)."""

    allow_reuse_address = True
    daemon_threads = True

    @classmethod
    def start(cls, engine=None, port: int = 0):
        srv = cls(("127.0.0.1", port), _Handler)
        srv.engine = engine or RegisterEngine()
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, srv.server_address[1]
