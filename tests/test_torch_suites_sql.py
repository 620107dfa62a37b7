"""The port's SQL family against the JAX package's: the pgwire shim
(``suites/pgwire.py``: client, engine, server), its durable server
(``live/pgwire_server.py``), ``cockroach`` and ``mongodb``.

The same inputs go through both packages and must give the same answer:
the wire frames byte for byte (each package's client against each
package's server), parameter quoting and its errors, the engine's
transactions and its fault counters, the SQL clients' ops against live
servers, a DB's commands on a ``DummyRemote`` (the whole log, under one
seeded ``random``), the test maps, the op functions and generators under
one seed, the nemeses, and the checkers' verdicts on seeded histories.
Then a short cockroach register run through the port's ``core.run``
against two stand-ins, sound and with one answering reads a committed
write behind, whose stored history the JAX package's checker decides key
for key as the port did; the durable server under ``kill -9``; and
``suites.SUITES``, all 26 of the JAX package's, each module with the
reference's public names.

Servers bind ports drawn below the kernel's ephemeral range (which starts
at 32768) and draw again when a port is taken."""

import collections
import importlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest
import torch

from jepsen_tpu import control as jcontrol
from jepsen_tpu import generator as jgen
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu_torch import cli as tcli
from jepsen_tpu_torch import control as tcontrol
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

KNOBS = ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
         "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_SHRINK", "JEPSEN_TPU_EXPLAIN",
         "JEPSEN_TPU_LIN_DECOMPOSE", "JEPSEN_TPU_LIN_ALGORITHM",
         "JEPSEN_TPU_STREAM")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mods(name, pkg="suites"):
    """(the JAX package's module, the port's module)."""
    return (importlib.import_module(f"jepsen_tpu.{pkg}.{name}"),
            importlib.import_module(f"jepsen_tpu_torch.{pkg}.{name}"))


#: (pgwire, cockroach, independent, history) of each package
JPKG = (_mods("pgwire")[0], _mods("cockroach")[0], jind, jh)
TPKG = (_mods("pgwire")[1], _mods("cockroach")[1], tind, th)


def _draw_port(bind):
    """``bind(port)`` on a port drawn below the ephemeral range, drawn
    again while taken."""
    rng = random.Random()
    while True:
        port = rng.randrange(20000, 32000)
        try:
            return bind(port), port
        except OSError:
            continue


def _pg_server(pgwire, engine=None):
    """``pgwire.MiniPGServer`` on a drawn port, serving on a daemon
    thread: (server, port)."""
    def bind(port):
        srv = pgwire.MiniPGServer(("127.0.0.1", port), pgwire._Handler)
        srv.engine = engine or pgwire.RegisterEngine()
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    return _draw_port(bind)


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _dummy(control, nodes, responses):
    r = control.DummyRemote(dict(responses))
    return {"nodes": list(nodes),
            "sessions": {n: control.Session(node=n, remote=r)
                         for n in nodes}}, r


# ---------------------------------------------------------------------------
# the wire: frames byte for byte, each client against each server
# ---------------------------------------------------------------------------


class _Tap:
    """A socket that records what passes through it."""

    def __init__(self, sock):
        self.sock, self.sent, self.got = sock, bytearray(), bytearray()

    def sendall(self, b):
        self.sent += b
        self.sock.sendall(b)

    def recv(self, n):
        b = self.sock.recv(n)
        self.got += b
        return b

    def settimeout(self, t):
        self.sock.settimeout(t)

    def close(self):
        self.sock.close()


#: a session of statements over one connection: (statement, params,
#: the fault to arm first)
SESSION = [
    ("CREATE TABLE IF NOT EXISTS registers (id INT PRIMARY KEY, "
     "value INT)", None, None),
    ("UPSERT INTO registers (id, value) VALUES (%s, %s)", (1, 5), None),
    ("SELECT value FROM registers WHERE id=%s", (1,), None),
    ("SELECT value FROM registers WHERE id=%s", (2,), None),
    ("UPDATE registers SET value=%s WHERE id=%s AND value=%s", (7, 1, 5),
     None),
    ("UPDATE registers SET value=%s WHERE id=%s AND value=%s", (9, 1, 5),
     None),
    ("UPSERT INTO accounts (id, balance) VALUES (%s, %s)", (0, 10), None),
    ("UPDATE accounts SET balance=balance-%s WHERE id=%s", (3, 0), None),
    ("SELECT id, balance FROM accounts", None, None),
    ("SELECT value FROM registers WHERE id=%s", (1,), "fail"),
    ("DELETE FROM registers", None, None),
    ("SELECT value FROM registers WHERE id=%s", (1,), None),
]


def _session(client, server, monkeypatch):
    """``SESSION`` through ``client.connect`` against ``server``'s
    handler over a socket pair: (results, bytes sent, bytes received)."""
    a, b = socket.socketpair()
    srv = type("S", (), {})()
    srv.engine = server.RegisterEngine()
    handler = threading.Thread(target=server._Handler,
                               args=(b, ("pair", 0), srv), daemon=True)
    handler.start()
    tap = _Tap(a)
    monkeypatch.setattr(socket, "create_connection",
                        lambda addr, timeout=None: tap)
    conn = client.connect("127.0.0.1", 26257)
    out = []
    for sql, params, fault in SESSION:
        if fault == "fail":
            srv.engine.fail_next(1)
        try:
            with conn:
                with conn.cursor() as cur:
                    cur.execute(sql, params)
                    out.append((cur.rowcount, cur.fetchall()))
        except Exception as e:  # noqa: BLE001 - the answer compared
            out.append((type(e).__name__, str(e)))
    conn.close()
    handler.join(timeout=10)
    b.close()
    return out, bytes(tap.sent), bytes(tap.got), dict(srv.engine.rows), \
        dict(srv.engine.accounts)


def test_frames_equal_reference_each_client_against_each_server(
        monkeypatch):
    jpg, tpg = _mods("pgwire")
    runs = {(c, s): _session(cm, sm, monkeypatch)
            for c, cm in (("jax", jpg), ("torch", tpg))
            for s, sm in (("jax", jpg), ("torch", tpg))}
    first = runs[("jax", "jax")]
    for key, run in runs.items():
        assert run == first, key
    out, sent, got, rows, accounts = first
    assert out[2] == (1, [(5,)]) and out[3] == (0, [])
    assert out[4][0] == 1 and out[5][0] == 0
    assert out[8] == (1, [(0, 7)])
    assert out[9] == ("Error", "restart transaction: injected conflict")
    assert out[10][0] == "Error" and "unsupported statement" in out[10][1]
    assert rows == {1: 7} and accounts == {0: 7}
    assert sent.startswith(tpg._startup_payload("root", "jepsen"))
    assert sent.count(b"Q\x00\x00\x00\x0aBEGIN\x00") == len(SESSION)


def test_frame_builders_equal_reference():
    jpg, tpg = _mods("pgwire")
    for args in (("root", "jepsen"), ("u", "")):
        assert tpg._startup_payload(*args) == jpg._startup_payload(*args)
    assert tpg._msg(b"Q", b"x") == jpg._msg(b"Q", b"x")
    assert tpg._row_desc(["id", "v"]) == jpg._row_desc(["id", "v"])
    for row in ((1, None, "a'b"), (), (-3,)):
        assert tpg._data_row(row) == jpg._data_row(row)
    assert tpg._complete("UPDATE 1") == jpg._complete("UPDATE 1")
    assert tpg._error("boom") == jpg._error("boom")
    assert tpg._READY == jpg._READY


def test_server_refuses_ssl_and_extended_query_as_reference():
    """An SSLRequest is answered ``N`` and the startup that follows is
    served; a message other than a simple query gets an error and
    ReadyForQuery."""
    outs = []
    for pg in _mods("pgwire"):
        a, b = socket.socketpair()
        srv = type("S", (), {})()
        srv.engine = pg.RegisterEngine()
        t = threading.Thread(target=pg._Handler, args=(b, ("p", 0), srv),
                             daemon=True)
        t.start()
        a.sendall(pg.struct.pack("!ii", 8, 80877103))
        a.sendall(pg._startup_payload("root", "jepsen"))
        a.sendall(pg._msg(b"P", b"stmt\x00"))
        a.sendall(pg._msg(b"X"))
        t.join(timeout=10)
        b.close()
        a.settimeout(5)
        got = b""
        while True:
            chunk = a.recv(65536)
            if not chunk:
                break
            got += chunk
        a.close()
        outs.append(got)
    assert outs[1] == outs[0]
    assert outs[1].startswith(b"N") and b"only simple query" in outs[1]


# ---------------------------------------------------------------------------
# the shim: parameter quoting and the engine's fault counters
# (tests/test_clients_live.py :443-488)
# ---------------------------------------------------------------------------

PARAMS = [("SELECT %s", (7,)), ("SELECT %s", (None,)),
          ("SELECT %s", ("it's",)), ("SELECT %s", (True,)),
          ("SELECT %s", (False,)), ("SELECT %s", (1.5,)),
          ("LIKE 'a%%' AND x=%s", (1,)), ("SELECT %d", (1,)),
          ("%s %s", (1,)), ("%s", (1, 2)), ("%s", (object(),)),
          ("%s", (float("nan"),)), ("SELECT 1 %", ()), ("%s", ([1],))]


def test_param_interpolation_equals_reference():
    from decimal import Decimal

    jpg, tpg = _mods("pgwire")
    cases = PARAMS + [("SELECT %s", (Decimal("1.50"),)),
                      ("%s", (Decimal("inf"),))]
    outs = []
    for pg in (jpg, tpg):
        got = []
        for sql, params in cases:
            try:
                got.append(("ok", pg._interpolate(sql, params)))
            except pg.Error as e:
                got.append(("error", str(e).split(" of type")[0]
                            if "object" in str(e) else str(e)))
        outs.append(got)
    assert outs[1] == outs[0]
    want = {0: "SELECT 7", 1: "SELECT NULL", 2: "SELECT 'it''s'",
            3: "SELECT TRUE", 6: "LIKE 'a%' AND x=1",
            len(PARAMS): "SELECT 1.50"}
    for i, text in want.items():
        assert outs[1][i] == ("ok", text)
    for i, msg in ((7, "unsupported format"), (8, "not enough parameters"),
                   (9, "more parameters"), (10, "can't adapt"),
                   (11, "non-finite"), (12, "lone '%'")):
        assert outs[1][i][0] == "error" and msg in outs[1][i][1], i


def _counter_scoping(pg):
    """tests/test_clients_live.py :466-488 on ``pg``'s engine: what each
    statement returned, in order."""
    eng = pg.RegisterEngine()
    seen = [eng.execute("UPSERT INTO registers (id, value) VALUES (1, 5)")]
    eng.die_next(3)
    results = []

    def other_conn():
        results.append(
            eng.execute("SELECT value FROM registers WHERE id=1"))

    seen.append(eng.execute("SELECT value FROM registers WHERE id=1"))
    t = threading.Thread(target=other_conn)
    t.start()
    t.join(timeout=10)
    seen.append(results[0])
    eng.abort_connection()
    for _ in range(4):
        seen.append(eng.execute("SELECT value FROM registers WHERE id=1"))
    eng.fail_next(2)
    eng.disarm()
    seen.append(eng.execute("SELECT value FROM registers WHERE id=1"))
    eng.fail_next(1)
    try:
        eng.execute("SELECT value FROM registers WHERE id=1")
    except pg.Error as e:
        seen.append(str(e))
    eng.die_next(1)
    try:
        eng.execute("SELECT value FROM registers WHERE id=1")
    except pg._Die:
        seen.append("died")
    return seen


def test_injection_counters_scope_to_consuming_connection_as_reference():
    outs = [_counter_scoping(pg) for pg in _mods("pgwire")]
    assert outs[1] == outs[0]
    assert outs[1][2] == ([(5,)], ["value"], "SELECT 1")
    assert outs[1][-2:] == ["restart transaction: injected conflict",
                            "died"]


def _txn_script(pg):
    """BEGIN/ROLLBACK/COMMIT and a dead connection mid-transaction on
    ``pg``'s engine: the tables after each step."""
    eng = pg.RegisterEngine()
    steps = []

    def snap():
        steps.append((dict(eng.rows), dict(eng.accounts), eng._txn_owner
                      is None))

    eng.execute("UPSERT INTO accounts (id, balance) VALUES (0, 10)")
    eng.execute("UPSERT INTO accounts (id, balance) VALUES (1, 10)")
    snap()
    eng.execute("BEGIN")
    eng.execute("UPDATE accounts SET balance=balance-4 WHERE id=0")
    eng.execute("UPDATE accounts SET balance=balance+4 WHERE id=1")
    eng.execute("UPSERT INTO registers (id, value) VALUES (3, 1)")
    eng.execute("UPSERT INTO registers (id, value) VALUES (3, 2)")
    snap()
    eng.execute("ROLLBACK")
    snap()
    eng.execute("BEGIN")
    eng.execute("BEGIN")  # re-entrant
    eng.execute("UPDATE accounts SET balance=balance-4 WHERE id=0")
    eng.execute("COMMIT")
    snap()
    eng.execute("BEGIN")
    eng.execute("UPDATE accounts SET balance=balance+9 WHERE id=1")
    eng.abort_connection()
    snap()
    steps.append(eng.execute("UPDATE accounts SET balance=balance+1 "
                             "WHERE id=7"))
    steps.append(eng.execute("COMMIT"))
    return steps


def test_engine_transactions_equal_reference():
    outs = [_txn_script(pg) for pg in _mods("pgwire")]
    assert outs[1] == outs[0]
    assert outs[1][2] == ({}, {0: 10, 1: 10}, True)
    assert outs[1][3][1] == {0: 6, 1: 10}
    assert outs[1][4] == ({}, {0: 6, 1: 10}, True)


# ---------------------------------------------------------------------------
# the SQL clients live (tests/test_clients_live.py :312-440)
# ---------------------------------------------------------------------------


def _register_live(client_pkg, server_pg):
    """tests/test_clients_live.py :312-358: ``client_pkg``'s
    ``RegisterClient`` against ``server_pg``'s server, each op's (type,
    value, whether it carries an error)."""
    pg, cockroach, ind, h = client_pkg
    srv, port = _pg_server(server_pg)
    t = {"sql_port": port}
    kv = ind.tuple_
    out = []

    def op(f, k, v):
        o = c.invoke(t, h.invoke_op(0, f, kv(k, v)))
        out.append((o.type, o.value.key, o.value.value, o.error is None))

    try:
        c = cockroach.RegisterClient().open(t, "127.0.0.1")
        c.setup(t)
        op("write", 1, 5)
        op("read", 1, None)
        op("read", 2, None)
        op("cas", 1, (5, 7))
        op("cas", 1, (5, 9))
        op("read", 1, None)
        srv.engine.fail_next(1)
        op("read", 1, None)
        srv.engine.fail_next(1)
        op("write", 1, 8)
        op("read", 1, None)
        srv.engine.die_next(1)
        op("write", 3, 1)
        op("read", 3, None)
        c.close(t)
    finally:
        _stop(srv)
    return out


@pytest.mark.parametrize("pair", ["torch-torch", "torch-jax", "jax-torch"])
def test_sql_register_live_equals_reference(pair):
    """The port's client against the JAX package's server and the JAX
    package's client against the port's, each the JAX package's own
    answer."""
    pkgs = {"jax": JPKG, "torch": TPKG}
    c, s = pair.split("-")
    want = _register_live(JPKG, JPKG[0])
    got = _register_live(pkgs[c], pkgs[s][0])
    assert got == want
    assert [o[0] for o in got] == ["ok", "ok", "ok", "ok", "fail", "ok",
                                   "fail", "info", "ok", "info", "fail"]
    assert got[1][2] == 5 and got[2][2] is None and got[5][2] == 7


def test_pgwire_shim_is_the_fallback_driver():
    for pg, cockroach in zip(_mods("pgwire"), _mods("cockroach")):
        try:
            import psycopg2  # noqa: F401
        except ImportError:
            assert cockroach.pg_driver() is pg


def _bank_live(pkg):
    """tests/test_clients_live.py :362-440 with ``pkg``'s client and
    server: four clients of 25 seeded transfers each, then an
    insufficient-funds transfer and a connection that dies with a write
    applied.  The answers that do not depend on the threads' order."""
    pg, cockroach, _ind, h = pkg
    srv, port = _pg_server(pg)
    t = {"sql_port": port, "accounts": list(range(4)), "total_amount": 100}
    try:
        c0 = cockroach.BankClient().open(t, "127.0.0.1")
        c0.setup(t)
        start = c0.invoke(t, h.invoke_op(0, "read", None)).value
        results = []

        def worker(seed):
            c = cockroach.BankClient().open(t, "127.0.0.1")
            r = random.Random(seed)
            for _ in range(25):
                a, b = r.sample(t["accounts"], 2)
                results.append(c.invoke(t, h.invoke_op(0, "transfer", {
                    "from": a, "to": b, "amount": 1 + r.randrange(5)})).type)
            c.close(t)

        ts = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
        for x in ts:
            x.start()
        for x in ts:
            x.join(timeout=60)
        total = sum(c0.invoke(t, h.invoke_op(0, "read", None)).value
                    .values())
        broke = c0.invoke(t, h.invoke_op(0, "transfer", {
            "from": 0, "to": 1, "amount": 10**6})).type
        balances = c0.invoke(t, h.invoke_op(0, "read", None)).value
        if balances[0] < 1:
            rich = max(balances, key=balances.get)
            c0.invoke(t, h.invoke_op(0, "transfer",
                                     {"from": rich, "to": 0, "amount": 1}))
        before = c0.invoke(t, h.invoke_op(0, "read", None)).value
        cdie = cockroach.BankClient().open(t, "127.0.0.1")
        srv.engine.die_next(3)
        try:
            died = cdie.invoke(t, h.invoke_op(0, "transfer", {
                "from": 0, "to": 1, "amount": 1})).type
            after = c0.invoke(t, h.invoke_op(0, "read", None)).value
        finally:
            srv.engine.disarm()
    finally:
        _stop(srv)
    return {"start": start, "threads_done": not any(x.is_alive()
                                                    for x in ts),
            "types": sorted(set(results)), "n": len(results),
            "total": total, "broke": broke, "died": died,
            "rolled_back": after == before}


def test_bank_live_concurrent_transfers_equal_reference():
    outs = [_bank_live(p) for p in (JPKG, TPKG)]
    assert outs[1]["types"] and set(outs[1]["types"]) <= {"ok", "fail"}
    for o in outs:
        o["types"] = None  # which transfers fail follows the threads
    assert outs[1] == outs[0]
    assert outs[1] == {"start": {0: 25, 1: 25, 2: 25, 3: 25},
                       "threads_done": True, "types": None, "n": 100,
                       "total": 100, "broke": "fail", "died": "info",
                       "rolled_back": True}


# ---------------------------------------------------------------------------
# live/pgwire_server.py (tests/test_live.py :1020)
# ---------------------------------------------------------------------------


def _spawn_pgwire_server(pkg, port, data):
    p = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.live.pgwire_server", str(port),
         data], cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    line = p.stdout.readline()
    assert "listening" in line, line + (p.stdout.read() or "")
    return p


def _free_port():
    def bind(port):
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port))
        finally:
            s.close()

    return _draw_port(bind)[1]


def _kill9(pkg, pg, data):
    """The reference's crash contract on ``pkg``'s daemon: three
    committed writes, an uncommitted one, kill -9, restart: the row read
    back."""
    port = _free_port()
    p = _spawn_pgwire_server(pkg, port, data)
    try:
        conn = pg.connect("127.0.0.1", port)
        conn.autocommit = False
        for v in (1, 2, 3):
            with conn:
                with conn.cursor() as cur:
                    cur.execute("UPSERT INTO registers (id, value) "
                                "VALUES (%s, %s)", (0, v))
        with conn.cursor() as cur:
            cur.execute("UPSERT INTO registers (id, value) "
                        "VALUES (%s, %s)", (0, 99))
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=5)
        p = _spawn_pgwire_server(pkg, port, data)
        conn2 = pg.connect("127.0.0.1", port)
        conn2.autocommit = False
        with conn2:
            with conn2.cursor() as cur:
                cur.execute("SELECT value FROM registers WHERE id=%s", (0,))
                return cur.fetchone()
    finally:
        p.kill()
        p.wait(timeout=5)


def test_pgwire_server_kill9_loses_only_unacked(tmp_path):
    rows = [_kill9(pkg, pg, str(tmp_path / pkg))
            for pkg, pg in zip(("jepsen_tpu", "jepsen_tpu_torch"),
                               _mods("pgwire"))]
    assert rows[1] == rows[0] == (3,)
    logs = [sorted(os.listdir(tmp_path / pkg))
            for pkg in ("jepsen_tpu", "jepsen_tpu_torch")]
    assert logs[1] == logs[0]


def _durable_script(mod, data):
    eng = mod.DurableRegisterEngine(data)
    eng.execute("UPSERT INTO registers (id, value) VALUES (1, 1)")
    eng.execute("BEGIN")
    eng.execute("UPSERT INTO registers (id, value) VALUES (2, 5)")
    eng.execute("UPSERT INTO accounts (id, balance) VALUES (0, 9)")
    eng.execute("COMMIT")
    eng.execute("BEGIN")
    eng.execute("UPSERT INTO registers (id, value) VALUES (2, 6)")
    eng.execute("ROLLBACK")
    eng.execute("BEGIN")
    eng.execute("UPSERT INTO registers (id, value) VALUES (1, 7)")
    eng.abort_connection()
    replayed = mod.DurableRegisterEngine(data)
    files = {f: (Path(data) / f).read_bytes()
             for f in sorted(os.listdir(data))}
    return dict(replayed.rows), dict(replayed.accounts), files


def test_durable_engine_journal_and_replay_equal_reference(tmp_path):
    outs = [_durable_script(mod, str(tmp_path / str(i)))
            for i, mod in enumerate(_mods("pgwire_server", "live"))]
    assert outs[1] == outs[0]
    assert outs[1][:2] == ({1: 1, 2: 5}, {0: 9})


def test_pgwire_server_usage_equals_reference(capsys):
    codes = []
    for mod in _mods("pgwire_server", "live"):
        with pytest.raises(SystemExit) as e:
            mod.main(["1"])
        codes.append((e.value.code, capsys.readouterr().err))
    assert codes[1] == codes[0] == (
        2, "usage: pgwire_server PORT DATA_DIR [--host H]\n")


def test_pgwire_server_loads_neither_numpy_nor_torch():
    code = ("import sys; sys.argv = ['x']\n"
            "import jepsen_tpu_torch.live.pgwire_server\n"
            "bad = [m for m in ('numpy', 'torch') if m in sys.modules]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# cockroach: the DB, the registry, generators, clients' helpers, nemeses
# (tests/test_suites.py :257-399)
# ---------------------------------------------------------------------------

_CRDB = {"stat /": (1, "", "no"),
         "ls -A": (0, "cockroach-v2.0.0.linux-amd64\n", ""),
         "dirname": (0, "/opt", "")}


def test_cockroach_db_commands_equal_reference(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)  # primary's wait
    logs = []
    for mod, control in zip(_mods("cockroach"), (jcontrol, tcontrol)):
        test, r = _dummy(control, ("n1", "n2", "n3"), _CRDB)
        random.seed("crdb")
        mod.db().setup(test, "n1")
        mod.db().setup(test, "n2")
        mod.db().teardown(test, "n1")
        logs.append((r.log, mod.db().log_files(test, "n1")))
    assert logs[1] == logs[0]
    cmds = [e[2] for e in logs[1][0] if e[0] == "n1" and e[1] == "exec"]
    assert any("--startas /opt/cockroach/cockroach -- start --insecure" in c
               and "--join=n1,n2,n3" in c for c in cmds)
    assert any("CREATE DATABASE IF NOT EXISTS jepsen" in c for c in cmds)


def test_cockroach_kill_and_start_node_equal_reference():
    logs = []
    for mod, control in zip(_mods("cockroach"), (jcontrol, tcontrol)):
        test, r = _dummy(control, ("n1", "n2", "n3"), {})
        outs = (mod.kill_node(test, "n2"), mod.start_node(test, "n2"))
        logs.append((outs, r.log))
    assert logs[1] == logs[0]
    cmds = [e[2] for e in logs[1][1] if e[1] == "exec"]
    assert any("kill" in c and "-9" in c and "cockroach" in c for c in cmds)


def _shape(t):
    def name(x):
        return None if x is None else type(x).__name__

    model = t.get("model")
    checkers = getattr(t["checker"], "checkers", None)
    inner = getattr(t["checker"], "checker", None)
    return {
        "keys": sorted(t), "name": t["name"],
        "classes": {k: name(t.get(k))
                    for k in ("client", "nemesis", "db", "os", "net",
                              "checker", "generator")},
        "model": None if model is None else (model.name, model.init),
        "checkers": sorted(checkers or getattr(inner, "checkers", {}) or {}),
        "scalars": {k: v for k, v in t.items()
                    if isinstance(v, (int, float, str, bool))
                    and k != "start_time"},
        "lists": {k: v for k, v in t.items() if isinstance(v, list)
                  and all(isinstance(x, (int, str)) for x in v)},
    }


_OPTS = {"nodes": ["n1", "n2", "n3"], "concurrency": 4, "time_limit": 1}


def test_cockroach_registry_equals_reference():
    jmod, tmod = _mods("cockroach")
    assert sorted(tmod.REGISTRY.workloads) == \
        sorted(jmod.REGISTRY.workloads)
    assert sorted(tmod.REGISTRY.nemeses) == sorted(jmod.REGISTRY.nemeses)
    want = {"skews", "strobe-skews", "small-skews", "subcritical-skews",
            "critical-skews", "big-skews", "huge-skews", "startstop",
            "startstop2", "startkill", "startkill2", "parts", "majring",
            "split"}
    assert want <= set(tmod.REGISTRY.nemeses)
    assert {"register", "bank", "monotonic", "sequential", "g2"} <= \
        set(tmod.REGISTRY.workloads)
    for name in sorted(tmod.REGISTRY.nemeses):
        a, b = jmod.REGISTRY.nemeses[name], tmod.REGISTRY.nemeses[name]
        assert (type(b.nemesis).__name__, b.during is None,
                b.final is None) == (type(a.nemesis).__name__,
                                     a.during is None, a.final is None), \
            name


CRDB_MAPS = [(w, n) for w in ("register", "bank", "monotonic",
                              "sequential", "g2")
             for n in ("none", "parts", "skews", "split")]


@pytest.mark.parametrize("workload,nemesis", CRDB_MAPS)
def test_cockroach_test_maps_equal_reference(workload, nemesis):
    from jepsen_tpu import client as jclient
    from jepsen_tpu_torch import client as tclient

    shapes = []
    for mod, client in zip(_mods("cockroach"), (jclient, tclient)):
        t = mod.REGISTRY.build_test(_OPTS | {"workload": workload,
                                             "nemesis": nemesis})
        assert t["client"] is not client.noop and t["generator"]
        shapes.append(_shape(t))
    assert shapes[1] == shapes[0]
    assert workload in shapes[1]["name"]


def test_cockroach_generators_equal_reference_under_one_seed():
    test = {"nodes": ["n1", "n2"], "concurrency": 4,
            "accounts": list(range(8))}
    outs = []
    for mod, gen in zip(_mods("cockroach"), (jgen, tgen)):
        random.seed(0)
        bank = [mod.bank_generator(test, p) for p in range(20)]
        w = mod.monotonic_workload({"concurrency": 4})
        mono = (gen.gen_op(w["generator"], test, 0),
                gen.gen_op(w["final_generator"], test, 0))
        w = mod.sequential_workload({"concurrency": 4})
        with gen.with_threads([0, 1, 2, 3]):
            seq = [gen.gen_op(w["generator"], test, p)
                   for p in (0, 1, 0, 1, 3, 2)]
        w = mod.register_workload({"concurrency": 8, "ops_per_key": 5})
        with gen.with_threads(list(range(8))):
            reg = [gen.gen_op(w["generator"], test | {"concurrency": 8},
                              p % 8) for p in range(30)]
        w = mod.g2_workload({})
        with gen.with_threads([0, 1, 2, 3]):
            g2 = [gen.gen_op(w["generator"], test, p % 4) for p in range(8)]

        def kv(ops):
            return [None if o is None else
                    (o["f"], o["value"].key, o["value"].value) for o in ops]

        outs.append((bank, mono, seq, kv(reg), kv(g2)))
    assert outs[1] == outs[0]
    bank, mono, seq, reg, g2 = outs[1]
    assert all(o["value"]["from"] != o["value"]["to"] for o in bank
               if o["f"] == "transfer")
    assert mono[0]["f"] == "add" and mono[1]["f"] == "read"
    assert [o["value"] for o in seq[:4]] == [0, 1, 2, 3]
    assert seq[4]["f"] == "read"
    per_key = collections.Counter(k for _f, k, _v in reg)
    assert max(per_key.values()) <= 5 and min(per_key) == 0


def test_cockroach_sequential_tables_and_keyrange_equal_reference():
    outs = []
    for mod in _mods("cockroach"):
        c = mod.SequentialClient()
        sks = c._subkeys(3, 7)
        test = {}
        mod.update_keyrange(test, "seq_0", "3_1")
        mod.update_keyrange(test, "seq_0", "3_2")
        outs.append((sks, [c._table_for(s) for s in sks + ["x", "9_4"]],
                     {t: sorted(v) for t, v in test["keyrange"].items()}))
    assert outs[1] == outs[0]
    assert outs[1][0] == ["7_0", "7_1", "7_2"]


def _nem_op(h, f):
    return h.Op(index=0, type="info", f=f, value=None, process="nemesis",
                time=0)


def _one_node_at_a_time(monkeypatch):
    """``control.on_nodes`` of both packages node by node, in the test's
    order, so a seeded draw per node lands on the same node in each."""
    for control in (jcontrol, tcontrol):
        monkeypatch.setattr(control, "on_nodes", lambda test, f, nodes=None: {
            n: f(test, n) for n in list(
                nodes if nodes is not None else test.get("nodes") or [])})


def test_cockroach_bump_time_nemesis_equals_reference(monkeypatch):
    _one_node_at_a_time(monkeypatch)
    outs = []
    for mod, control, h in zip(_mods("cockroach"), (jcontrol, tcontrol),
                               (jh, th)):
        test, r = _dummy(control, ("n1", "n2", "n3"),
                         {"stat /": (0, "yes", "")})
        nem = mod.BumpTimeNemesis(0.25)
        random.seed(1)
        nem.setup(test)
        a = nem.invoke(test, _nem_op(h, "start"))
        b = nem.invoke(test, _nem_op(h, "stop"))
        nem.teardown(test)
        outs.append(((a.type, a.value), (b.type, b.value), r.log))
    assert outs[1] == outs[0]
    (_t, bumped), _stop_, log = outs[1]
    assert set(bumped) == {"n1", "n2", "n3"}
    assert all(v in (0, 0.25) for v in bumped.values())
    cmds = [e[2] for e in log if e[1] == "exec"]
    assert any("ntpdate" in c for c in cmds)
    assert any("start-stop-daemon --start" in c for c in cmds)


def test_cockroach_split_nemesis_without_psycopg2_as_reference():
    """A reference fault the port copies: ``SplitNemesis`` imports
    psycopg2 with no shim fallback, so without psycopg2 every ``split``
    of a recorded key completes ``split-failed``; with no key recorded,
    ``nothing-to-split``."""
    outs = []
    for mod, h in zip(_mods("cockroach"), (jh, th)):
        nem = mod.SplitNemesis()
        test = {"nodes": ["n1", "n2", "n3"]}
        first = nem.invoke(test, _nem_op(h, "split"))
        mod.update_keyrange(test, "seq_0", "3_1")
        random.seed(2)
        second = nem.invoke(test, _nem_op(h, "split"))
        outs.append([(o.type, o.value) for o in (first, second)])
    assert outs[1] == outs[0]
    assert outs[1][0] == ("info", "nothing-to-split")
    try:
        import psycopg2  # noqa: F401
    except ImportError:
        kind, value = outs[1][1]
        assert kind == "info" and value[0] == "split-failed"
        assert "psycopg2" in value[1]


# ---------------------------------------------------------------------------
# mongodb (tests/test_suites2.py :14-72)
# ---------------------------------------------------------------------------


def _rs_status_ok(nodes):
    return json.dumps({"members": [
        {"name": f"{n}:27017", "stateStr":
         "PRIMARY" if i == 0 else "SECONDARY"}
        for i, n in enumerate(nodes)]})


def test_mongo_replica_set_config_equals_reference():
    jmod, tmod = _mods("mongodb")
    for nodes in (["n1"], ["n1", "n2", "n3"]):
        test = {"nodes": nodes}
        assert tmod.target_replica_set_config(test) == \
            jmod.target_replica_set_config(test)
    cfg = tmod.target_replica_set_config({"nodes": ["n1", "n2", "n3"]})
    assert cfg["_id"] == "jepsen"
    assert cfg["members"][2] == {"_id": 2, "host": "n3:27017"}


@pytest.mark.parametrize("node", ["n1", "n2"])
def test_mongo_db_commands_equal_reference(node, monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    nodes = ["n1", "n2", "n3"]
    logs = []
    for mod, control in zip(_mods("mongodb"), (jcontrol, tcontrol)):
        test, r = _dummy(control, nodes, {
            "rs.status()": (0, _rs_status_ok(nodes), ""),
            "pkgin list": (0, "", "")})
        test["barrier"] = "no-barrier"
        mod.db("3.0.4").setup(test, node)
        mod.db("3.0.4").teardown(test, node)
        logs.append((r.log, mod.db().log_files(test, node)))
    assert logs[1] == logs[0]
    cmds = [e[2] for e in logs[1][0] if e[0] == node and e[1] == "exec"]
    assert any("pkgin -y install mongodb-3.0.4" in c for c in cmds)
    assert any("rs.initiate" in c for c in cmds) is (node == "n1")


def test_mongo_await_join_and_primary_equal_reference():
    outs = []
    for mod, control in zip(_mods("mongodb"), (jcontrol, tcontrol)):
        r = control.DummyRemote(
            {"rs.status()": (0, _rs_status_ok(["n1", "n2"]), "")})
        sess = control.Session(node="n1", remote=r)
        mod.await_join({"nodes": ["n1", "n2"]}, sess, timeout_s=2)
        mod.await_primary(sess, timeout_s=2)
        status = json.loads(_rs_status_ok(["n1", "n2"]))
        outs.append((r.log, sorted(mod._member_nodes(status)),
                     mod._has_primary(status),
                     mod._has_primary({"members": []})))
    assert outs[1] == outs[0]
    assert outs[1][1:] == (["n1", "n2"], True, False)


MONGO_MAPS = [{"write_concern": wc} for wc in
              ("majority", "journaled", "acknowledged", "unacknowledged")] \
    + [{"no_reads": True}, {"workload": "transfer"}, {"version": "3.2.1"}]


@pytest.mark.parametrize("opts", MONGO_MAPS,
                         ids=lambda o: "-".join(map(str, o.values())))
def test_mongo_test_maps_equal_reference(opts):
    jmod, tmod = _mods("mongodb")
    assert tmod.WRITE_CONCERNS == jmod.WRITE_CONCERNS
    shapes = [_shape(m.mongo_test({"nodes": ["n1"], "time_limit": 1}
                                  | opts)) for m in (jmod, tmod)]
    assert shapes[1] == shapes[0]
    if "write_concern" in opts:
        assert opts["write_concern"] in shapes[1]["name"]
    t = tmod.mongo_test({"nodes": ["n1"]} | opts)
    want = tmod.TransferClient if opts.get("workload") == "transfer" \
        else tmod.DocumentCASClient
    assert isinstance(t["client"], want)


def test_mongo_ops_equal_reference_and_clients_name_pymongo():
    outs = []
    for mod in _mods("mongodb"):
        random.seed(3)
        ops = [f({}, p) for p in range(10) for f in (mod.r, mod.w, mod.cas)]
        try:
            mod._pymongo()
            err = None
        except RuntimeError as e:
            err = str(e)
        outs.append((ops, err))
    assert outs[1] == outs[0]
    try:
        import pymongo  # noqa: F401
    except ImportError:
        assert "pymongo" in outs[1][1]


# ---------------------------------------------------------------------------
# checkers on seeded histories, the command line, lazy driver imports
# ---------------------------------------------------------------------------


def _seeded_register(h_mod, seed, corrupt):
    from jepsen_tpu import synth as jsynth

    rng = random.Random(seed)
    hist = jsynth.register_history(rng, n_ops=40, n_procs=4, overlap=3,
                                   n_values=4)
    if corrupt:
        hist = jsynth.corrupt_read(rng, hist)
    return [h_mod.Op(**{k: getattr(op, k) for k in
                        ("process", "type", "f", "value", "time", "index",
                         "error")}) for op in hist]


@pytest.mark.parametrize("seed,corrupt", [(1, False), (2, True),
                                          (3, True)])
def test_doc_cas_checker_verdicts_equal_reference(seed, corrupt, tmp_path):
    """mongodb's doc-cas composition (linear, timeline, perf) on the same
    seeded register history."""
    outs = []
    for mod, h in zip(_mods("mongodb"), (jh, th)):
        t = mod.doc_cas_test({"nodes": ["n1"]})
        test = {"name": "doc-cas", "start_time": "t", "device": "cpu",
                "store_base": str(tmp_path / h.__name__)}
        res = t["checker"].check(test, _seeded_register(h, seed, corrupt))
        outs.append((res["valid"], res["linear"]["valid"],
                     res["timeline"]["valid"]))
    assert outs[1] == outs[0]


def test_cockroach_bank_checker_verdicts_equal_reference():
    outs = []
    for mod, h in zip(_mods("cockroach"), (jh, th)):
        t = mod.REGISTRY.build_test(_OPTS | {"workload": "bank"})
        good = [h.Op(process=0, type="invoke", f="read", value=None,
                     time=0, index=0),
                h.Op(process=0, type="ok", f="read",
                     value={i: 12 + (i < 4) for i in range(8)}, time=1,
                     index=1)]
        bad = good + [h.Op(process=1, type="invoke", f="read", value=None,
                           time=2, index=2),
                      h.Op(process=1, type="ok", f="read",
                           value={i: 12 for i in range(8)}, time=3,
                           index=3)]
        outs.append([t["checker"].check(t | {"name": "bank"}, x)["valid"]
                     for x in (good, bad)])
    assert outs[1] == outs[0] == [True, False]


@pytest.mark.parametrize("name", ["cockroach", "mongodb"])
def test_main_exit_codes_equal_reference(name, capsys):
    codes = []
    for mod in _mods(name):
        for argv in (["test", "--no-such-flag"], ["nosuch"],
                     ["test", "-w", "nope"] if name == "cockroach"
                     else ["test", "--workload", "nope"]):
            with pytest.raises(SystemExit) as e:
                mod.main(argv)
            codes.append(e.value.code)
    capsys.readouterr()
    assert codes[3:] == codes[:3] == [tcli.EXIT_BAD_ARGS] * 3


def test_cockroach_module_without_a_card_names_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.suites.cockroach", "test",
         "--dummy", "-n", "n1", "--workload", "register", "--time-limit",
         "1", "--device", "cuda"], cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == tcli.EXIT_BAD_ARGS
    assert "torch.cuda.is_available() is False" in out.stderr
    assert not (tmp_path / "store").exists()


_LAZY = r"""
import importlib.abc, sys, time
DRIVERS = ("psycopg2", "pymysql", "pika", "pymongo")
asked = []

class Watch(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in DRIVERS:
            asked.append(name)
        return None

sys.meta_path.insert(0, Watch())
sys.path.insert(0, {repo!r})
time.sleep = lambda s: None
from jepsen_tpu_torch import control
from jepsen_tpu_torch.suites import (chronos, cockroach, crate, dgraph,
    elasticsearch, galera, mongodb, mysql_cluster, percona, postgres_rds,
    rabbitmq, robustirc)
opts = {{"nodes": ["n1", "n2", "n3"], "time_limit": 1, "concurrency": 4}}
for w in cockroach.REGISTRY.workloads:
    cockroach.REGISTRY.build_test(opts | {{"workload": w}})
for wc in mongodb.WRITE_CONCERNS:
    mongodb.mongo_test(opts | {{"write_concern": wc}})
mongodb.mongo_test(opts | {{"workload": "transfer"}})
for w in galera.WORKLOADS:
    galera.galera_test(opts | {{"workload": w}})
for w in elasticsearch.WORKLOADS:
    elasticsearch.es_test(opts | {{"workload": w}})
for w in crate.TESTS:
    crate.crate_test(opts | {{"workload": w}})
for w in dgraph.WORKLOADS:
    dgraph.dgraph_test(opts | {{"workload": w}})
percona.bank_test(opts)
postgres_rds.bank_test(opts)
rabbitmq.rabbit_test(opts)
robustirc.sets_test(opts)
chronos.chronos_test(opts)
mysql_cluster.simple_test(opts)
r = control.DummyRemote({{"stat /": (1, "", "no"), "dirname": (0, "/opt", ""),
    "ls -A": (0, "x\n", ""), "dpkg-query": (1, "", "")}})
test = {{"nodes": ["n1"], "barrier": "no-barrier",
        "sessions": {{"n1": control.Session(node="n1", remote=r)}}}}
for db in (cockroach.db(), galera.db(), percona.db(), mysql_cluster.db()):
    db.setup(test, "n1")
    db.teardown(test, "n1")
assert not asked, asked
print("ok")
"""


def test_driver_imports_stay_lazy():
    """Building every test map of the new suites and running the SQL
    DBs' commands on the dummy remote asks for no driver module."""
    out = subprocess.run([sys.executable, "-c",
                          _LAZY.format(repo=str(REPO))], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# a short cockroach register run through the port's core.run
# ---------------------------------------------------------------------------


def _to_ref(history):
    """The port's stored events as the JAX package's, ``[k v]`` values
    lifted back to its tuples."""
    out = []
    for op in history:
        v = op.value
        if isinstance(op.process, int):
            kv = chip_smoke.stored_kv(v)
            v = jind.tuple_(kv.key, kv.value)
        out.append(jh.Op(process=op.process, type=op.type, f=op.f, value=v,
                         time=op.time, index=op.index, error=op.error))
    return out


def _standins(stale):
    """Two stand-ins (:func:`chip_smoke.pg_standins`) on 127.0.0.1 and
    127.0.0.2 at one drawn port."""
    return _draw_port(lambda port: chip_smoke.pg_standins(
        [("127.0.0.1", port), ("127.0.0.2", port)], stale_last=stale,
        latency=0.002))


@pytest.mark.parametrize("stale", [False, True])
def test_cockroach_register_run_checked_by_reference(stale, tmp_path):
    import jepsen_tpu.checker.linearizable as jlin
    from jepsen_tpu import models as jm
    from jepsen_tpu_torch import core, db as tdb, store as tstore
    from jepsen_tpu_torch.suites import cockroach

    servers, port = _standins(stale)
    random.seed(f"cockroach-{stale}")
    try:
        test = cockroach.REGISTRY.build_test({
            "workload": "register", "nemesis": "none",
            "nodes": ["127.0.0.1", "127.0.0.2"], "concurrency": 4,
            "time_limit": 2, "ops_per_key": 12, "sql_port": port,
            "device": "cpu", "store_base": str(tmp_path / "store")})
        test["db"] = tdb.noop  # its commands: the dummy-remote cases
        test["remote"] = tcontrol.DummyRemote()
        out = core.run(test)
    finally:
        chip_smoke.stop_gateways(servers)
    keys = out["results"]["results"]
    invalid = {k for k, r in keys.items() if r["linear"]["valid"] is False}
    assert len(keys) >= 2 and bool(invalid) is stale
    assert out["results"]["valid"] is (not stale)
    run = tstore.latest(str(tmp_path / "store"))
    want = jind.checker(jlin.linearizable(jm.cas_register())).check(
        {"name": None, "store_base": str(tmp_path / "ref")},
        _to_ref(run["history"]))
    assert {str(k): r["valid"] for k, r in want["results"].items()} == \
        {str(k): r["linear"]["valid"] for k, r in keys.items()}


def test_standins_serialize_transactions_and_delay_after_the_lock():
    """A reply is delayed only once its connection holds no transaction:
    a second connection's transaction runs while the first's COMMIT
    reply waits."""
    servers, port = _draw_port(lambda port: chip_smoke.pg_standins(
        [("127.0.0.1", port)], latency=0.3))
    from jepsen_tpu_torch.suites import pgwire

    try:
        engine = servers[0].engine
        a = pgwire.connect("127.0.0.1", port)
        b = pgwire.connect("127.0.0.1", port)
        with a:
            with a.cursor() as cur:
                cur.execute("UPSERT INTO registers (id, value) "
                            "VALUES (1, 1)")
        t0 = time.perf_counter()
        with b.cursor() as cur:  # BEGIN and the read reply at once
            cur.execute("SELECT value FROM registers WHERE id=1")
            assert cur.fetchone() == (1,)
            held = time.perf_counter() - t0
            assert engine._txn_owner is not None
        b.commit()
        assert engine._txn_owner is None and held < 0.25
        a.close()
        b.close()
    finally:
        chip_smoke.stop_gateways(servers)


def test_stale_standin_reads_one_committed_write_behind():
    servers, port = _draw_port(lambda port: chip_smoke.pg_standins(
        [("127.0.0.1", port), ("127.0.0.2", port)], stale_last=True,
        latency=0))
    from jepsen_tpu_torch.suites import cockroach

    t = {"sql_port": port}
    kv = tind.tuple_
    try:
        sound = cockroach.RegisterClient().open(t, "127.0.0.1")
        stale = cockroach.RegisterClient().open(t, "127.0.0.2")
        reads = []
        for f, v in (("write", 1), ("write", 2), ("cas", (2, 3)),
                     ("cas", (9, 4))):
            sound.invoke(t, th.invoke_op(0, f, kv(5, v)))
            reads.append(tuple(c.invoke(t, th.invoke_op(0, "read", kv(5, None)))
                               .value.value for c in (sound, stale)))
        sound.close(t)
        stale.close(t)
    finally:
        chip_smoke.stop_gateways(servers)
    assert reads == [(1, None), (2, 1), (3, 2), (3, 2)]


# ---------------------------------------------------------------------------
# suites/__init__.py
# ---------------------------------------------------------------------------


def test_suites_equal_reference_with_the_same_public_names():
    from jepsen_tpu import suites as jsuites
    from jepsen_tpu_torch import suites as tsuites

    assert tsuites.SUITES == jsuites.SUITES and len(tsuites.SUITES) == 26
    for name in tsuites.SUITES:
        jmod, tmod = jsuites.suite(name), tsuites.suite(name)
        pub = [sorted(n for n, v in vars(m).items()
                      if not n.startswith("_")
                      and not isinstance(v, types.ModuleType))
               for m in (jmod, tmod)]
        assert pub[1] == pub[0], name
