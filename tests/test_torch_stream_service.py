"""The port's stream service (``jepsen_tpu_torch/stream/service.py`` and
``python -m jepsen_tpu_torch.stream``) against the JAX package's: the
same protocol lines through both, in process, must give the same reply
lines (multiplexed runs, the bare-op shorthand and its EOF finalize,
op-budget shedding, the protocol drain).  Then the port alone: the
bounded ingest queue sheds, the ``/metrics`` and ``/api/stats`` scrape
on the protocol port, the TCP drain, the stdin service as a process,
and its SIGTERM drain under ``--listen``."""

import io
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.decompose.cache import VerdictCache as JCache
from jepsen_tpu.stream.service import StreamService as JService
from jepsen_tpu.stream.service import serve_stdio as j_serve_stdio
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.stream import service as tsvc
from test_torch_search import reference_defaults

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    reference_defaults(monkeypatch)


def _header(run, model="register"):
    return json.dumps({"run": run, "model": model, "init": 0})


def _op(run, process, typ, f, value):
    return json.dumps({"run": run, "op": {"process": process, "type": typ,
                                          "f": f, "value": value}})


def _ok_pair(run, process, f, value):
    return [_op(run, process, "invoke", f, value),
            _op(run, process, "ok", f, value)]


def _replies(make_service, lines, *, stdio):
    """Reply dicts of one service fed ``lines``: through ``serve_stdio``
    (EOF finalizes every open run), or line by line."""
    svc, serve = make_service()
    if stdio:
        out = io.StringIO()
        serve(svc, iter(ln + "\n" for ln in lines), out)
        return [json.loads(x) for x in out.getvalue().splitlines()]
    replies = []
    for ln in lines:
        svc.handle_line(ln, replies.append)
    return replies


def _both(lines, *, stdio=True, **kw):
    """The JAX package's replies and the port's on the same lines."""
    jkw = {k: (jm.cas_register() if k == "model" else v)
           for k, v in kw.items()}
    tkw = {k: (tm.cas_register() if k == "model" else v)
           for k, v in kw.items()}
    j = _replies(lambda: (JService(**jkw), j_serve_stdio), lines,
                 stdio=stdio)
    p = _replies(lambda: (tsvc.StreamService(device="cpu", **tkw),
                          tsvc.serve_stdio), lines, stdio=stdio)
    return j, p


def _two_runs():
    """Two interleaved cas-register runs, one valid and one invalid."""
    rng = random.Random(1)
    h_ok = js.sim_register_history(rng, n_procs=3, n_ops=14)
    h_bad = js.flip_read(rng, js.sim_register_history(rng, n_procs=3,
                                                      n_ops=14))
    rng = random.Random(1)
    assert [o.to_dict() for o in ts.sim_register_history(
        rng, n_procs=3, n_ops=14)] == [o.to_dict() for o in h_ok]
    lines = [_header("a", "cas-register"), _header("b", "cas-register")]
    for i in range(max(len(h_ok), len(h_bad))):
        if i < len(h_ok):
            lines.append(json.dumps({"run": "a", "op": h_ok[i].to_dict()}))
        if i < len(h_bad):
            lines.append(json.dumps({"run": "b", "op": h_bad[i].to_dict()}))
    return lines


def test_multiplexed_runs_match_reference():
    lines = _two_runs() + [json.dumps({"run": "a", "end": True}),
                           json.dumps({"run": "b", "end": True})]
    j, p = _both(lines, audit=True)
    assert p == j
    finals = {d["run"]: d["final"] for d in p if "final" in d}
    assert finals["a"]["valid"] is True and finals["b"]["valid"] is False
    assert all(f["audit"]["ok"] for f in finals.values())
    assert [d for d in p if "live" in d]
    assert not [d for d in p if "error" in d]


def test_bare_ops_and_eof_finalize_match_reference():
    rng = random.Random(2)
    h = ts.sim_register_history(rng, n_procs=3, n_ops=12)
    lines = [json.dumps(op.to_dict()) for op in h]
    j, p = _both(lines, model="cas")
    assert p == j
    finals = [d for d in p if "final" in d]
    assert len(finals) == 1 and finals[0]["run"] == "default"


def test_malformed_lines_match_reference():
    lines = ["not json", "[1, 2]", json.dumps({"run": "x"}),
             json.dumps({"run": "y", "end": True}),
             _op("z", 0, "invoke", "write", 1)]
    j, p = _both(lines, stdio=False)
    assert p == j
    assert all("error" in d for d in p) and len(p) == len(lines)


def test_op_budget_shedding_matches_reference():
    lines = [_header("a"), _header("b")]
    for i in range(8):
        for run in ("a", "b"):
            lines += _ok_pair(run, 0, "write", i % 3)
    j, p = _both(lines, op_budget=6)
    assert p == j
    over = [d for d in p if d.get("overloaded") == "op-budget"]
    assert {d["run"] for d in over} == {"a", "b"}
    finals = [d["final"] for d in p if "final" in d]
    assert [f["shed"] for f in finals] == [10, 10]


def test_protocol_drain_matches_reference():
    lines = [_header("a")] + _ok_pair("a", 0, "write", 1) + [
        json.dumps({"drain": True}), _header("b"),
        _op("c", 0, "invoke", "write", 1), json.dumps({"drain": True})]
    j, p = _both(lines, stdio=False, model="cas")
    assert p == j
    finals = [d for d in p if "final" in d]
    assert len(finals) == 1 and finals[0]["final"]["finalized_by"] == "drain"
    assert [d["overloaded"] for d in p if d.get("overloaded")] == \
        ["draining", "draining"]


def test_bounded_ingest_queue_sheds():
    """A checker slowed to 10 ms a line behind a 2-line queue: the
    flood is shed with ``overloaded`` replies and EOF finalizes what
    was admitted."""
    svc = tsvc.StreamService(model=tm.register(0), device="cpu")
    real = svc.handle_line

    def slow(line, emit):
        time.sleep(0.01)
        real(line, emit)

    svc.handle_line = slow
    lines = [_header("r1")]
    for i in range(100):
        lines += _ok_pair("r1", 0, "write", i % 3)
    replies = []
    shed = tsvc.serve_lines(svc, iter(lines), replies.append, ingest_max=2)
    assert shed > 0
    over = [r for r in replies if r.get("overloaded") == "ingest-queue"]
    assert over and over[0]["queue"] == 2
    assert len([r for r in replies if "final" in r]) == 1


def test_service_passes_device_and_budget_to_its_runs():
    svc = tsvc.StreamService(model=tm.register(0), device="cpu",
                             device_budget=7, host_fold_max=0)
    svc.handle_line(_header("r"), lambda d: None)
    chk = svc._runs["r"]
    assert (str(chk.device), chk.device_budget, chk.host_fold_max) == \
        ("cpu", 7, 0)


def test_device_route_error_is_not_an_error_reply(monkeypatch):
    """A device-routed fold that raises propagates out of the service;
    it is not answered as one bad line."""
    from jepsen_tpu_torch.checker import linearizable as tlin
    from jepsen_tpu_torch.stream.device import DeviceFoldError

    def boom(*a, **kw):
        raise RuntimeError("injected search_batch failure")

    monkeypatch.setattr(tlin, "search_batch", boom)
    svc = tsvc.StreamService(model=tm.register(0), device="cpu",
                             host_fold_max=0)
    h = ts.register_history(random.Random(6), n_ops=40, n_procs=5,
                            overlap=4, quiesce_every=8, n_values=6,
                            cas=False)
    replies = []
    with pytest.raises(DeviceFoldError):
        for op in h:
            svc.handle_line(json.dumps(op.to_dict()), replies.append)
    assert not [r for r in replies if "error" in r]


def test_device_error_in_one_run_still_finalizes_the_others(monkeypatch):
    """End of stream after one run's device fold failed: every other
    open run still gets its final, then the device error is raised."""
    from jepsen_tpu_torch.checker import linearizable as tlin
    from jepsen_tpu_torch.stream.device import DeviceFoldError

    failing = []
    real = tlin.search_batch

    def flaky(*a, **kw):
        if failing:
            raise RuntimeError("injected search_batch failure")
        return real(*a, **kw)

    monkeypatch.setattr(tlin, "search_batch", flaky)
    svc = tsvc.StreamService(model=tm.register(0), device="cpu",
                             host_fold_max=0)
    h = ts.register_history(random.Random(6), n_ops=40, n_procs=5,
                            overlap=4, quiesce_every=8, n_values=6,
                            cas=False)
    replies = []
    for run in ("bad", "good"):  # the failing run is finalized first
        svc.handle_line(_header(run), replies.append)
    for op in h:
        svc.handle_line(json.dumps({"run": "good", "op": op.to_dict()}),
                        replies.append)
    failing.append(True)
    with pytest.raises(DeviceFoldError):
        for op in h:
            svc.handle_line(json.dumps({"run": "bad", "op": op.to_dict()}),
                            replies.append)
    failing.clear()
    with pytest.raises(DeviceFoldError):
        svc.end_all(replies.append)
    finals = {r["run"]: r["final"] for r in replies if "final" in r}
    assert list(finals) == ["good"] and finals["good"]["valid"] is True
    assert not svc._runs


#: a line the service answers with an error: once its reply arrives,
#: every line sent before it has been ingested (lines run in order)
_PROBE = json.dumps({"run": "probe"})


def _serve(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t


def _http_get(port, target):
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(f"GET {target} HTTP/1.0\r\nHost: x\r\n\r\n".encode())
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    return head.decode(), body.decode()


def test_metrics_scrape_on_the_protocol_port():
    srv = tsvc.make_server("127.0.0.1", 0, model=tm.register(0),
                           device="cpu")
    t = _serve(srv)
    try:
        port = srv.server_address[1]
        head, body = _http_get(port, "/metrics")
        assert head.startswith("HTTP/1.0 200")
        for name in ("jtpu_stream_ops_ingested_total",
                     "jtpu_stream_segments_folded_total",
                     "jtpu_constraint_fold_events_total",
                     "jtpu_stream_runs_open", "jtpu_fold_seconds"):
            assert name in body, name
        head, body = _http_get(port, "/api/stats")
        assert "application/json" in head
        assert "jtpu_stream_ops_ingested_total" in json.loads(body)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_drain_server_finalizes_on_the_connection():
    srv = tsvc.make_server("127.0.0.1", 0, model=tm.register(0),
                           device="cpu")
    t = _serve(srv)
    s = socket.create_connection(("127.0.0.1", srv.server_address[1]))
    w, r = s.makefile("w"), s.makefile("r")
    w.write(_header("tcp-run") + "\n")
    for li in _ok_pair("tcp-run", 0, "write", 1):
        w.write(li + "\n")
    w.write(_PROBE + "\n")
    w.flush()
    s.settimeout(10)
    assert "error" in json.loads(r.readline())  # every line above is in
    assert tsvc.drain_server(srv) == 1
    reply = json.loads(r.readline())
    assert reply["run"] == "tcp-run"
    assert reply["final"]["valid"] is True
    assert reply["final"]["finalized_by"] == "drain"
    t.join(timeout=10)
    assert not t.is_alive()
    s.close()
    srv.server_close()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_stdin_service_process_matches_reference():
    """``python -m jepsen_tpu_torch.stream --device cpu --audit`` over
    stdin answers the JAX package's in-process reply lines."""
    lines = _two_runs() + [json.dumps({"run": "a", "end": True}),
                           json.dumps({"run": "b", "end": True})]
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.stream", "--device",
         "cpu", "--audit"], input="\n".join(lines) + "\n",
        capture_output=True, text=True, env=_env(), cwd=str(REPO),
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = [json.loads(x) for x in out.stdout.splitlines()]
    # the process's default cache: one in memory
    want = _replies(lambda: (JService(audit=True, cache=JCache()),
                             j_serve_stdio), lines, stdio=True)
    assert got == want


def test_sigterm_drains_and_exits_zero():
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.stream", "--device", "cpu",
         "--listen", "127.0.0.1:0"], stderr=subprocess.PIPE,
        stdout=subprocess.DEVNULL, text=True, env=_env(), cwd=str(REPO))
    try:
        line = proc.stderr.readline()
        assert "listening on" in line, line
        port = int(line.rsplit(":", 1)[1])
        s = socket.create_connection(("127.0.0.1", port))
        w, r = s.makefile("w"), s.makefile("r")
        w.write(_header("sig-run") + "\n")
        for li in _ok_pair("sig-run", 0, "write", 3):
            w.write(li + "\n")
        w.write(_PROBE + "\n")
        w.flush()
        s.settimeout(30)
        assert "error" in json.loads(r.readline())
        proc.send_signal(signal.SIGTERM)
        reply = json.loads(r.readline())
        assert reply["run"] == "sig-run"
        assert reply["final"]["valid"] is True
        assert reply["final"]["finalized_by"] == "drain"
        s.close()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
