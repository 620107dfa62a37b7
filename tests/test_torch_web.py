"""The port's results web server (``jepsen_tpu_torch.web``) against the
JAX package's: both servers run on one store directory, and every route
answers with the same status, content type and body.  ``/mc`` runs with
each package's ``modelcheck.run_mc_sweep`` stubbed; ``/metrics`` and
``/api/stats`` serve each process's own registry, so there the series
and keys are compared, not the values.  Then the JAX package's own web
cases (``tests/test_cli_web.py``, ``tests/test_stream.py``,
``tests/test_audit.py``, ``tests/test_obs.py``) on the port's server."""

import http.client
import io
import json
import os
import random
import threading
import urllib.error
import urllib.request
import zipfile

import pytest

from jepsen_tpu import store as jstore
from jepsen_tpu import web as jweb
# each package declares some series where a module is imported: load
# those modules on both sides, so both registries name the same series
from jepsen_tpu.analyze import constraints as _jcons  # noqa: F401
from jepsen_tpu.analyze import modelcheck as jmc
from jepsen_tpu.analyze.plan import explain as jexplain
from jepsen_tpu.history import encode_ops as jencode
from jepsen_tpu.models import cas_register as jcas
from jepsen_tpu.synth import sim_register_history
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import web as tweb
from jepsen_tpu_torch.analyze import modelcheck as tmc
from jepsen_tpu_torch.checker import bucket as _tbucket  # noqa: F401
from jepsen_tpu_torch.obs import telemetry as ttele

RUN = ("demo", "20260729T120000")
TELEMETRY = {
    "levels": 3, "slices": 1, "max_occupancy": 9, "expanded": 40,
    "mask_killed": 10, "dedup_folds": 2, "crash_rounds": 4,
    "overflows": 0, "goals": 1, "observed_prune_ratio": 0.769231,
    "truncated": False, "predicted_prune_ratio": 1.0,
    "prune_ratio_delta": -0.230769,
    "per_level": [[3, 12, 4, 0, 1, 6, 0, 0], [6, 18, 4, 1, 2, 9, 0, 0],
                  [9, 10, 2, 1, 1, 0, 0, 1]],
    "per_level_columns": ["occupancy", "expanded", "mask_killed",
                          "dedup_folds", "crash_rounds", "next_count",
                          "overflow", "goal"]}
SWEEP = {"ok": True, "runs": [
    {"family": "lock", "mode": "clean", "ok": True, "violations": [],
     "explored": {"states": 42, "schedules": 7, "events": 99,
                  "sleep_prunes": 3, "dedup": 1, "prune_ratio": 0.03,
                  "complete": True}},
    {"family": "lock", "mode": "volatile", "ok": False, "violations": [{
        "code": "MC106", "detail": "double grant",
        "schedule": [["op", 0], ["crash", 0], ["restart", 0], ["op", 1]],
        "shrunk": {"n_from": 6, "n_to": 4, "checks": 9, "minimal": True},
        "replayed": True,
        "confirm": {"route": "engine", "engine_valid": False,
                    "audit_ok": True, "audit_checked": 1}}],
     "explored": {"states": 50, "schedules": 9, "events": 120,
                  "sleep_prunes": 12, "dedup": 2, "prune_ratio": 0.09,
                  "complete": True}},
    {"family": "shell-kv", "mode": "clean", "ok": True, "violations": [],
     "explored": {"states": 7, "schedules": 2, "events": 9,
                  "sleep_prunes": 0, "dedup": 0, "prune_ratio": 0.0,
                  "complete": True}}]}


def _results() -> dict:
    """A composed keyed result carrying every panel the pages render."""
    h = sim_register_history(random.Random(3), n_procs=3, n_ops=20)
    plan = jexplain(jencode(h, jcas().f_codes), jcas())
    linear = {
        "valid": False, "engine": "device-bfs(cuda)+host-witness",
        "configs": 123, "final_ops": [1, 2], "explain": plan,
        "audit": {"ok": True, "checked": "final_ops", "codes": []},
        "shrink": {"n_from": 16, "n_to": 3, "rows": [0, 1, 2], "checks": 9,
                   "minimal": True, "brute_force": False,
                   "ops": [{"process": 0, "f": "write", "value": 1}]},
        "hb": {"applies": True, "decided": None, "must_edges": 4,
               "edges": 9},
        "constraints": {"applies": True, "family": "register",
                        "decided": False, "reason": "cycle"},
        "dpor": {"enabled": True, "sleep_prunes": 3, "dedup_rewrites": 2,
                 "dedup_hits": 1, "mask_lanes_killed": 5,
                 "device_masked": True, "device_mask_rows": 7},
        "search_telemetry": TELEMETRY,
        "hb_cycle": [{"src": 1}, {"src": 2}],
        "queue_cycle": [{"src": 3, "kind": "fifo"}],
        "queue_dup": {"dequeues": [1, 2], "enqueues": [0]},
        "queue_evidence": {"kind": "lost", "values": [4], "rows": [9]},
        "shard_batch": {"n_buckets": 2, "n_devices": 4,
                        "padding_efficiency": 0.5,
                        "fused_padding_efficiency": 0.25, "pad_keys": 1,
                        "overflow_redo": 1, "shard_map": False}}
    return {
        "valid": False,
        "workload": {"valid": False, "results": {
            "0": {"valid": True, "linear": {
                "valid": True, "engine": "greedy-witness", "configs": 20,
                "linearization": list(range(20))}},
            "1": {"valid": False, "linear": linear}}, "failures": [1]},
        "decompose": {"cache_hits": 2, "cache_misses": 1,
                      "cache_inserts": 3},
        "stream": {"valid": False, "engine": "stream(quiescence)",
                   "stream": {"segments": 3, "events": 40,
                              "first_verdict_event": 4, "cache_hits": 2,
                              "cache_misses": 1, "cache_inserts": 3}}}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """One store: a rich run with live.json and trace.json, a valid and an
    unknown run, a directory without results, two campaigns."""
    b = str(tmp_path_factory.mktemp("web") / "store")
    for (name, t), res in (
            (RUN, _results()),
            (("webdemo", "20260729T110000"), {"valid": True}),
            (("webdemo", "20260729T100000"), {"valid": "unknown"})):
        test = {"name": name, "start_time": t, "store_base": b}
        jstore.save_1(test, [])
        jstore.save_2(test, res)
    d = os.path.join(b, *RUN)
    with open(os.path.join(d, "live.json"), "w") as f:
        json.dump({"status": "invalid", "events": 40, "rows": 20,
                   "segments_closed": 3, "checked_rows": 12,
                   "final": {"valid": False}}, f)
    with open(os.path.join(d, "trace.json"), "w") as f:
        json.dump({"traceEvents": [
            {"ph": "M", "name": "thread_name", "tid": 1,
             "args": {"name": "main"}},
            {"ph": "X", "name": "run", "cat": "run", "ts": 0, "dur": 10,
             "tid": 1}]}, f)
    os.makedirs(os.path.join(d, "sub"))
    with open(os.path.join(d, "sub", "note.txt"), "w") as f:
        f.write("hello")
    with open(os.path.join(d, "plot.png"), "wb") as f:
        f.write(b"\x89PNG\r\n")
    os.makedirs(os.path.join(b, "empty"))
    for cid, cells in (
            ("20260801T000000", [
                {"family": "kv", "nemesis": "kill-restart", "status": "ok",
                 "valid": True, "store": "store/kv/20260801T000001",
                 "phases": {"setup": 1.2, "workload": 8.0},
                 "detection": {"latency_s": 0.5, "at": "streamed"}},
                {"family": "lock", "nemesis": "kill-restart",
                 "status": "ok", "valid": False, "seeded": True,
                 "attempts": 2, "watchdog": {"fired": True},
                 "detection": {"at": "finalize", "source": "post-hoc"}},
                {"family": "kv", "nemesis": "partition",
                 "status": "skipped", "reason": "needs <root>"}]),
            ("20260802T000000", [])):
        cd = os.path.join(b, "campaigns", cid)
        os.makedirs(cd)
        with open(os.path.join(cd, "campaign.json"), "w") as f:
            json.dump({"cells": cells, "summary": {
                "ok": 2, "skipped": 1, "failed": 0, "detected": 1,
                "streamed_detections": 1, "audited_ok": 1}}, f)
    os.makedirs(os.path.join(b, "campaigns", "broken"))
    return b


@pytest.fixture(scope="module")
def servers(base):
    """(reference port, port's port) of both servers on ``base``, the
    model-checker sweep stubbed in each package."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmc, "run_mc_sweep", lambda *a, **kw: SWEEP)
        mp.setattr(tmc, "run_mc_sweep", lambda *a, **kw: SWEEP)
        mp.setattr(jweb, "_MC_CACHE", None)
        mp.setattr(tweb, "_MC_CACHE", None)
        srvs = [jweb.make_server("127.0.0.1", 0, base),
                tweb.make_server("127.0.0.1", 0, base)]
        for s in srvs:
            threading.Thread(target=s.serve_forever, daemon=True).start()
        try:
            yield tuple(s.server_address[1] for s in srvs)
        finally:
            for s in srvs:
                s.shutdown()
                s.server_close()


def _get(port, path):
    """(status, content type, body) of a raw GET (no client-side
    normalisation of ``..``)."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


RUN_REL = "/".join(RUN)
ROUTES = [
    "/", "/campaigns", "/campaigns/", "/campaigns/20260801T000000",
    "/campaigns/20260802T000000", "/campaigns/broken",
    "/campaigns/nosuch", "/campaigns/../etc", "/campaigns/a/b",
    "/mc", "/mc/", "/mc?scope=shell", "/mc?scope=bogus",
    "/mc?scope=core&refresh=1",
    f"/api/live/{RUN_REL}", "/api/live/webdemo/20260729T110000",
    "/api/live/../../etc", "/api/live/nosuch/run",
    f"/files/{RUN_REL}/", f"/files/{RUN_REL}", f"/files/{RUN_REL}/sub/",
    f"/files/{RUN_REL}/results.json", f"/files/{RUN_REL}/live.json",
    f"/files/{RUN_REL}/history.jsonl", f"/files/{RUN_REL}/plot.png",
    f"/files/{RUN_REL}/sub/note.txt", f"/files/{RUN_REL}/trace.json",
    "/files/webdemo/20260729T110000/", "/files/webdemo/20260729T100000/",
    "/files/webdemo/", "/files/", "/files/empty/", "/files/nosuch",
    "/files/../../etc/passwd", "/files/demo/../../../etc/passwd",
    "/files/empty/?zip", "/nope", "/files%2F..%2Fx",
]


@pytest.mark.parametrize("path", ROUTES)
def test_route_answers_as_the_reference(servers, path):
    jport, tport = servers
    want = _get(jport, path)
    got = _get(tport, path)
    assert got == want


def test_mc_cache_is_kept_per_scope(servers):
    jport, tport = servers
    for port in servers:
        _get(port, "/mc")
        _get(port, "/mc?scope=shell")
    assert set(tweb._MC_CACHE) == set(jweb._MC_CACHE) == {"core", "shell"}


@pytest.mark.parametrize("rel", [RUN_REL, "webdemo/20260729T110000",
                                 "empty"])
def test_zip_lists_the_same_members(servers, rel):
    jport, tport = servers
    zips = []
    for port in (jport, tport):
        status, ctype, body = _get(port, f"/files/{rel}/?zip")
        assert status == 200 and ctype == "application/zip"
        assert body[:2] == b"PK"
        z = zipfile.ZipFile(io.BytesIO(body))
        zips.append({n: z.read(n) for n in z.namelist()})
    assert zips[1] == zips[0] and list(zips[1]) == list(zips[0])


def test_metrics_and_stats_name_the_same_series(servers):
    jport, tport = servers
    pages = [_get(p, "/metrics") for p in servers]
    assert pages[0][:2] == pages[1][:2] == (
        200, "text/plain; version=0.0.4; charset=utf-8")
    types = [{ln for ln in b.decode().splitlines()
              if ln.startswith(("# TYPE", "# HELP"))} for _, _, b in pages]
    assert types[1] == types[0]
    stats = [_get(p, "/api/stats") for p in servers]
    assert stats[0][:2] == stats[1][:2] == (200, "application/json")
    js_, ts_ = (json.loads(b) for _, _, b in stats)
    assert set(ts_) == set(js_)
    assert set(ts_["derived"]) == set(js_["derived"])


def test_page_functions_equal_the_reference(base, monkeypatch):
    """The page builders called directly: the same HTML."""
    res = _results()
    sub = res["workload"]["results"]["1"]["linear"]
    assert tweb.result_block(sub) == jweb.result_block(sub)
    assert tweb.result_block(res) == jweb.result_block(res)
    assert tweb._evidence_results(res) == jweb._evidence_results(res)
    assert tweb._occupancy_sparkline(TELEMETRY) == \
        jweb._occupancy_sparkline(TELEMETRY)
    long = dict(TELEMETRY, per_level=[[i % 17] + [0] * 7
                                      for i in range(200)])
    assert tweb._occupancy_sparkline(long) == \
        jweb._occupancy_sparkline(long)
    assert tweb.home_html(base) == jweb.home_html(base)
    assert tweb.campaigns_html(base) == jweb.campaigns_html(base)
    for cid in ("20260801T000000", "nosuch"):
        assert tweb.campaign_html(base, cid) == jweb.campaign_html(base, cid)
    assert tweb.dir_html(base, RUN_REL) == jweb.dir_html(base, RUN_REL)
    assert tweb.live_panel(RUN_REL) == jweb.live_panel(RUN_REL)
    assert tweb.trace_panel(RUN_REL) == jweb.trace_panel(RUN_REL)
    monkeypatch.setattr(jmc, "run_mc_sweep", lambda *a, **kw: SWEEP)
    monkeypatch.setattr(tmc, "run_mc_sweep", lambda *a, **kw: SWEEP)
    monkeypatch.setattr(jweb, "_MC_CACHE", SWEEP)  # an older caller's shape
    monkeypatch.setattr(tweb, "_MC_CACHE", SWEEP)
    for scope in ("core", "shell"):
        assert tweb.mc_html(scope=scope) == jweb.mc_html(scope=scope)
    out = [io.BytesIO(), io.BytesIO()]
    jweb.write_zip(out[0], base, RUN_REL, chunk=3)
    tweb.write_zip(out[1], base, RUN_REL, chunk=3)
    names = [zipfile.ZipFile(b).namelist() for b in out]
    assert names[1] == names[0]
    assert tweb.CONTENT_TYPES == jweb.CONTENT_TYPES
    assert tweb.STYLE == jweb.STYLE


# ---------------------------------------------------------------------------
# the JAX package's web cases on the port's server
# ---------------------------------------------------------------------------


def _serve(base):
    srv = tweb.make_server(host="127.0.0.1", port=0, base=base)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def test_web_serves_store(tmp_path):
    """``tests/test_cli_web.py::test_web_serves_store``."""
    base = str(tmp_path / "store")
    test = {"name": "webdemo", "start_time": "20260729T120000",
            "store_base": base}
    tstore.save_1(test, [])
    tstore.save_2(test, {"valid": True})
    srv, port = _serve(base)
    try:
        home = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/").read().decode()
        assert "webdemo" in home and "valid-true" in home
        d = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/files/webdemo/20260729T120000/"
        ).read().decode()
        assert "results.json" in d
        r = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/files/webdemo/20260729T120000/"
            f"results.json").read()
        assert json.loads(r)["valid"] is True
        z = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/files/webdemo/20260729T120000/?zip"
        ).read()
        assert z[:2] == b"PK"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/files/../../etc/passwd")
    finally:
        srv.shutdown()


def test_api_stats_derived_device_gauges(tmp_path):
    """``tests/test_cli_web.py::test_api_stats_derived_device_gauges``:
    the port's registry after one device second."""
    ttele.record_device_seconds(0.01)
    base = str(tmp_path / "store")
    os.makedirs(os.path.join(base, "campaigns"), exist_ok=True)
    srv, port = _serve(base)
    try:
        s = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/stats").read())
        d = s["derived"]
        assert 0.0 <= d["device_idle_fraction"] <= 1.0
        assert "observed_prune_ratio" in d
        s2 = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/stats").read())
        assert s2["jtpu_device_seconds_total"]["values"] > 0
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/campaigns").read().decode()
        assert "device idle" in page and "observed prune" in page
    finally:
        srv.shutdown()


def test_web_mc_panel(tmp_path, monkeypatch):
    """``tests/test_cli_web.py::test_web_mc_panel``."""
    monkeypatch.setattr(tmc, "run_mc_sweep", lambda *a: SWEEP)
    monkeypatch.setattr(tweb, "_MC_CACHE", None)
    page = tweb.mc_html()
    assert "MC106" in page and "caught MC106" in page
    assert "as expected" in page and "UNEXPECTED" not in page
    assert "op(0) → crash(0) → restart(0) → op(1)" in page
    assert "engine valid=False" in page and "audit ok=True" in page
    srv, port = _serve(str(tmp_path))
    try:
        home = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/").read().decode()
        assert '<a href="/mc">' in home
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/mc").read().decode()
        assert "Bounded model checker" in page
    finally:
        srv.shutdown()


def test_live_verdict_endpoint_and_panel(tmp_path):
    """``tests/test_stream.py``'s web case: ``/api/live`` serves the
    stream's snapshot, the run page polls it and shows the stream and
    verdict-cache rows."""
    base = str(tmp_path / "store")
    test = {"name": "livedemo", "start_time": "20260803T120000",
            "store_base": base}
    tstore.save_1(test, [])
    tstore.save_2(test, {
        "valid": True,
        "stream": {"valid": True, "engine": "stream(quiescence)",
                   "stream": {"segments": 3, "events": 40,
                              "first_verdict_event": 4, "cache_hits": 2,
                              "cache_misses": 1, "cache_inserts": 3}}})
    d = os.path.join(base, "livedemo", "20260803T120000")
    with open(os.path.join(d, "live.json"), "w") as f:
        json.dump({"status": "valid-so-far", "events": 40, "rows": 20,
                   "segments_closed": 3, "checked_rows": 12}, f)
    srv, port = _serve(base)
    try:
        api = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/live/livedemo/20260803T120000"
        ).read())
        assert api["status"] == "valid-so-far"
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/files/livedemo/20260803T120000/"
        ).read().decode()
        assert "Live verdict" in page and "streamed" in page
        assert "verdict cache" in page
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/live/nosuch/run")
    finally:
        srv.shutdown()


def test_result_page_shows_plan_audit_and_shrink(tmp_path):
    """``tests/test_audit.py``'s web case on the port's ``dir_html``."""
    from jepsen_tpu_torch.analyze.plan import explain
    from jepsen_tpu_torch.history import encode_ops
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.synth import sim_register_history as tsim

    m = cas_register()
    h = tsim(random.Random(3), n_procs=3, n_ops=16)
    run = tmp_path / "t" / "20260803T000000"
    run.mkdir(parents=True)
    result = {
        "valid": False, "engine": "host-oracle", "configs": 123,
        "final_ops": [1, 2], "explain": explain(encode_ops(h, m.f_codes), m,
                                                device="cpu"),
        "audit": {"ok": True, "checked": "final_ops", "codes": []},
        "shrink": {"n_from": 16, "n_to": 3, "rows": [0, 1, 2],
                   "checks": 9, "minimal": True, "brute_force": False,
                   "ops": [{"process": 0, "f": "write", "value": 1}]}}
    with open(run / "results.json", "w") as f:
        json.dump(result, f)
    page = tweb.dir_html(str(tmp_path), "t/20260803T000000")
    assert "Search plan" in page and "SearchDims" in page
    assert "audit" in page and "final_ops" in page
    assert "Minimal failing subhistory" in page
    assert "blocking frontier" in page
    (tmp_path / "t2").mkdir()
    assert "Search plan" not in tweb.dir_html(str(tmp_path), "t2")


def test_metrics_and_stats_endpoints(tmp_path):
    """``tests/test_obs.py``'s endpoint case on the port's server."""
    srv, port = _serve(str(tmp_path))
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
            assert r.status == 200
            assert "text/plain" in r.headers["Content-Type"]
            text = r.read().decode()
        assert "# TYPE jtpu_verdict_cache_total counter" in text
        assert "# TYPE jtpu_stream_runs_open gauge" in text
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/stats") as r:
            assert r.headers["Content-Type"] == "application/json"
            s = json.loads(r.read())
        assert "derived" in s and "jtpu_stream_runs_open" in s
    finally:
        srv.shutdown()


def test_campaign_grid_shows_phase_tooltips(tmp_path):
    """``tests/test_obs.py::test_campaign_grid_shows_phase_tooltips``."""
    d = tmp_path / "campaigns" / "c1"
    os.makedirs(d)
    with open(d / "campaign.json", "w") as f:
        json.dump({"cells": [{
            "family": "kv", "nemesis": "kill-restart", "status": "ok",
            "valid": True, "phases": {"setup": 1.2, "workload": 8.0,
                                      "nemesis": 0.4, "check": 0.6}}],
            "summary": {"ok": 1}}, f)
    page = tweb.campaign_html(str(tmp_path), "c1")
    assert 'title="setup 1.2s' in page and "nemesis 0.4s" in page
    assert "/api/stats" in tweb.campaigns_html(str(tmp_path))
