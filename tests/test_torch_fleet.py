"""The port's fleet tier (``jepsen_tpu_torch/fleet/``) against the JAX
package's, on the CPU.

Held with exact equality: the rendezvous routing (1000 seeded run ids,
and again after a worker joins and after one leaves), the shared
verdict-cache store (a root written by either package's workers read by
the other's; spill, refresh and compact leave equal entries), the
admission decisions over a grid of signals, the scale signal and the
metric merges, and the finals of runs routed through two port workers
(``device="cpu"``, every closed segment folded by the torch step) against
the JAX package's single service on the same histories.  Then the port's
router cases (dead-worker salvage and reroute, the aggregated scrape,
shedding on admission), the stream service's fleet flags and
``python -m jepsen_tpu_torch.fleet`` as processes, and the bench tier."""

import json
import os
import random
import signal
import socket
import socketserver
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from jepsen_tpu.fleet import admission as ja
from jepsen_tpu.fleet import cachestore as jc
from jepsen_tpu.fleet import router as jr
from jepsen_tpu.stream.service import StreamService as JService
from jepsen_tpu_torch.fleet import admission as ta
from jepsen_tpu_torch.fleet import bench as tbench
from jepsen_tpu_torch.fleet import cachestore as tc
from jepsen_tpu_torch.fleet import router as tr
from jepsen_tpu_torch.reconnect import Backoff
from test_torch_search import reference_defaults

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    reference_defaults(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _specs(mod, n, port=1):
    return [mod.WorkerSpec(f"w{i}", "127.0.0.1", port) for i in range(n)]


# ---------------------------------------------------------------------------
# rendezvous routing
# ---------------------------------------------------------------------------


def _run_ids(n=1000):
    rng = random.Random(4242)
    return [f"run-{rng.getrandbits(48):012x}-{i}" for i in range(n)]


@pytest.mark.parametrize("ring", ["four", "join", "leave"])
def test_routing_equal_on_1000_run_ids(ring):
    n = {"four": 4, "join": 5, "leave": 4}[ring]
    workers = {}
    for name, mod in (("jax", jr), ("port", tr)):
        ws = _specs(mod, n)
        if ring == "leave":
            ws = [w for w in ws if w.wid != "w2"]
        workers[name] = ws
    runs = _run_ids()
    want = [jr.route_run(r, workers["jax"]).wid for r in runs]
    got = [tr.route_run(r, workers["port"]).wid for r in runs]
    assert got == want
    assert [tr.rendezvous_score("w1", r) for r in runs[:50]] \
        == [jr.rendezvous_score("w1", r) for r in runs[:50]]


def test_join_moves_a_bounded_fraction_and_leave_only_its_own():
    runs = _run_ids(500)
    before = {r: tr.route_run(r, _specs(tr, 4)).wid for r in runs}
    after = {r: tr.route_run(r, _specs(tr, 5)).wid for r in runs}
    moved = [r for r in runs if before[r] != after[r]]
    assert len(moved) < len(runs) * 0.35
    assert all(after[r] == "w4" for r in moved)
    counts = {w: list(before.values()).count(w) for w in set(before.values())}
    assert len(counts) == 4 and max(counts.values()) < len(runs) // 2
    survivors = [w for w in _specs(tr, 4) if w.wid != "w2"]
    left = {r: tr.route_run(r, survivors).wid for r in runs}
    for r in runs:
        if before[r] != "w2":
            assert left[r] == before[r]
        else:
            assert left[r] != "w2"


# ---------------------------------------------------------------------------
# the shared verdict-cache store
# ---------------------------------------------------------------------------


def _fill(mod, root, wid, keys, *, states=False):
    st = mod.FleetCacheStore(root, worker_id=wid, compact_bytes=0)
    for i, k in enumerate(keys):
        if states:
            st.put_states(k, {(i % 5,), (i % 3 + 10,)})
        else:
            st.put_verdict(k, i % 3 != 0)
    return st


def _entries(mod, root):
    st = mod.FleetCacheStore(root, worker_id="reader")
    try:
        return {k: st.get(k) for k in sorted(st._d)}
    finally:
        st.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_root_read_by_the_other_package(tmp_path, writer):
    wmod, rmod = (jc, tc) if writer == "jax" else (tc, jc)
    root = str(tmp_path / "store")
    a = _fill(wmod, root, "w1", [f"a{i}" for i in range(40)])
    b = _fill(wmod, root, "w2", [f"b{i}" for i in range(30)], states=True)
    a.compact()  # a spill: the base holds both segments' entries
    _fill(wmod, root, "w1", [f"c{i}" for i in range(10)])
    want = _entries(wmod, root)
    assert len(want) == 80
    assert _entries(rmod, root) == want
    # a reader of the other package refreshes a peer's later insert
    r = rmod.FleetCacheStore(root, worker_id="w9", compact_bytes=0)
    b.put_verdict("late", True)
    assert r.get("late") is None
    assert r.refresh() == 1 and r.get("late") == {"k": "late", "v": True}
    for st in (a, b, r):
        st.close()


def test_spill_refresh_and_compact_leave_equal_files(tmp_path):
    out = {}
    for name, mod in (("jax", jc), ("port", tc)):
        root = str(tmp_path / name)
        a = _fill(mod, root, "w1", [f"k{i}" for i in range(25)])
        b = _fill(mod, root, "w2", [f"k{i}" for i in range(10, 40)],
                  states=True)
        dropped = [a.compact()]
        refreshed = a.refresh()
        b.put_verdict("k-new", False)
        dropped.append(b.compact())
        files = {}
        paths = tc.store_paths(root)
        for p in [paths["base"]] + sorted(
                os.path.join(paths["segments"], f)
                for f in os.listdir(paths["segments"])):
            with open(p) as f:
                files[os.path.relpath(p, root)] = sorted(f.read()
                                                         .splitlines())
        out[name] = (dropped, refreshed, files, a.compactions,
                     b.compacted_away, _entries(mod, root))
        a.close()
        b.close()
    assert out["port"] == out["jax"]


def test_concurrent_spills_lose_no_insert(tmp_path):
    root = str(tmp_path / "store")
    a = tc.FleetCacheStore(root, worker_id="w1", compact_bytes=0)
    b = tc.FleetCacheStore(root, worker_id="w2", compact_bytes=0)
    n = 150
    done = threading.Event()

    def writer():
        for i in range(n):
            b.put_verdict(f"b{i}", i % 2 == 0)
        done.set()

    def spiller():
        i = 0
        while True:
            a.put_verdict(f"a{i}", True)
            a.compact()
            i += 1
            if done.is_set():
                break

    threads = [threading.Thread(target=writer),
               threading.Thread(target=spiller)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    b.compact()
    fresh = tc.FleetCacheStore(root, worker_id="w3")
    assert [i for i in range(n) if fresh.get(f"b{i}") is None] == []
    assert fresh.get("a0")["v"] is True
    assert os.path.getsize(os.path.join(root, "segments", "w2.jsonl")) == 0


# ---------------------------------------------------------------------------
# admission, the scale signal and the merges
# ---------------------------------------------------------------------------


def _signals(n=300, seed=11):
    rng = random.Random(seed)
    shed = ops = hits = misses = 0.0
    out = []
    for _ in range(n):
        shed += rng.choice([0, 0, 0, 1, 5, 40])
        ops += rng.choice([0, 10, 100])
        hits += rng.choice([0, 5, 50])
        misses += rng.choice([0, 5, 50])
        sig = {"open_runs": float(rng.choice([0, 3, 10, 64, 100, 600])),
               "fold_backlog": float(rng.choice([0, 12, 5000])),
               "shed_total": shed, "ops_total": ops}
        if rng.random() < 0.7:
            sig.update(cache_hits=hits, cache_misses=misses)
        out.append((sig, rng.choice([0.0, 0.5, 3.0, 20.0])))
    return out


@pytest.mark.parametrize("policy", [
    {},
    {"max_open_runs": 100, "spawn_open_runs": 10, "max_shed_rate": 0.5,
     "spawn_shed_rate": 0.1, "min_spawn_interval_s": 5.0},
    {"max_open_runs": 0},
    {"spawn_open_runs": 3, "min_spawn_interval_s": 0.0,
     "spawn_min_cache_hit_ratio": 0.6, "cache_signal_min_lookups": 50},
])
def test_admission_decisions_equal_on_a_grid(policy):
    runs = []
    for mod in (ja, ta):
        t = {"now": 0.0}
        ctl = mod.AdmissionController(mod.AdmissionPolicy(**policy),
                                      clock=lambda t=t: t["now"])
        got = []
        for sig, dt in _signals():
            t["now"] += dt
            got.append((ctl.shed_rate(sig), ctl.cache_hit_ratio(sig),
                        ctl.decide(sig)))
        runs.append((got, dict(ctl.decisions)))
    assert runs[1] == runs[0]
    assert len({d for _r, _h, d in runs[0][0]}) >= (1 if policy.get(
        "max_open_runs") == 0 else 2)


@pytest.mark.parametrize("merged", [
    {"values": {"jtpu_stream_runs_open": {"type": "gauge", "values": 3},
                "jtpu_shed_total": {"op-budget": 2.0, "draining": 1.0},
                "jtpu_stream_ops_ingested_total": 500.0}},
    {"values": {"jtpu_verdict_cache_total": {"hit": 40.0, "miss": 160.0,
                                             "insert": 12.0},
                "jtpu_stream_cells_open": [1, 2]}},
    {"values": {"jtpu_verdict_cache_total": 0}},
    {"jtpu_stream_runs_open": 7, "jtpu_shed_total": "n/a"},
    {},
])
def test_scale_signal_equal(merged):
    assert ta.scale_signal(merged) == ja.scale_signal(merged)


def _worker_texts(seed):
    from jepsen_tpu_torch.obs import metrics

    rng = random.Random(seed)
    out = {}
    for wid in ("w0", "w1", "router"):
        reg = metrics.Registry()
        c = reg.counter("jtpu_x_total", "things", ("reason",))
        g = reg.gauge("jtpu_y", "level")
        for _ in range(rng.randrange(1, 6)):
            c.inc(rng.randrange(1, 9), reason=rng.choice("abc"))
        g.set(rng.random())
        out[wid] = (reg.render(), reg.snapshot())
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_metric_merges_equal(seed):
    worker = _worker_texts(seed)
    texts = {w: t for w, (t, _s) in worker.items()}
    snaps = {w: s for w, (_t, s) in worker.items()}
    snaps["w1"]["derived"] = {"ratio": 0.5}
    assert tr.merge_metrics_texts(texts) == jr.merge_metrics_texts(texts)
    assert tr.merge_snapshots(snaps) == jr.merge_snapshots(snaps)
    merged = tr.merge_metrics_texts(texts).splitlines()
    assert merged.count("# HELP jtpu_x_total things") == 1
    assert any(ln.startswith('jtpu_y{worker="router"}') for ln in merged)


def test_admission_requires_a_verified_warmup():
    router = tr.FleetRouter(require_warmup=True)
    cold = tr.WorkerSpec("cold", "127.0.0.1", 1)
    assert not router.admit_worker(cold)
    assert not router.admit_worker(cold, warmup_report={"verified": False})
    assert router.admit_worker(cold, warmup_report={"verified": True})
    assert router.is_live("cold")


# ---------------------------------------------------------------------------
# the live fleet in process
# ---------------------------------------------------------------------------


def _fleet(tmp_path, **kw):
    return tbench.Fleet(
        str(tmp_path), device="cpu", probe_interval=0.05,
        backoff_factory=lambda: Backoff(base=0.01, cap=0.05,
                                        max_attempts=3, jitter=0.0), **kw)


def _client(port, lines):
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        w, r = s.makefile("w"), s.makefile("r")
        for li in lines:
            w.write(li + "\n")
        w.flush()
        s.shutdown(socket.SHUT_WR)
        return [json.loads(x) for x in r if x.strip()]


def _jax_final(lines, **kw):
    svc = JService(**kw)
    replies = []
    for li in lines:
        svc.handle_line(li, replies.append)
    return tbench._strip_cache([d for d in replies if "final" in d][-1]
                               ["final"])


def _small_history(seed, n_ops=60):
    from jepsen_tpu_torch.synth import register_history

    return register_history(random.Random(seed), n_ops=n_ops, n_procs=4,
                            overlap=3, quiesce_every=8, n_values=5,
                            cas=False)


def test_routed_finals_equal_the_jax_single_service(tmp_path):
    """Two port workers folding every closed segment on the torch step
    (``host_fold_max=0``) behind the router, four concurrent clients:
    each routed final equals the JAX package's single service (same
    fold gate) on the same history."""
    fleet = _fleet(tmp_path, host_fold_max=0)
    try:
        hists = {f"run-{i}": _small_history(300 + i, 40) for i in range(4)}
        finals, lock = {}, threading.Lock()

        def go(rid, h):
            out = _client(fleet.port, tbench._op_lines(rid, h))
            fin = [d for d in out if "final" in d]
            with lock:
                finals[rid] = fin

        threads = [threading.Thread(target=go, args=kv)
                   for kv in hists.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert {fleet.router.route(r).wid for r in hists} == {"w0", "w1"}
        for rid, h in hists.items():
            assert len(finals[rid]) == 1, finals[rid]
            want = _jax_final(tbench._op_lines(rid, h), host_fold_max=0)
            assert want["stream"]["routes"]["device"] > 0
            assert tbench._strip_cache(finals[rid][0]["final"]) == want
    finally:
        fleet.close()


def test_dead_worker_salvages_and_reroutes(tmp_path):
    """Stop the worker holding an open run: the probes declare it dead,
    its persisted final is salvaged to the client, and the suffix runs
    on the survivor; both finals equal the single service's on the
    prefix and on the suffix."""
    fleet = _fleet(tmp_path)
    try:
        rid = "salvage-me"
        victim = fleet.router.route(rid)
        h = _small_history(77, 40)
        cut = next(i for i in range(len(h) // 2, len(h))
                   if sum(1 if op.type == "invoke" else -1
                          for op in h[:i]) == 0)
        lines = tbench._op_lines(rid, h)
        head, prefix = lines[0], lines[1:cut + 1]
        suffix = lines[cut + 1:]
        with socket.create_connection(("127.0.0.1", fleet.port)) as s:
            w, r = s.makefile("w"), s.makefile("r")
            for li in [head] + prefix:
                w.write(li + "\n")
            w.flush()
            # the victim has ingested the whole prefix, then it stops
            vsrv = fleet.servers[[x.wid for x in fleet.specs]
                                 .index(victim.wid)]
            deadline = time.time() + 60
            while time.time() < deadline and sum(
                    svc._ops.get(rid, 0)
                    for svc in list(vsrv.services)) < cut:
                time.sleep(0.02)
            fleet.kill(victim.wid)
            while fleet.router.is_live(victim.wid) \
                    and time.time() < deadline:
                time.sleep(0.05)
            assert not fleet.router.is_live(victim.wid)
            for li in suffix:
                w.write(li + "\n")
            w.flush()
            s.shutdown(socket.SHUT_WR)
            s.settimeout(60)
            replies = [json.loads(x) for x in r if x.strip()]
        finals = [d["final"] for d in replies if "final" in d]
        prefix_want = tbench._single_service_final(
            None, device="cpu", lines=[head] + prefix + lines[-1:])
        suffix_want = tbench._single_service_final(
            None, device="cpu", lines=[head] + suffix)
        # the salvaged final is the persisted snapshot's (verdict and
        # engine); the victim's own final may also get through first
        salvaged = [f for f in finals if f.get("finalized_by") == "salvage"]
        assert len(salvaged) == 1, replies
        assert {k: salvaged[0][k] for k in ("valid", "engine")} \
            == {k: prefix_want[k] for k in ("valid", "engine")}
        rest = [tbench._strip_cache(f) for f in finals
                if f.get("finalized_by") != "salvage"]
        assert rest[-1] == suffix_want
        assert rest[:-1] in ([], [prefix_want])
    finally:
        fleet.close()


class _SlowWorker(socketserver.ThreadingTCPServer):
    """A stand-in worker that answers every run's final only
    ``delay`` seconds after its client's EOF, as a loaded worker still
    working through a backlog does."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, delay):
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                runs = [json.loads(x)["run"] for x in self.rfile
                        if b'"model"' in x]
                time.sleep(outer.delay)
                for rid in runs:
                    self.wfile.write((json.dumps(
                        {"run": rid, "final": {"valid": True}}) + "\n")
                        .encode())

        self.delay = delay
        super().__init__(("127.0.0.1", 0), Handler)


def test_session_close_waits_for_a_busy_worker():
    """A client's EOF closes the router's upstream write sides; the
    finals a busy worker answers later must still reach the client.  The
    JAX package's router stops waiting after 5 s and drops them (section
    C of ``ROADMAP.md``); the port's waits while the worker is in the
    ring."""
    got = {}

    def one(name, mod):
        srv = _SlowWorker(7.5)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        router = mod.FleetRouter([mod.WorkerSpec(
            "w0", "127.0.0.1", srv.server_address[1])])
        rsrv = mod.make_router_server("127.0.0.1", 0, router)
        threading.Thread(target=rsrv.serve_forever, daemon=True).start()
        try:
            got[name] = _client(rsrv.server_address[1], [
                json.dumps({"run": "busy", "model": "register"}),
                json.dumps({"run": "busy", "end": True})])
        finally:
            rsrv.shutdown()
            rsrv.server_close()
            srv.shutdown()
            srv.server_close()

    threads = [threading.Thread(target=one, args=a)
               for a in (("jax", jr), ("port", tr))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert got["jax"] == []
    assert got["port"] == [{"run": "busy", "final": {"valid": True}}]


def test_aggregated_scrape_merges_workers(tmp_path):
    import urllib.request

    fleet = _fleet(tmp_path)
    try:
        _client(fleet.port, tbench._op_lines("scrape-run",
                                             _small_history(42, 30)))
        base = f"http://127.0.0.1:{fleet.port}"
        stats = json.loads(urllib.request.urlopen(
            f"{base}/api/stats", timeout=10).read())
        assert stats["n_workers"] == 3  # w0, w1 and the router itself
        assert "jtpu_stream_ops_ingested_total" in stats
        assert "jtpu_fleet_routed_total" in stats
        text = urllib.request.urlopen(f"{base}/metrics",
                                      timeout=10).read().decode()
        assert 'worker="router"' in text and 'worker="w0"' in text
        assert "jtpu_fleet_workers" in text
    finally:
        fleet.close()


def test_router_sheds_on_admission(tmp_path):
    fleet = _fleet(tmp_path)
    try:
        fleet.router.admission = ta.AdmissionController(
            ta.AdmissionPolicy(max_open_runs=0))
        out = _client(fleet.port, tbench._op_lines("shed-me",
                                                   _small_history(9, 20)))
        assert any(d.get("overloaded") == "admission" for d in out)
        assert not any("final" in d for d in out)
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _manifest(tmp_path):
    man = tmp_path / "shapes.json"
    man.write_text(json.dumps({"shapes": [
        {"model": ["register", 0, 1], "n_det_pad": 64, "frontier": 64},
        {"model": ["register", 0, 1], "n_det_pad": 64, "frontier": 32,
         "batch": 4, "masked": True, "dedup": True}]}))
    return str(man)


def test_stream_worker_warms_before_it_listens_and_writes_its_segment(
        tmp_path):
    root = tmp_path / "cache"
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.stream", "--device", "cpu",
         "--listen", "127.0.0.1:0", "--warmup", _manifest(tmp_path),
         "--fleet-cache", str(root), "--worker-id", "wA"],
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
        env=_env(), cwd=str(tmp_path))
    try:
        first = proc.stderr.readline()
        assert first.startswith("stream service warmup: shapes=2 "
                                "compiled=2 verified=true"), first
        second = proc.stderr.readline()
        assert "listening on" in second, second
        port = int(second.rsplit(":", 1)[1])
        out = _client(port, tbench._op_lines("seg-run",
                                             _small_history(5, 40)))
        assert [d["final"]["valid"] for d in out if "final" in d] == [True]
        seg = root / "segments" / "wA.jsonl"
        assert seg.exists() and seg.stat().st_size > 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_stream_worker_reports_k007_drift_unverified(tmp_path):
    man = tmp_path / "bad.json"
    man.write_text(json.dumps({"shapes": [{"window": 40}]}))
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.stream", "--device", "cpu",
         "--warmup", str(man)], input="", capture_output=True, text=True,
        env=_env(), cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stderr.splitlines()
    assert "verified=false" in lines[0] and "shapes=0" in lines[0]
    assert lines[1].startswith("stream service K007: warm shape #0")


def test_fleet_process_routes_and_drains_on_sigterm(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.fleet", "--workers", "2",
         "--device", "cpu", "--listen", "127.0.0.1:0",
         "--cache-root", str(tmp_path / "cache"),
         "--warmup", _manifest(tmp_path)],
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
        env=_env(), cwd=str(tmp_path), start_new_session=True)
    lines, ready = [], threading.Event()

    def read():
        for ln in proc.stderr:
            lines.append(ln)
            if ln.startswith("fleet router listening on"):
                ready.set()

    threading.Thread(target=read, daemon=True).start()
    try:
        assert ready.wait(120), "".join(lines)
        head = next(ln for ln in lines
                    if ln.startswith("fleet router listening on"))
        assert "with 2 worker(s)" in head
        port = int(head.split()[4].rsplit(":", 1)[1])
        admitted = [ln for ln in lines if "admitted at" in ln]
        assert len(admitted) == 2 and all("'verified': True" in ln
                                          for ln in admitted)
        h = _small_history(11, 30)
        out = _client(port, tbench._op_lines("p-run", h))
        fin = [d["final"] for d in out if "final" in d]
        assert [tbench._strip_cache(f) for f in fin] \
            == [tbench._single_service_final(h, device="cpu")]
        # an open run when SIGTERM lands: the drain delivers its final
        with socket.create_connection(("127.0.0.1", port)) as s:
            w, r = s.makefile("w"), s.makefile("r")
            for li in tbench._op_lines("open-run", h)[:-1]:
                w.write(li + "\n")
            w.flush()
            s.settimeout(60)
            # a live reply: the worker holds the run open
            replies = [json.loads(r.readline())]
            assert "live" in replies[0], replies
            proc.send_signal(signal.SIGTERM)
            replies += [json.loads(x) for x in r if x.strip()]
        fin = [d["final"] for d in replies if "final" in d]
        assert [(f["finalized_by"], f["valid"]) for f in fin] \
            == [("drain", True)], replies
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            # the workers too: they are in the fleet's session
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)


# ---------------------------------------------------------------------------
# the bench tier
# ---------------------------------------------------------------------------


def test_fleet_tier_quick_writes_only_where_told(tmp_path):
    before = sorted(p.name for p in REPO.iterdir())
    out_path = tmp_path / "fleet.json"
    trace_path = tmp_path / "trace.json"
    out = tbench.run_fleet_tier(quick=True, device="cpu",
                                out_path=str(out_path),
                                trace_path=str(trace_path))
    assert out["parity"] is True
    assert out["steady_state_compile_misses"] == 0
    assert out["warmup"]["verified"] is True
    assert out["scrape"] == {"n_workers": 3, "has_routed_counter": True,
                             "has_stream_ops": True}
    assert [r["clients"] for r in out["ramp"]] == [1, 2, 4]
    assert all(r["finals"] == r["runs"] and r["errors"] == 0
               for r in out["ramp"])
    assert json.loads(out_path.read_text())["knee"] == out["knee"]
    assert "traceEvents" in json.loads(trace_path.read_text())
    assert sorted(p.name for p in REPO.iterdir()) == before
