"""The benchmark of jepsen_tpu_torch, one cell per run.

    python3 linbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``configs/<config>.json``), its traffic
(``traffic/<cell>.json``: the entry kind, ``entries/<entry>.py``, and the
generator's parameters) and each per-layer metric's reader
(``metrics/<metric>.py``).

A run makes the cell's pool of checks (``gen.py``: the same checks for
every seed, relabelled and reordered by it), warms up the port on
checks of its own, then checks the pool in a closed loop with one caller
for ``--seconds``, and on until the pass over the pool in flight at that
time is complete, so that the window holds the pool's work whole.  With
``--trace 1`` the port's spans, the benchmark's own timers
(``probes.py``) and a device-only profiler (``devtrace.py``) are on,
and the per-layer metrics are reported instead of the end-to-end ones.
Once the window has closed, the traffic's ``extra`` checks, drawn from
the seed itself, go through the same checker, untimed; then every
verdict of the window and of the extra checks is compared with the
plain reference (``reference/``), key by key.  The last line of
standard output is the result, as JSON.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: the manifest the cells are found in
BENCH = ROOT / "BENCHMARK.json"
sys.path.insert(0, str(HERE))

import gen  # noqa: E402
from reference import check as ref  # noqa: E402

#: caches of the port's toolchain, inside the checkout at fixed paths
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton",
              "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "CUDA_CACHE_PATH": "build/cuda_cache"}
#: top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "jepsen_tpu")
#: the program's device; the CPU tests drive a run with "cpu"
DEVICE = "cuda"
#: engine labels of the device engines
DEVICE_ENGINES = ("device-batch", "device-bfs", "competition(device)")


class NoChip(RuntimeError):
    pass


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """``(benchmark, cell, configuration, traffic)`` by the cell's
    name in :data:`BENCH`."""
    bench = load_json(BENCH)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c["file"] for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]])
    return bench, cell, config, gen.load_traffic(name)


def load_module(path: Path):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(
        "linbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def require_chips(n: int) -> None:
    """Raise :class:`NoChip` unless this machine has ``n`` CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoChip(f"the cell asks for {n} cards, "
                     f"torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def is_device_engine(engine) -> bool:
    return isinstance(engine, str) and any(engine.startswith(d)
                                           for d in DEVICE_ENGINES)


def span_intervals(rec) -> list[tuple[float, float, str, str]]:
    """The port's recorded spans as ``(start, end, name, thread)`` in
    ``perf_counter`` seconds."""
    from jepsen_tpu_torch.obs import trace

    out = []
    for s in rec.spans():
        t0 = trace._EPOCH + s["ts"] / 1e6
        out.append((t0, t0 + s["dur"] / 1e6, s["name"], s["tid"]))
    rec.clear()
    return out


def counters() -> dict:
    """The port's launch and bucket counts so far."""
    from jepsen_tpu_torch import obs
    from jepsen_tpu_torch.checker import level_kernel as lk

    b = obs.REGISTRY.get("jtpu_bucket_ops_total")
    return {"launches": sum(lk.LAUNCHES_BY_FORM.values()),
            "bucket_useful": b.value(kind="useful") if b else 0.0,
            "bucket_padded": b.value(kind="padded") if b else 0.0}


def host_reading() -> dict:
    """This process's CPU seconds, its main thread's CPU and run-queue
    seconds, the machine's stolen seconds, context switches and threads:
    printed over the window, to tell the host's stalls from the port's
    own work."""
    import resource

    out = {"t": time.perf_counter(), "cpu_s": time.process_time(),
           "main_cpu_s": time.thread_time(),
           "threads": len(os.listdir("/proc/self/task"))
           if os.path.isdir("/proc/self/task") else 0}
    try:
        with open("/proc/thread-self/schedstat") as fh:
            out["main_runq_s"] = int(fh.read().split()[1]) / 1e9
        with open("/proc/stat") as fh:
            cpu = fh.readline().split()
        out["steal_s"] = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out["vol_cs"], out["invol_cs"] = ru.ru_nvcsw, ru.ru_nivcsw
    return out


def host_delta(a: dict, b: dict) -> str:
    parts = [f"wall {b['t'] - a['t']:.2f}"]
    for k in ("cpu_s", "main_cpu_s", "main_runq_s", "steal_s", "vol_cs",
              "invol_cs"):
        if k in a and k in b:
            parts.append(f"{k} {b[k] - a[k]:.2f}")
    parts.append(f"threads {a['threads']}->{b['threads']}")
    return ", ".join(parts)


def name_gap(t: float, checks, spans, probes) -> str:
    """What the host was doing at ``t``: the innermost span, timer or
    check around it."""
    best = None
    for s, e, n, *_ in list(spans) + list(probes):
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    if best is not None:
        return best[2]
    if any(c["t0"] <= t <= c["t1"] for c in checks):
        return "check (no span)"
    return "between checks"


#: every count compared, with its limit: all exact
LIMITS = {"mismatched_keys": 0, "undecided_keys": 0, "missing_keys": 0,
          "reference_undecided": 0, "test_verdicts_wrong": 0}


def compare(checks: list[dict], pool: list[dict]) -> dict:
    """Each check's verdicts against the reference's, key by key; the
    counts that decide ``correct`` (:data:`LIMITS`), beside two that
    show where the invalid keys were caught: the keys the reference
    calls invalid, and the invalid verdicts a device engine reached in
    the batch.  The reference checks each distinct test of the pool that
    the checks ran once."""
    refs: dict = {}
    for i in sorted({c["pool_index"] for c in checks}):
        events = pool[i]["events"]
        if pool[i]["keys"][0]["key"] is None:
            refs[i] = {None: ref.check(events)["valid"]}
        else:
            refs[i] = {k: r["valid"]
                       for k, r in ref.check_keys(events).items()}
    out = {"compared_checks": 0, "compared_keys": 0,
           "invalid_keys": 0, "batch_invalid_on_device": 0,
           "mismatched_keys": 0, "undecided_keys": 0, "missing_keys": 0,
           "reference_undecided": 0, "test_verdicts_wrong": 0}
    for c in checks:
        want = refs[c["pool_index"]]
        got = c["verdicts"]
        out["compared_checks"] += 1
        out["invalid_keys"] += sum(1 for v in want.values() if v is False)
        out["batch_invalid_on_device"] += sum(
            n for e, n in c.get("batch_invalid", {}).items()
            if is_device_engine(e))
        before = sum(out[k] for k in LIMITS)
        for k, v in want.items():
            out["compared_keys"] += 1
            if v not in (True, False):
                out["reference_undecided"] += 1
            if k not in got:
                out["missing_keys"] += 1
            elif got[k] not in (True, False):
                out["undecided_keys"] += 1
            elif got[k] != v:
                out["mismatched_keys"] += 1
        if c["valid"] != all(v is True for v in want.values()):
            out["test_verdicts_wrong"] += 1
        c["wrong"] = sum(out[k] for k in LIMITS) > before
    return out


def window_pool(seed: int, t: dict, traffic: dict) -> list[dict]:
    """The checks of the window: the same checks for every seed, made
    from the traffic's ``base_seed``, relabelled and reordered by
    ``seed``, so that every seed has the same work."""
    return gen.relabel(gen.make_pool(traffic["base_seed"], t,
                                     traffic["pool"]),
                       seed, t["n_values"])


def extra_pool(seed: int, t: dict, traffic: dict) -> list[dict]:
    """Checks drawn from ``seed`` itself, run after the window through
    the same checker and compared as its checks are, so that the
    histories ``correct`` covers change with the seed."""
    return gen.make_pool(seed, t, traffic["extra"], stream="extra")


class BatchStage:
    """Each key the batch (``search_batch``) called invalid, counted by
    the engine that did, before the independent checker checks that key
    again on its own and replaces the batch's result."""

    def __init__(self):
        self.invalid: dict = {}
        self._saved = None

    def install(self) -> None:
        from jepsen_tpu_torch.checker import linearizable as lin

        orig = self._saved = lin.search_batch
        invalid = self.invalid

        def search_batch(*a, **kw):
            out = orig(*a, **kw)
            for r in out:
                if r.get("valid") is False:
                    e = r.get("engine")
                    invalid[e] = invalid.get(e, 0) + 1
            return out

        lin.search_batch = search_batch

    def uninstall(self) -> None:
        from jepsen_tpu_torch.checker import linearizable as lin

        lin.search_batch = self._saved

    def take(self) -> dict:
        out = dict(self.invalid)
        self.invalid.clear()
        return out


def run(args, sizes: dict | None = None) -> dict:
    """One run of ``args.workload``; ``sizes`` overrides the generator's
    parameters and the pool's size (the CPU tests' small runs)."""
    bench, cell, config, traffic = load_cell(args.workload)
    traffic = {**traffic, **{k: v for k, v in (sizes or {}).items()
                             if k in ("pool", "warmup", "extra")}}
    sizes = {k: v for k, v in (sizes or {}).items()
             if k not in ("pool", "warmup", "extra")}
    for k, v in CACHE_DIRS.items():
        os.environ[k] = str(ROOT / v)
    if DEVICE == "cuda":
        require_chips(cell["chips"])
    import torch

    sys.path.insert(0, str(ROOT))
    from jepsen_tpu_torch import obs
    from jepsen_tpu_torch.models import cas_register

    entry = load_module(HERE / "entries" / f"{traffic['entry']}.py")
    t = {**config, **traffic["params"], **sizes}
    pool = window_pool(args.seed, t, traffic)
    extra = extra_pool(args.seed, t, traffic)
    # warm-up checks of their own: each entry a number of checks and the
    # sizes that differ from the window's
    warm = [c for i, w in enumerate(traffic["warmup"])
            for c in gen.make_pool(args.seed, {**t, **w.get("sizes", {})},
                                   w["n"], stream=f"warmup{i}")]
    inputs = [entry.to_program(c["events"]) for c in pool]
    checker = entry.build()
    store = Path(tempfile.gettempdir()) / "linbench-store"
    test = {"name": args.workload, "start_time": "window",
            "store_base": str(store), "model": cas_register(),
            "device": DEVICE}
    stage = BatchStage()
    stage.install()
    for c in warm:
        checker.check(dict(test, start_time="warmup"),
                      entry.to_program(c["events"]))

    def check_one(inp, index: int, ops: int) -> dict:
        stage.take()
        t0 = time.perf_counter()
        try:
            r = checker.check(test, inp)
            err = None
        except Exception as e:  # noqa: BLE001 — a check that raises fails
            r, err = {}, f"{type(e).__name__}: {e}"
        t1 = time.perf_counter()
        return {"pool_index": index, "t0": t0, "t1": t1,
                "seconds": t1 - t0, "ops": ops,
                "verdicts": entry.verdicts(r), "engines": entry.engines(r),
                "valid": r.get("valid"), "error": err,
                "batch_invalid": stage.take()}

    if DEVICE == "cuda":
        torch.cuda.synchronize()
    # the pool stays in memory for the loop, where a caller holds one
    # test at a time: keep it out of the collector's scans
    gc.collect()
    gc.freeze()

    probes = prof = rec = None
    if args.trace:
        from probes import Probes

        obs.enable(True)
        obs.set_run("linbench")
        rec = obs.recorder("linbench")
        rec.clear()
        probes = Probes()
        probes.install()
    before = counters()
    spans: list = []
    checks: list[dict] = []
    if args.trace and DEVICE == "cuda":
        import devtrace

        prof, host_t0 = devtrace.start()
    host0 = host_reading()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - T_START
    i = 0
    while True:
        k = i % len(pool)
        if i and k == 0:
            print(f"linbench: the pool of {len(pool)} checks wrapped at "
                  f"check {i}", file=sys.stderr)
        if probes is not None:
            probes.new_check()
        checks.append(check_one(inputs[k], k, pool[k]["ops"]))
        t1 = checks[-1]["t1"]
        if rec is not None:
            spans.extend(span_intervals(rec))
        i += 1
        # the window closes at the first pass over the pool completed
        # past --seconds, so that it holds the pool's work whole
        if t1 - t_w0 >= args.seconds and i % len(pool) == 0:
            break
    window_s = checks[-1]["t1"] - t_w0
    print(f"linbench: host over the window: "
          f"{host_delta(host0, host_reading())}", file=sys.stderr)
    after = counters()
    dev = None
    if prof is not None:
        t_r = time.perf_counter()
        devtrace.stop(prof)
        dev = devtrace.read(prof, host_t0)
        del prof
        print(f"linbench: the trace took {time.perf_counter() - t_r:.1f} s "
              f"to stop and read", file=sys.stderr)
    if probes is not None:
        spans.extend(span_intervals(rec))
        probes.uninstall()
        obs.enable(False)
    # the extra checks, outside the window and its metrics
    extras = [check_one(entry.to_program(c["events"]), len(pool) + j,
                        c["ops"]) for j, c in enumerate(extra)]
    stage.uninstall()

    device = {"platform": "gpu" if DEVICE == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0) if DEVICE == "cuda"
                       else "cpu"),
              "count": cell["chips"],
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(0)
                                    if DEVICE == "cuda" else 0)}
    del checker, inputs, check_one
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    decided = [c for c in checks
               if c["error"] is None and c["verdicts"]
               and all(v in (True, False) for v in c["verdicts"].values())]
    got = compare(checks + extras, pool + extra)
    failed = sum(1 for c in checks + extras
                 if c.get("wrong") or c["error"] is not None
                 or not c["verdicts"]
                 or not all(v in (True, False)
                            for v in c["verdicts"].values()))
    bad = {k: got[k] for k in LIMITS if got[k] > LIMITS[k]}
    correct = not bad and failed == 0

    ctx = {"checks": checks, "decided": decided, "window_s": window_s,
           "t_w0": t_w0, "pool": pool,
           "spans": spans, "probes": probes.intervals if probes else [],
           "counters": {k: after[k] - before[k] for k in after},
           "device": dev, "is_device_engine": is_device_engine}
    metrics = {}
    names = [m["name"] for m in (bench["per_layer"] if args.trace
                                 else bench["end_to_end"])
             if args.workload in m.get("workloads", [args.workload])]
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    for name in names:
        if name == "setup_s":
            v = setup_s
        else:
            v = load_module(HERE / "metrics" / f"{name}.py").read(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": units[name]}
    if args.trace:
        device["window_s"] = window_s
        device["busy_s"] = dev["busy_s"] if dev else 0.0
    result = {"correct": correct, "attempted": len(checks) + len(extras),
              "failed": failed, "metrics": metrics, "device": device}
    if dev is not None:
        ops = sorted(dev["by_name"].items(), key=lambda x: -x[1])[:10]
        gaps = [[name_gap((s + e) / 2, checks, spans, ctx["probes"]), e - s]
                for s, e in dev["gaps"][:10]]
        result["breakdown"] = {"device_ops": [[n, s] for n, s in ops],
                               "idle_gaps": gaps}
    secs = " ".join(f"{c['seconds']:.3f}" for c in checks)
    print(f"linbench: seconds per check: {secs}", file=sys.stderr)
    if probes is not None:
        # each check's seconds inside the benchmark's timers, by name
        for c in checks:
            by: dict = {}
            for s0, e0, n in probes.intervals:
                d = min(e0, c["t1"]) - max(s0, c["t0"])
                if d > 0:
                    n = n.split(":")[0]
                    by[n] = round(by.get(n, 0.0) + d, 4)
            print(f"linbench: check {c['seconds']:.3f} s, timers "
                  f"{json.dumps(by)}", file=sys.stderr)
    result["compared"] = {k: {"value": got[k], "limit": LIMITS.get(k)}
                          for k in got}
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the port may not load: "
                           f"{found}")
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result = run(args)
    except NoChip as e:
        print(f"linbench: no chip: {e}", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        lim = "" if v["limit"] is None else f" limit {v['limit']}"
        print(f"linbench compare: {k} {v['value']}{lim}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
