#!/usr/bin/env python3
"""What a device-routed stream fold costs, by stream shape.

    python3 tools/torch_stream_probe.py [--device cpu|cuda] [--ops N]
        [--budget N] [--forced] [--limit S] SHAPE...

A SHAPE is ``BURST:CLIENTS:IN_FLIGHT:VALUES`` (e.g. ``256:24:20:5``):
``synth.register_history(Random("bench-stream-0"), n_ops=N,
n_procs=CLIENTS, overlap=IN_FLIGHT, quiesce_every=BURST,
n_values=VALUES, cas=True)`` on ``cas_register()``.  For each shape it
prints the default gate's split of the closed segments
(``analyze.plan.stream_plan``) and their encoding windows (the kernel
takes windows up to 64), then streams the history through
``StreamChecker(device=...)`` (``--forced``: every fold to the device;
``--budget``: configs per variant) and prints one line per fold: rows,
most ops in flight, window, variants, configs, the kernel's grid and
single-key launches, and its wall; host folds print their wall too.
Each shape runs in a process of its own, stopped after ``--limit``
seconds.  The card's name and power limit lead the output.
"""

from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def probe(shape: str, n_ops: int, device: str, budget: int,
          forced: bool) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from jepsen_tpu_torch.analyze.plan import stream_plan
    from jepsen_tpu_torch.checker import level_kernel as lk
    from jepsen_tpu_torch.checker.encode import encode_search
    from jepsen_tpu_torch.decompose import engine
    from jepsen_tpu_torch.decompose.partition import (quiescence_segments,
                                                      subseq)
    from jepsen_tpu_torch.history import encode_ops, max_concurrency
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.stream import StreamChecker
    from jepsen_tpu_torch.stream import device as sd
    from jepsen_tpu_torch.synth import register_history

    burst, clients, in_flight, values = (int(x) for x in shape.split(":"))
    model = cas_register()
    h = register_history(random.Random("bench-stream-0"), n_ops=n_ops,
                         n_procs=clients, overlap=in_flight,
                         quiesce_every=burst, n_values=values, cas=True)
    seq = encode_ops(h, model.f_codes)
    plan = stream_plan(seq, model)
    wins = [encode_search(subseq(seq, rows)).window
            for rows in quiescence_segments(seq)[:-1]]
    print(f"{shape} events={len(h)} gate={plan['routes']} rows="
          f"{plan['expected_segment_rows']} windows max={max(wins or [0])} "
          f"over_64={sum(w > 64 for w in wins)} of {len(wins)}", flush=True)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    fold = sd.device_fold_states

    def traced(sseq, m, ins, **kw):
        g0, s0 = lk.BATCH_LAUNCHES, lk.LAUNCHES
        sync()
        t0 = time.perf_counter()
        out = fold(sseq, m, ins, **kw)
        sync()
        print(f"{shape} device fold rows={len(sseq)} in_flight="
              f"{max_concurrency(sseq)} window={encode_search(sseq).window} "
              f"in_states={len(ins)} configs={None if out is None else out[1]}"
              f" decided={out is not None} grid={lk.BATCH_LAUNCHES - g0} "
              f"single={lk.LAUNCHES - s0} s={time.perf_counter() - t0:.3f}",
              flush=True)
        return out

    host = engine.segment_states

    def host_traced(sseq, *a, **kw):
        t0 = time.perf_counter()
        out = host(sseq, *a, **kw)
        print(f"{shape} host fold rows={len(sseq)} in_flight="
              f"{max_concurrency(sseq)} s={time.perf_counter() - t0:.3f}",
              flush=True)
        return out

    sd.device_fold_states = traced
    engine.segment_states = host_traced
    sc = StreamChecker(model, device=device, device_budget=budget,
                       host_fold_max=0 if forced else None)
    t0 = time.perf_counter()
    for op in h:
        sc.ingest(op)
    r = sc.finalize()
    print(f"{shape} done valid={r['valid']} routes={r['stream']['routes']} "
          f"s={time.perf_counter() - t0:.3f}", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("shapes", nargs="+", metavar="SHAPE")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ops", type=int, default=8000)
    p.add_argument("--budget", type=int, default=2_000_000)
    p.add_argument("--forced", action="store_true")
    p.add_argument("--limit", type=float, default=170.0)
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.one:
        probe(a.shapes[0], a.ops, a.device, a.budget, a.forced)
        return 0
    if a.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
        sys.path.insert(0, str(REPO))
        from jepsen_tpu_torch import _build

        _build.build_all()
    for shape in a.shapes:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", shape,
               "--device", a.device, "--ops", str(a.ops), "--budget",
               str(a.budget)] + (["--forced"] if a.forced else [])
        try:
            subprocess.run(cmd, timeout=a.limit, check=False)
        except subprocess.TimeoutExpired:
            print(f"{shape} stopped after {a.limit} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
