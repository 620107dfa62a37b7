"""Time B1's single-key form in two trees of this repo on one CUDA card.

    python3 tools/torch_kernel_ab.py OLD_ROOT NEW_ROOT [--rounds N]
                                     [--gpu-only]

Each round runs OLD, NEW, NEW, OLD, every run in a process of its own,
so a drift of the card's clocks over the call falls on both trees alike.
A run imports that tree's ``chip_smoke.py`` and ``jepsen_tpu_torch``,
builds the kernel from that tree's sources, runs the 1k tier's search
once to capture the carries its wide rungs reached, and times every
shape of ``chip_smoke.phase_timing``: the kernel through
``level_kernel.level_loop`` (median of 20 launches between CUDA events,
so the wrapper's host work before the launch counts), checked against
its plain version.  With ``--gpu-only`` each timed launch is queued
behind a 1 ms sleep kernel, so the card is still busy when the host has
finished the wrapper's work, and the events hold the kernel's own time
without the host's.  Where a tree's ``chip_smoke`` also times the
kernel's telemetry form, that time comes as a third column
(``ms_tele``).  Each run prints ``chip_smoke``'s own ``timing`` lines
and each kernel instantiation's registers, spill stores and static
shared memory from ptxas;
the last line is one JSON object with every run's times and, per shape,
the median of each tree's runs.  Needs one card; imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path


#: cycles of the sleep kernel queued before each timed launch under
#: --gpu-only: about 1 ms on an H100, longer than the wrapper's host work
_SLEEP_CYCLES = 2_000_000


def child(root: str, gpu_only: bool) -> int:
    import torch

    sys.path.insert(0, root)
    import chip_smoke as cs
    from jepsen_tpu_torch import _build

    if gpu_only:
        def timed(fn, *a):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SLEEP_CYCLES)
            start.record()
            out = fn(*a)
            end.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(end)

        cs._timed = timed

    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _build.build_all()
    seq, model = cs.tier_history("1k")
    _res, _rows, captured = cs._traced_search(seq, model)
    shapes = cs.phase_timing(torch.device("cuda", 0), {"1k": captured})
    regs = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes "
                      r"spill stores.*?Used (\d+) registers.*?(\d+) bytes "
                      r"smem", _build.PTXAS_REPORT.get("level_loop", ""),
                      re.S)
    print(json.dumps({"root": root, "card": cs.CARD,
                      "ms": {t["shape"]: t["ms"] for t in shapes},
                      "ms_tele": {t["shape"]: t["ms_tele"] for t in shapes
                                  if "ms_tele" in t},
                      "ptxas": sorted([k, int(r), int(sp), int(sm)]
                                      for k, sp, r, sm in regs)}),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--gpu-only", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return child(a.old, a.gpu_only)
    roots = {"old": str(Path(a.old).resolve()),
             "new": str(Path(a.new).resolve())}
    runs = []
    for _ in range(a.rounds):
        for which in ("old", "new", "new", "old"):
            print(f"== {which}: {roots[which]}", flush=True)
            p = subprocess.run(
                [sys.executable, __file__, roots[which], roots[which],
                 "--child"] + (["--gpu-only"] if a.gpu_only else []),
                capture_output=True, text=True, timeout=1800)
            sys.stdout.write(p.stdout)
            if p.returncode != 0:
                sys.stderr.write(p.stderr)
                print(f"torch_kernel_ab: the {which} run failed "
                      f"({p.returncode})", file=sys.stderr)
                return 1
            runs.append({"tree": which,
                         **json.loads(p.stdout.strip().splitlines()[-1])})
    shapes = list(runs[0]["ms"])
    median = {which: {s: statistics.median(r["ms"][s] for r in runs
                                           if r["tree"] == which)
                      for s in shapes}
              for which in ("old", "new")}
    tele = {which: {s: statistics.median(r["ms_tele"][s] for r in runs
                                         if r["tree"] == which)
                    for s in shapes
                    if all(s in r["ms_tele"] for r in runs
                           if r["tree"] == which)}
            for which in ("old", "new")}
    print(json.dumps({"runs": runs, "median_ms": median,
                      "median_ms_tele": tele}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
