"""Time B1's single-key or grid form in two trees of this repo on one
CUDA card.

    python3 tools/torch_kernel_ab.py OLD_ROOT NEW_ROOT [--rounds N]
                                     [--gpu-only | --grid]

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
the median of each tree's runs.

With ``--grid`` a run times the grid-over-keys form instead
(``level_kernel.level_loop_batch``), with the measuring code of this
tool's own tree (its ``chip_smoke.py``) and the package of the tree
under test, at batch256's first rung (``chip_smoke.grid_first_rung``,
one slice of the ladder's first level cap with bail) and at the
:data:`GRID_CASES` of ``chip_smoke.grid_lockstep_cases``.  Each launch,
off and with telemetry, is split by ``chip_smoke._grid_split``: CUDA
events around one call on an idle card (``timed``), the device's time
per call with the queue kept full (``device``: the kernel and the
wrapper's small tensor ops), the host's time per call meanwhile
(``host``) and the profiler's kernel time; with the levels each running
key ran (``chip_smoke.grid_levels``) and a digest of the outputs, which
must be equal across trees.

Needs one card; imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path


#: cycles of the sleep kernel queued before each timed launch under
#: --gpu-only: about 1 ms on an H100, longer than the wrapper's host work
_SLEEP_CYCLES = 2_000_000

#: the grid shapes timed besides batch256's first rung, by
#: chip_smoke.grid_lockstep_cases label
GRID_CASES = ("batch256-F32-bail", "batch37-F128-bail", "batch4-F512-bail",
              "mixed-12-F64")

_SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def _digest(out) -> str:
    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().to("cpu").contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def grid_child(root: str) -> int:
    import torch

    sys.path.insert(0, root)
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.checker import level_kernel as lk
    from jepsen_tpu_torch.checker import linearizable as lin

    # this tool's tree's chip_smoke, under its own name: the same
    # measuring code for both trees, over the package found at root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.CARD = subprocess.run(_SMI, capture_output=True, text=True,
                             timeout=60).stdout.strip()
    _build.build_all()
    ptxas = cs._ptxas(_build.PTXAS_REPORT.get("level_loop", ""))
    device = torch.device("cuda", 0)
    model, dims, args, carry, n = cs.grid_first_rung(device)
    cases = [("batch256-first-rung", model, dims, args, carry,
              lin._SLICE_LEVELS0, True, n)]
    for label, m, seqs, frontier, lanes, bail, _slices, lvl_cap in \
            cs.grid_lockstep_cases():
        if label in GRID_CASES:
            cases.append((label, m, *cs.grid_setup(m, seqs, frontier, device,
                                                   lanes=lanes),
                          lvl_cap, bail, len(seqs)))
    shapes = {}
    for label, m, d, a, c, lvl_cap, bail, n_keys in cases:
        off = functools.partial(lk.level_loop_batch, m, d, *a, 10**8,
                                lvl_cap, bail, *c)
        levels = cs.grid_levels(m, d, a, c, lvl_cap, bail)
        ran = levels[levels > 0].double()
        plan = lk.launch_plan(d, device)
        rec = {"B": int(c[0].shape[0]), "keys": n_keys, "F": d.frontier,
               "threads": plan["threads"],
               "blocks_per_sm": plan["blocks_per_sm"],
               "levels_max": int(ran.max()) if ran.numel() else 0,
               "levels_mean": float(ran.mean()) if ran.numel() else 0.0,
               "digest": _digest(off()),
               "off": cs._grid_split(off),
               "tele": cs._grid_split(functools.partial(off,
                                                        telemetry=True))}
        shapes[label] = rec
        o, t = rec["off"], rec["tele"]
        print(f"grid {label}: B={rec['B']} keys={n_keys} F={d.frontier} "
              f"threads={plan['threads']} blocks/SM={plan['blocks_per_sm']} "
              f"levels max {rec['levels_max']} mean "
              f"{rec['levels_mean']:.2f}; timed {o['timed_ms']:.4f} ms, "
              f"device {o['queued_ms']:.4f} (full queue {o['full_queue']}), "
              f"host {o['host_ms']:.4f}, profiler kernel {o['prof_ms']}; "
              f"telemetry timed {t['timed_ms']:.4f}, device "
              f"{t['queued_ms']:.4f}, host {t['host_ms']:.4f}; digest "
              f"{rec['digest']} | card: {cs.CARD}", flush=True)
    print(json.dumps({"root": root, "card": cs.CARD, "ptxas": ptxas,
                      "grid": shapes}), flush=True)
    return 0


def _grid_medians(runs) -> dict:
    """Per tree and shape, the median of each split over the tree's
    runs, and whether every run's outputs were equal."""
    out = {}
    for which in ("old", "new"):
        mine = [r["grid"] for r in runs if r["tree"] == which]
        out[which] = {
            label: {f"{form}.{k}": statistics.median(
                g[label][form][k] for g in mine)
                for form in ("off", "tele")
                for k in ("timed_ms", "queued_ms", "host_ms")}
            for label in mine[0]}
        for label in mine[0]:
            prof = [g[label]["off"]["prof_ms"] for g in mine]
            out[which][label]["off.prof_ms"] = (
                statistics.median(prof) if None not in prof else None)
    labels = runs[0]["grid"]
    out["identical"] = {label: len({r["grid"][label]["digest"]
                                    for r in runs}) == 1
                        for label in labels}
    return out


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

    cs.CARD = subprocess.run(_SMI, capture_output=True, text=True,
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
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--gpu-only", action="store_true")
    mode.add_argument("--grid", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return grid_child(a.old) if a.grid else child(a.old, a.gpu_only)
    roots = {"old": str(Path(a.old).resolve()),
             "new": str(Path(a.new).resolve())}
    runs = []
    for _ in range(a.rounds):
        for which in ("old", "new", "new", "old"):
            print(f"== {which}: {roots[which]}", flush=True)
            p = subprocess.run(
                [sys.executable, __file__, roots[which], roots[which],
                 "--child"] + (["--gpu-only"] if a.gpu_only else [])
                + (["--grid"] if a.grid else []),
                capture_output=True, text=True, timeout=1800)
            sys.stdout.write(p.stdout)
            if p.returncode != 0:
                sys.stderr.write(p.stderr)
                print(f"torch_kernel_ab: the {which} run failed "
                      f"({p.returncode})", file=sys.stderr)
                return 1
            runs.append({"tree": which,
                         **json.loads(p.stdout.strip().splitlines()[-1])})
    if a.grid:
        med = _grid_medians(runs)
        for label, same in med["identical"].items():
            print(f"ab {label}: " + "; ".join(
                f"{which} device {m['off.queued_ms']:.4f} ms (telemetry "
                f"{m['tele.queued_ms']:.4f}), timed {m['off.timed_ms']:.4f}, "
                f"host {m['off.host_ms']:.4f}, profiler kernel "
                f"{m['off.prof_ms']}"
                for which in ("old", "new") for m in [med[which][label]])
                + f"; outputs identical across trees: {same} | card: "
                f"{runs[0]['card']}", flush=True)
        print(json.dumps({"runs": runs, "median": med}), flush=True)
        return 0 if all(med["identical"].values()) else 1
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
