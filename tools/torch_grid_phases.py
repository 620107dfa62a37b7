"""Where a level of B1's grid form goes, by phase, on one CUDA card.

    python3 tools/torch_grid_phases.py [--threads T1,T2,...]

Writes copies of ``jepsen_tpu_torch/csrc/level_loop.cu`` under
``build/grid_phases`` and builds them in parallel with the port's nvcc
flags; the port's own source and build are left as they are.  A copy
differs from the source in two ways only:

  * phase clocks (the clocked copies): thread 0 of each key reads
    ``clock64`` at the end of the mask phase, the crash closure, the
    successor build and the prune, and adds each phase's cycles to the
    key's row of a device array, summed over the slice's levels; an
    added C function ``jtt_phase_cycles_take`` copies the rows out and
    clears them.  A phase that ends without a barrier hands its
    stragglers' wait to the next;
  * the block's fewest threads (``plan_sw``'s floor): the port's 256,
    and each count ``--threads`` gives (64, 128, 512, 1024 by default).

Then, in this process, each build in turn takes the port library's
place and runs batch256's first rung (``chip_smoke.grid_first_rung``:
the keys the greedy witness leaves to the device, stacked at F=32, one
slice of the ladder's first level cap with bail) and batch256 from the
root (B=256, 16 levels):

  * ``device_ms``: CUDA events around 30 launches queued behind a sleep
    kernel, per launch, on the copy without clocks;
  * the clocked copy's cycles by phase, for the key with the most cycles
    and as the mean over running keys (the 256-thread floor only);
  * a digest of each output, equal across builds.

Every line ends with the card's name and power limit; the last line is
one JSON object.  Needs one card and nvcc; imports neither jax nor the
JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("mask", "closure", "successors", "prune")
PORT_THREADS = 256
_SLEEP_CYCLES = 40_000_000
QUEUED = 30

_CLOCKS = """
#define JTT_PHASE_KEYS 4096
__device__ unsigned long long jtt_phase_cycles[JTT_PHASE_KEYS][4];
#define PHASE_END(k)                                                 \\
  if (tid == 0) {                                                    \\
    long long now = clock64();                                       \\
    jtt_phase_cycles[blockIdx.x % JTT_PHASE_KEYS][k] += now - phase_t; \\
    phase_t = now;                                                   \\
  }
"""

_TAKE = """
int jtt_phase_cycles_take(unsigned long long* out, int n) {
  size_t bytes = (size_t)n * 4 * sizeof(unsigned long long);
  cudaError_t err = cudaMemcpyFromSymbol(out, jtt_phase_cycles, bytes);
  if (err != cudaSuccess) return (int)err;
  static unsigned long long zero[JTT_PHASE_KEYS][4];
  return (int)cudaMemcpyToSymbol(jtt_phase_cycles, zero, sizeof(zero));
}

"""

#: (text in the source, text it becomes) for the clocked copies: each
#: anchor must occur exactly once
_CLOCK_PATCHES = (
    ("#define NIL ((int)0x80000000)\n",
     "#define NIL ((int)0x80000000)\n" + _CLOCKS),
    ("    mask_phase<SW>(buf[c], count, vdet, vcr, tk, d, found, crash);\n"
     "    bool go = __syncthreads_or(crash);\n",
     "    long long phase_t = clock64();\n"
     "    mask_phase<SW>(buf[c], count, vdet, vcr, tk, d, found, crash);\n"
     "    bool go = __syncthreads_or(crash);\n"
     "    PHASE_END(0);\n"),
    ("    if (progress) ovf = true;\n",
     "    if (progress) ovf = true;\n    PHASE_END(1);\n"),
    ("                                     tk, d, wsum[ph], &maxp[mph]);\n",
     "                                     tk, d, wsum[ph], &maxp[mph]);\n"
     "    PHASE_END(2);\n"),
    ("                               wsum[ph], false, found, &any);\n",
     "                               wsum[ph], false, found, &any);\n"
     "    PHASE_END(3);\n"),
    ('}  // extern "C"', _TAKE + '}  // extern "C"'),
)
_FLOOR = "pl->threads = threads < 256 ? 256 :"


def source(threads: int, clocks: bool) -> str:
    """The kernel's source with the block floor at ``threads`` and, with
    ``clocks``, the phase clocks; raises if an anchor is not found
    once."""
    from jepsen_tpu_torch import _build

    text = (_build.SRC_DIR / "level_loop.cu").read_text()
    patches = ((_FLOOR, f"pl->threads = threads < {threads} ? {threads} :"),
               *(_CLOCK_PATCHES if clocks else ()))
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"level_loop.cu: {old!r} found "
                               f"{text.count(old)} times, want once")
        text = text.replace(old, new)
    return text


def build(variants, out_dir: Path) -> dict:
    """(threads, clocks) -> library path, built in parallel."""
    from jepsen_tpu_torch import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for threads, clocks in variants:
        stem = f"level_loop_t{threads}{'_clocks' if clocks else ''}"
        src = out_dir / f"{stem}.cu"
        src.write_text(source(threads, clocks))
        lib = out_dir / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[threads, clocks] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = lib
    return libs


def _load(path: Path, clocks: bool):
    """Put the library at ``path`` in the port library's place."""
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.checker import level_kernel as lk

    lib = ctypes.CDLL(str(path))
    for name, (args, res) in _build._SIGNATURES["level_loop"].items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    if clocks:
        lib.jtt_phase_cycles_take.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.jtt_phase_cycles_take.restype = ctypes.c_int
    _build._LIBS["level_loop"] = lib
    lk._plan.cache_clear()
    return lib


def _digest(out) -> str:
    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().to("cpu").contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _device_ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SLEEP_CYCLES)
    start.record()
    for _ in range(QUEUED):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / QUEUED


def _cycles(lib, fn, B: int, n_keys: int):
    """(slowest key's cycles by phase, mean over running keys, running
    keys) of one call of ``fn`` on the clocked library ``lib``."""
    import numpy as np
    import torch

    buf = (ctypes.c_ulonglong * (4 * B))()
    fn()
    torch.cuda.synchronize()
    lib.jtt_phase_cycles_take(buf, B)  # the warm-up's, dropped
    fn()
    torch.cuda.synchronize()
    rc = lib.jtt_phase_cycles_take(buf, B)
    if rc != 0:
        raise RuntimeError(f"jtt_phase_cycles_take: CUDA error {rc}")
    cyc = np.array(buf, dtype=np.float64).reshape(B, 4)[:n_keys]
    live = cyc[cyc.sum(1) > 0]
    return live[live.sum(1).argmax()], live.mean(0), len(live)


def main() -> int:
    import torch

    import chip_smoke as cs
    from jepsen_tpu_torch.checker import level_kernel as lk
    from jepsen_tpu_torch.checker import linearizable as lin

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="64,128,512,1024",
                    help="comma-separated block floors timed beside the "
                    f"port's {PORT_THREADS}")
    a = ap.parse_args()
    floors = [PORT_THREADS] + [int(t) for t in a.threads.split(",") if t]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    t0 = time.perf_counter()
    libs = build([(t, False) for t in floors] + [(PORT_THREADS, True)],
                 ROOT / "build" / "grid_phases")
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    device = torch.device("cuda", 0)
    model, dims, args, carry, n = cs.grid_first_rung(device)
    keys, _ = cs.batch_keys()
    shapes = [("batch256 first rung", dims, args, carry, lin._SLICE_LEVELS0,
               n),
              ("batch256 from the root",
               *cs.grid_setup(model, keys, 32, device, lanes=len(keys)), 16,
               len(keys))]
    recs = []
    for label, d, a_, c, lvl_cap, n_keys in shapes:
        B = int(c[0].shape[0])
        fn = functools.partial(lk.level_loop_batch, model, d, *a_, 10**8,
                               lvl_cap, True, *c)
        for threads in floors:
            _load(libs[threads, False], False)
            rec = {"shape": label, "threads": threads,
                   "digest": _digest(fn()), "device_ms": _device_ms(fn),
                   "launch_threads": lk.launch_plan(d, device)["threads"]}
            line = (f"phases {label} B={B} floor={threads} threads="
                    f"{rec['launch_threads']}: device {rec['device_ms']:.4f} "
                    f"ms/launch; digest {rec['digest']}")
            if threads == PORT_THREADS:
                lib = _load(libs[threads, True], True)
                slow, mean, running = _cycles(lib, fn, B, n_keys)
                rec.update(slowest_key_cycles=dict(zip(PHASES,
                                                       slow.tolist())),
                           mean_cycles=dict(zip(PHASES, mean.tolist())),
                           running_keys=running)
                line += ("; slowest key's cycles "
                         + ", ".join(f"{p} {v:.0f}"
                                     for p, v in zip(PHASES, slow))
                         + f" (total {slow.sum():.0f}); mean over {running} "
                         "running keys "
                         + ", ".join(f"{p} {v:.0f}"
                                     for p, v in zip(PHASES, mean)))
            recs.append(rec)
            print(f"{line} | card: {card}", flush=True)
    same = {label: len({r["digest"] for r in recs if r["shape"] == label})
            == 1 for label, *_ in shapes}
    print(json.dumps({"card": card, "runs": recs, "identical": same}),
          flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
