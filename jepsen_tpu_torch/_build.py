"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/jepsen_tpu_torch/``
at the repository root, named by a hash of its source and flags, so an
edited source rebuilds and an unchanged one loads as it is.  All sources
compile in parallel (one ``nvcc`` each).  Libraries load with ``ctypes``;
no PyTorch headers are involved.

Nothing here runs at import: the build starts when a CUDA tensor first
reaches a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "jepsen_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: seconds the last build took, and nvcc's -Xptxas -v report per source
BUILD_SECONDS: float | None = None
PTXAS_REPORT: dict[str, str] = {}

_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signatures of the exported functions, by source stem
_SIGNATURES = {
    "level_loop": {
        "jtt_level_loop": ([_VP] * 10 + [_INT] + [_VP] * 7 + [_LL]
                           + [_INT] * 10 + [_VP] * 2, _INT),
        "jtt_level_loop_plan": ([_INT] * 6 + [_VP], _INT),
        "jtt_error_string": ([_INT], ctypes.c_char_p),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "jepsen_tpu_torch need the CUDA toolkit to build")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every stale source (in parallel) and load every library.
    Raises RuntimeError with nvcc's output when a build fails."""
    global BUILD_SECONDS
    with _LOCK:
        if _LIBS:
            return _LIBS
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        srcs = sorted(SRC_DIR.glob("*.cu"))
        procs = []
        for src in srcs:
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            PTXAS_REPORT[src.stem] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
        for src in srcs:
            lib = ctypes.CDLL(str(_target(src)))
            for name, (args, res) in _SIGNATURES.get(src.stem, {}).items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _LIBS[src.stem] = lib
        BUILD_SECONDS = time.perf_counter() - t0
        return _LIBS


def prebuilt() -> bool:
    """Whether every source's library is already in the build directory
    (built by an earlier process or call): the port's persistent compile
    cache.  A file check; builds nothing."""
    srcs = sorted(SRC_DIR.glob("*.cu"))
    return bool(srcs) and all(_target(src).exists() for src in srcs)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    return build_all()[stem]
