"""The fused level loop: a whole search slice as one CUDA kernel.

Counterpart of the JAX package's Pallas kernel
(``jepsen_tpu/checker/pallas_level.py::build_pallas_step_fn``).  The
kernel (``csrc/level_loop.cu``) runs ``lvl_cap`` levels of mask phase,
crash closure, successor compaction and exact all-pairs dominance prune
inside one thread block, on every rung where the card's torch step
prunes all-pairs (``F <= 2048``), with the history tables in shared
memory where they fit.

  * :func:`eligible` — which searches the kernel takes (never one with
    reductions: the kernel computes the unreduced search);
  * :func:`level_loop_reference` — the plain version: the unreduced
    torch step (``step.py``) pinned to the all-pairs prune;
  * :func:`level_loop` — the wrapper: the plain version for CPU tensors,
    the kernel for CUDA tensors (or an exception; never a fallback);
    both refuse reduction planes that are not inert;
  * :func:`launch_plan` — where a launch at these dims keeps its tables
    (shared or device memory) and how much scratch it needs;
  * :data:`LAUNCHES` — kernel launches so far (plain version excluded).

Both take ``(model, dims, *step_args)`` where ``step_args`` are the 28
arguments of a step function; :func:`build_level_loop_fn` binds the
first two.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from . import step
from .encode import NEVER_DEAD, SearchDims
from .step import build_search_step_fn

#: models the kernel's ``model_step`` implements
SAFE_MODELS = frozenset({"register", "cas-register", "mutex", "noop"})

#: kernel launches so far; each launch adds one
LAUNCHES = 0

_CUDA = torch.device("cuda")


def eligible(model, dims: SearchDims, *, masked: bool = False,
             dedup: bool = False) -> bool:
    """The kernel takes a search when it has no reductions (``masked``,
    ``dedup``), its model is one of :data:`SAFE_MODELS`, its masks fit
    one 64-bit word each, its state four words, and the card's torch
    step would prune all-pairs at both of its sites (``2F`` closure
    rows, ``4F`` successor rows) under the default prune mode: the
    kernel prunes all-pairs, so it never takes a rung where the card's
    step would prune by sort.  That holds for ``F <= 2048``."""
    F = dims.frontier
    return (not masked and not dedup
            and model.name in SAFE_MODELS
            and dims.window <= 64
            and dims.n_crash_pad <= 64
            and dims.state_width <= 4
            and step._use_allpairs(2 * F, _CUDA, mode="auto")
            and step._use_allpairs(4 * F, _CUDA, mode="auto"))


_REFERENCE_STEPS: dict = {}


def _reference_step(model, dims: SearchDims, device: torch.device):
    key = (model.name, dims, str(device))
    fn = _REFERENCE_STEPS.get(key)
    if fn is None:
        fn = _REFERENCE_STEPS[key] = build_search_step_fn(
            model, dims, device, use_allpairs=True)
    return fn


def level_loop_reference(model, dims: SearchDims, *args):
    """The plain torch version of one kernel launch."""
    return _reference_step(model, dims, args[22].device)(*args)


_N_TABLES = 10  # det_f .. crash_inv


#: the plane tensors last found inert (weak references): every slice of
#: one search passes the same ones, so a search pays the check once
_INERT: list = []


def _check_inert(args) -> None:
    """Refuse reduction planes that are not inert: neither the kernel
    nor its plain version reads them."""
    planes = args[_N_TABLES:_N_TABLES + 5]
    if len(_INERT) == 5 and all(r() is t for r, t in zip(_INERT, planes)):
        return
    det_mpred, det_cpredw, crash_mpred, crash_cpredw, dead_from = planes
    live = torch.stack([(det_mpred != -1).any(), (det_cpredw != 0).any(),
                        (crash_mpred != -1).any(),
                        (crash_cpredw != 0).any(),
                        (dead_from != NEVER_DEAD).any()])
    if bool(live.any()):
        raise ValueError(
            "level_loop: the reduction planes are not inert; a masked or "
            "dedup search runs the torch step (step.py)")
    _INERT[:] = [weakref.ref(t) for t in planes]

#: launch-plan bits: which regions of the kernel's working set sit in
#: shared memory (the rest go to the scratch buffer in device memory)
_IN_SMEM = {"frontier": 1, "tables": 2, "successors": 4, "hash": 8}


def _check_tables(dims: SearchDims, tables, frontier):
    want = ([dims.n_det_pad] * 5 + [dims.n_det_pad + 1]
            + [dims.n_crash_pad] * 4)
    for i, (t, n) in enumerate(zip(tables, want)):
        if (t.device != frontier.device or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != (n,)):
            raise ValueError(
                f"level_loop: table {i} must be a contiguous int32 "
                f"[{n}] tensor on {frontier.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(
                f"level_loop: table {i} must start on a 16-byte boundary "
                "(the kernel's bulk copies need it)")
    if (frontier.dtype != torch.int32 or not frontier.is_contiguous()
            or tuple(frontier.shape) != (dims.frontier, dims.words)):
        raise ValueError(
            f"level_loop: frontier must be a contiguous int32 "
            f"[{dims.frontier}, {dims.words}] tensor, got "
            f"{frontier.dtype} {tuple(frontier.shape)}")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"level_loop {what} failed: "
                           f"{lib.jtt_error_string(rc).decode()} ({rc})")


@functools.lru_cache(maxsize=None)
def _plan(dims: SearchDims, device_index: int) -> dict:
    from .._build import library

    lib = library("level_loop")
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device_index):
        rc = lib.jtt_level_loop_plan(dims.frontier, dims.window,
                                     dims.n_crash_pad, dims.state_width,
                                     dims.n_det_pad, out)
    _raise_on(lib, rc, "plan")
    smem, bits, threads, scratch = (int(v) for v in out)
    return {"smem_bytes": smem, "threads": threads, "scratch_bytes": scratch,
            "in_smem": [k for k, b in _IN_SMEM.items() if bits & b],
            "tables": "shared" if bits & _IN_SMEM["tables"] else "device"}


def launch_plan(dims: SearchDims, device=None) -> dict:
    """The kernel's launch plan at ``dims`` on a CUDA ``device``:
    ``smem_bytes`` of dynamic shared memory, ``threads``,
    ``scratch_bytes`` of device memory, the regions ``in_smem``, and
    ``tables``: "shared" (brought in by bulk copies at launch) or
    "device" (read from device memory)."""
    dev = torch.device(device or "cuda")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return _plan(dims, index)


def level_loop(model, dims: SearchDims, *args):
    """One slice through the CUDA kernel (CUDA tensors) or through
    :func:`level_loop_reference` (CPU tensors).  Returns the carry
    ``(frontier, count, status, configs, max_depth, ovf)``."""
    global LAUNCHES
    frontier = args[22]
    _check_inert(args)
    if frontier.device.type == "cpu":
        return level_loop_reference(model, dims, *args)
    if frontier.device.type != "cuda":
        raise ValueError(f"level_loop: unsupported device {frontier.device}")
    if not eligible(model, dims):
        raise ValueError(f"level_loop: {model.name} at {dims} is not "
                         "eligible for the fused kernel")
    tables = args[:_N_TABLES]
    _check_tables(dims, tables, frontier)
    n_det, n_crash = int(args[15]), int(args[16])
    budget, lvl_cap, bail = int(args[19]), int(args[20]), bool(args[21])
    dev = frontier.device
    plan = launch_plan(dims, dev)
    scal_in = torch.stack([torch.as_tensor(v, device=dev).to(torch.int32)
                           for v in args[23:28]])
    frontier_out = torch.empty_like(frontier)
    scal_out = torch.empty(5, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(16, plan["scratch_bytes"]), dtype=torch.uint8,
                          device=dev)

    from .._build import library

    lib = library("level_loop")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jtt_level_loop(
            *[t.data_ptr() for t in tables], frontier.data_ptr(),
            scal_in.data_ptr(), frontier_out.data_ptr(),
            scal_out.data_ptr(), scratch.data_ptr(), scratch.numel(),
            dims.frontier, dims.window, dims.n_crash_pad, dims.state_width,
            dims.n_det_pad, n_det, n_crash, budget, lvl_cap, int(bail),
            model.kernel_id, stream)
    _raise_on(lib, rc, "kernel launch")
    LAUNCHES += 1
    return (frontier_out, scal_out[0], scal_out[1], scal_out[2],
            scal_out[3], scal_out[4] != 0)


def build_level_loop_fn(model, dims: SearchDims):
    """A step function (the 28-argument signature) backed by
    :func:`level_loop`."""
    return functools.partial(level_loop, model, dims)
