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
  * :func:`level_loop_batch` / :func:`level_loop_batch_reference` —
    the grid-over-keys form: one launch runs one slice of every key of
    a stacked batch, one block per key (the TPU kernel under
    ``jax.vmap``), and its plain version, the same per key.  The kernel
    has this one form; :func:`level_loop` launches it with one key;
  * :func:`launch_plan` — where a launch at these dims keeps its tables
    (shared or device memory), how much scratch it needs per key and
    how many blocks fit one SM;
  * :data:`LAUNCHES`, :data:`BATCH_LAUNCHES` — kernel launches so far,
    single-key and grid form (plain versions excluded), and
    :data:`LAUNCHES_BY_FORM`, the same split by telemetry off and on.

All take ``(model, dims, *step_args)`` where ``step_args`` are the 28
arguments of a step function, stacked along a leading key axis for the
grid form (:func:`~.linearizable.stack_batch`);
:func:`build_level_loop_fn` binds the first two.  With
``telemetry=True`` each launches the kernel's telemetry form (the TPU
kernel's ``telemetry=True`` build) and returns, as a 7th output, the
aux block (``obs/telemetry.py``): int32 ``[TELE_ROWS, TELE_COLS]``, or
``[B, TELE_ROWS, TELE_COLS]`` for the grid form; its plain version is
the torch step's telemetry build.  The carry is the same on and off.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref

import torch

from ..obs.telemetry import TELE_COLS, TELE_ROWS
from . import step
from .encode import NEVER_DEAD, SearchDims
from .step import build_search_step_fn

#: models the kernel's ``model_step`` implements
SAFE_MODELS = frozenset({"register", "cas-register", "mutex", "noop"})

#: kernel launches so far; each launch adds one
LAUNCHES = 0
#: grid-form launches so far (one per batch slice, whatever its keys)
BATCH_LAUNCHES = 0
#: launches so far by (form, telemetry): form "single" or "grid"
LAUNCHES_BY_FORM = {("single", False): 0, ("single", True): 0,
                    ("grid", False): 0, ("grid", True): 0}
#: guards the three counts: the fleet's workers launch from several
#: threads of one process
_COUNT_LOCK = threading.Lock()

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


def _reference_step(model, dims: SearchDims, device: torch.device,
                    telemetry: bool = False):
    key = (model.name, dims, str(device), telemetry)
    fn = _REFERENCE_STEPS.get(key)
    if fn is None:
        fn = _REFERENCE_STEPS[key] = build_search_step_fn(
            model, dims, device, use_allpairs=True, telemetry=telemetry)
    return fn


def level_loop_reference(model, dims: SearchDims, *args,
                         telemetry: bool = False):
    """The plain torch version of one kernel launch (its telemetry
    build with ``telemetry``)."""
    return _reference_step(model, dims, args[22].device, telemetry)(*args)


_N_TABLES = 10  # det_f .. crash_inv


#: the plane tensors last found inert (weak references): every slice of
#: one search passes the same ones, so a search pays the check once
_INERT: list = []


#: the same for the grid form: its stacked planes and per-key counts
_INERT_BATCH: list = []


def _check_inert(args, seen: list = _INERT, extra=()) -> None:
    """Refuse reduction planes that are not inert: neither the kernel
    nor its plain version reads them.  ``extra`` are (tensor, bad mask)
    checks made with them, cached with them in ``seen``."""
    planes = args[_N_TABLES:_N_TABLES + 5]
    watched = tuple(planes) + tuple(t for t, _ in extra)
    if len(seen) == len(watched) and all(
            r() is t for r, t in zip(seen, watched)):
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
    for t, bad in extra:
        if bool(bad.any()):
            raise ValueError(f"level_loop_batch: per-key counts out of "
                             f"range: {t.tolist()}")
    seen[:] = [weakref.ref(t) for t in watched]


#: launch-plan bits: which regions of the kernel's working set sit in
#: shared memory (the rest go to the scratch buffer in device memory)
_IN_SMEM = {"frontier": 1, "tables": 2, "successors": 4, "hash": 8}


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"level_loop {what} failed: "
                           f"{lib.jtt_error_string(rc).decode()} ({rc})")


@functools.lru_cache(maxsize=None)
def _plan(dims: SearchDims, device_index: int, telemetry: bool) -> dict:
    from .._build import library

    lib = library("level_loop")
    out = (ctypes.c_longlong * 5)()
    with torch.cuda.device(device_index):
        rc = lib.jtt_level_loop_plan(dims.frontier, dims.window,
                                     dims.n_crash_pad, dims.state_width,
                                     dims.n_det_pad, int(telemetry), out)
    _raise_on(lib, rc, "plan")
    smem, bits, threads, scratch, blocks = (int(v) for v in out)
    return {"smem_bytes": smem, "threads": threads, "scratch_bytes": scratch,
            "blocks_per_sm": blocks,
            "in_smem": [k for k, b in _IN_SMEM.items() if bits & b],
            "tables": "shared" if bits & _IN_SMEM["tables"] else "device"}


def launch_plan(dims: SearchDims, device=None, *,
                telemetry: bool = False) -> dict:
    """The kernel's launch plan at ``dims`` on a CUDA ``device`` (of its
    telemetry form with ``telemetry``):
    ``smem_bytes`` of dynamic shared memory, ``threads``,
    ``scratch_bytes`` of device memory per key, the regions
    ``in_smem``, ``tables``: "shared" (brought in by bulk copies at
    launch) or "device" (read from device memory), and
    ``blocks_per_sm``, the blocks of this plan one SM holds at once
    (the occupancy query; the grid form runs one block per key)."""
    dev = torch.device(device or "cuda")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return _plan(dims, index, telemetry)


def sfx_stride(dims: SearchDims) -> int:
    """Row stride of the stacked return suffix table: ``n_det_pad + 1``
    entries rounded up to 16 bytes, so every key's row starts where the
    kernel's bulk copies can read it."""
    return (dims.n_det_pad + 1 + 3) // 4 * 4


def _launch(who: str, model, dims: SearchDims, lead: tuple, tables,
            sfx: int, n_det, n_crash, frontier, scal_in, budget, lvl_cap,
            bail, telemetry: bool):
    """One launch of the kernel over the keys of ``frontier``
    (``[*lead, F, words]``; ``lead`` is ``(B,)`` for a stacked batch and
    ``()`` for one key, ``B = 1``): tables ``[*lead, n]`` (the return
    suffix table ``[*lead, sfx]``), ``n_det``/``n_crash`` int32 ``[B]``
    on the card, scalars ``[*lead, 5]``.  Returns ``(frontier_out,
    scal_out, tele)`` shaped as the inputs; ``tele`` is the
    ``[*lead, TELE_ROWS, TELE_COLS]`` block of the telemetry form
    (zeros where a key ran no level), None without ``telemetry``."""
    if frontier.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {frontier.device}")
    if not eligible(model, dims):
        raise ValueError(f"{who}: {model.name} at {dims} is not eligible "
                         "for the fused kernel")
    B = lead[0] if lead else 1
    want = [dims.n_det_pad] * 5 + [sfx] + [dims.n_crash_pad] * 4
    for i, (t, n) in enumerate(zip(tables, want)):
        if (t.device != frontier.device or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != (*lead, n)):
            raise ValueError(
                f"{who}: table {i} must be a contiguous int32 "
                f"{[*lead, n]} tensor on {frontier.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: table {i} must start on a 16-byte "
                             "boundary (the kernel's bulk copies need it)")
    shape = (*lead, dims.frontier, dims.words)
    if (frontier.dtype != torch.int32 or not frontier.is_contiguous()
            or tuple(frontier.shape) != shape):
        raise ValueError(
            f"{who}: frontier must be a contiguous int32 {list(shape)} "
            f"tensor, got {frontier.dtype} {tuple(frontier.shape)}")
    for t in (n_det, n_crash):
        if (t.device != frontier.device or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != (B,)):
            raise ValueError(f"{who}: n_det and n_crash must be contiguous "
                             f"int32 [{B}] tensors on {frontier.device}")
    dev = frontier.device
    plan = launch_plan(dims, dev, telemetry=telemetry)
    frontier_out = torch.empty_like(frontier)
    scal_out = torch.empty((*lead, 5), dtype=torch.int32, device=dev)
    scratch = torch.empty(max(16, B * plan["scratch_bytes"]),
                          dtype=torch.uint8, device=dev)
    # zeros: the kernel adds its rows, and a key that runs no level
    # writes none
    tele = (torch.zeros((*lead, TELE_ROWS, TELE_COLS), dtype=torch.int32,
                        device=dev) if telemetry else None)

    from .._build import library

    lib = library("level_loop")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jtt_level_loop(
            *[t.data_ptr() for t in tables], sfx, n_det.data_ptr(),
            n_crash.data_ptr(), frontier.data_ptr(), scal_in.data_ptr(),
            frontier_out.data_ptr(), scal_out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), B, dims.frontier, dims.window, dims.n_crash_pad,
            dims.state_width, dims.n_det_pad, budget, lvl_cap, int(bail),
            model.kernel_id, stream,
            tele.data_ptr() if telemetry else None)
    _raise_on(lib, rc, "kernel launch")
    return frontier_out, scal_out, tele


@functools.lru_cache(maxsize=64)
def _key_counts(n_det: int, n_crash: int, device: torch.device):
    """A single key's ``n_det``, ``n_crash`` as two int32 ``[1]`` tensors
    on the card, made once per search (every slice passes the same)."""
    t = torch.tensor([n_det, n_crash], dtype=torch.int32, device=device)
    return t[0:1], t[1:2]


def level_loop(model, dims: SearchDims, *args, telemetry: bool = False):
    """One slice through the CUDA kernel (CUDA tensors) or through
    :func:`level_loop_reference` (CPU tensors).  Returns the carry
    ``(frontier, count, status, configs, max_depth, ovf)``, and with
    ``telemetry`` the aux block as a 7th output.  On the card it is the
    grid launch with one key (``B = 1``)."""
    global LAUNCHES
    frontier = args[22]
    _check_inert(args)
    if frontier.device.type == "cpu":
        return level_loop_reference(model, dims, *args, telemetry=telemetry)
    n_det, n_crash = int(args[15]), int(args[16])
    if not (0 <= n_det <= dims.n_det_pad and 0 <= n_crash <= dims.n_crash_pad):
        raise ValueError(f"level_loop: n_det={n_det}, n_crash={n_crash} out "
                         f"of range for {dims}")
    dev = frontier.device
    counts = (_key_counts(n_det, n_crash, dev) if dev.type == "cuda"
              else (None, None))
    scal_in = torch.stack([torch.as_tensor(v, device=dev).to(torch.int32)
                           for v in args[23:28]])
    out, scal, tele = _launch("level_loop", model, dims, (),
                              args[:_N_TABLES], dims.n_det_pad + 1, *counts,
                              frontier, scal_in, int(args[19]),
                              int(args[20]), bool(args[21]), telemetry)
    with _COUNT_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_FORM["single", telemetry] += 1
    carry = (out, scal[0], scal[1], scal[2], scal[3], scal[4] != 0)
    return carry + (tele,) if telemetry else carry


def level_loop_batch_reference(model, dims: SearchDims, *args,
                               telemetry: bool = False):
    """The plain torch version of one grid launch: the all-pairs step
    of :func:`level_loop_reference`, key by key (``step.run_per_key``)."""
    return step.run_per_key(
        _reference_step(model, dims, args[22].device, telemetry), dims,
        *args, telemetry=telemetry)


def level_loop_batch(model, dims: SearchDims, *args,
                     telemetry: bool = False):
    """One slice of every key of a stacked batch: the grid-over-keys
    kernel (CUDA tensors; one block per key) or
    :func:`level_loop_batch_reference` (CPU tensors).  Tables are
    stacked ``[B, n]`` (the return suffix table ``[B, sfx_stride]``),
    the per-key ``n_det``/``n_crash``/``dead_lo``/``dead_tok`` are int32
    ``[B]``, and the carry is ``[B, F, words]`` and five ``[B]``
    tensors.  Returns the stacked carry, and with ``telemetry`` the
    ``[B, TELE_ROWS, TELE_COLS]`` aux blocks as a 7th output."""
    global BATCH_LAUNCHES
    frontier = args[22]
    n_det, n_crash = args[15], args[16]
    _check_inert(args, _INERT_BATCH, extra=(
        (n_det, (n_det < 0) | (n_det > dims.n_det_pad)),
        (n_crash, (n_crash < 0) | (n_crash > dims.n_crash_pad))))
    if frontier.device.type == "cpu":
        return level_loop_batch_reference(model, dims, *args,
                                          telemetry=telemetry)
    scal_in = torch.stack([args[23], args[24], args[25], args[26],
                           args[27].to(torch.int32)], dim=1).contiguous()
    out, scal, tele = _launch(
        "level_loop_batch", model, dims, (frontier.shape[0],),
        args[:_N_TABLES], sfx_stride(dims), n_det, n_crash, frontier,
        scal_in, int(args[19]), int(args[20]), bool(args[21]), telemetry)
    with _COUNT_LOCK:
        BATCH_LAUNCHES += 1
        LAUNCHES_BY_FORM["grid", telemetry] += 1
    carry = (out, scal[:, 0], scal[:, 1], scal[:, 2], scal[:, 3],
             scal[:, 4] != 0)
    return carry + (tele,) if telemetry else carry


def build_level_loop_fn(model, dims: SearchDims, *,
                        telemetry: bool = False):
    """A step function (the 28-argument signature) backed by
    :func:`level_loop`, its telemetry form with ``telemetry``."""
    return functools.partial(level_loop, model, dims, telemetry=telemetry)
