"""The device linearizability search and the ``Linearizable`` checker.

The configuration space (linearized set, model state) is explored
breadth-first on the device: a frontier of configurations is expanded
level by level, deduplicated exactly by dominance, and compacted into the
next level (``step.py``).  The search runs as a sequence of bounded
slices with the search state as an explicit carry, driven from the host
by :func:`_run_kernel`, which moves the frontier width along a
power-of-two ladder: an overflowing level is uncommitted and the search
resumes 4x wider from it; a frontier that stays narrow truncates one
rung down.  Narrow rungs of the four elementwise models run the fused
CUDA level loop (``level_kernel.py``); the rest run the torch step.

An overflow at the widest rung, an exhausted budget, a passed deadline
or a stop request reports "unknown", never a wrong verdict.  Histories
past the device encoding go to the host ``linear`` sweep (``linear.py``).

Every entry point runs the analysis layer in front of its engine, as the
JAX package does by default: the history lint (``analyze/lint.py``),
the static prepass (``analyze/hb.py``, ``analyze/constraints.py``),
which decides some histories with no search and otherwise yields
must-order edges, and DPOR (``analyze/dpor.py``): the edges become the
device search's lane mask and dead register values its dedup
(:func:`~.encode.attach_reductions`).  The fused kernel computes the
unreduced search, so where it would take the starting rung the
reductions are dropped for the whole search
(:func:`_strip_reductions_for_kernel`).  ``audit=True`` replays every
certificate (``analyze/audit.py``).

Every device search carries the reference's telemetry by default
(``telemetry=None`` on every entry point; ``False`` turns it off): its
slice functions also return a per-level aux block, gathered into the
result's ``search_telemetry`` (``obs/telemetry.py``), with
``device.slice`` spans and the ``jtpu_*`` metrics (``obs``).  The
verdict and its certificate are the same either way.

A search can be checkpointed after any slice (:func:`save_checkpoint`
from ``on_slice``) and resumed (:func:`resume_opseq`) in either package:
the file is the JAX package's npz.  :func:`search_batch` checks a batch
of independent keys: one slice of every key per launch of the fused
kernel's grid-over-keys form, or the torch step key by key, through a
ladder of shared rungs, by default bucketed by shape
(``bucket.py``).

:func:`check_competition` races the two exact host engines against the
device search, the default route of :class:`Linearizable` above
``host_threshold`` ops.  :class:`Linearizable` confirms invalid device
verdicts on the host oracle (``seq.py``) over the shortest sound
prefix, which also yields a certificate, and reports every invalid
verdict in ``linear.html`` (``linear_report.py``), led by its shrunk
core (``analyze/shrink.py``).

``decompose=True`` on :func:`search_batch` and :class:`Linearizable`
puts the decomposition layer (``decompose/``) in front: the
canonical-hash verdict cache and, for the checker, the key, value-block
and quiescence splits.

``sharding=`` on :func:`search_batch` spreads the batch of keys over a
mesh of devices (``distributed.py``), and :func:`search_opseq_sharded`
shards one history's frontier over one (``sharded.py``, re-exported
here).
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..analyze.audit import maybe_audit
from ..analyze.dpor import _M_MASK, resolve_dpor
from ..analyze.hb import attach, maybe_hb
from ..analyze.lint import maybe_lint
from ..history import OpSeq, encode_ops
from ..obs import telemetry as _tele
from . import level_kernel
from .encode import (MAX_CRASH, MAX_FRONTIER, MAX_WINDOW, EncodedSearch,
                     SearchDims, _grid_width, _init_carry, _init_config,
                     _next_pow2, _round_up, _widen_carry, attach_reductions,
                     carry_to_device, choose_dims, encode_search,
                     pad_search, search_args, stack_batch, to_numpy)
from .linear import DEFAULT_WITNESS_CAP, check_opseq_linear
from .step import build_search_step_fn, run_per_key

#: statuses
VALID, INVALID, UNKNOWN = 2, 1, 0
_STATUS = {2: True, 1: False, 0: "unknown"}

#: initial BFS levels per device call; the driver adapts from here so
#: each call lands near _SLICE_TARGET_S seconds
_SLICE_LEVELS0 = 32
_SLICE_TARGET_S = 2.0
_SLICE_MAX = 16384


def _resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without an index
    names the current card (``"cuda"`` and ``"cuda:0"`` resolve alike,
    so both find the same slice functions: the device is part of every
    kernel-cache key).  A CUDA device without a card raises: the port
    never drops quietly to the CPU; callers that want the CPU ask for
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _adapt_lvl_cap(lvl_cap: int, dt: float,
                   target_s: float | None = None) -> int:
    """Grow or shrink the per-call level cap toward the target slice
    time."""
    t = _SLICE_TARGET_S if target_s is None else target_s
    if dt < t / 16:
        return min(lvl_cap * 16, _SLICE_MAX)
    if dt < t / 4:
        return min(lvl_cap * 4, _SLICE_MAX)
    if dt < t / 2:
        return min(lvl_cap * 2, _SLICE_MAX)
    if dt > t * 2:
        return max(lvl_cap // 2, 8)
    return lvl_cap


def _use_kernel(model, dims: SearchDims, device: torch.device, *,
                masked: bool = False, dedup: bool = False) -> bool:
    """The fused CUDA level loop takes every eligible rung on the card
    (never one of a search with reductions)."""
    return device.type == "cuda" and level_kernel.eligible(
        model, dims, masked=masked, dedup=dedup)


def _reduction_key(esp: EncodedSearch) -> tuple:
    """(masked, masked_crash, dedup): the reduction part of the slice
    function's cache key.  The dead table's width is not in it, as it
    is in the JAX package's: the torch step traces no shapes."""
    return bool(esp.masked), bool(esp.mask_has_crash), bool(esp.dedup)


def _strip_reductions_for_kernel(es: EncodedSearch, model,
                                 dims: SearchDims,
                                 device: torch.device) -> EncodedSearch:
    """Where :func:`_use_kernel` picks the fused kernel at the starting
    dims, drop the must-order mask and the dedup for the whole search,
    as the JAX package does for its Pallas kernel: both are optional
    prunes, and the kernel computes the unreduced search.  Elsewhere
    they stay and the torch step reads them."""
    if (es.masked or es.dedup) and _use_kernel(model, dims, device):
        es.det_mpred = es.det_cpred = None
        es.crash_mpred = es.crash_cpred = None
        es.det_cpredw = es.crash_cpredw = None
        es.dead_from = None
        es.dead_lo = es.dead_tok = 0
        es.masked = es.mask_has_crash = es.dedup = False
    return es


_STEP_CACHE: dict = {}

#: slice-function cache hits and misses (single and batch)
KERNEL_CACHE_STATS = {"hits": 0, "misses": 0}
#: guards KERNEL_CACHE_STATS: a fleet's workers look up from several
#: threads of one process
_KCACHE_LOCK = threading.Lock()

#: the registry's twin of KERNEL_CACHE_STATS
_M_KCACHE = obs.REGISTRY.counter(
    "jtpu_kernel_cache_total",
    "Compiled-kernel cache lookups (hit/miss)", ("event",))


def kernel_cache_stats() -> dict:
    """A copy of :data:`KERNEL_CACHE_STATS`."""
    return dict(KERNEL_CACHE_STATS)


def _cached(key, build, model, dims: SearchDims, use_k: bool,
            engine: str | None = None, **coords):
    """The cached slice function under ``key``; a miss builds it inside
    a ``device.compile`` span carrying the cache key's coordinates
    (``engine``: the span's engine, by default "cuda" or "torch" as
    ``use_k`` says)."""
    fn = _STEP_CACHE.get(key)
    hit = fn is not None
    with _KCACHE_LOCK:
        KERNEL_CACHE_STATS["hits" if hit else "misses"] += 1
    _M_KCACHE.inc(event="hit" if hit else "miss")
    if fn is None:
        with _tele.compile_span(
                engine=engine or ("cuda" if use_k else "torch"),
                frontier=dims.frontier, n_det_pad=dims.n_det_pad,
                n_crash_pad=dims.n_crash_pad, window=dims.window, k=dims.k,
                model=model.name, model_init=int(model.init[0]),
                model_width=model.state_width, **coords):
            fn = _STEP_CACHE[key] = build()
    return fn


def get_kernel(model, dims: SearchDims, device: torch.device, *,
               masked: bool = False, masked_crash: bool = False,
               dedup: bool = False, telemetry: bool = False):
    """The slice function for (model, dims) on ``device`` and the
    search's reductions: the CUDA level loop where :func:`_use_kernel`
    says so, else the torch step; their telemetry builds with
    ``telemetry`` (a 7th output, the aux block)."""
    from . import step

    use_k = _use_kernel(model, dims, device, masked=masked, dedup=dedup)
    key = (model.name, dims, str(device), step._DOMINANCE_MODE, use_k,
           masked, masked_crash, dedup, telemetry)
    return _cached(key, lambda: (
        level_kernel.build_level_loop_fn(model, dims, telemetry=telemetry)
        if use_k
        else build_search_step_fn(model, dims, device, masked=masked,
                                  masked_crash=masked_crash, dedup=dedup,
                                  telemetry=telemetry)),
        model, dims, use_k, masked=masked, masked_crash=masked_crash,
        dedup=dedup, telemetry=telemetry)


#: the active single-key slice driver's "a slice ran the fused kernel"
#: flag, set around each ``on_slice`` call (thread-local: the race runs
#: the device leg in a thread); :func:`save_checkpoint` records it, as
#: the JAX package's ``_RUN_PALLAS``.  None outside a driver.
_RUN_KERNEL = threading.local()


def _run_kernel(esp, es, model, dims: SearchDims, budget: int, device, *,
                on_slice=None, resume=None, used_kernel0: bool = False,
                deadline: float | None = None, stop=None,
                telemetry: bool = True):
    """Drive the sliced search to completion with an adaptive width.

    Escalation climbs two grid steps (4x) from the level that
    overflowed (the slice uncommits it under ``bail``); the downshift
    settles one step at a time, after two consecutive slices fit the
    lower rung.  ``deadline`` (``time.perf_counter()`` clock) and
    ``stop`` (a ``threading.Event``) are tested after every slice and
    end the search as "unknown".  ``on_slice(carry, dims)`` runs after
    every slice (the checkpoint hook); ``resume`` is a carry to start
    from, at ``dims.frontier`` width.

    Each slice runs in a ``device.slice`` span and its wall seconds feed
    ``jtpu_device_seconds_total``.  With ``telemetry`` the slices run
    their telemetry builds and their aux blocks gather into a
    :class:`~..obs.telemetry.SearchTelemetry`.

    Returns (status, configs, max_depth, dims, used_kernel, acc): status
    is final (-1 never escapes), dims carries the final width,
    ``used_kernel`` says whether any slice ran the CUDA level loop, or
    ``used_kernel0`` (a resumed search's earlier slices) was set, and
    ``acc`` is the telemetry (None without ``telemetry``)."""
    args = search_args(esp, es, device=device)
    masked, masked_crash, dedup = _reduction_key(esp)
    carry = carry_to_device(
        resume if resume is not None else _init_carry(dims, model), device)
    F = dims.frontier
    lvl_cap = _SLICE_LEVELS0
    first = True
    low_streak = 0  # consecutive slices whose live width fit a lower rung
    used_kernel = used_kernel0
    timed_out = False
    acc = _tele.SearchTelemetry() if telemetry else None
    while True:
        bail = F < MAX_FRONTIER
        use_k = _use_kernel(model, dims, device, masked=masked, dedup=dedup)
        fn = get_kernel(model, dims, device, masked=masked,
                        masked_crash=masked_crash, dedup=dedup,
                        telemetry=telemetry)
        t0 = time.perf_counter()
        with obs.span("device.slice", cat="device", frontier=F,
                      levels=lvl_cap, first=first):
            res = fn(*args, budget, lvl_cap, bail, *carry)
            carry = res[:6]
            status = int(carry[2])  # waits for the slice
        dt = time.perf_counter() - t0
        _tele.record_device_seconds(dt)
        if acc is not None:
            acc.add_slice(res[6].cpu().numpy(), t0, t0 + dt, frontier=F)
        used_kernel = used_kernel or use_k
        if on_slice is not None:
            _RUN_KERNEL.flag = used_kernel
            try:
                on_slice(carry, dims)
            finally:
                _RUN_KERNEL.flag = None
        count = int(carry[1])
        configs = int(carry[3])
        ovf = bool(carry[5])
        if status != -1 or count <= 0 or configs >= budget:
            break
        if deadline is not None and time.perf_counter() > deadline:
            timed_out = True
            break
        if stop is not None and stop.is_set():
            timed_out = True
            break
        if bail and ovf:
            # the carry is the last clean state: resume 4x wider from it
            new_f = _grid_width(F * 4, device)
            carry = _widen_carry(carry[:5] + (torch.zeros_like(carry[5]),),
                                 F, new_f)
            low_streak = 0
            lvl_cap = max(8, lvl_cap * F // new_f)
            F = new_f
            dims = SearchDims(**{**dims.__dict__, "frontier": F})
            first = True
            continue
        if not first:
            # shorter slices while wide, so the downshift check comes
            # round sooner after a burst
            lvl_cap = _adapt_lvl_cap(
                lvl_cap, dt, target_s=(_SLICE_TARGET_S if F <= 512
                                       else _SLICE_TARGET_S / 4))
        first = False
        if not ovf and count > 0:
            # 4x headroom over the live width, one grid step at a time,
            # after two consecutive slices fit the lower rung
            new_f = max(_grid_width(4 * count, device), F // 2)
            low_streak = low_streak + 1 if new_f < F else 0
            if new_f < F and low_streak >= 2:
                low_streak = 0
                # live rows sit at the frontier's prefix: truncate
                carry = (carry[0][:new_f].contiguous(),) + tuple(carry[1:])
                lvl_cap = min(_SLICE_MAX, lvl_cap * (F // new_f))
                F = new_f
                dims = SearchDims(**{**dims.__dict__, "frontier": F})
                first = True
    if status == -1:
        # died out with no goal: invalid unless it ever overflowed;
        # budget exhausted, deadline passed or stopped: unknown
        status = UNKNOWN if timed_out or count > 0 or ovf else INVALID
    return status, configs, int(carry[4]), dims, used_kernel, acc


def greedy_witness(seq: OpSeq, model) -> bool:
    """Try one linearization on the host: ok ops in completion order,
    crashed ops skipped.  Real-time consistent by construction, so a
    legal replay is a valid witness."""
    state = model.init
    for i in sorted(range(len(seq)), key=lambda i: int(seq.ret[i])):
        if not bool(seq.ok[i]):
            continue
        state = model.pystep(state, int(seq.f[i]), int(seq.v1[i]),
                             int(seq.v2[i]))
        if state is None:
            return False
    return True


def greedy_linearization(seq: OpSeq) -> list[int]:
    """The certificate behind a True :func:`greedy_witness`."""
    return [i for i in sorted(range(len(seq)),
                              key=lambda i: int(seq.ret[i]))
            if bool(seq.ok[i])]


#: certificate drop reasons of the device search (it keeps no parent
#: chains; Linearizable re-derives witnesses on the host)
WITNESS_DROPPED_DEVICE = (
    "device-bfs keeps no parent chains; re-check with the host "
    "`linear` engine (witness_cap > 0) for a witness")
FRONTIER_DROPPED_DEVICE = (
    "device-bfs localizes the obstruction by depth/window only; "
    "Linearizable re-verifies invalid device verdicts host-side to "
    "extract the frontier")


def _engine_label(used_kernel: bool, resumed: bool = False,
                  base: str = "device-bfs") -> str:
    """The device engines' labels: ``base``, tagged ``cuda`` when a slice
    ran the fused kernel and ``resumed`` for a resumed search."""
    tags = [t for t, on in (("cuda", used_kernel), ("resumed", resumed))
            if on]
    return base + (f"({','.join(tags)})" if tags else "")


#: "the caller did not run the prepass" (a caller's result may be None)
_HB_UNSET = object()


def search_opseq(seq: OpSeq, model, *, budget: int = 20_000_000,
                 dims: SearchDims | None = None, device="cuda",
                 on_slice=None, deadline: float | None = None, stop=None,
                 lint: bool | None = None, audit: bool | None = None,
                 hb: bool | None = None, dpor: bool | None = None,
                 telemetry: bool | None = None,
                 _hbres=_HB_UNSET) -> dict:
    """Check one columnar history on ``device``.  Returns
    ``{"valid": True|False|"unknown", "configs", "max_depth", "engine",
    "frontier", "window", "concurrency"}`` plus certificate fields:
    greedy and trivial verdicts carry their ``linearization``, device
    verdicts ``witness_dropped``/``frontier_dropped`` reasons.  A
    history past the device encoding (``MAX_WINDOW``, ``MAX_CRASH``)
    is checked by the host ``linear`` sweep, engine
    "host-linear(fallback)".

    ``on_slice(carry, dims)`` runs after every slice: the checkpoint
    hook (:func:`save_checkpoint`, :func:`resume_opseq`).  ``deadline``
    (``time.perf_counter()`` clock) and ``stop`` (a ``threading.Event``,
    how the competition race retires the device leg) end the search as
    "unknown" between slices.

    ``lint`` (None: on) lints the history first.  ``hb`` (None: on) runs
    the static prepass: a decided history returns at once with its
    certificate and 0 configs (engine "hb-decide" or
    "constraint-decide").  ``dpor`` (None: on) ships the prepass's
    must-order edges and the dead-value table to the device search as
    reduction planes, and adds ``dpor`` stats to the result
    (``device_masked``, ``device_mask_rows``, ``dedup``).  ``audit=True``
    replays the certificate.  ``telemetry`` (None: on) adds the device
    search's ``search_telemetry`` block (``obs/telemetry.py``); a
    history the prepass decides gets only its ``search.telemetry`` span.
    ``_hbres`` is a prepass result the caller already has (the batch's
    fallback)."""
    dev = _resolve_device(device)
    tele_on = _tele.resolve(telemetry)
    maybe_lint(seq, model, lint)
    hbres = maybe_hb(seq, model, hb, dpor) if _hbres is _HB_UNSET \
        else _hbres

    def finish(out: dict) -> dict:
        return maybe_audit(seq, model, attach(out, hbres), audit)

    if hbres is not None and hbres.decided is not None:
        return _tele.emit_decided(
            maybe_audit(seq, model, dict(hbres.decided), audit),
            hbres=hbres, telemetry=tele_on)
    es = encode_search(seq)
    if es.n_det == 0 and es.n_crash == 0:
        return finish({"valid": True, "configs": 0, "max_depth": 0,
                       "engine": "trivial", "linearization": []})
    if greedy_witness(seq, model):
        return finish({"valid": True, "configs": es.n_det,
                       "max_depth": es.n_det, "engine": "greedy-witness",
                       "linearization": greedy_linearization(seq)})
    if es.window > MAX_WINDOW or es.n_crash > MAX_CRASH:
        # the linear sweep has no window or crash caps, and dominates the
        # WGL search on the crash-heavy histories that land here
        out = check_opseq_linear(seq, model, deadline=deadline, cancel=stop,
                                 lint=False, hb=hb, dpor=dpor)
        out["engine"] = "host-linear(fallback)"
        return finish(out)
    dims = dims or choose_dims(es, model, device=dev)
    dpor_stats = None
    if resolve_dpor(dpor):
        attach_reductions(es, seq, model,
                          hbres.must_pred if hbres is not None else None,
                          dedup=True)
        _strip_reductions_for_kernel(es, model, dims, dev)
        n_mask_rows = 0
        if es.det_mpred is not None:
            n_mask_rows = int(
                ((es.det_mpred[:, 0] >= 0) | (es.det_cpred != 0)).sum()
                + ((es.crash_mpred[:, 0] >= 0)
                   | (es.crash_cpred != 0)).sum())
        dpor_stats = {"enabled": True, "device_masked": es.masked,
                      "device_mask_rows": n_mask_rows, "dedup": es.dedup}
        if es.masked:
            _M_MASK.inc(n_mask_rows, site="device-rows")
    esp = pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    status, configs, max_depth, dims, used_kernel, acc = _run_kernel(
        esp, es, model, dims, budget, dev, on_slice=on_slice,
        deadline=deadline, stop=stop, telemetry=tele_on)
    out = {"valid": _STATUS[status], "configs": configs,
           "max_depth": max_depth, "engine": _engine_label(used_kernel),
           "frontier": dims.frontier, "window": es.window,
           "concurrency": es.concurrency}
    if dpor_stats is not None:
        out["dpor"] = dpor_stats
    if out["valid"] is True:
        out["witness_dropped"] = WITNESS_DROPPED_DEVICE
    elif out["valid"] is False:
        out["frontier_dropped"] = FRONTIER_DROPPED_DEVICE
    _tele.finalize_result(out, acc, hbres=hbres, device=dev)
    return finish(out)


def check_competition(seq: OpSeq, model, *, budget: int = 20_000_000,
                      max_configs: int = 50_000_000, device="cuda",
                      lint: bool | None = None, audit: bool | None = None,
                      hb: bool | None = None, dpor: bool | None = None,
                      telemetry: bool | None = None) -> dict:
    """Race the two exact host engines against the device search; the
    first conclusive verdict wins and retires the losers (knossos'
    ``competition``).  The WGL DFS (``seq.py``) can dive straight to a
    witness on a well-behaved history, the ``linear`` sweep decides
    crash-heavy histories, the device search sweeps wide state spaces.

    The host legs run in daemon threads and lose quietly when they
    raise; the device leg runs in the calling thread, and its exception
    (a kernel that fails to build or launch) retires the host legs and
    propagates: they never win in its place.  ``device`` is resolved
    before any host leg starts.  Past the device encoding the host legs
    decide alone.  The winner's certificate comes with its verdict.

    ``max_configs`` caps each host leg's configurations, at most what
    fits about 4 GB of the WGL leg's memo.  One lint at the race's
    boundary (``lint``, None: on); the legs run without it, each with
    its own prepass and reductions (``hb``, ``dpor``).  ``telemetry``
    goes to the device leg (:func:`search_opseq`).  ``audit=True``
    replays the winner's certificate."""
    from . import seq as seqmod

    dev = _resolve_device(device)
    maybe_lint(seq, model, lint)

    def finish(out: dict) -> dict:
        return maybe_audit(seq, model, out, audit)

    # the WGL DFS memoizes each configuration twice (visited and
    # parents) as a (bigint set, state) pair: cap it to about 4 GB, so a
    # loser thread cannot eat the host while the device works
    per_cfg = 2 * (len(seq) // 8 + 200)
    max_configs = min(max_configs, 4_000_000_000 // per_cfg)

    done = threading.Event()
    lock = threading.Lock()
    result: dict = {}

    def submit(r: dict, engine: str) -> bool:
        """Claim the race for a conclusive verdict."""
        if r.get("valid") == "unknown":
            return False
        with lock:
            if result:
                return False
            result.update(r)
            result["engine"] = engine
            done.set()
            return True

    def wgl_leg():
        try:
            r = seqmod.check_opseq(seq, model, max_configs=max_configs,
                                   cancel=done, lint=False, hb=hb,
                                   dpor=dpor)
        except Exception:  # noqa: BLE001 — a loser's error must not win
            return
        submit(r, "competition(host-wgl)")

    def linear_leg():
        try:
            r = check_opseq_linear(seq, model, max_configs=max_configs,
                                   cancel=done,
                                   witness_cap=DEFAULT_WITNESS_CAP,
                                   lint=False, hb=hb, dpor=dpor)
        except Exception:  # noqa: BLE001
            return
        submit(r, "competition(host-linear)")

    threads = [threading.Thread(target=wgl_leg, daemon=True,
                                name="competition-host-wgl"),
               threading.Thread(target=linear_leg, daemon=True,
                                name="competition-host-linear")]
    for t in threads:
        t.start()

    es = encode_search(seq)
    if es.window > MAX_WINDOW or es.n_crash > MAX_CRASH:
        # the device leg would fall back to the host sweep itself
        for t in threads:
            t.join()
        with lock:
            if result:
                out = dict(result)
                out["engine"] += "+device-skipped(encoding limits)"
                return finish(out)
        return {"valid": "unknown", "configs": 0,
                "engine": "competition(exhausted; device encoding limits)"}

    try:
        dev_out = search_opseq(seq, model, budget=budget, device=dev,
                               stop=done, lint=False, hb=hb, dpor=dpor,
                               telemetry=telemetry)
    except BaseException:
        done.set()
        for t in threads:
            t.join(timeout=5.0)
        raise
    submit(dev_out, "competition(device)")
    if not result:
        # the device leg gave up: the race ends when the hosts' own
        # bounded searches end too
        for t in threads:
            t.join()
    else:
        done.set()  # retire the losers
        for t in threads:
            t.join(timeout=5.0)
    with lock:
        if result:
            return finish(dict(result))
    return {**dev_out, "engine": "competition(exhausted)"}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def history_digest(seq: OpSeq, model) -> str:
    """Identity of (history, model), so a checkpoint never resumes on
    another history; the model's parameters bind too (register(0) and
    register(7) share a name).  The same digest as the JAX package's:
    the two packages' columns have the same dtypes."""
    import hashlib

    h = hashlib.sha256()
    for a in (seq.f, seq.v1, seq.v2, seq.inv, seq.ret, seq.ok):
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    h.update(model.name.encode())
    h.update(repr((model.init, model.state_width)).encode())
    return h.hexdigest()


def save_checkpoint(path: str, carry, dims: SearchDims, model,
                    budget: int, seq: OpSeq | None = None) -> None:
    """Write a live search carry (as ``on_slice`` receives it) to
    ``path``: the JAX package's npz, key for key, so either package
    resumes what the other wrote.  ``seq`` binds it to its history.
    ``used_pallas`` records whether a slice of the search so far ran the
    fused kernel (here the CUDA level loop), read from the active slice
    driver; False outside one."""
    c = to_numpy(carry)
    digest = history_digest(seq, model) if seq is not None else ""
    used = getattr(_RUN_KERNEL, "flag", None)
    np.savez_compressed(
        path, frontier=np.asarray(c[0], np.int32),
        count=np.int32(c[1]), status=np.int32(c[2]),
        configs=np.int32(c[3]), max_depth=np.int32(c[4]),
        ovf=np.bool_(c[5]), budget=np.int64(budget),
        model=np.bytes_(model.name.encode()),
        digest=np.bytes_(digest.encode()),
        used_pallas=np.bool_(bool(used)),
        dims=np.asarray([dims.n_det_pad, dims.n_crash_pad, dims.window,
                         dims.k, dims.state_width, dims.frontier],
                        np.int64))


def load_checkpoint(path: str):
    """Returns (carry, dims, model_name, budget, digest, used_kernel)."""
    z = np.load(path)
    d = z["dims"]
    dims = SearchDims(n_det_pad=int(d[0]), n_crash_pad=int(d[1]),
                      window=int(d[2]), k=int(d[3]), state_width=int(d[4]),
                      frontier=int(d[5]))
    carry = (z["frontier"], z["count"][()], z["status"][()],
             z["configs"][()], z["max_depth"][()], z["ovf"][()])
    digest = bytes(z["digest"][()]).decode() if "digest" in z else ""
    used = bool(z["used_pallas"][()]) if "used_pallas" in z else False
    return (carry, dims, bytes(z["model"][()]).decode(), int(z["budget"]),
            digest, used)


def resume_opseq(seq: OpSeq, model, path: str, *, device="cuda",
                 on_slice=None, deadline: float | None = None,
                 stop=None, telemetry: bool | None = None) -> dict:
    """Continue a search from :func:`save_checkpoint`'s file.  A model or
    history other than the checkpoint's raises.  ``on_slice``,
    ``deadline``, ``stop`` and ``telemetry`` as in :func:`search_opseq`:
    a resumed search stopped again is again a checkpoint, and its
    ``search_telemetry`` covers the resumed slices.  The engine label
    gains ``resumed``."""
    dev = _resolve_device(device)
    carry, dims, model_name, budget, digest, prior = load_checkpoint(path)
    if model_name != model.name:
        raise ValueError(
            f"checkpoint is for model {model_name!r}, got {model.name!r}")
    if digest and digest != history_digest(seq, model):
        raise ValueError(
            "checkpoint was taken on a different history (digest mismatch)")
    es = encode_search(seq)
    esp = pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    status, configs, max_depth, dims, used_kernel, acc = _run_kernel(
        esp, es, model, dims, budget, dev, on_slice=on_slice, resume=carry,
        used_kernel0=prior, deadline=deadline, stop=stop,
        telemetry=_tele.resolve(telemetry))
    out = {"valid": _STATUS[status], "configs": configs,
           "max_depth": max_depth,
           "engine": _engine_label(used_kernel, resumed=True),
           "frontier": dims.frontier, "window": es.window,
           "concurrency": es.concurrency}
    return _tele.finalize_result(out, acc, device=dev)


# ---------------------------------------------------------------------------
# the batch of independent keys
# ---------------------------------------------------------------------------

#: widest shared-batch rung; keys that overflow it go solo
#: (:func:`search_opseq`'s ladder resumes them up to MAX_FRONTIER)
BATCH_FRONTIER_CAP = 512


def batch_dims(ess: list[EncodedSearch], model, *,
               frontier: int = 32) -> SearchDims:
    """Dims covering every key of a batch.  The shared frontier starts
    narrow, sized for the typical key: keys that outgrow a rung climb
    together through 4x-wider rungs up to :data:`BATCH_FRONTIER_CAP`."""
    W = _round_up(max(e.window for e in ess), 32)
    ncr = max(e.n_crash for e in ess)
    NC = _round_up(ncr, 32) if ncr else 32
    K = _next_pow2(max(1, min(max(e.concurrency for e in ess), W + ncr)))
    nd = max(64, _next_pow2(max(e.n_det for e in ess)))
    return SearchDims(n_det_pad=nd, n_crash_pad=NC, window=W, k=K,
                      state_width=model.state_width, frontier=frontier)


def batch_dead_pad(ess: list[EncodedSearch]) -> int:
    """The dead-table width a batch pads its keys to (stacked shapes
    agree; keys without a table stack the inert 8-entry one)."""
    w = 8
    for e in ess:
        if e.dead_from is not None:
            w = max(w, _next_pow2(len(e.dead_from)))
    return w


def _init_batch_carry(n: int, dims: SearchDims, model, device) -> tuple:
    """Stacked fresh carries of n keys on ``device``."""
    frontier = np.zeros((n, dims.frontier, dims.words), np.int32)
    frontier[:, 0] = _init_config(dims, model)
    dev = torch.device(device)
    i32 = torch.int32
    return (torch.as_tensor(frontier, device=dev),
            torch.ones(n, dtype=i32, device=dev),
            torch.full((n,), -1, dtype=i32, device=dev),
            torch.zeros(n, dtype=i32, device=dev),
            torch.zeros(n, dtype=i32, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev))


def pad_batch_carry(carry, pad: int, dims: SearchDims, model,
                    device) -> tuple:
    """A stacked carry with ``pad`` inert lanes appended: status VALID,
    count 0, so they do nothing."""
    if not pad:
        return carry
    blank = _init_batch_carry(pad, dims, model, device)
    blank = (torch.zeros_like(blank[0]), torch.zeros_like(blank[1]),
             torch.full_like(blank[2], VALID)) + blank[3:]
    return tuple(torch.cat([c, p]) for c, p in zip(carry, blank))


def get_batch_kernel(model, dims: SearchDims, device: torch.device, *,
                     masked: bool = False, masked_crash: bool = False,
                     dedup: bool = False, telemetry: bool = False):
    """The batch slice function for (model, dims) on ``device``: the
    fused kernel's grid over keys where :func:`_use_kernel` says so,
    else the torch step key by key (``step.run_per_key``; other models,
    masked or dedup batches, rungs past the kernel's range).  Each key's
    result equals its solo run's, as each lane of the JAX package's
    vmapped step does.  With ``telemetry`` the keys' aux blocks come
    back stacked as a 7th output."""
    from . import step

    use_k = _use_kernel(model, dims, device, masked=masked, dedup=dedup)
    key = ("batch", model.name, dims, str(device), step._DOMINANCE_MODE,
           use_k, masked, masked_crash, dedup, telemetry)

    def build():
        if use_k:
            return functools.partial(level_kernel.level_loop_batch, model,
                                     dims, telemetry=telemetry)
        fn = build_search_step_fn(model, dims, device, masked=masked,
                                  masked_crash=masked_crash, dedup=dedup,
                                  telemetry=telemetry)
        return functools.partial(run_per_key, fn, dims,
                                 telemetry=telemetry)

    return _cached(key, build, model, dims, use_k, batch=True,
                   masked=masked, masked_crash=masked_crash, dedup=dedup,
                   telemetry=telemetry)


# ---------------------------------------------------------------------------
# kernel routes: the device contract's enumeration
# ---------------------------------------------------------------------------
# Every way a slice function can be requested is one ROUTE: the torch
# step, the fused CUDA level loop (B1) for one key and as a grid over the
# keys of a bucketed batch, the sharded search (B7) and the sharded batch
# (B8).  ``analyze/devlint.py`` runs one slice of each route under an op
# recorder and holds it to the K-codes; the declared fields are the
# contract it checks the live code against.


@dataclass(frozen=True)
class KernelRoute:
    """One slice-function dispatch route and its device contract.

    ``build(model, dims, device)`` returns ``(fn, args)``: the slice
    function the route's driver calls and the exact positional arguments
    it passes (Python ints where the driver passes them), so one slice
    runs as the driver runs it.  ``args[lvl_cap_arg]`` is the slice's
    level cap and the last ``carry_args`` arguments are the carry.
    ``request(model, dims, device)`` goes through the real cached getter
    (``getter`` in ``module``), so a fresh process emits the route's
    ``device.compile`` span for the K007 coordinate check.

    ``int_only`` (K002: no float) and ``donate_carry`` (the K004 policy:
    the slice drivers keep each pre-overflow carry and re-feed it
    widened after a frontier escalation, so a slice must not write into
    its carry arguments) keep their defaults on every shipped route;
    they are the reference's route contract, which devlint's toy routes
    exercise."""

    name: str
    span_kind: str     # the compile span's coordinate model (devlint K007)
    getter: str        # the cached getter's name
    module: str        # the dotted module defining the getter
    build: object      # (model, dims, device) -> (fn, args)
    request: object    # (model, dims, device) -> fn via the cache
    int_only: bool = True
    donate_carry: bool = False
    carry_args: int = 6
    lvl_cap_arg: int = 20


KERNEL_ROUTES: dict[str, KernelRoute] = {}


def register_route(route: KernelRoute) -> KernelRoute:
    KERNEL_ROUTES[route.name] = route
    return route


#: determinate ops of the sample history after its one crashed op: a
#: slice of it runs every level up to this depth, with a crash closure
#: at each, so a per-level cost shows at the level caps devlint runs
ROUTE_SAMPLE_OPS = 16

#: representative key count of the batch routes, and shards of the mesh
#: routes (logical shards of one device)
_ROUTE_BATCH = 4
_ROUTE_SHARDS = 2


def _route_sample_search(model, dims: SearchDims):
    """The encoded sample history of every route: one crashed op, then
    :data:`ROUTE_SAMPLE_OPS` sequential ones, of the model's first
    update function (the JAX package stages a one-op history: a staged
    program has no levels to run)."""
    from ..history import invoke_op, ok_op

    fc = model.f_codes
    try:
        names = list(fc)
    except TypeError:  # the noop model's codes accept anything
        names = ["write"]
    f = next((c for c in ("write", "enqueue", "acquire") if c in names),
             names[0])

    def value(i):
        return i % 5 + 1 if f == "write" else i if f == "enqueue" else None

    h = [invoke_op(0, f, value(0))]
    for i in range(1, ROUTE_SAMPLE_OPS + 1):
        h += [invoke_op(1, f, value(i)), ok_op(1, f, value(i))]
    es = encode_search(encode_ops(h, fc))
    return es, pad_search(es, dims.n_det_pad, dims.n_crash_pad)


def route_sample_inputs(model, dims: SearchDims, device, *, batch: int = 0):
    """The positional arguments a route's driver passes at ``dims`` for
    the sample history (:func:`_route_sample_search`): ``(*tables,
    n_det, n_crash, dead_lo, dead_tok, budget, lvl_cap, bail, *carry)``
    on ``device``, with a budget no slice reaches, 4 levels and no bail.
    ``batch > 0`` stacks the batch routes' form of that many keys."""
    es, esp = _route_sample_search(model, dims)
    tail = (1 << 24, 4, False)
    if batch:
        return (stack_batch([esp] * batch, device=device) + tail
                + _init_batch_carry(batch, dims, model, device))
    return (search_args(esp, es, device=device) + tail
            + carry_to_device(_init_carry(dims, model), device))


_ROUTE_TELEMETRY = True  # the drivers' default


def _build_single_torch(model, dims: SearchDims, device):
    fn = build_search_step_fn(model, dims, device, masked=True,
                              masked_crash=True, telemetry=_ROUTE_TELEMETRY)
    return fn, route_sample_inputs(model, dims, device)


def _request_single_torch(model, dims: SearchDims, device):
    return get_kernel(model, dims, device, masked=True, masked_crash=True,
                      telemetry=_ROUTE_TELEMETRY)


def _build_fused(model, dims: SearchDims, device):
    fn = level_kernel.build_level_loop_fn(model, dims,
                                          telemetry=_ROUTE_TELEMETRY)
    return fn, route_sample_inputs(model, dims, device)


def _request_fused(model, dims: SearchDims, device):
    return get_kernel(model, dims, device, telemetry=_ROUTE_TELEMETRY)


def _build_batch(model, dims: SearchDims, device):
    fn = functools.partial(level_kernel.level_loop_batch, model, dims,
                           telemetry=_ROUTE_TELEMETRY)
    return fn, route_sample_inputs(model, dims, device, batch=_ROUTE_BATCH)


def _request_batch(model, dims: SearchDims, device):
    return get_batch_kernel(model, dims, device, telemetry=_ROUTE_TELEMETRY)


def _route_mesh(device):
    from ..distributed import ShardMesh

    return ShardMesh([device] * _ROUTE_SHARDS)


def _build_window_sharded(model, dims: SearchDims, device):
    """B7 at ``dims.frontier`` rows per shard, its root on shard 0."""
    mesh = _route_mesh(device)
    D = mesh.size
    fn = _request_window_sharded(model, dims, device)
    args = route_sample_inputs(model, dims, device)
    frontier = torch.zeros((D * dims.frontier, dims.words),
                           dtype=torch.int32, device=device)
    frontier[0] = torch.as_tensor(_init_config(dims, model), device=device)
    count = torch.zeros(D, dtype=torch.int32, device=device)
    count[0] = 1
    i32 = torch.int32
    carry = (frontier, count,
             *(torch.tensor(v, dtype=i32, device=device) for v in (-1, 0, 0)),
             torch.tensor(False, device=device),
             torch.tensor(1, dtype=i32, device=device))
    return fn, args[:22] + carry


def _request_window_sharded(model, dims: SearchDims, device):
    from .sharded import get_sharded_search_kernel

    return get_sharded_search_kernel(model, dims, _route_mesh(device),
                                     telemetry=_ROUTE_TELEMETRY)


def _build_mesh_sharded(model, dims: SearchDims, device):
    """B8: each logical shard a block of the batch, its own carry."""
    mesh = _route_mesh(device)
    per = _ROUTE_BATCH // mesh.size
    fn = _request_mesh_sharded(model, dims, device)
    full = route_sample_inputs(model, dims, device, batch=_ROUTE_BATCH)
    shard_args = [tuple(t[s * per:(s + 1) * per] for t in full[:19])
                  for s in range(mesh.size)]
    carries = [_init_batch_carry(per, dims, model, device)
               for _ in range(mesh.size)]
    return fn, (shard_args, *full[19:22], carries)


def _request_mesh_sharded(model, dims: SearchDims, device):
    from .sharded import get_sharded_batch_kernel

    return get_sharded_batch_kernel(model, dims, batch=_ROUTE_BATCH,
                                    mesh=_route_mesh(device),
                                    telemetry=_ROUTE_TELEMETRY)


register_route(KernelRoute(
    name="single-torch", span_kind="solo",
    getter="get_kernel", module=__name__,
    build=_build_single_torch, request=_request_single_torch))
register_route(KernelRoute(
    name="cuda-fused", span_kind="solo",
    getter="get_kernel", module=__name__,
    build=_build_fused, request=_request_fused))
register_route(KernelRoute(
    name="window-sharded", span_kind="window-sharded",
    getter="get_sharded_search_kernel",
    module=__name__.rsplit(".", 1)[0] + ".sharded",
    build=_build_window_sharded, request=_request_window_sharded,
    carry_args=7))
# the two batch routes are dispatched by the bucket scheduler, which
# registers them on import (checker/bucket.py; kernel_routes() below
# forces that import so the enumeration is always complete)


def kernel_routes() -> dict[str, KernelRoute]:
    """All registered routes (importing the bucket scheduler so its
    batch and mesh registrations are in)."""
    from . import bucket  # noqa: F401 — registers its routes on import

    return dict(KERNEL_ROUTES)


def _drive_batch_compacting(fn, esps, model, dims: SearchDims, budget: int,
                            device, *, bail: bool = False, tele_acc=None):
    """Slice driver of one batch rung, with active-key compaction.

    Between slices, finished keys are recorded on the host; once the
    live keys fit ``1/shrink`` of the current lanes, the stacked
    arguments and carry are rebuilt at the smaller lane count (pad lanes
    carry status VALID and count 0: they do nothing).  Lanes step by
    powers of two up to 32, then by multiples of 32.  With ``bail`` a
    key that overflowed stops (a wider rung is coming) and retires.
    Each slice runs in a ``device.slice`` span and its
    wall seconds feed ``jtpu_device_seconds_total``; with ``tele_acc``
    (``fn`` a telemetry build) the slices' aux blocks, summed over the
    keys, add to its totals.

    Returns (status, count, configs, depth, ovf) numpy arrays over all
    keys, in input order."""
    n = len(esps)
    fin: dict = {}  # key -> (status, count, configs, depth, ovf)

    def grid(k: int) -> int:
        if k <= 32:
            return max(4, _next_pow2(k))
        return _round_up(k, 32)

    # the host rule: re-stack once the live keys fit half the lanes.  The
    # JAX package waits for a quarter on a TPU, where every new batch
    # shape is a fresh compile; the card compiles nothing per shape
    shrink = 2
    lanes = list(range(n))  # lane -> key (retired keys keep their lane
    #                         until the next re-stack)
    b = grid(n)
    args = stack_batch(esps, pad_to=b, device=device)
    carry = pad_batch_carry(_init_batch_carry(n, dims, model, device),
                            b - n, dims, model, device)

    lvl_cap = _SLICE_LEVELS0
    first = True
    while True:
        t0 = time.perf_counter()
        with obs.span("device.slice", cat="device", frontier=dims.frontier,
                      levels=lvl_cap, lanes=b, first=first):
            res = fn(*args, budget, lvl_cap, bail, *carry)
            carry = res[:6]
            scal = torch.stack([carry[2], carry[1], carry[3], carry[4],
                                carry[5].to(torch.int32)]).cpu().numpy()
        dt = time.perf_counter() - t0
        _tele.record_device_seconds(dt)
        if tele_acc is not None:
            # the keys pace differently: only the sum over the lanes
            tele_acc.add_totals(res[6].sum(dim=0).cpu().numpy())
        live = []  # lanes still running
        for i, k in enumerate(lanes):
            if k in fin:
                continue
            st, ct, cf, dp, ov = (int(v) for v in scal[:, i])
            if st != -1 or ct <= 0 or cf >= budget or (bail and ov):
                fin[k] = (st, ct, cf, dp, ov)
            else:
                live.append(i)
        if not live:
            break
        if not first:
            lvl_cap = _adapt_lvl_cap(lvl_cap, dt)
        first = False
        if grid(len(live)) * shrink <= grid(len(lanes)):
            idx = torch.tensor(live, device=carry[0].device)
            lanes = [lanes[i] for i in live]
            b = grid(len(lanes))
            args = stack_batch([esps[k] for k in lanes], pad_to=b,
                               device=device)
            carry = pad_batch_carry(tuple(c[idx] for c in carry),
                                    b - len(lanes), dims, model, device)
            first = True

    out = np.zeros((5, n), np.int64)
    for k, vals in fin.items():
        out[:, k] = vals
    return (out[0].astype(np.int32), out[1].astype(np.int32),
            out[2].astype(np.int32), out[3].astype(np.int32),
            out[4].astype(bool))


def _finalize_batch_status(status, count, ovf):
    """Still-running statuses after the ladder, as :func:`_run_kernel`
    finalizes them: a dead frontier is invalid unless it overflowed; an
    exhausted budget is unknown."""
    return np.where(
        status == -1,
        np.where(count <= 0, np.where(ovf, UNKNOWN, INVALID), UNKNOWN),
        status)


def _device_batch_certificate(r: dict) -> dict:
    """The batch engines' certificate-drop reasons on a device verdict."""
    if r.get("valid") is True:
        r.setdefault("witness_dropped", WITNESS_DROPPED_DEVICE)
    elif r.get("valid") is False:
        r.setdefault("frontier_dropped", FRONTIER_DROPPED_DEVICE)
    return r


def _search_batch_ladder(seqs: list[OpSeq], esps: list[EncodedSearch],
                         model, dims: SearchDims, budget: int,
                         device, telemetry: bool = True) -> list[dict]:
    """The batch's device route over padded encodings at ``dims``: every
    pending key runs at the current rung; keys that overflow it run
    together at the next, 4x wider, up to :data:`BATCH_FRONTIER_CAP`.
    Each key's configs add up over the rungs, and its budget bounds the
    sum.  Keys still overflowing at the cap run solo
    (:func:`search_opseq`) on what is left of their budget.  A failing
    kernel raises.  With ``telemetry`` the first result carries the
    batch's ``search_telemetry`` (totals over every key and rung)."""
    n = len(seqs)
    status = np.full(n, UNKNOWN, np.int32)
    count = np.zeros(n, np.int32)
    configs = np.zeros(n, np.int64)
    depth = np.zeros(n, np.int32)
    ovf = np.zeros(n, bool)
    pending = list(range(n))
    spent = np.zeros(n, np.int64)  # configs over all rungs
    rung = dims.frontier
    # uniform over the batch: pad_search materializes every plane, and
    # the step reads them when any key needs them (inert for the rest)
    b_masked = any(e.masked for e in esps)
    b_mcrash = any(e.mask_has_crash for e in esps)
    b_dedup = any(e.dedup for e in esps)
    used_kernel = False
    acc = _tele.SearchTelemetry("device-batch") if telemetry else None
    while pending:
        d = SearchDims(**{**dims.__dict__, "frontier": rung})
        use_k = _use_kernel(model, d, device, masked=b_masked,
                            dedup=b_dedup)
        fn = get_batch_kernel(model, d, device, masked=b_masked,
                              masked_crash=b_mcrash, dedup=b_dedup,
                              telemetry=telemetry)
        st, ct, cf, dp, ov = _drive_batch_compacting(
            fn, [esps[i] for i in pending], model, d, budget, device,
            bail=True, tele_acc=acc)
        used_kernel = used_kernel or use_k
        nxt = []
        for j, i in enumerate(pending):
            spent[i] += int(cf[j])
            if st[j] == -1 and bool(ov[j]) and spent[i] < budget:
                nxt.append(i)  # overflowed this rung: climb
            else:
                status[i], count[i] = st[j], ct[j]
                configs[i] = spent[i]
                depth[i], ovf[i] = dp[j], ov[j]
        pending = nxt
        if pending and rung >= BATCH_FRONTIER_CAP:
            break  # stragglers go solo below
        rung = min(rung * 4, BATCH_FRONTIER_CAP)
    status = _finalize_batch_status(status, count, ovf)
    out = []
    engine = _engine_label(used_kernel, base="device-batch")
    solo = set(pending)
    for i in range(n):
        needs_solo = i in solo or (int(status[i]) == UNKNOWN
                                   and bool(ovf[i]))
        if needs_solo and spent[i] >= budget:
            # the rungs spent this key's budget: unknown, with the count
            out.append({"valid": "unknown", "configs": int(spent[i]),
                        "max_depth": int(depth[i]), "engine": engine})
        elif needs_solo:
            r = search_opseq(seqs[i], model,
                             budget=max(1000, budget - int(spent[i])),
                             device=device, lint=False, audit=False,
                             telemetry=telemetry)
            r["configs"] = int(r.get("configs", 0)) + int(spent[i])
            out.append(r)
        else:
            out.append(_device_batch_certificate(
                {"valid": _STATUS[int(status[i])],
                 "configs": int(configs[i]), "max_depth": int(depth[i]),
                 "engine": engine}))
    if acc is not None and out:
        # one block for the batch, on the first result only
        _tele.finalize_result(out[0], acc, device=device)
    return out


def _audit_batch(seqs: list[OpSeq], model, results: list[dict],
                 audit: bool) -> list[dict]:
    """Replay every key's certificate when ``audit`` is on."""
    if audit:
        for s, r in zip(seqs, results):
            maybe_audit(s, model, r, True)
    return results


def _greedy_result(seq: OpSeq) -> dict:
    return {"valid": True, "configs": seq.n_must, "max_depth": seq.n_must,
            "engine": "greedy-witness",
            "linearization": greedy_linearization(seq)}


def search_batch(seqs: list[OpSeq], model, *, budget: int = 2_000_000,
                 dims: SearchDims | None = None, device="cuda",
                 sharding=None, decompose: bool = False,
                 decompose_cache=None,
                 bucket: bool | None = None, lint: bool | None = None,
                 audit: bool | None = None, hb: bool | None = None,
                 dpor: bool | None = None, telemetry: bool | None = None,
                 _prepass: list | None = None) -> list[dict]:
    """Check a batch of independent per-key histories: the knossos
    ``independent`` checker's per-key searches, run together on
    ``device``.  Returns one result per key, in order.

    Keys the greedy witness or the prepass decides return at once with
    their certificates; keys past the device encoding go to the host
    ``linear`` sweep ("host-linear(fallback)"); the rest ride the batch
    ladder (:func:`_search_batch_ladder`): one slice of every key per
    launch of the fused kernel's grid over keys on the card, the torch
    step key by key elsewhere.  Device verdicts carry drop reasons.

    ``bucket`` (None: on for more than one key, unless ``dims`` pins one
    shape) groups the keys by padded shape (``bucket.py``), each bucket
    at its own dims; the verdicts are the same either way.  ``lint``
    (None: on) lints every key first; errors raise naming the key.
    ``hb`` and ``dpor`` (None: on) as in :func:`search_opseq`; where the
    kernel takes the batch's starting rung the reductions are dropped.
    ``audit=True`` replays every key's certificate.  ``telemetry``
    (None: on) puts the ladder's ``search_telemetry`` on its first
    result (one per bucket when bucketed); a key searched alone carries
    its own.  ``_prepass`` carries per-key must-order maps a caller
    already computed.

    ``sharding`` (a :class:`~..distributed.ShardMesh` or
    :class:`~..distributed.KeysSharding`) spreads the batch over a mesh,
    whose devices replace ``device``: each shard runs the batch slice
    function on its block of the keys at a fixed frontier of 64
    (``sharded.py``), bucketed by default (each bucket covering the mesh
    at its own dims, ``bucket.search_batch_sharded_bucketed``, whose
    ``shard_batch`` stats ride the first result) or fused with
    ``bucket=False``.  Over a keys axis that spans processes, each
    process checks its contiguous block of the keys and every process
    returns the whole list (gathered with ``all_gather_object``); the
    first result of each process's block carries that block's stats.

    ``decompose=True`` puts the canonical-hash verdict cache in front of
    the batch (:func:`_search_batch_decomposed`): cached shapes return
    at once, a shape repeated within the batch is searched once, and
    only the distinct rest rides the device.  ``decompose_cache`` is a
    VerdictCache, a jsonl path, or None (in memory: dedup only); the
    first result carries ``decompose_batch`` stats."""
    from ..analyze.hb import resolve_hb
    from ..analyze.lint import Diagnostic, HistoryLintError, lint_opseq

    from ..distributed import as_sharding

    sh = as_sharding(sharding)
    if sh is not None:
        dev = [_resolve_device(d) for d in sh.mesh.devices][0]
    else:
        dev = _resolve_device(device)
    if not seqs:
        return []
    telemetry = _tele.resolve(telemetry)
    hb = resolve_hb(hb)
    dpor_on = resolve_dpor(dpor)
    audit = bool(audit)
    if lint is None or lint:
        # every key up front; an error names its key
        bad = []
        for k, s in enumerate(seqs):
            for d in lint_opseq(s, model):
                bad.append(Diagnostic(d.code, d.severity,
                                      f"batch key {k}: {d.message}",
                                      index=d.index, process=d.process,
                                      f=d.f))
        if any(d.severity == "error" for d in bad):
            raise HistoryLintError(bad)
    if sh is not None and sh.spans_processes:
        return _search_batch_across_processes(
            seqs, model, sh, budget=budget, dims=dims, decompose=decompose,
            decompose_cache=decompose_cache, bucket=bucket, audit=audit,
            hb=hb, dpor=dpor, telemetry=telemetry)
    if decompose:
        return _audit_batch(seqs, model, _search_batch_decomposed(
            seqs, model, budget=budget, dims=dims, device=dev, sharding=sh,
            cache=decompose_cache, bucket=bucket, hb=hb, dpor=dpor,
            telemetry=telemetry), audit)
    if bucket is None and dims is None and len(seqs) > 1:
        bucket = True
    if bucket and dims is None and sh is not None:
        from .bucket import search_batch_sharded_bucketed

        return _audit_batch(seqs, model, search_batch_sharded_bucketed(
            seqs, model, sh, budget=budget, hb=hb, dpor=dpor,
            telemetry=telemetry), audit)
    if bucket and dims is None:
        from .bucket import search_batch_bucketed

        return _audit_batch(seqs, model, search_batch_bucketed(
            seqs, model, budget=budget, device=dev, hb=hb, dpor=dpor,
            telemetry=telemetry), audit)
    # the greedy witness and the prepass dispose of keys on the host;
    # undecided keys keep their must-order maps (the device mask)
    results, rest, masks, hbs = _dispose_batch(seqs, model, hb, dpor,
                                               _prepass)
    if results:
        if rest:
            sub = search_batch([seqs[i] for i in rest], model,
                               budget=budget, dims=dims, device=dev,
                               sharding=sh, bucket=False, lint=False,
                               audit=False,
                               hb=False, dpor=dpor, telemetry=telemetry,
                               _prepass=masks)
            results.update(zip(rest, sub))
        return _audit_batch(seqs, model,
                            [results[i] for i in range(len(seqs))], audit)

    ess = [encode_search(s) for s in seqs]
    if any(e.window > MAX_WINDOW or e.n_crash > MAX_CRASH for e in ess):
        # past the encoding: those keys go to the host sweep, the rest
        # solo
        out = []
        for i, (s, e) in enumerate(zip(seqs, ess)):
            if e.window > MAX_WINDOW or e.n_crash > MAX_CRASH:
                r = _host_linear_fallback(s, model, hb, dpor)
            else:
                r = search_opseq(s, model, budget=budget, device=dev,
                                 lint=False, audit=False, hb=hb, dpor=dpor,
                                 telemetry=telemetry, _hbres=hbs[i])
            out.append(r)
        return _audit_batch(seqs, model, out, audit)
    if sh is not None:
        # no ladder over a mesh: the keys keep covering it at one shape,
        # so the shape starts at the wider frontier
        from .sharded import search_batch_sharded_fixed

        dims = dims or batch_dims(ess, model, frontier=64)
        esps = _pad_batch(seqs, ess, masks, model, dims, dev, dpor_on)
        acc = _tele.SearchTelemetry("device-batch-sharded") \
            if telemetry else None
        out, _info = search_batch_sharded_fixed(
            seqs, esps, model, dims, sh, budget, tele_acc=acc,
            telemetry=telemetry)
        if acc is not None and out:
            _tele.finalize_result(out[0], acc, device=dev)
        return _audit_batch(seqs, model, out, audit)
    dims = dims or batch_dims(ess, model)
    esps = _pad_batch(seqs, ess, masks, model, dims, dev, dpor_on)
    return _audit_batch(seqs, model, _search_batch_ladder(
        seqs, esps, model, dims, budget, dev, telemetry), audit)


def _search_batch_across_processes(seqs: list[OpSeq], model, sh, *,
                                   audit: bool, **kw) -> list[dict]:
    """:func:`search_batch` over a keys axis that spans processes: this
    process checks its contiguous block of the keys over its own shard
    devices, and the blocks are gathered (``all_gather_object``), so
    every process returns the whole list."""
    import torch.distributed as tdist

    n_proc, rank = sh.n_processes, sh.mesh.process_index
    bounds = [len(seqs) * i // n_proc for i in range(n_proc + 1)]
    block = seqs[bounds[rank]:bounds[rank + 1]]
    mine = search_batch(block, model, sharding=sh.local(), lint=False,
                        audit=audit, **kw) if block else []
    parts: list = [None] * n_proc
    tdist.all_gather_object(parts, mine)
    return [r for part in parts for r in part]


def _search_batch_decomposed(seqs: list[OpSeq], model, *, budget: int,
                             dims, device, cache, sharding=None,
                             bucket=None,
                             hb: bool | None = None,
                             dpor: bool | None = None,
                             telemetry: bool | None = None) -> list[dict]:
    """The cache and dedup front of :func:`search_batch`
    (``decompose=True``).  Exact: equal canonical keys are the same
    search problem (the same rows and precedence ranks, values
    bijective), so one verdict serves both.  An undecided result is
    never cached and never copied to another key; its shape is searched
    again alone, once."""
    from ..decompose.cache import VerdictCache
    from ..decompose.canonical import canonical_key

    if isinstance(cache, str):
        cache = VerdictCache(cache)
    elif cache is None:
        cache = VerdictCache()  # in memory: dedup within the batch only
    cache.reset_stats()
    keys = [canonical_key(s, model) for s in seqs]
    results: dict[int, dict] = {}
    rep: dict[str, int] = {}  # canonical key -> representative index
    todo: list[int] = []
    drop = "canonical verdict-cache hit (the cache stores verdicts, " \
           "not witnesses)"
    for i, k in enumerate(keys):
        e = cache.get(k)
        if e is not None and "v" in e:
            results[i] = {"valid": e["v"], "configs": 0,
                          "engine": "decompose-cache"}
            results[i]["witness_dropped" if e["v"] is True
                       else "frontier_dropped"] = drop
        elif k not in rep:
            rep[k] = i
            todo.append(i)
    if todo:
        sub = search_batch([seqs[i] for i in todo], model, budget=budget,
                           dims=dims, device=device, sharding=sharding,
                           bucket=bucket, lint=False, hb=hb, dpor=dpor,
                           telemetry=telemetry)
        for i, r in zip(todo, sub):
            results[i] = r
            if r.get("valid") in (True, False):
                cache.put_verdict(keys[i], r["valid"])

    def _copy_cert(dst: dict, src: dict) -> dict:
        """Certificates carry over between canonically equal keys: the
        histories are row-aligned and value-bijective, so one's witness
        and frontier rows are the other's (and the audit replays the
        copy against its own history)."""
        for field in ("linearization", "final_ops", "witness_dropped",
                      "frontier_dropped", "hb_cycle"):
            if field in src:
                v = src[field]
                dst[field] = list(v) if isinstance(v, list) else v
        return dst

    n_dup = 0
    solo: dict[str, dict] = {}
    for i, k in enumerate(keys):
        if i in results:
            continue
        r = results[rep[k]]
        if r.get("valid") in (True, False):
            n_dup += 1
            results[i] = _copy_cert({"valid": r["valid"], "configs": 0,
                                     "engine": "decompose-dedup"}, r)
            continue
        # the representative was undecided in the batch: search the
        # shape alone, once (a decided retry serves every copy)
        r2 = solo.get(k)
        if r2 is None:
            r2 = solo[k] = search_opseq(seqs[i], model, budget=budget,
                                        device=device, lint=False,
                                        telemetry=telemetry)
            if r2.get("valid") in (True, False):
                cache.put_verdict(k, r2["valid"])
                # the retry serves the representative too: one shape
                # must not report two verdicts in one result list (its
                # batch configs stay billed)
                ri = results[rep[k]]
                ri["valid"] = r2["valid"]
                ri["engine"] = (ri.get("engine") or
                                "device-batch") + "+decompose-retry"
                _copy_cert(ri, r2)
            results[i] = r2
        else:
            n_dup += 1
            results[i] = _copy_cert(
                {"valid": r2.get("valid"), "configs": 0,
                 "engine": "decompose-dedup"}, r2)
    out = [results[i] for i in range(len(seqs))]
    stats = {"n_keys": len(seqs), "cache_hits": cache.hits,
             "cache_misses": cache.misses, "deduped": n_dup,
             "searched": len(todo),
             "hit_rate": round(cache.hits / max(1, len(seqs)), 4)}
    # on the first result only, as bucket_batch
    if out:
        out[0].setdefault("decompose_batch", stats)
    return out


def _dispose_batch(seqs: list[OpSeq], model, hb: bool, dpor,
                   prepass: list | None = None):
    """The host's disposal of a batch's keys before any device work (both
    batch routes): the greedy witness, then, with ``hb``, the prepass,
    each deciding with its certificate.  Returns ``(decided, rest,
    masks, hbs)``: results by key index, the undecided indices, and for
    each of them its must-order map and its prepass result
    (``_HB_UNSET`` where none ran).  ``prepass`` gives the must-order
    maps a caller already computed; the prepass does not run again."""
    decided: dict = {}
    rest, masks, hbs = [], [], []
    for i, s in enumerate(seqs):
        r = None
        mp = prepass[i] if prepass is not None else None
        hbres = _HB_UNSET
        if greedy_witness(s, model):
            r = _greedy_result(s)
        elif hb and prepass is None:
            hbres = maybe_hb(s, model, True, dpor)
            if hbres is not None and hbres.decided is not None:
                r = dict(hbres.decided)
            elif hbres is not None and hbres.must_pred:
                mp = hbres.must_pred
        if r is not None:
            decided[i] = r
        else:
            rest.append(i)
            masks.append(mp)
            hbs.append(hbres)
    return decided, rest, masks, hbs


def _pad_batch(seqs: list[OpSeq], ess: list[EncodedSearch], masks: list,
               model, dims: SearchDims, dev, dpor_on: bool) -> list:
    """The undecided keys' encodings padded to ``dims`` (both batch
    routes): with DPOR on, each gets its reductions (its must-order map
    and dead-value table), dropped again where the kernel takes the
    starting rung; the dead tables pad to one width."""
    if dpor_on:
        for s, e, mp in zip(seqs, ess, masks):
            attach_reductions(e, s, model, mp, dedup=True)
            _strip_reductions_for_kernel(e, model, dims, dev)
    dead_pad = batch_dead_pad(ess)
    return [pad_search(e, dims.n_det_pad, dims.n_crash_pad,
                       dead_pad=dead_pad) for e in ess]


def _host_linear_fallback(seq: OpSeq, model, hb: bool, dpor) -> dict:
    """A batch key past the device encoding: the host ``linear`` sweep."""
    r = check_opseq_linear(seq, model, lint=False, hb=hb, dpor=dpor)
    r["engine"] = "host-linear(fallback)"
    return r


def truncate_to_failure(seq: OpSeq, depth: int, window: int
                        ) -> OpSeq | None:
    """Cut the history just past the failure region, at a point where
    every kept determinate op returned before any removed op invoked, so
    prefix-invalid implies full-invalid and the host oracle can confirm
    on the prefix.  None when no such cut exists before the end."""
    ok = np.asarray(seq.ok, dtype=bool)
    det_rows = np.nonzero(ok)[0]
    n_det = len(det_rows)
    want = min(depth + window + 1, n_det)
    if want >= n_det:
        return None
    det_inv = np.asarray(seq.inv)[det_rows]
    run_max = np.maximum.accumulate(np.asarray(seq.ret)[det_rows])
    cut = next((i for i in range(want, n_det - 1)
                if run_max[i] < det_inv[i + 1]), None)
    if cut is None:
        return None
    idx = np.nonzero(np.asarray(seq.inv) < det_inv[cut + 1])[0]
    if len(idx) >= len(seq):
        return None
    return OpSeq(process=seq.process[idx], f=seq.f[idx], v1=seq.v1[idx],
                 v2=seq.v2[idx], inv=seq.inv[idx], ret=seq.ret[idx],
                 ok=seq.ok[idx], ops=[seq.ops[i] for i in idx],
                 encoder=seq.encoder)


class Linearizable:
    """Linearizability checker: the knossos ``linearizable`` checker.

    ``algorithm``: ``auto`` (the default: the host WGL oracle up to
    ``host_threshold`` ops, above it :func:`check_competition`),
    ``competition``, ``device``/``tpu`` (the device search alone),
    ``linear`` (the host sweep, with a witness) or ``host``/``wgl`` (the
    host WGL oracle).  An invalid verdict of the device search or of the
    WGL leg of the race is confirmed on the host oracle over the
    shortest sound prefix, up to ``witness_threshold`` ops.  Every
    invalid verdict is reported in ``linear.html`` under the test's
    store directory (``report_file``), led by its delta-debugged core
    (``shrink``; histories up to :attr:`SHRINK_MAX_OPS` rows;
    ``shrink=False`` turns it off).  ``model`` may be given here or ride
    in ``test["model"]``.  ``device`` follows the package rule: "cuda"
    by default, "cpu" only when asked for.

    ``lint`` (None: on) lints the events, or the columns of an OpSeq,
    before anything else: errors raise ``HistoryLintError``, warnings
    ride the result as ``lint_warnings``.  ``hb`` and ``dpor`` (None:
    on) reach every route; the host confirmation after a device win
    runs with both at their defaults.  ``telemetry`` (None: on) reaches
    the device search.  ``audit=True`` replays the returned
    certificate.  ``explain=True`` searches nothing: it prints the
    static plan of the search (``analyze/plan.py``) and returns it under
    ``explain`` with ``valid`` "unknown".

    ``decompose=True`` checks through the decomposition layer
    (``decompose/engine.py``) in front of the selected route, which
    becomes its ``direct`` fallback; cells and segments run the host
    ``linear`` sweep (the WGL oracle under ``algorithm="host"``).  The
    verdict is the same.  ``verdict_cache`` is its VerdictCache, a jsonl
    path (opened once per checker), True for the store's default path,
    or None (no cache)."""

    name = "linearizable"

    ALGORITHMS = {"auto": "auto", "device": "device", "tpu": "device",
                  "linear": "linear", "host": "host", "wgl": "host",
                  "competition": "competition"}

    #: delta-debug failure reports only up to this many rows: each probe
    #: is a bounded re-search, and a report should not cost more than
    #: its verdict
    SHRINK_MAX_OPS = 400

    def __init__(self, model=None, *, budget: int = 20_000_000,
                 host_threshold: int = 48, witness_threshold: int = 3000,
                 algorithm: str = "auto", decompose: bool = False,
                 verdict_cache=None,
                 lint: bool | None = None, explain: bool | None = None,
                 audit: bool | None = None, shrink: bool | None = None,
                 hb: bool | None = None, dpor: bool | None = None,
                 telemetry: bool | None = None, device="cuda"):
        try:
            self.algorithm = self.ALGORITHMS[algorithm]
        except KeyError:
            raise ValueError(f"unknown algorithm {algorithm!r}; one of "
                             f"{sorted(self.ALGORITHMS)}") from None
        self.model = model
        self.budget = budget
        self.host_threshold = host_threshold
        self.witness_threshold = witness_threshold
        self.shrink = shrink
        self.lint = lint
        self.audit = audit
        self.hb = hb
        self.dpor = dpor
        self.telemetry = telemetry
        self.device = device
        self.explain = explain
        self.decompose = decompose
        self.verdict_cache = verdict_cache
        self._cache_obj = None

    def check(self, test, history, opts=None):
        from ..analyze.lint import check_history, check_opseq_lint

        model = self.model or (test or {}).get("model")
        if model is None:
            raise ValueError("linearizable checker needs a model")
        lint_warnings: list = []
        if self.lint is None or self.lint:
            # the event-level lint sees what encoding erases (double
            # invokes, orphan completions); an OpSeq gets the columns'
            if isinstance(history, OpSeq):
                lint_warnings = check_opseq_lint(history, model)
            else:
                lint_warnings = check_history(history, model)
        seq = history if isinstance(history, OpSeq) else \
            encode_ops(history, model.f_codes)
        if self.explain:
            return self._plan_only(seq, model, lint_warnings)
        out = self._checked(test, seq, model, opts)
        if lint_warnings:
            out.setdefault("lint_warnings",
                           [d.to_dict() for d in lint_warnings])
        return maybe_audit(seq, model, out, self.audit)

    def _plan_only(self, seq: OpSeq, model, lint_warnings) -> dict:
        """``explain=True``: print the static plan of the search this
        checker would run (``analyze/plan.py``) and return it as an
        "unknown" verdict; nothing is searched or launched."""
        from ..analyze.plan import explain, render_plan

        plan = explain(seq, model, host_threshold=self.host_threshold,
                       device=self.device, hb=self.hb, dpor=self.dpor,
                       telemetry=self.telemetry)
        print(render_plan(plan))
        out = {"valid": "unknown", "engine": "explain(plan-only)",
               "explain": plan, "configs": 0}
        if lint_warnings:
            out["lint_warnings"] = [d.to_dict() for d in lint_warnings]
        return out

    def _checked(self, test, seq: OpSeq, model, opts) -> dict:
        if not self.decompose:
            return self._check_direct(test, seq, model, opts)
        from ..decompose.cache import VerdictCache, default_cache_path
        from ..decompose.engine import check_opseq_decomposed

        cache = self.verdict_cache
        if cache is True:
            cache = default_cache_path()
        if isinstance(cache, str):
            # one cache per checker, not per check: each one re-reads
            # the whole append-only file
            if self._cache_obj is None or self._cache_obj.path != cache:
                self._cache_obj = VerdictCache(cache)
            cache = self._cache_obj
        sub_check = None
        if self.algorithm == "host":
            # the selected host engine runs the sub-searches too; the
            # other routes keep the default host ``linear`` sweep (cells
            # and segments are small, where a device call only loses)
            from . import seq as seqmod

            def sub_check(s, m, *, max_configs, deadline):
                return seqmod.check_opseq(s, m, max_configs=max_configs,
                                          deadline=deadline, lint=False,
                                          hb=self.hb, dpor=self.dpor)
        out = check_opseq_decomposed(
            seq, model, cache=cache, sub_max_configs=self.budget,
            sub_check=sub_check, lint=False, witness=True, hb=self.hb,
            dpor=self.dpor, device=self.device, telemetry=self.telemetry,
            direct=lambda s: self._check_direct(test, s, model, opts))
        if out["valid"] is False and "report_file" not in out:
            # the direct route writes its own report; a verdict decided
            # by decomposition alone gets one here
            self._render_failure(test, seq, out, opts, model)
        return out

    def _check_direct(self, test, seq: OpSeq, model, opts) -> dict:
        from . import seq as seqmod

        # the lint ran at the checker's boundary: every route runs
        # lint-free below
        red = {"lint": False, "hb": self.hb, "dpor": self.dpor}
        if self.algorithm == "host" or (self.algorithm == "auto"
                                        and len(seq) <= self.host_threshold):
            out = seqmod.check_opseq(seq, model, **red)
            out["engine"] = "host-oracle"
            if out["valid"] is False:
                self._render_failure(test, seq, out, opts, model)
            return out
        if self.algorithm == "linear":
            out = check_opseq_linear(seq, model,
                                     witness_cap=DEFAULT_WITNESS_CAP, **red)
            out["engine"] = "host-linear"
            if out["valid"] is False:
                self._render_failure(test, seq, out, opts, model)
            return out
        if self.algorithm in ("auto", "competition"):
            out = check_competition(seq, model, budget=self.budget,
                                    device=self.device,
                                    telemetry=self.telemetry, **red)
        else:
            out = search_opseq(seq, model, budget=self.budget,
                               device=self.device,
                               telemetry=self.telemetry, **red)
        if out["valid"] is False:
            eng = out.get("engine", "")
            if "host-oracle" in eng or "host-linear" in eng:
                # an exact host engine decided, with its frontier:
                # confirming would repeat the same search
                self._render_failure(test, seq, out, opts, model)
                return out
            # exact confirmation + witness on the shortest sound prefix
            # covering the failure region
            target = truncate_to_failure(seq, out.get("max_depth", 0),
                                         out.get("window", 1))
            if target is None:
                target = seq
            if len(target) <= self.witness_threshold:
                # hb and dpor at their defaults, as the JAX package's
                # confirmation runs
                confirm = seqmod.check_opseq(target, model, lint=False)
                if confirm["valid"] is False:
                    confirm["engine"] = out["engine"] + "+host-witness"
                    confirm["device_configs"] = out["configs"]
                    confirm["witness_prefix_ops"] = len(target)
                    self._render_failure(test, target, confirm, opts,
                                         model)
                    return confirm
                # the prefix came back valid: the obstruction lies past
                # the cut, and the full verdict stands
        return out

    def _render_failure(self, test, seq: OpSeq, result: dict, opts,
                        model) -> None:
        """Shrink an invalid verdict and write its linear.html; reporting
        never changes the verdict."""
        from . import linear_report

        if (result.get("shrink") is None and 0 < len(seq)
                <= self.SHRINK_MAX_OPS
                and (self.shrink is None or self.shrink)):
            from ..analyze.shrink import shrink_invalid, shrink_summary

            try:
                result["shrink"] = shrink_summary(
                    seq, shrink_invalid(seq, model))
            except Exception:  # noqa: BLE001 — reporting only
                pass
        path = linear_report.write_linear_html(test or {}, seq, result,
                                               opts)
        if path is not None:
            result["report_file"] = path

    def __call__(self, test, history, opts=None):
        return self.check(test, history, opts)


def linearizable(model=None, **kw) -> Linearizable:
    return Linearizable(model, **kw)


# the multi-device routes (sharded.py), under this module's names as in
# the JAX package
from .sharded import (build_sharded_search_step_fn,  # noqa: E402,F401
                      get_sharded_batch_kernel, search_opseq_sharded)
