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

:func:`check_competition` races the two exact host engines against the
device search, the default route of :class:`Linearizable` above
``host_threshold`` ops.  :class:`Linearizable` confirms invalid device
verdicts on the host oracle (``seq.py``) over the shortest sound
prefix, which also yields a certificate, and reports every invalid
verdict in ``linear.html`` (``linear_report.py``), led by its shrunk
core (``analyze/shrink.py``).

Not in this module yet: decomposition and checkpoints.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..analyze.audit import maybe_audit
from ..analyze.dpor import resolve_dpor
from ..analyze.hb import attach, maybe_hb
from ..analyze.lint import maybe_lint
from ..history import OpSeq, encode_ops
from . import level_kernel
from .encode import (MAX_CRASH, MAX_FRONTIER, MAX_WINDOW, EncodedSearch,
                     SearchDims, _grid_width, _init_carry, _widen_carry,
                     attach_reductions, carry_to_device, choose_dims,
                     encode_search, pad_search, search_args)
from .linear import DEFAULT_WITNESS_CAP, _refuse, check_opseq_linear
from .step import build_search_step_fn

#: statuses
VALID, INVALID, UNKNOWN = 2, 1, 0
_STATUS = {2: True, 1: False, 0: "unknown"}

#: initial BFS levels per device call; the driver adapts from here so
#: each call lands near _SLICE_TARGET_S seconds
_SLICE_LEVELS0 = 32
_SLICE_TARGET_S = 2.0
_SLICE_MAX = 16384

#: configurations each host leg of the race may visit, before the
#: memory cap of :func:`check_competition`
COMPETITION_MAX_CONFIGS = 50_000_000


def _resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device without a card
    raises: the port never drops quietly to the CPU; callers that want
    the CPU ask for ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the host")
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


def get_kernel(model, dims: SearchDims, device: torch.device, *,
               masked: bool = False, masked_crash: bool = False,
               dedup: bool = False):
    """The slice function for (model, dims) on ``device`` and the
    search's reductions: the CUDA level loop where :func:`_use_kernel`
    says so, else the torch step."""
    from . import step

    use_k = _use_kernel(model, dims, device, masked=masked, dedup=dedup)
    key = (model.name, dims, str(device), step._DOMINANCE_MODE, use_k,
           masked, masked_crash, dedup)
    fn = _STEP_CACHE.get(key)
    if fn is None:
        fn = (level_kernel.build_level_loop_fn(model, dims) if use_k
              else build_search_step_fn(model, dims, device, masked=masked,
                                        masked_crash=masked_crash,
                                        dedup=dedup))
        _STEP_CACHE[key] = fn
    return fn


def _run_kernel(esp, es, model, dims: SearchDims, budget: int, device, *,
                deadline: float | None = None, stop=None):
    """Drive the sliced search to completion with an adaptive width.

    Escalation climbs two grid steps (4x) from the level that
    overflowed (the slice uncommits it under ``bail``); the downshift
    settles one step at a time, after two consecutive slices fit the
    lower rung.  ``deadline`` (``time.perf_counter()`` clock) and
    ``stop`` (a ``threading.Event``) are tested after every slice and
    end the search as "unknown".

    Returns (status, configs, max_depth, dims, used_kernel): status is
    final (-1 never escapes), dims carries the final width, and
    ``used_kernel`` says whether any slice ran the CUDA level loop."""
    args = search_args(esp, es, device=device)
    masked, masked_crash, dedup = _reduction_key(esp)
    carry = carry_to_device(_init_carry(dims, model), device)
    F = dims.frontier
    lvl_cap = _SLICE_LEVELS0
    first = True
    low_streak = 0  # consecutive slices whose live width fit a lower rung
    used_kernel = False
    timed_out = False
    while True:
        bail = F < MAX_FRONTIER
        used_kernel = used_kernel or _use_kernel(
            model, dims, device, masked=masked, dedup=dedup)
        fn = get_kernel(model, dims, device, masked=masked,
                        masked_crash=masked_crash, dedup=dedup)
        t0 = time.perf_counter()
        carry = fn(*args, budget, lvl_cap, bail, *carry)
        status = int(carry[2])  # waits for the slice
        dt = time.perf_counter() - t0
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
    return status, configs, int(carry[4]), dims, used_kernel


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


def _engine_label(used_kernel: bool) -> str:
    return "device-bfs(cuda)" if used_kernel else "device-bfs"


def search_opseq(seq: OpSeq, model, *, budget: int = 20_000_000,
                 dims: SearchDims | None = None, device="cuda",
                 deadline: float | None = None, stop=None,
                 lint: bool | None = None, audit: bool | None = None,
                 hb: bool | None = None, dpor: bool | None = None) -> dict:
    """Check one columnar history on ``device``.  Returns
    ``{"valid": True|False|"unknown", "configs", "max_depth", "engine",
    "frontier", "window", "concurrency"}`` plus certificate fields:
    greedy and trivial verdicts carry their ``linearization``, device
    verdicts ``witness_dropped``/``frontier_dropped`` reasons.  A
    history past the device encoding (``MAX_WINDOW``, ``MAX_CRASH``)
    is checked by the host ``linear`` sweep, engine
    "host-linear(fallback)".

    ``deadline`` (``time.perf_counter()`` clock) and ``stop`` (a
    ``threading.Event``, how the competition race retires the device
    leg) end the search as "unknown" between slices.

    ``lint`` (None: on) lints the history first.  ``hb`` (None: on) runs
    the static prepass: a decided history returns at once with its
    certificate and 0 configs (engine "hb-decide" or
    "constraint-decide").  ``dpor`` (None: on) ships the prepass's
    must-order edges and the dead-value table to the device search as
    reduction planes, and adds ``dpor`` stats to the result
    (``device_masked``, ``device_mask_rows``, ``dedup``).  ``audit=True``
    replays the certificate."""
    dev = _resolve_device(device)
    maybe_lint(seq, model, lint)
    hbres = maybe_hb(seq, model, hb, dpor)

    def finish(out: dict) -> dict:
        return maybe_audit(seq, model, attach(out, hbres), audit)

    if hbres is not None and hbres.decided is not None:
        return maybe_audit(seq, model, dict(hbres.decided), audit)
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
    esp = pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    status, configs, max_depth, dims, used_kernel = _run_kernel(
        esp, es, model, dims, budget, dev, deadline=deadline, stop=stop)
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
    return finish(out)


def check_competition(seq: OpSeq, model, *, budget: int = 20_000_000,
                      device="cuda",
                      lint: bool | None = None, audit: bool | None = None,
                      hb: bool | None = None,
                      dpor: bool | None = None) -> dict:
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

    One lint at the race's boundary (``lint``, None: on); the legs run
    without it, each with its own prepass and reductions (``hb``,
    ``dpor``).  ``audit=True`` replays the winner's certificate."""
    from . import seq as seqmod

    dev = _resolve_device(device)
    maybe_lint(seq, model, lint)

    def finish(out: dict) -> dict:
        return maybe_audit(seq, model, out, audit)

    # the WGL DFS memoizes each configuration twice (visited and
    # parents) as a (bigint set, state) pair: cap it to about 4 GB, so a
    # loser thread cannot eat the host while the device works
    per_cfg = 2 * (len(seq) // 8 + 200)
    max_configs = min(COMPETITION_MAX_CONFIGS, 4_000_000_000 // per_cfg)

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
                               stop=done, lint=False, hb=hb, dpor=dpor)
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
    runs with both at their defaults.  ``audit=True`` replays the
    returned certificate."""

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
                 lint: bool | None = None, explain: bool | None = None,
                 audit: bool | None = None, shrink: bool | None = None,
                 hb: bool | None = None, dpor: bool | None = None,
                 device="cuda"):
        _refuse(decompose, "decompose", "A8")
        _refuse(explain, "explain", "A12")
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
        self.device = device

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
        out = self._check_direct(test, seq, model, opts)
        if lint_warnings:
            out.setdefault("lint_warnings",
                           [d.to_dict() for d in lint_warnings])
        return maybe_audit(seq, model, out, self.audit)

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
                                    device=self.device, **red)
        else:
            out = search_opseq(seq, model, budget=self.budget,
                               device=self.device, **red)
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
