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

An overflow at the widest rung or an exhausted budget reports
"unknown", never a wrong verdict.  :class:`Linearizable`
confirms invalid device verdicts on the host oracle (``seq.py``) over
the shortest sound prefix, which also yields a certificate.

Not in this module yet: the ``linear`` host sweep and the
``competition`` race (histories past the device encoding limits, and
``algorithm="auto"`` above ``host_threshold``), the history lint, the
happens-before and DPOR reductions, certificate audit, decomposition,
failure reports and checkpoints.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..history import OpSeq, encode_ops
from . import level_kernel
from .encode import (MAX_CRASH, MAX_FRONTIER, MAX_WINDOW, SearchDims,
                     _grid_width, _init_carry, _widen_carry,
                     carry_to_device, choose_dims, encode_search,
                     pad_search, search_args)
from .step import build_search_step_fn

#: statuses
VALID, INVALID, UNKNOWN = 2, 1, 0
_STATUS = {2: True, 1: False, 0: "unknown"}

#: initial BFS levels per device call; the driver adapts from here so
#: each call lands near _SLICE_TARGET_S seconds
_SLICE_LEVELS0 = 32
_SLICE_TARGET_S = 2.0
_SLICE_MAX = 16384

_NOT_PORTED = "not ported yet (ROADMAP queue A{item})"


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


def _refuse(flag: bool | None, name: str) -> None:
    """The reductions and passes of later slices accept only off."""
    if flag:
        raise NotImplementedError(
            f"{name}=True: {_NOT_PORTED.format(item=7)}")


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


def _use_kernel(model, dims: SearchDims, device: torch.device) -> bool:
    """The fused CUDA level loop takes every eligible rung on the card."""
    return device.type == "cuda" and level_kernel.eligible(model, dims)


_STEP_CACHE: dict = {}


def get_kernel(model, dims: SearchDims, device: torch.device):
    """The slice function for (model, dims) on ``device``: the CUDA
    level loop where :func:`_use_kernel` says so, else the torch step."""
    from . import step

    use_k = _use_kernel(model, dims, device)
    key = (model.name, dims, str(device), step._DOMINANCE_MODE, use_k)
    fn = _STEP_CACHE.get(key)
    if fn is None:
        fn = (level_kernel.build_level_loop_fn(model, dims) if use_k
              else build_search_step_fn(model, dims, device))
        _STEP_CACHE[key] = fn
    return fn


def _run_kernel(esp, es, model, dims: SearchDims, budget: int, device):
    """Drive the sliced search to completion with an adaptive width.

    Escalation climbs two grid steps (4x) from the level that
    overflowed (the slice uncommits it under ``bail``); the downshift
    settles one step at a time, after two consecutive slices fit the
    lower rung.

    Returns (status, configs, max_depth, dims, used_kernel): status is
    final (-1 never escapes), dims carries the final width, and
    ``used_kernel`` says whether any slice ran the CUDA level loop."""
    args = search_args(esp, es, device=device)
    carry = carry_to_device(_init_carry(dims, model), device)
    F = dims.frontier
    lvl_cap = _SLICE_LEVELS0
    first = True
    low_streak = 0  # consecutive slices whose live width fit a lower rung
    used_kernel = False
    while True:
        bail = F < MAX_FRONTIER
        used_kernel = used_kernel or _use_kernel(model, dims, device)
        fn = get_kernel(model, dims, device)
        t0 = time.perf_counter()
        carry = fn(*args, budget, lvl_cap, bail, *carry)
        status = int(carry[2])  # waits for the slice
        dt = time.perf_counter() - t0
        count = int(carry[1])
        configs = int(carry[3])
        ovf = bool(carry[5])
        if status != -1 or count <= 0 or configs >= budget:
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
        # budget exhausted: unknown
        status = UNKNOWN if count > 0 or ovf else INVALID
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
                 lint: bool | None = None, audit: bool | None = None,
                 hb: bool | None = None, dpor: bool | None = None) -> dict:
    """Check one columnar history on ``device``.  Returns
    ``{"valid": True|False|"unknown", "configs", "max_depth", "engine",
    "frontier", "window", "concurrency"}`` plus certificate fields:
    greedy and trivial verdicts carry their ``linearization``, device
    verdicts ``witness_dropped``/``frontier_dropped`` reasons.

    ``lint``, ``audit``, ``hb`` and ``dpor`` take None or False (off)."""
    for flag, name in ((lint, "lint"), (audit, "audit"), (hb, "hb"),
                       (dpor, "dpor")):
        _refuse(flag, name)
    dev = _resolve_device(device)
    es = encode_search(seq)
    if es.n_det == 0 and es.n_crash == 0:
        return {"valid": True, "configs": 0, "max_depth": 0,
                "engine": "trivial", "linearization": []}
    if greedy_witness(seq, model):
        return {"valid": True, "configs": es.n_det, "max_depth": es.n_det,
                "engine": "greedy-witness",
                "linearization": greedy_linearization(seq)}
    if es.window > MAX_WINDOW or es.n_crash > MAX_CRASH:
        raise NotImplementedError(
            f"window {es.window} / {es.n_crash} crashed ops exceed the "
            f"device encoding; the host `linear` sweep is "
            f"{_NOT_PORTED.format(item=5)}")
    dims = dims or choose_dims(es, model, device=dev)
    esp = pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    status, configs, max_depth, dims, used_kernel = _run_kernel(
        esp, es, model, dims, budget, dev)
    out = {"valid": _STATUS[status], "configs": configs,
           "max_depth": max_depth, "engine": _engine_label(used_kernel),
           "frontier": dims.frontier, "window": es.window,
           "concurrency": es.concurrency}
    if out["valid"] is True:
        out["witness_dropped"] = WITNESS_DROPPED_DEVICE
    elif out["valid"] is False:
        out["frontier_dropped"] = FRONTIER_DROPPED_DEVICE
    return out


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
    """Linearizability checker backed by the device search.

    ``algorithm``: ``device``/``tpu`` (the device search, with invalid
    verdicts confirmed on the host oracle over the shortest sound
    prefix up to ``witness_threshold`` ops), ``host``/``wgl`` (the host
    WGL oracle), ``auto`` (the host oracle up to ``host_threshold`` ops;
    above it the competition race, not ported yet).  ``model`` may be
    given here or ride in ``test["model"]``.  ``device`` follows the
    package rule: "cuda" by default, "cpu" only when asked for."""

    name = "linearizable"

    ALGORITHMS = {"auto": "auto", "device": "device", "tpu": "device",
                  "linear": "linear", "host": "host", "wgl": "host",
                  "competition": "competition"}

    def __init__(self, model=None, *, budget: int = 20_000_000,
                 host_threshold: int = 48, witness_threshold: int = 3000,
                 algorithm: str = "auto", decompose: bool = False,
                 lint: bool | None = None, explain: bool | None = None,
                 audit: bool | None = None, shrink: bool | None = None,
                 hb: bool | None = None, dpor: bool | None = None,
                 device="cuda"):
        for flag, name in ((lint, "lint"), (audit, "audit"), (hb, "hb"),
                           (dpor, "dpor"), (decompose, "decompose"),
                           (explain, "explain"), (shrink, "shrink")):
            _refuse(flag, name)
        try:
            self.algorithm = self.ALGORITHMS[algorithm]
        except KeyError:
            raise ValueError(f"unknown algorithm {algorithm!r}; one of "
                             f"{sorted(self.ALGORITHMS)}") from None
        self.model = model
        self.budget = budget
        self.host_threshold = host_threshold
        self.witness_threshold = witness_threshold
        self.device = device

    def check(self, test, history, opts=None):
        model = self.model or (test or {}).get("model")
        if model is None:
            raise ValueError("linearizable checker needs a model")
        seq = history if isinstance(history, OpSeq) else \
            encode_ops(history, model.f_codes)
        return self._check_direct(seq, model)

    def _check_direct(self, seq: OpSeq, model) -> dict:
        from . import seq as seqmod

        if self.algorithm == "host" or (self.algorithm == "auto"
                                        and len(seq) <= self.host_threshold):
            out = seqmod.check_opseq(seq, model)
            out["engine"] = "host-oracle"
            return out
        if self.algorithm != "device":
            raise NotImplementedError(
                f"algorithm {self.algorithm!r} on {len(seq)} ops: the "
                f"host `linear` sweep and the competition race are "
                f"{_NOT_PORTED.format(item=5)}")
        out = search_opseq(seq, model, budget=self.budget,
                           device=self.device)
        if out["valid"] is False:
            # exact confirmation + witness on the shortest sound prefix
            # covering the failure region
            target = truncate_to_failure(seq, out.get("max_depth", 0),
                                         out.get("window", 1))
            if target is None:
                target = seq
            if len(target) <= self.witness_threshold:
                confirm = seqmod.check_opseq(target, model)
                if confirm["valid"] is False:
                    confirm["engine"] = out["engine"] + "+host-witness"
                    confirm["device_configs"] = out["configs"]
                    confirm["witness_prefix_ops"] = len(target)
                    return confirm
        return out

    def __call__(self, test, history, opts=None):
        return self.check(test, history, opts)


def linearizable(model=None, **kw) -> Linearizable:
    return Linearizable(model, **kw)
