"""Device-search telemetry: the aux counter block of every device slice.

The search runs tens to thousands of levels per bounded device call
(``device.slice``), so without it the slice's wall time is the finest
thing a caller sees.  Each telemetry build of a slice function (the
torch step, ``checker/step.py``, and the fused CUDA level loop,
``csrc/level_loop.cu``) returns beside its carry a small int32 block,
one row per level, that nothing reads back: the carry, and so every
verdict, is the same with telemetry on or off.

Block schema (``TELE_ROWS`` x ``TELE_COLS`` int32; row = one level,
additive: levels past the buffer fold into the last row):

  col 0  occupancy     live frontier rows after the level's crash
                       closure
  col 1  expanded      valid candidate lanes (after the mask and the
                       closure)
  col 2  mask_killed   candidate lanes the must-order mask killed (0
                       when the search is unmasked)
  col 3  dedup_folds   successor states rewritten to the dead-value
                       token (0 when dedup is off)
  col 4  crash_rounds  crash-closure rounds the level ran
  col 5  next_count    rows carried into the next level
  col 6  overflow      1 iff this level newly overflowed (a bailed level
                       appears with overflow=1 and runs again wider)
  col 7  goal          1 iff a goal configuration was found

On the host, :class:`SearchTelemetry` gathers the rows over a search's
slices, emits ``device.level`` spans under each ``device.slice`` (when
tracing is on), feeds the ``jtpu_search_*`` metrics and renders the
``search_telemetry`` result block, whose ``observed_prune_ratio`` reads
beside the prepass's predicted ``prune_ratio``.

Telemetry is on unless a caller passes ``telemetry=False`` to an entry
point; this module reads no environment.  A copy of the JAX package's
module with the same block, result dict, spans and metrics.
"""

from __future__ import annotations

import time

import numpy as np

from . import metrics as _metrics
from . import trace as _trace

#: aux block shape: one row per BFS level within a slice; levels past
#: the buffer fold additively into the last row
TELE_ROWS = 128
TELE_COLS = 8

#: column indices (see the module doc)
C_OCC, C_EXP, C_KILL, C_DEDUP, C_ROUNDS, C_NEXT, C_OVF, C_GOAL = range(8)

COLUMNS = ("occupancy", "expanded", "mask_killed", "dedup_folds",
           "crash_rounds", "next_count", "overflow", "goal")

#: per-level detail cap on the result block (totals are exact; the
#: per_level list is a bounded sample so result dicts stay storable)
BLOCK_LEVEL_CAP = 512


def resolve(flag: bool | None) -> bool:
    """An entry point's ``telemetry`` argument: None means on."""
    return True if flag is None else bool(flag)


_M_LEVELS = _metrics.REGISTRY.counter(
    "jtpu_search_levels_total",
    "Device BFS levels executed (telemetry-observed)")
_M_EXP = _metrics.REGISTRY.counter(
    "jtpu_search_expanded_total",
    "Valid candidate lanes expanded by device BFS levels")
_M_KILL = _metrics.REGISTRY.counter(
    "jtpu_search_mask_killed_total",
    "Candidate lanes killed on-device by the hb/dpor must-order mask")
_M_DEDUP = _metrics.REGISTRY.counter(
    "jtpu_search_dedup_folds_total",
    "Successor states folded onto the dead-value canonical token")
_M_ROUNDS = _metrics.REGISTRY.counter(
    "jtpu_search_crash_rounds_total",
    "Crash-closure rounds executed inside device BFS levels")
_M_OVF = _metrics.REGISTRY.counter(
    "jtpu_search_overflows_total",
    "Device BFS levels that overflowed their frontier width")
_M_RATIO = _metrics.REGISTRY.gauge(
    "jtpu_search_observed_prune_ratio",
    "Observed surviving-lane fraction of the most recent device "
    "search (expanded / (expanded + mask_killed + dedup_folds); "
    "0 = decided without search)")
_M_OCC = _metrics.REGISTRY.histogram(
    "jtpu_search_level_occupancy",
    "Live frontier rows per device BFS level",
    buckets=(1, 8, 64, 512, 4096, 32768, 262144))
_M_DEV_S = _metrics.REGISTRY.counter(
    "jtpu_device_seconds_total",
    "Wall seconds spent inside device.slice executions")
_M_XFER = _metrics.REGISTRY.counter(
    "jtpu_device_transfer_bytes_total",
    "Host<->device bytes staged for search dispatch, by direction",
    ("direction",))
_M_DEVMEM = _metrics.REGISTRY.gauge(
    "jtpu_device_memory_bytes",
    "bytes_in_use reported by the primary device (0 where the "
    "backend has no memory_stats)")


# ---------------------------------------------------------------------------
# host-side unpack and accumulation
# ---------------------------------------------------------------------------


def unpack_levels(tele: np.ndarray) -> list[dict]:
    """One aux block ([TELE_ROWS, TELE_COLS] int32) as level dicts,
    dropping rows never written (occupancy 0: a level runs only with a
    live frontier, so every level that ran has occupancy >= 1)."""
    t = np.asarray(tele)
    if t.ndim != 2 or t.shape[1] != TELE_COLS:
        raise ValueError(f"aux block must be [rows, {TELE_COLS}], "
                         f"got {t.shape}")
    out = []
    for r in t:
        if int(r[C_OCC]) <= 0:
            continue
        out.append({name: int(r[i]) for i, name in enumerate(COLUMNS)})
    return out


def observed_prune_ratio(expanded: int, killed: int, folds: int):
    """Surviving-lane fraction, the observed twin of the prepass's
    predicted ``prune_ratio`` (both in (0, 1], smaller = more pruned; 0
    is kept for searches decided with no device work).  None when
    nothing expanded and nothing was killed."""
    den = expanded + killed + folds
    if den <= 0:
        return None
    return round(expanded / den, 6)


class SearchTelemetry:
    """The aux blocks of ONE search, gathered over its device slices.

    ``add_slice`` takes a 2-D block (with the slice's wall window, for
    ``device.level`` spans); ``add_totals`` takes a batch's blocks,
    where the keys' levels do not align and only totals are kept.
    ``block()`` renders the ``search_telemetry`` result dict."""

    def __init__(self, engine: str = "device-bfs"):
        self.engine = engine
        self.levels: list[dict] = []
        self.totals = {name: 0 for name in COLUMNS}
        self.n_levels = 0
        self.max_occupancy = 0
        self.slices = 0
        self.truncated = False  # some slice folded levels into its
        #                         last row (lvl_cap > TELE_ROWS)

    def _tally(self, rows: list[dict]) -> None:
        for r in rows:
            for name in COLUMNS:
                self.totals[name] += r[name]
            self.max_occupancy = max(self.max_occupancy, r["occupancy"])
        self.n_levels += len(rows)

    def add_slice(self, tele: np.ndarray, t0: float | None = None,
                  t1: float | None = None,
                  frontier: int | None = None) -> None:
        """Take one slice's aux block.  ``t0``/``t1`` (perf_counter
        readings around the slice) turn on ``device.level`` spans,
        the window shared out by occupancy: a level's cost grows with
        its frontier, so occupancy is the cheap honest estimate."""
        rows = unpack_levels(tele)
        self.slices += 1
        if not rows:
            return
        t = np.asarray(tele)
        if int(t[TELE_ROWS - 1, C_OCC]) > 0 and len(rows) == TELE_ROWS:
            # the last row is additive: with every row written it may
            # hold the fold of levels past the buffer
            self.truncated = True
        base_level = self.n_levels
        self._tally(rows)
        self.levels.extend(rows)
        if t0 is not None and t1 is not None and _trace.enabled():
            rec = _trace.recorder(_trace.current_run())
            occ_sum = sum(r["occupancy"] for r in rows) or 1
            cur = t0
            span = max(0.0, t1 - t0)
            for i, r in enumerate(rows):
                frac = r["occupancy"] / occ_sum
                end = min(t1, cur + span * frac)
                args = {"level": base_level + i, **r}
                if frontier is not None:
                    args["frontier"] = frontier
                rec.record("device.level", "device", cur, end, args)
                cur = end

    def add_totals(self, tele: np.ndarray) -> None:
        """Take an aggregate block (a batch's ``[B, R, C]`` blocks sum
        over the keys): totals and level count only; the rows of
        differently paced keys do not align, so none are kept."""
        t = np.asarray(tele)
        if t.ndim == 3:
            t = t.sum(axis=0)
        rows = unpack_levels(t)
        self.slices += 1
        self._tally(rows)

    def block(self, predicted: float | None = None) -> dict:
        """The ``search_telemetry`` result block.  ``predicted`` is the
        prepass's prune_ratio where one was computed, recorded beside
        the observed ratio.  Counters only, no wall times: reruns of the
        same search give the same block."""
        tt = self.totals
        obs_ratio = observed_prune_ratio(
            tt["expanded"], tt["mask_killed"], tt["dedup_folds"])
        out = {
            "levels": self.n_levels,
            "slices": self.slices,
            "max_occupancy": self.max_occupancy,
            "expanded": tt["expanded"],
            "mask_killed": tt["mask_killed"],
            "dedup_folds": tt["dedup_folds"],
            "crash_rounds": tt["crash_rounds"],
            "overflows": tt["overflow"],
            "goals": tt["goal"],
            "observed_prune_ratio": obs_ratio,
            "truncated": self.truncated,
        }
        if predicted is not None:
            out["predicted_prune_ratio"] = predicted
            if obs_ratio is not None:
                out["prune_ratio_delta"] = round(obs_ratio - predicted,
                                                 6)
        per = [[r[name] for name in COLUMNS]
               for r in self.levels[:BLOCK_LEVEL_CAP]]
        if per:
            out["per_level"] = per
            out["per_level_columns"] = list(COLUMNS)
            if self.n_levels > len(per):
                out["per_level_capped"] = True
        return out


def emit_shard_levels(tele: np.ndarray, n_used: int, n_shards: int,
                      t0: float, t1: float) -> None:
    """Per-shard ``device.level`` spans of one sharded batch slice:
    ``tele`` is its ``[B, TELE_ROWS, TELE_COLS]`` lane-stacked block, in
    ``n_shards`` contiguous blocks of lanes.  Lanes at or past ``n_used``
    are the inert pad keys and are left out.  Each shard's lane sum
    becomes its own spans (``shard=i``), the slice's window shared out by
    occupancy as :meth:`SearchTelemetry.add_slice` does.  Only while
    tracing; the totals are the caller's accumulator's."""
    if not _trace.enabled():
        return
    t = np.asarray(tele)
    if t.ndim != 3 or n_shards <= 0 or t.shape[0] % n_shards:
        return
    per = t.shape[0] // n_shards
    rec = _trace.recorder(_trace.current_run())
    span = max(0.0, t1 - t0)
    for s in range(n_shards):
        lo = s * per
        used = min(max(0, n_used - lo), per)
        if used <= 0:
            continue  # only pad keys ran here
        rows = unpack_levels(t[lo:lo + used].sum(axis=0))
        if not rows:
            continue
        occ_sum = sum(r["occupancy"] for r in rows) or 1
        cur = t0
        for i, r in enumerate(rows):
            end = min(t1, cur + span * (r["occupancy"] / occ_sum))
            rec.record("device.level", "device", cur, end,
                       {"level": i, "shard": s, "lanes": used, **r})
            cur = end


def _predicted_ratio(result: dict | None, hbres=None):
    """The prepass's predicted prune_ratio for this search, if any: the
    live prepass stats (``hbres``) first, else the result's ``hb``
    block."""
    st = None
    if hbres is not None:
        st = getattr(hbres, "stats", None)
    if st is None and isinstance(result, dict):
        hb = result.get("hb")
        if isinstance(hb, dict):
            st = hb
    if isinstance(st, dict) and "prune_ratio" in st:
        try:
            return float(st["prune_ratio"])
        except (TypeError, ValueError):
            return None
    return None


def finalize_result(result: dict, acc: "SearchTelemetry | None", *,
                    hbres=None, attach: bool = True,
                    device=None) -> dict:
    """Close one search's telemetry: compute the block, attach it to
    the result (``attach``), bump the ``jtpu_search_*`` metrics, read
    ``device``'s memory into its gauge, and emit the
    ``search.telemetry`` span (when tracing is on).  ``acc`` None (the
    caller turned telemetry off) leaves the result as it is."""
    if acc is None:
        return result
    predicted = _predicted_ratio(result, hbres)
    blk = acc.block(predicted=predicted)
    tt = acc.totals
    if acc.n_levels:
        _M_LEVELS.inc(acc.n_levels)
        _M_EXP.inc(tt["expanded"])
        _M_KILL.inc(tt["mask_killed"])
        _M_DEDUP.inc(tt["dedup_folds"])
        _M_ROUNDS.inc(tt["crash_rounds"])
        _M_OVF.inc(tt["overflow"])
        for r in acc.levels[:BLOCK_LEVEL_CAP]:
            _M_OCC.observe(r["occupancy"])
    if blk.get("observed_prune_ratio") is not None:
        _M_RATIO.set(blk["observed_prune_ratio"])
    update_device_memory(device)
    if attach:
        result["search_telemetry"] = blk
    _emit_span(blk)
    return result


def emit_decided(result: dict, hbres=None, telemetry: bool = True) -> dict:
    """Telemetry of a search the prepass decided with no device work:
    an all-zero block whose observed ratio is 0.0, beside the predicted
    0.0.  Span only: a decided result keeps its certificate's shape (no
    ``search_telemetry`` key), but a trace still carries the row.
    ``telemetry`` False does nothing."""
    if not telemetry:
        return result
    predicted = _predicted_ratio(result, hbres)
    blk = {"levels": 0, "slices": 0, "max_occupancy": 0, "expanded": 0,
           "mask_killed": 0, "dedup_folds": 0, "crash_rounds": 0,
           "overflows": 0, "goals": 0, "observed_prune_ratio": 0.0,
           "decided": True, "truncated": False}
    blk["predicted_prune_ratio"] = predicted if predicted is not None \
        else 0.0
    blk["prune_ratio_delta"] = round(0.0 - blk["predicted_prune_ratio"],
                                     6)
    _M_RATIO.set(0.0)
    _emit_span(blk)
    return result


def _emit_span(blk: dict) -> None:
    if not _trace.enabled():
        return
    now = time.perf_counter()
    args = {k: v for k, v in blk.items()
            if k not in ("per_level", "per_level_columns")}
    _trace.recorder(_trace.current_run()).record(
        "search.telemetry", "telemetry", now, now, args)


# ---------------------------------------------------------------------------
# compile, transfer and memory accounting
# ---------------------------------------------------------------------------


def record_device_seconds(dt: float) -> None:
    """One device slice's wall seconds: the numerator of the derived
    ``device_idle_fraction``."""
    if dt > 0:
        _M_DEV_S.inc(dt)


def record_transfer(nbytes: int, direction: str = "h2d") -> None:
    """Host-to-device staging, counted in bytes, with a
    ``device.transfer`` span when tracing is on."""
    if nbytes <= 0:
        return
    _M_XFER.inc(nbytes, direction=direction)
    if _trace.enabled():
        now = time.perf_counter()
        _trace.recorder(_trace.current_run()).record(
            "device.transfer", "device", now, now,
            {"bytes": int(nbytes), "direction": direction})


def transfer_bytes(arrays) -> int:
    """Total bytes of the arrays or tensors about to be staged."""
    total = 0
    for a in arrays:
        nb = getattr(a, "nbytes", None)
        if nb:
            total += int(nb)
    return total


def compile_span(**attrs):
    """The ``device.compile`` span around one slice function's build on
    a cache miss (a hit never enters it).  ``persistent_cache`` says
    whether the kernel libraries were already in the build directory
    (``jepsen_tpu_torch/_build.py``, the port's persistent compile
    cache), so a cold start's build shows in the trace."""
    from .. import _build

    return _trace.span("device.compile", cat="device", cache="miss",
                       persistent_cache=_build.prebuilt(), **attrs)


def update_device_memory(device=None) -> None:
    """Set the device-memory gauge to ``torch.cuda.memory_allocated`` of
    a CUDA ``device``; on the CPU the gauge is left as it is (0)."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        _M_DEVMEM.set(float(torch.cuda.memory_allocated(dev)))
