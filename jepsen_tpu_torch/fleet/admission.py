"""Admission control and the fleet's scale signal.

The stream service sheds per-run and per-connection overload (op
budgets, bounded ingest queues); the fleet decides one level up whether
a run is admitted at all and whether the tier is sized right.
:class:`AdmissionController` folds the aggregated worker stats (shed
rate, open runs, fold backlog) into one of three decisions (a cold
fleet verdict cache damps ``spawn-worker`` down to ``accept``: see
``AdmissionPolicy.spawn_min_cache_hit_ratio``):

``accept``
    steady state: route the run.
``shed``
    the tier is past its ceiling: refuse the run at the door (the
    router answers the header with an ``overloaded`` reply).
``spawn-worker``
    load is climbing but not critical: admit the run and signal the
    supervisor (``fleet/__main__.py``) to add a worker, damped by
    ``min_spawn_interval_s``.

Thresholds in, a decision out, every decision counted on
``jtpu_fleet_admission_total``.  The JAX package's
``fleet/admission.py``, decision for decision.
"""

from __future__ import annotations

import dataclasses

from ..obs import metrics as obs_metrics

_M_ADMIT = obs_metrics.REGISTRY.counter(
    "jtpu_fleet_admission_total",
    "Fleet admission decisions (accept/shed/spawn-worker)",
    ("decision",))


@dataclasses.dataclass
class AdmissionPolicy:
    """Thresholds for the three-way decision.

    ``max_open_runs`` is the hard fleet-wide ceiling (shed past it);
    ``spawn_open_runs`` the soft one (scale signal).  ``shed_rate``
    thresholds read the workers' own shed counters as a fraction of
    ops ingested over the sampling window: workers already shedding
    means the tier is undersized long before open-runs says so.
    ``max_fold_backlog`` bounds the summed segment-fold queue depth
    (jtpu_stream_cells_open) the same way."""

    max_open_runs: int = 512
    spawn_open_runs: int = 64
    max_shed_rate: float = 0.5
    spawn_shed_rate: float = 0.02
    max_fold_backlog: int = 4096
    min_spawn_interval_s: float = 10.0
    #: verdict-cache damping: while the fleet cache's cumulative hit
    #: ratio sits below this, spawn signals downgrade to ``accept`` —
    #: a cold cache means the tier is still warming shapes, and a new
    #: worker would boot even colder (it re-misses everything the
    #: incumbents are busy inserting).  Only consulted once the cache
    #: has seen ``cache_signal_min_lookups`` lookups: an empty store
    #: at boot says nothing about sizing.
    spawn_min_cache_hit_ratio: float = 0.2
    cache_signal_min_lookups: int = 256


def scale_signal(merged: dict) -> dict:
    """Distill an aggregated ``/api/stats`` snapshot (router's merged
    worker scrape) into the controller's inputs."""

    def _num(v) -> float:
        if isinstance(v, dict):
            return float(sum(_num(x) for x in v.values()))
        try:
            return float(v)
        except (TypeError, ValueError):
            return 0.0

    def _label(v, key) -> float:
        # a labelled counter merges to {label_value: n}; a worker that
        # never fired it may report a bare 0
        return _num(v.get(key, 0)) if isinstance(v, dict) else 0.0

    values = merged.get("values", merged) or {}
    vc = values.get("jtpu_verdict_cache_total", 0)
    return {
        "open_runs": _num(values.get("jtpu_stream_runs_open", 0)),
        "fold_backlog": _num(values.get("jtpu_stream_cells_open", 0)),
        "shed_total": _num(values.get("jtpu_shed_total", 0)),
        "ops_total": _num(
            values.get("jtpu_stream_ops_ingested_total", 0)),
        # FleetCacheStore lookups ride the same verdict-cache counter
        # every VerdictCache feeds; hits/misses (not inserts) are the
        # warmth signal the spawn damping reads
        "cache_hits": _label(vc, "hit"),
        "cache_misses": _label(vc, "miss"),
    }


class AdmissionController:
    """Stateful three-way gate over successive :func:`scale_signal`
    samples.  Shed/ops totals are monotonic counters, so the shed
    *rate* is computed over the delta between samples."""

    def __init__(self, policy: AdmissionPolicy | None = None,
                 clock=None):
        import threading
        import time

        self.policy = policy or AdmissionPolicy()
        self._clock = clock or time.monotonic
        # decide() runs on every router connection-handler thread
        # (fleet/router.py _Session.handle_line): the rate window
        # (_last_shed/_last_ops), the spawn damper (_last_spawn) and
        # the decision counters are all read-modify-write state, so
        # one lock serializes the whole decision (T001)
        self._lock = threading.Lock()
        self._last_shed = 0.0
        self._last_ops = 0.0
        self._last_spawn = None
        self.decisions = {"accept": 0, "shed": 0, "spawn-worker": 0}

    def shed_rate(self, signal: dict) -> float:
        """Shed fraction over the window since the previous sample."""
        d_shed = max(0.0, signal.get("shed_total", 0.0)
                     - self._last_shed)
        d_ops = max(0.0, signal.get("ops_total", 0.0) - self._last_ops)
        denom = d_shed + d_ops
        return d_shed / denom if denom else 0.0

    def cache_hit_ratio(self, signal: dict) -> float | None:
        """Cumulative fleet verdict-cache hit ratio, or None while the
        cache has seen too few lookups to mean anything."""
        h = signal.get("cache_hits", 0.0)
        m = signal.get("cache_misses", 0.0)
        if h + m < self.policy.cache_signal_min_lookups:
            return None
        return h / (h + m)

    def decide(self, signal: dict) -> str:
        """One admission decision for the run knocking now.
        Thread-safe: concurrent handler threads serialize on the
        controller lock, so the rate window advances once per sample
        and the spawn damper can't double-fire in a burst."""
        p = self.policy
        with self._lock:
            rate = self.shed_rate(signal)
            self._last_shed = max(self._last_shed,
                                  signal.get("shed_total", 0.0))
            self._last_ops = max(self._last_ops,
                                 signal.get("ops_total", 0.0))
            open_runs = signal.get("open_runs", 0.0)
            backlog = signal.get("fold_backlog", 0.0)
            if (open_runs >= p.max_open_runs or rate >= p.max_shed_rate
                    or backlog >= p.max_fold_backlog):
                decision = "shed"
            elif open_runs >= p.spawn_open_runs \
                    or rate >= p.spawn_shed_rate:
                hit_ratio = self.cache_hit_ratio(signal)
                if hit_ratio is not None \
                        and hit_ratio < p.spawn_min_cache_hit_ratio:
                    # cold cache: the tier is still warming shapes, and
                    # a fresh worker boots colder still — admit, don't
                    # fork
                    decision = "accept"
                else:
                    now = self._clock()
                    if self._last_spawn is None or \
                            now - self._last_spawn \
                            >= p.min_spawn_interval_s:
                        self._last_spawn = now
                        decision = "spawn-worker"
                    else:
                        decision = "accept"  # damped: already sent
            else:
                decision = "accept"
            self.decisions[decision] += 1
        _M_ADMIT.inc(decision=decision)
        return decision
