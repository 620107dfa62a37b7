"""The metrics registry: what the checker is doing right now.

Counters, gauges and histograms with optional labels, rendered in
Prometheus text exposition format (:func:`render`) and as a JSON
snapshot (:func:`snapshot`).  No dependencies, one process-wide
:data:`REGISTRY`.  A copy of the JAX package's registry with the same
``jtpu_*`` metric names, so the two packages' scrapes read alike.

Metrics are always on: a bump is one lock acquire and one dict update.
Handles are created once at module scope (``M = REGISTRY.counter(
"jtpu_x_total", "...")``) and bumped with ``M.inc(...)``.

Naming follows Prometheus: the ``jtpu_`` prefix, ``_total`` on
counters, base-unit ``_seconds`` on histograms; label names are closed
enums (``route``, ``event``, ``reason``), never unbounded ids.
"""

from __future__ import annotations

import threading
import time

#: process epoch for the derived device-idle fraction (/api/stats):
#: idle = 1 - device-busy seconds / process uptime
_PROC_EPOCH = time.monotonic()


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers without the trailing .0."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _labels_str(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    body = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + body + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, labelnames=()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {sorted(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)


class Counter(_Metric):
    """Monotonically increasing count, optionally labelled."""

    kind = "counter"

    def __init__(self, name, help_, labelnames=()):
        super().__init__(name, help_, labelnames)
        self._v: dict[tuple, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._v[k] = self._v.get(k, 0) + n

    def value(self, **labels) -> float:
        return self._v.get(self._key(labels), 0)

    def total(self) -> float:
        """Sum across every label combination (ratio math, snapshots)."""
        return sum(self._v.values())

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._v.items())
        if not items and not self.labelnames:
            items = [((), 0)]
        for k, v in items:
            out.append(f"{self.name}"
                       f"{_labels_str(self.labelnames, k)} {_fmt(v)}")
        return out

    def snapshot(self):
        with self._lock:
            if not self.labelnames:
                return self._v.get((), 0)
            return {",".join(k): v for k, v in sorted(self._v.items())}


class Gauge(Counter):
    """A value that goes both ways (open runs, queue depths)."""

    kind = "gauge"

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def set(self, v: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._v[k] = float(v)

    def render(self) -> list[str]:
        out = super().render()
        out[1] = f"# TYPE {self.name} gauge"
        return out


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus ``le`` convention)."""

    kind = "histogram"

    #: default buckets: wall-clock seconds from sub-ms folds to
    #: multi-minute device searches
    DEFAULT_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.5, 2.0, 10.0, 60.0)

    def __init__(self, name, help_, labelnames=(), buckets=None):
        super().__init__(name, help_, labelnames)
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self._counts: dict[tuple, list[int]] = {}
        self._sum: dict[tuple, float] = {}
        self._n: dict[tuple, int] = {}

    def observe(self, v: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            c = self._counts.get(k)
            if c is None:
                c = self._counts[k] = [0] * len(self.buckets)
                self._sum[k] = 0.0
                self._n[k] = 0
            for i, le in enumerate(self.buckets):
                if v <= le:
                    c[i] += 1
            self._sum[k] += v
            self._n[k] += 1

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            keys = sorted(self._counts)
            for k in keys:
                base = list(zip(self.labelnames, k))
                for le, c in zip(self.buckets, self._counts[k]):
                    ls = _labels_str(
                        tuple(n for n, _ in base) + ("le",),
                        tuple(v for _, v in base) + (_fmt(le),))
                    out.append(f"{self.name}_bucket{ls} {c}")
                ls = _labels_str(
                    tuple(n for n, _ in base) + ("le",),
                    tuple(v for _, v in base) + ("+Inf",))
                out.append(f"{self.name}_bucket{ls} {self._n[k]}")
                plain = _labels_str(self.labelnames, k)
                out.append(f"{self.name}_sum{plain} "
                           f"{_fmt(round(self._sum[k], 6))}")
                out.append(f"{self.name}_count{plain} {self._n[k]}")
        return out

    def snapshot(self):
        with self._lock:
            return {",".join(k) if k else "": {
                "count": self._n[k],
                "sum": round(self._sum[k], 6)}
                for k in sorted(self._counts)}


class Registry:
    """Name -> metric; get-or-create is idempotent so modules can
    declare their handles independently."""

    def __init__(self):
        self._m: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help_, labelnames=(), **kw):
        with self._lock:
            m = self._m.get(name)
            if m is None:
                m = self._m[name] = cls(name, help_, labelnames, **kw)
            elif not isinstance(m, cls) \
                    or m.labelnames != tuple(labelnames):
                raise ValueError(f"metric {name!r} re-registered with a "
                                 f"different type or labels")
            return m

    def counter(self, name, help_, labelnames=()) -> Counter:
        return self._get(Counter, name, help_, labelnames)

    def gauge(self, name, help_, labelnames=()) -> Gauge:
        return self._get(Gauge, name, help_, labelnames)

    def histogram(self, name, help_, labelnames=(),
                  buckets=None) -> Histogram:
        return self._get(Histogram, name, help_, labelnames,
                         buckets=buckets)

    def get(self, name) -> _Metric | None:
        return self._m.get(name)

    def render(self) -> str:
        """The Prometheus text exposition body (``/metrics``)."""
        lines: list[str] = []
        for name in sorted(self._m):
            lines.extend(self._m[name].render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able {name: {type, help, values}} (``/api/stats``),
        plus the derived ratios dashboards actually want."""
        out = {name: {"type": m.kind, "help": m.help,
                      "values": m.snapshot()}
               for name, m in sorted(self._m.items())}
        out["derived"] = derived_stats(self)
        return out

    def reset(self) -> None:
        """Zero every metric IN PLACE (tests only).  The metric
        objects themselves survive — instrumented modules hold handles
        captured at import (``_M_OPS``, ``_M_SHED``, ...), and
        replacing the objects would silently orphan every one of
        them."""
        with self._lock:
            metrics = list(self._m.values())
        for m in metrics:
            with m._lock:
                if isinstance(m, Histogram):
                    m._counts.clear()
                    m._sum.clear()
                    m._n.clear()
                else:
                    m._v.clear()


def _ratio(num: float, den: float):
    return round(num / den, 4) if den else None


def derived_stats(reg: "Registry") -> dict:
    """The headline ratios: verdict/kernel cache hit ratio, bucket
    padding efficiency — computed from the raw counters so every
    surface (Prometheus, /api/stats, CLI) derives them identically."""
    out: dict = {}
    vc = reg.get("jtpu_verdict_cache_total")
    if isinstance(vc, Counter):
        h = vc.value(event="hit")
        m = vc.value(event="miss")
        out["verdict_cache_hit_ratio"] = _ratio(h, h + m)
    kc = reg.get("jtpu_kernel_cache_total")
    if isinstance(kc, Counter):
        h = kc.value(event="hit")
        m = kc.value(event="miss")
        out["kernel_cache_hit_ratio"] = _ratio(h, h + m)
    b = reg.get("jtpu_bucket_ops_total")
    if isinstance(b, Counter):
        out["bucket_padding_efficiency"] = _ratio(
            b.value(kind="useful"), b.value(kind="padded"))
    sb = reg.get("jtpu_shard_ops_total")
    if isinstance(sb, Counter):
        out["shard_padding_efficiency"] = _ratio(
            sb.value(kind="useful"), sb.value(kind="padded"))
    # device-idle fraction: of this process's lifetime, the share NOT
    # spent inside device.slice executions — the fleet strip's
    # is-the-accelerator-earning-its-keep gauge.  None until any
    # device time has been recorded (an all-host process is not
    # "100% idle accelerator", it has no accelerator story at all).
    ds = reg.get("jtpu_device_seconds_total")
    if isinstance(ds, Counter):
        busy = ds.total()
        up = max(1e-9, time.monotonic() - _PROC_EPOCH)
        out["device_idle_fraction"] = (
            round(max(0.0, 1.0 - busy / up), 4) if busy > 0 else None)
    pr = reg.get("jtpu_search_observed_prune_ratio")
    if isinstance(pr, Gauge):
        v = pr.value()
        out["observed_prune_ratio"] = v if v else None
    return out


#: the process-wide registry every instrumentation point feeds
REGISTRY = Registry()


def _declare(reg: Registry) -> None:
    """Declare the standing metric set so a fresh scrape shows the
    whole taxonomy (zeros included for the unlabelled ones) instead of
    only what has fired.  Modules re-obtain these handles by name."""
    reg.counter("jtpu_ops_total",
                "Client worker op completions by type",
                ("type",))
    reg.counter("jtpu_nemesis_ops_total",
                "Nemesis injections applied (completions)")
    reg.counter("jtpu_stream_ops_ingested_total",
                "History events ingested by streaming checkers")
    reg.counter("jtpu_stream_segments_folded_total",
                "Closed quiescence segments folded, by route",
                ("route",))
    reg.counter("jtpu_stream_forks_total",
                "Bounded :info lookahead forks, spawned vs capped",
                ("outcome",))
    reg.counter("jtpu_verdict_cache_total",
                "Verdict-cache lookups/writes (hit/miss/insert)",
                ("event",))
    reg.counter("jtpu_kernel_cache_total",
                "Compiled-kernel cache lookups (hit/miss)",
                ("event",))
    reg.counter("jtpu_bucket_ops_total",
                "Bucketed device batch rows, useful vs padded",
                ("kind",))
    reg.counter("jtpu_shard_ops_total",
                "Mesh-sharded bucketed batch rows, useful vs padded",
                ("kind",))
    reg.counter("jtpu_shed_total",
                "Ops/lines shed under backpressure, by reason",
                ("reason",))
    reg.counter("jtpu_backoff_exhausted_total",
                "Reconnect backoff schedules that ran out of budget")
    reg.counter("jtpu_watchdog_total",
                "Cell watchdog events (fired/killed)",
                ("event",))
    reg.counter("jtpu_campaign_cells_total",
                "Campaign cells finished, by status",
                ("status",))
    reg.counter("jtpu_hb_prepass_total",
                "HB pre-pass outcomes (decided_valid/decided_invalid/"
                "undecided/skipped)", ("outcome",))
    reg.counter("jtpu_hb_edges_total",
                "Forced/canonical HB edges inferred beyond real time, "
                "by kind", ("kind",))
    reg.counter("jtpu_hb_fold_total",
                "Streamed/decomposed segment folds answered by the HB "
                "interval pass")
    reg.gauge("jtpu_hb_prune_ratio",
              "pruned/raw config-bound ratio of the most recent HB "
              "pre-pass (0 = decided without search)")
    reg.counter("jtpu_dpor_sleep_prunes_total",
                "Host-DFS candidates skipped because they were "
                "sleeping (covered by an explored commuting sibling)")
    reg.counter("jtpu_dpor_dedup_total",
                "Canonical-state frontier dedup events, by site/kind",
                ("site", "event"))
    reg.counter("jtpu_dpor_mask_total",
                "Must-order mask effects by site (host frames/DFS "
                "candidates killed; masked rows shipped to device "
                "planes)", ("site",))
    reg.counter("jtpu_dpor_dup_edges_total",
                "Duplicate-op canonical must-order edges inferred")
    reg.gauge("jtpu_stream_runs_open",
              "Streaming runs currently open in this process")
    reg.histogram("jtpu_fold_seconds",
                  "Wall seconds per streamed segment fold")
    reg.histogram("jtpu_bucket_seconds",
                  "Wall seconds per bucket stage (prep/device)",
                  ("stage",))
    # device-search telemetry (obs/telemetry.py): what the kernels did
    # inside their device.slice windows, level by level
    reg.counter("jtpu_search_levels_total",
                "Device BFS levels executed (telemetry-observed)")
    reg.counter("jtpu_search_expanded_total",
                "Valid candidate lanes expanded by device BFS levels")
    reg.counter("jtpu_search_mask_killed_total",
                "Candidate lanes killed on-device by the hb/dpor "
                "must-order mask")
    reg.counter("jtpu_search_dedup_folds_total",
                "Successor states folded onto the dead-value "
                "canonical token")
    reg.counter("jtpu_search_crash_rounds_total",
                "Crash-closure rounds executed inside device BFS "
                "levels")
    reg.counter("jtpu_search_overflows_total",
                "Device BFS levels that overflowed their frontier "
                "width")
    reg.gauge("jtpu_search_observed_prune_ratio",
              "Observed surviving-lane fraction of the most recent "
              "device search (0 = decided without search)")
    reg.histogram("jtpu_search_level_occupancy",
                  "Live frontier rows per device BFS level",
                  buckets=(1, 8, 64, 512, 4096, 32768, 262144))
    # compile/transfer accounting (the fleet-warmup signal)
    reg.counter("jtpu_device_seconds_total",
                "Wall seconds spent inside device.slice executions")
    reg.counter("jtpu_device_transfer_bytes_total",
                "Host<->device bytes staged for search dispatch, "
                "by direction", ("direction",))
    reg.gauge("jtpu_device_memory_bytes",
              "bytes_in_use reported by the primary device (0 where "
              "the backend has no memory_stats)")
    # fleet tier (jepsen_tpu/fleet/): router + admission control
    reg.counter("jtpu_fleet_routed_total",
                "Run headers routed to a worker, by worker id",
                ("worker",))
    reg.counter("jtpu_fleet_rerouted_total",
                "Runs re-routed off their worker, by reason",
                ("reason",))
    reg.counter("jtpu_fleet_salvaged_total",
                "Dead-worker open runs finalized from the persist-dir "
                "salvage path")
    reg.counter("jtpu_fleet_probe_total",
                "Worker health probes, by result (ok/failed/dead)",
                ("result",))
    reg.counter("jtpu_fleet_admission_total",
                "Fleet admission decisions (accept/shed/spawn-worker)",
                ("decision",))
    reg.gauge("jtpu_fleet_workers",
              "Live (admitted, probe-passing) workers behind the "
              "router")


_declare(REGISTRY)

# the streamed multiset fold's counters (``analyze.constraints.
# MultisetFold``), in the process registry from the start so a scrape
# shows them before the first fold; outside _declare, which stays the
# JAX package's set (it registers these in its constraints module)
REGISTRY.counter("jtpu_constraint_fold_flips_total",
                 "Streamed multiset-fold verdict flips, by evidence kind",
                 ("kind",))
REGISTRY.counter("jtpu_constraint_fold_events_total",
                 "Events ingested by streamed multiset folds")


def render() -> str:
    return REGISTRY.render()


def snapshot() -> dict:
    return REGISTRY.snapshot()
