"""Performance analysis — latency and throughput graphs.

Reference: jepsen/src/jepsen/checker/perf.clj — latency point plots
(point-graph! 248), latency quantile plots (quantiles-graph! 301),
throughput plots (rate-graph! 351), with nemesis-active intervals shaded
(nemesis-regions 190) — all via a gnuplot subprocess.  Rebuilt on
matplotlib (host-side; the checker's numbers ride along the history, no
device work needed for O(n) stats).  matplotlib is imported only when a
graph is drawn; the numbers do not need it.
"""

from __future__ import annotations

from collections import defaultdict

from .. import store
from ..history import Op
from ..util import history_latencies, nemesis_intervals
from .core import Checker, compose

#: seconds per bucket for quantile/rate series (perf.clj dt=10)
DT = 10.0
QUANTILES = [0.5, 0.95, 0.99, 1.0]

TYPE_COLORS = {"ok": "#81BFFC", "info": "#FFA400", "fail": "#FF1E90"}


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def latencies_by_f_type(history: list[Op]):
    """{f: {type: [(t_seconds, latency_ms), ...]}}
    (perf.clj invokes-by-f-type + latency pairing)."""
    out: dict = defaultdict(lambda: defaultdict(list))
    for inv, comp, latency in history_latencies(history):
        if inv.process == "nemesis":
            continue
        t = (inv.time or 0) / 1e9
        out[inv.f][comp.type].append((t, latency / 1e6))
    return out


def nemesis_regions(history: list[Op]):
    """[(t0_seconds, t1_seconds)] nemesis-active windows
    (perf.clj:190-215)."""
    regions = []
    tmax = max((op.time or 0) for op in history) / 1e9 if history else 0
    for start, stop in nemesis_intervals(history):
        t0 = (start.time or 0) / 1e9
        t1 = (stop.time or 0) / 1e9 if stop is not None else tmax
        regions.append((t0, t1))
    return regions


def _shade_nemesis(ax, history):
    for t0, t1 in nemesis_regions(history):
        ax.axvspan(t0, t1, color="#FF8B8B", alpha=0.2, lw=0)


def quantiles(qs, values):
    """Value at each quantile (perf.clj:46-57 floor-index convention)."""
    s = sorted(values)
    if not s:
        return {}
    n = len(s)
    return {q: s[min(n - 1, int(n * q))] for q in qs}


def latencies_to_quantiles(dt, qs, points):
    """{q: [(bucket_midpoint_t, latency_at_q), ...]} (perf.clj:58-81)."""
    buckets: dict = defaultdict(list)
    for t, latency in points:
        b = int(t / dt) * dt + dt / 2
        buckets[b].append(latency)
    out = {q: [] for q in qs}
    for b in sorted(buckets):
        qv = quantiles(qs, buckets[b])
        for q in qs:
            out[q].append((b, qv[q]))
    return out


def point_graph(test, history, opts=None) -> str:
    """Raw latency scatter, color by completion type, one subplot-less
    figure per test (perf.clj:248-299)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 5))
    _shade_nemesis(ax, history)
    by_f = latencies_by_f_type(history)
    markers = ["o", "s", "^", "v", "D", "*"]
    for i, (f, by_type) in enumerate(sorted(by_f.items())):
        for typ, pts in sorted(by_type.items()):
            if not pts:
                continue
            xs, ys = zip(*pts)
            ax.plot(xs, ys, linestyle="", marker=markers[i % len(markers)],
                    markersize=3, alpha=0.6,
                    color=TYPE_COLORS.get(typ, "#888888"),
                    label=f"{f} {typ}")
    ax.set_yscale("log")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("latency (ms)")
    ax.set_title(f"{test.get('name', 'test')} latency (raw)")
    ax.legend(fontsize=7, loc="upper right")
    p = store.path_mkdirs(test, *(opts or {}).get("subdirectory", []),
                          "latency-raw.png")
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return p


def quantiles_graph(test, history, opts=None) -> str:
    """Latency quantiles over time (perf.clj:301-349)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 5))
    _shade_nemesis(ax, history)
    pts = []
    for inv, comp, latency in history_latencies(history):
        if inv.process != "nemesis" and comp.type == "ok":
            pts.append(((inv.time or 0) / 1e9, latency / 1e6))
    series = latencies_to_quantiles(DT, QUANTILES, pts)
    for q in QUANTILES:
        if series.get(q):
            xs, ys = zip(*series[q])
            ax.plot(xs, ys, marker="o", markersize=3, label=f"q={q}")
    ax.set_yscale("log")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("latency (ms)")
    ax.set_title(f"{test.get('name', 'test')} latency quantiles")
    ax.legend(fontsize=8)
    p = store.path_mkdirs(test, *(opts or {}).get("subdirectory", []),
                          "latency-quantiles.png")
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return p


def rate_graph(test, history, opts=None) -> str:
    """Completion rate by f and type over time (perf.clj:351-394)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 5))
    _shade_nemesis(ax, history)
    buckets: dict = defaultdict(lambda: defaultdict(float))
    for op in history:
        if op.type == "invoke" or op.process == "nemesis":
            continue
        b = int(((op.time or 0) / 1e9) / DT) * DT + DT / 2
        buckets[(op.f, op.type)][b] += 1 / DT
    for (f, typ), series in sorted(buckets.items()):
        xs = sorted(series)
        ys = [series[x] for x in xs]
        ax.plot(xs, ys, marker="o", markersize=3,
                color=TYPE_COLORS.get(typ, "#888888"), label=f"{f} {typ}")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("throughput (hz)")
    ax.set_title(f"{test.get('name', 'test')} rate")
    ax.legend(fontsize=7)
    p = store.path_mkdirs(test, *(opts or {}).get("subdirectory", []),
                          "rate.png")
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return p


class LatencyGraph(Checker):
    """checker.clj:408-415."""

    def check(self, test, history, opts=None):
        point_graph(test, history, opts)
        quantiles_graph(test, history, opts)
        return {"valid": True}


class RateGraph(Checker):
    """checker.clj:417-423."""

    def check(self, test, history, opts=None):
        rate_graph(test, history, opts)
        return {"valid": True}


def latency_graph() -> Checker:
    return LatencyGraph()


def rate_graph_checker() -> Checker:
    return RateGraph()


def perf() -> Checker:
    """checker.clj:425-429."""
    return compose({"latency-graph": LatencyGraph(),
                    "rate-graph": RateGraph()})
