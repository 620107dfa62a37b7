"""Trace summary: fold a Chrome trace into a phase-time table.

Of a run's wall clock, how much was device work, how much host prep and
fold work, and how much nothing at all (idle: the pipelining headroom).
``python -m jepsen_tpu_torch.obs report`` prints it.  A copy of the JAX
package's ``obs/report.py``: it folds either package's traces (the
port's ``device.compile`` spans carry ``engine`` ``cuda``, ``torch`` or
``device-sharded`` and a ``telemetry`` coordinate, which the table does
not read).

Per-category *busy* time is the **interval union** of that category's
spans (two overlapped device dispatches don't double-bill), and idle
is the run extent minus the union of every non-envelope span —
envelope categories (the ``run`` span wrapping the whole test) exist
to anchor the extent, not to claim the time.
"""

from __future__ import annotations

import json

#: categories that wrap other work rather than doing any themselves
ENVELOPE_CATS = ("run",)


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _union_us(ivs: list[tuple[float, float]]) -> float:
    """Total length of the union of [start, end) microsecond intervals."""
    if not ivs:
        return 0.0
    ivs = sorted(ivs)
    total = 0.0
    cur_s, cur_e = ivs[0]
    for s, e in ivs[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def _telemetry_table(events: list) -> dict | None:
    """The device-search telemetry section of a report, from the
    ``device.level`` / ``search.telemetry`` / ``device.compile`` /
    ``device.transfer`` spans a telemetry-on traced run records
    (obs/telemetry.py).  ``None`` when the trace predates telemetry
    (or ran with it off) — callers keep their pre-telemetry shape."""
    levels = [e for e in events if e.get("name") == "device.level"]
    tele = [e for e in events if e.get("name") == "search.telemetry"]
    compiles = [e for e in events if e.get("name") == "device.compile"]
    transfers = [e for e in events
                 if e.get("name") == "device.transfer"]
    if not (levels or tele):
        return None
    out: dict = {}
    if levels:
        per: dict[int, dict] = {}
        for e in levels:
            a = e.get("args") or {}
            lvl = int(a.get("level", 0))
            r = per.setdefault(lvl, {"level": lvl, "occupancy": 0,
                                     "expanded": 0, "mask_killed": 0,
                                     "dedup_folds": 0, "busy_s": 0.0})
            for k in ("occupancy", "expanded", "mask_killed",
                      "dedup_folds"):
                r[k] += int(a.get(k, 0))
            r["busy_s"] = round(r["busy_s"]
                                + e.get("dur", 0) / 1e6, 6)
        rows = [per[k] for k in sorted(per)]
        for r in rows:
            den = (r["expanded"] + r["mask_killed"]
                   + r["dedup_folds"])
            r["mask_kill_pct"] = (round(100 * r["mask_killed"] / den,
                                        1) if den else None)
            r["dedup_fold_pct"] = (round(100 * r["dedup_folds"] / den,
                                         1) if den else None)
        out["levels"] = rows
        out["max_occupancy"] = max(r["occupancy"] for r in rows)
    if tele:
        # one span per finished search; totals across the trace plus
        # the LAST search's predicted-vs-observed prune row (bench
        # tiers run one search per trace, so last == the search)
        tot = {"searches": len(tele), "expanded": 0, "mask_killed": 0,
               "dedup_folds": 0, "overflows": 0}
        last = (tele[-1].get("args") or {})
        for e in tele:
            a = e.get("args") or {}
            for k in ("expanded", "mask_killed", "dedup_folds",
                      "overflows"):
                tot[k] += int(a.get(k, 0) or 0)
        for k in ("observed_prune_ratio", "predicted_prune_ratio",
                  "prune_ratio_delta"):
            if last.get(k) is not None:
                tot[k] = last[k]
        if last.get("decided"):
            tot["decided"] = True
        out["search"] = tot
    if compiles:
        out["compiles"] = {
            "count": len(compiles),
            "total_s": round(sum(e.get("dur", 0)
                                 for e in compiles) / 1e6, 4),
            "persistent_cache": bool(
                (compiles[0].get("args") or {}).get(
                    "persistent_cache"))}
    if transfers:
        out["transfer_bytes"] = sum(
            int((e.get("args") or {}).get("bytes", 0))
            for e in transfers)
    return out


def phase_table(trace: dict) -> dict:
    """-> {wall_s, phases: [{cat, spans, busy_s, pct}], idle_s,
    idle_pct, top: [{name, count, total_s}]} for one Chrome trace;
    traces recorded with device telemetry on additionally carry a
    ``telemetry`` section (per-level table, predicted-vs-observed
    prune, compile/transfer accounting)."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X"]
    if not events:
        return {"wall_s": 0.0, "phases": [], "idle_s": 0.0,
                "idle_pct": None, "top": []}
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e.get("dur", 0) for e in events)
    wall_us = max(0.0, t1 - t0)

    by_cat: dict[str, list] = {}
    by_name: dict[str, list] = {}
    for e in events:
        by_cat.setdefault(e.get("cat") or "span", []).append(e)
        by_name.setdefault(e.get("name") or "?", []).append(e)

    phases = []
    work_ivs = []
    for cat in sorted(by_cat):
        ivs = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in by_cat[cat]]
        busy = _union_us(ivs)
        if cat not in ENVELOPE_CATS:
            work_ivs.extend(ivs)
        phases.append({"cat": cat, "spans": len(ivs),
                       "busy_s": round(busy / 1e6, 4),
                       "pct": round(100 * busy / wall_us, 1)
                       if wall_us else None})
    phases.sort(key=lambda p: -p["busy_s"])
    idle_us = max(0.0, wall_us - _union_us(work_ivs))
    top = sorted(({"name": n,
                   "count": len(es),
                   "total_s": round(sum(e.get("dur", 0)
                                        for e in es) / 1e6, 4)}
                  for n, es in by_name.items()),
                 key=lambda r: -r["total_s"])[:12]
    out = {"wall_s": round(wall_us / 1e6, 4),
           "phases": phases,
           "idle_s": round(idle_us / 1e6, 4),
           "idle_pct": round(100 * idle_us / wall_us, 1)
           if wall_us else None,
           "top": top}
    t = _telemetry_table(events)
    if t is not None:
        out["telemetry"] = t
    return out


def render_report(rep: dict) -> str:
    """The human table the CLI prints."""
    lines = [f"wall: {rep['wall_s']}s   idle: {rep['idle_s']}s"
             + (f" ({rep['idle_pct']}%)"
                if rep.get("idle_pct") is not None else "")]
    if rep["phases"]:
        lines.append(f"{'phase':<12} {'spans':>6} {'busy_s':>10} "
                     f"{'% wall':>7}")
        for p in rep["phases"]:
            pct = "" if p["pct"] is None else f"{p['pct']:>6.1f}%"
            lines.append(f"{p['cat']:<12} {p['spans']:>6} "
                         f"{p['busy_s']:>10.4f} {pct:>7}")
    if rep["top"]:
        lines.append("")
        lines.append(f"{'span':<32} {'count':>6} {'total_s':>10}")
        for r in rep["top"]:
            lines.append(f"{r['name']:<32} {r['count']:>6} "
                         f"{r['total_s']:>10.4f}")
    t = rep.get("telemetry")
    if t:
        lines.append("")
        lines.append("device search telemetry")
        s = t.get("search")
        if s:
            obs_r = s.get("observed_prune_ratio")
            pred = s.get("predicted_prune_ratio")
            row = (f"prune ratio: observed "
                   f"{'n/a' if obs_r is None else obs_r}")
            if pred is not None:
                row += f"  predicted {pred}"
                if s.get("prune_ratio_delta") is not None:
                    row += f"  delta {s['prune_ratio_delta']}"
            if s.get("decided"):
                row += "  (decided statically — no device levels)"
            lines.append(row)
            lines.append(f"expanded {s['expanded']}  mask-killed "
                         f"{s['mask_killed']}  dedup-folds "
                         f"{s['dedup_folds']}  overflows "
                         f"{s['overflows']}")
        c = t.get("compiles")
        if c:
            lines.append(f"kernel compiles (cache misses): "
                         f"{c['count']} in {c['total_s']}s"
                         + ("  [persistent cache]"
                            if c.get("persistent_cache") else ""))
        if t.get("transfer_bytes"):
            lines.append(f"h2d transfer: {t['transfer_bytes']} bytes")
        rows = t.get("levels") or []
        if rows:
            lines.append(f"{'level':>5} {'occupancy':>9} "
                         f"{'expanded':>9} {'mask-kill%':>10} "
                         f"{'dedup%':>7} {'busy_s':>9}")

            def fmt(r):
                mk = r.get("mask_kill_pct")
                df = r.get("dedup_fold_pct")
                return (f"{r['level']:>5} {r['occupancy']:>9} "
                        f"{r['expanded']:>9} "
                        f"{'-' if mk is None else mk:>10} "
                        f"{'-' if df is None else df:>7} "
                        f"{r['busy_s']:>9.4f}")

            # head + tail, elided middle: a 500-level search must not
            # print 500 rows
            if len(rows) <= 24:
                lines.extend(fmt(r) for r in rows)
            else:
                lines.extend(fmt(r) for r in rows[:12])
                lines.append(f"  ... {len(rows) - 24} level(s) "
                             f"elided ...")
                lines.extend(fmt(r) for r in rows[-12:])
    return "\n".join(lines)
