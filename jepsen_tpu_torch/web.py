"""Results web UI (reference L8) — browse the store over HTTP.

Reference: jepsen/src/jepsen/web.clj — http-kit server with a home table
of runs (validity color-coded, web.clj:47-128), a file browser with
text/image previews (web.clj:194-248), and zip downloads of whole runs
(web.clj:250-292).  Rebuilt on the stdlib http.server (no extra deps);
same surface: `/` home, `/files/...` browser, `?zip` downloads; plus
`/campaigns` (the fault-injection campaigns' ``campaign.json``),
`/mc` (the bounded model checker's sweep), `/metrics` and `/api/stats`
(this process's metrics registry) and `/api/live/<test>/<time>` (a
streamed run's ``live.json``).  The pages are the JAX package's, byte
for byte, on the same store.

    python -m jepsen_tpu_torch.suites.atomdemo serve --port 8080
"""

from __future__ import annotations

import html
import io
import json
import logging
import os
import shutil
import urllib.parse
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import store
from .obs import metrics as obs_metrics

log = logging.getLogger("jepsen")

STYLE = """
body { font-family: sans-serif; margin: 2em; }
table { border-collapse: collapse; }
th, td { padding: .3em .8em; text-align: left; }
tr:nth-child(even) { background: #f4f4f4; }
.valid-true { background: #c7f0c2; }
.valid-false { background: #f0c2c2; }
.valid-unknown { background: #f0e9c2; }
a { text-decoration: none; }
pre { background: #f8f8f8; padding: 1em; overflow-x: auto; }
"""


def _read_valid(run_dir: str):
    p = os.path.join(run_dir, "results.json")
    try:
        with open(p) as f:
            return json.load(f).get("valid")
    except Exception:
        return None


def home_html(base: str) -> str:
    """The run table (web.clj:47-128)."""
    rows = []
    for name, runs in sorted(store.tests(base=base).items()):
        for t, d in sorted(runs.items(), reverse=True):
            valid = _read_valid(d)
            cls = {True: "valid-true", False: "valid-false",
                   "unknown": "valid-unknown"}.get(valid, "")
            rel = urllib.parse.quote(f"{name}/{t}")
            rows.append(
                f'<tr class="{cls}"><td><a href="/files/{rel}/">{html.escape(name)}'
                f"</a></td><td>{html.escape(t)}</td>"
                f"<td>{html.escape(str(valid))}</td>"
                f'<td><a href="/files/{rel}/?zip">zip</a></td></tr>')
    campaigns = ""
    if os.path.isdir(os.path.join(base, "campaigns")):
        campaigns = '<p><a href="/campaigns">fault-injection campaigns</a></p>'
    campaigns += '<p><a href="/mc">bounded model checker</a></p>'
    return (f"<html><head><title>Jepsen</title><style>{STYLE}</style></head>"
            f"<body><h1>Jepsen results</h1>{campaigns}<table>"
            f"<tr><th>test</th><th>time</th><th>valid?</th><th></th></tr>"
            f"{''.join(rows)}</table></body></html>")


# ---------------------------------------------------------------------------
# bounded model checker panel (analyze/modelcheck.py)
# ---------------------------------------------------------------------------

#: one sweep per process per scope unless ?refresh=1 — the default
#: scopes finish in a few seconds, but a dashboard page must not
#: re-search per click.  Keyed by scope ("core" / "shell").
_MC_CACHE: dict | None = None


def mc_html(refresh: bool = False, scope: str = "core") -> str:
    """The ``/mc`` page: the family x mode expected-outcome matrix
    (clean modes must clear their scope; seeded modes must be caught
    with replaying certificates), explored-scope numbers, and each
    violation's schedule certificate with its confirm verdicts.

    ``scope`` picks the family set: ``core`` runs the abstract
    MC1xx worlds, ``shell`` lifts the live daemons' dispatch code
    onto the simulated transport (MC2xx, docs/analyze.md §12)."""
    global _MC_CACHE
    from .analyze import modelcheck as mc

    if scope not in ("core", "shell"):
        scope = "core"
    if not isinstance(_MC_CACHE, dict) or "runs" in _MC_CACHE:
        # unset, or a bare sweep dict left by an older caller —
        # promote to the per-scope cache shape
        _MC_CACHE = {}
    if scope not in _MC_CACHE or refresh:
        _MC_CACHE[scope] = (mc.run_mc_sweep(mc.SHELL_FAMILIES)
                            if scope == "shell" else mc.run_mc_sweep())
    sweep = _MC_CACHE[scope]
    shell_families = set(mc.SHELL_FAMILIES)
    rows = []
    certs = []
    for r in sweep["runs"]:
        ex = r["explored"]
        r_scope = "shell" if r["family"] in shell_families else "core"
        seeded = r["mode"] != "clean"
        expected = (not r["ok"] and all(c.get("replayed")
                                        for c in r["violations"])) \
            if seeded else r["ok"]
        cls = "valid-true" if expected else "valid-false"
        codes = sorted({c["code"] for c in r["violations"]})
        verdict = ("caught " + ", ".join(codes)) if codes else "clean"
        rows.append(
            f'<tr class="{cls}"><td>{r_scope}</td>'
            f'<td>{html.escape(r["family"])}</td>'
            f'<td>{html.escape(r["mode"])}</td>'
            f"<td>{html.escape(verdict)}</td>"
            f"<td>{ex['states']}</td><td>{ex['schedules']}</td>"
            f"<td>{ex['prune_ratio']}</td><td>{ex['complete']}</td>"
            f"<td>{'as expected' if expected else 'UNEXPECTED'}</td>"
            f"</tr>")
        for c in r["violations"]:
            sched = " → ".join(f"{e[0]}({e[1]})" if e[1] is not None
                               else e[0] for e in c["schedule"])
            conf = c.get("confirm") or {}
            certs.append(
                f"<h3>{html.escape(c['code'])} — "
                f"{html.escape(r['family'])}/{html.escape(r['mode'])}"
                f"</h3><p>{html.escape(c['detail'])}</p>"
                f"<p><code>{html.escape(sched)}</code> "
                f"({c['shrunk']['n_from']} → {c['shrunk']['n_to']} "
                f"events, minimal={c['shrunk']['minimal']}, "
                f"replayed={c['replayed']})</p>"
                f"<p>confirm [{html.escape(str(conf.get('route')))}]: "
                f"engine valid={conf.get('engine_valid')}, "
                f"audit ok={conf.get('audit_ok')} "
                f"(checked {conf.get('audit_checked')})</p>")
    status = "ok — every mode behaved as expected" if sweep["ok"] \
        else "FAILED — some mode deviated from its expected outcome"
    return (f"<html><head><title>model checker</title>"
            f"<style>{STYLE}</style></head><body>"
            f"<h1>Bounded model checker</h1>"
            f'<p><a href="/">home</a> · '
            f'<a href="/mc?scope=core">core scope</a> · '
            f'<a href="/mc?scope=shell">shell scope</a> · '
            f'<a href="/mc?scope={scope}&refresh=1">re-run sweep</a></p>'
            f"<p>scope: {scope} — {html.escape(status)} "
            f"(MC1xx/MC2xx codes, schedule certificates — "
            f"docs/analyze.md §11–§12)</p><table>"
            f"<tr><th>scope</th><th>family</th><th>mode</th>"
            f"<th>verdict</th>"
            f"<th>states</th><th>schedules</th><th>prune ratio</th>"
            f"<th>complete</th><th>expected?</th></tr>"
            f"{''.join(rows)}</table>{''.join(certs)}</body></html>")


# ---------------------------------------------------------------------------
# campaign grid (live fault-injection campaigns: store/campaigns/)
# ---------------------------------------------------------------------------


def _load_campaign(base: str, cid: str) -> dict | None:
    p = os.path.join(base, "campaigns", cid, "campaign.json")
    try:
        with open(p) as f:
            out = json.load(f)
        return out if isinstance(out, dict) else None
    except Exception:
        return None


#: the /campaigns fleet-health strip: polls /api/stats every 5s and
#: shows the live registry's headline numbers (open runs, cache hit
#: ratio, sheds, watchdog firings) so a running fleet is glanceable
#: from the grid page itself
_HEALTH_STRIP = """
<p id="fleet-health" style="font-family:monospace"></p>
<script>
async function pollStats() {
  try {
    const r = await fetch("/api/stats");
    if (r.ok) {
      const s = await r.json();
      const v = (n) => {
        const m = s[n]; if (!m) return 0;
        const vv = m.values;
        return typeof vv === "number" ? vv
          : Object.values(vv || {}).reduce((a, b) => a + b, 0);
      };
      const d = s.derived || {};
      document.getElementById("fleet-health").textContent =
        "fleet: " + v("jtpu_stream_runs_open") + " open runs · "
        + "cache hit ratio " + (d.verdict_cache_hit_ratio ?? "n/a")
        + " · " + v("jtpu_shed_total") + " shed · watchdog "
        + v("jtpu_watchdog_total")
        + " · corpus " + v("jtpu_corpus_pool_size")
        + " · rules swept " + v("jtpu_link_rules_swept_total")
        + " · device idle " + (d.device_idle_fraction ?? "n/a")
        + " · observed prune " + (d.observed_prune_ratio ?? "n/a");
    }
  } catch (e) {}
  setTimeout(pollStats, 5000);
}
pollStats();
</script>"""


def campaigns_html(base: str) -> str:
    """The campaign index: one row per recorded campaign."""
    d = os.path.join(base, "campaigns")
    rows = []
    try:
        cids = sorted(os.listdir(d), reverse=True)
    except OSError:
        cids = []
    for cid in cids:
        c = _load_campaign(base, cid)
        if c is None:
            continue
        s = c.get("summary") or {}
        q = urllib.parse.quote(cid)
        rows.append(
            f'<tr><td><a href="/campaigns/{q}">{html.escape(cid)}</a>'
            f"</td><td>{s.get('ok', 0)}</td>"
            f"<td>{s.get('skipped', 0)}</td>"
            f"<td>{s.get('failed', 0)}</td>"
            f"<td>{s.get('detected', 0)}</td>"
            f"<td>{s.get('audited_ok', 0)}</td></tr>")
    return (f"<html><head><title>Campaigns</title><style>{STYLE}</style>"
            f"</head><body><h1>Fault-injection campaigns</h1>"
            f"<p><a href='/'>home</a></p>{_HEALTH_STRIP}<table>"
            f"<tr><th>campaign</th><th>ok</th><th>skipped</th>"
            f"<th>failed</th><th>violations detected</th>"
            f"<th>audited ok</th></tr>{''.join(rows)}</table>"
            f"</body></html>")


def campaign_html(base: str, cid: str) -> str:
    """One campaign as a family × nemesis grid: every executed cell is
    colored by its verdict and links to its run directory; skipped
    cells show their reason inline."""
    c = _load_campaign(base, cid)
    if c is None:
        return (f"<html><body>campaign {html.escape(cid)} has no "
                f"readable campaign.json</body></html>")
    cells = c.get("cells") or []
    fams = sorted({x["family"] for x in cells})
    nems = []
    for x in cells:
        if x["nemesis"] not in nems:
            nems.append(x["nemesis"])

    def cell_td(outs: list) -> str:
        parts = []
        for o in outs:
            label = "seeded: " if o.get("seeded") else ""
            # phase-time tooltip (cells.jsonl "phases"): slow cells are
            # diagnosable from the grid without rerunning them
            ph = o.get("phases") or {}
            tip = " · ".join(f"{k} {v}s" for k, v in ph.items())
            title = f' title="{html.escape(tip)}"' if tip else ""
            if o.get("status") == "ok":
                cls = {True: "valid-true",
                       False: "valid-false"}.get(o.get("valid"),
                                                 "valid-unknown")
                body = f"{label}{o.get('valid')}"
                det = o.get("detection") or {}
                if det.get("latency_s") is not None:
                    # the detection GRADE: streamed = the live verdict
                    # flipped mid-run (an online cut or the :info
                    # lookahead fork); finalize = only the close
                    # confirmed it (post-hoc marks model-less
                    # families, whose only close is the batch checker)
                    at = det.get("at") or "streamed"
                    if det.get("source") == "post-hoc":
                        at += "/post-hoc"
                    body += f" (detected in {det['latency_s']}s, {at})"
                elif det.get("at"):
                    at = det["at"]
                    if det.get("source") == "post-hoc":
                        at += "/post-hoc"
                    body += f" (detected at {at})"
                if (o.get("watchdog") or {}).get("fired"):
                    body += " [watchdog]"
                if o.get("attempts", 1) > 1:
                    body += f" [attempt {o['attempts']}]"
                rel = o.get("store")
                if rel:
                    # store paths are absolute-or-relative to the base;
                    # link via /files using the run's name/time suffix
                    tail = "/".join(str(rel).split(os.sep)[-2:])
                    body = (f'<a href="/files/{urllib.parse.quote(tail)}'
                            f'/">{html.escape(body)}</a>')
                parts.append(f'<div class="{cls}"{title}>{body}</div>')
            else:
                reason = html.escape(str(o.get("reason") or ""))
                parts.append(f'<div class="valid-unknown"{title}>'
                             f"{label}{o.get('status')}"
                             f"<br><small>{reason}</small></div>")
        return f"<td>{''.join(parts)}</td>"

    rows = []
    for f in fams:
        tds = []
        for n in nems:
            outs = [x for x in cells
                    if x["family"] == f and x["nemesis"] == n]
            tds.append(cell_td(outs))
        rows.append(f"<tr><th>{html.escape(f)}</th>{''.join(tds)}</tr>")
    s = c.get("summary") or {}
    return (f"<html><head><title>{html.escape(cid)}</title>"
            f"<style>{STYLE}</style></head><body>"
            f"<h1>campaign {html.escape(cid)}</h1>"
            f"<p><a href='/campaigns'>campaigns</a> | "
            f"<a href='/'>home</a></p>"
            f"<p>{s.get('ok', 0)} ok, {s.get('skipped', 0)} skipped, "
            f"{s.get('failed', 0)} failed — "
            f"{s.get('detected', 0)} violation(s) detected"
            f" ({s.get('streamed_detections', 0)} streamed), "
            f"{s.get('audited_ok', 0)} cell(s) audited ok</p>"
            f"<table><tr><th>family \\ nemesis</th>"
            + "".join(f"<th>{html.escape(n)}</th>" for n in nems)
            + f"</tr>{''.join(rows)}</table></body></html>")


#: unicode eighth-blocks for the depth/occupancy sparkline
_SPARK = "▁▂▃▄▅▆▇█"


def _occupancy_sparkline(st: dict, width: int = 60) -> str:
    """Frontier occupancy per BFS level as a text sparkline — the
    search's depth profile at a glance (``search_telemetry.per_level``
    col 0; empty string when the block carries no per-level rows)."""
    per = st.get("per_level")
    cols = st.get("per_level_columns") or []
    try:
        occ_i = cols.index("occupancy")
    except ValueError:
        occ_i = 0
    if not isinstance(per, list) or not per:
        return ""
    try:
        occ = [int(r[occ_i]) for r in per]
    except (TypeError, ValueError, IndexError):
        return ""
    if len(occ) > width:
        # fixed-stride downsample keeping the max of each window (a
        # spike is the interesting part of a depth profile)
        step = len(occ) / width
        occ = [max(occ[int(i * step):max(int(i * step) + 1,
                                         int((i + 1) * step))])
               for i in range(width)]
    hi = max(occ) or 1
    return ("".join(_SPARK[min(len(_SPARK) - 1,
                               (v * len(_SPARK)) // (hi + 1))]
                    for v in occ)
            + f"  ({len(per)} level(s), peak {hi})")


def result_block(result: dict) -> str:
    """The verdict panel for a run's result page: validity, engine,
    certificate summary, the static search plan when the result carries
    one (``--explain``), and the audit/shrink outcomes when present —
    so a browsing human sees WHY a verdict is trustworthy, not just
    what it was."""
    valid = result.get("valid")
    cls = {True: "valid-true", False: "valid-false",
           "unknown": "valid-unknown"}.get(valid, "")
    rows = [("valid", valid), ("engine", result.get("engine")),
            ("configs", result.get("configs"))]
    lin = result.get("linearization")
    if lin is not None:
        rows.append(("certificate",
                     f"linearization witness, {len(lin)} ops"))
    elif result.get("witness_dropped"):
        rows.append(("certificate",
                     f"witness dropped: {result['witness_dropped']}"))
    if result.get("hb_cycle") is not None:
        cyc = result["hb_cycle"]
        rows.append(("certificate",
                     f"HB cycle, {len(cyc)} forced edge(s): "
                     + " -> ".join(str(e.get("src")) for e in cyc[:6])
                     + " -> ..."))
    if result.get("queue_cycle") is not None:
        cyc = result["queue_cycle"]
        rows.append(("certificate",
                     f"queue order cycle, {len(cyc)} forced edge(s): "
                     + " -> ".join(f"{e.get('src')}[{e.get('kind')}]"
                                   for e in cyc[:6])))
    if result.get("queue_dup") is not None:
        dup = result["queue_dup"]
        rows.append(("certificate",
                     f"duplicate delivery: {len(dup.get('dequeues', ()))}"
                     f" dequeue(s) over "
                     f"{len(dup.get('enqueues', ()))} enqueue row(s)"))
    qe = result.get("queue_evidence")
    if isinstance(qe, dict):
        rows.append(("certificate",
                     f"{qe.get('kind')}: values "
                     f"{qe.get('values', [])[:6]} at event(s) "
                     f"{qe.get('rows', [])[:6]}"))
    if result.get("final_ops") is not None:
        rows.append(("blocking frontier",
                     f"{len(result['final_ops'])} ops "
                     f"{result['final_ops'][:10]}"))
    elif result.get("frontier_dropped"):
        rows.append(("blocking frontier",
                     f"dropped: {result['frontier_dropped']}"))
    hbs = result.get("hb")
    if isinstance(hbs, dict) and hbs.get("applies"):
        if hbs.get("decided") is not None:
            rows.append(("happens-before",
                         f"decided statically ({hbs.get('reason')}, "
                         f"no search)"))
        else:
            rows.append(("happens-before",
                         f"{hbs.get('must_edges', 0)} must-order "
                         f"edge(s) pruned the search "
                         f"{hbs.get('edges')}"))
    cs = result.get("constraints")
    if isinstance(cs, dict) and cs.get("applies"):
        if cs.get("decided") is not None:
            rows.append(("constraints",
                         f"[{cs.get('family')}] decided statically "
                         f"({cs.get('reason')}, no search)"))
        else:
            rows.append(("constraints",
                         f"[{cs.get('family')}] "
                         f"{cs.get('must_edges', 0)} must-order "
                         f"edge(s) pruned the search "
                         f"{cs.get('edges')}"))
    dp = result.get("dpor")
    if isinstance(dp, dict) and dp.get("enabled"):
        bits = []
        if dp.get("sleep_prunes"):
            bits.append(f"{dp['sleep_prunes']} sleep-set prune(s)")
        if dp.get("dedup_rewrites"):
            bits.append(f"{dp['dedup_rewrites']} dead-state "
                        f"rewrite(s), {dp.get('dedup_hits', 0)} "
                        f"frontier-dedup hit(s)")
        if dp.get("mask_lanes_killed") or dp.get("mask_skips"):
            bits.append(f"{dp.get('mask_lanes_killed') or dp.get('mask_skips')} "
                        f"mask-killed candidate(s)")
        if dp.get("device_masked"):
            bits.append(f"{dp.get('device_mask_rows', 0)} device-"
                        f"masked row(s)")
        rows.append(("dpor", "; ".join(bits) if bits
                     else "on (nothing to prune here)"))
    st = result.get("search_telemetry")
    if isinstance(st, dict):
        # the observed twin of the hb/dpor PREDICTED rows above: what
        # the device kernel actually did, level by level
        obs_r = st.get("observed_prune_ratio")
        pred = st.get("predicted_prune_ratio")
        line = (f"{st.get('levels', 0)} level(s) / "
                f"{st.get('slices', 0)} slice(s), max occupancy "
                f"{st.get('max_occupancy', 0)}; expanded "
                f"{st.get('expanded', 0)}, mask-killed "
                f"{st.get('mask_killed', 0)}, dedup-folded "
                f"{st.get('dedup_folds', 0)}")
        if obs_r is not None:
            line += f"; observed prune ratio {obs_r}"
            if pred is not None:
                line += (f" vs predicted {pred} "
                         f"(delta {st.get('prune_ratio_delta')})")
        if st.get("truncated"):
            line += " [per-level rows truncated]"
        rows.append(("device telemetry", line))
        spark = _occupancy_sparkline(st)
        if spark:
            rows.append(("depth/occupancy", spark))
    shb = result.get("shard_batch")
    if isinstance(shb, dict):
        # the mesh scheduler's padding story: tight per-bucket shapes
        # vs the fused single-shape counterfactual
        line = (f"{shb.get('n_buckets', 0)} bucket(s) over "
                f"{shb.get('n_devices', 0)} device(s), padding "
                f"efficiency {shb.get('padding_efficiency')}"
                f" (fused counterfactual "
                f"{shb.get('fused_padding_efficiency')}); "
                f"{shb.get('pad_keys', 0)} inert mesh pad lane(s)")
        if shb.get("overflow_redo"):
            line += f", {shb['overflow_redo']} overflow redo(s)"
        if shb.get("shard_map") is False:
            line += " [GSPMD fallback]"
        rows.append(("sharded batch", line))
    a = result.get("audit")
    if a:
        rows.append(("audit", "ok (checked %s)" % a.get("checked")
                     if a.get("ok")
                     else "FAILED: %s" % ", ".join(a.get("codes", []))))
    sh = result.get("shrink")
    if sh:
        bf = {True: "brute-force says VALID (divergence!)",
              False: "brute-force confirmed",
              None: "unconfirmed (too large)"}.get(sh.get("brute_force"))
        rows.append(("minimal counterexample",
                     f"{sh.get('n_from')} ops -> {sh.get('n_to')} "
                     f"({bf})"))
    sm = result.get("stream")
    if isinstance(sm, dict):
        # the streamed verdict next to the authoritative one: a run
        # result's "stream" is the service summary (stats nested), a
        # raw streamed result carries the stats dict directly
        st = sm.get("stream") if isinstance(sm.get("stream"), dict) \
            else sm
        rows.append(("streamed",
                     f"{sm.get('valid', st.get('valid'))} after "
                     f"{st.get('segments')} segment(s) / "
                     f"{st.get('events')} events; first verdict at "
                     f"event {st.get('first_verdict_event')}"))
    # verdict-cache reuse counters (decomposed or streamed route):
    # segment-level reuse across runs and fleets, measured not inferred
    for src in (result.get("decompose"),
                (result.get("stream") or {}).get("stream")
                if isinstance(result.get("stream"), dict) else None,
                result.get("stream")):
        if isinstance(src, dict) and "cache_hits" in src:
            rows.append(("verdict cache",
                         f"{src['cache_hits']} hits / "
                         f"{src['cache_misses']} misses / "
                         f"{src.get('cache_inserts', 0)} inserts"))
            break
    body = "".join(f"<tr><th>{html.escape(str(k))}</th>"
                   f"<td>{html.escape(str(v))}</td></tr>"
                   for k, v in rows)
    out = (f'<table class="{cls}"><caption>result</caption>{body}'
           f"</table>")
    plan = result.get("explain")
    if isinstance(plan, dict):
        # the plan block next to the verdict: dims, bucket, engine
        # route, decomposition applicability — analyze.plan's renderer
        # is the ONE formatter, here as everywhere
        try:
            from .analyze.plan import render_plan

            out += f"<h3>Search plan</h3><pre>" \
                   f"{html.escape(render_plan(plan))}</pre>"
        except Exception:  # noqa: BLE001 — a malformed stored plan
            pass           # must not take down the results page
    if sh:
        # the ONE shrink renderer, shared with linear.html — the two
        # surfaces must tell the same failure story
        from .checker.linear_report import shrink_block

        out += shrink_block(result)
    return out


#: nested result fields worth a panel of their own
_EVIDENCE = ("linearization", "witness_dropped", "final_ops",
             "frontier_dropped", "hb_cycle", "queue_cycle",
             "queue_dup", "queue_evidence", "explain", "audit",
             "shrink")


def _evidence_results(result: dict, *, max_depth: int = 5,
                      max_panels: int = 24):
    """(path, sub-result) pairs for nested verdicts carrying evidence,
    depth-first, bounded so a huge independent-key run cannot render
    an unbounded page."""
    out: list = []

    def walk(d: dict, path: str, depth: int) -> None:
        if depth > max_depth or len(out) >= max_panels:
            return
        for name, sub in d.items():
            if not isinstance(sub, dict):
                continue
            p = f"{path}/{name}" if path else str(name)
            if "valid" in sub and any(k in sub for k in _EVIDENCE):
                out.append((p, sub))
                if len(out) >= max_panels:
                    return
            walk(sub, p, depth + 1)

    walk(result, "", 0)
    return out


def _load_result(d: str) -> dict | None:
    p = os.path.join(d, "results.json")
    try:
        with open(p) as f:
            out = json.load(f)
        return out if isinstance(out, dict) else None
    except Exception:
        return None


def live_panel(rel: str) -> str:
    """The live-verdict panel for a run directory holding a
    ``live.json`` snapshot (written by the streaming op sink,
    stream/checker.py): a status strip polled from ``/api/live/<run>``
    every 2s until the stream finalizes."""
    api = "/api/live/" + urllib.parse.quote(rel.rstrip("/"))
    return f"""
<div id="live-panel"><h3>Live verdict</h3>
<p id="live-status">loading…</p><pre id="live-json"></pre></div>
<script>
const CLS = {{"valid-so-far": "valid-true", "invalid": "valid-false",
             "open": "valid-unknown"}};
async function pollLive() {{
  let done = false;
  try {{
    const r = await fetch({json.dumps(api)});
    if (r.ok) {{
      const d = await r.json();
      const el = document.getElementById("live-status");
      el.textContent = d.status + " — " + d.events + " events, "
        + d.segments_closed + " segments closed, "
        + d.checked_rows + "/" + d.rows + " rows checked"
        + (d.final ? " — FINAL: " + d.final.valid : "");
      el.className = CLS[d.status] || "";
      document.getElementById("live-json").textContent =
        JSON.stringify(d, null, 1);
      done = !!d.final;
    }}
  }} catch (e) {{}}
  if (!done) setTimeout(pollLive, 2000);
}}
pollLive();
</script>"""


def trace_panel(rel: str) -> str:
    """The zoomable flight-recorder timeline for a run directory
    holding a ``trace.json`` (written by ``--trace`` runs): spans drawn
    per thread track, colored by category, wheel-zoom + drag-pan, span
    details on hover.  The same file loads in Perfetto for the full
    treatment — this panel is the no-tools-needed first look."""
    src = "/files/" + urllib.parse.quote(rel.rstrip("/")) + "/trace.json"
    return f"""
<div id="trace-panel"><h3>Trace timeline</h3>
<p><a href="{src}">trace.json</a> — open in
<a href="https://ui.perfetto.dev">Perfetto</a> for the full UI.
Scroll to zoom, drag to pan.</p>
<canvas id="trace-c" height="240"
        style="border:1px solid #ccc;width:100%"></canvas>
<div id="trace-hover" style="font-family:monospace">&nbsp;</div>
<script>
(async () => {{
  const r = await fetch({json.dumps(src)});
  if (!r.ok) return;
  const tr = await r.json();
  const evs = (tr.traceEvents || []).filter(e => e.ph === "X");
  if (!evs.length) return;
  const names = {{}};
  for (const e of tr.traceEvents)
    if (e.ph === "M" && e.name === "thread_name")
      names[e.tid] = e.args.name;
  const tids = [...new Set(evs.map(e => e.tid))].sort((a,b) => a-b);
  // reduce, not Math.min(...spread): a full 65k-span ring buffer
  // would blow the engine's argument limit and blank the panel
  let t0 = Infinity, t1 = -Infinity;
  for (const e of evs) {{
    if (e.ts < t0) t0 = e.ts;
    const end = e.ts + (e.dur || 0);
    if (end > t1) t1 = end;
  }}
  const c = document.getElementById("trace-c");
  c.width = c.clientWidth; const W = c.width, LANE = 22, PAD = 110;
  c.height = tids.length * LANE + 20;
  const ctx = c.getContext("2d");
  const color = cat => {{
    let h = 0; for (const ch of (cat || "")) h = (h * 31 + ch.charCodeAt(0)) % 360;
    return `hsl(${{h}},60%,60%)`;
  }};
  let view = [t0, Math.max(t1, t0 + 1)];
  function draw() {{
    ctx.clearRect(0, 0, W, c.height);
    const [v0, v1] = view, sc = (W - PAD) / (v1 - v0);
    ctx.font = "10px monospace"; ctx.fillStyle = "#333";
    tids.forEach((t, i) => ctx.fillText(
      (names[t] || ("tid " + t)).slice(0, 16), 2, i * LANE + 14));
    for (const e of evs) {{
      const x = PAD + (e.ts - v0) * sc,
            w = Math.max(1, (e.dur || 0) * sc),
            y = tids.indexOf(e.tid) * LANE + 4;
      if (x + w < PAD || x > W) continue;
      const cx = Math.max(PAD, x);
      ctx.fillStyle = color(e.cat);
      ctx.fillRect(cx, y, w - (cx - x), LANE - 8);
    }}
  }}
  c.addEventListener("wheel", ev => {{
    ev.preventDefault();
    const [v0, v1] = view, span = v1 - v0,
          fx = (ev.offsetX - PAD) / (W - PAD),
          at = v0 + fx * span,
          f = ev.deltaY > 0 ? 1.25 : 0.8;
    view = [at - (at - v0) * f, at + (v1 - at) * f]; draw();
  }});
  let drag = null;
  c.addEventListener("mousedown", ev => drag = ev.offsetX);
  c.addEventListener("mouseup", () => drag = null);
  c.addEventListener("mousemove", ev => {{
    const [v0, v1] = view, sc = (W - PAD) / (v1 - v0);
    if (drag !== null) {{
      const dt = (drag - ev.offsetX) / sc;
      view = [v0 + dt, v1 + dt]; drag = ev.offsetX; draw(); return;
    }}
    const t = v0 + (ev.offsetX - PAD) / sc,
          lane = Math.floor(ev.offsetY / LANE), tid = tids[lane];
    const hit = evs.find(e => e.tid === tid && e.ts <= t
                              && t <= e.ts + (e.dur || 0));
    document.getElementById("trace-hover").textContent = hit
      ? hit.name + " [" + hit.cat + "] "
        + ((hit.dur || 0) / 1000).toFixed(3) + " ms "
        + JSON.stringify(hit.args || {{}})
      : "\\u00a0";
  }});
  draw();
}})();
</script></div>"""


def dir_html(base: str, rel: str) -> str:
    """Directory browser (web.clj:194-248); run directories (those
    holding a results.json) get the result panel on top, a live
    streaming run (live.json present) its auto-refreshing verdict, and
    a traced run (trace.json present) the flight-recorder timeline."""
    d = os.path.join(base, rel)
    entries = sorted(os.listdir(d))
    items = []
    for e in entries:
        q = urllib.parse.quote(e)
        full = os.path.join(d, e)
        suffix = "/" if os.path.isdir(full) else ""
        items.append(f'<li><a href="{q}{suffix}">{html.escape(e)}{suffix}'
                     f"</a></li>")
    block = ""
    if os.path.isfile(os.path.join(d, "live.json")):
        block += live_panel(rel)
    if os.path.isfile(os.path.join(d, "trace.json")):
        block += trace_panel(rel)
    result = _load_result(d)
    if result is not None:
        # composed checkers nest per-checker (and per-key) results
        # arbitrarily deep ({"workload": {"results": {0: {"linear":
        # ...}}}}): render the top-level verdict plus every nested
        # verdict that carries certificate/plan/audit/shrink evidence
        block += result_block(result)
        for path, sub in _evidence_results(result):
            block += (f"<h2>{html.escape(path)}</h2>"
                      + result_block(sub))
    return (f"<html><head><style>{STYLE}</style></head><body>"
            f"<h1>{html.escape(rel)}</h1><p><a href='/'>home</a> | "
            f"<a href='?zip'>zip</a></p>{block}<ul>{''.join(items)}</ul>"
            f"</body></html>")


class _CountingWriter(io.RawIOBase):
    """File-like adapter over a socket stream for ZipFile: zipfile needs
    ``write`` and ``tell`` (for central-directory offsets); everything
    goes straight to the wire, nothing is buffered."""

    def __init__(self, sink):
        self._sink = sink
        self._pos = 0

    def writable(self):
        return True

    def write(self, b):
        self._sink.write(b)
        self._pos += len(b)
        return len(b)

    def tell(self):
        return self._pos


def write_zip(sink, base: str, rel: str, *, chunk: int = 1 << 20) -> None:
    """Stream a run directory as a zip straight into ``sink`` — the
    reference streams its zips too (web.clj:250-292); buffering a
    multi-GB run dir in memory is not an option.  Files are copied in
    ``chunk``-sized pieces through ``ZipFile.open(..., "w")``."""
    d = os.path.join(base, rel)
    with zipfile.ZipFile(_CountingWriter(sink), "w",
                         zipfile.ZIP_DEFLATED) as z:
        for root, _dirs, files in os.walk(d):
            _dirs.sort()  # deterministic archive order
            for f in sorted(files):
                full = os.path.join(root, f)
                arc = os.path.relpath(full, d)
                try:
                    zi = zipfile.ZipInfo.from_file(full, arc)
                    src = open(full, "rb")
                except OSError:
                    # a live run dir can rotate files between walk and
                    # stat/open; skip rather than abort the download
                    log.warning("zip: skipping vanished file %s", full)
                    continue
                # ZipFile.open honors the ZipInfo's compress_type (which
                # from_file defaults to STORED), not the constructor's
                zi.compress_type = zipfile.ZIP_DEFLATED
                with src, z.open(zi, "w") as dst:
                    shutil.copyfileobj(src, dst, chunk)


CONTENT_TYPES = {".html": "text/html", ".txt": "text/plain",
                 ".log": "text/plain", ".json": "application/json",
                 ".jsonl": "text/plain", ".edn": "text/plain",
                 ".png": "image/png", ".svg": "image/svg+xml",
                 ".jpg": "image/jpeg"}


class Handler(BaseHTTPRequestHandler):
    base = store.BASE

    def log_message(self, fmt, *args):  # quiet
        log.debug("web: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str = "text/html",
              extra: dict | None = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        parsed = urllib.parse.urlparse(self.path)
        path = urllib.parse.unquote(parsed.path)
        if path == "/":
            self._send(200, home_html(self.base).encode())
            return
        if path == "/campaigns" or path == "/campaigns/":
            self._send(200, campaigns_html(self.base).encode())
            return
        if path == "/mc" or path == "/mc/":
            q = urllib.parse.parse_qs(parsed.query or "")
            refresh = q.get("refresh", ["0"])[0] == "1"
            scope = q.get("scope", ["core"])[0]
            self._send(200,
                       mc_html(refresh=refresh, scope=scope).encode(),
                       extra={"Cache-Control": "no-store"})
            return
        if path == "/metrics":
            # the flight recorder's Prometheus scrape surface: this
            # process's registry (point your scraper at the runner /
            # stream-service process for fleet counters)
            self._send(200, obs_metrics.render().encode(),
                       "text/plain; version=0.0.4; charset=utf-8",
                       extra={"Cache-Control": "no-store"})
            return
        if path == "/api/stats":
            # the JSON twin: raw metric values + derived ratios (cache
            # hit ratio, padding efficiency), polled by /campaigns
            self._send(200, json.dumps(obs_metrics.snapshot()).encode(),
                       "application/json",
                       extra={"Cache-Control": "no-store"})
            return
        if path.startswith("/campaigns/"):
            cid = os.path.normpath(
                path[len("/campaigns/"):]).lstrip("/")
            if cid.startswith("..") or "/" in cid:
                self._send(403, b"forbidden", "text/plain")
                return
            self._send(200, campaign_html(self.base, cid).encode())
            return
        if path.startswith("/api/live/"):
            # the live provisional verdict of a (possibly running)
            # streamed test: the op sink rewrites live.json atomically
            # as the stream moves (stream/checker.py), so this is a
            # plain read — no coordination with the runner process
            rel = os.path.normpath(path[len("/api/live/"):]).lstrip("/")
            if rel.startswith(".."):
                self._send(403, b"forbidden", "text/plain")
                return
            p = os.path.join(self.base, rel, "live.json")
            try:
                with open(p, "rb") as f:
                    body = f.read()
            except OSError:
                self._send(404, b'{"error": "no live stream"}',
                           "application/json")
                return
            self._send(200, body, "application/json",
                       extra={"Cache-Control": "no-store"})
            return
        if not path.startswith("/files/"):
            self._send(404, b"not found", "text/plain")
            return
        rel = os.path.normpath(path[len("/files/"):]).lstrip("/")
        if rel.startswith(".."):
            self._send(403, b"forbidden", "text/plain")
            return
        full = os.path.join(self.base, rel)
        if parsed.query == "zip" and os.path.isdir(full):
            name = rel.replace("/", "-") + ".zip"
            # streamed: no Content-Length; the body is delimited by
            # connection close, which REQUIRES the handler to stay on
            # HTTP/1.0 (BaseHTTPRequestHandler's default) — with
            # keep-alive the client could not tell where the zip ends
            assert self.protocol_version == "HTTP/1.0", \
                "streamed zip framing relies on close-delimited bodies"
            self.send_response(200)
            self.send_header("Content-Type", "application/zip")
            self.send_header("Content-Disposition",
                             f'attachment; filename="{name}"')
            self.end_headers()
            try:
                write_zip(self.wfile, self.base, rel)
            except (BrokenPipeError, ConnectionResetError):
                log.debug("zip: client dropped the connection")
            except Exception:  # noqa: BLE001 — status already sent: the
                # archive is truncated/corrupt; sabotage the framing by
                # closing mid-stream and say so (a zlib or read error
                # here must not masquerade as a clean 200)
                log.warning("zip: stream aborted mid-archive for %r",
                            rel, exc_info=True)
            return
        if os.path.isdir(full):
            self._send(200, dir_html(self.base, rel).encode())
            return
        if os.path.isfile(full):
            ext = os.path.splitext(full)[1]
            ctype = CONTENT_TYPES.get(ext, "application/octet-stream")
            with open(full, "rb") as f:
                self._send(200, f.read(), ctype)
            return
        self._send(404, b"not found", "text/plain")


def make_server(host: str = "0.0.0.0", port: int = 8080,
                base: str | None = None) -> ThreadingHTTPServer:
    handler = type("H", (Handler,), {"base": base or store.BASE})
    return ThreadingHTTPServer((host, port), handler)


def serve(host: str = "0.0.0.0", port: int = 8080,
          base: str | None = None) -> None:
    """web.clj:322-335."""
    srv = make_server(host, port, base)
    log.info("Web server running on http://%s:%d", host, port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
