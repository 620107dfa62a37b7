"""Shape-bucketed batches: tight padding, with host prep beside the device.

``search_batch`` pads every key of a batch to the widest key's dims, so
one long key inflates the padded work of all the others.  This module
is the scheduler in front of the batch ladder that avoids it:

* **Buckets.**  Keys group by their power-of-two-rounded dims
  (:func:`bucket_key`: the ``(n_det_pad, window, n_crash_pad)`` that
  ``choose_dims``/``batch_dims`` give one key), and each bucket runs
  its own ladder at its own dims.  Past :data:`MAX_BUCKETS` buckets the
  cheapest folds into its nearest neighbour (:func:`plan_buckets`).
* **Prep beside the device.**  While bucket k runs, one worker thread
  disposes of bucket k+1's keys by the greedy witness and the prepass
  and pads the rest.

Bucketing gives the same verdicts as the fused batch: the searches are
exact at any padding, and every key rides the same ladder.  The first
result carries a ``bucket_batch`` stats dict (per-bucket padding
efficiency, the fused batch's for comparison, slice-function cache hits
and misses).  Each bucket's host stage runs in a ``bucket.prep`` span
and its device stage in a ``bucket.device`` span; the
``jtpu_bucket_seconds`` histogram times both stages and
``jtpu_bucket_ops_total`` counts useful and padded rows.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

from .. import obs
from ..history import OpSeq

#: padded against useful rows shipped to the device, and the seconds of
#: each bucket stage, process-wide (the ``bucket_batch`` dict's numbers
#: per run)
_M_BUCKET_OPS = obs.REGISTRY.counter(
    "jtpu_bucket_ops_total",
    "Bucketed device batch rows, useful vs padded", ("kind",))
_M_BUCKET_S = obs.REGISTRY.histogram(
    "jtpu_bucket_seconds",
    "Wall seconds per bucket stage (prep/device)", ("stage",))

#: the most buckets one batch splits into: each is a ladder of its own
MAX_BUCKETS = 8


def bucket_key(es) -> tuple[int, int, int]:
    """The ``(n_det_pad, window, n_crash_pad)`` bucket of an encoded
    key: the dims it would pick for itself, so a bucket of equal keys
    pads nothing for the batch."""
    from .encode import _next_pow2, _round_up

    nd = max(64, _next_pow2(es.n_det))
    w = _round_up(es.window, 32)
    nc = _round_up(es.n_crash, 32) if es.n_crash else 32
    return nd, w, nc


def _bucket_cost(key: tuple[int, int, int], n_keys: int) -> int:
    """Padded rows a bucket ships to the device."""
    nd, _w, nc = key
    return (nd + nc) * n_keys


def plan_buckets(keys: list[tuple[int, int, int]],
                 max_buckets: int) -> list[list[int]]:
    """Group key indices by bucket, then merge down to ``max_buckets``:
    the cheapest bucket folds into its neighbour in dims order (its
    members pad to the pair's elementwise maximum).  Groups come out
    costliest first, so the largest device stage hides the most host
    prep."""
    groups: dict[tuple, list[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    while len(groups) > max(1, max_buckets):
        order = sorted(groups)
        costs = [_bucket_cost(k, len(groups[k])) for k in order]
        j = min(range(len(order)), key=costs.__getitem__)
        t = j + 1 if j + 1 < len(order) else j - 1
        a, b = order[j], order[t]
        merged = tuple(max(x, y) for x, y in zip(a, b))
        rows = groups.pop(a) + groups.pop(b)
        groups.setdefault(merged, []).extend(rows)
    return [idxs for _k, idxs in
            sorted(groups.items(),
                   key=lambda kv: -_bucket_cost(kv[0], len(kv[1])))]


def search_batch_bucketed(seqs: list[OpSeq], model, *,
                          budget: int = 2_000_000, device="cuda",
                          hb: bool | None = None,
                          dpor: bool | None = None,
                          telemetry: bool | None = None) -> list[dict]:
    """``search_batch``'s route by buckets.  Per-key results are the
    engines' own (greedy witness, prepass, the batch ladder, or the host
    ``linear`` sweep past the device encoding); the first result also
    carries the ``bucket_batch`` stats dict.  ``telemetry`` (None: on)
    goes to each bucket's ladder, whose first result carries the
    bucket's ``search_telemetry``."""
    from ..analyze.dpor import resolve_dpor
    from ..analyze.hb import resolve_hb
    from ..obs.telemetry import resolve
    from . import linearizable as lin

    dev = lin._resolve_device(device)
    telemetry = resolve(telemetry)
    hb = resolve_hb(hb)
    dpor_on = resolve_dpor(dpor)
    n = len(seqs)
    t_start = time.perf_counter()
    kc0 = lin.kernel_cache_stats()
    ess = [lin.encode_search(s) for s in seqs]
    results: list = [None] * n
    hard, fit = [], []
    for i, e in enumerate(ess):
        (hard if e.window > lin.MAX_WINDOW
         or e.n_crash > lin.MAX_CRASH else fit).append(i)
    plans = plan_buckets([bucket_key(ess[i]) for i in fit], MAX_BUCKETS)
    plans = [[fit[p] for p in grp] for grp in plans]
    stats: dict = {"n_keys": n, "n_buckets": len(plans), "buckets": [],
                   "greedy": 0, "hard": len(hard), "hb_decided": 0,
                   "constraint_decided": 0}
    # the prep thread's spans go to the run this call started in, even
    # if the process's current run moves on meanwhile
    run_pin = obs.current_run()

    def prep(idxs: list[int]):
        """Host stage of one bucket: greedy witness and prepass disposal,
        then tight dims and padding for the keys left.  Numpy and Python
        only, so it runs beside the previous bucket's device stage (its
        span on the prep thread's track shows the overlap)."""
        t_prep = time.perf_counter()
        with obs.span("bucket.prep", cat="host", run=run_pin,
                      keys=len(idxs)):
            decided, rest, masks, _ = lin._dispose_batch(
                [seqs[i] for i in idxs], model, hb, dpor)
            ready = {idxs[j]: r for j, r in decided.items()}
            run = [idxs[j] for j in rest]
            dims = esps = None
            if run:
                dims = lin.batch_dims([ess[i] for i in run], model)
                esps = lin._pad_batch([seqs[i] for i in run],
                                      [ess[i] for i in run], masks, model,
                                      dims, dev, dpor_on)
        _M_BUCKET_S.observe(time.perf_counter() - t_prep, stage="prep")
        return ready, run, dims, esps

    useful_total = padded_total = 0
    run_all: list[int] = []
    if plans:
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="bucket-prep") as ex:
            fut = ex.submit(prep, plans[0])
            for b, idxs in enumerate(plans):
                ready, run, dims, esps = fut.result()
                if b + 1 < len(plans):
                    # the next bucket's host stage runs beside this
                    # bucket's device stage
                    fut = ex.submit(prep, plans[b + 1])
                for i, r in ready.items():
                    results[i] = r
                n_hb = sum(1 for r in ready.values()
                           if r.get("engine") == "hb-decide")
                n_cs = sum(1 for r in ready.values()
                           if r.get("engine") == "constraint-decide")
                stats["hb_decided"] += n_hb
                stats["constraint_decided"] += n_cs
                stats["greedy"] += len(ready) - n_hb - n_cs
                t0 = time.perf_counter()
                if run:
                    with obs.span("bucket.device", cat="device", bucket=b,
                                  keys=len(run),
                                  dims=[dims.n_det_pad, dims.window,
                                        dims.n_crash_pad]):
                        sub = lin._search_batch_ladder(
                            [seqs[i] for i in run], esps, model, dims,
                            budget, dev, telemetry)
                    for i, r in zip(run, sub):
                        results[i] = r
                dt = time.perf_counter() - t0
                if run:
                    _M_BUCKET_S.observe(dt, stage="device")
                useful = sum(ess[i].n_det + ess[i].n_crash for i in run)
                padded = (len(run) * (dims.n_det_pad + dims.n_crash_pad)
                          if run else 0)
                useful_total += useful
                padded_total += padded
                run_all += run
                stats["buckets"].append({
                    "dims": ([dims.n_det_pad, dims.window,
                              dims.n_crash_pad] if run else None),
                    "n_keys": len(idxs), "searched": len(run),
                    "useful_ops": useful, "padded_ops": padded,
                    "padding_efficiency": (round(useful / padded, 4)
                                           if padded else None),
                    "seconds": round(dt, 3)})
    if hard:
        # past the device encoding: the greedy witness first (as the
        # fused route does), then the host sweep
        for i in hard:
            s = seqs[i]
            if lin.greedy_witness(s, model):
                results[i] = lin._greedy_result(s)
                stats["greedy"] += 1
            else:
                results[i] = lin._host_linear_fallback(s, model, hb, dpor)
    # what one fused batch over the same searched keys would have padded
    fused_padded = 0
    if run_all:
        fdims = lin.batch_dims([ess[i] for i in run_all], model)
        fused_padded = len(run_all) * (fdims.n_det_pad + fdims.n_crash_pad)
    kc1 = lin.kernel_cache_stats()
    if useful_total or padded_total:
        _M_BUCKET_OPS.inc(useful_total, kind="useful")
        _M_BUCKET_OPS.inc(padded_total, kind="padded")
    stats.update({
        "useful_ops": useful_total,
        "padded_ops": padded_total,
        "padding_efficiency": (round(useful_total / padded_total, 4)
                               if padded_total else None),
        "fused_padded_ops": fused_padded or None,
        "fused_padding_efficiency": (round(useful_total / fused_padded, 4)
                                     if fused_padded else None),
        "kernel_cache": {k: kc1[k] - kc0[k] for k in kc1},
        "seconds": round(time.perf_counter() - t_start, 3),
    })
    # on the first result only: one shared dict, not one copy per key
    if results:
        results[0].setdefault("bucket_batch", stats)
    return results
