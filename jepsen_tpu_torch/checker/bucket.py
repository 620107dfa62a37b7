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

:func:`search_batch_sharded_bucketed` is the same scheduler over a mesh
(bucket-then-shard): each bucket covers the mesh at its own dims through
the fixed sharded dispatch (``sharded.py``), padded with inert keys only
up to the shard count within the bucket, and the first result carries a
``shard_batch`` stats dict.  Its stages run in ``shard.prep`` and
``shard.device`` spans, timed by ``jtpu_shard_seconds`` and counted by
``jtpu_shard_ops_total``.
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

#: the same for the mesh-sharded scheduler, whose padded rows include
#: the inert keys that make a bucket cover the mesh
_M_SHARD_OPS = obs.REGISTRY.counter(
    "jtpu_shard_ops_total",
    "Mesh-sharded batch rows, useful vs padded (mesh pad lanes included)",
    ("kind",))
_M_SHARD_S = obs.REGISTRY.histogram(
    "jtpu_shard_seconds",
    "Wall seconds per sharded bucket stage (prep/device)", ("stage",))

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


def _prep_bucket(idxs: list[int], seqs, ess, model, dev, hb, dpor,
                 dpor_on: bool, *, frontier: int, span: str, timer,
                 run_pin):
    """Host stage of one bucket: greedy witness and prepass disposal,
    then tight dims (at ``frontier``) and padding for the keys left.
    Numpy and Python only, so it runs beside the previous bucket's device
    stage (its ``span`` on the prep thread's track shows the overlap).
    Returns (decided results by key, the keys left, dims, encodings)."""
    from . import linearizable as lin

    t_prep = time.perf_counter()
    with obs.span(span, cat="host", run=run_pin, keys=len(idxs)):
        decided, rest, masks, _ = lin._dispose_batch(
            [seqs[i] for i in idxs], model, hb, dpor)
        ready = {idxs[j]: r for j, r in decided.items()}
        run = [idxs[j] for j in rest]
        dims = esps = None
        if run:
            dims = lin.batch_dims([ess[i] for i in run], model,
                                  frontier=frontier)
            esps = lin._pad_batch([seqs[i] for i in run],
                                  [ess[i] for i in run], masks, model, dims,
                                  dev, dpor_on)
    timer.observe(time.perf_counter() - t_prep, stage="prep")
    return ready, run, dims, esps


def _pipelined(plans: list, prep, name: str):
    """``(bucket, prep(plan))`` for each plan in order; bucket k+1's host
    stage runs on one worker thread while the caller runs bucket k's
    device stage."""
    if not plans:
        return
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix=name) as ex:
        fut = ex.submit(prep, plans[0])
        for b in range(len(plans)):
            out = fut.result()
            if b + 1 < len(plans):
                fut = ex.submit(prep, plans[b + 1])
            yield b, out


def _tally_disposed(stats: dict, ready: dict) -> None:
    """A bucket's host-decided keys into ``stats``, by engine."""
    n_hb = sum(1 for r in ready.values() if r.get("engine") == "hb-decide")
    n_cs = sum(1 for r in ready.values()
               if r.get("engine") == "constraint-decide")
    stats["hb_decided"] += n_hb
    stats["constraint_decided"] += n_cs
    stats["greedy"] += len(ready) - n_hb - n_cs


def _split(seqs, model):
    """(encodings, keys past the device encoding, buckets of the rest)."""
    from . import linearizable as lin

    ess = [lin.encode_search(s) for s in seqs]
    hard, fit = [], []
    for i, e in enumerate(ess):
        (hard if e.window > lin.MAX_WINDOW
         or e.n_crash > lin.MAX_CRASH else fit).append(i)
    plans = plan_buckets([bucket_key(ess[i]) for i in fit], MAX_BUCKETS)
    return ess, hard, [[fit[p] for p in grp] for grp in plans]


def _check_hard(hard: list[int], seqs, model, hb, dpor, results: list,
                stats: dict) -> None:
    """Keys past the device encoding: the greedy witness (as the fused
    route does), then the host sweep."""
    from . import linearizable as lin

    for i in hard:
        s = seqs[i]
        if lin.greedy_witness(s, model):
            results[i] = lin._greedy_result(s)
            stats["greedy"] += 1
        else:
            results[i] = lin._host_linear_fallback(s, model, hb, dpor)


def _close_stats(stats: dict, useful: int, padded: int, fused_padded: int,
                 kc0: dict, t_start: float) -> None:
    """The batch-wide padding and cache numbers of a stats dict."""
    from . import linearizable as lin

    kc1 = lin.kernel_cache_stats()
    stats.update({
        "useful_ops": useful,
        "padded_ops": padded,
        "padding_efficiency": (round(useful / padded, 4)
                               if padded else None),
        "fused_padded_ops": fused_padded or None,
        "fused_padding_efficiency": (round(useful / fused_padded, 4)
                                     if fused_padded else None),
        "kernel_cache": {k: kc1[k] - kc0[k] for k in kc1},
        "seconds": round(time.perf_counter() - t_start, 3),
    })


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
    ess, hard, plans = _split(seqs, model)
    results: list = [None] * n
    stats: dict = {"n_keys": n, "n_buckets": len(plans), "buckets": [],
                   "greedy": 0, "hard": len(hard), "hb_decided": 0,
                   "constraint_decided": 0}
    # the prep thread's spans go to the run this call started in, even
    # if the process's current run moves on meanwhile
    run_pin = obs.current_run()

    def prep(idxs: list[int]):
        return _prep_bucket(idxs, seqs, ess, model, dev, hb, dpor, dpor_on,
                            frontier=32, span="bucket.prep",
                            timer=_M_BUCKET_S, run_pin=run_pin)

    useful_total = padded_total = 0
    run_all: list[int] = []
    for b, (ready, run, dims, esps) in _pipelined(plans, prep,
                                                  "bucket-prep"):
        for i, r in ready.items():
            results[i] = r
        _tally_disposed(stats, ready)
        t0 = time.perf_counter()
        if run:
            with obs.span("bucket.device", cat="device", bucket=b,
                          keys=len(run),
                          dims=[dims.n_det_pad, dims.window,
                                dims.n_crash_pad]):
                sub = lin._search_batch_ladder(
                    [seqs[i] for i in run], esps, model, dims, budget, dev,
                    telemetry)
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
            "dims": ([dims.n_det_pad, dims.window, dims.n_crash_pad]
                     if run else None),
            "n_keys": len(plans[b]), "searched": len(run),
            "useful_ops": useful, "padded_ops": padded,
            "padding_efficiency": (round(useful / padded, 4)
                                   if padded else None),
            "seconds": round(dt, 3)})
    _check_hard(hard, seqs, model, hb, dpor, results, stats)
    # what one fused batch over the same searched keys would have padded
    fused_padded = 0
    if run_all:
        fdims = lin.batch_dims([ess[i] for i in run_all], model)
        fused_padded = len(run_all) * (fdims.n_det_pad + fdims.n_crash_pad)
    if useful_total or padded_total:
        _M_BUCKET_OPS.inc(useful_total, kind="useful")
        _M_BUCKET_OPS.inc(padded_total, kind="padded")
    _close_stats(stats, useful_total, padded_total, fused_padded, kc0,
                 t_start)
    # on the first result only: one shared dict, not one copy per key
    if results:
        results[0].setdefault("bucket_batch", stats)
    return results


def search_batch_sharded_bucketed(seqs: list[OpSeq], model, sharding, *,
                                  budget: int = 2_000_000,
                                  hb: bool | None = None,
                                  dpor: bool | None = None,
                                  telemetry: bool | None = None
                                  ) -> list[dict]:
    """Bucket-then-shard: :func:`search_batch_bucketed` over the mesh of
    ``sharding`` (a ``ShardMesh`` or ``KeysSharding`` of this process).
    Keys bucket as there (:func:`bucket_key`, :func:`plan_buckets`);
    each bucket's undecided keys run the fixed sharded dispatch at the
    bucket's dims with a frontier of 64
    (``sharded.search_batch_sharded_fixed``), padded with inert keys only
    up to the shard count; the next bucket's host prep runs beside it on
    one worker thread.  Verdicts are the fused sharded route's: the same
    exact search at the bucket's padding, the same certificates, the
    same solo redo of keys that overflow.  The first result carries the
    ``shard_batch`` stats dict (per-bucket lanes, pad lanes and padding
    efficiency, with the mesh's pad lanes billed in the padded rows; the
    fused shape's efficiency for comparison; slice-function cache hits
    and misses; the shard count) and, with ``telemetry`` (None: on), the
    ``search_telemetry`` of every bucket's device work."""
    from ..analyze.dpor import resolve_dpor
    from ..analyze.hb import resolve_hb
    from ..distributed import as_sharding
    from ..obs import telemetry as _tele
    from . import linearizable as lin
    from .sharded import search_batch_sharded_fixed

    sh = as_sharding(sharding)
    dev = [lin._resolve_device(d) for d in sh.mesh.devices][0]
    telemetry = _tele.resolve(telemetry)
    hb = resolve_hb(hb)
    dpor_on = resolve_dpor(dpor)
    n = len(seqs)
    t_start = time.perf_counter()
    kc0 = lin.kernel_cache_stats()
    n_dev = sh.num_devices
    tele_acc = _tele.SearchTelemetry("device-batch-sharded") \
        if telemetry else None
    ess, hard, plans = _split(seqs, model)
    results: list = [None] * n
    stats: dict = {"n_keys": n, "n_buckets": len(plans),
                   "n_devices": n_dev, "buckets": [], "greedy": 0,
                   "hard": len(hard), "hb_decided": 0,
                   "constraint_decided": 0}
    run_pin = obs.current_run()

    def prep(idxs: list[int]):
        # no ladder over a mesh: the shape starts at the wider frontier
        return _prep_bucket(idxs, seqs, ess, model, dev, hb, dpor, dpor_on,
                            frontier=64, span="shard.prep",
                            timer=_M_SHARD_S, run_pin=run_pin)

    useful_total = padded_total = pad_lanes_total = redo_total = 0
    run_all: list[int] = []
    for b, (ready, run, dims, esps) in _pipelined(plans, prep,
                                                  "shard-prep"):
        for i, r in ready.items():
            results[i] = r
        _tally_disposed(stats, ready)
        t0 = time.perf_counter()
        info = None
        if run:
            with obs.span("shard.device", cat="device", bucket=b,
                          keys=len(run), shards=n_dev,
                          dims=[dims.n_det_pad, dims.window,
                                dims.n_crash_pad]):
                sub, info = search_batch_sharded_fixed(
                    [seqs[i] for i in run], esps, model, dims, sh, budget,
                    tele_acc=tele_acc, telemetry=telemetry)
            for i, r in zip(run, sub):
                results[i] = r
        dt = time.perf_counter() - t0
        if run:
            _M_SHARD_S.observe(dt, stage="device")
        useful = sum(ess[i].n_det + ess[i].n_crash for i in run)
        lanes = info["batch_lanes"] if info else 0
        # the mesh's pad lanes occupy rows: they bill into the padded
        # rows, never into configs
        padded = (lanes * (dims.n_det_pad + dims.n_crash_pad)
                  if run else 0)
        useful_total += useful
        padded_total += padded
        if info:
            pad_lanes_total += info["pad_lanes"]
            redo_total += info["overflow_redo"]
        run_all += run
        stats["buckets"].append({
            "dims": ([dims.n_det_pad, dims.window, dims.n_crash_pad]
                     if run else None),
            "n_keys": len(plans[b]), "searched": len(run), "lanes": lanes,
            "pad_lanes": info["pad_lanes"] if info else 0,
            "useful_ops": useful, "padded_ops": padded,
            "padding_efficiency": (round(useful / padded, 4)
                                   if padded else None),
            "seconds": round(dt, 3)})
    _check_hard(hard, seqs, model, hb, dpor, results, stats)
    # one fused shape over the same searched keys, covering the mesh once
    fused_padded = 0
    if run_all:
        fdims = lin.batch_dims([ess[i] for i in run_all], model,
                               frontier=64)
        fused_padded = lin._round_up(len(run_all), n_dev) \
            * (fdims.n_det_pad + fdims.n_crash_pad)
    if useful_total or padded_total:
        _M_SHARD_OPS.inc(useful_total, kind="useful")
        _M_SHARD_OPS.inc(padded_total, kind="padded")
    stats.update({"pad_keys": pad_lanes_total, "overflow_redo": redo_total,
                  "shard_map": True if run_all else None})
    _close_stats(stats, useful_total, padded_total, fused_padded, kc0,
                 t_start)
    if tele_acc is not None and results and results[0] is not None:
        _tele.finalize_result(results[0], tele_acc, device=dev)
    if results:
        results[0].setdefault("shard_batch", stats)
    return results


# ---------------------------------------------------------------------------
# device-contract enumeration (see linearizable.KernelRoute)
# ---------------------------------------------------------------------------

from . import linearizable as _lin  # noqa: E402

_lin.register_route(_lin.KernelRoute(
    name="bucketed-batch", span_kind="batch",
    getter="get_batch_kernel", module=_lin.__name__,
    build=_lin._build_batch, request=_lin._request_batch))
_lin.register_route(_lin.KernelRoute(
    name="mesh-sharded", span_kind="batch-sharded",
    getter="get_sharded_batch_kernel",
    module=_lin.__name__.rsplit(".", 1)[0] + ".sharded",
    build=_lin._build_mesh_sharded, request=_lin._request_mesh_sharded,
    carry_args=1, lvl_cap_arg=2))
