"""Multi-core HOST comparator — the honest 16-core baseline.

BASELINE.json's target is "≥50× faster than knossos.competition on a
16-core CPU".  knossos has no JVM here, so the stand-in must be the
strongest thing a 16-core host can do with this package's own exact
algorithms (anything weaker, a single thread say, would overstate the
device's speedup).

Two shapes, mirroring how the reference actually parallelizes
(SURVEY.md §2.3):

* :func:`portfolio_check` — ONE history, ``n_procs`` processes racing
  algorithm variants (the `linear` sweep, a P-compositional decomposed
  leg, plus WGL DFS under different exploration orders); first
  conclusive verdict wins and the rest are killed.  This is knossos
  `competition` scaled to a process pool: a
  single history's search does not data-parallelize (the reference's
  answer is the same — it shards *keys*, not one search,
  independent.clj:66-111), so extra cores buy portfolio diversity, not
  linear speedup.
* :func:`batch_check_pool` — MANY independent keys striped over a
  process pool, each checked with the `linear` algorithm: the
  bounded-pmap shape of jepsen.independent (independent.clj:247-298).

Workers REBUILD their history from a module-level ``builder`` callable
(spawn context): nothing compiled or closure-built crosses the
process boundary, and a worker signals READY before the parent starts
the clock — process startup is not billed to the baseline.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as _queue
import time

__all__ = ["portfolio_check", "batch_check_pool"]


def _await_ready(procs, readies, *, timeout: float):
    """Wait for worker READY signals against ONE shared deadline.

    Returns the ready subset (same order).  Workers that never signal
    are terminated and excluded — a dead or wedged worker must neither
    stall startup serially nor be billed into the portfolio."""
    t_end = time.monotonic() + timeout
    ready_procs = []
    for p, r in zip(procs, readies):
        if r.wait(timeout=max(0.1, t_end - time.monotonic())):
            ready_procs.append(p)
        else:
            p.terminate()
    return ready_procs


def _portfolio_worker(builder, builder_args, algo, seed, max_configs,
                      decompose, ready, go, q):
    try:
        seq, model = builder(*builder_args)
        ready.set()
        go.wait()
        t0 = time.perf_counter()
        if algo == "linear":
            from .linear import DEFAULT_WITNESS_CAP, check_opseq_linear

            # a bounded witness_cap: if this leg wins, its verdict
            # carries a real certificate through the queue (row lists
            # pickle fine) instead of a witness_dropped stub
            r = check_opseq_linear(seq, model, max_configs=max_configs,
                                   witness_cap=DEFAULT_WITNESS_CAP,
                                   decompose=decompose)
        elif algo == "decompose":
            from ..decompose.engine import check_opseq_decomposed
            from ..decompose.partition import (partition_by_key,
                                               quiescence_segments,
                                               value_block_verdict)

            # the dedicated decomposed leg: P-compositional splits +
            # the canonical-hash verdict cache, racing the DIRECT legs
            # (which ARE the fallback — direct=None here).  When NO
            # cutter applies, the whole-history sub-search would be
            # byte-for-byte the sibling `linear` leg's sweep, so the
            # leg concedes "unknown" immediately instead of burning a
            # core on duplicate work.
            cells, _cm, early = partition_by_key(seq, model)
            if (early is None and cells is None
                    and value_block_verdict(seq, model) is None
                    and len(quiescence_segments(seq)) <= 1):
                r = {"valid": "unknown", "info": "nothing decomposes"}
            else:
                # witness=True: the winner's certificate propagates to
                # the parent (stitched per-cell witnesses or an
                # explicit witness_dropped reason)
                r = check_opseq_decomposed(seq, model,
                                           sub_max_configs=max_configs,
                                           witness=True)
        else:
            from . import seq as seqmod

            r = seqmod.check_opseq(seq, model, max_configs=max_configs,
                                   order_seed=seed, decompose=decompose)
        r["worker_seconds"] = time.perf_counter() - t0
        q.put((algo, seed, r))
    except Exception as e:  # noqa: BLE001 — a crashed leg must not hang the pool
        q.put((algo, seed, {"valid": "unknown", "error": repr(e)}))


def portfolio_check(builder, builder_args=(), *, n_procs: int = 16,
                    deadline_s: float | None = None,
                    max_configs: int = 500_000_000,
                    decompose: bool = False) -> dict:
    """Race ``n_procs`` host algorithm variants on one history.

    ``builder(*builder_args) -> (OpSeq, ModelSpec)`` must be a
    module-level callable (it is re-imported in spawned workers).
    Returns the winning verdict plus {"engine", "n_procs", "seconds"};
    "unknown" if every leg was inconclusive or the deadline passed.
    The clock starts only after every worker has built its history and
    signalled ready — startup is not billed.  ``decompose`` runs every
    leg behind the P-compositional decomposition layer (verdict-
    identical; the legs still diverge inside undecomposable parts).
    """
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    go = ctx.Event()
    legs = [("linear", 0)]
    if n_procs >= 3 and not decompose:
        # a dedicated decomposed leg races the direct legs (first
        # conclusive verdict wins): cells/value-blocks/quiescence cuts
        # win exactly the structured histories that strand a direct
        # sweep.  Redundant when ``decompose`` already wraps every leg;
        # at n_procs == 2 the classic linear+wgl pairing stands.
        legs.append(("decompose", 0))
    legs += [("wgl", s) for s in range(max(0, n_procs - len(legs)))]
    procs = []
    readies = []
    for algo, seed in legs[:n_procs]:
        ready = ctx.Event()
        p = ctx.Process(target=_portfolio_worker,
                        args=(builder, builder_args, algo, seed,
                              max_configs, decompose, ready, go, q),
                        daemon=True)
        p.start()
        procs.append(p)
        readies.append(ready)
    ready_procs = _await_ready(procs, readies, timeout=120.0)
    n_billed = len(ready_procs)
    t0 = time.perf_counter()
    go.set()
    deadline = None if deadline_s is None else t0 + deadline_s
    result = None
    received = 0
    # bounded q.get in a loop, polling worker liveness: a leg that dies
    # without enqueueing (segfault / OOM-kill) must not hang the
    # portfolio forever under deadline_s=None
    while received < n_billed:
        now = time.perf_counter()
        if deadline is not None and now >= deadline:
            break
        step = 1.0 if deadline is None else min(1.0, max(0.1,
                                                         deadline - now))
        try:
            algo, seed, r = q.get(timeout=step)
        except _queue.Empty:
            if not any(p.is_alive() for p in ready_procs):
                # every worker is gone; drain any result that raced the
                # liveness check, then stop waiting
                try:
                    algo, seed, r = q.get_nowait()
                except _queue.Empty:
                    break
            else:
                continue
        received += 1
        if r.get("valid") != "unknown":
            result = (algo, seed, r)
            break
    seconds = time.perf_counter() - t0
    for p in procs:
        p.terminate()
    for p in procs:
        p.join(timeout=5.0)
    if result is None:
        return {"valid": "unknown", "engine": f"host{n_billed}(none)",
                "n_procs": n_billed, "seconds": seconds}
    algo, seed, r = result
    r["engine"] = f"host{n_billed}({algo})"
    r["n_procs"] = n_billed
    r["seconds"] = seconds
    return r


def _batch_worker(builder, n_keys, wid, n_procs, decompose, cache_path,
                  ready, go, q):
    try:
        from .linear import check_opseq_linear

        cache = None
        if decompose and cache_path:
            # open the shared cache once per worker, not once per key
            from ..decompose.cache import VerdictCache

            cache = VerdictCache(cache_path)
        work = []
        for k in range(wid, n_keys, n_procs):
            work.append((k,) + tuple(builder(k)))
        ready.set()
        go.wait()
        for k, seq, model in work:
            # a per-key failure must not kill this worker's other keys
            try:
                r = check_opseq_linear(seq, model, decompose=decompose,
                                       decompose_cache=cache)
                q.put((k, r.get("valid"), r.get("configs", 0)))
            except Exception:  # noqa: BLE001
                q.put((k, "unknown", 0))
    except Exception as e:  # noqa: BLE001 — builder/startup failure
        q.put((-1, wid, repr(e)))


def batch_check_pool(builder, n_keys: int, *, n_procs: int = 16,
                     deadline_s: float | None = None,
                     decompose: bool = False,
                     cache_path: str | None = None) -> dict:
    """Check ``n_keys`` independent histories over a process pool.

    ``builder(k) -> (OpSeq, ModelSpec)`` must be module-level.  Returns
    {"verdicts": {k: valid}, "seconds", "configs", "keys_done"} — the
    per-key-parallel host baseline for the batch tiers (the reference's
    bounded-pmap, independent.clj:247-298).  History construction
    happens before the clock starts.  ``decompose`` checks every key
    behind the decomposition layer; with ``cache_path`` the workers
    share one on-disk canonical-hash verdict cache (appends are
    line-atomic, and duplicate entries are only ever equal).
    """
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    go = ctx.Event()
    n_procs = min(n_procs, n_keys)
    procs, readies = [], []
    for wid in range(n_procs):
        ready = ctx.Event()
        p = ctx.Process(target=_batch_worker,
                        args=(builder, n_keys, wid, n_procs, decompose,
                              cache_path, ready, go, q), daemon=True)
        p.start()
        procs.append(p)
        readies.append(ready)
    ready_procs = _await_ready(procs, readies, timeout=300.0)
    ready_set = {wid for wid, p in enumerate(procs) if p in ready_procs}
    t0 = time.perf_counter()
    go.set()
    deadline = None if deadline_s is None else t0 + deadline_s
    verdicts: dict = {}
    configs = 0
    # a worker that never signalled ready will never produce its keys
    dead_wids: set = set(range(n_procs)) - ready_set

    def expected() -> int:
        # a dead worker's unseen keys will never arrive; keep draining
        # the healthy workers instead of aborting the whole measurement
        missing = sum(1 for k in range(n_keys)
                      if k % n_procs in dead_wids and k not in verdicts)
        return n_keys - missing

    def take(item) -> None:
        nonlocal configs
        k, valid, c = item
        if k < 0:
            dead_wids.add(int(valid))  # valid slot carries the wid
        else:
            verdicts[k] = valid
            configs += int(c)

    while len(verdicts) < expected():
        now = time.perf_counter()
        if deadline is not None and now >= deadline:
            break
        step = 1.0 if deadline is None else min(1.0, max(0.1,
                                                         deadline - now))
        try:
            take(q.get(timeout=step))
        except _queue.Empty:
            # liveness poll: a worker killed without enqueueing (-1, wid)
            # must not hang the pool under deadline_s=None.  A normally-
            # finished worker is also not alive; marking it dead is
            # harmless because its keys are either in `verdicts` already
            # or still in the queue — the post-loop drain collects them.
            for wid in ready_set - dead_wids:
                if not procs[wid].is_alive():
                    dead_wids.add(wid)
    # drain results that raced a liveness check or the deadline
    while True:
        try:
            take(q.get_nowait())
        except _queue.Empty:
            break
    seconds = time.perf_counter() - t0
    for p in procs:
        p.terminate()
    for p in procs:
        p.join(timeout=5.0)
    return {"verdicts": verdicts, "seconds": seconds,
            "configs": configs, "keys_done": len(verdicts),
            # bill only workers that actually ran (signalled ready) —
            # per-core rates derived from this must not be understated
            "n_procs": len(ready_set)}
