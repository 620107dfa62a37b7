"""The cell scheduler: independent cells over a host process pool or
the device.

The partitioners' cells (per-key projections) are independent
histories, so they schedule as the knossos ``independent`` checker's
bounded pmap does, largest first (the biggest cell bounds the tail, so
it starts first), over either

* :func:`pool_check_cells`: a spawn-context process pool.  Cells travel
  as plain int columns and the model as a descriptor (a ModelSpec's
  closures do not pickle); each worker imports only this package, runs
  the decomposed checker with host engines and shares the on-disk
  verdict cache; or
* :func:`device_batch_cells`: the cells as one ``search_batch`` on the
  device, bucketed by shape by default, so each bucket runs at its own
  dims (on the card, the fused kernel's grid over keys).

Quiescence segments are not scheduling units: they compose in sequence
through carried state sets, inside their cell's worker.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as _queue
import time

import numpy as np

from ..analyze.plan import schedule_weight
from ..history import OpSeq


def model_descriptor(model) -> tuple:
    """``(name, init, state_width)``: enough to rebuild every built-in
    model in a spawned worker."""
    return (model.name, tuple(int(x) for x in model.init),
            int(model.state_width))


def model_from_descriptor(desc: tuple):
    from .. import models

    name, init, width = desc
    if name == "register":
        return models.register(init[0])
    if name == "cas-register":
        return models.cas_register(init[0])
    if name == "mutex":
        return models.mutex()
    if name == "noop":
        return models.noop()
    if name == "multi-register":
        return models.multi_register(width, init[0])
    if name.startswith("unordered-queue-"):
        return models.unordered_queue(int(name.rsplit("-", 1)[1]))
    if name.startswith("fifo-queue-"):
        return models.fifo_queue(int(name.rsplit("-", 1)[1]))
    raise ValueError(f"no factory for model {name!r}")


def _pack_cell(seq: OpSeq) -> tuple:
    """The row columns as plain lists (workers return verdicts, so the
    ops and the encoder stay behind)."""
    return ([int(x) for x in seq.process], [int(x) for x in seq.f],
            [int(x) for x in seq.v1], [int(x) for x in seq.v2],
            [int(x) for x in seq.inv], [int(x) for x in seq.ret],
            [bool(x) for x in seq.ok])


def _unpack_cell(cols: tuple) -> OpSeq:
    process, f, v1, v2, inv, ret, ok = cols
    n = len(f)
    return OpSeq(process=np.array(process, np.int32).reshape(n),
                 f=np.array(f, np.int32).reshape(n),
                 v1=np.array(v1, np.int32).reshape(n),
                 v2=np.array(v2, np.int32).reshape(n),
                 inv=np.array(inv, np.int64).reshape(n),
                 ret=np.array(ret, np.int64).reshape(n),
                 ok=np.array(ok, bool).reshape(n))


def _pool_worker(desc, packed, idxs, cache_path, max_configs, q):
    try:
        from .cache import VerdictCache
        from .engine import check_opseq_decomposed

        model = model_from_descriptor(desc)
        # one cache per worker, not per cell: each one re-reads the
        # whole jsonl and holds its own append handle
        cache = VerdictCache(cache_path) if cache_path else None
        for i in idxs:
            try:
                r = check_opseq_decomposed(
                    _unpack_cell(packed[i]), model, cache=cache,
                    sub_max_configs=max_configs, lint=False)
                q.put((i, r.get("valid"), int(r.get("configs", 0))))
            except Exception:  # noqa: BLE001 — one cell, not the pool
                q.put((i, "unknown", 0))
    except Exception:  # noqa: BLE001 — the worker did not start
        for i in idxs:
            q.put((i, "unknown", 0))


def pool_check_cells(cells: list[OpSeq], model, *,
                     n_procs: int | None = None,
                     cache_path: str | None = None,
                     max_configs: int = 50_000_000,
                     deadline_s: float | None = None
                     ) -> tuple[list, int]:
    """(verdict per cell, configs explored in all) from a process pool,
    the cells striped largest first.  Workers run the decomposed checker
    (value blocks and quiescence cuts within each cell) against the
    shared cache file; its appends are whole lines, so concurrent
    writers only duplicate equal entries.  A cell a worker did not
    finish by ``deadline_s`` is "unknown"."""
    n = len(cells)
    if n == 0:
        return [], 0
    n_procs = max(1, min(n_procs or min(16, os.cpu_count() or 1), n))
    order = sorted(range(n), key=lambda i: -schedule_weight(cells[i]))
    packed = {i: _pack_cell(cells[i]) for i in range(n)}
    # worker w takes order[w], order[w + P], ...
    shards = [order[w::n_procs] for w in range(n_procs)]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    desc = model_descriptor(model)
    procs = []
    for shard in shards:
        mine = {i: packed[i] for i in shard}  # each worker its own cells
        p = ctx.Process(target=_pool_worker,
                        args=(desc, mine, shard, cache_path,
                              max_configs, q), daemon=True)
        p.start()
        procs.append(p)
    out: dict = {}
    t_end = None if deadline_s is None else time.monotonic() + deadline_s
    while len(out) < n:
        if t_end is not None and time.monotonic() >= t_end:
            break
        try:
            i, v, c = q.get(timeout=1.0)
            out[i] = (v, c)
        except _queue.Empty:
            if not any(p.is_alive() for p in procs):
                break
    # verdicts that raced the deadline or the liveness check still count
    _drain_queue(q, out)
    for p in procs:
        p.terminate()
    for p in procs:
        p.join(timeout=5.0)
    return ([out.get(i, ("unknown", 0))[0] for i in range(n)],
            sum(int(c) for _v, c in out.values()))


def _drain_queue(q, out: dict) -> None:
    """Collect every (index, verdict, configs) already queued, without
    blocking."""
    try:
        while True:
            i, v, c = q.get_nowait()
            out[i] = (v, c)
    except _queue.Empty:
        pass


def device_batch_cells(cells: list[OpSeq], model, *,
                       budget: int = 2_000_000, device="cuda",
                       telemetry: bool | None = None) -> list[dict]:
    """Each cell's full result from one ``search_batch`` on ``device``,
    largest first (the ladder retires big cells early within a bucket).
    The ``bucket_batch`` stats move to the first output slot."""
    from ..checker.linearizable import search_batch

    n = len(cells)
    if n == 0:
        return []
    order = sorted(range(n), key=lambda i: -schedule_weight(cells[i]))
    # lint=False: cells are projections of a history linted at entry
    results = search_batch([cells[i] for i in order], model,
                           budget=budget, device=device, lint=False,
                           telemetry=telemetry)
    out: list = [None] * n
    for pos, i in enumerate(order):
        out[i] = results[pos]
    st = results[0].pop("bucket_batch", None)
    if st is not None:
        out[0].setdefault("bucket_batch", st)
    return out
