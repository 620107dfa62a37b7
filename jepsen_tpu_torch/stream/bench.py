"""The streaming bench tier: what streaming buys, measured on one
process.

Three measurements, returned as one dict (and written as JSON to
``out_path`` when given):

  * **time-to-first-verdict**: a quiescent register workload streamed
    op by op; wall clock (and event index) from the first ingest to the
    first folded segment, the moment the verdict stops being "open".  A
    post-hoc check cannot answer before the last op;
  * **violation-detection latency**: the same workload with a read
    corrupted about 10% in; events and wall clock between ingesting the
    violating op and the stream flipping ``invalid``, and the headroom
    to the end of the stream;
  * **sustained multiplexed ingest**: 4 concurrent streams (two pairs
    with the same content) sharing one in-memory verdict cache; total
    events per second, with the cache counters showing the reuse.

Every stream's final verdict is checked against the host ``linear``
engine on the whole history (``parity``).  The workload has 6 clients
and bursts of 8 ops, so every fold is a host fold; ``device`` is passed
to the checkers all the same.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time


def _mk_history(seed: int, n_ops: int, *, corrupt_at: float | None = None):
    from ..synth import corrupt_read, register_history

    rng = random.Random(seed)
    h = register_history(rng, n_ops=n_ops, n_procs=6, overlap=4,
                         quiesce_every=8, n_values=5, cas=False)
    violation_idx = None
    if corrupt_at is not None:
        h2 = corrupt_read(rng, h, at=corrupt_at)
        violation_idx = next(i for i, (a, b) in enumerate(zip(h, h2))
                             if a is not b)
        h = h2
    return h, violation_idx


def _stream_one(model, h, *, cache=None, device="cuda"):
    """Stream a history op by op: (final result, timeline), the timeline
    marking the first-verdict and first-invalid wall and event."""
    from .checker import StreamChecker

    sc = StreamChecker(model, cache=cache, device=device)
    t0 = time.perf_counter()
    tl = {"t0": t0, "first_verdict": None, "first_invalid": None,
          "ingest_s": None}
    for i, op in enumerate(h):
        sc.ingest(op)
        if tl["first_verdict"] is None or tl["first_invalid"] is None:
            v = sc.verdict()
            if tl["first_verdict"] is None and v["status"] != "open":
                tl["first_verdict"] = (i, time.perf_counter() - t0)
            if tl["first_invalid"] is None and v["status"] == "invalid":
                tl["first_invalid"] = (i, time.perf_counter() - t0)
    tl["ingest_s"] = time.perf_counter() - t0
    return sc.finalize(), tl


def run_stream_tier(*, quick: bool = False, out_path: str | None = None,
                    device="cuda") -> dict:
    """The three measurements at 2000 ops per stream (400 with
    ``quick``); the dict, also written to ``out_path`` if given."""
    from ..checker.linear import check_opseq_linear
    from ..decompose.cache import VerdictCache
    from ..history import encode_ops
    from ..models import register

    n_ops = 400 if quick else 2000
    model = register(0)
    out: dict = {"metric": "streaming incremental checker",
                 "n_ops": n_ops, "quick": quick, "parity": True}

    def posthoc(h):
        seq = encode_ops(h, model.f_codes)
        t0 = time.perf_counter()
        r = check_opseq_linear(seq, model, lint=False)
        return r, time.perf_counter() - t0

    # time-to-first-verdict on a valid stream
    h, _ = _mk_history(11, n_ops)
    r, tl = _stream_one(model, h, device=device)
    ph, ph_s = posthoc(h)
    out["parity"] &= r["valid"] == ph["valid"]
    out["ttfv"] = {
        "events": len(h),
        "first_verdict_event": tl["first_verdict"][0]
        if tl["first_verdict"] else None,
        "first_verdict_s": round(tl["first_verdict"][1], 4)
        if tl["first_verdict"] else None,
        "stream_total_s": round(tl["ingest_s"], 4),
        "posthoc_s": round(ph_s, 4),
        "segments": r["stream"]["segments"],
        "valid": r["valid"],
    }

    # violation-detection latency
    h, k = _mk_history(12, n_ops, corrupt_at=0.1)
    r, tl = _stream_one(model, h, device=device)
    ph, _s = posthoc(h)
    out["parity"] &= r["valid"] == ph["valid"]
    inv = tl["first_invalid"]
    out["violation_latency"] = {
        "violation_event": k,
        "invalid_at_event": inv[0] if inv else None,
        "event_delta": (inv[0] - k) if inv else None,
        "invalid_at_s": round(inv[1], 4) if inv else None,
        "headroom_events": (len(h) - 1 - inv[0]) if inv else None,
        "detected_before_stream_end": bool(inv and inv[0] < len(h) - 1),
        "valid": r["valid"],
    }

    # sustained ingest, 4 concurrent streams on one cache
    cache = VerdictCache()
    streams = [(i, _mk_history(100 + (i % 2), n_ops)[0])
               for i in range(4)]  # two pairs share content: cache hits
    results: dict = {}

    def worker(i, h):
        results[i] = _stream_one(model, h, cache=cache, device=device)

    threads = [threading.Thread(target=worker, args=s) for s in streams]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    total_events = sum(len(h) for _i, h in streams)
    for i, h in streams:
        ph, _s = posthoc(h)
        out["parity"] &= results[i][0]["valid"] == ph["valid"]
    out["multiplexed"] = {
        "streams": len(streams),
        "events_total": total_events,
        "wall_s": round(wall, 4),
        "events_per_sec": round(total_events / wall, 1) if wall else None,
        "cache": {"hits": cache.hits, "misses": cache.misses,
                  "inserts": cache.inserts},
    }
    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return out
