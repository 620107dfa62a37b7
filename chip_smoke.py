#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA level-loop kernel from ``jepsen_tpu_torch/csrc`` with
nvcc and holds it against its plain torch version slice by slice on the
card (F=16 to 512 from the root, a history whose tables only fit in
device memory).  Then checks the two bench-tier histories ("1k": 1000-op
cas-register, "mutex2k": 1999-op mutex with crashed ops) down three
counted paths: the default entry point ``linearizable(model,
device="cuda")`` with its defaults (the lint, the static prepass, DPOR;
the competition race of the two host engines against the device search,
the host confirmation, the failure report), ``algorithm="device"`` with
the defaults, and ``algorithm="device"`` with the prepass and DPOR off.
mutex2k is decided by the prepass with no search; 1k's device search
runs on the kernel, which drops the reductions.  Beside them, with the
reductions off and held to the reference's counts: the device search
alone before the race (cold) and after (warm, every slice on the
kernel), and the race again with a shorter switch interval.  A control
runs 1k's device search with the reductions on the torch step instead
(the masked step on the card).  Then the kernel against its plain
version again from carries the 1k search reached at F=512 and F=2048;
the default entry point on three more histories (valid but not decided
by the greedy witness, past the device encoding, BASELINE config 1 with
its shrink) and on a fifo-queue and an unordered-queue history (state 16
words wide: the torch step); and the kernel timed at every shape the
main path uses.  The decomposition layer runs on the card too: the
batch256 keys through ``search_batch(decompose=True)`` with a verdict
cache file, cold (searched on the grid form), warm and from a reloaded
file (every key a hit, no launch), and a 32,768-op multi-register
history built from the same keys through the decomposed
``linearizable`` (in-process cells) and the device scheduler (its cells
as one batch on the grid form), each held to the JAX package's verdict
and ``decompose`` dict.  The streaming checker runs on the card at
full width (24 clients, 20 ops in flight, bursts of 32; :data:`STREAM`):
op by op through ``StreamChecker(device="cuda")`` with every closed
segment folded on the device, valid, and with a corrupted read (the
verdict flips at the violating segment's cut); its first two device
folds and the one that empties again on the card's torch step; its
first closed segments at the default gate, the one segment that gate
sends to the device folded alone, and a gated burst whose undecided
fold the checker sweeps on the host; with async folds; twice on one
verdict cache file (the second run all hits,
no launch); two streams with the same content through one
``StreamService`` (the second served from the cache); and the stream
bench tier.  The multi-device routes run over logical shards of the
card (:data:`SHARDS`): the sharded-frontier search on 1k (one shard and
four) and mutex2k, the key-sharded batch on batch256 (bucketed and
fused, its shards on B1's grid form), and the same batch over a
one-rank NCCL process group on the keys axis.  The fleet tier runs on
the card too (:func:`phase_fleet`): the warm boot from a cold kernel
cache launches B1 at every steady-state shape and verifies, two
in-process workers behind the router check a client swarm (every
segment folded on B1-T's grid form, no kernel-cache miss, every final
equal to one service's), a worker stopped mid-run has its runs salvaged
and rerouted, and ``python -m jepsen_tpu_torch.fleet`` boots two worker
processes from a warmup manifest and drains on SIGTERM.  The static plan
closes its loop on the card (:func:`phase_plan` to
:func:`phase_report`): ``explain`` launches nothing and predicts the
route, first dims and bucket the live searches take; the shard bench
tier runs in full over eight logical shards, its live stats equal to the
plan and to the JAX package's numbers; a seeded corpus replays through
every route with B1 on the direct and bucketed ones; the differential
fuzzer (:func:`phase_fuzz`) holds the device search on all five models
to the host oracles, B1-T on the register models' rounds and one round
past its widest frontier; batches of the fuzzer's histories hold B1's
grid to its plain version (:func:`phase_fuzz_grid`); and the shard
tier's trace folds into its device share.  The model checker and the
daemons come last (:func:`phase_mc` to :func:`phase_live`): ``python -m
jepsen_tpu_torch.analyze --mc --mc-scope all`` sweeps the 17 family x
mode pairs to the JAX package's blocks (:data:`MC_SWEEP`) and banks its
certificates, which replay on the card; the same command audits and
plans 1k after the card checked it, and fails a tampered certificate;
and the port's kv and replicated daemons run as real processes under
client traffic and SIGKILLs, their histories checked on the card and on
the host.  Then the checker library (:func:`phase_checkers`): the
batch256 keys as a stored test, saved, loaded and checked by
``compose`` of the lifted linearizability checker, a timeline per key
and ``perf``, and 26 seeded histories held to the JAX package's
verdicts, ``queue_linearizable``'s device leg among them on the card's
torch step; and the device contract (:func:`phase_devlint`): ``python -m
jepsen_tpu_torch.analyze --devlint`` in a fresh process, its findings
the pinned set.  Last, whole Jepsen tests through the port's
``core.run`` (:func:`phase_run`): the etcd tutorial's register test at
its width (50 keys, 5,000 ops, five nodes under a partition of the
halves on a dummy remote, the streaming checker on), valid and with a
client that lies on three keys, each key checked by linearizability
(B1-T on the card) and a timeline, the invalid keys held to the host's
verdict on the stored history; and a run whose generator raises, its
streamed prefix verdict on the exception and in the store.  Then the
suites (:func:`phase_suites`): ``python -m
jepsen_tpu_torch.suites.atomdemo test`` as a user types it, in a child
process with the device route, the stream and the trace on; the same
suite through ``cli.run`` in process on the default route; ``localnode``
with three real server processes under kill -9; the lock server's
staged double grant caught on the card; hazelcast's lock fixture
(BASELINE config 4) sound and broken; each verdict held to the host's
check of the stored history; the etcd tutorial (BASELINE config 1,
``python -m jepsen_tpu_torch.suites.etcdemo test``) against three etcd
gateway stand-ins, sound and with one gateway serving stale reads;
cockroach's SQL register (``python -m jepsen_tpu_torch.suites.cockroach
test --workload register``) against three pgwire stand-ins, sound from
its command line and in process with one stand-in serving stale reads;
the suite and service lint (``python -m
jepsen_tpu_torch.analyze.lint_suites``) over the tree under test; and
the results web server on the phase's store.  Every phase
prints one line per case, timed
lines with the card's name and power limit; the line before the last is
the per-kernel JSON record and the last line the device record.  Any failed
phase exits nonzero.  Exits nonzero without a result when no CUDA device
is present or the package is not beside this script.

Telemetry (the JAX package's device-search aux block) is on by default,
so every counted path runs the kernel's telemetry form, and every device
result must carry its ``search_telemetry`` block; every lockstep case
also runs the telemetry form, whose carry must equal the off form's and
whose block must equal the plain version's.  One extra pass of the 1k
paths and of batch256 runs with tracing on, and prints where the wall
went by span (``bucket.prep``, ``bucket.device``, ``device.slice``,
``device.transfer``), each path's device share and the process's
device idle fraction.  Every single-key shape and the grid form's first
rung are timed with telemetry off and on; the grid's launches are split
into the device's and the wrapper's time.

The script imports torch, numpy and the port only.
"""

from __future__ import annotations

import collections
import functools
import http.server
import json
import logging
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import replace
from pathlib import Path

REPO = Path(__file__).resolve().parent

#: bench tiers: (name, encoded ops, processes); generator parameters as
#: the JAX package's bench.py builds them, seeded "bench-<tier>"
TIERS = (("1k", 1000, 32), ("mutex2k", 2000, 16))

#: (valid, configs, max_depth) of the JAX package's device search on the
#: same tier histories (jepsen_tpu.checker.linearizable.search_opseq on
#: the CPU, lint/hb/dpor/audit off)
REFERENCE = {"1k": (False, 97218, 975), "mutex2k": (False, 15863, 1971)}

#: the same search with the JAX package's defaults (lint, prepass and
#: dpor on), also on the CPU, where the masked, deduplicated step runs:
#: 1k's prepass applies without deciding; mutex2k is decided by it
#: ("lock-overhold") with no search.  On the card the kernel takes 1k's
#: search and drops the reductions, so 1k gives REFERENCE's counts
#: there, and these only with the kernel kept out (the control)
REFERENCE_REDUCED = {"1k": (False, 65682, 975), "mutex2k": (False, 0, 0)}
PREPASS_REASON = {"1k": None, "mutex2k": "lock-overhold"}

#: queue histories through the default entry point, and the JAX
#: package's verdict on each (``linearizable(model)`` on the CPU, no
#: JEPSEN_TPU_* variable set); the fifo one is valid and not decided by
#: the prepass, so a device leg runs the torch step at state width 16
QUEUES = (("fifo-queue-6", True, True), ("unordered-queue-8", False, False))

#: keys of the batch256 tier (bench.py's BASELINE config 3)
BATCH_KEYS = 256

#: the JAX package's answer on the batch256 keys, per key
#: (``search_batch(keys, cas_register(), dpor=False)`` on the CPU, no
#: JEPSEN_TPU_* variable set; the same with the prune pinned to
#: all-pairs): every 4th key invalid, the rest valid; configs and depth
#: per key, 63,339 configs in all.  With the defaults the JAX package
#: keeps the reductions on the CPU (57,034 configs in all, the same
#: verdicts); on the card the kernel drops them, so every path there is
#: held to these counts
BATCH256_INVALID = frozenset(range(0, BATCH_KEYS, 4))
BATCH256_CONFIGS = (
    643, 101, 515, 93, 467, 100, 91, 90, 274, 91, 90, 93, 619, 92, 91, 93,
    593, 99, 94, 89, 505, 590, 92, 98, 623, 94, 96, 94, 414, 95, 86, 99,
    807, 82, 97, 105, 462, 91, 96, 90, 355, 93, 99, 100, 615, 90, 96, 98,
    488, 84, 96, 103, 491, 97, 89, 98, 541, 490, 107, 97, 1320, 479, 605,
    100, 513, 93, 91, 95, 364, 94, 100, 106, 651, 85, 95, 95, 575, 499, 93,
    93, 588, 100, 105, 95, 677, 93, 85, 811, 505, 98, 394, 100, 327, 90, 96,
    588, 451, 91, 96, 759, 411, 104, 100, 106, 525, 95, 512, 97, 417, 460,
    462, 96, 375, 81, 97, 95, 526, 96, 81, 93, 556, 100, 91, 98, 536, 107,
    100, 98, 375, 94, 92, 93, 537, 95, 96, 91, 385, 92, 87, 102, 442, 90,
    938, 93, 651, 521, 98, 95, 480, 95, 94, 100, 491, 94, 732, 92, 768, 98,
    91, 99, 399, 89, 83, 97, 633, 91, 92, 92, 500, 94, 101, 90, 548, 97,
    490, 93, 397, 95, 91, 95, 570, 91, 99, 96, 559, 100, 88, 85, 540, 101,
    93, 102, 837, 455, 91, 90, 412, 87, 93, 98, 442, 90, 97, 99, 547, 90,
    96, 94, 332, 94, 97, 90, 401, 92, 100, 99, 371, 97, 92, 99, 743, 96,
    103, 87, 509, 97, 90, 90, 885, 98, 97, 88, 761, 96, 95, 95, 447, 97,
    491, 96, 535, 84, 96, 93, 472, 91, 86, 534, 1547, 92, 106, 103, 1013,
    94, 94, 93)
BATCH256_DEPTH = (
    87, 101, 93, 93, 75, 100, 91, 90, 71, 91, 90, 93, 82, 92, 91, 93, 81,
    99, 94, 89, 85, 90, 92, 98, 83, 94, 96, 94, 71, 95, 86, 99, 73, 82, 97,
    105, 78, 91, 96, 90, 79, 93, 99, 100, 83, 90, 96, 98, 80, 84, 96, 103,
    80, 97, 89, 98, 79, 92, 107, 97, 82, 89, 91, 100, 85, 93, 91, 95, 75,
    94, 100, 106, 79, 85, 95, 95, 85, 88, 93, 93, 82, 100, 105, 95, 68, 93,
    85, 92, 77, 98, 86, 100, 80, 90, 96, 94, 79, 91, 96, 100, 69, 104, 100,
    106, 82, 95, 86, 97, 78, 93, 87, 96, 72, 81, 97, 95, 81, 96, 81, 93, 85,
    100, 91, 98, 84, 107, 100, 98, 69, 94, 92, 93, 80, 95, 96, 91, 74, 92,
    87, 102, 80, 90, 93, 93, 76, 101, 98, 95, 82, 95, 94, 100, 82, 94, 95,
    92, 89, 98, 91, 99, 74, 89, 83, 97, 74, 91, 92, 92, 78, 94, 101, 90, 83,
    97, 89, 93, 77, 95, 91, 95, 80, 91, 99, 96, 77, 100, 88, 85, 88, 101,
    93, 102, 84, 92, 91, 90, 84, 87, 93, 98, 72, 90, 97, 99, 80, 90, 96, 94,
    68, 94, 97, 90, 82, 92, 100, 99, 79, 97, 92, 99, 77, 96, 103, 87, 82,
    97, 90, 90, 89, 98, 97, 88, 84, 96, 95, 95, 74, 97, 93, 96, 71, 84, 96,
    93, 87, 91, 86, 95, 87, 92, 106, 103, 75, 94, 94, 93)

#: the keys whose configs differ when the batch runs at one fixed
#: frontier of 64 rows, as the sharded batch does, from ``BATCH256_*``,
#: whose ladder starts at 32: these three outgrow 32 rows, and the
#: ladder bills the configs of the rung they outgrew (the JAX package's
#: ``search_batch(keys, cas_register(), dpor=False,
#: dims=batch_dims(keys, frontier=64))`` on the CPU; verdicts and depths
#: as ``BATCH256_*``)
BATCH256_AT64_CONFIGS = {60: 765, 248: 909, 252: 546}

#: ``decompose_batch`` of the JAX package's ``search_batch(keys,
#: cas_register(), decompose=True, dpor=False)`` on the batch256 keys on
#: the CPU, with a fresh cache and then again on it: the 256 keys are 256
#: distinct canonical shapes, so the cold run searches each (verdicts,
#: configs and depths as ``BATCH256_*``) and the warm run hits each
BATCH256_DECOMP_COLD = {"n_keys": 256, "cache_hits": 0, "cache_misses": 256,
                        "deduped": 0, "searched": 256, "hit_rate": 0.0}
BATCH256_DECOMP_WARM = {"n_keys": 256, "cache_hits": 256, "cache_misses": 0,
                        "deduped": 0, "searched": 0, "hit_rate": 1.0}

#: the JAX package's answer on the multireg256 histories
#: (:func:`multireg_history`, with and without the corrupted keys) on the
#: CPU, no JEPSEN_TPU_* variable set: the verdict and ``decompose`` dict of
#: ``Linearizable(multi_register(256), decompose=True, verdict_cache=<a
#: fresh file>)`` (in-process cells, host engines; the corrupted history
#: stops at its first cell, key 0, which the prepass decides), and of
#: ``check_opseq_decomposed(seq, model, scheduler="device")`` with
#: JEPSEN_TPU_DPOR=0 (the card's kernel drops the reductions, as for
#: ``BATCH256_*``), whose ``cell_engines`` the card tags "(cuda)"
MULTIREG256 = {
    "multireg256": (False, {
        "cells": 256, "segments": 1, "cache_hits": 0, "cache_misses": 2,
        "configs_searched": 0, "methods": ["key-partition", "sub-search"],
        "cache_inserts": 2}),
    "multireg256-valid": (True, {
        "cells": 256, "segments": 256, "cache_hits": 0, "cache_misses": 257,
        "configs_searched": 609640,
        "methods": ["key-partition", "sub-search"], "stitched": True,
        "cache_inserts": 257}),
}
MULTIREG256_DEVICE = {
    "multireg256": (False, {
        "cells": 256, "segments": 0, "cache_hits": 0, "cache_misses": 0,
        "configs_searched": 55625, "methods": ["device", "key-partition"],
        "cell_engines": ["device-batch", "greedy-witness", "hb-decide"]}),
    "multireg256-valid": (True, {
        "cells": 256, "segments": 0, "cache_hits": 0, "cache_misses": 0,
        "configs_searched": 72827, "methods": ["device", "key-partition"],
        "cell_engines": ["device-batch", "greedy-witness"]}),
}

#: H100 SXM peaks for the kernel's bound (NVIDIA data sheet): memory
#: rate, and the float32 rate outside the tensor cores standing in for
#: 32-bit integer work (the card's int32 rate is at most that)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
OPS_PER_LANE = 8

#: the single-key form's time on mutex2k at F=64 before the telemetry
#: form, and the grid form's at batch256's first rung (this script, the
#: H100 80GB HBM3 at 700 W, the last run before it)
MUTEX2K_F64_BEFORE_TELE_MS = 2.5092
GRID_FIRST_RUNG_BEFORE_TELE_MS = 0.5761

#: launches of the counted main paths by (form, telemetry), gathered
#: over the paths by :func:`_read_counts`
FORM_LAUNCHES: collections.Counter = collections.Counter()
#: their grid launches by rung and telemetry, the same way, in this
#: process; and those a child process reported (devlint's), by
#: telemetry only
GRID_RUNG_LAUNCHES: collections.Counter = collections.Counter()
CHILD_GRID_LAUNCHES: collections.Counter = collections.Counter()
#: rung -> (model, dims, arguments) of the first grid launch of
#: batch256's bucketed run at that rung, for the grid timing
GRID_CAPTURED: dict = {}

#: device results whose per-level occupancy was checked against their
#: configs (a search that never overflowed, within the per-level cap)
OCCUPANCY_CHECKED: list = []

#: the interpreter's switch interval in the control race: a tenth of
#: the 5 ms default, so a thread that wants the GIL back waits less
CONTROL_SWITCH_S = 0.0005


#: the card's name and power limit as nvidia-smi prints them, set in
#: main; every timed line ends with it
CARD = "?"


class SmokeFailure(Exception):
    pass


def emit(line: str) -> None:
    """Print a timed line with the card's name and power limit."""
    print(f"{line} | card: {CARD}", flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _zero_counts() -> None:
    """Every launch count set to 0, just before a counted path."""
    from jepsen_tpu_torch.checker import level_kernel as lk

    lk.LAUNCHES = lk.BATCH_LAUNCHES = 0
    for k in lk.LAUNCHES_BY_FORM:
        lk.LAUNCHES_BY_FORM[k] = 0
    lk.GRID_LAUNCHES.clear()


def _read_counts(counted: bool = True) -> tuple:
    """(single-key, grid) launches since :func:`_zero_counts`, just after
    a path; a counted path's launches by form join
    :data:`FORM_LAUNCHES`."""
    from jepsen_tpu_torch.checker import level_kernel as lk

    if counted:
        for (form, tele), n in lk.LAUNCHES_BY_FORM.items():
            FORM_LAUNCHES[f"{form},{'on' if tele else 'off'}"] += n
        for (f, tele), n in lk.GRID_LAUNCHES.items():
            GRID_RUNG_LAUNCHES[f"F={f},{'on' if tele else 'off'}"] += n
    return lk.LAUNCHES, lk.BATCH_LAUNCHES


def _tele_totals(res) -> str:
    """A result's telemetry block in one line."""
    b = res.get("search_telemetry")
    if b is None:
        return "-"
    return (f"levels={b['levels']} slices={b['slices']} "
            f"max_occupancy={b['max_occupancy']} expanded={b['expanded']} "
            f"mask_killed={b['mask_killed']} dedup_folds={b['dedup_folds']} "
            f"crash_rounds={b['crash_rounds']} overflows={b['overflows']} "
            f"goals={b['goals']} observed_prune_ratio="
            f"{b['observed_prune_ratio']}")


def _check_telemetry(label, res) -> None:
    """A device result carries its ``search_telemetry`` block; where its
    search never overflowed and kept every level's row (at most
    ``BLOCK_LEVEL_CAP`` levels), the occupancy column adds up to its
    configs."""
    from jepsen_tpu_torch.obs.telemetry import BLOCK_LEVEL_CAP

    b = res.get("search_telemetry")
    check(b is not None, f"{label}: the device result ({res.get('engine')})"
          " carries no search_telemetry")
    check(b["levels"] > 0 and b["slices"] > 0,
          f"{label}: an empty telemetry block {b}")
    if (b["overflows"] == 0 and not b["truncated"]
            and b["levels"] <= BLOCK_LEVEL_CAP
            and "resumed" not in res.get("engine", "")):
        occ = sum(r[0] for r in b["per_level"])
        check(occ == res["configs"], f"{label}: the occupancy column sums "
              f"to {occ}, the search counted {res['configs']} configs")
        OCCUPANCY_CHECKED.append((label, occ))


# ---------------------------------------------------------------------------
# histories
# ---------------------------------------------------------------------------


def _exact_encoded(gen, encode, target: int, *, lo_guess: int):
    """Scan the generator's nominal size until the ENCODED row count
    equals ``target`` (encoding drops :fail ops); deterministic, so the
    same tier always gives the same history."""
    n = lo_guess
    best = None
    seen: set[int] = set()
    for _ in range(200):
        h = gen(n)
        seq = encode(h)
        got = len(seq)
        if got == target:
            return h, seq
        if best is None or abs(got - target) < best[0]:
            best = (abs(got - target), h, seq)
        seen.add(n)
        step = int(round(n * (target - got) / max(1, got)))
        n += step if step else (1 if got < target else -1)
        n = max(target // 2, n)
        if n in seen:
            for d in range(1, 50):
                if n + d not in seen:
                    n += d
                    break
                if n - d > target // 2 and n - d not in seen:
                    n -= d
                    break
            else:
                break
    return best[1], best[2]


def tier_history(name: str):
    """(OpSeq, model) of a bench tier, built with the port's synth."""
    _, seq, model = tier_events(name)
    return seq, model


def tier_events(name: str):
    """(events, OpSeq, model) of a bench tier: the history whose
    encoding :func:`tier_history` checks."""
    from jepsen_tpu_torch.history import encode_ops, invoke_op, ok_op
    from jepsen_tpu_torch.models import cas_register, mutex
    from jepsen_tpu_torch.synth import (corrupt_read, register_history,
                                        sim_mutex_history)

    _, n_ops, n_procs = {t[0]: t for t in TIERS}[name]
    if name == "mutex2k":
        model = mutex()

        def gen(n):
            rng = random.Random(f"bench-{name}")
            h = sim_mutex_history(rng, n_ops=n, n_procs=n_procs,
                                  crash_p=0.01, max_crashes=12)
            # an acquire chain longer than the :info ops can explain
            n_info = sum(1 for op in h if op.type == "info")
            for i in range(n_info + 2):
                p = n_procs + i
                h = h + [invoke_op(p, "acquire", None),
                         ok_op(p, "acquire", None)]
            return h
        lo = n_ops
    else:
        model = cas_register()

        def gen(n):
            rng = random.Random(f"bench-{name}")
            h = register_history(rng, n_ops=n, n_procs=n_procs, overlap=8,
                                 crash_p=0.002, max_crashes=8, n_values=4)
            return corrupt_read(rng, h, at=0.98)
        lo = int(n_ops * 1.35)
    h, seq = _exact_encoded(gen, lambda h: encode_ops(h, model.f_codes),
                            n_ops, lo_guess=lo)
    return h, seq, model


def big_mutex_history():
    """(OpSeq, model): a 9000-op mutex history whose tables (n_det_pad
    16384, about 393 KB) do not fit in shared memory."""
    from jepsen_tpu_torch.history import encode_ops
    from jepsen_tpu_torch.models import mutex
    from jepsen_tpu_torch.synth import sim_mutex_history

    m = mutex()
    h = sim_mutex_history(random.Random(7), n_ops=9000, n_procs=6,
                          crash_p=0.001, max_crashes=3)
    return encode_ops(h, m.f_codes), m


def extra_histories():
    """(label, OpSeq, model, want) for the default entry point beyond the
    tiers: a 997-op cas-register history the greedy witness cannot
    decide (a crashed write took effect), valid; a 470-op register
    history with 70 crashed ops (past the device encoding), invalid; and
    BASELINE config 1, an etcd cas-register history of 183 ops (10
    processes, 5 values, crashed ops, one corrupted read), invalid."""
    from jepsen_tpu_torch.history import encode_ops
    from jepsen_tpu_torch.models import cas_register, register
    from jepsen_tpu_torch.synth import (corrupt_read,
                                        crash_heavy_register_history,
                                        register_history)

    out = []
    m = cas_register()
    h = register_history(random.Random("valid-26"), n_ops=1350, n_procs=32,
                         overlap=8, crash_p=0.002, max_crashes=8,
                         n_values=4)
    out.append(("valid-1k", encode_ops(h, m.f_codes), m, True))
    m = register(0)
    h = crash_heavy_register_history(
        random.Random("past-encoding"), n_ops=400, n_procs=8, overlap=6,
        n_values=4, n_crash=70, corrupt=True)
    out.append(("past-encoding", encode_ops(h, m.f_codes), m, False))
    m = cas_register()
    rng = random.Random("baseline-1")
    h = register_history(rng, n_ops=270, n_procs=10, overlap=10,
                         crash_p=0.02, max_crashes=8, n_values=5)
    h = corrupt_read(rng, h, at=0.8)
    out.append(("baseline-1", encode_ops(h, m.f_codes), m, False))
    return out


def queue_history(name: str, *, fifo: bool):
    """(OpSeq, model): a queue history of six rounds of 50 enqueue/
    dequeue ops (``synth.sim_queue_history``, crashed ops included),
    each round on processes and values of its own and followed by
    dequeues of what it left, so the queue stays within 16 lanes; the
    unordered one then has two dequeues' values swapped."""
    from jepsen_tpu_torch.history import encode_ops, invoke_op, ok_op
    from jepsen_tpu_torch.models import fifo_queue, unordered_queue
    from jepsen_tpu_torch.synth import sim_queue_history, swap_dequeues

    rng = random.Random(name)
    h = []
    for r in range(6):
        sub = [replace(op, process=op.process + 5 * r,
                       value=None if op.value is None
                       else op.value + 1000 * r)
               for op in sim_queue_history(rng, 50, 4, crash_p=0.03,
                                           fifo=fifo)]
        taken = {op.value for op in sub
                 if op.type == "ok" and op.f == "dequeue"}
        for op in list(sub):
            if op.type == "ok" and op.f == "enqueue" \
                    and op.value not in taken:
                sub += [invoke_op(5 * r + 4, "dequeue", None),
                        ok_op(5 * r + 4, "dequeue", op.value)]
        h += sub
    if not fifo:
        h = swap_dequeues(random.Random(name + "-swap"), h)
    model = (fifo_queue if fifo else unordered_queue)(16)
    return encode_ops(h, model.f_codes), model


def lockstep_cases():
    """(label, model, OpSeq, frontier, bail, slices, lvl_cap) for the
    kernel-vs-plain phase: the JAX package's own Pallas lockstep cases,
    the bench tiers at the main path's F=64 rung, a wider cas-register
    history with crashes at F=128 and F=512, mutex2k at F=128 and in
    300-level slices at F=64, and a history whose tables only fit in
    device memory."""
    from jepsen_tpu_torch.history import encode_ops
    from jepsen_tpu_torch.models import cas_register, mutex
    from jepsen_tpu_torch.synth import (corrupt_read, register_history,
                                        sim_mutex_history)

    out = []
    for seed in (1, 2, 3, 4, 5):
        rng = random.Random(seed)
        h = register_history(rng, n_ops=56, n_procs=4, overlap=3,
                             crash_p=0.08, max_crashes=4, n_values=3)
        if seed % 2:
            h = corrupt_read(rng, h, at=0.85)
        m = cas_register()
        out.append((f"cas-crash-{seed}", m, encode_ops(h, m.f_codes), 16,
                    False, 12, 8))
    for seed in (11, 12, 13):
        rng = random.Random(seed)
        h = sim_mutex_history(rng, n_ops=60, n_procs=3, crash_p=0.06,
                              max_crashes=4)
        m = mutex()
        out.append((f"mutex-{seed}", m, encode_ops(h, m.f_codes), 16,
                    False, 12, 8))
    for seed in (21, 22, 23):
        rng = random.Random(seed)
        h = register_history(rng, n_ops=64, n_procs=8, overlap=7,
                             crash_p=0.05, max_crashes=3, n_values=2)
        m = cas_register()
        seq = encode_ops(h, m.f_codes)
        out.append((f"overflow-bail-{seed}", m, seq, 16, True, 12, 8))
        out.append((f"overflow-nobail-{seed}", m, seq, 16, False, 12, 8))
    for name, _, _ in TIERS:
        seq, m = tier_history(name)
        out.append((f"{name}-F64", m, seq, 64, False, 4, 64))
    rng = random.Random(31)
    h = register_history(rng, n_ops=200, n_procs=12, overlap=10,
                         crash_p=0.06, max_crashes=6, n_values=3)
    h = corrupt_read(rng, h, at=0.85)
    m = cas_register()
    seq = encode_ops(h, m.f_codes)
    for frontier in (128, 512):
        for bail in (True, False):
            out.append((f"cas-crash-wide-F{frontier}-"
                        f"{'bail' if bail else 'nobail'}", m, seq, frontier,
                        bail, 6, 8))
    seq, m = tier_history("mutex2k")
    out.append(("mutex2k-F128", m, seq, 128, False, 4, 64))
    # slices of 300 levels: the telemetry block's last row folds the
    # levels past its 128 rows
    out.append(("mutex2k-F64-L300", m, seq, 64, False, 2, 300))
    seq, m = big_mutex_history()
    out.append(("mutex9k-device-tables-F64", m, seq, 64, False, 3, 64))
    return out


def batch_key_history(k: int):
    """(history, model): key ``k`` of bench's BASELINE config 3 tier
    ("batch256", ``bench.py:275-297``): a 128-op, 8-process cas-register
    history, every 4th key with a corrupted read."""
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.synth import corrupt_read, register_history

    rng = random.Random(f"bench-batch-{k}")
    h = register_history(rng, n_ops=128, n_procs=8, overlap=4, crash_p=0.01,
                         max_crashes=2, n_values=4)
    if k % 4 == 0:
        h = corrupt_read(rng, h, at=0.85)
    return h, cas_register()


def batch_keys(n: int = BATCH_KEYS):
    """(OpSeqs, model) of the first ``n`` keys of the batch256 tier."""
    from jepsen_tpu_torch.history import encode_ops

    out = []
    for k in range(n):
        h, model = batch_key_history(k)
        out.append(encode_ops(h, model.f_codes))
    return out, model


def keyed_history(n: int = BATCH_KEYS):
    """(history, model): the same keys as one ``[k v]`` history, key
    after key, for ``independent.checker``."""
    from jepsen_tpu_torch.independent import tuple_

    out = []
    for k in range(n):
        h, model = batch_key_history(k)
        out += [replace(op, value=tuple_(k, op.value)) for op in h]
    return out, model


def multireg_history(n: int = BATCH_KEYS, *, corrupt: bool = True):
    """(history, model): BASELINE config 3's size as one
    ``multi_register(n)`` history.  Key k's ops come from the batch256
    generator with ``cas=False`` (every 4th key with a corrupted read
    when ``corrupt``), its processes 8k..8k+7 and its values ``(k, v)``;
    the keys' events are merged round-robin onto one clock, each key's
    own order kept."""
    from jepsen_tpu_torch.models import multi_register
    from jepsen_tpu_torch.synth import corrupt_read, register_history

    per_key = []
    for k in range(n):
        rng = random.Random(f"bench-batch-{k}")
        h = register_history(rng, n_ops=128, n_procs=8, overlap=4,
                             crash_p=0.01, max_crashes=2, n_values=4,
                             cas=False)
        if corrupt and k % 4 == 0:
            h = corrupt_read(rng, h, at=0.85)
        per_key.append([replace(op, process=8 * k + op.process,
                                value=(k, op.value)) for op in h])
    merged = [h[j] for j in range(max(map(len, per_key)))
              for h in per_key if j < len(h)]
    return merged, multi_register(n)


def grid_setup(model, seqs, frontier, device, *, lanes=None):
    """(dims, stacked args, stacked carry) of a batch at its batch dims
    and ``frontier``, from the root, with ``lanes - len(seqs)`` inert pad
    lanes."""
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.checker.encode import encode_search, pad_search

    ess = [encode_search(s) for s in seqs]
    dims = lin.batch_dims(ess, model, frontier=frontier)
    dead_pad = lin.batch_dead_pad(ess)
    esps = [pad_search(e, dims.n_det_pad, dims.n_crash_pad,
                       dead_pad=dead_pad) for e in ess]
    b = lanes or len(seqs)
    args = lin.stack_batch(esps, pad_to=b, device=device)
    carry = lin.pad_batch_carry(
        lin._init_batch_carry(len(seqs), dims, model, device),
        b - len(seqs), dims, model, device)
    return dims, args, carry


def grid_diff(ck, cr) -> int:
    """Max abs difference of two stacked carries over every key's
    scalars and live frontier rows (at least 1 where live counts
    differ)."""
    import torch

    def scal(c):
        return torch.stack([c[1], c[2], c[3], c[4], c[5].to(torch.int32)],
                           dim=1).to(torch.int64)

    err = int((scal(ck) - scal(cr)).abs().max())
    F = ck[0].shape[1]
    live = (torch.arange(F, device=ck[0].device)[None, :]
            < cr[1][:, None])[..., None]
    d = ((ck[0].to(torch.int64) - cr[0].to(torch.int64)).abs() * live)
    return max(err, int(d.max()) if d.numel() else 0)


def _idle_lanes(carry, budget, bail, n=None) -> int:
    """Of the first ``n`` lanes (default all), those with nothing to do:
    the slice must hand them back as they came."""
    st, ct, cf, ov = (c[:n] for c in (carry[2], carry[1], carry[3],
                                       carry[5]))
    busy = (st == -1) & (ct > 0) & (cf < budget)
    if bail:
        busy = busy & ~ov
    return int((~busy).sum())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _setup(model, seq, frontier, device):
    from jepsen_tpu_torch.checker.encode import (carry_to_device,
                                                 choose_dims, encode_search,
                                                 pad_search, search_args,
                                                 _init_carry)

    es = encode_search(seq)
    dims = choose_dims(es, model, device=device, frontier=frontier)
    esp = pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    args = search_args(esp, es, device=device)
    carry = carry_to_device(_init_carry(dims, model), device)
    return dims, args, carry


def _timed(fn, *a):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*a)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _diff(ca, cb):
    """Max abs difference of two carries over the scalars and the live
    frontier rows (at least 1 when the live counts differ)."""
    import torch

    sa = [int(v) for v in ca[1:]]
    sb = [int(v) for v in cb[1:]]
    err = max(abs(x - y) for x, y in zip(sa, sb))
    n = sa[0]
    if sa[0] != sb[0]:
        return max(err, 1)
    if n:
        d = (ca[0][:n].to(torch.int64) - cb[0][:n].to(torch.int64)).abs()
        err = max(err, int(d.max()))
    return err


class _EmptyRounds:
    """Counts, while active, the closure rounds of the plain version
    (the torch step) that merge an empty successor block: the rounds the
    kernel's closure shortcut skips and its telemetry still counts."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        from jepsen_tpu_torch.checker import step

        self._saved = succ_block = step._succ_block

        def spy(pieces, frontier, validf, cand, ns, cap, K):
            if cap == frontier.shape[0] and not bool(validf.any()):
                self.n += 1
            return succ_block(pieces, frontier, validf, cand, ns, cap, K)

        step._succ_block = spy
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.checker import step

        step._succ_block = self._saved


def _block_err(a, b) -> int:
    """Max abs difference of two telemetry blocks."""
    return int((a.to("cpu").long() - b.to("cpu").long()).abs().max())


def _lockstep_one(label, model, dims, args, carry, bail, slices, lvl_cap):
    """Kernel vs plain version from ``carry``, slice by slice, the
    kernel's off and telemetry forms against the plain version's
    telemetry build: the same carries, and the same block.  Returns
    (max abs error, the blocks' last-row occupancy, empty closure rounds
    of the plain version)."""
    from jepsen_tpu_torch.checker import level_kernel as lk

    check(lk.eligible(model, dims), f"{label}: {dims} not eligible")
    plan = lk.launch_plan(dims, carry[0].device)
    ck = ct = cr = carry
    t_k, t_t, t_r = [], [], []
    worst = fold = 0
    total = None
    with _EmptyRounds() as empty:
        for s in range(slices):
            ck, ms_k = _timed(lk.level_loop, model, dims, *args, 10**8,
                              lvl_cap, bail, *ck)
            ot, ms_t = _timed(functools.partial(lk.level_loop,
                                                telemetry=True),
                              model, dims, *args, 10**8, lvl_cap, bail, *ct)
            orf, ms_r = _timed(functools.partial(lk.level_loop_reference,
                                                 telemetry=True),
                               model, dims, *args, 10**8, lvl_cap, bail,
                               *cr)
            ct, cr = ot[:6], orf[:6]
            t_k.append(ms_k)
            t_t.append(ms_t)
            t_r.append(ms_r)
            err = _diff(ck, cr)
            worst = max(worst, err)
            check(err == 0, f"{label} slice {s}: kernel != plain "
                  f"(kernel {[int(v) for v in ck[1:]]}, plain "
                  f"{[int(v) for v in cr[1:]]}, max abs err {err})")
            err = max(_diff(ct, ck), _block_err(ot[6], orf[6]))
            worst = max(worst, err)
            check(err == 0, f"{label} slice {s}: the telemetry form's "
                  f"carry or block != the off form's / the plain "
                  f"version's (max abs err {err})")
            fold = max(fold, int(ot[6][-1, 0]))
            total = ot[6] if total is None else total + ot[6]
            if int(cr[2]) != -1 or int(cr[1]) == 0 or \
                    (bail and bool(cr[5])):
                break
    emit(f"lockstep {label}: F={dims.frontier} W={dims.window} "
          f"NC={dims.n_crash_pad} n_det_pad={dims.n_det_pad} "
          f"tables={plan['tables']} smem={plan['smem_bytes']} B "
          f"({'+'.join(plan['in_smem'])}) scratch={plan['scratch_bytes']} B "
          f"threads={plan['threads']} "
          f"live_in={int(carry[1])} slices={s + 1} identical; "
          f"status={int(ck[2])} configs={int(ck[3])} depth={int(ck[4])} "
          f"ovf={int(ck[5])}; telemetry on == off, block == plain: column "
          f"sums {total.sum(0).tolist()}, last row occupancy {fold}, "
          f"empty closure rounds {empty.n}; kernel ms/slice "
          f"{[round(t, 3) for t in t_k]} (telemetry "
          f"{[round(t, 3) for t in t_t]}) plain ms/slice "
          f"{[round(t, 1) for t in t_r]}")
    return worst, fold, empty.n


def phase_lockstep(device):
    """Kernel vs plain version slice by slice on the card, from the
    root; at least one case on each table path."""
    from jepsen_tpu_torch.checker import level_kernel as lk

    worst = folded = empty = 0
    paths = set()
    for label, model, seq, frontier, bail, slices, lvl_cap in \
            lockstep_cases():
        dims, args, carry = _setup(model, seq, frontier, device)
        paths.add(lk.launch_plan(dims, device)["tables"])
        err, fold, n_empty = _lockstep_one(label, model, dims, args, carry,
                                           bail, slices, lvl_cap)
        worst = max(worst, err)
        folded += fold > 1
        empty += n_empty
    check(paths == {"shared", "device"},
          f"lockstep ran the table paths {sorted(paths)}, want both")
    check(folded, "no lockstep case folded levels into the block's last row")
    # the kernel's closure shortcut skips a round that would merge an
    # empty successor block, which its telemetry counts all the same;
    # such a round cannot arise (some kept row always keeps an enabled
    # crash lane), and the plain version shows none
    emit(f"lockstep telemetry: {folded} case(s) folded levels into the "
         f"last row; empty closure rounds in the plain version: {empty}")
    return worst


def grid_lockstep_cases():
    """(label, model, OpSeqs, frontier, lanes, bail, slices, lvl_cap) for
    the grid form against its plain version: batch256's keys in batches
    of 256, 37 (27 pad lanes) and 4 (4 pad lanes) at F=32, 128 and 512,
    bail on and off; at F=32 one running key among seven pad lanes, and
    the three keys that outgrow 32 rows, key 248's overflowing level
    reverted in the first slice; keys of 16 to 192 ops, so that finished
    and running keys share a launch; and a 9000-op mutex key beside two
    short ones, whose tables only fit in device memory."""
    from jepsen_tpu_torch.history import encode_ops
    from jepsen_tpu_torch.models import cas_register, mutex
    from jepsen_tpu_torch.synth import register_history, sim_mutex_history

    keys, m = batch_keys(BATCH_KEYS)
    out = [("batch256-F32-bail", m, keys, 32, 256, True, 2, 16),
           ("batch37-F32-nobail", m, keys[:37], 32, 64, False, 2, 16),
           ("batch1+7pads-F32-bail", m, keys[:1], 32, 8, True, 2, 16),
           ("overflow3-F32-bail", m, [keys[k] for k in (60, 248, 252)], 32,
            4, True, 2, 64),
           ("batch37-F128-bail", m, keys[:37], 128, 64, True, 2, 16),
           ("batch37-F128-nobail", m, keys[:37], 128, 64, False, 2, 16),
           ("batch4-F512-bail", m, keys[:4], 512, 8, True, 2, 16),
           ("batch4-F512-nobail", m, keys[:4], 512, 8, False, 2, 16)]
    cas = cas_register()
    mixed = [encode_ops(register_history(
        random.Random(f"mixed-{k}"), n_ops=16 + 16 * k, n_procs=6,
        overlap=4, crash_p=0.03, max_crashes=3, n_values=3), cas.f_codes)
        for k in range(12)]
    out.append(("mixed-12-F64", cas, mixed, 64, 16, False, 6, 32))
    big, mm = big_mutex_history()
    small = [encode_ops(sim_mutex_history(random.Random(s), n_ops=60,
                                          n_procs=3, crash_p=0.06,
                                          max_crashes=4), mutex().f_codes)
             for s in (11, 12)]
    out.append(("mutex9k+2-device-tables-F64", mm, [big] + small, 64, 3,
                False, 2, 64))
    return out


def _grid_lockstep_one(label, model, dims, args, carry, bail, slices,
                       lvl_cap, n_keys):
    """The grid form vs its plain version from ``carry``, slice by
    slice, off and with telemetry; returns (max abs error, slices that
    had finished keys beside running ones, table path, keys whose
    overflowing level was reverted)."""
    from jepsen_tpu_torch.checker import level_kernel as lk

    check(lk.eligible(model, dims), f"{label}: {dims} not eligible")
    plan = lk.launch_plan(dims, carry[0].device)
    ck = ct = cr = carry
    t_k, t_t, t_r = [], [], []
    worst = idle = mixed = reverted = 0
    B = carry[0].shape[0]
    total = None
    for s in range(slices):
        idle += _idle_lanes(ck, 10**8, bail)
        done = _idle_lanes(ck, 10**8, bail, n_keys)
        mixed += 0 < done < n_keys
        fresh = (cr[2] == -1) & (cr[1] > 0) & ~cr[5]
        before = lk.BATCH_LAUNCHES
        ck, ms_k = _timed(lk.level_loop_batch, model, dims, *args, 10**8,
                          lvl_cap, bail, *ck)
        check(lk.BATCH_LAUNCHES == before + 1,
              f"{label}: the grid form did not launch")
        ot, ms_t = _timed(functools.partial(lk.level_loop_batch,
                                            telemetry=True),
                          model, dims, *args, 10**8, lvl_cap, bail, *ct)
        orf, ms_r = _timed(functools.partial(lk.level_loop_batch_reference,
                                             telemetry=True),
                           model, dims, *args, 10**8, lvl_cap, bail, *cr)
        ct, cr = ot[:6], orf[:6]
        t_k.append(ms_k)
        t_t.append(ms_t)
        t_r.append(ms_r)
        err = grid_diff(ck, cr)
        worst = max(worst, err)
        check(err == 0, f"{label} slice {s}: grid kernel != plain "
              f"(max abs err {err})")
        err = max(grid_diff(ct, ck), _block_err(ot[6], orf[6]))
        worst = max(worst, err)
        check(err == 0, f"{label} slice {s}: the grid telemetry form's "
              f"carry or blocks != the off form's / the plain version's "
              f"(max abs err {err})")
        pad = int(ot[6][n_keys:].abs().sum())
        check(pad == 0, f"{label} slice {s}: pad lanes wrote telemetry")
        if bail:
            reverted += int((fresh & (cr[2] == -1) & cr[5]).sum())
        total = ot[6] if total is None else total + ot[6]
        if _idle_lanes(cr, 10**8, bail) == B:
            break
    emit(f"grid-lockstep {label}: B={B} F={dims.frontier} W={dims.window} "
         f"NC={dims.n_crash_pad} n_det_pad={dims.n_det_pad} bail={int(bail)} "
         f"tables={plan['tables']} smem={plan['smem_bytes']} B "
         f"threads={plan['threads']} blocks/SM={plan['blocks_per_sm']} "
         f"slices={s + 1} identical; idle lanes handed back {idle} "
         f"({mixed} slices with finished keys beside running ones); "
         f"overflowing levels reverted {reverted}; status counts "
         f"{sorted(collections.Counter(cr[2].tolist()).items())}; "
         f"telemetry on == off, blocks == plain: column sums "
         f"{total.sum((0, 1)).tolist()}; kernel ms/slice "
         f"{[round(t, 3) for t in t_k]} (telemetry "
         f"{[round(t, 3) for t in t_t]}) plain ms/slice "
         f"{[round(t, 1) for t in t_r]}")
    return worst, mixed, plan["tables"], reverted


def phase_grid_lockstep(device):
    """The grid-over-keys form against its plain version on the card,
    every key's scalars and live rows identical after every slice; a
    launch with idle lanes beside running ones, pad lanes, both table
    paths and an overflowing level reverted."""
    worst = reverted = 0
    paths = set()
    idle_seen = False
    for label, model, seqs, frontier, lanes, bail, slices, lvl_cap in \
            grid_lockstep_cases():
        dims, args, carry = grid_setup(model, seqs, frontier, device,
                                       lanes=lanes)
        err, mixed, tables, rev = _grid_lockstep_one(
            label, model, dims, args, carry, bail, slices, lvl_cap,
            len(seqs))
        worst = max(worst, err)
        paths.add(tables)
        idle_seen = idle_seen or mixed > 0
        reverted += rev
    check(paths == {"shared", "device"},
          f"grid lockstep ran the table paths {sorted(paths)}, want both")
    check(idle_seen, "mixed: no launch had finished keys beside running "
          "ones")
    check(reverted, "grid lockstep: no launch reverted an overflowing level")
    return worst


class _GridTrace:
    """Wraps ``linearizable.get_batch_kernel`` for one run: per batch
    slice, its rung, its lanes, the keys it had to run and its route
    (the grid kernel or the torch step key by key)."""

    def __init__(self):
        self.slices: list = []  # (frontier, lanes, running keys, route)
        #: rung -> (model, dims, the call's arguments) of its first
        #: launch on the grid kernel
        self.first: dict = {}

    def __enter__(self):
        from jepsen_tpu_torch.checker import linearizable as lin

        self._saved = get_batch_kernel = lin.get_batch_kernel

        def traced(model, dims, device, **reduction):
            fn = get_batch_kernel(model, dims, device, **reduction)
            route = ("cuda" if lin._use_kernel(
                model, dims, device, masked=reduction.get("masked", False),
                dedup=reduction.get("dedup", False)) else "torch")

            def run(*a):
                busy = int(((a[24] == -1) & (a[23] > 0)).sum())
                self.slices.append((dims.frontier, int(a[22].shape[0]),
                                    busy, route))
                if route == "cuda":
                    self.first.setdefault(dims.frontier, (model, dims, a))
                return fn(*a)
            return run

        lin.get_batch_kernel = traced
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.checker import linearizable as lin

        lin.get_batch_kernel = self._saved

    def summary(self) -> str:
        by = collections.defaultdict(lambda: [0, 0, 0])
        for f, lanes, busy, route in self.slices:
            r = by[(route, f)]
            r[0] += 1
            r[1] += lanes
            r[2] += busy
        return "; ".join(
            f"{route} F={f}: {n} launches, {lanes / n:.1f} lanes and "
            f"{busy / n:.1f} running keys per launch"
            for (route, f), (n, lanes, busy) in sorted(by.items()))


def _route_counts(results) -> dict:
    """How many keys each route decided."""
    out = collections.Counter()
    for r in results:
        e = r.get("engine", "?")
        out["greedy" if e == "greedy-witness" else
            "prepass" if e in ("hb-decide", "constraint-decide") else
            "device-batch" if e.startswith("device-batch") else
            "device-solo" if e.startswith("device-bfs") else
            "host" if e.startswith("host-linear") else e] += 1
    return dict(sorted(out.items()))


class _StepTrace:
    """Wraps ``checker.linearizable.get_kernel`` for one run: the slices
    the torch step ran (a slice function that is not the fused kernel),
    counted by the device the search was asked for."""

    def __enter__(self):
        from jepsen_tpu_torch.checker import linearizable as lin

        self.slices = collections.Counter()
        self._saved = get = lin.get_kernel

        def traced(model, dims, device, **kw):
            fn = get(model, dims, device, **kw)
            if lin._use_kernel(model, dims, device,
                               masked=kw.get("masked", False),
                               dedup=kw.get("dedup", False)):
                return fn

            def counted(*a):
                self.slices[str(device)] += 1
                return fn(*a)

            return counted

        lin.get_kernel = traced
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.checker import linearizable as lin

        lin.get_kernel = self._saved


def _check_batch_results(label, results, rechecked=(), configs=None):
    """Every key's verdict is the JAX package's; its configs and depth
    too, but for keys checked again on their own (``rechecked``).
    ``configs`` replaces some keys' configs (a key -> configs map)."""
    check(len(results) == BATCH_KEYS, f"{label}: {len(results)} results")
    for k, r in enumerate(results):
        want = k not in BATCH256_INVALID
        check(r["valid"] is want,
              f"{label}: key {k} gave {r['valid']}, want {want}")
        if k in rechecked:
            continue
        got = (r["configs"], r["max_depth"])
        ref = ((configs or {}).get(k, BATCH256_CONFIGS[k]), BATCH256_DEPTH[k])
        check(r["configs"] <= ref[0], f"{label}: key {k} visited "
              f"{r['configs']} configs, more than the JAX package's {ref[0]}")
        check(got == ref, f"{label}: key {k} gave (configs, depth) {got}, "
              f"the JAX package {ref}")


def _batch_run(label, run, counted=True):
    """One batch256 run, with both launch counts set to 0 just before it
    and read just after (``counted``: the run is the path's counted one,
    not its warm repeat); returns (results, seconds, grid launches,
    single-key launches, the grid trace)."""
    with _GridTrace() as trace:
        _zero_counts()
        t0 = time.perf_counter()
        results = run()
        wall = time.perf_counter() - t0
        single, grid = _read_counts(counted)
    check(grid == sum(1 for s in trace.slices if s[3] == "cuda"),
          f"{label}: {grid} grid launches, {len(trace.slices)} batch slices")
    return results, wall, grid, single, trace


def phase_batch256(store_base):
    """bench's BASELINE config 3 (256 cas-register keys of 128 ops, every
    4th corrupted) three ways on the card, each cold and then warm:
    ``search_batch`` bucketed (the default), fused (``bucket=False``),
    and ``independent.checker(linearizable(model))`` on the keyed
    history, which checks every invalid key again on its own.  Every
    key's verdict, configs and depth must be the JAX package's, and the
    grid form must have run on each path."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker import linearizable as lin

    keys, model = batch_keys()
    keyed, _ = keyed_history()
    test = {"name": "batch256", "store_base": store_base}
    ways = (
        ("bucketed", lambda: lin.search_batch(keys, model, device="cuda")),
        ("fused", lambda: lin.search_batch(keys, model, device="cuda",
                                           bucket=False)),
        ("independent", lambda: independent.checker(
            lin.linearizable(model)).check(test, keyed)))
    launches = {}
    for way, run in ways:
        label = f"batch256[{way}]"
        res, cold, grid, single, trace = _batch_run(label, run)
        if way == "bucketed":
            GRID_CAPTURED.update(trace.first)
        res_w, warm, grid_w, single_w, _ = _batch_run(label, run,
                                                      counted=False)
        for r in (res, res_w):
            if way == "independent":
                check(r["valid"] is False and sorted(r["failures"])
                      == sorted(BATCH256_INVALID),
                      f"{label}: valid={r['valid']}, failures "
                      f"{sorted(r['failures'])}")
                per_key = [r["results"][k] for k in range(BATCH_KEYS)]
                _check_batch_results(label, per_key, BATCH256_INVALID)
            else:
                per_key = r
                _check_batch_results(label, per_key)
        check(grid > 0, f"{label}: the grid form never launched")
        blocks = [r["search_telemetry"] for r in per_key
                  if "search_telemetry" in r]
        # through independent.checker an invalid key's result is its
        # own check's, which replaces the batch result carrying the block
        check(blocks or way == "independent", f"{label}: no result "
              "carries the batch's search_telemetry")
        stats = (res[0].get("bucket_batch") or {}) if way == "bucketed" \
            else {}
        launches[label] = {"grid": grid, "single": single}
        rungs = sorted({s[0] for s in trace.slices})
        emit(f"main[{label}]: keys={BATCH_KEYS} routes="
             f"{_route_counts(per_key)} cold_s={cold:.3f} warm_s={warm:.3f} "
             f"grid_launches={grid} (warm {grid_w}) single_launches={single} "
             f"(warm {single_w}) rungs={rungs}; {trace.summary()}"
             + (f"; buckets={stats.get('n_buckets')} padding_efficiency="
                f"{stats.get('padding_efficiency')}" if stats else "")
             + f"; telemetry blocks={len(blocks)}: " + "; ".join(
                 _tele_totals({"search_telemetry": b}) for b in blocks))
    # one key alone through the single search, from the same tier: a
    # search with no overflow whose every level keeps its row
    res = lin.search_opseq(keys[0], model, device="cuda", hb=False,
                           dpor=False)
    emit(f"batch256 key 0 alone: valid={res['valid']} "
         f"configs={res['configs']} max_depth={res['max_depth']} "
         f"engine={res['engine']} telemetry: {_tele_totals(res)}")
    check((res["configs"], res["max_depth"]) == (BATCH256_CONFIGS[0],
                                                 BATCH256_DEPTH[0]),
          f"batch256 key 0 alone: {res['configs']} configs, depth "
          f"{res['max_depth']}")
    _check_telemetry("batch256 key 0 alone", res)
    return launches


def phase_batch256_decomposed(store_base):
    """The batch256 keys through ``search_batch(decompose=True)`` on the
    card with a verdict cache file, three runs: cold (every key a
    distinct shape, searched on the grid form, each verdict, configs and
    depth the JAX package's), warm on the same cache (256 hits, no
    launch), and a fresh cache on the same file (256 hits, no launch: the
    file persists).  The plain bucketed ``search_batch`` is timed beside
    them, uncounted."""
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.decompose import VerdictCache

    keys, model = batch_keys()
    path = os.path.join(store_base, "verdict_cache", "verdicts.jsonl")
    cache = VerdictCache(path)
    label = "batch256[decomposed]"

    def run(c):
        return lambda: lin.search_batch(keys, model, device="cuda",
                                        decompose=True, decompose_cache=c)

    _, plain, _, _, _ = _batch_run(label, lambda: lin.search_batch(
        keys, model, device="cuda"), counted=False)
    res, cold, grid, single, trace = _batch_run(label, run(cache))
    _check_batch_results(label, res)
    st = res[0]["decompose_batch"]
    check(st == BATCH256_DECOMP_COLD, f"{label} cold: {st}")
    check(st["searched"] + st["deduped"] + st["cache_hits"] == BATCH_KEYS,
          f"{label} cold: {st}")
    check(grid > 0, f"{label} cold: the grid form never launched")
    runs = []
    for what, c in (("warm", cache), ("reload", VerdictCache(path))):
        r, wall, g, s1, _ = _batch_run(label, run(c))
        check([x["valid"] for x in r] == [x["valid"] for x in res],
              f"{label} {what}: verdicts differ from the cold run")
        check(r[0]["decompose_batch"] == BATCH256_DECOMP_WARM,
              f"{label} {what}: {r[0]['decompose_batch']}")
        check(g == 0 and s1 == 0, f"{label} {what}: {g} grid and {s1} "
              "single-key launches, want none")
        check({x["engine"] for x in r} == {"decompose-cache"},
              f"{label} {what}: engines {sorted({x['engine'] for x in r})}")
        runs.append((what, wall, r[0]["decompose_batch"]["cache_hits"]))
    blocks = [r["search_telemetry"] for r in res if "search_telemetry" in r]
    emit(f"main[{label}]: keys={BATCH_KEYS} routes={_route_counts(res)} "
         f"cold_s={cold:.3f} " + " ".join(
             f"{w}_s={t:.3f} ({h} hits)" for w, t, h in runs)
         + f" plain_bucketed_s={plain:.3f}; cold stats {st}; "
         f"grid_launches={grid} single_launches={single} (warm and reload "
         f"0); file {os.path.getsize(path)} B; {trace.summary()}; "
         f"telemetry blocks={len(blocks)}")
    return {label: {"grid": grid, "single": single}}


def phase_multireg256(store_base):
    """BASELINE config 3's size as one multi-register history (256 keys,
    32,768 ops), with and without its corrupted keys, down both
    decomposed routes on the card: ``Linearizable(decompose=True,
    verdict_cache=...)`` (in-process cells, host engines; then again,
    one whole-history hit) and ``check_opseq_decomposed(...,
    scheduler="device")`` (every cell in one ``search_batch`` on the
    grid form).  Each is held to the JAX package's verdict and
    ``decompose`` dict."""
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.decompose import check_opseq_decomposed
    from jepsen_tpu_torch.history import encode_ops

    launches = {}
    for name, (want_valid, want) in MULTIREG256.items():
        history, model = multireg_history(corrupt=name == "multireg256")
        chk = lin.Linearizable(model, decompose=True, device="cuda",
                               verdict_cache=os.path.join(
                                   store_base, name, "verdicts.jsonl"))
        test = {"name": name, "store_base": store_base}
        label = f"{name}[in-process]"
        _zero_counts()
        t0 = time.perf_counter()
        out = chk.check(test, history)
        wall = time.perf_counter() - t0
        single, grid = _read_counts()
        launches[label] = {"grid": grid, "single": single}
        t0 = time.perf_counter()
        again = chk.check(test, history)
        warm = time.perf_counter() - t0
        check(out["valid"] is want_valid and out["decompose"] == want,
              f"{label}: valid={out['valid']} decompose {out['decompose']}, "
              f"the JAX package {want_valid} {want}")
        check(again["valid"] is want_valid
              and again["decompose"]["methods"] == ["cache"],
              f"{label} again: {again['valid']} {again['decompose']}")
        check(want_valid or out.get("report_file"),
              f"{label}: an invalid verdict without its report")
        emit(f"main[{label}]: ops={len(encode_ops(history, model.f_codes))} "
             f"valid={out['valid']} engine={out['engine']} wall_s={wall:.3f} "
             f"again_s={warm:.3f} (whole-history hit); decompose "
             f"{out['decompose']}; launches grid={grid} single={single}")
        if name not in MULTIREG256_DEVICE:
            continue
        want_valid, want = MULTIREG256_DEVICE[name]
        seq = encode_ops(history, model.f_codes)
        label = f"{name}[device]"
        with _GridTrace() as trace:
            _zero_counts()
            t0 = time.perf_counter()
            out = check_opseq_decomposed(seq, model, scheduler="device",
                                         device="cuda")
            wall = time.perf_counter() - t0
            single, grid = _read_counts()
        launches[label] = {"grid": grid, "single": single}
        got = dict(out["decompose"])
        got["cell_engines"] = sorted({e.replace("(cuda)", "")
                                      for e in got["cell_engines"]})
        check(out["valid"] is want_valid and got == want,
              f"{label}: valid={out['valid']} decompose {out['decompose']}, "
              f"the JAX package {want_valid} {want}")
        check(grid > 0 and "device-batch(cuda)"
              in out["decompose"]["cell_engines"],
              f"{label}: the grid form never launched ({grid} launches, "
              f"engines {out['decompose']['cell_engines']})")
        emit(f"main[{label}]: valid={out['valid']} wall_s={wall:.3f}; "
             f"decompose {out['decompose']}; launches grid={grid} "
             f"single={single}; {trace.summary()}")
    return launches


def phase_checkpoint(store_base):
    """The 1k tier's device search on the card, checkpointed after every
    slice by ``save_checkpoint`` from ``on_slice`` and stopped after the
    third; ``resume_opseq`` from the file must give :data:`REFERENCE`'s
    1k answer, engine ``device-bfs(cuda,resumed)``.  Launch count set to
    0 before the stopped search, read after the resumed one."""
    import threading

    from jepsen_tpu_torch.checker import level_kernel as lk
    from jepsen_tpu_torch.checker import linearizable as lin

    seq, model = tier_history("1k")
    budget = 20_000_000
    path = os.path.join(store_base, "1k-checkpoint.npz")
    stop = threading.Event()
    seen = []

    def on_slice(carry, dims):
        lin.save_checkpoint(path, carry, dims, model, budget, seq=seq)
        seen.append((dims.frontier, int(carry[4]), int(carry[3])))
        if len(seen) == 3:
            stop.set()

    _zero_counts()
    t0 = time.perf_counter()
    first = lin.search_opseq(seq, model, budget=budget, device="cuda",
                             on_slice=on_slice, stop=stop, hb=False,
                             dpor=False)
    t1 = time.perf_counter()
    launches_first = lk.LAUNCHES
    out = lin.resume_opseq(seq, model, path, device="cuda")
    t2 = time.perf_counter()
    launches, _ = _read_counts()
    emit(f"main[checkpoint] 1k: stopped after {len(seen)} slices "
         f"(frontier, depth, configs) {seen}: valid={first['valid']} "
         f"in {t1 - t0:.3f} s with {launches_first} launches; file "
         f"{os.path.getsize(path)} B; resumed: valid={out['valid']} "
         f"configs={out['configs']} max_depth={out['max_depth']} "
         f"engine={out['engine']} in {t2 - t1:.3f} s; launches={launches}; "
         f"telemetry stopped: {_tele_totals(first)}; resumed: "
         f"{_tele_totals(out)}")
    _check_telemetry("checkpoint 1k (stopped)", first)
    _check_telemetry("checkpoint 1k (resumed)", out)
    check(len(seen) == 3 and first["valid"] == "unknown",
          f"checkpoint: the search was not stopped after its third slice "
          f"({len(seen)} slices, valid={first['valid']})")
    _check_search("1k", "resume_opseq", out, REFERENCE["1k"])
    check(out["engine"] == "device-bfs(cuda,resumed)",
          f"checkpoint: engine {out['engine']}")
    check(launches > launches_first > 0,
          f"checkpoint: {launches_first} launches before the stop, "
          f"{launches} in all")
    return {"1k": launches}


#: CUDA events around this many back-to-back grid launches queued behind
#: a sleep kernel of _SLEEP_CYCLES (about 20 ms on an H100), so the card
#: runs them while the host enqueues: the device's time per launch
QUEUED_LAUNCHES = 30
_SLEEP_CYCLES = 40_000_000


def _grid_split(fn, reps=20) -> dict:
    """A grid launch ``fn()`` split: ``timed_ms``, CUDA events around one
    call on an idle card (the wrapper's host work counts; median of
    ``reps``); ``queued_ms``, the device's time per launch with the
    queue kept full; ``host_ms``, the host's time per call meanwhile;
    ``prof_ms``, the profiler's device time of the kernel itself per
    launch (None where the trace shows no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    ms = sorted(_timed(fn)[1] for _ in range(reps))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    slept = torch.cuda.Event()
    torch.cuda._sleep(_SLEEP_CYCLES)
    slept.record()
    start.record()
    t0 = time.perf_counter()
    for _ in range(QUEUED_LAUNCHES):
        fn()
    host = (time.perf_counter() - t0) / QUEUED_LAUNCHES * 1e3
    full = not slept.query()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        if "level_loop" in e.key and "kernel" in e.key:
            us += (getattr(e, "device_time_total", None)
                   or getattr(e, "cuda_time_total", 0) or 0)
            n += e.count
    return {"timed_ms": ms[len(ms) // 2], "timed_min_ms": ms[0],
            "timed_max_ms": ms[-1],
            "queued_ms": start.elapsed_time(end) / QUEUED_LAUNCHES,
            "host_ms": host, "full_queue": full,
            "prof_ms": us / n / 1e3 if n and us else None}


def _ladder_lanes(n: int) -> int:
    """Lanes the batch ladder stacks ``n`` keys in: a power of two from 4
    to 32, then a multiple of 32."""
    return max(4, 1 << (n - 1).bit_length()) if n <= 32 else -(-n // 32) * 32


def grid_first_rung(device):
    """(model, dims, args, carry, keys) of batch256's first rung: the
    keys the greedy witness leaves to the device, stacked at F=32 as the
    ladder stacks them."""
    from jepsen_tpu_torch.checker import linearizable as lin

    keys, model = batch_keys()
    run = [s for s in keys if not lin.greedy_witness(s, model)]
    dims, args, carry = grid_setup(model, run, 32, device,
                                   lanes=_ladder_lanes(len(run)))
    return model, dims, args, carry, len(run)


def grid_levels(model, dims, args, carry, lvl_cap, bail):
    """The levels each lane runs in one slice from ``carry`` (int64
    ``[B]`` on the CPU): the grid form one level at a time."""
    import torch

    from jepsen_tpu_torch.checker import level_kernel as lk

    c, levels = carry, torch.zeros(carry[0].shape[0], dtype=torch.int64)
    for _ in range(lvl_cap):
        busy = ((c[2] == -1) & (c[1] > 0) & (c[3] < 10**8)).cpu()
        if bail:
            busy &= ~c[5].cpu()
        if not bool(busy.any()):
            break
        levels += busy
        c = lk.level_loop_batch(model, dims, *args, 10**8, 1, bail, *c)
    return levels


def _grid_time(label, model, dims, args, carry, lvl_cap, bail, n_keys):
    """The grid form on one slice: :func:`_grid_split` off and on, the
    plain version once, the levels each key ran, and the bound (the
    larger of the real keys' tables and every lane's carry moved once
    and the operations of the configurations the slice visited)."""
    import torch

    from jepsen_tpu_torch.checker import level_kernel as lk

    call = (*args, 10**8, lvl_cap, bail, *carry)
    B = int(carry[0].shape[0])
    off = functools.partial(lk.level_loop_batch, model, dims, *call)
    on = functools.partial(off, telemetry=True)
    out = off()
    check(grid_diff(on()[:6], out) == 0,
          f"timing {label}: the telemetry form's carry != the off form's")
    split = {"off": _grid_split(off), "on": _grid_split(on)}
    ref, plain_ms = _timed(lk.level_loop_batch_reference, model, dims,
                           *call)
    err = grid_diff(out, ref)
    check(err == 0, f"timing {label}: kernel != plain (max abs err {err})")
    levels = grid_levels(model, dims, args, carry, lvl_cap, bail)
    ran = levels[levels > 0].double()
    # bytes the launch must move: the tables of the real keys (a pad
    # lane leaves before it reads one), every lane's carry read and
    # written once (a pad lane copies its own back)
    n_bytes = (sum(t[:n_keys].numel() * t.element_size() for t in args[:10])
               + 2 * (carry[0].numel() * 4 + 5 * 4 * B))
    configs = int((out[3] - carry[3]).sum())
    n_ops = configs * (dims.window + dims.n_crash_pad) * OPS_PER_LANE
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    plan = lk.launch_plan(dims, carry[0].device)
    sm = torch.cuda.get_device_properties(carry[0].device).multi_processor_count
    o, t = split["off"], split["on"]
    prof = "not shown" if o["prof_ms"] is None else f"{o['prof_ms']:.4f} ms"
    emit(f"timing {label} B={B} ({n_keys} keys, {ran.numel()} running) "
         f"F={dims.frontier} W={dims.window} NC={dims.n_crash_pad} "
         f"n_det_pad={dims.n_det_pad} lvl_cap={lvl_cap} bail={int(bail)} "
         f"threads={plan['threads']} smem={plan['smem_bytes']} B "
         f"tables={plan['tables']} blocks={B} "
         f"blocks/SM={plan['blocks_per_sm']} SMs used={min(B, sm)} of "
         f"{sm}: levels per running key max "
         f"{int(ran.max()) if ran.numel() else 0} mean "
         f"{float(ran.mean()) if ran.numel() else 0.0:.2f}, "
         f"configs={configs}; kernel {o['timed_ms']:.4f} ms/launch (min "
         f"{o['timed_min_ms']:.4f} max {o['timed_max_ms']:.4f}); "
         f"split: device {o['queued_ms']:.4f} ms/launch with the queue "
         f"full ({o['full_queue']}), wrapper host {o['host_ms']:.4f} "
         f"ms/call, profiler kernel {prof}; telemetry form "
         f"{t['timed_ms']:.4f} ms/launch (device {t['queued_ms']:.4f}, "
         f"host {t['host_ms']:.4f}); plain {plain_ms:.1f} ms; bound: bytes "
         f"{bytes_ms:.3e} ms ({n_bytes} B), operations {ops_ms:.3e} ms "
         f"({n_ops} int32 ops)")
    return {"shape": f"{label} B={B} F={dims.frontier}",
            "levels": int(ran.sum()),
            "ms": o["timed_ms"], "ms_tele": t["timed_ms"],
            "device_ms": o["queued_ms"], "host_ms": o["host_ms"],
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err}


def phase_grid_timing(device):
    """The grid form at batch256's first rung: the keys the greedy
    witness leaves to the device, stacked as the ladder stacks them
    (F=32, lanes rounded up by its rule), one slice of the ladder's
    first level cap with bail, split into the device's and the wrapper's
    time, against its plain version and, as a control, the same keys
    launched one by one through the single-key form.  Then the next rung
    batch256's bucketed run reached, from its first launch there.
    Returns the two shapes."""
    from jepsen_tpu_torch.checker import level_kernel as lk
    from jepsen_tpu_torch.checker import linearizable as lin

    model, dims, args, carry, n = grid_first_rung(device)
    lvl_cap, bail = lin._SLICE_LEVELS0, True
    first = _grid_time("batch256 grid", model, dims, args, carry, lvl_cap,
                       bail, n)
    # the control: each key alone through the single-key form
    singles = []
    for b in range(n):
        key_args = [t[b] for t in args[:15]]
        key_args[5] = key_args[5][:dims.n_det_pad + 1]
        singles.append((*key_args, int(args[15][b]), int(args[16][b]),
                        int(args[17][b]), int(args[18][b]), 10**8, lvl_cap,
                        bail, *(x[b] for x in carry)))

    def one_by_one():
        return [lk.level_loop(model, dims, *s) for s in singles]

    one_by_one()  # warm-up
    ms_s = sorted(_timed(one_by_one)[1] for _ in range(5))
    out = lk.level_loop_batch(model, dims, *args, 10**8, lvl_cap, bail,
                              *carry)
    for b, o in enumerate(one_by_one()):
        e = grid_diff(tuple(x[b:b + 1] for x in out),
                      tuple(x.reshape((1,) + x.shape) for x in o))
        check(e == 0, f"grid timing: key {b} alone != its grid lane")
    first["single_key_ms"] = ms_s[len(ms_s) // 2]
    emit(f"timing batch256 grid control: the same {n} keys one by one "
         f"through the single-key form {first['single_key_ms']:.4f} ms "
         f"({n} launches)")
    wider = sorted(f for f in GRID_CAPTURED if f > dims.frontier)
    check(wider, f"grid timing: batch256 ran no grid rung past "
          f"F={dims.frontier} (rungs {sorted(GRID_CAPTURED)})")
    m, d, a = GRID_CAPTURED[wider[0]]
    busy = int(((a[24] == -1) & (a[23] > 0)).sum())
    second = _grid_time(f"batch256 grid F={d.frontier}", m, d, a[:19],
                        a[22:], a[20], a[21], busy)
    return [first, second]


def phase_lockstep_captured(captured):
    """Kernel vs plain version from carries the 1k search reached at
    F=512 and F=2048 (the live row count printed as live_in)."""
    worst = 0
    for frontier in (512, 2048):
        model, dims, args, carry, src = _captured_at(captured, frontier)
        worst = max(worst, _lockstep_one(
            f"1k-F{frontier}-captured(from F={src})", model, dims, args,
            carry, False, 3, 8)[0])
    return worst


def _captured_at(captured, frontier):
    """(model, dims, args, carry, source width) at ``frontier`` for the
    1k tier: the captured carry with the most live rows at that rung,
    or, when the search never ran there, the widest-reaching one below
    it zero-padded up to it."""
    from jepsen_tpu_torch.checker.encode import SearchDims, _widen_carry

    cands = [(f, c) for f, c in captured["1k"].items() if f <= frontier]
    check(cands, f"1k: no carry captured at or below F={frontier}")
    src, (model, dims, args, carry) = max(
        cands, key=lambda fc: (fc[0] == frontier, int(fc[1][3][1])))
    if src != frontier:
        carry = _widen_carry(carry, src, frontier)
        dims = SearchDims(**{**dims.__dict__, "frontier": frontier})
    return model, dims, args, carry, src


def _levels_run(model, dims, args, carry, out, lvl_cap, bail):
    """Levels one slice ran: ``lvl_cap`` when its carry shows no reason
    to stop, else counted by stepping the plain version one level at a
    time from ``carry``."""
    from jepsen_tpu_torch.checker import level_kernel as lk

    def stopped(c):
        return (int(c[2]) != -1 or int(c[1]) == 0
                or (bail and bool(c[5])))

    if not stopped(out):
        return lvl_cap
    c, n = carry, 0
    while n < lvl_cap and not stopped(c):
        c = lk.level_loop_reference(model, dims, *args, 10**8, 1, bail, *c)
        n += 1
    return n


def _time_shape(label, model, dims, args, carry, lvl_cap, bail, reps=20,
                plain_reps=3):
    """Kernel (median of ``reps`` after a warm-up, CUDA events) and plain
    version (median of ``plain_reps``) on the same slice; the bound is
    the larger of the bytes the slice must move and the operations its
    data needs."""
    from jepsen_tpu_torch.checker import level_kernel as lk

    call = (*args, 10**8, lvl_cap, bail, *carry)
    out, _ = _timed(lk.level_loop, model, dims, *call)  # warm-up
    levels = _levels_run(model, dims, args, carry, out, lvl_cap, bail)
    ms_k = [_timed(lk.level_loop, model, dims, *call)[1]
            for _ in range(reps)]
    # then the telemetry form the same way
    tele = functools.partial(lk.level_loop, telemetry=True)
    on, _ = _timed(tele, model, dims, *call)  # warm-up
    check(_diff(on[:6], out) == 0,
          f"timing {label}: the telemetry form's carry != the off form's")
    ms_t = [_timed(tele, model, dims, *call)[1] for _ in range(reps)]
    ref, _ = _timed(lk.level_loop_reference, model, dims, *call)
    ms_r = [_timed(lk.level_loop_reference, model, dims, *call)[1]
            for _ in range(plain_reps)]
    err = _diff(out, ref)
    check(err == 0, f"timing {label}: kernel != plain (max abs err {err})")
    # bytes the slice must move: every table read once, the carry read
    # and written once
    n_bytes = (sum(t.numel() * t.element_size() for t in args[:10])
               + 2 * (carry[0].numel() * 4 + 5 * 4))
    # operations this run's data needs, at least: every live
    # configuration of every level tests each of its L candidate lanes
    # (window bit, two return compares, model step: >= 8 int32 ops)
    configs = int(out[3]) - int(carry[3])
    n_ops = configs * (dims.window + dims.n_crash_pad) * OPS_PER_LANE
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    ms = sorted(ms_k)[len(ms_k) // 2]
    ms_tele = sorted(ms_t)[len(ms_t) // 2]
    plain_ms = sorted(ms_r)[len(ms_r) // 2]
    plan = lk.launch_plan(dims, carry[0].device)
    emit(f"timing {label} F={dims.frontier} W={dims.window} "
          f"NC={dims.n_crash_pad} lvl_cap={lvl_cap} bail={int(bail)} "
          f"live_in={int(carry[1])} tables={plan['tables']}: "
          f"levels={levels} configs={configs} kernel {ms:.4f} ms/slice "
          f"({ms / max(1, levels) * 1e3:.2f} us/level, min {min(ms_k):.4f} "
          f"max {max(ms_k):.4f} over {reps}); telemetry form "
          f"{ms_tele:.4f} ms/slice (min {min(ms_t):.4f} max "
          f"{max(ms_t):.4f}, {ms_tele / ms - 1:+.2%}); plain "
          f"{plain_ms:.1f} ms/slice; bound: bytes {bytes_ms:.3e} ms "
          f"({n_bytes} B), operations {ops_ms:.3e} ms ({n_ops} int32 ops)")
    return {"shape": f"{label} F={dims.frontier}", "levels": levels,
            "ms": ms, "ms_tele": ms_tele, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err}


def phase_timing(device, captured):
    """Kernel and plain version on the same inputs at every shape the
    main path uses: mutex2k from the root in 256-level slices at F=64
    (the first port's shape), F=128 and F=256; 1k from the root at
    F=128 in a 32-level slice, and at F=512 and F=2048 from carries its
    search reached, 32-level slices without bail, so an overflowing
    level does not end the slice early."""
    seq, model = tier_history("mutex2k")
    shapes = []
    for frontier in (64, 128, 256):
        dims, args, carry = _setup(model, seq, frontier, device)
        shapes.append(_time_shape("mutex2k", model, dims, args, carry, 256,
                                  True))
    seq, model = tier_history("1k")
    dims, args, carry = _setup(model, seq, 128, device)
    shapes.append(_time_shape("1k", model, dims, args, carry, 32, True))
    for frontier in (512, 2048):
        model, dims, args, carry, src = _captured_at(captured, frontier)
        shapes.append(_time_shape(f"1k(from F={src})", model, dims, args,
                                  carry, 32, False))
    return shapes


def _traced_search(seq, model):
    """``search_opseq`` on the card with each slice timed: returns the
    result; per (route, width), [slices, depth advanced, configs added,
    seconds]; and per width, (model, dims, args, carry) of the slice
    that started with the most live rows (its input carry)."""
    import torch

    from jepsen_tpu_torch.checker import linearizable as lin

    rows: dict = {}
    captured: dict = {}
    get_kernel = lin.get_kernel

    def traced(model, dims, device, **reduction):
        fn = get_kernel(model, dims, device, **reduction)
        route = ("cuda" if lin._use_kernel(model, dims, device)
                 else "torch")

        def run(*a):
            live = int(a[23])
            if live > int(captured.get(dims.frontier, (0, 0, 0, (0, 0)))
                          [3][1]):
                carry = tuple(v.clone() for v in a[22:28])
                captured[dims.frontier] = (model, dims, a[:19], carry)
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            r = rows.setdefault((route, dims.frontier), [0, 0, 0, 0.0])
            r[0] += 1
            r[1] += int(out[4]) - int(a[26])
            r[2] += int(out[3]) - int(a[25])
            r[3] += time.perf_counter() - t0
            return out
        return run

    lin.get_kernel = traced
    try:
        return (lin.search_opseq(seq, model, device="cuda", hb=False,
                                 dpor=False), rows, captured)
    finally:
        lin.get_kernel = get_kernel


class _Spy:
    """Wraps functions of the port for one run: per name, the seconds
    spent in them, their calls and their last result."""

    def __init__(self, *targets):
        self.targets = targets  # (owner, attribute name) pairs
        self.seconds: dict = {}
        self.calls: dict = {}
        self.last: dict = {}
        self._saved: list = []

    def _wrap(self, name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            finally:
                self.seconds[name] = (self.seconds.get(name, 0.0)
                                      + time.perf_counter() - t0)
                self.calls[name] = self.calls.get(name, 0) + 1
            self.last[name] = out
            return out
        return run

    def __enter__(self):
        for owner, name in self.targets:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)


class _FirstDims:
    """Spies on ``linearizable._run_kernel`` for one run: ``started``
    holds the dims of each slice the device search launched, the first
    being those it started at."""

    def __enter__(self):
        from jepsen_tpu_torch.checker import linearizable as lin

        self.started: list = []
        self._run_kernel = run_kernel = lin._run_kernel

        def spy(esp, es, m, dims, *a, **k):
            self.started.append(dims)
            return run_kernel(esp, es, m, dims, *a, **k)

        lin._run_kernel = spy
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.checker import linearizable as lin

        lin._run_kernel = self._run_kernel
        return False


def _default_route(label, seq, model, store_base, *, algorithm="auto",
                   path="auto", counted=True, **flags):
    """One history through ``linearizable(model, device="cuda",
    **flags)`` with ``algorithm``, its stages timed; the kernel launch
    count is set to 0 just before and read just after.  ``path`` names
    the run in its ``main[...]`` line; ``counted`` says whether it is one
    of the counted main paths.  Returns (result, stats)."""
    from jepsen_tpu_torch.analyze import shrink
    from jepsen_tpu_torch.checker import level_kernel as lk
    from jepsen_tpu_torch.checker import linear_report
    from jepsen_tpu_torch.checker import linearizable as lin

    spy = _Spy((lin, "check_competition"), (lin, "search_opseq"),
               (lin.Linearizable, "_render_failure"),
               (shrink, "shrink_invalid"),
               (linear_report, "write_linear_html"))
    test = {"name": label, "store_base": store_base}
    with spy:
        _zero_counts()
        t0 = time.perf_counter()
        out = lin.linearizable(model, algorithm=algorithm, device="cuda",
                               **flags).check(test, seq)
        wall = time.perf_counter() - t0
        launches, _ = _read_counts(counted)
    sec = spy.seconds
    st = {"wall": wall, "launches": launches,
          "race_s": sec.get("check_competition", 0.0),
          "device_leg_s": sec.get("search_opseq"),
          "device_leg": spy.last.get("search_opseq"),
          "render_s": sec.get("_render_failure", 0.0),
          "shrink_s": sec.get("shrink_invalid"),
          "report_s": sec.get("write_linear_html")}
    # what the entry spent outside the search or race and the report:
    # the host confirmation of a device or WGL verdict
    st["confirm_s"] = wall - st["race_s"] - st["render_s"]
    if algorithm == "device":
        st["confirm_s"] -= st["device_leg_s"] or 0.0
    dev = st["device_leg"]
    sh = out.get("shrink")
    emit(f"main[{path}] {label}: ops={len(seq)} valid={out['valid']} "
         f"engine={out['engine']} configs={out.get('configs')} "
         f"device_configs={out.get('device_configs')} "
         f"wall_s={wall:.3f} race_s={st['race_s']:.3f} "
         f"device_leg_s="
         + ("skipped" if dev is None else f"{st['device_leg_s']:.3f}")
         + " device_leg="
         + ("-" if dev is None else
            f"{dev['engine']}:{dev['valid']}/{dev['configs']}/"
            f"{dev['max_depth']} ("
            f"{_us_per_level(st['device_leg_s'], dev)} us/level)"
            f" dpor={dev.get('dpor')}")
         + f" prepass={_prepass(out)}"
         + f" confirm_s={st['confirm_s']:.3f} render_s={st['render_s']:.3f}"
         f" shrink=" + ("-" if sh is None else
                        f"{sh['n_from']}->{sh['n_to']} in "
                        f"{st['shrink_s']:.3f} s ({sh['checks']} checks, "
                        f"minimal={sh['minimal']}, "
                        f"brute_force={sh['brute_force']})")
         + " report_s=" + ("-" if st["report_s"] is None
                           else f"{st['report_s']:.4f}")
         + f" report_file={out.get('report_file')} launches={launches}"
         + " telemetry=" + ("-" if dev is None else _tele_totals(dev)))
    if out["valid"] is False:
        report = out.get("report_file")
        if report is None:
            # as in the reference, a verdict the prepass decided is
            # confirmed on the failure prefix, and no report is written
            # when that prefix comes back valid
            check(_prepass_stats(out).get("decided") is False,
                  f"{label}: invalid verdict wrote no linear.html")
        else:
            check(os.path.isfile(report), f"{label}: {report} is missing")
            with open(report) as fh:
                check("Linearizability failure" in fh.read(),
                      f"{label}: {report} is not a failure report")
    if dev is not None and dev["engine"].startswith("device-bfs"):
        _check_telemetry(f"{label} ({path}) device leg", dev)
        # the kernel takes the search of a kernel model whose
        # reductions were dropped; the torch step all others
        red = dev.get("dpor") or {}
        kernel = (model.name in lk.SAFE_MODELS
                  and not red.get("device_masked") and not red.get("dedup"))
        check(("cuda" in dev["engine"]) == kernel,
              f"{label}: device leg's engine {dev['engine']}, want the "
              f"{'kernel' if kernel else 'torch step'}")
        check(launches > 0 or not kernel,
              f"{label}: the device leg ran and the kernel never launched")
    return out, st


def _prepass_stats(res) -> dict:
    return res.get("hb") or res.get("constraints") or {}


def _prepass(res) -> str:
    """The prepass's summary on a result: decided and why, or the
    must-order edges it handed the engines."""
    st = _prepass_stats(res)
    if not st:
        return "-"
    return (f"{st.get('solver', 'hb')}:applies={st.get('applies')},"
            f"decided={st.get('decided')},reason={st.get('reason')},"
            f"must_edges={st.get('must_edges')},"
            f"dup_edges={(st.get('dpor') or {}).get('dup_edges')}")


def _us_per_level(seconds, res) -> str:
    """Microseconds of wall per level the search reached."""
    return f"{seconds / max(1, res['max_depth']) * 1e6:.1f}"


def _check_search(name, what, res, want):
    check((res["valid"], res["configs"], res["max_depth"]) == want,
          f"{name}: {what} gave {res['valid']}, {res['configs']} configs, "
          f"depth {res['max_depth']}; the JAX package gives {want}")


def _check_race(name, out, st, want):
    """The race's verdict, and the device leg's where it finished."""
    dev = st["device_leg"]
    check(out["valid"] is False, f"{name}: verdict {out['valid']}, "
          "want False")
    check(dev is not None and st["launches"] > 0,
          f"{name}: the device leg never ran the kernel")
    if dev["valid"] != "unknown":
        _check_search(name, "the device leg", dev, want)
    if out["engine"].startswith("competition(device)"):
        check(out.get("device_configs") == want[1],
              f"{name}: device_configs {out.get('device_configs')}, "
              f"want {want[1]}")


def _check_reduced(name, out, st, path):
    """A tier through ``path`` with the defaults: mutex2k decided by the
    prepass with no search and no launch; 1k's device search on the
    kernel, its reductions dropped, with the unreduced counts."""
    dev = st["device_leg"]
    check(out["valid"] is False, f"{name}: {path} gave {out['valid']}")
    reason = PREPASS_REASON[name]
    stats = _prepass_stats(out)
    check(stats.get("applies") and stats.get("reason") == reason
          if reason else stats.get("decided") is None,
          f"{name}: {path}: prepass {_prepass(out)}, want {reason}")
    if reason:
        check(dev is not None and dev["engine"] == "constraint-decide"
              and dev["configs"] == 0 and st["launches"] == 0,
              f"{name}: {path}: the device leg searched a decided "
              f"history ({dev and dev['engine']}, {st['launches']} "
              "launches)")
        return
    if dev is not None and dev["valid"] != "unknown":
        _check_search(name, f"the device search ({path})", dev,
                      REFERENCE[name])
        check(dev["dpor"]["device_masked"] is False,
              f"{name}: {path}: the kernel's search kept its mask")


def phase_main_path(store_base):
    """Both tiers down the three counted main paths on the card, each
    run with the launch count set to 0 just before it and read just
    after: the default entry point with its defaults (the lint, the
    prepass and DPOR; the competition race, then the host confirmation
    of a device or WGL win), ``algorithm="device"`` with the defaults,
    and ``algorithm="device"`` with the prepass and DPOR off (held to
    :data:`REFERENCE`).  Around them, not counted and with the prepass
    and DPOR off: the device search alone before the race, the tier's
    first search in the process (cold); the race again with the
    interpreter's switch interval cut to :data:`CONTROL_SWITCH_S`, a
    control for the device leg's wait on the GIL; and the device search
    alone after them (warm) with its per-rung trace, which must have run
    every slice on the kernel.  Returns the launches by path, the
    frontiers captured for the lockstep, and each tier's
    ``algorithm="device"`` result with the dims its search started at
    (:func:`phase_analyze_cli` reads 1k's)."""
    from jepsen_tpu_torch.checker import linearizable as lin

    off = {"hb": False, "dpor": False}
    launches = {"auto": {}, "device": {}, "device,off": {}}
    captured, checked = {}, {}
    for name, _, _ in TIERS:
        seq, model = tier_history(name)
        want = REFERENCE[name]
        t0 = time.perf_counter()
        cold = lin.search_opseq(seq, model, device="cuda", **off)
        cold_s = time.perf_counter() - t0
        _check_search(name, "the device search (cold)", cold, want)
        _check_telemetry(f"{name} (cold)", cold)

        out, st = _default_route(name, seq, model, store_base)
        launches["auto"][name] = st["launches"]
        _check_reduced(name, out, st, "the default route")

        interval = sys.getswitchinterval()
        sys.setswitchinterval(CONTROL_SWITCH_S)
        try:
            out_c, st_c = _default_route(
                name, seq, model, store_base,
                path=f"auto,off,switch={CONTROL_SWITCH_S * 1e3:g}ms",
                counted=False, **off)
        finally:
            sys.setswitchinterval(interval)
        _check_race(name, out_c, st_c, want)

        with _FirstDims() as spy:
            out, st_d = _default_route(name, seq, model, store_base,
                                       algorithm="device", path="device")
        checked[name] = (out, spy.started[:1])
        launches["device"][name] = st_d["launches"]
        _check_reduced(name, out, st_d, "algorithm='device'")
        if PREPASS_REASON[name] is None:
            check(st_d["launches"] > 0 and out.get("device_configs")
                  == want[1], f"{name}: algorithm='device' launched "
                  f"{st_d['launches']} times, device_configs "
                  f"{out.get('device_configs')}, want {want[1]}")

        out, st_o = _default_route(name, seq, model, store_base,
                                   algorithm="device", path="device,off",
                                   **off)
        launches["device,off"][name] = st_o["launches"]
        check(out["valid"] is False, f"{name}: algorithm='device' gave "
              f"{out['valid']}, want False")
        check(out["engine"] == "device-bfs(cuda)+host-witness",
              f"{name}: algorithm='device' engine {out['engine']}, want "
              "the host-confirmed device verdict")
        check(out.get("device_configs") == want[1],
              f"{name}: device_configs {out.get('device_configs')}, "
              f"want {want[1]}")
        check(st_o["launches"] > 0,
              f"{name}: algorithm='device' never launched the kernel")
        _check_search(name, "the device search", st_o["device_leg"], want)

        t0 = time.perf_counter()
        dev, slices, captured[name] = _traced_search(seq, model)
        wall = time.perf_counter() - t0
        emit(f"search {name}: valid={dev['valid']} "
             f"configs={dev['configs']} max_depth={dev['max_depth']} "
             f"engine={dev['engine']} frontier={dev['frontier']} "
             f"window={dev['window']} wall_s={wall:.3f} "
             f"({_us_per_level(wall, dev)} us/level); cold, before the "
             f"race: {cold_s:.3f} s ({_us_per_level(cold_s, cold)} "
             f"us/level)")
        emit(f"slices {name}: " + "; ".join(
            f"{route} F={f}: {n} slices, depth +{d}, configs +{c}, "
            f"{t:.3f} s" for (route, f), (n, d, c, t) in slices.items()))
        _check_search(name, "the device search (warm)", dev, want)
        _check_telemetry(f"{name} (warm)", dev)
        emit(f"telemetry {name}: {_tele_totals(dev)}")
        torch_rungs = sorted(f for route, f in slices if route != "cuda")
        check(not torch_rungs,
              f"{name}: slices at F={torch_rungs} ran the torch step")
        check("cuda" in dev["engine"],
              f"{name}: engine label lacks the cuda tag")
    return launches, captured, checked


def phase_masked_control():
    """1k's device search with the defaults and the kernel kept out
    (``linearizable._use_kernel`` patched): the masked, deduplicated
    torch step on the card must give :data:`REFERENCE_REDUCED`, the
    reference's CPU answer."""
    from jepsen_tpu_torch.checker import level_kernel as lk
    from jepsen_tpu_torch.checker import linearizable as lin

    seq, model = tier_history("1k")
    use_kernel = lin._use_kernel
    lin._use_kernel = lambda *a, **kw: False
    try:
        lk.LAUNCHES = 0
        t0 = time.perf_counter()
        out = lin.search_opseq(seq, model, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        lin._use_kernel = use_kernel
    emit(f"control 1k[masked torch step]: valid={out['valid']} "
         f"configs={out['configs']} max_depth={out['max_depth']} "
         f"engine={out['engine']} frontier={out['frontier']} "
         f"dpor={out['dpor']} wall_s={wall:.3f} "
         f"({_us_per_level(wall, out)} us/level) launches={lk.LAUNCHES} "
         f"telemetry: {_tele_totals(out)}")
    _check_telemetry("control 1k", out)
    check(out["search_telemetry"]["mask_killed"] > 0,
          f"control 1k: the masked step's block shows no mask kills: "
          f"{_tele_totals(out)}")
    _check_search("1k", "the masked torch step", out,
                  REFERENCE_REDUCED["1k"])
    check(out["dpor"]["device_masked"] and out["dpor"]["dedup"]
          and out["engine"] == "device-bfs" and lk.LAUNCHES == 0,
          "1k: the control did not run the masked torch step")


def phase_default_route(store_base):
    """The default entry point on histories beyond the tiers, each with
    its expected verdict; past the device encoding the host legs must
    decide alone."""
    for label, seq, model, want in extra_histories():
        out, st = _default_route(label, seq, model, store_base,
                                 counted=False)
        check(out["valid"] is want,
              f"{label}: verdict {out['valid']}, want {want}")
        if label == "past-encoding":
            check("+device-skipped(encoding limits)" in out["engine"]
                  and st["device_leg"] is None,
                  f"{label}: engine {out['engine']}, want the host legs "
                  "alone")


def phase_queues(store_base):
    """The queue histories through the default entry point: the
    reference's verdict each; the one the prepass leaves undecided has
    its device leg run the torch step at state width 16."""
    launches = {}
    for name, fifo, want in QUEUES:
        seq, model = queue_history(name, fifo=fifo)
        out, st = _default_route(name, seq, model, store_base)
        launches[name] = st["launches"]
        check(out["valid"] is want,
              f"{name}: verdict {out['valid']}, want {want}")
        dev = st["device_leg"]
        if _prepass_stats(out).get("decided") is None:
            check(dev is not None and dev["engine"] == "device-bfs"
                  and dev["configs"] > 0 and model.state_width == 16,
                  f"{name}: no device leg ran the torch step "
                  f"({dev and dev['engine']})")
    return launches


def phase_traced(store_base):
    """One more pass of 1k's default route and ``algorithm="device"``
    path and of batch256's bucketed ``search_batch``, with tracing on:
    per path, its wall split by span (``bucket.prep``, ``bucket.device``,
    ``device.slice``, ``device.transfer`` and the rest), its device
    share (the ``device.slice`` seconds over the wall), and after them
    the process's ``device_idle_fraction``.  Not counted."""
    from jepsen_tpu_torch import obs
    from jepsen_tpu_torch.checker import linearizable as lin

    seq, model = tier_history("1k")
    keys, bmodel = batch_keys()
    test = {"name": "traced", "store_base": store_base}
    paths = (
        ("1k[auto]", lambda: lin.linearizable(
            model, device="cuda").check(test, seq)),
        ("1k[device]", lambda: lin.linearizable(
            model, algorithm="device", device="cuda").check(test, seq)),
        ("batch256[bucketed]", lambda: lin.search_batch(
            keys, bmodel, device="cuda")))
    shares = {}
    obs.enable(True)
    try:
        for label, run in paths:
            obs.set_run(label)
            try:
                t0 = time.perf_counter()
                run()
                wall = time.perf_counter() - t0
            finally:
                obs.set_run(None)
            spans = obs.recorder(label).spans()
            obs.drop_recorder(label)
            by = collections.defaultdict(lambda: [0, 0.0])
            for sp in spans:
                by[sp["name"]][0] += 1
                by[sp["name"]][1] += sp["dur"] / 1e6
            xfer = sum(sp["args"].get("bytes", 0) for sp in spans
                       if sp["name"] == "device.transfer")
            check(by["device.slice"][0] > 0,
                  f"traced {label}: no device.slice span")
            shares[label] = by["device.slice"][1] / wall
            named = ("bucket.prep", "bucket.device", "device.slice",
                     "device.transfer")
            emit(f"spans {label}: wall_s={wall:.4f} " + " ".join(
                f"{n}={by[n][0]}/{by[n][1]:.4f}s" for n in named)
                + f" transfer_bytes={xfer} device_share="
                f"{shares[label]:.4f}; other spans (count/seconds): "
                + " ".join(f"{n}={c}/{t:.4f}s" for n, (c, t)
                           in sorted(by.items()) if n not in named))
    finally:
        obs.enable(False)
    idle = obs.metrics.derived_stats(obs.REGISTRY)["device_idle_fraction"]
    emit(f"device idle fraction of this process so far: {idle}")
    return shares


# ---------------------------------------------------------------------------
# the streaming checker on the card
# ---------------------------------------------------------------------------

#: the full-width stream: 24 clients with 20 ops in flight, bursts of 32
#: ops, 5 values, cas; depth cut to 320 ops.  Every segment's window
#: fits the kernel's 64-lane masks (bursts of 256 give windows up to
#: 102, which no kernel rung takes, and cost 18 to 84 s per fold on the
#: card's torch step; PERF.md §6)
STREAM = dict(n_ops=320, n_procs=24, overlap=20, quiesce_every=32,
              n_values=5, cas=True)
STREAM_SEED = "bench-stream-0"

#: every closed segment to the device (at 24 clients the default gate
#: leaves most to the host sweep, seconds to minutes each), with a
#: budget that decides every variant (at the default 2,000,000 configs
#: the widest variants stay undecided and their folds go to the host)
STREAM_KW = dict(host_fold_max=0, device_budget=50_000_000)


def stream_history(*, corrupt: bool = False, seed: str = STREAM_SEED):
    """(events, model, violating event or None): the full-width
    cas-register stream, a read corrupted 10% in with ``corrupt``, then
    one trailing sequential write by process 0 (a write always
    linearizes; its invoke closes the last burst)."""
    from jepsen_tpu_torch.history import invoke_op, ok_op
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.synth import corrupt_read, register_history

    rng = random.Random(seed)
    h = register_history(rng, **STREAM)
    bad = None
    if corrupt:
        h2 = corrupt_read(rng, h, at=0.1)
        bad = next(i for i, (a, b) in enumerate(zip(h, h2)) if a is not b)
        h = h2
    return h + [invoke_op(0, "write", 0), ok_op(0, "write", 0)], \
        cas_register(), bad


#: the share of stream24's events ``stream[default]`` runs: its first
#: closed segments, all under the default gate's cost cap, so every one
#: folds on the host sweep (the whole stream there is about 3 minutes of
#: host sweeps).  The gate's device route is driven past the prefix: by
#: the fold of stream24's one gated segment alone, and inside the stream
#: checker by ``stream[gate]``
STREAM_DEFAULT_SHARE = 1 / 3

#: ``stream[gate]``'s burst, all open at once after a sequential write
#: of 0: a cas chain 0 -> 1 -> ... -> ``n_cas``, then ``n_writes``
#: writes of 100 on and ``n_reads`` reads of the last one (20 rows,
#: window 20: past the default gate's cost cap).  Its host sweep is a
#: fraction of a second; its device fold's variants search about 4,000
#: configs each, so at :data:`STREAM_GATE_BUDGET` the fold is undecided
#: and the stream checker sweeps the segment on the host instead
STREAM_GATE = dict(n_cas=10, n_writes=6, n_reads=4)
STREAM_GATE_BUDGET = 1_000


def stream_prefix(h, model):
    """The stream's closed segments that start within its first
    :data:`STREAM_DEFAULT_SHARE` of events, cut where the next one
    starts (no op is open there), then the trailing sequential write of
    :func:`stream_history`."""
    from jepsen_tpu_torch.decompose.partition import quiescence_segments
    from jepsen_tpu_torch.history import encode_ops

    seq = encode_ops(h, model.f_codes)
    starts = [int(seq.inv[s[0]]) for s in quiescence_segments(seq)]
    cut = max(s for s in starts if s <= len(h) * STREAM_DEFAULT_SHARE)
    return h[:cut] + h[-2:]


def stream_gate_history():
    """(events, model): :data:`STREAM_GATE`'s burst between two
    sequential writes of 0 (the second closes the burst's segment)."""
    from jepsen_tpu_torch.history import invoke_op, ok_op
    from jepsen_tpu_torch.models import cas_register

    g = STREAM_GATE
    ops = [(p, "cas", [p, p + 1]) for p in range(g["n_cas"])]
    ops += [(g["n_cas"] + i, "write", 100 + i) for i in range(g["n_writes"])]
    last = 100 + g["n_writes"] - 1
    ops += [(g["n_cas"] + g["n_writes"] + i, "read", None)
            for i in range(g["n_reads"])]
    h = [invoke_op(0, "write", 0), ok_op(0, "write", 0)]
    h += [invoke_op(p, f, v) for p, f, v in ops]
    h += [ok_op(p, f, last if f == "read" else v) for p, f, v in ops]
    return h + [invoke_op(0, "write", 0), ok_op(0, "write", 0)], \
        cas_register()


class _FoldTrace:
    """Wraps ``stream.device.device_fold_states`` for one run: per
    device fold, its segment and in-states, the states out, the
    variants, the configs, and its wall on the card.  Also wraps
    ``decompose.engine.segment_states``: the wall of each host sweep,
    and its rows and the states it reached."""

    def __init__(self):
        self.folds: list = []
        self.host: list = []
        self.host_out: list = []

    def __enter__(self):
        import torch

        from jepsen_tpu_torch.decompose import engine
        from jepsen_tpu_torch.models import R_CAS, R_WRITE
        from jepsen_tpu_torch.stream import device as sd

        self._saved = fold = sd.device_fold_states
        self._saved_host = host = engine.segment_states

        def host_traced(sseq, *a, **kw):
            t0 = time.perf_counter()
            try:
                out = host(sseq, *a, **kw)
            finally:
                self.host.append(time.perf_counter() - t0)
            # with witness=True: (states, witnesses)
            self.host_out.append((len(sseq), out[0] if isinstance(
                out, tuple) else out))
            return out

        def traced(sseq, model, in_states, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fold(sseq, model, in_states, **kw)
            torch.cuda.synchronize()
            # the variants: every in-state with every written value
            outs = {v2 if f == R_CAS else v1 for f, v1, v2 in zip(
                sseq.f.tolist(), sseq.v1.tolist(), sseq.v2.tolist())
                if f in (R_CAS, R_WRITE)}
            self.folds.append({
                "sseq": sseq, "in": set(in_states),
                "out": None if out is None else out[0],
                "configs": None if out is None else out[1],
                "variants": len({s[0] for s in in_states}) * len(outs),
                "s": time.perf_counter() - t0})
            return out

        sd.device_fold_states = traced
        engine.segment_states = host_traced
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.decompose import engine
        from jepsen_tpu_torch.stream import device as sd

        sd.device_fold_states = self._saved
        engine.segment_states = self._saved_host


def _stream_run(label, h, model, *, forced=True, **kw):
    """One counted stream on the card, op by op, with :data:`STREAM_KW`
    unless not ``forced``: (result, timeline, grid launches, single-key
    launches, fold trace, grid trace)."""
    import torch

    from jepsen_tpu_torch.stream import StreamChecker

    with _FoldTrace() as folds, _GridTrace() as grid_trace:
        _zero_counts()
        sc = StreamChecker(model, device="cuda",
                           **(STREAM_KW if forced else {}), **kw)
        t0 = time.perf_counter()
        tl = {"first_verdict": None, "first_invalid": None}
        for i, op in enumerate(h):
            sc.ingest(op)
            if tl["first_invalid"] is None:
                st = sc.verdict()["status"]
                if tl["first_verdict"] is None and st != "open":
                    tl["first_verdict"] = (i, time.perf_counter() - t0)
                if st == "invalid":
                    tl["first_invalid"] = (i, time.perf_counter() - t0)
        tl["ingest_s"] = time.perf_counter() - t0
        res = sc.finalize()
        torch.cuda.synchronize()
        tl["finalize_s"] = time.perf_counter() - t0 - tl["ingest_s"]
        single, grid = _read_counts()
    check(grid == sum(1 for s in grid_trace.slices if s[3] == "cuda"),
          f"{label}: {grid} grid launches, {grid_trace.slices} slices")
    return res, tl, grid, single, folds, grid_trace


def _fold_summary(folds, grid_trace) -> str:
    dev = [f for f in folds.folds if f["out"] is not None]
    n = max(1, len(dev))
    keys = [s[2] for s in grid_trace.slices if s[3] == "cuda"]
    return (f"device folds={len(dev)} (declined {len(folds.folds) - len(dev)})"
            f" variants/fold={sum(f['variants'] for f in dev) / n:.1f} "
            f"configs/fold={sum(f['configs'] for f in dev) / n:.1f} "
            f"fold_s mean={sum(f['s'] for f in dev) / n:.4f} max="
            f"{max([f['s'] for f in dev] or [0]):.4f}; grid keys/launch="
            f"{sum(keys) / max(1, len(keys)):.2f}; {grid_trace.summary()}")


def _segment_end(h, model, event):
    """The event at which the closed segment holding ``event`` is cut:
    the invoke of the first row of the next quiescence segment."""
    from jepsen_tpu_torch.decompose.partition import quiescence_segments
    from jepsen_tpu_torch.history import encode_ops

    seq = encode_ops(h, model.f_codes)
    starts = [int(seq.inv[s[0]]) for s in quiescence_segments(seq)]
    return min((s for s in starts if s > event), default=len(h) - 1)


def phase_stream(store_base):
    """The streaming checker on the card at full width (:data:`STREAM`,
    :data:`STREAM_KW`):
    ``stream[valid]`` (every closed segment folded on the device, the
    grid form launched, valid; on a cache file, the cold run of
    ``stream[cache]``), ``stream[default]`` (the stream's closed segments
    of its first third at the default gate and budget, :func:`stream_prefix`:
    its routes and walls; then the one segment the gate sends to the
    device, folded alone at the default budget: undecided, never
    wrong), ``stream[gate]`` (the default gate's device route inside the
    checker: a gated burst undecided at :data:`STREAM_GATE_BUDGET`, then
    swept on the host to the states a deciding fold reaches),
    ``stream[corrupt]`` (invalid inside the
    violating segment, before the stream's end), ``stream[plain]`` (the
    first two device folds and the one that empties, again on the
    card's torch step: the same state sets), ``stream[async]`` (async
    folds of the stream's first third, :func:`stream_prefix`, against
    inline folds of it: the same final result),
    ``stream[cache]`` (``stream[valid]`` again from a fresh cache on its
    file: every segment a hit, no launch), ``stream[service]`` (two streams
    with the same content, a stream's closed segments of its first third,
    :func:`stream_prefix`, through one service on one cache) and the
    stream bench tier (host folds, ``parity``)."""
    import torch

    from jepsen_tpu_torch.analyze.plan import segment_fold_route
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.decompose import VerdictCache
    from jepsen_tpu_torch.history import max_concurrency
    from jepsen_tpu_torch.stream import device as sd
    from jepsen_tpu_torch.stream.bench import run_stream_tier
    from jepsen_tpu_torch.stream.service import StreamService, serve_lines

    launches = {}
    h, model, _ = stream_history()
    path = os.path.join(store_base, "stream_cache", "verdicts.jsonl")
    res, tl, grid, single, folds, gtrace = _stream_run(
        "stream[valid]", h, model, cache=VerdictCache(path))
    st = res["stream"]
    launches["stream[valid]"] = {"grid": grid, "single": single}
    fv = tl["first_verdict"]
    emit(f"stream[valid]: events={len(h)} valid={res['valid']} "
         f"engine={res['engine']} first_verdict_event={fv[0]} at "
         f"{fv[1]:.4f} s; ingest_s={tl['ingest_s']:.3f} "
         f"({len(h) / tl['ingest_s']:.1f} events/s) finalize_s="
         f"{tl['finalize_s']:.4f}; segments={st['segments']} routes="
         f"{st['routes']} fallback={st['fallback']} configs={res['configs']}"
         f"; launches grid={grid} single={single}; "
         f"{_fold_summary(folds, gtrace)}; cache hits/misses/inserts="
         f"{st['cache_hits']}/{st['cache_misses']}/{st['cache_inserts']}")
    check(res["valid"] is True, f"stream[valid]: valid={res['valid']}")
    check(st["routes"]["host"] == 0 and st["routes"]["device"] > 0
          and not st["fallback"], f"stream[valid]: routes {st['routes']}, "
          f"fallback {st['fallback']}")
    check(grid > 0, "stream[valid]: the grid form never launched")
    valid_folds = [f for f in folds.folds if f["out"] is not None]

    # what a user who sets nothing gets on this stream: the default gate
    # (most segments to the host sweep) and budget (the widest variants
    # undecided, their folds to the host); no time is asked of it, so it
    # runs the stream's first closed segments only (stream_prefix), and
    # the gate's device route below
    hd = stream_prefix(h, model)
    resd, tld, grid_d, single_d, folds_d, gtrace_d = _stream_run(
        "stream[default]", hd, model, forced=False)
    std = resd["stream"]
    undecided = [f for f in folds_d.folds if f["out"] is None]
    emit(f"stream[default]: events={len(hd)} of {len(h)} "
         f"valid={resd['valid']} engine={resd['engine']} "
         f"ingest_s={tld['ingest_s']:.3f} finalize_s="
         f"{tld['finalize_s']:.4f}; segments={std['segments']} routes="
         f"{std['routes']} fallback={std['fallback']} configs="
         f"{resd['configs']}; device folds tried={len(folds_d.folds)} "
         f"undecided={len(undecided)} (s {[round(f['s'], 4) for f in undecided]}"
         f"); host sweeps={len(folds_d.host)} s total="
         f"{sum(folds_d.host):.4f} max={max(folds_d.host or [0]):.4f}; "
         f"launches grid={grid_d} single={single_d}")
    check(resd["valid"] is True, f"stream[default]: valid={resd['valid']}")
    check(std["routes"]["device"] == 0 and not std["fallback"]
          and not folds_d.folds, f"stream[default]: routes "
          f"{std['routes']}, {len(folds_d.folds)} device folds tried: "
          f"the prefix lies under the gate's cost cap")
    # the gate's device route lies past the prefix: stream24's one
    # segment over the gate's cost cap is its 9th (events 512 on, 29
    # rows, 19 open at once), whose fold at the default budget is
    # undecided and whose host sweep then takes about 94 s; its fold
    # runs here alone, at the default budget, from the in-states
    # stream[valid] folded it from, and is held to the states
    # stream[valid] folded there at its budget
    gated = [f for f in valid_folds if segment_fold_route(
        len(f["sseq"]), max_concurrency(f["sseq"]), model) == "device"]
    check(gated, "stream[default]: the gate routes no segment of the "
          "stream to the device")
    _zero_counts()
    undecided = []
    for f in gated:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sd.device_fold_states(f["sseq"], model, f["in"],
                                    device="cuda")
        torch.cuda.synchronize()
        first = int(f["sseq"].inv[0])
        undecided.append((first, len(f["sseq"]), out is None,
                          round(time.perf_counter() - t0, 4)))
        check(out is None or out[0] == f["out"],
              f"stream[default] gate: the fold from event {first} at the "
              f"default budget gives {out and sorted(out[0])}, "
              f"stream[valid] {sorted(f['out'])}")
        check(out is None, f"stream[default] gate: the fold from event "
              f"{first} is decided at the default budget ("
              f"{out and out[1]} configs): stream[gate] no longer stands "
              f"for it")
    single_g, grid_g = _read_counts()
    launches["stream[default]"] = {"grid": grid_d + grid_g,
                                   "single": single_d + single_g}
    emit(f"stream[default] gate: segments past the cap (first event, rows, "
         f"undecided at the default budget, s) {undecided}; launches "
         f"grid={grid_g} single={single_g}")

    # the same route inside the stream checker, at the default gate: a
    # gated burst whose fold is undecided at STREAM_GATE_BUDGET and whose
    # host sweep is cheap, so the checker sweeps it on the host; the
    # states that sweep reaches are the device fold's at a budget that
    # decides it
    hg, _m = stream_gate_history()
    resg, tlg, grid_q, single_q, folds_g, _gt = _stream_run(
        "stream[gate]", hg, model, forced=False,
        device_budget=STREAM_GATE_BUDGET)
    stg = resg["stream"]
    launches["stream[gate]"] = {"grid": grid_q, "single": single_q}
    tried = folds_g.folds
    check(len(tried) == 1 and tried[0]["out"] is None,
          f"stream[gate]: device folds tried {len(tried)}, out "
          f"{[f['out'] for f in tried]}: the burst's fold is not undecided")
    check(grid_q + single_q > 0, "stream[gate]: the burst's fold launched "
          "no kernel")
    swept = [st for n, st in folds_g.host_out if n == len(tried[0]["sseq"])]
    decided = sd.device_fold_states(tried[0]["sseq"], model, tried[0]["in"],
                                    budget=STREAM_KW["device_budget"],
                                    device="cuda")
    emit(f"stream[gate]: events={len(hg)} valid={resg['valid']} "
         f"engine={resg['engine']} ingest_s={tlg['ingest_s']:.3f} "
         f"finalize_s={tlg['finalize_s']:.4f}; segments={stg['segments']} "
         f"routes={stg['routes']} fallback={stg['fallback']}; the burst "
         f"({len(tried[0]['sseq'])} rows, window "
         f"{max_concurrency(tried[0]['sseq'])}) tried on the device: "
         f"undecided in {tried[0]['s']:.4f} s at {STREAM_GATE_BUDGET} "
         f"configs, then host swept to {swept and sorted(swept[0])} in "
         f"{max(folds_g.host or [0]):.4f} s; decided at "
         f"{STREAM_KW['device_budget']} configs: "
         f"{decided and (sorted(decided[0]), decided[1])}; launches "
         f"grid={grid_q} single={single_q}")
    check(resg["valid"] is True and not stg["fallback"]
          and stg["routes"]["host"] >= 1,
          f"stream[gate]: valid={resg['valid']} routes {stg['routes']} "
          f"fallback {stg['fallback']}")
    check(len(swept) == 1 and decided is not None
          and swept[0] == decided[0] and len(swept[0]) == STREAM_GATE[
              "n_writes"], f"stream[gate]: the host sweep reached "
          f"{swept}, the decided device fold {decided}")

    hc, _m, bad = stream_history(corrupt=True)
    resc, tlc, grid_c, single_c, folds_c, gtrace_c = _stream_run(
        "stream[corrupt]", hc, model)
    stc = resc["stream"]
    launches["stream[corrupt]"] = {"grid": grid_c, "single": single_c}
    inv = stc["invalid_event"]
    end = _segment_end(hc, model, bad)
    at = tlc["first_invalid"]
    emit(f"stream[corrupt]: events={len(hc)} valid={resc['valid']} "
         f"violating_event={bad} invalid_event={inv} (segment cut at "
         f"{end}) event_delta={None if inv is None else inv - bad} "
         f"wall_to_invalid_s={at[1] if at else None} headroom_events="
         f"{None if inv is None else len(hc) - 1 - inv}; routes="
         f"{stc['routes']} fallback={stc['fallback']}; launches grid="
         f"{grid_c} single={single_c}; {_fold_summary(folds_c, gtrace_c)}")
    check(resc["valid"] is False, f"stream[corrupt]: valid={resc['valid']}")
    check(inv is not None and bad <= inv <= end and inv < len(hc) - 1,
          f"stream[corrupt]: invalid_event {inv}, violating event {bad}, "
          f"its segment cut at {end}")
    # a fold the prepass decides (0 configs) launches nothing
    searched = [f for f in folds_c.folds if f["configs"]]
    check(stc["routes"]["host"] == 0 and not stc["fallback"]
          and (grid_c > 0 or not searched), f"stream[corrupt]: routes "
          f"{stc['routes']}, {grid_c} grid launches for {len(searched)} "
          f"searched folds")

    # the control: the same folds on the card's torch step
    empty = [f for f in folds_c.folds if f["out"] == set()]
    check(empty, "stream[corrupt]: no device fold emptied")
    saved = lin._use_kernel
    lin._use_kernel = lambda *a, **k: False
    try:
        for name, f in ([(f"valid#{i}", f) for i, f in
                         enumerate(valid_folds[:2])]
                        + [("corrupt#empty", empty[0])]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sd.device_fold_states(f["sseq"], model, f["in"],
                                        device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            emit(f"stream[plain] {name}: rows={len(f['sseq'])} "
                 f"in={sorted(f['in'])} kernel_states={sorted(f['out'])} "
                 f"plain_states={None if out is None else sorted(out[0])} "
                 f"kernel_s={f['s']:.4f} plain_s={wall:.4f}")
            check(out is not None and out[0] == f["out"],
                  f"stream[plain] {name}: torch step {out}, kernel "
                  f"{f['out']}")
    finally:
        lin._use_kernel = saved

    # async folds: the same final result as inline folds, on the stream's
    # first third (the comparison at a third of the folds)
    resi, tli, grid_i, single_i, _f, _g = _stream_run(
        "stream[async] inline", hd, model)
    launches["stream[async] inline"] = {"grid": grid_i, "single": single_i}
    resa, tla, grid_a, single_a, _f, _g = _stream_run(
        "stream[async]", hd, model, async_folds=True)
    launches["stream[async]"] = {"grid": grid_a, "single": single_a}

    def final(r):
        # stream[valid] ran on a cache file: its cache counters differ
        s = dict(r["stream"])
        for k in ("first_verdict_event", "invalid_event", "cache_hits",
                  "cache_misses", "cache_inserts"):
            s.pop(k, None)
        return {**r, "stream": s}

    emit(f"stream[async]: events={len(hd)} of {len(h)} valid={resa['valid']}"
         f" ingest_s={tla['ingest_s']:.3f} finalize_s="
         f"{tla['finalize_s']:.4f} routes={resa['stream']['routes']}; "
         f"launches grid={grid_a} single={single_a}; inline ingest_s="
         f"{tli['ingest_s']:.3f} launches grid={grid_i} single={single_i}")
    check(final(resa) == final(resi), "stream[async]: the final result "
          "differs from the inline one")

    # the verdict cache: stream[valid] was the cold run on this file; a
    # fresh object on it serves every segment
    r2, t2, g2, s2, _f, _g = _stream_run("stream[cache] warm", h, model,
                                         cache=VerdictCache(path))
    st2 = r2["stream"]
    launches["stream[cache]"] = {"grid": g2, "single": s2}
    emit(f"stream[cache]: cold (stream[valid]) ingest_s={tl['ingest_s']:.3f}"
         f" grid={grid}; warm ingest_s={t2['ingest_s']:.3f} grid={g2} "
         f"single={s2} "
         f"hits/misses={st2['cache_hits']}/{st2['cache_misses']} "
         f"segments={st2['segments']} configs={r2['configs']}")
    check(r2["valid"] is True and st2["cache_misses"] == 0
          and st2["cache_hits"] == st2["segments"] and g2 == 0 and s2 == 0,
          f"stream[cache]: warm run {st2}, {g2} grid and {s2} single-key "
          f"launches")

    # the service: two streams with the same content, the second served
    # from the cache the first fills; a stream's first third, which keeps
    # the service's routes and cache at a third of the folds
    served = stream_prefix(stream_history(seed=f"{STREAM_SEED}-0")[0], model)
    streams = {f"s{i}": served for i in range(2)}
    lines = [json.dumps({"run": r, "model": "cas-register"})
             for r in streams]
    for i in range(max(len(x) for x in streams.values())):
        for r, x in streams.items():
            if i < len(x):
                lines.append(json.dumps({"run": r, "op": x[i].to_dict()}))
    cache = VerdictCache()
    svc = StreamService(cache=cache, device="cuda", **STREAM_KW)
    replies = []
    _zero_counts()
    t0 = time.perf_counter()
    serve_lines(svc, lines, replies.append)
    wall = time.perf_counter() - t0
    single_v, grid_v = _read_counts()
    launches["stream[service]"] = {"grid": grid_v, "single": single_v}
    finals = {d["run"]: d["final"] for d in replies if "final" in d}
    errors = [d for d in replies if "error" in d]
    n_events = sum(len(x) for x in streams.values())
    emit(f"stream[service]: streams={len(streams)} events={n_events} "
         f"wall_s={wall:.3f} "
         f"({n_events / wall:.1f} events/s); cache hits/misses/inserts="
         f"{cache.hits}/{cache.misses}/{cache.inserts}; finals "
         + " ".join(f"{r}={f['valid']}/{f['stream']['routes']}"
                    for r, f in sorted(finals.items()))
         + f"; launches grid={grid_v} single={single_v}")
    check(not errors, f"stream[service]: error replies {errors[:2]}")
    check(sorted(finals) == sorted(streams)
          and all(f["valid"] is True for f in finals.values()),
          f"stream[service]: finals {finals}")
    check(cache.hits > 0, f"stream[service]: the second stream had no "
          f"cache hit (hits/misses {cache.hits}/{cache.misses})")

    # the bench tier: 6 clients, host folds
    _zero_counts()
    t0 = time.perf_counter()
    tier = run_stream_tier(quick=False, device="cuda", out_path=str(
        REPO / "build" / "stream_tier.json"))
    wall = time.perf_counter() - t0
    single_t, grid_t = _read_counts()
    launches["stream tier"] = {"grid": grid_t, "single": single_t}
    emit(f"stream tier: wall_s={wall:.3f} parity={tier['parity']} "
         f"ttfv={tier['ttfv']} "
         f"violation={tier['violation_latency']} multiplexed="
         f"{tier['multiplexed']}; launches grid={grid_t} "
         f"single={single_t}")
    check(tier["parity"] is True, "stream tier: parity false")
    return launches


#: logical shards on the one card for the multi-device phases (the
#: reference's tests put 8 virtual devices on one CPU)
SHARDS = 4


def _prune_modes(dims, n_shards: int) -> tuple:
    """(closure site, det site) prune of the sharded step at ``dims``,
    as ``build_sharded_search_step_fn`` picks them on the card."""
    import torch

    from jepsen_tpu_torch.checker import sharded, step

    c_det, c_cr = sharded.route_capacities(dims, n_shards)
    card = torch.device("cuda", 0)
    F = dims.frontier
    return tuple("allpairs" if step._use_allpairs(m, card) else "sort"
                 for m in (F + n_shards * c_cr, n_shards * c_det))


def _sharded_run(label, seq, model, n_shards, **kw):
    """One counted ``search_opseq_sharded`` over ``n_shards`` logical
    shards on ``cuda:0``: (result, wall seconds, closure and det prune
    modes at its final width, escalations)."""
    import math

    import torch

    from jepsen_tpu_torch.checker import encode
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.distributed import ShardMesh

    mesh = ShardMesh(["cuda:0"] * n_shards)
    f0 = kw.get("frontier_per_device", 1024)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lin.search_opseq_sharded(seq, model, mesh, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    single, grid = _read_counts()
    check(single == grid == 0, f"{label}: the sharded step launched B1 "
          f"({single} single, {grid} grid): it has its own level body")
    check(res["engine"] == f"device-sharded-x{n_shards}",
          f"{label}: engine {res['engine']}")
    F = res["frontier_per_device"]
    dims = encode.choose_dims(encode.encode_search(seq), model,
                              device=mesh.devices[0], frontier=F)
    esc = round(math.log(F / f0, 4))
    return res, wall, _prune_modes(dims, n_shards), esc


def _sharded_line(label, res, wall, modes, esc, extra="") -> None:
    tb = res["search_telemetry"]
    emit(f"{label}: valid={res['valid']} configs={res['configs']}{extra} "
         f"max_depth={res['max_depth']} engine={res['engine']} "
         f"frontier_per_device={res['frontier_per_device']} prune(closure,"
         f"det)={modes} levels={tb['levels']} slices={tb['slices']} "
         f"escalations={esc} wall_s={wall:.3f} "
         f"({_us_per_level(wall, res)} us/level) "
         f"telemetry: {_tele_totals(res)}")


def phase_sharded():
    """The multi-device routes on one card, over logical shards of
    ``cuda:0``: the sharded-frontier search (B7) on 1k at 1024 rows per
    shard, one shard and :data:`SHARDS`, with the defaults (held to
    :data:`REFERENCE_REDUCED`, and to the masked control's configs where
    every merge site prunes all-pairs), and on mutex2k with the prepass
    and DPOR off; then the key-sharded batch (B8) on batch256, bucketed
    and fused, every key held to ``BATCH256_*``, its shards running B1's
    grid form with telemetry (at its fixed frontier of 64, three keys
    bill fewer configs than the ladder's, :data:`BATCH256_AT64_CONFIGS`);
    then the same batch over a one-rank NCCL
    group on the keys axis (``distributed.init_process_group``), held to
    the standalone result.  Returns the batch paths' launches."""
    import socket

    from jepsen_tpu_torch import distributed as dist
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.distributed import ShardMesh

    seq, model = tier_history("1k")
    want = REFERENCE_REDUCED["1k"]
    for n_shards in (1, SHARDS):
        label = f"sharded[1k] D={n_shards}"
        res, wall, modes, esc = _sharded_run(label, seq, model, n_shards,
                                             frontier_per_device=1024)
        _sharded_line(label, res, wall, modes, esc,
                      extra=f" (masked control {want[1]})")
        check((res["valid"], res["max_depth"]) == (want[0], want[2]),
              f"{label}: valid={res['valid']} max_depth={res['max_depth']}"
              f", want {want[0]}, {want[2]}")
        if modes == ("allpairs", "allpairs"):
            check(res["configs"] == want[1], f"{label}: {res['configs']} "
                  f"configs with every merge site all-pairs, the masked "
                  f"control {want[1]}")
        _check_telemetry(label, res)

    seq, model = tier_history("mutex2k")
    label = f"sharded[mutex2k] D={SHARDS}"
    res, wall, modes, esc = _sharded_run(label, seq, model, SHARDS,
                                         hb=False, dpor=False)
    _sharded_line(label, res, wall, modes, esc)
    check(res["valid"] is False and res["max_depth"] == 1971
          and res["configs"] <= REFERENCE["mutex2k"][1],
          f"{label}: valid={res['valid']} configs={res['configs']} "
          f"max_depth={res['max_depth']}, want False, <= "
          f"{REFERENCE['mutex2k'][1]}, 1971")
    _check_telemetry(label, res)

    keys, model = batch_keys()
    mesh = ShardMesh(["cuda:0"] * SHARDS)
    launches, standalone = {}, None
    for way, kw in (("bucketed", {}), ("fused", {"bucket": False})):
        label = f"sharded_batch[batch256[{way}]] D={SHARDS}"
        _zero_counts()
        t0 = time.perf_counter()
        res = lin.search_batch(keys, model, sharding=mesh, **kw)
        wall = time.perf_counter() - t0
        single, grid = _read_counts()
        launches[label] = {"grid": grid, "single": single}
        _check_batch_results(label, res, configs=BATCH256_AT64_CONFIGS)
        check(grid > 0, f"{label}: B1's grid form never launched")
        sb = res[0].get("shard_batch") or {}
        check(way == "fused" or sb.get("n_devices") == SHARDS,
              f"{label}: shard_batch {sb}")
        stats = {k: sb[k] for k in ("n_buckets", "pad_keys", "overflow_redo",
                                    "padding_efficiency",
                                    "fused_padding_efficiency",
                                    "kernel_cache") if k in sb}
        buckets = [(b["dims"], b["lanes"], b["pad_lanes"])
                   for b in sb.get("buckets", [])]
        emit(f"{label}: keys={BATCH_KEYS} routes={_route_counts(res)} "
             f"wall_s={wall:.3f} grid_launches={grid} (B1-T grid form, "
             f"telemetry on) single_launches={single} shard_batch={stats} "
             f"buckets (dims, lanes, pad lanes)={buckets}")
        if way == "bucketed":
            standalone = res

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    label = f"distributed[nccl] D={SHARDS}"
    t0 = time.perf_counter()
    check(dist.init_process_group(coordinator=f"127.0.0.1:{port}",
                                  num_processes=1, process_id=0,
                                  device="cuda:0", timeout=120.0),
          f"{label}: the process group did not come up")
    try:
        init_s = time.perf_counter() - t0
        kmesh = dist.multihost_mesh(devices=["cuda:0"] * SHARDS)
        check(kmesh.shape == {"keys": 1, "shard": SHARDS},
              f"{label}: mesh {kmesh.shape}")
        sh = dist.keys_sharding(kmesh)
        check(sh.spans_processes, f"{label}: the keys do not span the group")
        _zero_counts()
        t0 = time.perf_counter()
        res = lin.search_batch(keys, model, sharding=sh)
        wall = time.perf_counter() - t0
        single, grid = _read_counts()
        launches[label] = {"grid": grid, "single": single}
        backend = __import__("torch").distributed.get_backend()
    finally:
        dist.shutdown_process_group()
    _check_batch_results(label, res, configs=BATCH256_AT64_CONFIGS)
    got = [(r["valid"], r["configs"], r["max_depth"]) for r in res]
    check(got == [(r["valid"], r["configs"], r["max_depth"])
                  for r in standalone],
          f"{label}: the group's result differs from the standalone one")
    emit(f"{label}: backend={backend} keys={BATCH_KEYS} init_s={init_s:.3f}"
         f" wall_s={wall:.3f} grid_launches={grid} single_launches={single}"
         f" equal to the standalone result: True")
    return launches


#: the fleet tier at the JAX package's own size (``fleet/bench.py``):
#: 2 workers, 400-op register runs of 6 processes (overlap 4, quiescent
#: every 8 ops, 5 values), rungs of 1, 2, 4 and 8 clients; one run per
#: client where the JAX package's tier runs 3 (cut to make room for
#: phase_suites inside the script's time limit)
FLEET_RUNGS = (1, 2, 4, 8)
FLEET_RUNS_PER_CLIENT = 1
FLEET_OPS = 400
#: seeds of the traffic sample whose compile spans give the warm set
#: (the swarm's seeds start at 1001)
FLEET_SHAPE_SEEDS = (2001, 2002)
#: the sharded-batch shape the warm boot adds: 16 keys over 4 logical
#: shards of the card (the sharded batch's own frontier of 64)
FLEET_SHARDED_SHAPE = dict(n_det_pad=64, frontier=64, batch=16, shards=4)
#: the ``--device`` of ``python -m jepsen_tpu_torch.fleet``'s workers
FLEET_WORKER_DEVICE = "cuda"


def _fleet_final_check(label, got, want) -> None:
    from jepsen_tpu_torch.fleet.bench import _strip_cache

    check(_strip_cache(got) == want, f"{label}: the routed final "
          f"{_strip_cache(got)} differs from the single service's {want}")


def _quiescent_cut(h) -> int:
    """The first index past the middle of ``h`` where no op is open."""
    for i in range(len(h) // 2, len(h)):
        if sum(1 if op.type == "invoke" else -1 for op in h[:i]) == 0:
            return i
    raise SmokeFailure("no quiescent cut in the fleet history")


def phase_fleet(store_base):
    """The fleet tier (``jepsen_tpu_torch/fleet/``) on the card.

    ``fleet[warmup]``: a cold kernel cache (as a new worker has), then
    ``warm_boot`` on ``cuda:0`` over three sets: ``_default_warm_shapes``
    (the committed 1k trace and the JAX package's small-segment shapes),
    the shapes a traced sample of the fleet traffic builds
    (``record_traffic_shapes``, seeds outside the swarm's) and one
    sharded-batch shape over 4 logical shards; every set verifies and B1
    launches; a second boot compiles nothing.  ``fleet[routed]``: two
    in-process workers folding every closed segment on the card
    (``host_fold_max=0``), each on its own segment of one
    ``FleetCacheStore`` root, the router with its probes, the swarm at
    the JAX package's size; no kernel-cache miss while it runs, and every
    routed final equal to one in-process ``StreamService``'s on the same
    history.  ``fleet[dead]``: a worker stopped mid-run; its runs'
    salvaged finals and their suffixes on the survivor equal the single
    service's.  ``fleet[process]``: ``python -m jepsen_tpu_torch.fleet
    --workers 2`` warming from a manifest of the traffic shapes, two runs
    through its router, the aggregated scrape, and a SIGTERM drain.
    Returns the counted paths' launches."""
    import dataclasses
    import signal
    import socket
    import threading
    import urllib.request

    from jepsen_tpu_torch.checker import level_kernel as lk
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.fleet import bench as fb
    from jepsen_tpu_torch.fleet.warmup import WarmShape, warm_boot
    from jepsen_tpu_torch.reconnect import Backoff

    t_phase = time.perf_counter()
    launches = {}

    # -- fleet[warmup] ---------------------------------------------------
    lin._STEP_CACHE.clear()
    t0 = time.perf_counter()
    traffic = fb.record_traffic_shapes(
        [fb._mk_history(s, FLEET_OPS) for s in FLEET_SHAPE_SEEDS],
        device="cuda", host_fold_max=0)
    record_s = time.perf_counter() - t0
    check(traffic and not lin._STEP_CACHE, f"fleet[warmup]: the traffic "
          f"sample built {len(traffic)} shapes, cache {len(lin._STEP_CACHE)}")
    sets = {"default": fb._default_warm_shapes(), "traffic": traffic,
            "sharded": [WarmShape(**FLEET_SHARDED_SHAPE)]}
    _zero_counts()
    for name, shapes in sets.items():
        s0, g0 = lk.LAUNCHES, lk.BATCH_LAUNCHES
        by0 = dict(lk.LAUNCHES_BY_FORM)
        rep = warm_boot(shapes, device="cuda:0")
        single, grid = lk.LAUNCHES - s0, lk.BATCH_LAUNCHES - g0
        by = {f"{f},{'on' if t else 'off'}": n - by0[f, t]
              for (f, t), n in lk.LAUNCHES_BY_FORM.items() if n - by0[f, t]}
        emit(f"fleet[warmup] {name}: {rep} B1 launches single={single} "
             f"grid={grid} by form {by}"
             + (f"; traffic sample traced in {record_s:.3f} s: "
                f"{[dataclasses.astuple(s) for s in shapes]}"
                if name == "traffic" else ""))
        check(rep["verified"] is True and rep["compiled"] > 0
              and rep["shapes"] == len(shapes),
              f"fleet[warmup] {name}: report {rep}")
        check(single + grid > 0, f"fleet[warmup] {name}: B1 never launched")
        if name == "sharded":
            check(grid == FLEET_SHARDED_SHAPE["shards"], f"fleet[warmup] "
                  f"sharded: {grid} grid launches, want one per shard")
    every = [s for shapes in sets.values() for s in shapes]
    rep2 = warm_boot(every, device="cuda:0")
    single, grid = _read_counts()
    launches["fleet[warmup]"] = {"grid": grid, "single": single}
    emit(f"fleet[warmup] second boot: {rep2}; both boots launched B1 "
         f"single={single} grid={grid}")
    check(rep2["compiled"] == 0 and rep2["verified"] is True,
          f"fleet[warmup]: the second boot {rep2}")

    # -- fleet[routed] ---------------------------------------------------
    with tempfile.TemporaryDirectory(dir=store_base) as root:
        fleet = fb.Fleet(root, device="cuda", host_fold_max=0)
        try:
            keys0, misses0 = set(lin._STEP_CACHE), \
                lin.KERNEL_CACHE_STATS["misses"]
            _zero_counts()
            t0 = time.perf_counter()
            ramp, finals, hists = fb.run_swarm(
                fleet.port, FLEET_RUNGS, FLEET_RUNS_PER_CLIENT, FLEET_OPS)
            swarm_s = time.perf_counter() - t0
            single, grid = _read_counts()
            misses = lin.KERNEL_CACHE_STATS["misses"] - misses0
            launches["fleet[routed]"] = {"grid": grid, "single": single}
            stats = fleet.router.aggregate_stats()
            segs = {c.worker_id: os.path.getsize(c.path)
                    for c in fleet.caches}
        finally:
            fleet.close()
    for r in ramp:
        emit(f"fleet[routed] clients={r['clients']}: runs={r['runs']} "
             f"finals={r['finals']} events={r['events_total']} "
             f"wall_s={r['wall_s']} events_per_sec={r['events_per_sec']} "
             f"overloaded={r['overloaded']} errors={r['errors']}")
        check(r["finals"] == r["runs"] and not r["errors"]
              and not r["overloaded"], f"fleet[routed]: rung {r}")
    knee = fb.throughput_knee(ramp)
    check(misses == 0, f"fleet[routed]: {misses} kernel-cache misses in "
          f"the swarm: {sorted(map(str, set(lin._STEP_CACHE) - keys0))}")
    check(grid > 0, "fleet[routed]: B1's grid form never launched")
    routes = collections.Counter()
    for f in finals.values():
        routes.update(f["stream"]["routes"])
    t0 = time.perf_counter()
    par = fb.parity_check(finals, hists, device="cuda", host_fold_max=0,
                          sample=None)
    parity_s = time.perf_counter() - t0
    emit(f"fleet[routed]: {len(finals)} runs of {FLEET_OPS} ops, swarm "
         f"{swarm_s:.3f} s, knee {knee}; routes over the runs "
         f"{dict(routes)}; steady-state kernel-cache misses {misses}; B1 "
         f"launches grid={grid} single={single} (telemetry forms); "
         f"workers in the scrape {stats.get('n_workers')}, segment bytes "
         f"{segs}; every final against the single service: "
         f"{par['parity']} ({par['checked']} runs, {parity_s:.3f} s)")
    check(par["parity"] and par["checked"] == len(finals) == sum(
        r["runs"] for r in ramp), f"fleet[routed]: parity "
        f"{par.get('diffs', [])[:1]}")
    check(routes["device"] > 0 and routes["host"] == 0,
          f"fleet[routed]: routes {dict(routes)}")

    # -- fleet[dead] -----------------------------------------------------
    with tempfile.TemporaryDirectory(dir=store_base) as root:
        fleet = fb.Fleet(root, device="cuda", host_fold_max=0,
                         probe_interval=0.05, backoff_factory=lambda: Backoff(
                             base=0.01, cap=0.05, max_attempts=3,
                             jitter=0.0))
        try:
            victim = fleet.router.route("dead-0").wid
            rids = [r for r in (f"dead-{i}" for i in range(64))
                    if fleet.router.route(r).wid == victim][:2]
            other = next(r for r in (f"live-{i}" for i in range(64))
                         if fleet.router.route(r).wid != victim)
            runs = {r: fb._mk_history(4001 + i, FLEET_OPS)
                    for i, r in enumerate(rids + [other])}
            lines = {r: fb._op_lines(r, h) for r, h in runs.items()}
            cuts = {r: _quiescent_cut(runs[r]) for r in rids}
            vsrv = fleet.servers[[s.wid for s in fleet.specs].index(victim)]
            _zero_counts()
            with socket.create_connection(("127.0.0.1", fleet.port),
                                          timeout=300) as s:
                w, rf = s.makefile("w"), s.makefile("r")
                for r in rids:
                    for li in lines[r][:cuts[r] + 1]:
                        w.write(li + "\n")
                for li in lines[other]:
                    w.write(li + "\n")
                w.flush()
                # every prefix op ingested by the victim, then stop it
                deadline = time.monotonic() + 120
                while time.monotonic() < deadline and sum(
                        svc._ops.get(r, 0) for svc in list(vsrv.services)
                        for r in rids) < sum(cuts.values()):
                    time.sleep(0.02)
                fleet.kill(victim)
                while fleet.router.is_live(victim) \
                        and time.monotonic() < deadline:
                    time.sleep(0.02)
                check(not fleet.router.is_live(victim),
                      "fleet[dead]: the probes never declared the victim "
                      "dead")
                for r in rids:
                    for li in lines[r][cuts[r] + 1:]:
                        w.write(li + "\n")
                w.flush()
                s.shutdown(socket.SHUT_WR)
                replies = [json.loads(x) for x in rf if x.strip()]
            single, grid = _read_counts()
            launches["fleet[dead]"] = {"grid": grid, "single": single}
        finally:
            fleet.close()
    salvaged = rerouted = 0
    for r in rids:
        fin = [d["final"] for d in replies
               if d.get("run") == r and "final" in d]
        head, end = lines[r][0], lines[r][-1:]
        pre = fb._single_service_final(
            None, device="cuda", host_fold_max=0,
            lines=lines[r][:cuts[r] + 1] + end)
        suf = fb._single_service_final(
            None, device="cuda", host_fold_max=0,
            lines=[head] + lines[r][cuts[r] + 1:])
        sal = [f for f in fin if f.get("finalized_by") == "salvage"]
        rest = [f for f in fin if f.get("finalized_by") != "salvage"]
        check(len(sal) == 1 and {k: sal[0][k] for k in ("valid", "engine")}
              == {k: pre[k] for k in ("valid", "engine")},
              f"fleet[dead] {r}: salvaged {sal}, want {pre}")
        check(rest and len(rest) <= 2, f"fleet[dead] {r}: finals {fin}")
        _fleet_final_check(f"fleet[dead] {r} suffix", rest[-1], suf)
        if len(rest) == 2:  # the victim's own final got through first
            _fleet_final_check(f"fleet[dead] {r} prefix", rest[0], pre)
        salvaged += 1
        rerouted += 1
    fin = [d["final"] for d in replies if d.get("run") == other
           and "final" in d]
    check(len(fin) == 1, f"fleet[dead] {other}: finals {fin}")
    _fleet_final_check(f"fleet[dead] {other}", fin[0],
                       fb._single_service_final(runs[other], device="cuda",
                                                host_fold_max=0))
    emit(f"fleet[dead]: victim {victim} stopped with {len(rids)} open runs "
         f"(cut at ops {sorted(cuts.values())}); salvaged {salvaged}, "
         f"suffixes rerouted {rerouted}, the survivor's own run final; every "
         f"final equal to the single service's; B1 launches grid={grid} "
         f"single={single}")

    # -- fleet[process] --------------------------------------------------
    with tempfile.TemporaryDirectory(dir=store_base) as root:
        manifest = os.path.join(root, "shapes.json")
        with open(manifest, "w") as f:
            json.dump({"shapes": [dataclasses.asdict(s) for s in traffic]},
                      f)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch.fleet", "--workers",
             "2", "--device", FLEET_WORKER_DEVICE, "--warmup", manifest,
             "--listen", "127.0.0.1:0", "--cache-root",
             os.path.join(root, "cache")],
            stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
            cwd=str(REPO), start_new_session=True)
        log_lines, ready = [], threading.Event()

        def read():
            for ln in proc.stderr:
                log_lines.append(ln.rstrip())
                if ln.startswith("fleet router listening on"):
                    ready.set()
            ready.set()

        threading.Thread(target=read, daemon=True).start()
        try:
            check(ready.wait(300) and proc.poll() is None,
                  "fleet[process]: the router never listened: "
                  + " | ".join(log_lines[-20:]))
            boot_s = time.perf_counter() - t0
            head = next(ln for ln in log_lines
                        if ln.startswith("fleet router listening on"))
            port = int(head.split()[4].rsplit(":", 1)[1])
            admitted = [ln.split("fleet: ", 1)[1] for ln in log_lines
                        if "admitted at" in ln]
            check(len(admitted) == 2 and all("'verified': True" in ln
                                             for ln in admitted),
                  f"fleet[process]: admissions {admitted}")
            hs = {f"proc-{i}": fb._mk_history(5001 + i, FLEET_OPS)
                  for i in range(2)}
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=300) as s:
                w, rf = s.makefile("w"), s.makefile("r")
                for rid, h in hs.items():
                    for li in fb._op_lines(rid, h):
                        w.write(li + "\n")
                w.flush()
                s.shutdown(socket.SHUT_WR)
                out = [json.loads(x) for x in rf if x.strip()]
            for rid, h in hs.items():
                fin = [d["final"] for d in out
                       if d.get("run") == rid and "final" in d]
                check(len(fin) == 1, f"fleet[process] {rid}: {fin}")
                _fleet_final_check(f"fleet[process] {rid}", fin[0],
                                   fb._single_service_final(h,
                                                            device="cuda"))
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30).read() \
                .decode()
            scraped = sorted({ln.split('worker="', 1)[1].split('"', 1)[0]
                              for ln in text.splitlines()
                              if 'worker="' in ln})
            check({"w1", "w2", "router"} <= set(scraped),
                  f"fleet[process]: /metrics carries {scraped}")
            # a run still open when SIGTERM lands gets its final
            h = fb._mk_history(5003, FLEET_OPS)
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=300) as s:
                w, rf = s.makefile("w"), s.makefile("r")
                for li in fb._op_lines("proc-open", h)[:-1]:
                    w.write(li + "\n")
                w.flush()
                # a live reply: the worker holds the run open
                drained = [json.loads(rf.readline())]
                check("live" in drained[0], f"fleet[process]: {drained}")
                t1 = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
                drained += [json.loads(x) for x in rf if x.strip()]
            rc = proc.wait(timeout=120)
            drain_s = time.perf_counter() - t1
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
    fin = [d["final"] for d in drained if "final" in d]
    check(rc == 0 and [f.get("finalized_by") for f in fin] == ["drain"],
          f"fleet[process]: exit {rc}, finals after SIGTERM {fin}")
    emit(f"fleet[process]: 2 workers booted and admitted in {boot_s:.3f} s "
         f"({admitted}); 2 routed runs equal to the single service's; "
         f"/metrics workers {scraped}; SIGTERM drained the open run "
         f"(valid={fin[0]['valid']}) and exited {rc} in {drain_s:.3f} s")
    emit(f"fleet: phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# the static plan and its closed loop on the card
# ---------------------------------------------------------------------------

#: the JAX package's static plan of the shard tier's full key set (40
#: keys of 74 ops and 8 of 240 over 8 devices: ``explain_batch(keys,
#: model, n_devices=8)`` on the CPU, the numbers of its committed
#: BENCH_shard.json), which the port's live stats on the card must equal
SHARD_TIER_PLAN = {"n_buckets": 2, "useful_ops": 3619, "padded_ops": 6144,
                   "padding_efficiency": 0.589, "fused_padded_ops": 13824,
                   "fused_padding_efficiency": 0.2618}

#: the corpus phase's register histories: seeds, and their shape (110
#: ops of 6 processes, 5 in flight, a few crashes), sized past the greedy
#: witness and the prepass; every other one gets a corrupted read
CORPUS_SEEDS = tuple(range(9000, 9006))
CORPUS_REGISTER = dict(n_ops=110, n_procs=6, overlap=5, crash_p=0.03,
                       max_crashes=3, n_values=4)


def _timed_phase(name):
    """Print a phase's wall seconds when it returns."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            emit(f"{name}: phase wall {time.perf_counter() - t0:.1f} s")
            return out
        return run
    return deco


@_timed_phase("plan")
def phase_plan():
    """The static plan against the live search on the card.  For 1k
    (the defaults), mutex2k (its prepass decides it, so with the prepass
    and DPOR off) and a 110-op register history (prepass and DPOR off,
    whose first frontier is the card's 64 where the host's is 32),
    ``explain(device="cuda")`` launches nothing,
    and its ``engine``, ``search_dims`` (the frontier included) and
    ``bucket`` must be the route the live device search took, the dims it
    started at, and the bucket the bucketed batch put the history in;
    mutex2k's plan must carry the prepass's decision.  The plan's
    predicted hb/dpor prune ratios print beside 1k's observed one.
    ``Linearizable(explain=True)`` on 1k launches B1 no time and answers
    "unknown".  Returns the counted live searches' launches."""
    import contextlib
    import io

    from jepsen_tpu_torch.analyze.plan import explain
    from jepsen_tpu_torch.checker import linearizable as lin

    from jepsen_tpu_torch.history import encode_ops
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.synth import corrupt_read, register_history

    off = {"hb": False, "dpor": False}
    rng = random.Random(CORPUS_SEEDS[0])
    small = corrupt_read(rng, register_history(rng, **CORPUS_REGISTER),
                         at=0.8)
    cases = [("1k", *tier_history("1k"), {}),
             ("mutex2k", *tier_history("mutex2k"), off),
             ("register110", encode_ops(small, cas_register().f_codes),
              cas_register(), off)]
    launches, plans = {}, {}
    for name, seq, model, kw in cases:
        _zero_counts()
        t0 = time.perf_counter()
        plan = explain(seq, model, device="cuda", **kw)
        plan_s = time.perf_counter() - t0
        check(_read_counts() == (0, 0), f"plan[{name}]: explain launched")
        plans[name] = plan
        host = explain(seq, model, device="cpu", **kw)["search_dims"]
        _zero_counts()
        with _FirstDims() as spy:
            t0 = time.perf_counter()
            res = lin.search_opseq(seq, model, device="cuda", **kw)
            live_s = time.perf_counter() - t0
            batch = lin.search_batch([seq], model, device="cuda",
                                     bucket=True, **kw)[0]
        single, grid = _read_counts()
        launches[f"plan[{name}]"] = {"grid": grid, "single": single}
        d0 = spy.started[0]
        live_dims = {k: getattr(d0, k) for k in plan["search_dims"]}
        bucket = batch["bucket_batch"]["buckets"][0]["dims"]
        emit(f"plan[{name}] {kw or 'defaults'}: explain {plan_s:.3f} s, "
             f"engine={plan['engine']} search_dims={plan['search_dims']} "
             f"(on the host: frontier {host['frontier']}) "
             f"bucket={plan['bucket']}; the live search {live_s:.3f} s: "
             f"engine={res['engine']} started at {live_dims}, final "
             f"frontier {res['frontier']}; the bucketed batch's bucket "
             f"{bucket} ({batch['engine']}); B1 launches single={single} "
             f"grid={grid}")
        check(plan["engine"] == "device-bfs"
              and res["engine"] == "device-bfs(cuda)",
              f"plan[{name}]: planned {plan['engine']}, ran {res['engine']}")
        check(live_dims == plan["search_dims"],
              f"plan[{name}]: planned {plan['search_dims']}, the search "
              f"started at {live_dims}")
        check(bucket == plan["bucket"] and grid > 0,
              f"plan[{name}]: planned bucket {plan['bucket']}, ran {bucket}")
        if name == "1k":
            tele = res["search_telemetry"]
            emit(f"plan[1k] prune ratios: predicted hb "
                 f"{plan['hb']['prune_ratio']} dpor "
                 f"{plan['dpor']['prune_ratio']}; the search's telemetry "
                 f"predicted {tele.get('predicted_prune_ratio')} observed "
                 f"{tele['observed_prune_ratio']} (delta "
                 f"{tele.get('prune_ratio_delta')})")
            check(plan["hb"]["decided"] is None, f"plan[1k]: {plan['hb']}")
        elif name == "mutex2k":
            decided = lin.search_opseq(seq, model, device="cuda")
            check(plan["constraints"]["decided"] is False
                  and plan["constraints"]["reason"] == PREPASS_REASON[name]
                  and decided["engine"] == "constraint-decide",
                  f"plan[mutex2k]: the plan's prepass "
                  f"{plan['constraints'].get('reason')}, the search's "
                  f"{decided['engine']}")

    # the card's narrowest rung is 64 rows, the host's 16
    check(plans["register110"]["search_dims"]["frontier"] == 64,
          f"plan[register110]: {plans['register110']['search_dims']}")
    seq, model = tier_history("1k")
    before = dict(FORM_LAUNCHES)
    _zero_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = lin.linearizable(model, explain=True, device="cuda").check(
            {"name": "plan"}, seq)
    counts = _read_counts()
    emit(f"plan[1k] Linearizable(explain=True): valid={res['valid']} "
         f"engine={res['engine']} configs={res['configs']}; printed "
         f"{len(out.getvalue().splitlines())} plan lines; B1 launches "
         f"single={counts[0]} grid={counts[1]}")
    check(res["valid"] == "unknown" and counts == (0, 0)
          and dict(FORM_LAUNCHES) == before
          and res["explain"] == plans["1k"],
          f"plan[1k] explain=True: {res['valid']}, launches {counts}")
    return launches


@_timed_phase("shard tier")
def phase_shard_tier(out_dir):
    """The shard bench tier in full (48 keys over 8 logical shards of
    the card, its shards on B1-T's grid form), writing into ``out_dir``:
    parity, no steady-state build, the warm-boot round trip building
    nothing, and the live ``shard_batch`` stats equal to the plan and to
    the JAX package's static numbers (:data:`SHARD_TIER_PLAN`).  Returns
    (its launches, its trace's path)."""
    from jepsen_tpu_torch.checker.shard_bench import run_shard_tier

    trace = os.path.join(out_dir, "trace_shard.json")
    _zero_counts()
    t0 = time.perf_counter()
    out = run_shard_tier(out_path=os.path.join(out_dir, "shard.json"),
                         trace_path=trace)
    wall = time.perf_counter() - t0
    single, grid = _read_counts()
    b, fc = out["bucketed"], out["fused_counterfactual"]
    live = {"n_buckets": b["n_buckets"],
            "useful_ops": sum(x["useful_ops"] for x in b["buckets"]),
            "padded_ops": sum(x["padded_ops"] for x in b["buckets"]),
            "padding_efficiency": b["padding_efficiency"],
            "fused_padded_ops": fc["padded_ops"],
            "fused_padding_efficiency": fc["padding_efficiency"]}
    emit(f"shard_tier: {out['n_keys']} keys over {out['n_devices']} "
         f"logical shards of {out['device']}, wall {wall:.3f} s (warm laps "
         f"{out['warm_lap']}; measured bucketed {b['wall_s']} s, fused "
         f"{fc['wall_s']} s); {live}; buckets (dims, lanes, pad lanes) "
         f"{[(x['dims'], x['lanes'], x['pad_lanes']) for x in b['buckets']]}"
         f"; parity {out['parity']} ({out['parity_oracle_sampled']} keys on "
         f"the oracle), explain_match {out['explain_match']}, steady-state "
         f"misses {out['steady_state_compile_misses']}, warm boot "
         f"{out['warmup']}; B1-T launches grid={grid} single={single}")
    check(out["parity"] and out["explain_match"]
          and out["steady_state_compile_misses"] == 0,
          f"shard_tier: parity {out['parity']}, explain "
          f"{out.get('explain_diffs')}, misses "
          f"{out['steady_state_compile_misses']}")
    check(out["warmup"]["compiled"] == 0 and out["warmup"]["verified"],
          f"shard_tier: the warm boot {out['warmup']}")
    check(live == SHARD_TIER_PLAN, f"shard_tier: {live}, the JAX "
          f"package's plan {SHARD_TIER_PLAN}")
    check(grid > 0, "shard_tier: B1's grid form never launched")
    return {"shard_tier": {"grid": grid, "single": single}}, trace


def corpus_pool(base) -> list:
    """Bank the corpus phase's pool under ``base``: the
    :data:`CORPUS_SEEDS` register histories, a mutex history with
    crashes, a queue history that loses an acked enqueue and a valid one
    with a drain, each with its verdict by the host oracle as the banked
    expectation (so an invalid entry gets its minimal repro).  Returns
    the pool."""
    from jepsen_tpu_torch import synth
    from jepsen_tpu_torch.checker import basic
    from jepsen_tpu_torch.checker.seq import check_opseq
    from jepsen_tpu_torch.history import encode_ops, invoke_op, ok_op
    from jepsen_tpu_torch.live import corpus
    from jepsen_tpu_torch.models import cas_register, mutex

    cells = []
    for i, seed in enumerate(CORPUS_SEEDS):
        rng = random.Random(seed)
        h = synth.register_history(rng, **CORPUS_REGISTER)
        if i % 2 == 0:
            h = synth.corrupt_read(rng, h, at=0.8)
        cells.append((cas_register(), h, "kv", "partition"))
    cells.append((mutex(), synth.sim_mutex_history(
        random.Random(9100), 60, 4, crash_p=0.05), "lock", "pause"))
    lost = []
    for j in range(14):
        lost += [invoke_op(j % 3, "enqueue", j), ok_op(j % 3, "enqueue", j)]
    drain = [invoke_op(0, "drain", None), ok_op(0, "drain", list(range(14)))]
    cells += [(None, lost + [drain[0], ok_op(0, "drain", [
        j for j in range(14) if j != 3])], "queue", "link-bridge"),
        (None, lost + drain, "queue", "kill-restart")]
    for model, h, family, nemesis in cells:
        if model is None:
            valid = basic.total_queue().check({}, h)["valid"]
        else:
            valid = check_opseq(encode_ops(h, model.f_codes),
                                model)["valid"]
        corpus.bank_cell({"model": model, "history": h},
                         {"family": family, "nemesis": nemesis,
                          "valid": valid}, base=base)
    return corpus.load_pool(corpus.corpus_dir(base))


@_timed_phase("corpus")
def phase_corpus(base):
    """A seeded pool (:func:`corpus_pool`) replayed through every route
    with ``corpus_replay(device="cuda")``: the direct search and the
    bucketed batch on B1 (single-key and grid forms), the decomposed
    engine, the stream, the prepass and the host oracle with DPOR on and
    off; every route agrees, every banked expectation and minimal repro
    holds, every certificate audits clean.  Returns its launches."""
    from jepsen_tpu_torch.live import corpus

    t0 = time.perf_counter()
    pool = corpus_pool(base)
    bank_s = time.perf_counter() - t0
    minimal = [e["minimal"]["n_ops"] for e in pool if e.get("minimal")]
    _zero_counts()
    out = corpus.corpus_replay(corpus.corpus_dir(base), device="cuda")
    single, grid = _read_counts()
    direct = sum(1 for e in out["engines"]
                 if e["direct"] == "device-bfs(cuda)")
    bucketed = sum(1 for e in out["engines"]
                   if e["bucketed"] == "device-batch(cuda)")
    emit(f"corpus: {len(pool)} entries banked in {bank_s:.3f} s "
         f"({sum(e['routes'] == 'engines' for e in pool)} engine, "
         f"{sum(e['routes'] == 'queue' for e in pool)} queue; banked "
         f"verdicts {[e['valid'] for e in pool]}; minimal repros of "
         f"{minimal} ops); replayed in {out['seconds']} s: failures "
         f"{out['failures']}, unknown route verdicts {out['unknowns']}, "
         f"prepass-decided {out['hb_decided']}; past the greedy witness "
         f"and the prepass to B1: {direct} of {len(out['engines'])} on the "
         f"direct route, {bucketed} on the bucketed one; B1 launches "
         f"single={single} grid={grid}")
    check(out["ok"] and out["entries"] == len(pool),
          f"corpus: {out['failures']}")
    check(minimal, "corpus: no entry got a minimal repro")
    check(direct > 0 and bucketed > 0 and single > 0 and grid > 0,
          f"corpus: B1 on the direct route {direct} times, the bucketed "
          f"{bucketed}; launches single={single} grid={grid}")
    return {"corpus": {"grid": grid, "single": single}}


#: the fuzz phase's (first seed, rounds) per model at the fuzzer's
#: default size (60 ops, 4 processes), the audit on: B1's three models
#: and the two queues (the torch step).  On the card cas-register's
#: seed 50 is the first to climb past F=2048 into the torch step (to
#: F=4096; the phase prints the seed), so its rounds run seeds 0-59
FUZZ_PLAN = {"cas-register": (0, 60), "register": (0, 60),
             "mutex": (0, 60), "unordered-queue": (0, 20),
             "fifo-queue": (0, 20)}
#: the command-line child: cas-register rounds from the seed after the
#: in-process ones
FUZZ_CLI = ("--model", "cas-register", "--rounds", "8", "--seed", "60",
            "--audit")
#: B1's widest frontier (``level_kernel.eligible``: F <= 2048)
FUZZ_B1_MAX_F = 2048


@_timed_phase("fuzz")
def phase_fuzz(base):
    """The differential fuzzer on the card: ``fuzz(model, audit=True,
    device="cuda")`` for each of the five models (:data:`FUZZ_PLAN`),
    the device leg on B1-T up to F=2048 and the torch step past it and
    for the queues, held to the host oracle and the linear sweep with
    every certificate audited; no divergence, no W-code, no round
    skipped as an encode error, B1 launched and one cas-register round
    past F=2048.  Then ``python -m jepsen_tpu_torch.fuzz``
    (:data:`FUZZ_CLI`) in a child process, exit 0 with its clean last
    line.  Returns its launches."""
    from jepsen_tpu_torch.fuzz import fuzz

    t0 = time.perf_counter()
    _zero_counts()
    recs = {m: fuzz(m, rounds=n, seed=seed, n_ops=60, n_procs=4,
                    audit=True, out=None, device="cuda")
            for m, (seed, n) in FUZZ_PLAN.items()}
    single, grid = _read_counts()
    wall = time.perf_counter() - t0
    for m, r in recs.items():
        emit(f"fuzz[{m}]: {r['rounds']} rounds from seed "
             f"{FUZZ_PLAN[m][0]} in {r['seconds']} s, "
             f"divergence {r['divergence']}, W-codes "
             f"{len(r['audit_failures'])}, encode errors "
             f"{r['encode_errors']}; device leg engines "
             f"{dict(sorted(r['engines'].items()))}, widest frontier "
             f"{r['frontier']} (first at seed {r['frontier_seed']})")
    argv = [sys.executable, "-m", "jepsen_tpu_torch.fuzz", *FUZZ_CLI,
            "--device", "cuda", "--out",
            os.path.join(base, "fuzz-repro.json")]
    t0 = time.perf_counter()
    code, out, err = _finish(subprocess.Popen(
        argv, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), timeout=300)
    child_s = time.perf_counter() - t0
    last = out.strip().splitlines()[-1] if out.strip() else ""
    rounds = FUZZ_CLI[FUZZ_CLI.index("--rounds") + 1]
    emit(f"fuzz: in process {wall:.3f} s, B1 launches single={single} "
         f"grid={grid}; child {' '.join(argv[1:])} exit {code} in "
         f"{child_s:.3f} s: {last!r}")
    for m, r in recs.items():
        check(r["rounds"] == FUZZ_PLAN[m][1] and r["divergence"] is None
              and not r["audit_failures"],
              f"fuzz[{m}]: {r['divergence'] or r['audit_failures']}")
        check(r["encode_errors"] == 0
              and sum(r["engines"].values()) == r["rounds"],
              f"fuzz[{m}]: {r['encode_errors']} rounds skipped as encode "
              f"errors, engines {r['engines']}")
    check(single > 0, f"fuzz: B1 single-key launches {single}")
    check(recs["cas-register"]["frontier"] > FUZZ_B1_MAX_F,
          f"fuzz: no cas-register round past F={FUZZ_B1_MAX_F} "
          f"(widest {recs['cas-register']['frontier']})")
    check(code == 0 and last.startswith(
        f"fuzz: {rounds} rounds, no divergence ("),
        f"fuzz: the child exited {code}: {last!r} {err[-2000:]}")
    return {"fuzz": {"grid": grid, "single": single}}


#: B1's grid form fuzzed (:func:`phase_fuzz_grid`): the models, the
#: rungs with the keys stacked at each, batches per (model, rung) and the
#: first seed; each batch's histories from the fuzzer's generator
FUZZ_GRID_MODELS = ("register", "cas-register", "mutex")
FUZZ_GRID_RUNGS = {32: 9, 128: 4, 512: 2}
FUZZ_GRID_ROUNDS = 2
FUZZ_GRID_SEED = 7000


@_timed_phase("fuzz_grid")
def phase_fuzz_grid(device):
    """B1's grid form fuzzed on the card: for each model of
    :data:`FUZZ_GRID_MODELS` and rung of :data:`FUZZ_GRID_RUNGS`,
    :data:`FUZZ_GRID_ROUNDS` batches of random histories from the
    fuzzer's generator (``fuzz.gen_history``: 10 to 60 ops of four
    processes with crashes, every other one corrupted by
    ``fuzz.corrupt``), stacked with pad lanes by the ladder's rule, bail
    on and off by turns, through the grid form (off and telemetry) and
    its plain version slice by slice (:func:`_grid_lockstep_one`); any
    difference fails.  Returns the worst error."""
    from jepsen_tpu_torch.fuzz import MODELS, corrupt, gen_history
    from jepsen_tpu_torch.history import encode_ops

    worst = rounds = 0
    seeds = []
    for name in FUZZ_GRID_MODELS:
        model = MODELS[name]()
        for frontier, n in FUZZ_GRID_RUNGS.items():
            for r in range(FUZZ_GRID_ROUNDS):
                seed = FUZZ_GRID_SEED + len(seeds)
                seeds.append(seed)
                rng = random.Random(seed)
                seqs = []
                for _ in range(n):
                    h = gen_history(rng, name, rng.randint(10, 60), 4, 0.05)
                    if rng.random() < 0.5:
                        h = corrupt(rng, h)
                    seqs.append(encode_ops(h, model.f_codes))
                dims, args, carry = grid_setup(model, seqs, frontier, device,
                                               lanes=_ladder_lanes(n))
                err, *_ = _grid_lockstep_one(
                    f"fuzz[{name},F={frontier},seed={seed}]", model, dims,
                    args, carry, r % 2 == 0, 4, 16, n)
                worst = max(worst, err)
                rounds += 1
    emit(f"fuzz_grid: {rounds} batches of "
         f"{dict(FUZZ_GRID_RUNGS)} keys by rung, models "
         f"{list(FUZZ_GRID_MODELS)}, seeds {seeds[0]}..{seeds[-1]}: every "
         f"batch identical to the plain version after every slice, off "
         f"and telemetry forms; max abs err {worst}")
    return worst


@_timed_phase("report")
def phase_report(trace):
    """The shard tier's trace folded by ``obs/report.py``: its device
    share and idle, and ``python -m jepsen_tpu_torch.obs report <trace>
    --json`` printing the same dict."""
    from jepsen_tpu_torch.obs.report import load_trace, phase_table

    rep = phase_table(load_trace(trace))
    dev = next((p for p in rep["phases"] if p["cat"] == "device"), None)
    check(dev is not None and rep["wall_s"] > 0,
          f"report: no device phase in {rep['phases']}")
    p = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch.obs",
                        "report", trace, "--json"], cwd=str(REPO),
                       capture_output=True, text=True, timeout=300)
    check(p.returncode == 0 and json.loads(p.stdout) == rep,
          f"report: the command exited {p.returncode}: {p.stderr[-2000:]}")
    tele = rep.get("telemetry", {})
    emit(f"report[shard_tier]: wall {rep['wall_s']} s, device busy "
         f"{dev['busy_s']} s ({dev['pct']}% of the wall), idle "
         f"{rep['idle_s']} s ({rep['idle_pct']}%); phases "
         f"{[(x['cat'], x['spans'], x['busy_s']) for x in rep['phases']]}; "
         f"compiles {tele.get('compiles')}; the command's JSON equal: True")


#: the model checker's sweep, ``python -m jepsen_tpu.analyze --mc
#: --mc-scope all``: each family/mode's ``explored`` block
#: (:data:`MC_SWEEP_KEYS`) in the JAX package's run (held to it by
#: ``tests/test_torch_modelcheck.py``)
MC_SWEEP_KEYS = ("states", "schedules", "events", "sleep_prunes", "dedup",
                 "prune_ratio", "complete")
MC_SWEEP = {
    "replicated/clean": (492, 570, 1824, 27, 763, 0.0146, True),
    "replicated/volatile": (498, 605, 1836, 33, 734, 0.0177, True),
    "replicated/split-brain": (154, 399, 794, 128, 229, 0.1388, False),
    "rqueue/clean": (660, 948, 2369, 97, 762, 0.0393, True),
    "rqueue/volatile": (660, 969, 2369, 97, 741, 0.0393, True),
    "lock/clean": (39, 5, 52, 12, 9, 0.1875, True),
    "lock/volatile": (36, 7, 49, 12, 7, 0.1967, True),
    "shell-kv/clean": (17, 5, 22, 4, 1, 0.1538, True),
    "shell-kv/volatile": (16, 7, 22, 3, 0, 0.12, True),
    "shell-queue/clean": (211, 80, 353, 36, 63, 0.0925, True),
    "shell-queue/volatile": (154, 84, 268, 13, 31, 0.0463, True),
    "shell-queue/session-leak": (213, 80, 356, 36, 64, 0.0918, True),
    "shell-replicated/clean": (226, 51, 364, 494, 88, 0.5758, True),
    "shell-replicated/proxy-loop": (387, 215, 805, 403, 204, 0.3336, True),
    "shell-replicated/stale-proxy": (211, 115, 387, 433, 62, 0.528, True),
    "shell-rqueue/clean": (17, 5, 22, 4, 1, 0.1538, True),
    "shell-rqueue/volatile": (13, 9, 21, 0, 0, 0.0, True),
}


def _analyze_cli(*args) -> subprocess.Popen:
    """``python -m jepsen_tpu_torch.analyze ARGS...``, started."""
    return subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.analyze", *map(str, args)],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(proc, timeout=600) -> tuple:
    """(exit code, stdout, stderr) of a started command."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


@_timed_phase("mc")
def phase_mc(base):
    """The bounded model checker and the card.  ``python -m
    jepsen_tpu_torch.analyze --mc --mc-scope all --json --mc-bank`` must
    exit 0 with 17 runs whose ``explored`` blocks are :data:`MC_SWEEP`,
    every clean mode violation-free, every seeded mode caught, every
    certificate replayed and confirmed (the engine invalid, the audit
    clean; MC203 on its ``loop`` route).  The deeper matrix (depth 7, or
    the default where deeper) runs in process with the same
    expectations, and ``--mc --replay`` reproduces one certificate.
    Last, the banked certificates replay through every route on the
    card (``corpus_replay(device="cuda")``): the routes agree on every
    entry, and the only failures against a banked verdict are the JAX
    package's MC201 bank fault.  Returns that replay's launches."""
    from jepsen_tpu_torch.analyze import modelcheck as mc
    from jepsen_tpu_torch.history import Op
    from jepsen_tpu_torch.live import corpus

    bank = os.path.join(base, "mc")
    t0 = time.perf_counter()
    rc, out, err = _finish(_analyze_cli("--mc", "--mc-scope", "all",
                                        "--json", "--mc-bank", bank))
    sweep_s = time.perf_counter() - t0
    check(rc == 0, f"mc: the sweep exited {rc}: {err[-2000:]}")
    runs = json.loads(out)["runs"]
    got = {f"{r['family']}/{r['mode']}":
           tuple(r["explored"][k] for k in MC_SWEEP_KEYS) for r in runs}
    check(got == MC_SWEEP, f"mc: explored {got}, the JAX package's "
          f"{MC_SWEEP}")
    certs = [c for r in runs for c in r["violations"]]
    for r in runs:
        check(r["ok"] if r["mode"] == "clean" else not r["ok"],
              f"mc: {r['family']}/{r['mode']} ok={r['ok']}")
    for c in certs:
        conf = c["confirm"]
        check(c["replayed"] and conf["engine_valid"] is False
              and conf["audit_ok"] is True
              and (conf["route"] == "loop") == (c["code"] == "MC203"),
              f"mc: certificate {c['code']} of {c['family']}/{c['mode']}: "
              f"replayed {c['replayed']}, confirm {conf}")
    emit(f"mc[sweep]: {len(runs)} runs in {sweep_s:.3f} s (a process), "
         f"explored equal to the JAX package's; {len(certs)} certificates "
         f"({sorted(collections.Counter(c['code'] for c in certs).items())}"
         f"), {sum(c['banked']['banked'] for c in certs)} banked")

    t0 = time.perf_counter()
    n_deep = 0
    for fam in mc.ALL_FAMILIES:
        for mode in mc.ALL_MODES[fam]:
            depth = max(7, mc.default_scope(fam, mode).max_events)
            scope = mc.scope_from_args(fam, mode, max_events=depth)
            if mode == "clean":
                r = mc.run_mc(fam, mode, scope=scope, dpor=True)
                check(r["ok"] and r["explored"]["complete"],
                      f"mc[deeper]: {fam}/clean {r['explored']}")
            else:
                r = mc.run_mc(fam, mode, scope=scope, dpor=True,
                              shrink=False, confirm=False)
                check(not r["ok"] and all(v["replayed"]
                                          for v in r["violations"]),
                      f"mc[deeper]: {fam}/{mode} not caught")
            n_deep += r["explored"]["states"]
    deep_s = time.perf_counter() - t0

    cert = next(c for c in certs if c["code"] != "MC203")
    cert_path = os.path.join(base, "mc-cert.json")
    with open(cert_path, "w") as f:
        json.dump(cert, f)
    rc, out, err = _finish(_analyze_cli("--mc", "--replay", cert_path))
    check(rc == 0 and "reproduced" in out,
          f"mc: --replay exited {rc}: {out[-500:]} {err[-1000:]}")

    pool = corpus.load_pool(corpus.corpus_dir(bank))
    _zero_counts()
    rep = corpus.corpus_replay(corpus.corpus_dir(bank), device="cuda")
    single, grid = _read_counts()
    direct = sum(1 for e in rep["engines"]
                 if e["direct"] == "device-bfs(cuda)")
    bucketed = sum(1 for e in rep["engines"]
                   if e["bucketed"] == "device-batch(cuda)")
    emit(f"mc[deeper]: {len(mc.ALL_FAMILIES)} families at depth 7 (or "
         f"deeper), {n_deep} states, {deep_s:.3f} s; --replay of "
         f"{cert['code']}: {out.strip()}; the banked pool ({len(pool)} "
         f"entries) replayed on the card in {rep['seconds']} s: failures "
         f"{rep['failures']}, prepass-decided {rep['hb_decided']}; to B1: "
         f"{direct} on the direct route, {bucketed} on the bucketed one; "
         f"B1 launches single={single} grid={grid}")
    # the JAX package banks an MC201 certificate (one job delivered
    # twice) as a total-queue entry expected invalid, while total-queue
    # admits a duplicate delivery: its own replay reports that entry as
    # a regression (ROADMAP.md §C), and the port's pool is the same
    dup = {e["id"][:12] for c in certs if c["code"] == "MC201"
           for e in corpus.entries_from_test(
               {"history": [Op.from_dict(d) for d in c["history"]],
                "model": None},
               {"family": f"mc-{c['family']}", "nemesis": f"mc-{c['mode']}",
                "seeded": True, "valid": False})}
    known = [f for f in rep["failures"] if f.startswith("REGRESSION ")
             and any(f"[{i}]" in f for i in dup)]
    emit(f"mc[replay]: {len(known)} of {len(rep['failures'])} failures "
         f"are the JAX package's MC201 bank fault: {known}")
    check(len(known) == len(rep["failures"]) and rep["entries"] == len(pool),
          f"mc: the corpus replay: {rep['failures']}")
    return {"mc": {"grid": grid, "single": single}}


#: the device the analyze command plans for (the CPU rehearsal sets
#: "cpu")
ANALYZE_DEVICE = "cuda"


def _tampered(result: dict, n_rows: int) -> dict:
    """The result with one step of its certificate corrupted: a row of
    the linearization, or of the blocking frontier, past the history."""
    bad = json.loads(json.dumps(result))
    key = "linearization" if bad.get("linearization") else "final_ops"
    check(bad.get(key), f"analyze_cli: the result has no {key}")
    bad[key][0] = n_rows + 7
    return bad


@_timed_phase("analyze_cli")
def phase_analyze_cli(base, checked):
    """``python -m jepsen_tpu_torch.analyze`` on a history the card
    checked.  ``checked`` is 1k's ``Linearizable(algorithm="device",
    device="cuda")`` result from :func:`phase_main_path` (``main[device]``,
    counted there) and the dims its search started at; the bucketed
    batch (counted here) gives 1k's bucket.  The history is written with
    ``store.write_history`` and the result as JSON.  ``analyze <history>
    --model cas-register --explain --audit <result> --json --device
    cuda`` must exit 0 with a clean audit and a plan whose route, first
    dims and bucket are the live search's; with one step of the
    certificate corrupted it must exit 1 with a W-code.  Returns the
    card's launches."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checker import linearizable as lin

    h, seq, model = tier_events("1k")
    test = {"name": "analyze_cli", "store_base": base,
            "start_time": "run"}
    res, started = checked
    check(res["valid"] is REFERENCE["1k"][0]
          and res["engine"].startswith("device-bfs(") and started,
          f"analyze_cli: 1k gave {res['valid']} by {res['engine']}, "
          f"first dims {started}")
    _zero_counts()
    batch = lin.search_batch([seq], model, device=ANALYZE_DEVICE,
                             bucket=True)[0]
    single, grid = _read_counts()
    hist_path = store.write_history(test, h)
    paths = {}
    for name, r in (("result", res),
                    ("tampered", _tampered(res, len(seq)))):
        paths[name] = store.path_mkdirs(test, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(store._jsonable(r), f)
    t0 = time.perf_counter()
    procs = {name: _analyze_cli(hist_path, "--model", "cas-register",
                                "--explain", "--audit", p, "--json",
                                "--device", ANALYZE_DEVICE)
             for name, p in paths.items()}
    done = {name: _finish(p) for name, p in procs.items()}
    cli_s = time.perf_counter() - t0
    rc, out, err = done["result"]
    check(rc == 0, f"analyze_cli: exited {rc}: {err[-2000:]}")
    rep = json.loads(out)
    plan = rep["plan"]
    live_dims = {k: getattr(started[0], k) for k in plan["search_dims"]}
    bucket = batch["bucket_batch"]["buckets"][0]["dims"]
    check(rep["audit"]["ok"] and rep["errors"] == 0,
          f"analyze_cli: audit {rep['audit']}, errors {rep['errors']}")
    check(plan["engine"] == "device-bfs" and live_dims == plan["search_dims"]
          and bucket == plan["bucket"],
          f"analyze_cli: planned {plan['engine']} {plan['search_dims']} "
          f"{plan['bucket']}, ran {res['engine']} from {live_dims}, bucket "
          f"{bucket}")
    rc_bad, out_bad, err_bad = done["tampered"]
    bad = json.loads(out_bad) if out_bad.strip() else {}
    codes = bad.get("audit", {}).get("codes", [])
    emit(f"analyze_cli: 1k as main[device] checked it on the card "
         f"(valid={res['valid']} engine={res['engine']} "
         f"configs={res['configs']}); the bucketed batch's B1 launches "
         f"single={single} grid={grid}; the command (two processes at once) {cli_s:.3f} s: "
         f"exit {rc}, audit {rep['audit']['checked']} ok, plan "
         f"{plan['engine']} {plan['search_dims']} bucket {plan['bucket']} "
         f"= the live search's; tampered: exit {rc_bad}, codes {codes}")
    check(rc_bad == 1 and codes and all(c.startswith("W") for c in codes),
          f"analyze_cli: the tampered result exited {rc_bad}, codes "
          f"{codes}: {err_bad[-1000:]}")
    return {"analyze_cli": {"grid": grid, "single": single}}


#: ``phase_live``: the kv daemon's run (16 clients, 1,000 read/write/cas
#: ops on one key at 200 ops/s in all, values 1 to 5, no fault during
#: the traffic; the rate keeps the history's window, the ops invoked
#: while one is open, inside B1's 64 lanes: at 1,429 ops/s a stall of a
#: tenth of a second opened a window of 160) and the
#: replicated cluster's (the JAX package's replicated kill-restart cell,
#: ``jepsen_tpu/live/campaign.py:59-64``, without its seeded volatile
#: mode: 3 replicas, lease 400 ms, 4 clients at 20 ops/s in all for 12
#: s, reads weighted 4, a SIGKILL every 2 s.  The kills alternate: the
#: current leader, restarted at once, and the whole cluster, the cell's
#: ``kill_all``, the power failure clean replicas survive from the
#: shared oplog alone, down for ``down_s`` as in the JAX package's
#: kill-restart cadence, ``jepsen_tpu/live/matrix.py:112-113``, then
#: restarted)
LIVE_KV = dict(clients=16, ops=1000, rate=200.0, values=(1, 2, 3, 4, 5))
LIVE_REPLICATED = dict(nodes=3, lease_ms=400, clients=4, rate=20.0,
                       seconds=12.0, read_weight=4, kill_every=2.0,
                       down_s=0.7, values=(1, 2, 3, 4, 5))
#: how a read of the unset key (404) renders: the model's initial value,
#: as the JAX package's live client renders it (``backend.py:499``)
LIVE_MISSING = -1
#: the live client's request timeout (the JAX package's V2Client's)
LIVE_TIMEOUT_S = 2.0
#: how long one connection attempt waits for the handshake before the
#: client tries again (the kernel's own SYN retry waits a second)
LIVE_SYN_S = 0.05


def _free_port() -> int:
    """An ephemeral port the kernel hands out now (bound and closed)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_port(port, proc, deadline_s=20.0) -> None:
    import socket

    deadline = time.monotonic() + deadline_s
    while True:
        check(proc.poll() is None,
              f"live: the daemon on port {port} exited {proc.returncode}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            check(time.monotonic() < deadline,
                  f"live: nothing listens on port {port}")
            time.sleep(0.05)


def _spawn_daemon(module, port, *args):
    """``python -m jepsen_tpu_torch.live.<module> PORT ARGS...``, once it
    accepts connections."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"jepsen_tpu_torch.live.{module}",
         str(port), *map(str, args)], cwd=str(REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        _wait_port(port, proc)
    except SmokeFailure:
        _kill9(proc)
        raise
    return proc


def _kill9(proc) -> None:
    import signal

    if proc.poll() is None:
        os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=10)


def _connect(port):
    """An HTTP connection to ``port``.  Each attempt waits
    :data:`LIVE_SYN_S` for the handshake and a dropped SYN is retried at
    once, up to :data:`LIVE_TIMEOUT_S` in all (nothing is sent yet, so
    the op is not in flight): the daemons' listen backlog is the
    standard library's 5, and under a burst of new connections the
    kernel's own SYN retry would hold an op open for a second."""
    import http.client

    deadline = time.monotonic() + LIVE_TIMEOUT_S
    while True:
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=LIVE_SYN_S)
        try:
            conn.connect()
        except TimeoutError:
            conn.close()
            if time.monotonic() > deadline:
                raise
            continue
        conn.sock.settimeout(LIVE_TIMEOUT_S)
        return conn


def _kv_request(port, f, value, key="x"):
    """One etcd-v2 request on its own connection, as ``urllib`` makes
    it: ``(type, value)`` of the op's completion.  2xx is ok (a 404
    read is ok with :data:`LIVE_MISSING`), 503 and a refused connection
    fail (nothing was applied), a failed compare (412, or 404 on a
    missing key) fails, and 504 or any other transport error (a
    timeout, a reset) is info."""
    import http.client
    import urllib.parse

    path = f"/v2/keys/{key}"
    body, headers = None, {"Connection": "close"}
    if f != "read":
        new = value if f == "write" else value[1]
        if f == "cas":
            path += "?" + urllib.parse.urlencode({"prevValue": value[0]})
        body = urllib.parse.urlencode({"value": new}).encode()
        headers["Content-Type"] = "application/x-www-form-urlencoded"
    try:
        conn = _connect(port)
    except ConnectionRefusedError:
        return "fail", value
    except OSError:
        return "info", value
    try:
        conn.request("GET" if f == "read" else "PUT", path, body=body,
                     headers=headers)
        r = conn.getresponse()
        status, out = r.status, json.loads(r.read() or b"{}")
    except (OSError, http.client.HTTPException, ValueError):
        return "info", value
    finally:
        conn.close()
    if 200 <= status < 300:
        return ("ok", int(out["node"]["value"])) if f == "read" \
            else ("ok", value)
    if f == "read" and status == 404:
        return "ok", LIVE_MISSING
    return ("info" if status == 504 else "fail"), value


def _live_clients(ports, n_clients, n_ops, values, *, rate=None,
                  seconds=None, read_weight=1, seed=0):
    """Start ``n_clients`` threads of read/write/cas on one key (client i
    on ``ports[i % len(ports)]``) that run until ``n_ops`` ops have been
    invoked or ``seconds`` have passed, ``rate`` ops/s in all.  An info
    op retires its process (the next op takes a fresh one, as a Jepsen
    worker does).  Returns what :func:`_join_clients` takes."""
    import threading

    from jepsen_tpu_torch.history import Op

    lock = threading.Lock()
    events: list = []
    issued = [0]
    t_end = None if seconds is None else time.monotonic() + seconds
    mix = ["read"] * read_weight + ["write", "cas"]

    def record(proc, typ, f, value):
        with lock:
            events.append(Op(process=proc, type=typ, f=f, value=value,
                             time=time.monotonic_ns()))

    def worker(i):
        rng = random.Random(f"live-{seed}-{i}")
        proc = i
        while True:
            if rate:
                time.sleep(rng.uniform(0, 2 * n_clients / rate))
            with lock:
                if (n_ops is not None and issued[0] >= n_ops) or (
                        t_end is not None and time.monotonic() >= t_end):
                    return
                issued[0] += 1
            f = rng.choice(mix)
            value = (None if f == "read" else rng.choice(values)
                     if f == "write" else [rng.choice(values),
                                           rng.choice(values)])
            record(proc, "invoke", f, value)
            typ, got = _kv_request(ports[i % len(ports)], f, value)
            record(proc, typ, f, got if typ == "ok" else value)
            if typ == "info":
                proc += n_clients

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n_clients)]
    for th in threads:
        th.start()
    return threads, events, lock


def _join_clients(threads, events, lock) -> list:
    for th in threads:
        th.join()
    with lock:
        return sorted(events, key=lambda op: op.time)


def _live_check(label, history, model, store_base) -> dict:
    """One live history checked on the card (``algorithm="device"``,
    counted) and by the host engine on the CPU: the verdicts must agree
    and be valid.  Both ``configs`` print; they count different things
    (the card's breadth-first configurations, the host WGL's cache
    entries), so they are not compared."""
    from jepsen_tpu_torch.checker import linearizable as lin

    test = {"name": f"live-{label}", "store_base": store_base}
    _zero_counts()
    t0 = time.perf_counter()
    dev = lin.linearizable(model, algorithm="device",
                           device="cuda").check(test, history)
    dev_s = time.perf_counter() - t0
    single, grid = _read_counts()
    t0 = time.perf_counter()
    host = lin.linearizable(model, algorithm="host",
                            device="cpu").check(test, history)
    host_s = time.perf_counter() - t0
    types = collections.Counter(op.type for op in history)
    emit(f"live[{label}]: {len(history)} events ({dict(types)}); the card: "
         f"valid={dev['valid']} configs={dev['configs']} "
         f"engine={dev['engine']} {dev_s:.3f} s, B1 launches "
         f"single={single} grid={grid}; the host engine: "
         f"valid={host['valid']} configs={host['configs']} "
         f"engine={host['engine']} {host_s:.3f} s")
    check(dev["valid"] == host["valid"],
          f"live[{label}]: the card {dev['valid']}, the host "
          f"{host['valid']}")
    check(dev["valid"] is True, f"live[{label}]: {dev['valid']}")
    return {"grid": grid, "single": single}


def _live_kv(base) -> list:
    """``live[kv]``: one durable kv daemon under :data:`LIVE_KV`'s
    traffic, then a read, SIGKILL, a restart on the same data and a read
    back (every acked write survives: the value read before the kill is
    read after it).  Returns the history."""
    from jepsen_tpu_torch.history import Op

    port, data = _free_port(), os.path.join(base, "kv")
    proc = _spawn_daemon("kv_server", port, data)
    try:
        t0 = time.perf_counter()
        h = _join_clients(*_live_clients(
            [port], LIVE_KV["clients"], LIVE_KV["ops"], LIVE_KV["values"],
            rate=LIVE_KV["rate"]))
        wall = time.perf_counter() - t0
        reads = []
        # above every process a worker can have reached
        top = max(op.process for op in h)
        for _ in range(2):
            p = top + 1 + len(reads)
            h.append(Op(p, "invoke", "read", None, time=time.monotonic_ns()))
            typ, got = _kv_request(port, "read", None)
            check(typ == "ok", f"live[kv]: the read back was {typ}")
            h.append(Op(p, "ok", "read", got, time=time.monotonic_ns()))
            reads.append(got)
            if len(reads) == 1:
                _kill9(proc)
                proc = _spawn_daemon("kv_server", port, data)
    finally:
        _kill9(proc)
    acked = sum(1 for op in h if op.type == "ok" and op.f != "read")
    emit(f"live[kv]: {LIVE_KV['ops']} ops from {LIVE_KV['clients']} "
         f"clients in {wall:.3f} s ({LIVE_KV['ops'] / wall:.1f} ops/s), "
         f"{acked} acked writes; read {reads[0]} before SIGKILL, "
         f"{reads[1]} after the restart")
    check(reads[0] == reads[1], f"live[kv]: read {reads[0]} before the "
          f"kill and {reads[1]} after it")
    return h


def _repl_leader(ports):
    from jepsen_tpu_torch.live.replicated_server import http_json

    leaders = []
    for i, port in enumerate(ports):
        try:
            _st, out = http_json("127.0.0.1", port, "/_repl/status",
                                 timeout=0.5)
            if out.get("role") == "leader":
                leaders.append(i)
        except OSError:
            pass
    return leaders[0] if len(leaders) == 1 else None


def _live_replicated(base) -> tuple:
    """``live[replicated]``: three clean replicas over one shared oplog
    under :data:`LIVE_REPLICATED`'s traffic, a SIGKILL every
    ``kill_every`` seconds, alternately of the leader (restarted at
    once) and of the whole cluster (restarted after ``down_s``).
    Returns (history, kills): the leader's index, ``"all"``, or None
    where there was no single leader to kill."""
    cfg = LIVE_REPLICATED
    ports = [_free_port() for _ in range(cfg["nodes"])]
    oplog = os.path.join(base, "replicated", "shared", "oplog")

    def start(i):
        return _spawn_daemon(
            "replicated_server", ports[i],
            os.path.join(base, "replicated", f"n{i}"), "--id", i,
            "--peers", ",".join(map(str, ports)), "--oplog", oplog,
            "--lease-ms", cfg["lease_ms"])

    procs, kills = [], []
    try:
        for i in range(cfg["nodes"]):
            procs.append(start(i))
        deadline = time.monotonic() + 20
        while _repl_leader(ports) is None:
            check(time.monotonic() < deadline, "live[replicated]: no "
                  "single leader within 20 s")
            time.sleep(0.05)
        t0 = time.perf_counter()
        running = _live_clients(ports, cfg["clients"], None, cfg["values"],
                                rate=cfg["rate"], seconds=cfg["seconds"],
                                read_weight=cfg["read_weight"], seed=1)
        for k in range(1, round(cfg["seconds"] / cfg["kill_every"])):
            time.sleep(max(0.0, t0 + k * cfg["kill_every"]
                           - time.perf_counter()))
            if k % 2 == 0:
                for p in procs:
                    _kill9(p)
                time.sleep(cfg["down_s"])
                for i in range(cfg["nodes"]):
                    procs[i] = start(i)
                kills.append("all")
                continue
            lead = _repl_leader(ports)
            if lead is None:
                kills.append(None)
                continue
            _kill9(procs[lead])
            procs[lead] = start(lead)
            kills.append(lead)
        h = _join_clients(*running)
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            _kill9(p)
    emit(f"live[replicated]: {sum(op.type == 'invoke' for op in h)} ops "
         f"from {cfg['clients']} clients in {wall:.3f} s; SIGKILL at each "
         f"{cfg['kill_every']} s, alternately of the leader and of the "
         f"whole cluster (down {cfg['down_s']} s): {kills} (None: no "
         f"single leader then)")
    return h, kills


@_timed_phase("live")
def phase_live(base):
    """The port's daemons as real processes on ephemeral ports, driven
    by this script's client (:func:`_kv_request`): ``live[kv]``
    (:func:`_live_kv`) and ``live[replicated]``
    (:func:`_live_replicated`).  Each history is checked on the card
    with ``algorithm="device"`` and by the host engine on the CPU
    (:func:`_live_check`).  Returns the card checks' launches."""
    from jepsen_tpu_torch.models import cas_register

    model = cas_register(LIVE_MISSING)
    kv = _live_kv(base)
    launches = collections.Counter(_live_check("kv", kv, model, base))
    repl, _kills = _live_replicated(base)
    launches.update(_live_check("replicated", repl, model, base))
    check(launches["single"] + launches["grid"] > 0,
          "live: B1 never launched")
    return {"live": dict(launches)}


# ---------------------------------------------------------------------------
# the checker library and the device contract
# ---------------------------------------------------------------------------

#: the stored batch256 test's name and start time (the one field a clock
#: would set is pinned: the run dir is the same in every run)
CHECKERS_TEST = {"name": "checkers-batch256", "start_time": "20260101T000000"}

#: ms between the stored batch256 test's events (the timeline and perf
#: graphs read event times)
CHECKERS_EVENT_MS = 1


class _BankCursor:
    """An in-memory DB-API cursor over one ``accounts`` table: the
    statements ``bank.sql_bank_body`` sends, in place or not."""

    def __init__(self, n: int, total: int):
        self.bal = {i: total // n + (i < total % n) for i in range(n)}
        self._rows: list = []

    def execute(self, sql, params=()):
        if sql.startswith("select id, balance"):
            self._rows = sorted(self.bal.items())
        elif sql.startswith("select balance"):
            self._rows = [(self.bal[params[0]],)]
        elif "balance - %s" in sql:
            self.bal[params[1]] -= params[0]
        elif "balance + %s" in sql:
            self.bal[params[1]] += params[0]
        else:  # update accounts set balance = %s where id = %s
            self.bal[params[1]] = params[0]

    def fetchall(self):
        return list(self._rows)

    def fetchone(self):
        return self._rows[0]


def _bank_history(seed, *, n=5, total=100, n_ops=40, corrupt=False):
    """A bank workload from the port's ``bank`` generators and
    transaction body on :class:`_BankCursor`: one op at a time by 4
    processes; ``corrupt`` adds 5 to one read's first balance."""
    from jepsen_tpu_torch import bank
    from jepsen_tpu_torch.history import Op

    random.seed(seed)  # bank_transfer draws from the module generator
    rng = random.Random(seed)
    cur = _BankCursor(n, total)
    transfer = bank.bank_transfer(n)
    h = []
    for i in range(n_ops):
        p = rng.randrange(4)
        gen = bank.bank_read if rng.random() < 0.4 else transfer
        op = Op(process=p, **gen({}, p))
        h += [op, bank.sql_bank_body(cur, op, n, in_place=bool(i % 2))]
    if corrupt:
        i = next(i for i, op in enumerate(h)
                 if op.type == "ok" and op.f == "read")
        h[i] = replace(h[i], value={**h[i].value, 0: h[i].value[0] + 5})
    return h


def _ops(*specs):
    """``(type, process, f, value)`` tuples as port Ops."""
    from jepsen_tpu_torch.history import Op

    return [Op(process=p, type=t, f=f, value=v) for t, p, f, v in specs]


def _counter_history(seed, *, corrupt=False):
    """Concurrent adds and reads of a counter, each read's value between
    the ok adds before its invoke and the attempted adds before its
    completion; ``corrupt`` makes one read too high."""
    rng = random.Random(seed)
    lower = upper = 0
    spec, open_ = [], {}
    for _ in range(60):
        p = rng.randrange(4)
        if p in open_:
            f, v, lo = open_.pop(p)
            if f == "add":
                lower += v
                spec.append(("ok", p, "add", v))
            else:
                spec.append(("ok", p, "read", rng.randint(lo, upper)))
        elif rng.random() < 0.6:
            v = rng.randint(1, 5)
            upper += v
            open_[p] = ("add", v, 0)
            spec.append(("invoke", p, "add", v))
        else:
            open_[p] = ("read", None, lower)
            spec.append(("invoke", p, "read", None))
    if corrupt:
        i = max(i for i, s in enumerate(spec)
                if s[0] == "ok" and s[2] == "read")
        spec[i] = spec[i][:3] + (upper + 9,)
    return _ops(*spec)


def _monotonic_history(seed, *, corrupt=False):
    """Twelve adds, then a final read of every row (two rows swapped
    with ``corrupt``)."""
    rng = random.Random(seed)
    spec, rows = [], []
    for v in range(12):
        p = rng.randrange(3)
        spec += [("invoke", p, "add", {"val": v}),
                 ("ok", p, "add", {"val": v})]
        rows.append({"val": v, "sts": 10 * v, "proc": p,
                     "node": f"n{rng.randrange(3)}", "tb": v % 2})
    if corrupt:
        rows[3], rows[7] = rows[7], rows[3]
    return _ops(*spec, ("invoke", 3, "read", None), ("ok", 3, "read", rows))


def _schedule_history(seed, *, corrupt=False):
    """Three jobs of 4 runs each (one missing with ``corrupt``), read
    back at 400 s."""
    from jepsen_tpu_torch.history import invoke_op, ok_op

    rng = random.Random(seed)
    jobs, runs, spec = [], [], []
    for j in range(3):
        job = {"name": str(j), "start": 100.0 + j, "interval": 60,
               "count": 4, "epsilon": 10, "duration": 5}
        jobs.append(job)
        spec += [("invoke", 0, "add-job", job), ("ok", 0, "add-job", job)]
        for i in range(4):
            if corrupt and (j, i) == (1, 2):
                continue
            s = job["start"] + 60 * i + rng.randint(0, 12)
            runs.append({"name": str(j), "start": s, "end": s + 5})
    return _ops(*spec) + [invoke_op(0, "read", None, time=int(400e9)),
                ok_op(0, "read", runs, time=int(400e9))]


def checker_histories():
    """name -> (checker, test map, history): a seeded history for each
    checker of the library, made with the port's ``synth``, ``bank`` and
    simple generators at the sizes of the JAX package's own tests (one
    queue history of 200 ops for ``queue_linearizable``, with crashed
    ops, so that neither the prepass nor the greedy witness decides it
    and the race's device leg runs a slice).  ``checker``
    names a factory and its arguments (:func:`make_checker`)."""
    from jepsen_tpu_torch.history import invoke_op, ok_op
    from jepsen_tpu_torch.synth import (corrupt_dequeue, sim_queue_history,
                                        swap_dequeues)

    def queue_h(seed, fifo=False):
        return sim_queue_history(random.Random(seed), 40, 4, fifo=fifo)

    def drained(h):
        left = [o.value for o in h if o.type == "ok" and o.f == "enqueue"]
        for o in h:
            if o.type == "ok" and o.f == "dequeue":
                left.remove(o.value)
        return h + [invoke_op(9, "drain", None), ok_op(9, "drain", left)]

    def ids(seed, dup):
        rng = random.Random(seed)
        vals = rng.sample(range(1000), 30)
        if dup:
            vals[20] = vals[4]
        return _ops(*[s for i, v in enumerate(vals) for s in (
            ("invoke", i % 4, "generate", None), ("ok", i % 4, "generate", v))])

    def g2(seed, twice):
        rng = random.Random(seed)
        spec = []
        for k in range(10):
            a, b = rng.sample(range(4), 2)
            spec += [("invoke", a, "insert", (k, (1, None))),
                     ("ok", a, "insert", (k, (1, None))),
                     ("invoke", b, "insert", (k, (None, 2))),
                     ("ok" if twice and k == 6 else "fail", b, "insert",
                      (k, (None, 2)))]
        return _ops(*spec)

    def seq_reads(bad):
        spec = []
        for k in range(8):
            vec = [f"{k}_1", f"{k}_0"] if k % 2 else [None, f"{k}_0"]
            if bad and k == 5:
                vec = [f"{k}_1", None]
            spec += [("invoke", k % 3, "read", None),
                     ("ok", k % 3, "read", (k, vec))]
        return _ops(*spec)

    def dirty(bad):
        spec = [("invoke", 0, "write", 1), ("ok", 0, "write", 1),
                ("invoke", 1, "write", 2), ("fail", 1, "write", 2),
                ("invoke", 0, "write", 3), ("ok", 0, "write", 3),
                ("invoke", 2, "read", None), ("ok", 2, "read", [1, 1, 1]),
                ("invoke", 3, "read", None), ("ok", 3, "read", [1, 3, 1])]
        if bad:
            spec += [("invoke", 2, "read", None),
                     ("ok", 2, "read", [2, 2, 2])]
        return _ops(*spec)

    def strong(bad):
        spec = [("invoke", 0, "write", 1), ("ok", 0, "write", 1),
                ("invoke", 1, "write", 2), ("ok", 1, "write", 2),
                ("invoke", 2, "read", 1), ("ok", 2, "read", 1),
                ("invoke", 3, "read", 2), ("ok", 3, "read", 2)]
        if bad:
            spec += [("invoke", 2, "read", 9), ("ok", 2, "read", 9)]
        spec += [("invoke", p, "strong-read", None) for p in range(2)]
        spec += [("ok", p, "strong-read", [1, 2]) for p in range(2)]
        return _ops(*spec)

    q = queue_h("chk-queue")
    return {
        "queue/valid": (("checker.basic", "queue"), {}, q),
        "queue/invalid": (("checker.basic", "queue"), {},
                          corrupt_dequeue(random.Random(1), q)),
        "queue/fifo": (("checker.basic", "queue", "FIFOQueue"), {},
                       swap_dequeues(random.Random(2),
                                     queue_h("chk-fifo", fifo=True))),
        "total_queue/valid": (("checker.basic", "total_queue"), {},
                              drained(queue_h("chk-total"))),
        "total_queue/invalid": (("checker.basic", "total_queue"), {},
                                drained(queue_h("chk-total"))[:-1]),
        "unique_ids/valid": (("checker.basic", "unique_ids"), {},
                             ids("chk-ids", False)),
        "unique_ids/invalid": (("checker.basic", "unique_ids"), {},
                               ids("chk-ids", True)),
        "counter/valid": (("checker.basic", "counter"), {},
                          _counter_history("chk-counter")),
        "counter/invalid": (("checker.basic", "counter"), {},
                            _counter_history("chk-counter", corrupt=True)),
        "bank/valid": (("checker.basic", "bank"), {"total_amount": 100},
                       _bank_history("chk-bank")),
        "bank/invalid": (("checker.basic", "bank"), {"total_amount": 100},
                         _bank_history("chk-bank", corrupt=True)),
        "g2/valid": (("checker.basic", "g2"), {}, g2("chk-g2", False)),
        "g2/invalid": (("checker.basic", "g2"), {}, g2("chk-g2", True)),
        "sequential/valid": (("checker.extra", "sequential"),
                             {"key_count": 2}, seq_reads(False)),
        "sequential/invalid": (("checker.extra", "sequential"),
                               {"key_count": 2}, seq_reads(True)),
        "monotonic/valid": (("checker.extra", "monotonic"), {},
                            _monotonic_history("chk-mono")),
        "monotonic/invalid": (("checker.extra", "monotonic"), {},
                              _monotonic_history("chk-mono", corrupt=True)),
        "dirty_reads/valid": (("checker.dirty", "dirty_reads"), {},
                              dirty(False)),
        "dirty_reads/invalid": (("checker.dirty", "dirty_reads"), {},
                                dirty(True)),
        "strong_dirty_read/valid": (("checker.dirty", "strong_dirty_read"),
                                    {}, strong(False)),
        "strong_dirty_read/invalid": (("checker.dirty",
                                       "strong_dirty_read"), {}, strong(True)),
        "schedule/valid": (("checker.schedule", "schedule_checker"),
                           {"start_wall_time": 0},
                           _schedule_history("chk-sched")),
        "schedule/invalid": (("checker.schedule", "schedule_checker"),
                             {"start_wall_time": 0},
                             _schedule_history("chk-sched", corrupt=True)),
        "concurrency_limit/valid": (("checker.core", "concurrency_limit"),
                                    {}, _counter_history("chk-limit")),
        "concurrency_limit/invalid": (
            ("checker.core", "concurrency_limit"), {},
            _counter_history("chk-limit", corrupt=True)),
        "queue_linearizable/valid": (
            ("checker.basic", "queue_linearizable"), {},
            sim_queue_history(random.Random("chk-queue-linear-2"), 200, 8,
                              crash_p=0.01)),
    }


def port_module(name):
    """The port's module ``name`` (dotted, below the package)."""
    import importlib

    return importlib.import_module(f"jepsen_tpu_torch.{name}")


def make_checker(spec, mod=port_module, **kw):
    """The checker a :func:`checker_histories` entry names, its modules
    from ``mod`` (a module name -> module function; the port's by
    default): ``(module, factory)``, ``(module, "queue", model
    class)``; ``concurrency_limit`` wraps the counter checker (2 at
    once, plot off for the schedule checker); ``kw`` reach
    ``queue_linearizable``."""
    m = mod(spec[0])
    if spec[1] == "queue" and len(spec) > 2:
        return m.queue(getattr(m, spec[2])())
    if spec[1] == "concurrency_limit":
        return m.concurrency_limit(2, mod("checker.basic").counter())
    if spec[1] == "schedule_checker":
        return m.schedule_checker(plot=False)
    return getattr(m, spec[1])(**kw)


def queue_linear_device_leg(base, *, device="cuda"):
    """``queue_linearizable``'s own path on its :func:`checker_histories`
    entry, with its ``Linearizable`` held to ``algorithm="device"`` (the
    default race may end on the host WGL before the device steps):
    (result, the torch step's slices by device, slice functions
    requested)."""
    from jepsen_tpu_torch.checker import linearizable as lin

    spec, tmap, h = checker_histories()["queue_linearizable/valid"]
    saved = lin.Linearizable

    class _DeviceLeg(saved):
        def __init__(self, model=None, **kw):
            super().__init__(model, algorithm="device", **kw)

    lin.Linearizable = _DeviceLeg
    try:
        with _StepTrace() as steps:
            before = sum(lin.KERNEL_CACHE_STATS.values())
            out = make_checker(spec, device=device).check(
                {**tmap, "store_base": base}, h, {})
            requests = sum(lin.KERNEL_CACHE_STATS.values()) - before
    finally:
        lin.Linearizable = saved
    return out, dict(steps.slices), requests


#: the JAX package's verdict on each :func:`checker_histories` entry
#: (recomputed by tests/test_torch_smoke_reference.py)
CHECKERS_REFERENCE = {
    "queue/valid": True, "queue/invalid": False, "queue/fifo": False,
    "total_queue/valid": True, "total_queue/invalid": False,
    "unique_ids/valid": True, "unique_ids/invalid": False,
    "counter/valid": True, "counter/invalid": False,
    "bank/valid": True, "bank/invalid": False,
    "g2/valid": True, "g2/invalid": False,
    "sequential/valid": True, "sequential/invalid": False,
    "monotonic/valid": True, "monotonic/invalid": False,
    "dirty_reads/valid": True, "dirty_reads/invalid": False,
    "strong_dirty_read/valid": True, "strong_dirty_read/invalid": False,
    "schedule/valid": True, "schedule/invalid": False,
    "concurrency_limit/valid": True, "concurrency_limit/invalid": False,
    "queue_linearizable/valid": True,
}


def _timeline_per_key():
    """The timeline checker under ``independent.checker``, each key's
    page in its own subdirectory: the lifted checker passes the key in
    ``opts["history_key"]`` and no subdirectory (both packages), so a
    bare timeline would write one file 256 times."""
    from jepsen_tpu_torch.checker import CheckerFn, timeline

    def check(test, history, opts):
        sub = ["independent", str(opts["history_key"])]
        return timeline.timeline().check(test, history,
                                         {**opts, "subdirectory": sub})

    return CheckerFn(check, "timeline-per-key")


def _plots() -> bool:
    """Whether matplotlib imports (perf's PNGs need it; its numbers do
    not)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


@_timed_phase("checkers")
def phase_checkers(store_base):
    """The analysis phase of a stored Jepsen test at full width: the
    batch256 keyed history (256 cas-register keys of 128 ops, every 4th
    corrupted; 32,768 ops, 1 ms apart) saved with ``store.save_1``,
    loaded back with ``store.load`` and checked with ``compose`` of the
    linearizability checker lifted over keys (on the card: B1-T's grid),
    the timeline lifted over keys (one page per key) and ``perf``; the
    results saved with ``store.save_2`` and read back through
    ``store.latest``.  Every key's verdict is the JAX package's
    (:data:`BATCH256_INVALID`), and the valid keys' configs and depth
    (the invalid ones are checked again alone, by the race); 256
    timeline pages and perf's three PNGs are written (the PNGs and
    ``perf`` in the composed verdict only where matplotlib imports).
    Then every checker of the library on its seeded history
    (:func:`checker_histories`) gives the JAX package's verdict
    (:data:`CHECKERS_REFERENCE`); ``queue_linearizable`` runs on the card,
    its race and then its device leg alone
    (:func:`queue_linear_device_leg`), whose torch-step slices must run
    on the card (the queue models are not B1's)."""
    import torch

    from jepsen_tpu_torch import independent, store
    from jepsen_tpu_torch.checker import compose, perf
    from jepsen_tpu_torch.checker import linearizable as lin

    base = os.path.join(store_base, "checkers")
    keyed, model = keyed_history()
    test = {**CHECKERS_TEST, "store_base": base, "concurrency": 8,
            "model": model}
    # a [k v] tuple is stored as its repr by both packages' stores; the
    # client's value is the JSON pair, lifted back after the load
    stored = [replace(op, time=i * CHECKERS_EVENT_MS * 1_000_000,
                      value=[op.value.key, op.value.value])
              for i, op in enumerate(keyed)]
    t0 = time.perf_counter()
    store.save_1(test, stored)
    run = store.load(test["name"], test["start_time"], base)
    history = [replace(op, value=independent.tuple_(*op.value))
               for op in run["history"]]
    io_s = time.perf_counter() - t0
    check(len(history) == len(keyed) and run["name"] == test["name"],
          f"checkers: loaded {len(history)} of {len(keyed)} events")
    plots = _plots()
    checkers = {"linear": independent.checker(
                    lin.Linearizable(model, device="cuda")),
                "timeline": independent.checker(_timeline_per_key())}
    if plots:
        checkers["perf"] = perf.perf()
    with _GridTrace() as trace:
        _zero_counts()
        t0 = time.perf_counter()
        res = compose(checkers).check(run, history)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        single, grid = _read_counts()
    linear = res["linear"]
    check(res["valid"] is False and linear["valid"] is False
          and sorted(linear["failures"]) == sorted(BATCH256_INVALID),
          f"checkers: composed valid={res['valid']}, linear failures "
          f"{sorted(linear.get('failures', []))}")
    _check_batch_results("checkers[linear]",
                         [linear["results"][k] for k in range(BATCH_KEYS)],
                         BATCH256_INVALID)
    check(grid > 0, "checkers: B1-T's grid never launched")
    pages = [os.path.join(store.path(test, "independent", str(k)),
                          "timeline.html") for k in range(BATCH_KEYS)]
    check(res["timeline"]["valid"] is True
          and all(os.path.getsize(p) > 0 for p in pages),
          f"checkers: timeline {res['timeline'].get('valid')}, "
          f"{sum(os.path.exists(p) for p in pages)} pages")
    by_f = perf.latencies_by_f_type(history)
    q = {f: perf.latencies_to_quantiles(perf.DT, perf.QUANTILES,
                                        by_f[f]["ok"]) for f in by_f}
    check(sorted(by_f) == ["cas", "read", "write"] and all(q.values()),
          f"checkers: perf numbers by f {sorted(by_f)}")
    pngs = [store.path(test, n) for n in ("latency-raw.png",
                                          "latency-quantiles.png",
                                          "rate.png")]
    if plots:
        check(res["perf"]["valid"] is True
              and all(os.path.getsize(p) > 0 for p in pngs),
              f"checkers: perf {res['perf']}")
    t1 = time.perf_counter()
    store.save_2(test, res)
    latest = store.latest(base)
    io_s += time.perf_counter() - t1
    check(latest is not None and latest["results"]["valid"] is False
          and sorted(latest["results"]["linear"]["failures"])
          == sorted(BATCH256_INVALID), "checkers: store.latest did not "
          "return the saved results")
    emit(f"checkers[batch256]: events={len(history)} keys={BATCH_KEYS} "
         f"composed valid={res['valid']} failures="
         f"{len(linear['failures'])} ({', '.join(sorted(checkers))}); "
         f"compose wall_s={wall:.3f}; store save/load/latest s={io_s:.3f}; "
         f"launches grid={grid} single={single}; {trace.summary()}; "
         f"timeline pages={len(pages)}; perf "
         + ("PNGs written, in the composed verdict" if plots else
            "numbers only: matplotlib does not import here, so no PNG "
            "and perf is left out of the composed verdict")
         + f" (quantile buckets by f "
         f"{ {f: len(v[1.0]) for f, v in q.items()} })")

    verdicts, engine = {}, None
    t0 = time.perf_counter()
    for name, (spec, tmap, h) in checker_histories().items():
        if spec[1] == "queue_linearizable":
            _zero_counts()
            before = sum(lin.KERNEL_CACHE_STATS.values())
            out = make_checker(spec, device="cuda").check(
                {**tmap, "store_base": base}, h, {})
            q_single, q_grid = _read_counts()
            engine = out.get("engine")
            requests = sum(lin.KERNEL_CACHE_STATS.values()) - before
        else:
            out = make_checker(spec).check({**tmap, "store_base": base}, h,
                                           {})
        verdicts[name] = out["valid"]
    lib_s = time.perf_counter() - t0
    wrong = {k: (v, CHECKERS_REFERENCE[k]) for k, v in verdicts.items()
             if v is not CHECKERS_REFERENCE[k]}
    check(not wrong and sorted(verdicts) == sorted(CHECKERS_REFERENCE),
          f"checkers: verdicts (port, JAX package) differ: {wrong}")
    check(q_single + q_grid == 0, "checkers: queue_linearizable launched "
          f"B1 ({q_single} single, {q_grid} grid): the queue models are "
          "not the kernel's")
    emit(f"checkers[library]: {len(verdicts)} histories, every verdict the "
         f"JAX package's ({sum(v is True for v in verdicts.values())} "
         f"valid) in {lib_s:.3f} s; queue_linearizable on the card: "
         f"engine={engine}, slice functions requested={requests} (B1 "
         f"launches 0)")

    # the race above may end on the host WGL before the card steps: the
    # device leg alone
    name = "queue_linearizable/valid"
    _zero_counts()
    t0 = time.perf_counter()
    out, slices, requests = queue_linear_device_leg(base, device="cuda")
    torch.cuda.synchronize()
    leg_s = time.perf_counter() - t0
    q_single, q_grid = _read_counts()
    emit(f"checkers[queue_linearizable device leg]: valid={out['valid']} "
         f"engine={out.get('engine')} configs={out.get('configs')} "
         f"model={out.get('model')} in {leg_s:.3f} s; torch step slices by "
         f"device {dict(slices)}, slice functions requested={requests}; "
         f"B1 launches single={q_single} grid={q_grid}")
    check(out["valid"] is CHECKERS_REFERENCE[name],
          f"checkers: the device leg of {name} gives {out['valid']}, the "
          f"JAX package {CHECKERS_REFERENCE[name]}")
    card = str(lin._resolve_device("cuda"))
    check(requests > 0 and slices.get(card, 0) > 0 and set(slices) == {card},
          f"checkers: the device leg requested {requests} slice functions "
          f"and ran torch step slices {dict(slices)}")
    check(q_single + q_grid == 0, "checkers: the device leg launched B1 "
          f"({q_single} single, {q_grid} grid)")
    return {"checkers": {"grid": grid, "single": single}}


# ---------------------------------------------------------------------------
# a whole Jepsen test through core.run
# ---------------------------------------------------------------------------

#: the etcd tutorial's register workload (jepsen.etcdemo): five nodes, 10
#: threads per key, 100 ops per key over values 0-4; stagger and the
#: nemesis's half-period in seconds (the tutorial's 5 s nemesis is cut
#: to 0.5 s so its faults land while the in-process register runs)
RUN = dict(nodes=("n1", "n2", "n3", "n4", "n5"), concurrency=50,
           per_key=10, keys=50, ops_per_key=100, values=5, stagger_s=0.02,
           nemesis_s=0.5, cycles=2)

#: run[invalid]: these keys answer their first read with RUN_LIE, a value
#: no write gives
RUN_LIARS = frozenset({3, 17, 41})
RUN_LIE = 7

#: run[abort]: reads before the generator raises
RUN_ABORT_OPS = 2000

#: what the dummy remote answers for each node's address (the default
#: dummy answers nothing, on which ``net.ip`` raises in both packages)
RUN_GETENT = {f"getent ahosts {n}": (0, f"10.0.0.{i + 1} STREAM {n}\n", "")
              for i, n in enumerate(RUN["nodes"])}

#: the command log of a run: each (node, command) with its count, as the
#: JAX package's dummy remote records them on the CPU for RUN's nodes and
#: nemesis schedule (recomputed by tests/test_torch_smoke_reference.py)
RUN_NEMESIS_COMMANDS = {
    ('n1', "sudo -S -u root sh -c 'getent ahosts n3'"): 2,
    ('n1', "sudo -S -u root sh -c 'getent ahosts n4'"): 2,
    ('n1', "sudo -S -u root sh -c 'getent ahosts n5'"): 2,
    ('n1', "sudo -S -u root sh -c 'iptables -A INPUT -s 10.0.0.3,10.0.0.4,10.0.0.5 -j DROP -w'"): 2,
    ('n1', "sudo -S -u root sh -c 'iptables -F -w'"): 5,
    ('n1', "sudo -S -u root sh -c 'iptables -X -w'"): 5,
    ('n2', "sudo -S -u root sh -c 'getent ahosts n3'"): 2,
    ('n2', "sudo -S -u root sh -c 'getent ahosts n4'"): 2,
    ('n2', "sudo -S -u root sh -c 'getent ahosts n5'"): 2,
    ('n2', "sudo -S -u root sh -c 'iptables -A INPUT -s 10.0.0.3,10.0.0.4,10.0.0.5 -j DROP -w'"): 2,
    ('n2', "sudo -S -u root sh -c 'iptables -F -w'"): 5,
    ('n2', "sudo -S -u root sh -c 'iptables -X -w'"): 5,
    ('n3', "sudo -S -u root sh -c 'getent ahosts n1'"): 2,
    ('n3', "sudo -S -u root sh -c 'getent ahosts n2'"): 2,
    ('n3', "sudo -S -u root sh -c 'iptables -A INPUT -s 10.0.0.1,10.0.0.2 -j DROP -w'"): 2,
    ('n3', "sudo -S -u root sh -c 'iptables -F -w'"): 5,
    ('n3', "sudo -S -u root sh -c 'iptables -X -w'"): 5,
    ('n4', "sudo -S -u root sh -c 'getent ahosts n1'"): 2,
    ('n4', "sudo -S -u root sh -c 'getent ahosts n2'"): 2,
    ('n4', "sudo -S -u root sh -c 'iptables -A INPUT -s 10.0.0.1,10.0.0.2 -j DROP -w'"): 2,
    ('n4', "sudo -S -u root sh -c 'iptables -F -w'"): 5,
    ('n4', "sudo -S -u root sh -c 'iptables -X -w'"): 5,
    ('n5', "sudo -S -u root sh -c 'getent ahosts n1'"): 2,
    ('n5', "sudo -S -u root sh -c 'getent ahosts n2'"): 2,
    ('n5', "sudo -S -u root sh -c 'iptables -A INPUT -s 10.0.0.1,10.0.0.2 -j DROP -w'"): 2,
    ('n5', "sudo -S -u root sh -c 'iptables -F -w'"): 5,
    ('n5', "sudo -S -u root sh -c 'iptables -X -w'"): 5,
}


class RegisterClient:
    """One in-process cas register per key, each op atomic under one
    lock; on the keys in ``liars`` the first read answers
    :data:`RUN_LIE`.  ``tuple_`` is the package's ``independent.tuple_``."""

    def __init__(self, tuple_, liars=()):
        self.tuple_ = tuple_
        self.liars = set(liars)
        self.regs: dict = {}
        self.lock = threading.Lock()

    def open(self, test, node):
        return self

    def setup(self, test):
        pass

    def teardown(self, test):
        pass

    def close(self, test):
        pass

    def invoke(self, test, op):
        k, v = op.value.key, op.value.value
        with self.lock:
            cur = self.regs.get(k, 0)
            if op.f == "read":
                if k in self.liars:
                    self.liars.discard(k)
                    cur = RUN_LIE
                return replace(op, type="ok", value=self.tuple_(k, cur))
            if op.f == "write":
                self.regs[k] = v
                return replace(op, type="ok")
            if cur != v[0]:
                return replace(op, type="fail")
            self.regs[k] = v[1]
            return replace(op, type="ok")


class ExplodingGen:
    """``n`` reads, then raises (the reference's generator-recovery
    test)."""

    def __init__(self, n):
        self.n = n
        self.lock = threading.Lock()

    def op(self, test, process):
        with self.lock:
            self.n -= 1
            if self.n < 0:
                raise RuntimeError("generator exploded!")
        return {"type": "invoke", "f": "read", "value": None}


def _read_op(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def _write_op(test, process):
    return {"type": "invoke", "f": "write",
            "value": random.randrange(RUN["values"])}


def _cas_op(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(RUN["values"]),
                      random.randrange(RUN["values"]))}


def run_test(checker, *, mod=port_module, liars=(), abort=None,
             **kw) -> dict:
    """The test map of a :data:`RUN` test (``kw`` overrides RUN's keys),
    its modules from ``mod`` (as :func:`make_checker`'s): the etcd
    tutorial's phases (the workload under a start/stop nemesis, then
    heal) on per-key in-process registers, a partition of the halves
    over iptables on a dummy remote.  ``abort`` (a read count) swaps the
    workload for :class:`ExplodingGen` on the atom register."""
    gen, ind, fixtures = mod("generator"), mod("independent"), mod("fixtures")
    cfg = {**RUN, **kw}
    start = {"type": "info", "f": "start"}
    stop = {"type": "info", "f": "stop"}
    test = fixtures.noop_test() | {
        "nodes": list(cfg["nodes"]), "concurrency": cfg["concurrency"],
        "remote": mod("control").DummyRemote(dict(RUN_GETENT)),
        "net": mod("net").iptables,
        "nemesis": mod("nemesis").partition_halves(),
        "model": mod("models").cas_register(0), "checker": checker}
    if abort is not None:
        state = fixtures.AtomRegister(0)
        return test | {"db": fixtures.atom_db(state),
                       "client": fixtures.atom_client(state),
                       "generator": gen.clients(gen.phases(
                           ExplodingGen(abort),
                           gen.limit(10, _read_op)))}
    workload = ind.concurrent_generator(
        cfg["per_key"], range(cfg["keys"]),
        lambda k: gen.limit(cfg["ops_per_key"],
                            gen.mix([_read_op, _write_op, _cas_op])))
    dt = cfg["nemesis_s"]
    main = gen.nemesis(
        gen.seq([gen.sleep(dt), start, gen.sleep(dt), stop] * cfg["cycles"]),
        gen.stagger(cfg["stagger_s"], workload))
    return test | {
        "client": RegisterClient(ind.tuple_, liars),
        "generator": gen.phases(main, gen.log("Healing cluster"),
                                gen.nemesis(gen.once(stop)))}


def double_grant_generator(gen):
    """The lock workload's staged double grant, from ``gen`` (a
    generator module): thread 0 acquires, the nemesis kills the lock
    server with kill -9 and restarts it, thread 1 acquires, then thread
    0 releases.  Each phase ends before the next begins, so thread 1's
    grant completes before thread 0's release is invoked: on a server
    that forgets its holder in a crash (``lock_volatile``) two acquires
    succeed with no release between them, which no mutex linearization
    explains; a durable server answers thread 1 BUSY."""
    acquire = {"type": "invoke", "f": "acquire", "value": None}
    release = {"type": "invoke", "f": "release", "value": None}
    return gen.phases(
        gen.on(lambda t: t == 0, gen.once(acquire)),
        gen.nemesis(gen.once({"type": "info", "f": "kill"})),
        gen.nemesis(gen.once({"type": "info", "f": "restart"})),
        gen.on(lambda t: t == 1, gen.once(acquire)),
        gen.on(lambda t: t == 0, gen.once(release)))


def nemesis_commands(remote) -> dict:
    """A dummy remote's exec log as (node, command) -> count, the sources
    of each drop rule sorted (a grudge is a set: its order is the hash
    seed's)."""
    def canonical(cmd):
        head, sep, rest = cmd.partition(" -s ")
        if not sep:
            return cmd
        srcs, _, tail = rest.partition(" ")
        return f"{head} -s {','.join(sorted(srcs.split(',')))} {tail}"

    return dict(sorted(collections.Counter(
        (node, canonical(cmd)) for node, kind, cmd in remote.log
        if kind == "exec").items()))


def run_checker():
    """The etcd tutorial's register checker
    (``suites/etcdemo.py:202-205``): linearizability and a timeline,
    composed and lifted over keys.  Both packages check the lifted
    composition key by key, each key a race of the host engines and
    B1-T's single-key form; B1-T's grid never runs (``ROADMAP.md`` §C)."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker import compose, timeline
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import cas_register

    return independent.checker(compose({
        "linear": linearizable(cas_register(0), device="cuda"),
        "timeline": timeline.timeline()}))


def _error_paths(v, path="results") -> list:
    """Every ``"error"`` key at any depth of a result."""
    out = []
    if isinstance(v, dict):
        for k, x in v.items():
            if k == "error":
                out.append(f"{path}.error")
            out += _error_paths(x, f"{path}.{k}")
    elif isinstance(v, (list, tuple)):
        for i, x in enumerate(v):
            out += _error_paths(x, f"{path}[{i}]")
    return out


def stored_kv(v):
    """A stored ``[k v]`` value (the store writes a tuple as its repr)
    as the port's tuple."""
    import ast

    from jepsen_tpu_torch import independent

    k, x = v[1:-1].split(" ", 1)
    return independent.tuple_(ast.literal_eval(k), ast.literal_eval(x))


def _run_once(test):
    """``core.run`` on ``test`` with its launches counted: (the run or
    the exception it raised, seconds, (single, grid) launches)."""
    import torch

    from jepsen_tpu_torch import core

    _zero_counts()
    t0 = time.perf_counter()
    try:
        out = core.run(test)
    except Exception as e:  # noqa: BLE001 — run[abort] expects one
        out = e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, _read_counts()


def _check_run(label, out, *, keys, ops, store_base):
    """What every finished run owes: each client op completed, the
    history indexed, a stream verdict, no ``"error"`` anywhere, and the
    store's copy of the history and verdict."""
    from jepsen_tpu_torch import store

    check(not isinstance(out, BaseException), f"{label}: core.run raised "
          f"{out!r}")
    h = out["history"]
    client = [op for op in h if isinstance(op.process, int)]
    done = [op for op in client if op.type in ("ok", "fail")]
    check(len(client) == 2 * ops and len(done) == ops,
          f"{label}: {len(client)} client events, {len(done)} completed, "
          f"want {2 * ops} and {ops}")
    check(all(op.index == i for i, op in enumerate(h)),
          f"{label}: the history is not indexed 0..{len(h) - 1}")
    res = out["results"]
    got = sorted(res["results"])
    check(got == list(range(keys))
          and all({"linear", "timeline"} <= set(res["results"][k])
                  for k in got),
          f"{label}: checked {len(got)} keys, want {keys}, each with its "
          f"linear and timeline results")
    errors = _error_paths(res)
    check(not errors, f"{label}: error keys in the results: {errors[:5]}")
    sres = out.get("stream_results")
    check(sres is not None and res.get("stream") is not None,
          f"{label}: no streamed verdict")
    loaded = store.load(out["name"], out["start_time"], store_base)
    check(len(loaded["history"]) == len(h)
          and loaded["results"]["valid"] == res["valid"],
          f"{label}: the store holds {len(loaded.get('history', []))} "
          f"events and valid={loaded.get('results', {}).get('valid')}")
    return res, sres, loaded


@_timed_phase("run")
def phase_run(store_base):
    """Whole Jepsen tests through the port's ``core.run`` (the sessions,
    the OS and DB, client and nemesis workers from the generator with
    the stream linter and the streaming checker as op sinks, the store,
    the composed checker): the etcd tutorial's register test at its
    width (:data:`RUN`: 50 keys, 5,000 ops) under a partition of the
    halves, checked by the tutorial's :func:`run_checker` (each key a
    race of the host engines and B1-T's single-key form); the same test
    with a client that lies on :data:`RUN_LIARS`, whose keys the host
    holds to the same verdict on the stored history; and a run whose
    generator raises, whose streamed prefix verdict rides the exception
    and the store."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.independent import subhistory
    from jepsen_tpu_torch.models import cas_register

    base = os.path.join(store_base, "run")
    quiet = logging.StreamHandler()
    quiet.setLevel(logging.WARNING)
    logger = logging.getLogger("jepsen")
    logger.addHandler(quiet)  # the run log goes to the store's jepsen.log
    launches = {}
    ops = RUN["keys"] * RUN["ops_per_key"]
    try:
        for label, liars in (("run[register]", ()),
                             ("run[invalid]", RUN_LIARS)):
            random.seed(label)
            test = run_test(run_checker(), liars=liars) | {
                "name": label.replace("[", "-").strip("]"),
                "store_base": base, "stream": True, "device": "cuda"}
            out, wall, (single, grid) = _run_once(test)
            launches[label] = {"grid": grid, "single": single}
            res, sres, loaded = _check_run(label, out, keys=RUN["keys"],
                                           ops=ops, store_base=base)
            per_key = [res["results"][k] for k in range(RUN["keys"])]
            linear = [r["linear"] for r in per_key]
            failures = sorted(res["failures"])
            cmds = nemesis_commands(out["remote"])
            nem = [op for op in out["history"] if op.process == "nemesis"]
            emit(f"{label}: wall_s={wall:.3f} events={len(out['history'])} "
                 f"client ops={ops} nemesis events={len(nem)} phases_s="
                 f"{out.get('phase_s')}; valid={res['valid']} failures="
                 f"{failures} linear engines "
                 f"{_route_counts(linear)}; stream valid={sres['valid']} "
                 f"routes={res['stream']['stream'].get('routes')} "
                 f"segments={res['stream']['stream'].get('segments')}; "
                 f"launches "
                 f"grid={grid} single={single}; commands={sum(cmds.values())}")
            check(cmds == RUN_NEMESIS_COMMANDS,
                  f"{label}: the dummy remote's commands differ from the JAX "
                  f"package's: {sorted(set(cmds.items()) ^ set(RUN_NEMESIS_COMMANDS.items()))[:6]}")
            if grid == 0:
                emit(f"{label}: B1-T's grid did not launch: the tutorial "
                     f"lifts the composition, which checks key by key in "
                     f"both packages (ROADMAP.md section C)")
            if not liars:
                check(res["valid"] is True and sres["valid"] is True
                      and all(r["valid"] is True and r["linear"]["valid"]
                              is True and r["timeline"]["valid"] is True
                              for r in per_key),
                      f"{label}: valid={res['valid']} stream "
                      f"{sres['valid']} failures {failures}")
                continue
            check(res["valid"] is False and sres["valid"] is False
                  and failures == sorted(RUN_LIARS),
                  f"{label}: valid={res['valid']} stream {sres['valid']} "
                  f"failures {failures}")
            stored = [replace(op, value=stored_kv(op.value))
                      if isinstance(op.process, int) else op
                      for op in loaded["history"]]
            host = linearizable(cas_register(0), device="cpu")
            for k in sorted(RUN_LIARS):
                want = host.check({"store_base": base}, subhistory(k, stored),
                                  {})
                check(linear[k]["valid"] is want["valid"] is False,
                      f"{label}: key {k} is {linear[k]['valid']} on the "
                      f"card, {want['valid']} on the host")
            emit(f"{label}: the invalid keys' races (the host engines "
                 f"and B1-T's single-key form): "
                 + ", ".join(f"{k} {linear[k].get('engine')}"
                             for k in sorted(RUN_LIARS)))

        label = "run[abort]"
        test = run_test(run_checker(), abort=RUN_ABORT_OPS) | {
            "name": "run-abort", "store_base": base, "stream": True,
            "device": "cuda", "start_time": "20260101T000000"}
        out, wall, (single, grid) = _run_once(test)
        launches[label] = {"grid": grid, "single": single}
        check(isinstance(out, RuntimeError)
              and "generator exploded" in str(out),
              f"{label}: core.run gave {out!r}, want the generator's error")
        sres = getattr(out, "stream_results", None)
        check(sres is not None and sres["aborted"] is True
              and sres["valid"] is True,
              f"{label}: the exception carries {sres}")
        loaded = store.load("run-abort", test["start_time"], base)
        check(loaded["results"]["valid"] is True
              and loaded["results"]["aborted"] is True
              and len(loaded["history"]) > 0,
              f"{label}: the store holds {loaded.get('results')}")
        emit(f"{label}: wall_s={wall:.3f} raised {out!r}; streamed prefix "
             f"valid={sres['valid']} aborted={sres['aborted']} over "
             f"{len(loaded['history'])} stored events "
             f"(routes={sres['stream']['stream'].get('routes')}); launches "
             f"grid={grid} single={single}")
    finally:
        logger.removeHandler(quiet)
    grid = sum(v["grid"] for v in launches.values())
    single = sum(v["single"] for v in launches.values())
    emit(f"run: B1-T launches over the three runs grid={grid} "
         f"single={single}")
    check(grid + single > 0, "run: B1 never launched on the run path")
    return launches


#: the atomdemo command a user types (the README's recipe for a suite),
#: with the device route forced on every key, the stream and the trace on
SUITE_CMD = ("test", "--dummy", "-n", "n1", "-n", "n2", "-n", "n3",
             "--time-limit", "5", "--lin-algorithm", "device", "--stream",
             "--trace")
#: ...and four threads on each key at 200 ops/s, each reply delayed up to
#: 10 ms after its op applies (``--latency``).  At atomdemo's defaults the
#: in-process register replies in the order it applies the ops, so the
#: greedy witness decides nearly every key on the host before a search
#: (114 of 115 keys on the card at four threads a key) and B1-T need not
#: launch in the child; more threads alone reorder too rarely (0 of 32
#: keys on the card at thirty-two threads).  Delayed replies reorder
#: completions on every busy key: 43 of 44 keys reached the device search
#: in a CPU rehearsal.
SUITE_OVERLAP = ("-r", "200", "--group-size", "4", "--concurrency", "8",
                 "--latency", "10")
#: the device the phase's runs ask for ("cpu" only to rehearse the phase
#: off the card: the child process runs where this says)
SUITE_DEVICE = "cuda"
#: engines that decide a key on the host before any search, as the
#: device route does ahead of its first launch
SUITE_PRESEARCH = ("greedy-witness", "hb-decide", "constraint-decide",
                   "trivial")

#: the etcd tutorial's nodes: an etcd v3 JSON gateway stand-in on each
#: loopback address at etcd's client port, which ``suites/etcdemo.py``'s
#: ``client_url`` names, so the suite's command line runs unchanged
ETCD_NODES = ("127.0.0.1", "127.0.0.2", "127.0.0.3")
ETCD_PORT = 2379
#: ``python -m jepsen_tpu_torch.suites.etcdemo`` as a user types it: ten
#: threads a key (the tutorial's ``--concurrency 10n``), the device route
#: on every key; the suite keeps its 10 s join wait, its partition of the
#: halves every 5 s and its 10 s recovery wait
ETCD_CMD = ("test", "--dummy", "-n", ETCD_NODES[0], "-n", ETCD_NODES[1],
            "-n", ETCD_NODES[2], "--time-limit", "10", "--concurrency",
            "10n", "--lin-algorithm", "device")
#: the stale etcd child's seconds of workload (the sound child runs
#: :data:`ETCD_CMD`'s 10): a stale read shows within seconds
ETCD_STALE_S = 5
#: the dummy remote's answers (``--dummy-responses``) that let the DB's
#: archive install finish: a fresh temporary directory, and one root in
#: the unpacked archive.  Without them the default dummy answers every
#: ``stat``, and ``control_util.tmp_dir`` never finds a fresh directory
#: (in both packages)
ETCD_DUMMY_RESPONSES = {
    "stat /tmp/jepsen/": [1, "", "stat: No such file or directory"],
    "ls -A": [0, "etcd-v3.1.5-linux-amd64\n", ""]}
#: each stand-in delays its reply by a uniform draw up to this many
#: seconds after the op applies, as a network's reply leg: completions
#: then leave the order the ops applied in, and the greedy witness no
#: longer decides every key before the search
ETCD_LATENCY_S = 0.01

#: cockroach's SQL port, which ``SQLClient.open`` reads from the test map
#: (``sql_port``; no flag sets it): a pgwire stand-in listens on it at
#: each of :data:`ETCD_NODES`
PG_PORT = 26257
#: ``python -m jepsen_tpu_torch.suites.cockroach`` as a user types it:
#: the register workload at its own width (four threads a key, 100 ops a
#: key; ``--concurrency 4``, one key at a time, where the default of one
#: thread a node would give three), no nemesis, the device route on
#: every key.  The primary's setup keeps its 5 s wait
COCKROACH_CMD = ("test", "--dummy", "-n", ETCD_NODES[0], "-n",
                 ETCD_NODES[1], "-n", ETCD_NODES[2], "--workload",
                 "register", "--nemesis", "none", "--time-limit", "10",
                 "--concurrency", "4", "--lin-algorithm", "device")
#: the stale run, in process: the same at 5 s
COCKROACH_STALE_S = 5
#: the dummy remote's answers that let cockroach's archive install
#: finish (see :data:`ETCD_DUMMY_RESPONSES`)
COCKROACH_DUMMY_RESPONSES = {
    "stat /tmp/jepsen/": [1, "", "stat: No such file or directory"],
    "ls -A": [0, "cockroach-v2.0.0.linux-amd64\n", ""]}
#: each pgwire stand-in delays a reply by a uniform draw up to this many
#: seconds once the statement has applied and its connection holds no
#: transaction (after COMMIT or ROLLBACK), so replies leave the order
#: the transactions committed in while transactions still serialize
PG_LATENCY_S = 0.01


class EtcdGateway(http.server.BaseHTTPRequestHandler):
    """A stand-in for etcd's v3 JSON gateway (``/kv/put``, ``/kv/range``,
    ``/kv/txn`` with base64 keys and values), the handler of
    ``tests/test_clients_live.py``: every gateway of one cluster shares
    ``server.kv`` under ``server.lock``.  Each reply waits up to
    ``server.latency`` seconds after its op applies.  The store also
    keeps ``server.prev``, each key's value before its latest write: a
    ``server.stale`` gateway answers reads from it, a copy of the store
    one write behind."""

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        import base64

        srv = self.server
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n))

        def b64d(x):
            return base64.b64decode(x).decode()

        def b64e(x):
            return base64.b64encode(x.encode()).decode()

        def put(k, v):
            if k in srv.kv:
                srv.prev[k] = srv.kv[k]
            srv.kv[k] = v

        with srv.lock:
            if self.path.endswith("/kv/put"):
                put(b64d(body["key"]), b64d(body["value"]))
                out = {}
            elif self.path.endswith("/kv/range"):
                kv = srv.prev if srv.stale else srv.kv
                k = b64d(body["key"])
                out = {}
                if k in kv:
                    out["kvs"] = [{"key": body["key"],
                                   "value": b64e(kv[k])}]
            elif self.path.endswith("/kv/txn"):
                cmp_ = body["compare"][0]
                k = b64d(cmp_["key"])
                ok = srv.kv.get(k) == b64d(cmp_["value"])
                if ok:
                    req = body["success"][0]["requestPut"]
                    put(b64d(req["key"]), b64d(req["value"]))
                out = {"succeeded": ok}
            else:
                self.send_response(404)
                self.end_headers()
                return
        time.sleep(random.uniform(0, srv.latency))
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class _GatewayServer(http.server.ThreadingHTTPServer):
    # the standard library's listen backlog of 5 overflows under a
    # tutorial run's thirty clients, and a dropped SYN is retried after
    # a second: every op would take one
    request_queue_size = 128
    daemon_threads = True


def etcd_gateways(addrs, *, stale_last=False, latency=ETCD_LATENCY_S):
    """One :class:`EtcdGateway` server per ``(host, port)`` of ``addrs``,
    each serving on a daemon thread, all sharing one store; the last one
    stale when ``stale_last``.  Raises OSError (the servers started so
    far shut down) when an address is taken."""
    kv, prev, lock = {}, {}, threading.Lock()
    servers = []
    try:
        for i, addr in enumerate(addrs):
            srv = _GatewayServer(addr, EtcdGateway)
            srv.kv, srv.prev, srv.lock, srv.latency = kv, prev, lock, latency
            srv.stale = stale_last and i == len(addrs) - 1
            servers.append(srv)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
    except OSError:
        stop_gateways(servers)
        raise
    return servers


def stop_gateways(servers) -> None:
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def pg_standins(addrs, *, stale_last=False, latency=PG_LATENCY_S):
    """One pgwire ``MiniPGServer`` per ``(host, port)`` of ``addrs``, each
    serving on a daemon thread, all sharing one ``RegisterEngine``: the
    stand-ins of a cockroach cluster for ``suites/cockroach.py``'s SQL
    clients.  The engine delays each reply by up to ``latency`` seconds
    once the statement has applied and the connection holds no
    transaction: never while the transaction lock is held, so
    transactions serialize and their replies still reorder.  It also
    keeps each register's value before its latest committed write; with
    ``stale_last`` the last server answers a register's ``SELECT`` from
    that copy, one committed write behind.  Raises OSError (the servers
    started so far shut down) when an address is taken."""
    import re

    from jepsen_tpu_torch.suites import pgwire

    class Engine(pgwire.RegisterEngine):
        def __init__(self):
            super().__init__()
            self.prev = {}

        def execute(self, sql):
            me = threading.get_ident()
            if (self._txn_owner == me
                    and re.fullmatch(r"COMMIT", sql.strip().rstrip(";"),
                                     re.I)):
                seen = set()
                for table, k, old in self._undo:  # oldest first
                    if table == "registers" and k not in seen:
                        seen.add(k)
                        if old is None:
                            self.prev.pop(k, None)
                        else:
                            self.prev[k] = old
            out = super().execute(sql)
            if self._txn_owner != me:
                time.sleep(random.uniform(0, latency))
            return out

    class StaleView:
        """The shared engine, whose register reads answer from the copy
        one committed write behind."""

        def __init__(self, engine):
            self.engine = engine

        def execute(self, sql):
            m = re.fullmatch(r"SELECT value FROM registers WHERE id=(-?\d+)",
                             sql.strip().rstrip(";"), re.I)
            if m is None:
                return self.engine.execute(sql)
            with self.engine.lock:
                v = self.engine.prev.get(int(m.group(1)))
            rows = [] if v is None else [(v,)]
            return rows, ["value"], f"SELECT {len(rows)}"

        def abort_connection(self):
            self.engine.abort_connection()

    class Server(pgwire.MiniPGServer):
        # every client connects at once when the run starts
        request_queue_size = 128

    engine = Engine()
    servers = []
    try:
        for i, addr in enumerate(addrs):
            srv = Server(addr, pgwire._Handler)
            srv.engine = (StaleView(engine)
                          if stale_last and i == len(addrs) - 1 else engine)
            servers.append(srv)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
    except OSError:
        stop_gateways(servers)
        raise
    return servers


def _run_ports(n: int) -> int:
    """The first of ``n`` consecutive ports below the kernel's ephemeral
    range, all free now (the localnode servers bind them)."""
    import socket

    rng = random.Random()
    while True:
        base = rng.randrange(20000, 32000 - n)
        socks = []
        try:
            for port in range(base, base + n):
                socks.append(socket.socket())
                socks[-1].bind(("127.0.0.1", port))
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
        return base


def _host_keys(label, stored, card, store_base, model=None,
               algorithm="auto"):
    """Each key of a stored keyed history checked again on the host
    (``algorithm``: the default route's race of the host engines and the
    CPU's torch step, or ``"host"``, the WGL search alone), held to the
    card's per-key verdicts (``card``: key -> valid), under ``model``
    (default a cas-register from 0)."""
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.independent import subhistory
    from jepsen_tpu_torch.models import cas_register

    hist = [replace(op, value=stored_kv(op.value))
            if isinstance(op.process, int) else op for op in stored]
    host = linearizable(model or cas_register(0), device="cpu",
                        algorithm=algorithm)
    for k, valid in sorted(card.items()):
        want = host.check({"store_base": store_base}, subhistory(k, hist))
        check(want["valid"] is valid, f"{label}: key {k} is {valid} on the "
              f"card, {want['valid']} on the host")


def _host_lock(label, stored, valid, store_base):
    """A stored lock history checked again on the host under the mutex
    model, held to the card's verdict."""
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import mutex

    want = linearizable(mutex(), device="cpu").check(
        {"store_base": store_base}, stored)
    check(want["valid"] is valid, f"{label}: {valid} on the card, "
          f"{want['valid']} on the host")


def _suite_child(d):
    """``python -m jepsen_tpu_torch.suites.atomdemo`` as a user types it,
    run in ``d`` (where its ``store/`` lands; the package is linked in):
    (exit code, stdout, stderr, wall seconds)."""
    link = os.path.join(d, "jepsen_tpu_torch")
    if not os.path.exists(link):
        os.symlink(REPO / "jepsen_tpu_torch", link)
    argv = [*SUITE_CMD, *SUITE_OVERLAP]
    if SUITE_DEVICE != "cuda":
        argv += ["--device", SUITE_DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.suites.atomdemo", *argv],
        cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    code, out, err = _finish(proc, timeout=300)
    return code, out, err, time.perf_counter() - t0


def _suite_cli_child(d, module, argv, responses, start):
    """``python -m jepsen_tpu_torch.suites.<module> *argv`` as a user types
    it, in ``d`` (the package linked in), with ``responses`` as its
    ``--dummy-responses`` file, while the stand-ins ``start()`` returns
    serve: (exit code, stdout, stderr, wall seconds)."""
    os.makedirs(d, exist_ok=True)
    link = os.path.join(d, "jepsen_tpu_torch")
    if not os.path.exists(link):
        os.symlink(REPO / "jepsen_tpu_torch", link)
    path = os.path.join(d, "dummy-responses.json")
    with open(path, "w") as f:
        json.dump(responses, f)
    argv = [*argv, "--dummy-responses", path]
    if SUITE_DEVICE != "cuda":
        argv += ["--device", SUITE_DEVICE]
    servers = start()
    try:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", f"jepsen_tpu_torch.suites.{module}",
             *argv], cwd=d, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        code, out, err = _finish(proc, timeout=300)
        return code, out, err, time.perf_counter() - t0
    finally:
        stop_gateways(servers)


def _etcd_child(d, *, stale):
    """``python -m jepsen_tpu_torch.suites.etcdemo`` (:data:`ETCD_CMD`)
    against :func:`etcd_gateways` on :data:`ETCD_NODES`, the last one
    stale when ``stale`` (:func:`_suite_cli_child`).  Raises
    SmokeFailure when a gateway's address is taken."""
    def start():
        try:
            return etcd_gateways([(h, ETCD_PORT) for h in ETCD_NODES],
                                 stale_last=stale)
        except OSError as e:
            raise SmokeFailure(f"etcd gateway stand-ins: cannot bind "
                               f"{ETCD_NODES} at port {ETCD_PORT}: "
                               f"{e}") from e

    argv = list(ETCD_CMD)
    if stale:
        argv[argv.index("--time-limit") + 1] = str(ETCD_STALE_S)
    return _suite_cli_child(d, "etcdemo", argv, ETCD_DUMMY_RESPONSES,
                            start)


def _pg_start(stale):
    """:func:`pg_standins` on :data:`ETCD_NODES` at :data:`PG_PORT`, the
    last one stale when ``stale``; SmokeFailure when a port is taken."""
    try:
        return pg_standins([(h, PG_PORT) for h in ETCD_NODES],
                           stale_last=stale)
    except OSError as e:
        raise SmokeFailure(f"pgwire stand-ins: cannot bind {ETCD_NODES} "
                           f"at port {PG_PORT}: {e}") from e


def _cockroach_child(d):
    """``python -m jepsen_tpu_torch.suites.cockroach``
    (:data:`COCKROACH_CMD`) against three sound :func:`pg_standins`."""
    return _suite_cli_child(d, "cockroach", COCKROACH_CMD,
                            COCKROACH_DUMMY_RESPONSES,
                            lambda: _pg_start(False))


def _stored_keys(label, d, code, wall, where="in the child"):
    """The stored keyed run under ``d/store`` (a child's or an in-process
    run's): (the run, per-key results, keys on B1-T, invalid keys), with
    its line printed."""
    from jepsen_tpu_torch import store

    run = store.latest(os.path.join(d, "store"))
    check(run is not None and "results" in run,
          f"{label}: exit {code}, no stored results")
    res = run["results"]
    # etcdemo composes its lifted checker under "workload"; the
    # registry's suites check with the lifted checker alone
    keys = res["workload"]["results"] if "workload" in res \
        else res["results"]
    # a key whose check raised has no engine: check_safe leaves only
    # its verdict ("unknown") and the traceback
    raised = {k: r["linear"].get("error", "") for k, r in keys.items()
              if "engine" not in r["linear"]}
    engines = collections.Counter(r["linear"].get("engine", "raised")
                                  for r in keys.values())
    on_card = {k for k, r in keys.items() if r["linear"].get(
        "engine", "").startswith("device-bfs(cuda")}
    invalid = sorted(int(k) for k, r in keys.items()
                     if r["linear"]["valid"] is False)
    emit(f"{label}: exit {code}, {where} wall_s={wall:.3f}, {len(keys)} "
         f"keys, valid={res['valid']}, invalid keys {invalid}; engines "
         f"{dict(engines)}; {len(on_card)} keys on B1-T {where}")
    for k, tb in sorted(raised.items(), key=lambda kv: int(kv[0])):
        emit(f"{label}: key {k}'s check raised: {tb.strip()[-1500:]!r}")
    if raised:
        first = min(raised, key=int)
        raise SmokeFailure(f"{label}: the checks of keys "
                           f"{sorted(raised, key=int)} raised; key {first}'s:"
                           f" {raised[first].strip()[-1500:]}")
    check(all(e.startswith("device-bfs") or e in SUITE_PRESEARCH
              for e in engines),
          f"{label}: engines off the device route: {dict(engines)}")
    return run, keys, on_card, invalid


def _cockroach_runs(base, hostb, counted):
    """``suites[cockroach-cli]`` and ``suites[cockroach-stale]`` of
    :func:`phase_suites` (``counted(label, fn)`` runs ``fn`` with its
    launches counted: (its value, wall, single, grid)), each key held to
    the host's WGL check of the stored history."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.suites import cockroach

    # -- suites[cockroach-cli]: the SQL register as a user types it ----------
    label = "suites[cockroach-cli]"
    d = os.path.join(base, "cockroach")
    code, out, err, wall = _cockroach_child(d)
    run, keys, on_card, invalid = _stored_keys(label, d, code, wall)
    check(code == 0 and run["results"]["valid"] is True,
          f"{label}: exit {code}, valid={run['results']['valid']}; "
          f"errors {_error_paths(run['results'])[:5]}; {err[-1500:]}")
    check(2 * len(on_card) > len(keys) or SUITE_DEVICE != "cuda",
          f"{label}: B1-T searched {len(on_card)} of {len(keys)} keys "
          f"in the child, not most")
    _host_keys(label, run["history"], {
        int(k): r["linear"]["valid"] for k, r in keys.items()}, hostb,
        model=cas_register(), algorithm="host")
    emit(f"{label}: every key the host's")

    # -- suites[cockroach-stale]: in process, one stand-in a write behind --
    label = "suites[cockroach-stale]"
    d = os.path.join(base, "cockroach-stale")
    os.makedirs(d, exist_ok=True)
    responses = os.path.join(d, "dummy-responses.json")
    with open(responses, "w") as f:
        json.dump(COCKROACH_DUMMY_RESPONSES, f)
    argv = list(COCKROACH_CMD)
    argv[argv.index("--time-limit") + 1] = str(COCKROACH_STALE_S)
    argv += ["--dummy-responses", responses, "--device", SUITE_DEVICE]
    dstore = os.path.join(d, "store")
    random.seed(label)
    servers = _pg_start(True)
    try:
        code, wall, single, grid = counted(label, lambda: cli.run(
            cli.single_test_cmd(
                lambda opts: cockroach.REGISTRY.build_test(opts)
                | {"store_base": dstore},
                add_opts=cockroach.REGISTRY.add_opts), argv))
    finally:
        stop_gateways(servers)
    run, keys, on_card, invalid = _stored_keys(label, d, code, wall,
                                               where="in process")
    check(code == 1 and run["results"]["valid"] is False and invalid,
          f"{label}: exit {code}, valid={run['results']['valid']}, "
          f"invalid keys {invalid}")
    _host_keys(label, run["history"], {
        int(k): r["linear"]["valid"] for k, r in keys.items()}, hostb,
        model=cas_register(), algorithm="host")
    decided = sorted(k for k in invalid if str(k) in on_card)
    emit(f"{label}: every key the host's; invalid keys decided on B1-T "
         f"{decided}; launches single={single} grid={grid}")
    check(decided or SUITE_DEVICE != "cuda",
          f"{label}: no invalid key was decided on B1-T")


@_timed_phase("suites")
def phase_suites(store_base):
    """The suites' command line and the results web server on the card.

    ``suites[atomdemo-cli]``: ``python -m jepsen_tpu_torch.suites.atomdemo
    test`` in a child process (:data:`SUITE_CMD`, :data:`SUITE_OVERLAP`):
    exit 0, ``results.json`` valid, every key on the device route (B1-T
    in the child: ``device-bfs(cuda...)``, or decided on the host before
    a search), most keys on B1-T, ``trace.json`` with device spans, ``live.json`` from the
    stream.  ``suites[atomdemo]``: ``cli.run`` of the suite in process
    with no algorithm flag (the default route: the race), its launches
    counted, every key held to the host's check of the stored history.
    ``suites[localnode]``: three real server processes under kill -9 and
    restart for 6 s, checked on the card (``lin_algorithm`` device: the
    keys the greedy witness leaves, those with crashed ops, on B1-T),
    valid, every key held to the host.
    ``suites[locknode]``: the lock server with ``lock_volatile`` and
    :func:`double_grant_generator`, checked on the card
    (``lin_algorithm`` device, ``hb`` off: the search, not the prepass),
    invalid, as the host says.  ``suites[hazelcast]``: the lock fixture
    (BASELINE config 4), sound and broken, on the card the same way:
    valid and invalid, each the host's verdict.  Every run stores under
    one store.  ``suites[etcdemo-cli]``: ``python -m
    jepsen_tpu_torch.suites.etcdemo test`` (:data:`ETCD_CMD`) in a child
    against three gateway stand-ins sharing one store: exit 0, valid,
    most keys on B1-T (``device-bfs(cuda...)``).  ``suites[etcdemo-stale]``:
    the same for :data:`ETCD_STALE_S` seconds of workload with the third
    gateway answering reads from a lagging copy:
    exit 1, every key's verdict the host's on the stored history, one
    invalid key at least decided on B1-T.  ``suites[cockroach-cli]``:
    ``python -m jepsen_tpu_torch.suites.cockroach test --workload
    register`` (:data:`COCKROACH_CMD`) in a child against three pgwire
    stand-ins on :data:`ETCD_NODES` at :data:`PG_PORT` sharing one engine
    (:func:`pg_standins`): exit 0, valid, most keys on B1-T, every key
    the host's.  ``suites[cockroach-stale]``: the same in process for
    :data:`COCKROACH_STALE_S` seconds with the third stand-in answering
    reads one committed write behind: exit 1, every key the host's, one
    invalid key at least decided on B1-T (:func:`_cockroach_runs`).
    ``lint``: ``python -m
    jepsen_tpu_torch.analyze.lint_suites --json`` over the tree under
    test exits 0 with no error.  The etcd runs store apart from the
    others (their test's name has spaces, which the web check's URLs
    would have to quote).  ``suites[web]``: the results server on it answers ``/``
    (every run listed), each run's page (its search telemetry shown
    wherever one of the page's result panels carries it, on one page at
    least), ``/api/live/...`` for the streamed run, ``/api/stats``
    (device seconds > 0) and ``?zip``.  Returns the counted paths'
    launches."""
    import json as json_mod
    import urllib.request

    import torch

    from jepsen_tpu_torch import cli, core, store, web
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.suites import atomdemo, hazelcast, localnode

    base = os.path.join(store_base, "suites")
    sbase = os.path.join(base, "store")
    hostb = os.path.join(base, "host")  # the host re-checks' reports
    os.makedirs(base, exist_ok=True)
    quiet = logging.StreamHandler()
    quiet.setLevel(logging.WARNING)
    logger = logging.getLogger("jepsen")
    logger.addHandler(quiet)  # the run log goes to the store's jepsen.log
    launches = {}

    def counted(label, fn):
        _zero_counts()
        t0 = time.perf_counter()
        out = fn()
        if SUITE_DEVICE == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        single, grid = _read_counts()
        launches[label] = {"grid": grid, "single": single}
        return out, wall, single, grid

    try:
        # -- suites[atomdemo-cli]: the command line in a child --------------
        label = "suites[atomdemo-cli]"
        code, out, err, wall = _suite_child(base)
        run = store.latest(sbase)
        check(code == 0, f"{label}: exit {code}; errors in the results "
              f"{_error_paths((run or {}).get('results'))[:5]}; "
              f"{err[-1500:]}")
        res = run["results"]
        keys = res["workload"]["results"]
        engines = collections.Counter(r["linear"]["engine"]
                                      for r in keys.values())
        on_card = sum(n for e, n in engines.items()
                      if e.startswith("device-bfs(cuda"))
        rel = os.path.join("atomdemo", run["start_time"])
        with open(os.path.join(sbase, rel, "trace.json")) as f:
            spans = collections.Counter(
                e.get("name") for e in json_mod.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "device")
        live = os.path.join(sbase, rel, "live.json")
        emit(f"{label}: exit {code}, child wall_s={wall:.3f}, "
             f"{len(keys)} keys, valid={res['valid']} stream "
             f"{res['stream']['valid']}; engines {dict(engines)}; device "
             f"spans in trace.json {dict(spans)}; live.json "
             f"{os.path.isfile(live)}")
        check(res["valid"] is True and res["stream"]["valid"] is True,
              f"{label}: valid={res['valid']}")
        check(all(e.startswith("device-bfs") or e in SUITE_PRESEARCH
                  for e in engines),
              f"{label}: engines off the device route: {dict(engines)}")
        check(2 * on_card > len(keys) or SUITE_DEVICE != "cuda",
              f"{label}: B1-T searched {on_card} of {len(keys)} keys in "
              f"the child, not most: {dict(engines)}")
        check(spans and os.path.isfile(live),
              f"{label}: device spans {dict(spans)}, live.json "
              f"{os.path.isfile(live)}")

        # -- suites[atomdemo]: the default route, in process ----------------
        label = "suites[atomdemo]"
        random.seed(label)
        argv = ["test", "--dummy", "-n", "n1", "-n", "n2", "-n", "n3",
                "--time-limit", "3", "--device", SUITE_DEVICE]
        code, wall, single, grid = counted(label, lambda: cli.run(
            cli.single_test_cmd(
                lambda opts: atomdemo.atom_test(opts) | {"store_base": sbase},
                add_opts=atomdemo.add_opts), argv))
        check(code == 0, f"{label}: cli.run exit {code}")
        run = store.latest(sbase)
        keys = run["results"]["workload"]["results"]
        engines = collections.Counter(r["linear"]["engine"]
                                      for r in keys.values())
        _host_keys(label, run["history"], {
            int(k): r["linear"]["valid"] for k, r in keys.items()}, hostb)
        emit(f"{label}: cli.run exit {code}, wall_s={wall:.3f}, {len(keys)} "
             f"keys valid={run['results']['valid']}, every key the host's; "
             f"engines {dict(engines)}; launches single={single} "
             f"grid={grid} (the race may retire every key on the host)")

        # -- suites[localnode]: real processes -------------------------------
        label = "suites[localnode]"
        random.seed(label)
        test = localnode.localnode_test({
            "nodes": ["n1", "n2", "n3"], "base_port": _run_ports(3),
            "data_root": os.path.join(base, "nodes"), "store_base": sbase,
            "time_limit": 6, "device": SUITE_DEVICE,
            "lin_algorithm": "device"})
        out, wall, single, grid = counted(label, lambda: core.run(test))
        res = out["results"]
        nem = collections.Counter(op.f for op in out["history"]
                                  if op.process == "nemesis"
                                  and op.type == "info")
        keys = res["workload"]["results"]
        check(res["valid"] is True and nem["kill"] > 0
              and nem["restart"] > 0,
              f"{label}: valid={res['valid']} nemesis {dict(nem)}")
        _host_keys(label, store.latest(sbase)["history"],
                   {k: r["linear"]["valid"] for k, r in keys.items()}, hostb)
        engines = collections.Counter(r["linear"]["engine"]
                                      for r in keys.values())
        emit(f"{label}: wall_s={wall:.3f} events={len(out['history'])} "
             f"nemesis {dict(nem)}; {len(keys)} keys valid={res['valid']}, "
             f"every key the host's; engines {dict(engines)}; launches "
             f"single={single} grid={grid}")

        # -- suites[locknode]: the volatile server's double grant -------------
        label = "suites[locknode]"
        test = localnode.locknode_test({
            "base_port": _run_ports(1), "store_base": sbase,
            "data_root": os.path.join(base, "locknodes"),
            "lock_volatile": True, "concurrency": 2,
            "device": SUITE_DEVICE, "lin_algorithm": "device", "hb": False})
        test["generator"] = double_grant_generator(gen)
        out, wall, single, grid = counted(label, lambda: core.run(test))
        lin = out["results"]["linear"]
        _host_lock(label, store.latest(sbase)["history"], lin["valid"], hostb)
        grants = [op.type for op in out["history"]
                  if op.f == "acquire" and op.type != "invoke"]
        emit(f"{label}: wall_s={wall:.3f} acquires {grants}; valid="
             f"{lin['valid']} engine {lin.get('engine')}, the host's; "
             f"launches single={single} grid={grid}")
        check(lin["valid"] is False and grants == ["ok", "ok"],
              f"{label}: valid={lin['valid']} acquires {grants}")

        # -- suites[hazelcast]: BASELINE config 4 ----------------------------
        for broken in (False, True):
            label = f"suites[hazelcast{'-broken' if broken else ''}]"
            random.seed(label)
            svc = hazelcast.InProcessLockService()
            svc.broken = broken
            opts = {"nodes": ["n1", "n2"], "concurrency": 3,
                    "time_limit": 2, "rate": 100,
                    "workload": "lock-fixture", "store_base": sbase,
                    "device": SUITE_DEVICE, "lin_algorithm": "device",
                    "hb": False}
            test = hazelcast.hazelcast_test(opts) | {
                "name": "hazelcast-lock",
                "client": hazelcast.LockClient(svc)}
            out, wall, single, grid = counted(label, lambda: core.run(test))
            lin = out["results"]["workload"]["linear"]
            _host_lock(label, store.latest(sbase)["history"], lin["valid"],
                       hostb)
            n_ops = sum(1 for op in out["history"]
                        if isinstance(op.process, int)
                        and op.type != "invoke")
            emit(f"{label}: wall_s={wall:.3f} {n_ops} lock ops; valid="
                 f"{lin['valid']} engine {lin.get('engine')}, the host's; "
                 f"launches single={single} grid={grid}")
            check(lin["valid"] is (not broken),
                  f"{label}: valid={lin['valid']}")

        # -- suites[etcdemo-cli]: BASELINE config 1 as a user types it -------
        from jepsen_tpu_torch.models import cas_register

        label = "suites[etcdemo-cli]"
        d = os.path.join(base, "etcd")
        code, out, err, wall = _etcd_child(d, stale=False)
        run, keys, on_card, invalid = _stored_keys(label, d, code, wall)
        check(code == 0 and run["results"]["valid"] is True,
              f"{label}: exit {code}, valid={run['results']['valid']}; "
              f"errors {_error_paths(run['results'])[:5]}; {err[-1500:]}")
        check(2 * len(on_card) > len(keys) or SUITE_DEVICE != "cuda",
              f"{label}: B1-T searched {len(on_card)} of {len(keys)} keys "
              f"in the child, not most")

        # -- suites[etcdemo-stale]: one gateway serves stale reads -----------
        label = "suites[etcdemo-stale]"
        d = os.path.join(base, "etcd-stale")
        code, out, err, wall = _etcd_child(d, stale=True)
        run, keys, on_card, invalid = _stored_keys(label, d, code, wall)
        check(code == 1 and run["results"]["valid"] is False and invalid,
              f"{label}: exit {code}, valid={run['results']['valid']}, "
              f"invalid keys {invalid}; {err[-1500:]}")
        _host_keys(label, run["history"], {
            int(k): r["linear"]["valid"] for k, r in keys.items()}, hostb,
            model=cas_register())
        decided = sorted(k for k in invalid if str(k) in on_card)
        emit(f"{label}: every key the host's; invalid keys decided on B1-T "
             f"{decided}")
        check(decided or SUITE_DEVICE != "cuda",
              f"{label}: no invalid key was decided on B1-T")

        _cockroach_runs(base, hostb, counted)

        # -- the lint as a user runs it --------------------------------------
        label = "lint"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch.analyze.lint_suites",
             "--json"], cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        code, out, err = _finish(proc, timeout=300)
        wall = time.perf_counter() - t0
        payload = json_mod.loads(out) if code in (0, 1) else {}
        emit(f"{label}: python -m jepsen_tpu_torch.analyze.lint_suites "
             f"--json exit {code}, wall_s={wall:.3f}, errors "
             f"{payload.get('errors')}, warnings {payload.get('warnings')}")
        check(code == 0 and payload.get("errors") == 0,
              f"{label}: exit {code}; {out[-1500:]} {err[-1500:]}")
    finally:
        logger.removeHandler(quiet)

    # -- suites[web]: the results server on the phase's store -----------------
    label = "suites[web]"
    srv = web.make_server("127.0.0.1", 0, base=sbase)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    runs = sorted((name, t) for name, ts in store.tests(base=sbase).items()
                  for t in ts)
    try:
        def get(path):
            with urllib.request.urlopen(url + path, timeout=30) as r:
                return r.status, r.read()

        home = get("/")
        pages = {f"{n}/{t}": get(f"/files/{n}/{t}/") for n, t in runs}
        live = get(f"/api/live/{rel}")
        stats = get("/api/stats")
        zipped = get(f"/files/{rel}/?zip")
    finally:
        srv.shutdown()
        srv.server_close()
    shown = []
    for r, (status, body) in pages.items():
        with open(os.path.join(sbase, r, "results.json")) as f:
            res = json_mod.load(f)
        panels = [res] + [sub for _, sub in web._evidence_results(res)]
        has = any(isinstance(p.get("search_telemetry"), dict)
                  for p in panels)
        check(status == 200 and (b"device telemetry" in body) == has,
              f"{label}: {r}: {status}, telemetry in its panels {has}")
        if has:
            shown.append(r)
    snap = json_mod.loads(stats[1])
    dev_s = snap["jtpu_device_seconds_total"]["values"]
    live_d = json_mod.loads(live[1])
    emit(f"{label}: / {home[0]} ({len(home[1])} bytes, {len(runs)} runs), "
         f"{len(pages)} run pages 200, search telemetry shown on {shown}; "
         f"/api/live {live[0]} status={live_d.get('status')} "
         f"final={(live_d.get('final') or {}).get('valid')}, /api/stats "
         f"{stats[0]} jtpu_device_seconds_total={dev_s}, ?zip {zipped[0]} "
         f"{len(zipped[1])} bytes")
    check(home[0] == live[0] == stats[0] == zipped[0] == 200
          and all(f"{n}/{t}".encode() in home[1] for n, t in runs)
          and live_d.get("final") is not None and zipped[1][:2] == b"PK"
          and (dev_s > 0 and shown or SUITE_DEVICE != "cuda"),
          f"{label}: a route answered wrong")
    return launches


#: the campaign phase (:func:`phase_campaign`): ``python -m
#: jepsen_tpu_torch.live`` as a user types it, two families under kill -9
#: and restart for 5 s of workload a cell, every cell checked on the card
#: (``--lin-algorithm device``: the register family's keys of 30 ops sit
#: under the default route's 48-op host threshold); ``--rate 100`` so
#: that kills land on writes in flight and some keys defeat the greedy
#: witness; ``--cell-retries 0`` so that a failed cell, a kernel's
#: failure above all, is never hidden by a second attempt that passes.
#: The seeded cell keeps the JAX package's ``SEEDED`` settings
CAMPAIGN_CMD = ("--families", "register,replicated", "--nemeses",
                "kill-restart", "--time-limit", "5", "--rate", "100",
                "--lin-algorithm", "device", "--cell-retries", "0",
                "--json")
#: (family, nemesis, seeded) of that command's cells, in order;
#: tests/test_torch_campaign.py holds it to the JAX package's ``plan()``
CAMPAIGN_PLAN = (("register", "kill-restart", False),
                 ("replicated", "kill-restart", False),
                 ("replicated", "kill-restart", True))
#: campaigns at most: when the seeded cell's stage did not land (a valid
#: history: a kill-all whose amnesiac cluster first accepted a write),
#: :data:`CAMPAIGN_CMD` runs once more with the replicated family alone;
#: a second miss fails the phase
CAMPAIGN_SEEDED_ATTEMPTS = 2
#: the matrix rows that need nothing of the host; the phase prints the
#: ``--dry-run`` skip reasons of the others (clock, port partitions, disk
#: faults, links)
CAMPAIGN_ANYWHERE = ("kill-restart", "pause")
#: the cells' models: register's keys from the unset register, the
#: replicated family's from the V2 client's MISSING
CAMPAIGN_MODELS = {"register": None, "replicated": -1}


def _campaign_results(results) -> list:
    """Every checker result in a stored cell's results that names an
    engine (the lifted keys' ``linear`` results, a history's ``linear``),
    the stream's summaries left out."""
    out = []
    if isinstance(results, dict):
        if "engine" in results and "valid" in results \
                and not str(results["engine"]).startswith("stream"):
            out.append(results)
        for k, v in results.items():
            if k != "stream":
                out += _campaign_results(v)
    return out


def _dry_run_start(d) -> tuple:
    """``python -m jepsen_tpu_torch.live --dry-run --json`` started in
    ``d``: (the process, the rows not probed and why).  TcEngine's probe
    adds and deletes a qdisc on ``lo`` where ``tc`` is on the PATH and the
    caller is root; the script changes no setting of the host, so there
    it leaves the link rows out."""
    import shutil

    from jepsen_tpu_torch.live.matrix import standard_matrix

    rows = list(standard_matrix())
    link_rows = [r for r in rows if r.startswith("link-")]
    unprobed = None
    if shutil.which("tc") is not None and os.geteuid() == 0:
        unprobed = (f"{', '.join(link_rows)} not probed: `tc` is on the "
                    f"PATH and the script runs as root, where the link "
                    f"engines' probe adds and deletes a qdisc on lo")
        rows = [r for r in rows if r not in link_rows]
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.live", "--dry-run",
         "--json", "--nemeses", ",".join(rows)], cwd=d,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, unprobed


def _dry_run_rows(proc) -> tuple:
    """The started dry run's (exit code, {row: skip reason or "run"})."""
    code, out, err = _finish(proc, timeout=300)
    check(code == 0, f"campaign[dry-run]: exit {code}; {err[-1500:]}")
    cells = json.loads(out)
    # the rows of a family that can run them all (the link rows skip for
    # a family whose nodes exchange no packet)
    reasons = {c["nemesis"]: c["skip"] or "run" for c in cells
               if c["family"] == "replicated" and not c["seeded"]
               and c["nemesis"] not in CAMPAIGN_ANYWHERE}
    return code, reasons


def _kill_pidfiles(root) -> list:
    """SIGKILL every live pid a node's ``server.pid`` under ``root``
    names: a child that timed out leaves its daemons behind."""
    import glob
    import signal

    killed = []
    for pf in glob.glob(os.path.join(root, "*", "server.pid")):
        try:
            with open(pf) as f:
                pid = int(f.read().split()[0])
            os.kill(pid, signal.SIGKILL)
            killed.append(pid)
        except (OSError, ValueError, IndexError):
            pass
    return killed


def _campaign_child(base, sbase, argv) -> tuple:
    """``python -m jepsen_tpu_torch.live *argv`` in ``base`` (the package
    linked in); its daemons are killed if any outlive it: (exit code,
    stderr, wall seconds, the record of the campaign it wrote)."""
    data = argv[argv.index("--data-root") + 1]
    runs = os.path.join(sbase, "campaigns")
    before = set(os.listdir(runs)) if os.path.isdir(runs) else set()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.live", *argv], cwd=base,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        code, _out, err = _finish(proc, timeout=400)
    finally:
        left = _kill_pidfiles(data)
    wall = time.perf_counter() - t0
    check(code == 0 and not left, f"campaign: exit {code}, daemons left "
          f"behind {left}; {err[-2000:]}")
    [cid] = sorted(set(os.listdir(runs)) - before)
    with open(os.path.join(runs, cid, "campaign.json")) as f:
        return code, err, wall, json.load(f)


def _campaign_cell(c, sbase, hostb) -> tuple:
    """One cell of a campaign record, checked: ``ok``, no ``error`` in its
    results, each key or history's verdict the host WGL search's on the
    stored history, a plain cell valid with ``audit.ok`` and a fault at
    least.  (keys or histories on B1-T, their launches in the child from
    the stored ``search_telemetry`` slices)."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import cas_register

    tag = f"campaign[{c['family']}{'-seeded' if c['seeded'] else ''}]"
    check(c["status"] == "ok" and c["attempts"] == 1,
          f"{tag}: {c['status']} after {c['attempts']} attempt(s): "
          f"{c.get('reason')}")
    run = store.load(os.path.basename(os.path.dirname(c["store"])),
                     os.path.basename(c["store"]), sbase)
    res = run["results"]
    results = _campaign_results(res)
    engines = collections.Counter(r["engine"] for r in results)
    card = [r for r in results if r["engine"].startswith("device-bfs(cuda")]
    slices = sum((r.get("search_telemetry") or {}).get("slices", 0)
                 for r in card)
    det = c.get("detection") or {}
    emit(f"{tag}: valid={c['valid']} stream_valid={c.get('stream_valid')} "
         f"wall_s={c['wall_s']} ops={c['ops']} faults={c['faults']} "
         f"audit={c.get('audit')} detection={det.get('at')}/"
         f"{det.get('latency_s')}s recovery={c.get('recovery')} "
         f"phases={c.get('phases')}; engines {dict(engines)}; {len(card)} on "
         f"B1-T, {slices} B1-T launches in the child (search_telemetry "
         f"slices)")
    errors = _error_paths(res)
    check(not errors, f"{tag}: errors in the results {errors[:5]}")
    init = CAMPAIGN_MODELS[c["family"]]
    model = cas_register() if init is None else cas_register(init)
    if "workload" in res:
        _host_keys(tag, run["history"], {
            int(k): r["linear"]["valid"]
            for k, r in res["workload"]["results"].items()}, hostb,
            model=model, algorithm="host")
    else:
        want = linearizable(model, device="cpu", algorithm="host").check(
            {"store_base": hostb}, run["history"])
        check(want["valid"] is res["linear"]["valid"],
              f"{tag}: {res['linear']['valid']} on the card, "
              f"{want['valid']} on the host")
    if not c["seeded"]:
        check(c["valid"] is True and (c.get("audit") or {}).get("ok")
              and c["faults"] >= 1, f"{tag}: valid={c['valid']} audit "
              f"{c.get('audit')} faults {c['faults']}")
    return len(card), slices


@_timed_phase("campaign")
def phase_campaign(store_base):
    """The live fault-injection campaign on the card.

    ``campaign``: ``python -m jepsen_tpu_torch.live`` (:data:`CAMPAIGN_CMD`)
    in a child, with a store, a data root and a base port of the phase's
    own: the register family (localnode's three server processes, a key
    per node) and the replicated family (three replicas of a leader-lease
    KV group) under kill -9 and restart, and the seeded cell (a volatile
    replica under kill-all, the JAX package's ``SEEDED``).  Each cell is a
    whole ``core.run`` with the streaming checker and the certificate
    audit on.  The child exits 0, its cells are :data:`CAMPAIGN_PLAN`,
    every cell ``ok`` (:func:`_campaign_cell`); both plain cells valid
    with ``audit.ok`` and a fault at least; no result carries an
    ``error``; every key or history's verdict is the host WGL search's on
    the stored history; B1-T (``device-bfs(cuda...)``) decided a key or
    history of each family.  The seeded cell must be invalid with a
    detection.  Its stage is timing: a kill-all whose restarted, amnesiac
    cluster first accepts a write leaves a valid history, which the host
    confirms; then the replicated cells run again, once
    (:data:`CAMPAIGN_SEEDED_ATTEMPTS`), each cell checked alike and
    printed, and the misses are counted.  No cell is retried within a
    campaign (``--cell-retries 0``): each ran once.  The child's
    launches are not counted in process: the lines count them from the
    stored results.  ``campaign[dry-run]``: the skip reasons
    ``--dry-run`` gives on this host for the clock, partition, disk and
    link rows; ``campaign[sweep]``: ``--sweep`` of the data root exits 0.
    The two run beside the campaign child and the host's checks.
    Returns no in-process launch."""
    base = os.path.join(store_base, "campaign")
    sbase = os.path.join(base, "store")
    data = os.path.join(base, "nodes")
    hostb = os.path.join(base, "host")
    os.makedirs(base, exist_ok=True)
    link = os.path.join(base, "jepsen_tpu_torch")
    if not os.path.exists(link):
        os.symlink(REPO / "jepsen_tpu_torch", link)
    label = "campaign"
    own = ["--store-base", sbase, "--data-root", data, "--device",
           SUITE_DEVICE]
    dry, unprobed = _dry_run_start(base)
    children = [dry]
    try:
        argv = [*CAMPAIGN_CMD, *own, "--base-port", str(_run_ports(3))]
        code, err, wall, record = _campaign_child(base, sbase, argv)
        sweep = subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch.live", "--sweep",
             data], cwd=base, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        children.append(sweep)
        cells = record["cells"]
        got = tuple((c["family"], c["nemesis"], bool(c.get("seeded")))
                    for c in cells)
        emit(f"{label}: python -m jepsen_tpu_torch.live exit {code}, child "
             f"wall_s={wall:.3f}, cells {got}, summary {record['summary']}")
        check(got == CAMPAIGN_PLAN, f"{label}: cells {got}, want "
              f"{CAMPAIGN_PLAN}")
        on_card = collections.Counter()
        child_launches = 0
        seeded = []
        for attempt in range(CAMPAIGN_SEEDED_ATTEMPTS):
            if attempt:
                argv = list(CAMPAIGN_CMD)
                argv[argv.index("--families") + 1] = "replicated"
                argv += [*own, "--base-port", str(_run_ports(3))]
                code, err, wall, record = _campaign_child(base, sbase, argv)
                cells = record["cells"]
                emit(f"{label}: the seeded stage did not land; the "
                     f"replicated cells again (attempt {attempt + 1}): exit "
                     f"{code}, child wall_s={wall:.3f}, summary "
                     f"{record['summary']}")
            for c in cells:
                n, slices = _campaign_cell(c, sbase, hostb)
                on_card[c["family"]] += n
                child_launches += slices
                if c["seeded"]:
                    seeded.append(c)
            if seeded[-1]["valid"] is False:
                break
        misses = sum(c["valid"] is not False for c in seeded)
        emit(f"{label}: every verdict the host's; keys or histories on B1-T "
             f"by family {dict(on_card)}; {child_launches} B1-T launches "
             f"counted from the child's stored results; seeded cell valid "
             f"{[c['valid'] for c in seeded]}: {misses} miss(es) in "
             f"{len(seeded)} campaign(s)")
        check(seeded[-1]["valid"] is False and seeded[-1].get("detection"),
              f"{label}: the seeded cell was never invalid with a detection "
              f"in {len(seeded)} campaigns: "
              f"{[(c['valid'], c.get('detection')) for c in seeded]}")
        check(all(on_card[f] > 0 for f in ("register", "replicated"))
              or SUITE_DEVICE != "cuda",
              f"{label}: B1-T decided nothing of a family: {dict(on_card)}")

        # -- campaign[dry-run]: the host's skip reasons ----------------------
        code, reasons = _dry_run_rows(dry)
        emit(f"{label}[dry-run]: exit {code}; skip reasons on this host "
             f"{reasons}" + (f"; {unprobed}" if unprobed else ""))

        # -- campaign[sweep]: the rule journals under the data root ----------
        code, out, err = _finish(sweep, timeout=120)
        emit(f"{label}[sweep]: exit {code}: {out.strip()}")
        check(code == 0, f"{label}[sweep]: exit {code}; {err[-1500:]}")
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=30)
    return {}


#: the device contract's findings on the card, one per (route, code,
#: site): the torch step's host reads per level (the loop test, the
#: closure's start and its next round) and the sharded step's (its
#: merge widths, loop test and closure); the fused kernel's routes
#: (single key, the bucketed batch's grid and the sharded batch's
#: shards) are clean.  tests/test_torch_devlint.py pins the same set on
#: the CPU with the card's dispatch.
DEVLINT_FINDINGS = frozenset({
    ("single-torch", "K001", "jepsen_tpu_torch/checker/step.py:472"),
    ("single-torch", "K001", "jepsen_tpu_torch/checker/step.py:485"),
    ("single-torch", "K001", "jepsen_tpu_torch/checker/step.py:508"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:135"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:164"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:232"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:251"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:258"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:284"),
})

#: every route the registry enumerates, and the fused kernel's
DEVLINT_ROUTES = ("bucketed-batch", "cuda-fused", "mesh-sharded",
                  "single-torch", "window-sharded")
DEVLINT_B1_ROUTES = ("bucketed-batch", "cuda-fused", "mesh-sharded")


@_timed_phase("devlint")
def phase_devlint():
    """``python -m jepsen_tpu_torch.analyze --devlint --json`` in a fresh
    process on the card (its live K007 needs a cold kernel cache): every
    registered route listed, the fused kernel's routes clean with their
    compile spans captured and K007-clean, the findings exactly
    :data:`DEVLINT_FINDINGS`, exit 1 because they are errors.  The
    sweep's B1 launches join the counts."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.analyze", "--devlint",
         "--json"], cwd=str(REPO), capture_output=True, text=True,
        timeout=300)
    wall = time.perf_counter() - t0
    try:
        rep = json.loads(proc.stdout)
    except ValueError:
        raise SmokeFailure(f"devlint: no JSON (exit {proc.returncode}): "
                           f"{proc.stderr[-2000:]}") from None
    found = {tuple(f) for f in rep["findings"]}
    check(tuple(rep["routes"]) == DEVLINT_ROUTES,
          f"devlint: routes {rep['routes']}")
    dirty = {f for f in found if f[0] in DEVLINT_B1_ROUTES}
    check(not dirty and all(rep["spans"][r] > 0 for r in DEVLINT_B1_ROUTES),
          f"devlint: the fused kernel's routes: findings {sorted(dirty)}, "
          f"live compile spans {rep['spans']}")
    check(found == DEVLINT_FINDINGS, f"devlint: findings beyond the pinned "
          f"set {sorted(found - DEVLINT_FINDINGS)}, missing "
          f"{sorted(DEVLINT_FINDINGS - found)}")
    check(proc.returncode == (1 if rep["errors"] else 0) == 1,
          f"devlint: exit {proc.returncode} with {rep['errors']} errors")
    for form, n in rep["launches"].items():
        FORM_LAUNCHES[form] += n
        if form.startswith("grid"):
            CHILD_GRID_LAUNCHES[form] += n
    launches = {"single": sum(n for f, n in rep["launches"].items()
                              if f.startswith("single")),
                "grid": sum(n for f, n in rep["launches"].items()
                            if f.startswith("grid"))}
    check(launches["single"] > 0 and launches["grid"] > 0,
          f"devlint: B1 launches {rep['launches']}")
    emit(f"devlint: exit {proc.returncode}, {rep['errors']} error(s) over "
         f"{len(rep['routes'])} routes on {rep['device']}; findings "
         f"{len(found)} = the pinned set; B1 routes clean, live compile "
         f"spans {rep['spans']}; launches {rep['launches']}; command "
         f"wall_s={wall:.3f}")
    return {"devlint": launches}


def _ptxas(report: str) -> list:
    """(instantiation, registers, spill store bytes) of each kernel in
    nvcc's -Xptxas -v report."""
    import re

    out, name = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            t = re.search(r"level_loop_kernelILi(\d)ELb([01])ELb([01])E",
                          m.group(1))
            name = (f"SW={t.group(1)},KEYED={t.group(2)},TELE={t.group(3)}"
                    if t else m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "jepsen_tpu_torch").is_dir():
        print("chip_smoke: jepsen_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {name} x{torch.cuda.device_count()} torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    global CARD
    CARD = smi
    device = torch.device("cuda", 0)
    try:
        from jepsen_tpu_torch import _build

        _build.build_all()
        kernels = _ptxas(_build.PTXAS_REPORT.get("level_loop", ""))
        emit(f"build: {_build.BUILD_SECONDS:.2f} s; ptxas (kernel, "
             f"registers, spill store bytes): {sorted(kernels)}")
        check(len(kernels) == 16 and all(sp == 0 for _, _, sp in kernels),
              f"ptxas: want 16 kernels without spill stores, got "
              f"{sorted(kernels)}")
        worst = phase_lockstep(device)
        worst = max(worst, phase_grid_lockstep(device))
        with tempfile.TemporaryDirectory() as store_base:
            launches, captured, checked = phase_main_path(store_base)
            phase_masked_control()
            worst = max(worst, phase_lockstep_captured(captured))
            phase_default_route(store_base)
            launches["queues"] = phase_queues(store_base)
            launches.update(phase_batch256(store_base))
            launches.update(phase_batch256_decomposed(store_base))
            launches.update(phase_multireg256(store_base))
            launches["checkpoint"] = phase_checkpoint(store_base)
            launches.update(phase_stream(store_base))
            launches.update(phase_sharded())
            launches.update(phase_fleet(store_base))
            launches.update(phase_plan())
            shard_launches, shard_trace = phase_shard_tier(store_base)
            launches.update(shard_launches)
            launches.update(phase_corpus(store_base))
            launches.update(phase_fuzz(store_base))
            worst = max(worst, phase_fuzz_grid(device))
            launches.update(phase_mc(store_base))
            launches.update(phase_analyze_cli(store_base, checked["1k"]))
            launches.update(phase_live(store_base))
            launches.update(phase_checkers(store_base))
            launches.update(phase_run(store_base))
            launches.update(phase_suites(store_base))
            launches.update(phase_campaign(store_base))
            launches.update(phase_devlint())
            phase_report(shard_trace)
            shares = phase_traced(store_base)
        shapes = phase_timing(device, captured)
        grid_shapes = phase_grid_timing(device)
        shapes += grid_shapes
        check(OCCUPANCY_CHECKED, "no device result had its occupancy "
              "column checked against its configs")
        check(FORM_LAUNCHES["single,on"] > 0 and FORM_LAUNCHES["grid,on"] > 0,
              f"the main paths did not run the telemetry forms: "
              f"{dict(FORM_LAUNCHES)}")
        check(sum(GRID_RUNG_LAUNCHES.values())
              + sum(CHILD_GRID_LAUNCHES.values()) == FORM_LAUNCHES["grid,on"]
              + FORM_LAUNCHES["grid,off"],
              f"the main paths' grid launches by rung "
              f"{dict(GRID_RUNG_LAUNCHES)} and in a child "
              f"{dict(CHILD_GRID_LAUNCHES)} != {dict(FORM_LAUNCHES)} in all")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    timing = shapes[0]  # the first port's shape: mutex2k, F=64
    grid, grid_wide = grid_shapes
    emit(f"single-key form: mutex2k F=64 {timing['ms']:.4f} ms/slice, "
         f"telemetry form {timing['ms_tele']:.4f} "
         f"({MUTEX2K_F64_BEFORE_TELE_MS} ms/slice before the telemetry "
         f"form); grid form at batch256's first rung {grid['ms']:.4f} "
         f"ms/launch, telemetry form {grid['ms_tele']:.4f} "
         f"({GRID_FIRST_RUNG_BEFORE_TELE_MS} before the telemetry form), "
         f"device {grid['device_ms']:.4f} and wrapper host "
         f"{grid['host_ms']:.4f}; at {grid_wide['shape']} "
         f"{grid_wide['ms']:.4f} ms/launch; grid launches of the main "
         f"paths by rung and telemetry "
         f"{dict(sorted(GRID_RUNG_LAUNCHES.items()))} and "
         f"{dict(CHILD_GRID_LAUNCHES)} in devlint's child; occupancy checked "
         f"on {len(OCCUPANCY_CHECKED)} results; device share by path "
         f"{ {k: round(v, 4) for k, v in shares.items()} }; script wall "
         f"{time.perf_counter() - t_start:.1f} s of the 1200 s limit")
    total = sum(n for by_tier in launches.values() for n in by_tier.values())
    if total == 0 or sum(FORM_LAUNCHES.values()) != total:
        print(f"chip_smoke: FAILED: B1 launched {total} times on the main "
              f"path, {dict(FORM_LAUNCHES)} by form", file=sys.stderr)
        return 1
    record = {"kernels": [{
        "name": "level_loop",
        "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/level_loop.cu",
        "replaces": "jepsen_tpu/checker/pallas_level.py:132",
        "launches": total,
        "launches_by_path": launches,
        "launches_by_form": dict(FORM_LAUNCHES),
        "grid_launches_by_rung": dict(sorted(GRID_RUNG_LAUNCHES.items())),
        "grid_launches_in_a_child": dict(CHILD_GRID_LAUNCHES),
        "max_abs_err": max([worst] + [t["max_abs_err"] for t in shapes]),
        "ms": timing["ms"],
        "ms_tele": timing["ms_tele"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "shapes": [{k: t[k] for k in ("shape", "levels", "ms", "ms_tele",
                                      "device_ms", "host_ms",
                                      "plain_ms", "single_key_ms",
                                      "bound_ms", "bound_by") if k in t}
                   for t in shapes],
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
