"""The port's key-sharded batch (B8, ``search_batch(sharding=)``) on
``ShardMesh(["cpu"] * 8)`` against the JAX package's single-device
``search_batch``, key for key.

The JAX package's own sharded batch does not run on this image's jax
(``shard_map(check_rep=)``, ``ROADMAP.md`` §C); by its own contract it is
verdict-identical, key for key, to its single-device batch at the same
dims (``bucket.search_batch_sharded_bucketed``'s docstring,
``tests/test_sharded.py::test_sharded_pad_lanes_inert``), so that is
what the port is held to:

  * the two mixed batches of ``tests/test_sharded.py`` (small, medium
    and big keys, crashed ops, valid and invalid keys, keys the greedy
    witness and the prepass decide), bucket-then-shard and fused: every
    key's verdict, configs, depth, engine and certificate fields, every
    certificate audited, and the ``shard_batch`` stats' invariants;
  * inert pad keys: 3 keys on 8 shards (5 pad keys) bill nothing, per
    key and in the telemetry, against the unsharded batch at the same
    dims.

On the CPU nothing is stripped: the keys keep their reductions, as the
JAX package's sharded batch keeps them."""

import random

import pytest
import torch

import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.history import encode_ops as j_encode_ops
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.analyze.audit import audit as t_audit
from jepsen_tpu_torch.checker import encode as tenc
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.distributed import ShardMesh
from jepsen_tpu_torch.history import encode_ops as t_encode_ops

D = 8
TMESH = ShardMesh(["cpu"] * D)
FIELDS = ("valid", "configs", "max_depth", "engine", "linearization",
          "witness_dropped", "frontier_dropped", "final_ops", "hb_cycle")


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """The level cap pinned in both packages, the JAX package's knobs
    unset, torch on one thread."""
    for mod in (lin, tlin):
        monkeypatch.setattr(mod, "_adapt_lvl_cap",
                            lambda cap, dt, target_s=None: cap)
    for knob in ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
                 "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_TELEMETRY",
                 "JEPSEN_TPU_BATCH_BUCKETS"):
        monkeypatch.delenv(knob, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mixed_batch(synth, models, encode, seed0, n=12):
    """The reference's differential-fuzz key mix (``tests/test_sharded.py``
    ``_mixed_batch``) in one package."""
    model = models.cas_register()
    seqs = []
    for k in range(n):
        rng = random.Random(seed0 + k)
        n_ops = (28, 50, 90)[k % 3]
        cas = k % 4 != 3
        h = synth.register_history(rng, n_ops=n_ops, n_procs=5, overlap=4,
                                   crash_p=0.1 if k % 3 == 0 else 0.0,
                                   cas=cas)
        if k % 2 == 0 or not cas:
            h = synth.corrupt_read(rng, h, at=0.8)
        seqs.append(encode(h, model.f_codes))
    return seqs, model


_REFERENCE: dict = {}


def _reference(seed0):
    """(port seqs, port model, the JAX package's single-device results),
    the JAX side computed once per batch."""
    if seed0 not in _REFERENCE:
        sj, mj = _mixed_batch(js, jm, j_encode_ops, seed0)
        _REFERENCE[seed0] = lin.search_batch(sj, mj, budget=400_000)
    st, mt = _mixed_batch(ts, tm, t_encode_ops, seed0)
    return st, mt, _REFERENCE[seed0]


@pytest.mark.parametrize("bucket", [None, False], ids=["bucketed", "fused"])
@pytest.mark.parametrize("seed0", [5200, 6300])
def test_sharded_batch_matches_single_device_reference(seed0, bucket):
    st, mt, ref = _reference(seed0)
    got = tlin.search_batch(st, mt, budget=400_000, sharding=TMESH,
                            bucket=bucket, audit=True)
    assert len(got) == len(ref)
    for k, (r, g) in enumerate(zip(ref, got)):
        for f in FIELDS:
            assert g.get(f) == r.get(f), (k, f, r.get(f), g.get(f))
        a = t_audit(st[k], mt, g)
        assert a["ok"], (k, [str(d) for d in a["diagnostics"]])
    assert any(g["engine"] == "device-batch" for g in got)
    # the batch's telemetry rides its first result (the fused route's
    # first device key, as the JAX package's fused route puts it)
    assert sum("search_telemetry" in g for g in got) >= 1
    sb = got[0].get("shard_batch")
    if bucket is False:
        assert sb is None
        return
    assert sb and sb["n_devices"] == D
    disposed = (sb["greedy"] + sb["hb_decided"] + sb["constraint_decided"]
                + sb["hard"])
    searched = sum(b["searched"] for b in sb["buckets"])
    assert disposed + searched == len(st)
    # the non-CAS corrupt keys never reach a device bucket
    assert sb["hb_decided"] + sb["constraint_decided"] > 0
    assert sb["pad_keys"] == sum(b["pad_lanes"] for b in sb["buckets"])
    for b in sb["buckets"]:
        if b["searched"]:
            assert b["lanes"] % D == 0
            assert b["lanes"] == b["searched"] + b["pad_lanes"]
    assert sb["overflow_redo"] == 0 and sb["shard_map"] is True


def _three(synth, models, encode):
    model = models.cas_register()
    seqs = []
    for k in range(3):
        rng = random.Random(7100 + k)
        h = synth.register_history(rng, n_ops=40, n_procs=5, overlap=4)
        seqs.append(encode(synth.corrupt_read(rng, h, at=0.85),
                           model.f_codes))
    return seqs, model


def test_sharded_pad_lanes_inert():
    """3 keys on 8 shards, 5 of the lanes inert pad keys: per-key
    configs and the telemetry block's counters equal the JAX package's
    unsharded batch at the same dims, so the pad keys billed nothing."""
    sj, mj = _three(js, jm, j_encode_ops)
    st, mt = _three(ts, tm, t_encode_ops)
    dj = lin.batch_dims([lin.encode_search(s) for s in sj], mj, frontier=64)
    dt = tlin.batch_dims([tenc.encode_search(s) for s in st], mt,
                         frontier=64)
    assert dj.__dict__ == dt.__dict__
    ref = lin.search_batch(sj, mj, budget=400_000, dims=dj, audit=False)
    got = tlin.search_batch(st, mt, budget=400_000, dims=dt, sharding=TMESH,
                            audit=False)
    assert [g["engine"] for g in got] == ["device-batch"] * 3
    for f in ("valid", "configs", "max_depth"):
        assert [g[f] for g in got] == [r[f] for r in ref], f
    tr, tg = ref[0]["search_telemetry"], got[0]["search_telemetry"]
    for f in ("expanded", "mask_killed", "dedup_folds", "goals",
              "max_occupancy", "crash_rounds", "overflows"):
        assert tg[f] == tr[f], (f, tr[f], tg[f])
