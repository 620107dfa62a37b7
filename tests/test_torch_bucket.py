"""The port's shape buckets against the JAX package's: ``bucket_key``,
``_bucket_cost`` and ``plan_buckets`` on random key sets, and
``search_batch_bucketed`` on keys of mixed shapes, per key and in its
``bucket_batch`` stats (apart from the wall seconds and the slice
function cache, which differ by nature).  The tolerance is exact
equality."""

import random

import pytest

import jepsen_tpu.checker.bucket as jbucket
import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import models as jm
from jepsen_tpu import synth as js
from jepsen_tpu.history import encode_ops as j_encode_ops
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.checker import bucket as tbucket
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.history import encode_ops as t_encode_ops

FIELDS = ("valid", "configs", "max_depth", "engine", "linearization",
          "witness_dropped", "frontier_dropped")


@pytest.fixture(autouse=True)
def _reference_knobs(monkeypatch):
    for knob in ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
                 "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_BATCH_BUCKETS"):
        monkeypatch.delenv(knob, raising=False)


def _random_keys(rng, n):
    return [(rng.choice((64, 128, 256, 512)), rng.choice((32, 64)),
             rng.choice((32, 64))) for _ in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_plan_buckets_matches_reference(seed):
    rng = random.Random(f"plan-{seed}")
    keys = _random_keys(rng, rng.randrange(1, 60))
    for cap in (1, 2, 3, 8, 64):
        assert tbucket.plan_buckets(keys, cap) == \
            jbucket.plan_buckets(keys, cap), cap
    for k in set(keys):
        assert tbucket._bucket_cost(k, 7) == jbucket._bucket_cost(k, 7)


def _mixed(synth, models, encode):
    """Keys of 20 to 110 ops, with and without crashed ops, every third
    one corrupted: several buckets."""
    m = models.cas_register()
    out = []
    for k in range(10):
        rng = random.Random(f"mixed-{k}")
        h = synth.register_history(
            rng, n_ops=20 + 10 * k, n_procs=3 + k % 4, overlap=3,
            crash_p=0.02 * (k % 3), max_crashes=2, n_values=3)
        if k % 3 == 0:
            h = synth.corrupt_read(rng, h, at=0.8)
        out.append(encode(h, m.f_codes))
    return out, m


@pytest.fixture(scope="module")
def mixed():
    return _mixed(js, jm, j_encode_ops), _mixed(ts, tm, t_encode_ops)


def test_bucket_key_matches_reference(mixed):
    (sj, _), (st, _) = mixed
    kj = [jbucket.bucket_key(lin.encode_search(s)) for s in sj]
    kt = [tbucket.bucket_key(tlin.encode_search(s)) for s in st]
    assert kt == kj
    assert len(set(kt)) > 1


def _stats(r):
    s = dict(r["bucket_batch"])
    s.pop("seconds")
    s.pop("kernel_cache")
    s["buckets"] = [{k: v for k, v in b.items() if k != "seconds"}
                    for b in s["buckets"]]
    return s


@pytest.mark.parametrize("cap", [8, 2])
def test_search_batch_bucketed_matches_reference(mixed, monkeypatch, cap):
    """Per key and in the stats, at the default cap and with the buckets
    merged down to two."""
    (sj, mj), (st, mt) = mixed
    monkeypatch.setattr(tbucket, "MAX_BUCKETS", cap)
    monkeypatch.setenv("JEPSEN_TPU_BATCH_BUCKETS", str(cap))
    rj = jbucket.search_batch_bucketed(sj, mj)
    rt = tbucket.search_batch_bucketed(st, mt, device="cpu")
    for k, (a, b) in enumerate(zip(rj, rt)):
        assert {f: b.get(f) for f in FIELDS} == \
            {f: a.get(f) for f in FIELDS}, k
    assert _stats(rt[0]) == _stats(rj[0])
    assert rt[0]["bucket_batch"]["n_buckets"] == min(
        cap, len({tbucket.bucket_key(tlin.encode_search(s)) for s in st}))
    kc = rt[0]["bucket_batch"]["kernel_cache"]
    assert set(kc) == {"hits", "misses"} and kc["hits"] + kc["misses"] >= 1
