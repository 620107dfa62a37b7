"""The reference numbers ``chip_smoke.py`` holds the card to, recomputed
by the JAX package on the CPU from the same histories: the bench tiers'
device search with the JAX package's defaults (``REFERENCE_REDUCED``,
``PREPASS_REASON``) and the queue histories' verdicts (``QUEUES``)."""

import pytest

import chip_smoke
import jepsen_tpu.checker.linearizable as lin
from jepsen_tpu import models as jm
from jepsen_tpu.checker import linear as jlinear
from jepsen_tpu.history import OpSeq
from test_torch_search import reference_defaults


def _jax(seq):
    """A port OpSeq as the JAX package's (the same columns)."""
    return OpSeq(process=seq.process, f=seq.f, v1=seq.v1, v2=seq.v2,
                 inv=seq.inv, ret=seq.ret, ok=seq.ok, ops=[], encoder=None)


@pytest.mark.parametrize("tier", ["mutex2k", "1k"])
def test_reduced_tier_reference(tier, monkeypatch):
    reference_defaults(monkeypatch)
    monkeypatch.setattr(lin, "_SLICE_TARGET_S", 1e9)
    seq, _model = chip_smoke.tier_history(tier)
    model = jm.mutex() if tier == "mutex2k" else jm.cas_register()
    out = lin.search_opseq(_jax(seq), model)
    assert (out["valid"], out["configs"], out["max_depth"]) == \
        chip_smoke.REFERENCE_REDUCED[tier]
    stats = out.get("hb") or out.get("constraints")
    want = chip_smoke.PREPASS_REASON[tier]
    if want is None:
        assert stats["decided"] is None
    else:
        assert stats["decided"] is False and stats["reason"] == want


@pytest.mark.parametrize("name,fifo,want", chip_smoke.QUEUES)
def test_queue_verdicts(name, fifo, want, monkeypatch):
    reference_defaults(monkeypatch)
    seq, model = chip_smoke.queue_history(name, fifo=fifo)
    assert model.state_width == 16
    jmodel = (jm.fifo_queue if fifo else jm.unordered_queue)(16)
    out = jlinear.check_opseq_linear(_jax(seq), jmodel)
    assert out["valid"] is want


def test_batch256_reference(monkeypatch):
    """The batch256 keys' per-key verdicts, configs and depths
    (``BATCH256_*``): the JAX package's ``search_batch`` with DPOR off."""
    reference_defaults(monkeypatch)
    keys, _model = chip_smoke.batch_keys()
    out = lin.search_batch([_jax(s) for s in keys], jm.cas_register(),
                           dpor=False)
    assert {k for k, r in enumerate(out) if r["valid"] is False} == \
        chip_smoke.BATCH256_INVALID
    assert all(r["valid"] is True for k, r in enumerate(out)
               if k not in chip_smoke.BATCH256_INVALID)
    assert tuple(r["configs"] for r in out) == chip_smoke.BATCH256_CONFIGS
    assert tuple(r["max_depth"] for r in out) == chip_smoke.BATCH256_DEPTH
