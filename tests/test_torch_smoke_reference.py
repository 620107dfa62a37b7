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
