"""The port's multi-core host comparator (``checker/parallel.py``) against
the JAX package's: the portfolio race and the key pool on the same
histories give the same verdicts, and ``check_opseq(order_seed=)`` walks
the same candidate orders as the JAX package's search.

The builders are module-level, as both packages' spawned workers need:
the workers import this module again, so the JAX package is imported
inside the tests and the JAX builders only."""

import random

import pytest

from jepsen_tpu_torch.checker.parallel import (batch_check_pool,
                                               portfolio_check)
from jepsen_tpu_torch.checker.seq import check_opseq
from jepsen_tpu_torch.history import encode_ops
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.synth import corrupt_read, register_history


def _mk_history(seed: int, corrupt: bool, *, jax: bool = False):
    """(seq, model) of ``tests/test_parallel.py``'s history, built by the
    JAX package (``jax``) or the port."""
    if jax:
        from jepsen_tpu.history import encode_ops as enc
        from jepsen_tpu.models import cas_register as cas
        from jepsen_tpu.synth import corrupt_read as corrupt_
        from jepsen_tpu.synth import register_history as reg
    else:
        enc, cas, corrupt_, reg = (encode_ops, cas_register, corrupt_read,
                                   register_history)
    model = cas()
    rng = random.Random(seed)
    h = reg(rng, n_ops=60, n_procs=4, overlap=4, n_values=3)
    if corrupt:
        h = corrupt_(rng, h, at=0.7)
    return enc(h, model.f_codes), model


# module-level builders (spawned workers re-import this module)


def build_invalid():
    return _mk_history(5, True)


def build_valid():
    return _mk_history(6, False)


def build_key(k: int):
    return _mk_history(100 + k, k % 2 == 0)


def build_invalid_jax():
    return _mk_history(5, True, jax=True)


def build_valid_jax():
    return _mk_history(6, False, jax=True)


def build_key_jax(k: int):
    return _mk_history(100 + k, k % 2 == 0, jax=True)


@pytest.fixture
def jax_parallel(monkeypatch):
    """The JAX package's comparator with its pass knobs unset, so its
    workers run the defaults the port always runs."""
    for knob in ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
                 "JEPSEN_TPU_AUDIT"):
        monkeypatch.delenv(knob, raising=False)
    from jepsen_tpu.checker import parallel

    return parallel


@pytest.mark.parametrize("build,jbuild,want", [
    (build_invalid, build_invalid_jax, False),
    (build_valid, build_valid_jax, True)], ids=["invalid", "valid"])
def test_portfolio_verdict_as_reference(jax_parallel, build, jbuild, want):
    out = portfolio_check(build, n_procs=2, deadline_s=120)
    ref = jax_parallel.portfolio_check(jbuild, n_procs=2, deadline_s=120)
    assert out["valid"] is ref["valid"] is want
    assert out["engine"].startswith("host2(")
    assert out["n_procs"] == ref["n_procs"] == 2
    assert out["seconds"] >= 0


def test_batch_pool_verdicts_as_reference(jax_parallel):
    out = batch_check_pool(build_key, 6, n_procs=2, deadline_s=240)
    ref = jax_parallel.batch_check_pool(build_key_jax, 6, n_procs=2,
                                        deadline_s=240)
    assert out["keys_done"] == ref["keys_done"] == 6
    assert out["verdicts"] == ref["verdicts"]
    for k, v in out["verdicts"].items():
        assert v is (k % 2 != 0), (k, v)
    assert out["n_procs"] == ref["n_procs"] == 2


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("hist", [(5, True), (6, False), (104, True)])
def test_order_seed_walks_the_reference_order(monkeypatch, seed, hist):
    """One process, one hash seed: the same configurations in the same
    order, so the same counts, witness and frontier, with and without
    the reductions."""
    for knob in ("JEPSEN_TPU_LINT", "JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR",
                 "JEPSEN_TPU_AUDIT"):
        monkeypatch.delenv(knob, raising=False)
    from jepsen_tpu.checker import seq as jseq

    seq, model = _mk_history(*hist)
    jseq_, jmodel = _mk_history(*hist, jax=True)
    for kw in ({}, {"hb": False, "dpor": False}):
        got = check_opseq(seq, model, order_seed=seed, **kw)
        want = jseq.check_opseq(jseq_, jmodel, order_seed=seed, **kw)
        for k in ("valid", "configs", "max_depth", "linearization",
                  "final_ops", "final_paths", "dpor"):
            assert got.get(k) == want.get(k), (k, kw)
    # the order changes the walk, never the verdict
    plain = check_opseq(seq, model, hb=False, dpor=False)
    assert plain["valid"] is check_opseq(seq, model, order_seed=seed,
                                         hb=False, dpor=False)["valid"]
