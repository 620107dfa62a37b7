"""The port's model steps against the JAX package's: ``tstep`` must agree
exactly with ``jstep`` (elementwise, on arbitrary int32 inputs) and with
``pystep`` (on legal random walks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.history import NIL
from jepsen_tpu_torch import models as tm

MODELS = {
    "register": (jm.register(0), tm.register(0), [
        ("read", 0, NIL), ("read", 1, NIL), ("read", NIL, NIL),
        ("write", 3, NIL), ("write", -1, NIL)]),
    "cas-register": (jm.cas_register(0), tm.cas_register(0), [
        ("read", 0, NIL), ("read", 2, NIL), ("read", NIL, NIL),
        ("write", 4, NIL), ("cas", 0, 9), ("cas", 7, 9)]),
    "mutex": (jm.mutex(), tm.mutex(), [
        ("acquire", NIL, NIL), ("release", NIL, NIL)]),
    "noop": (jm.noop(), tm.noop(), [("anything", 1, 2), ("x", NIL, 3)]),
}


def _tstep(model, state, f, v1, v2):
    s2, legal = model.tstep(torch.tensor([state], dtype=torch.int32),
                            torch.tensor(f, dtype=torch.int32),
                            torch.tensor(v1, dtype=torch.int32),
                            torch.tensor(v2, dtype=torch.int32))
    return tuple(int(x) for x in s2.reshape(-1)), bool(legal)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_spec_matches_reference(name):
    jmodel, tmodel, _ = MODELS[name]
    assert tmodel.name == jmodel.name
    assert tmodel.state_width == jmodel.state_width
    assert tmodel.init == jmodel.init
    for fname in ("read", "write", "cas", "acquire", "release"):
        assert (fname in tmodel.f_codes) == (fname in jmodel.f_codes)
        if fname in jmodel.f_codes:
            assert tmodel.f_codes[fname] == jmodel.f_codes[fname]


@pytest.mark.parametrize("name", list(MODELS))
def test_tstep_matches_pystep_on_random_walks(name):
    jmodel, tmodel, ops = MODELS[name]
    rng = np.random.default_rng(0)
    states = [tmodel.init]
    for _ in range(60):
        state = states[rng.integers(len(states))]
        fname, v1, v2 = ops[rng.integers(len(ops))]
        code = tmodel.f_codes[fname]
        py = tmodel.pystep(state, code, v1, v2)
        assert py == jmodel.pystep(state, code, v1, v2)
        ts, legal = _tstep(tmodel, state, code, v1, v2)
        if py is None:
            assert not legal, (name, state, fname, v1, v2)
        else:
            assert legal and ts == py, (name, state, fname, v1, v2)
            states.append(py)


@pytest.mark.parametrize("name", list(MODELS))
def test_tstep_matches_jstep_elementwise(name):
    """Batched over arbitrary int32 inputs, padding f codes included:
    the device search steps every lane, legal or not."""
    jmodel, tmodel, _ = MODELS[name]
    rng = np.random.default_rng(7)
    n = 512
    vals = np.array([NIL, -1, 0, 1, 2, 3, 2**31 - 1], np.int32)
    state = rng.choice(vals, size=(n, 1)).astype(np.int32)
    f = rng.integers(0, 4, size=n).astype(np.int32)
    v1 = rng.choice(vals, size=n).astype(np.int32)
    v2 = rng.choice(vals, size=n).astype(np.int32)
    js, jl = jax.vmap(jmodel.jstep)(jnp.asarray(state), jnp.asarray(f),
                                    jnp.asarray(v1), jnp.asarray(v2))
    ts, tl = tmodel.tstep(torch.from_numpy(state), torch.from_numpy(f),
                          torch.from_numpy(v1), torch.from_numpy(v2))
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert ts.dtype == torch.int32


def test_kernel_ids_are_distinct():
    ids = {m.kernel_id for _, m, _ in MODELS.values()}
    assert ids == {tm.K_REGISTER, tm.K_CAS_REGISTER, tm.K_MUTEX, tm.K_NOOP}


# ---------------------------------------------------------------------------
# the three models the fused kernel does not take: multi-register and the
# two queues (state 3 and 16 words wide, no kernel_id)
# ---------------------------------------------------------------------------

Q_EMPTY = jm.Q_EMPTY

WIDE = {
    "multi-register": (jm.multi_register(3), tm.multi_register(3)),
    "multi-register-init": (jm.multi_register(2, 5),
                            tm.multi_register(2, 5)),
    "unordered-queue": (jm.unordered_queue(16), tm.unordered_queue(16)),
    "unordered-queue-4": (jm.unordered_queue(4), tm.unordered_queue(4)),
    "fifo-queue": (jm.fifo_queue(16), tm.fifo_queue(16)),
    "fifo-queue-4": (jm.fifo_queue(4), tm.fifo_queue(4)),
}


def _random_op(rng, model):
    """(f code, v1, v2) with NIL values, out-of-range keys and repeats."""
    vals = [NIL, 0, 1, 2, 3]
    if model.name == "multi-register":
        return (int(rng.integers(2)), int(rng.choice([NIL, -1, 0, 1, 2, 3])),
                int(rng.choice(vals)))
    return int(rng.integers(2)), int(rng.choice(vals)), NIL


def test_wide_model_constants_match_reference():
    assert (tm.Q_ENQ, tm.Q_DEQ, tm.Q_EMPTY) == (jm.Q_ENQ, jm.Q_DEQ,
                                                jm.Q_EMPTY)
    for jmodel, tmodel in WIDE.values():
        assert (tmodel.name, tmodel.state_width, tmodel.init,
                dict(tmodel.f_codes)) == (jmodel.name, jmodel.state_width,
                                          jmodel.init, dict(jmodel.f_codes))
        assert tmodel.kernel_id is None


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_pystep_and_tstep_on_random_walks(name):
    """Seeded walks from the initial state, queues filled past their
    capacity: the port's ``pystep`` equals the reference's, and
    ``tstep`` agrees with it on every step, legal or not."""
    jmodel, tmodel = WIDE[name]
    rng = np.random.default_rng(11)
    states = [tmodel.init]
    for _ in range(300):
        state = states[-1 if rng.random() < 0.8
                       else rng.integers(len(states))]
        f, v1, v2 = _random_op(rng, tmodel)
        if rng.random() < 0.4 and "queue" in name:
            f, v1 = tm.Q_ENQ, int(rng.integers(0, 9))  # grow toward full
        py = tmodel.pystep(state, f, v1, v2)
        assert py == jmodel.pystep(state, f, v1, v2)
        ts, legal = tmodel.tstep(torch.tensor(state, dtype=torch.int32),
                                 torch.tensor(f, dtype=torch.int32),
                                 torch.tensor(v1, dtype=torch.int32),
                                 torch.tensor(v2, dtype=torch.int32))
        if py is None:
            assert not bool(legal), (name, state, f, v1, v2)
        else:
            assert bool(legal) and tuple(int(x) for x in ts) == py
            states.append(py)
    if "queue" in name:
        assert any(s[-1] != Q_EMPTY for s in states), "never filled"


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_tstep_matches_jstep_elementwise(name):
    """Batched over arbitrary int32 states (full, empty, unsorted, NIL
    lanes) and ops: exact equality with ``jax.vmap(jstep)``."""
    jmodel, tmodel = WIDE[name]
    rng = np.random.default_rng(23)
    n, w = 1024, tmodel.state_width
    vals = np.array([NIL, -1, 0, 1, 2, 3, Q_EMPTY], np.int32)
    state = rng.choice(vals, size=(n, w)).astype(np.int32)
    full = rng.random(n) < 0.25
    state[full] = rng.integers(0, 4, size=(int(full.sum()), w))
    f = rng.integers(0, 3, size=n).astype(np.int32)
    v1 = rng.choice(vals, size=n).astype(np.int32)
    v2 = rng.choice(vals, size=n).astype(np.int32)
    js, jl = jax.vmap(jmodel.jstep)(jnp.asarray(state), jnp.asarray(f),
                                    jnp.asarray(v1), jnp.asarray(v2))
    ts, tl = tmodel.tstep(torch.from_numpy(state), torch.from_numpy(f),
                          torch.from_numpy(v1), torch.from_numpy(v2))
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert ts.dtype == torch.int32
    # the search's shape: rows broadcast over K candidate lanes
    ts3, tl3 = tmodel.tstep(torch.from_numpy(state[:8, None, :]).expand(
        8, 4, w), torch.from_numpy(f[:32].reshape(8, 4)),
        torch.from_numpy(v1[:32].reshape(8, 4)),
        torch.from_numpy(v2[:32].reshape(8, 4)))
    tsf, tlf = tmodel.tstep(torch.from_numpy(np.repeat(state[:8], 4, 0)),
                            torch.from_numpy(f[:32]),
                            torch.from_numpy(v1[:32]),
                            torch.from_numpy(v2[:32]))
    assert torch.equal(ts3.reshape(32, w), tsf)
    assert torch.equal(tl3.reshape(32), tlf)
