"""Consistency models over fixed-width int32 state.

Each :class:`ModelSpec` carries two step implementations with identical
semantics:

  * ``pystep(state, f, v1, v2) -> state' | None`` — plain Python, for the
    host oracle and the greedy witness;
  * ``tstep(state[..., w], f, v1, v2) -> (state'[..., w], legal)`` —
    elementwise torch over any leading batch shape, for the device search.

``kernel_id`` selects the same step inside the CUDA level-loop kernel
(``csrc/level_loop.cu``, ``model_step``).  Values are int32 lanes;
:data:`~jepsen_tpu_torch.history.NIL` is an unknown value, always legal
to read and never a state change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from .history import NIL

State = Tuple[int, ...]

#: CUDA kernel model ids (switch in csrc/level_loop.cu)
K_REGISTER, K_CAS_REGISTER, K_MUTEX, K_NOOP = 0, 1, 2, 3


@dataclass(frozen=True)
class ModelSpec:
    name: str
    f_codes: dict
    state_width: int
    init: State
    pystep: Callable[[State, int, int, int], Optional[State]]
    tstep: Callable
    kernel_id: int


# ---------------------------------------------------------------------------
# register / cas-register
# ---------------------------------------------------------------------------

R_READ, R_WRITE, R_CAS = 0, 1, 2


def _register_pystep(state, f, v1, v2):
    (val,) = state
    if f == R_READ:
        return state if (v1 == NIL or v1 == val) else None
    if f == R_WRITE:
        return (v1,)
    raise ValueError(f"register: bad f code {f}")


def _register_tstep(state, f, v1, v2):
    val = state[..., 0]
    legal = torch.where(f == R_READ, (v1 == NIL) | (v1 == val), True)
    new_val = torch.where(f == R_WRITE, v1, val)
    return new_val.unsqueeze(-1), legal


def register(initial: int = 0) -> ModelSpec:
    """A read/write register holding one int."""
    return ModelSpec(
        name="register", f_codes={"read": R_READ, "write": R_WRITE},
        state_width=1, init=(initial,), pystep=_register_pystep,
        tstep=_register_tstep, kernel_id=K_REGISTER)


def _cas_register_pystep(state, f, v1, v2):
    (val,) = state
    if f == R_READ:
        return state if (v1 == NIL or v1 == val) else None
    if f == R_WRITE:
        return (v1,)
    if f == R_CAS:
        return (v2,) if val == v1 else None
    raise ValueError(f"cas-register: bad f code {f}")


def _cas_register_tstep(state, f, v1, v2):
    val = state[..., 0]
    read_legal = (v1 == NIL) | (v1 == val)
    cas_legal = v1 == val
    legal = torch.where(f == R_READ, read_legal,
                        torch.where(f == R_CAS, cas_legal, True))
    new_val = torch.where(f == R_WRITE, v1,
                          torch.where((f == R_CAS) & cas_legal, v2, val))
    return new_val.unsqueeze(-1), legal


def cas_register(initial: int = NIL) -> ModelSpec:
    """Read/write/cas register; ``cas`` takes [expected, new].  The
    default initial state NIL is an unset register."""
    return ModelSpec(
        name="cas-register",
        f_codes={"read": R_READ, "write": R_WRITE, "cas": R_CAS},
        state_width=1, init=(initial,), pystep=_cas_register_pystep,
        tstep=_cas_register_tstep, kernel_id=K_CAS_REGISTER)


# ---------------------------------------------------------------------------
# mutex
# ---------------------------------------------------------------------------

M_ACQUIRE, M_RELEASE = 0, 1


def _mutex_pystep(state, f, v1, v2):
    (locked,) = state
    if f == M_ACQUIRE:
        return (1,) if not locked else None
    if f == M_RELEASE:
        return (0,) if locked else None
    raise ValueError(f"mutex: bad f code {f}")


def _mutex_tstep(state, f, v1, v2):
    locked = state[..., 0]
    legal = torch.where(f == M_ACQUIRE, locked == 0, locked == 1)
    new_locked = (f == M_ACQUIRE).to(locked.dtype)
    return torch.where(legal, new_locked, locked).unsqueeze(-1), legal


def mutex() -> ModelSpec:
    return ModelSpec(
        name="mutex", f_codes={"acquire": M_ACQUIRE, "release": M_RELEASE},
        state_width=1, init=(0,), pystep=_mutex_pystep,
        tstep=_mutex_tstep, kernel_id=K_MUTEX)


# ---------------------------------------------------------------------------
# noop
# ---------------------------------------------------------------------------


def _noop_pystep(state, f, v1, v2):
    return state


def _noop_tstep(state, f, v1, v2):
    legal = torch.ones(torch.broadcast_shapes(state.shape[:-1], f.shape),
                       dtype=torch.bool, device=state.device)
    return state.expand(legal.shape + state.shape[-1:]), legal


class _AnyFCodes(dict):
    """f_codes table accepting every f name (all map to code 0)."""

    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        return super().get(key, 0)

    def __missing__(self, key):
        return 0


def noop() -> ModelSpec:
    return ModelSpec(
        name="noop", f_codes=_AnyFCodes(), state_width=1, init=(0,),
        pystep=_noop_pystep, tstep=_noop_tstep, kernel_id=K_NOOP)
