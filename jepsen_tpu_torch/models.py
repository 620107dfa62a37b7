"""Consistency models over fixed-width int32 state.

Each :class:`ModelSpec` carries two step implementations with identical
semantics:

  * ``pystep(state, f, v1, v2) -> state' | None`` — plain Python, for the
    host oracle and the greedy witness;
  * ``tstep(state[..., w], f, v1, v2) -> (state'[..., w], legal)`` —
    elementwise torch over any leading batch shape, for the device search.

``kernel_id`` selects the same step inside the CUDA level-loop kernel
(``csrc/level_loop.cu``, ``model_step``); None for the models the kernel
does not implement (multi-register and the two queues: their state is
wider than the kernel's four words), which always run the torch step.
Values are int32 lanes; :data:`~jepsen_tpu_torch.history.NIL` is an
unknown value, always legal to read and never a state change.
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
    kernel_id: Optional[int] = None


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


def _broadcast(state, *lanes):
    """``state[..., w]`` and the op lanes expanded to one batch shape."""
    batch = torch.broadcast_shapes(state.shape[:-1],
                                   *(x.shape for x in lanes))
    return (state.expand(batch + state.shape[-1:]),
            *(x.expand(batch) for x in lanes))


# ---------------------------------------------------------------------------
# multi-register: ``width`` registers in one object; ops take (key, value)
# ---------------------------------------------------------------------------


def multi_register(width: int, initial: int = 0) -> ModelSpec:
    """``width`` registers; the value lanes are (key, value)."""

    def pystep(state, f, v1, v2):
        key = v1
        if key == NIL or not (0 <= key < width):
            return None
        if f == R_READ:
            return state if (v2 == NIL or v2 == state[key]) else None
        if f == R_WRITE:
            s = list(state)
            s[key] = v2
            return tuple(s)
        raise ValueError(f"multi-register: bad f code {f}")

    def tstep(state, f, v1, v2):
        state, f, v1, v2 = _broadcast(state, f, v1, v2)
        key = v1.clamp(0, width - 1).to(torch.int64).unsqueeze(-1)
        in_range = (v1 >= 0) & (v1 < width)
        cur = state.gather(-1, key).squeeze(-1)
        read_legal = in_range & ((v2 == NIL) | (v2 == cur))
        legal = torch.where(f == R_READ, read_legal, in_range)
        # an illegal step leaves the state unchanged
        lanes = torch.arange(width, device=state.device)
        hit = ((f == R_WRITE) & in_range).unsqueeze(-1) & (lanes == key)
        return torch.where(hit, v2.unsqueeze(-1), state), legal

    return ModelSpec(
        name="multi-register", f_codes={"read": R_READ, "write": R_WRITE},
        state_width=width, init=(initial,) * width, pystep=pystep,
        tstep=tstep)


# ---------------------------------------------------------------------------
# unordered-queue and fifo-queue: bounded queues over ``capacity`` lanes
# ---------------------------------------------------------------------------

Q_ENQ, Q_DEQ = 0, 1

#: empty lane: sorts after every real value (2**31-1 is never an
#: encoded value)
Q_EMPTY = 2**31 - 1


def _uq_pystep_factory(capacity: int):
    def pystep(state, f, v1, v2):
        if v1 == NIL:
            # an op with an unknown value (a crashed invoke) constrains
            # and changes nothing
            return state
        if f == Q_ENQ:
            if state[capacity - 1] != Q_EMPTY:
                return None  # over capacity
            s = sorted(state[:capacity - 1] + (v1,))
            return tuple(s) + (Q_EMPTY,) * (capacity - len(s))
        if f == Q_DEQ:
            if v1 not in state:
                return None
            s = list(state)
            s.remove(v1)
            return tuple(s) + (Q_EMPTY,)
        raise ValueError(f"unordered-queue: bad f code {f}")

    return pystep


def _shift_left(state):
    """Lanes moved one to the left, an empty lane in at the end."""
    return torch.cat([state[..., 1:],
                      torch.full_like(state[..., :1], Q_EMPTY)], dim=-1)


def _uq_tstep_factory(capacity: int):
    def tstep(state, f, v1, v2):
        state, f, v1 = _broadcast(state, f, v1)
        idx = torch.arange(capacity, device=state.device)
        v = v1.unsqueeze(-1)
        # enqueue: sorted insert at cnt = |{i: state[i] <= v}|
        room = state[..., capacity - 1] == Q_EMPTY
        cnt = (state <= v).sum(dim=-1, keepdim=True)
        enq = torch.where(idx < cnt, state,
                          torch.where(idx == cnt, v,
                                      torch.roll(state, 1, dims=-1)))
        # dequeue: remove the first lane equal to v
        eq = state == v
        first = torch.where(eq, idx, capacity).min(dim=-1,
                                                    keepdim=True).values
        deq = torch.where(idx < first, state, _shift_left(state))
        is_enq = f == Q_ENQ
        nil = v1 == NIL
        legal = nil | torch.where(is_enq, room, eq.any(dim=-1))
        new_state = torch.where((nil | ~legal).unsqueeze(-1), state,
                                torch.where(is_enq.unsqueeze(-1), enq, deq))
        return new_state, legal

    return tstep


def unordered_queue(capacity: int = 16) -> ModelSpec:
    """Bounded unordered queue (a multiset held as sorted lanes).
    ``capacity`` must cover the longest queue any linearization reaches
    (the enqueue count is always enough): an enqueue past it is
    illegal."""
    return ModelSpec(
        name=f"unordered-queue-{capacity}",
        f_codes={"enqueue": Q_ENQ, "dequeue": Q_DEQ},
        state_width=capacity, init=(Q_EMPTY,) * capacity,
        pystep=_uq_pystep_factory(capacity),
        tstep=_uq_tstep_factory(capacity))


def _fq_pystep_factory(capacity: int):
    def pystep(state, f, v1, v2):
        if v1 == NIL:
            return state
        if f == Q_ENQ:
            if state[capacity - 1] != Q_EMPTY:
                return None  # over capacity
            cnt = sum(1 for x in state if x != Q_EMPTY)
            return state[:cnt] + (v1,) + state[cnt + 1:]
        if f == Q_DEQ:
            if state[0] == Q_EMPTY or state[0] != v1:
                return None
            return state[1:] + (Q_EMPTY,)
        raise ValueError(f"fifo-queue: bad f code {f}")

    return pystep


def _fq_tstep_factory(capacity: int):
    def tstep(state, f, v1, v2):
        state, f, v1 = _broadcast(state, f, v1)
        idx = torch.arange(capacity, device=state.device)
        room = state[..., capacity - 1] == Q_EMPTY
        cnt = (state != Q_EMPTY).sum(dim=-1, keepdim=True)
        enq = torch.where(idx == cnt, v1.unsqueeze(-1), state)
        head_ok = (state[..., 0] != Q_EMPTY) & (state[..., 0] == v1)
        is_enq = f == Q_ENQ
        nil = v1 == NIL
        legal = nil | torch.where(is_enq, room, head_ok)
        new_state = torch.where((nil | ~legal).unsqueeze(-1), state,
                                torch.where(is_enq.unsqueeze(-1), enq,
                                            _shift_left(state)))
        return new_state, legal

    return tstep


def fifo_queue(capacity: int = 16) -> ModelSpec:
    """Bounded FIFO queue, front at lane 0; the capacity rule of
    :func:`unordered_queue` holds."""
    return ModelSpec(
        name=f"fifo-queue-{capacity}",
        f_codes={"enqueue": Q_ENQ, "dequeue": Q_DEQ},
        state_width=capacity, init=(Q_EMPTY,) * capacity,
        pystep=_fq_pystep_factory(capacity),
        tstep=_fq_tstep_factory(capacity))
