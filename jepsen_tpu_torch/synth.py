"""Synthetic histories for benchmarks and self-tests.

Simulated single-threaded processes run against an in-memory register,
lock or queue; each op takes effect atomically at its completion event, so the
emitted history is valid by construction until a corruptor rewrites it.
Driven by a caller's ``random.Random``: the same seed gives the same
history as the JAX package's generators of the same names.
"""

from __future__ import annotations

import random
from dataclasses import replace

from .history import Op, fail_op, info_op, invoke_op, ok_op


def register_history(rng: random.Random, *, n_ops: int, n_procs: int,
                     overlap: int = 4, crash_p: float = 0.0,
                     max_crashes: int = 16, n_values: int = 5,
                     cas: bool = True,
                     unique_writes: bool = False,
                     quiesce_every: int | None = None) -> list[Op]:
    """Concurrent cas-register history, valid by construction.

    ``overlap`` is the target number of pending ops; ``crash_p`` the
    chance a completing op crashes (:info) instead, its effect applied
    on a coin flip; ``unique_writes`` draws write values from a counter
    starting at 1; ``quiesce_every`` drains all pending ops after every
    that many invocations."""
    state = None
    h: list[Op] = []
    pending: dict[int, tuple] = {}
    n_crashed = 0
    done = 0
    next_v = 1
    crashed_procs: set[int] = set()
    while done < n_ops or pending:
        free = [p for p in range(n_procs)
                if p not in pending and p not in crashed_procs]
        want_invoke = (done < n_ops and free
                       and (len(pending) < overlap or not pending)
                       and not (quiesce_every and done
                                and done % quiesce_every == 0
                                and pending))
        if want_invoke:
            p = rng.choice(free)
            fs = ["read", "write"] + (["cas"] if cas else [])
            f = rng.choice(fs)
            if f == "read":
                v = None
            elif f == "write":
                if unique_writes:
                    v = next_v
                    next_v += 1
                else:
                    v = rng.randrange(n_values)
            else:
                v = (rng.randrange(n_values), rng.randrange(n_values))
            h.append(invoke_op(p, f, v))
            pending[p] = (f, v)
            done += 1
            continue
        if not pending:
            break
        p = rng.choice(list(pending))
        f, v = pending.pop(p)
        if crash_p and rng.random() < crash_p and n_crashed < max_crashes:
            n_crashed += 1
            crashed_procs.add(p)  # a crashed process id is retired
            if rng.random() < 0.5:
                if f == "write":
                    state = v
                elif f == "cas" and state == v[0]:
                    state = v[1]
            h.append(info_op(p, f, v if f != "read" else None))
            continue
        if f == "read":
            h.append(ok_op(p, f, state))
        elif f == "write":
            state = v
            h.append(ok_op(p, f, v))
        elif state == v[0]:
            state = v[1]
            h.append(ok_op(p, f, v))
        else:
            h.append(fail_op(p, f, v))
    return h


def crash_heavy_register_history(rng: random.Random, *, n_ops: int,
                                 n_procs: int, overlap: int, n_values: int,
                                 n_crash: int, n_writes: int = 4,
                                 corrupt: bool = False) -> list[Op]:
    """A write/read register history (:func:`register_history`,
    optionally with a corrupted read at 0.7 of the way through) with
    ``n_crash`` crashed ops inserted at seeded places, each from a
    process of its own numbered from 100: the first ``n_writes`` are
    writes, the rest reads.  Far more crashed ops than a real run makes,
    so it lies past the device encoding's crash limit."""
    h = register_history(rng, n_ops=n_ops, n_procs=n_procs,
                         overlap=overlap, n_values=n_values, cas=False)
    if corrupt:
        h = corrupt_read(rng, h, at=0.7)
    for i in range(n_crash):
        pos = rng.randrange(len(h) + 1)
        f, v = (("write", rng.randrange(n_values)) if i < n_writes
                else ("read", None))
        h = h[:pos] + [invoke_op(100 + i, f, v),
                       info_op(100 + i, f, v)] + h[pos:]
    return h


def swap_read_values(rng: random.Random, h: list[Op], *,
                     min_gap: int | None = None) -> list[Op]:
    """Swap the values of two ok reads of different values at least
    ``min_gap`` events apart (default: a quarter of the history)."""
    idx = [i for i, op in enumerate(h)
           if op.type == "ok" and op.f == "read" and op.value is not None]
    if len(idx) < 2:
        return h
    gap = len(h) // 4 if min_gap is None else min_gap
    for _ in range(200):
        i, j = sorted(rng.sample(idx, 2))
        if j - i >= gap and h[i].value != h[j].value:
            h = list(h)
            h[i], h[j] = (replace(h[i], value=h[j].value),
                          replace(h[j], value=h[i].value))
            return h
    return h


def corrupt_read(rng: random.Random, h: list[Op], *,
                 at: float = 1.0) -> list[Op]:
    """Rewrite the ok read nearest fraction ``at`` of the way through to
    a value nothing wrote; the result is (almost certainly) invalid."""
    h = list(h)
    idx = [i for i, op in enumerate(h)
           if op.type == "ok" and op.f == "read" and op.value is not None]
    if not idx:
        return h
    target = int(at * (len(h) - 1))
    i = min(idx, key=lambda j: abs(j - target))
    h[i] = replace(h[i], value=(h[i].value or 0) + 1_000_003)
    return h


def sim_register_history(rng: random.Random, n_procs: int = 4,
                         n_ops: int = 40, *, crash_p: float = 0.0,
                         cas: bool = True,
                         max_crashes: int = 8) -> list[Op]:
    """Processes against a register that starts unset, values 0-4; a
    crashed op takes effect on a coin flip."""
    state = None
    h: list[Op] = []
    pending: dict = {}  # process -> (f, value)
    n_crashed = 0
    done = 0
    while done < n_ops or pending:
        p = rng.randrange(n_procs)
        if p in pending:
            f, v = pending.pop(p)
            if crash_p and rng.random() < crash_p and \
                    n_crashed < max_crashes:
                n_crashed += 1
                if rng.random() < 0.5:
                    if f == "write":
                        state = v
                    elif f == "cas" and state == v[0]:
                        state = v[1]
                h.append(info_op(p, f, v if f != "read" else None))
                continue
            if f == "read":
                h.append(ok_op(p, f, state))
            elif f == "write":
                state = v
                h.append(ok_op(p, f, v))
            elif state == v[0]:
                state = v[1]
                h.append(ok_op(p, f, v))
            else:
                h.append(fail_op(p, f, v))
        elif done < n_ops:
            f = rng.choice(["read", "write"] + (["cas"] if cas else []))
            if f == "read":
                v = None
            elif f == "write":
                v = rng.randrange(5)
            else:
                v = (rng.randrange(5), rng.randrange(5))
            h.append(invoke_op(p, f, v))
            pending[p] = (f, v)
            done += 1
    return h


def flip_read(rng: random.Random, h: list[Op]) -> list[Op]:
    """Add 7 to one ok read's value; usually makes the history
    invalid."""
    h = list(h)
    idx = [i for i, op in enumerate(h)
           if op.type == "ok" and op.f == "read" and op.value is not None]
    if not idx:
        return h
    i = rng.choice(idx)
    h[i] = replace(h[i], value=(h[i].value or 0) + 7)
    return h


def mutate(rng: random.Random, h: list[Op]) -> list[Op]:
    """One random mutation: flip a read value, swap two completions, or
    duplicate a completion."""
    h = list(h)
    kind = rng.randrange(3)
    if kind == 0:
        return flip_read(rng, h)
    idx = [i for i, op in enumerate(h) if op.type == "ok"]
    if kind == 1 and len(idx) >= 2:
        i, j = rng.sample(idx, 2)
        h[i], h[j] = h[j], h[i]
    elif idx:
        h.insert(rng.choice(idx), h[rng.choice(idx)])
    return h


def sim_mutex_history(rng: random.Random, n_ops: int = 40,
                      n_procs: int = 4, *,
                      crash_p: float = 0.0,
                      max_crashes: int = 48,
                      lease_p: float = 0.05) -> list[Op]:
    """Alternating acquire/release per process against a real lock.

    After the op budget is spent, completable pending ops are drained
    and anything still stuck becomes a crashed :info op.  A holder that
    crashes holding the lock loses it to lease expiry (probability
    ``lease_p`` per scheduling step); ``max_crashes`` caps :info ops."""
    holder = None
    holder_crashed = False
    h: list[Op] = []
    pending: dict = {}
    wants: dict = {}
    crashed: set = set()
    done = 0
    while done < n_ops:
        if len(crashed) >= n_procs:
            break
        if holder_crashed and rng.random() < lease_p:
            holder = None
            holder_crashed = False
        p = rng.randrange(n_procs)
        if p in crashed:
            continue
        if p in pending:
            f = pending[p]
            if crash_p and len(crashed) < max_crashes \
                    and rng.random() < crash_p:
                if rng.random() < 0.5:
                    if f == "acquire" and holder is None:
                        holder = p
                    elif f == "release" and holder == p:
                        holder = None
                del pending[p]
                crashed.add(p)
                if holder == p:
                    holder_crashed = True
                h.append(info_op(p, f, None))
                continue
            if f == "acquire" and holder is None:
                holder = p
                holder_crashed = False
                del pending[p]
                h.append(ok_op(p, f, None))
            elif f == "release":
                del pending[p]
                if holder == p:
                    holder = None
                    holder_crashed = False
                    h.append(ok_op(p, f, None))
                else:
                    h.append(fail_op(p, f, None))
            continue
        f = "release" if wants.get(p) else "acquire"
        wants[p] = not wants.get(p)
        h.append(invoke_op(p, f, None))
        pending[p] = f
        done += 1

    if holder is not None and holder not in crashed \
            and holder not in pending:
        h.append(invoke_op(holder, "release", None))
        h.append(ok_op(holder, "release", None))
        holder = None
    for p, f in sorted(pending.items()):
        if f == "acquire" and holder is None:
            holder = p
            h.append(ok_op(p, f, None))
        elif f == "release":
            if holder == p:
                holder = None
                h.append(ok_op(p, f, None))
            else:
                h.append(fail_op(p, f, None))
        else:
            h.append(info_op(p, f, None))
    return h


def sim_queue_history(rng: random.Random, n_ops: int = 40,
                      n_procs: int = 4, *,
                      crash_p: float = 0.0,
                      fifo: bool = False) -> list[Op]:
    """Enqueue/dequeue against an in-memory multiset, valid by
    construction (ops take effect at completion; a dequeue takes an
    arbitrary present element, or the oldest when ``fifo``).  Enqueued
    values are unique integers.  A crashed enqueue applies its effect on
    a coin flip, and a later dequeue may then return its value."""
    contents: list[int] = []
    h: list[Op] = []
    pending: dict = {}  # process -> (f, value or None)
    crashed: set = set()
    next_v = 0
    done = 0
    while done < n_ops or pending:
        live = [p for p in range(n_procs) if p not in crashed]
        if not live:
            break
        p = rng.choice(live)
        if p in pending:
            f, v = pending.pop(p)
            if crash_p and rng.random() < crash_p:
                if f == "enqueue" and rng.random() < 0.5:
                    contents.append(v)
                crashed.add(p)
                h.append(info_op(p, f, v))
                continue
            if f == "enqueue":
                contents.append(v)
                h.append(ok_op(p, f, v))
            elif contents:
                got = contents.pop(0 if fifo
                                   else rng.randrange(len(contents)))
                h.append(ok_op(p, f, got))
            else:
                h.append(fail_op(p, f, None))
        elif done < n_ops:
            if rng.random() < 0.55 or not contents:
                f, v = "enqueue", next_v
                next_v += 1
            else:
                f, v = "dequeue", None
            h.append(invoke_op(p, f, v))
            pending[p] = (f, v)
            done += 1
    return h


def swap_dequeues(rng: random.Random, h: list[Op]) -> list[Op]:
    """Swap the values of two ok dequeues: a different service order,
    which a FIFO queue rejects unless the two were concurrent."""
    idx = [i for i, op in enumerate(h)
           if op.type == "ok" and op.f == "dequeue"]
    if len(idx) < 2:
        return h
    i, j = rng.sample(idx, 2)
    h = list(h)
    h[i], h[j] = (replace(h[i], value=h[j].value),
                  replace(h[j], value=h[i].value))
    return h


def corrupt_dequeue(rng: random.Random, h: list[Op]) -> list[Op]:
    """Rewrite one ok dequeue's value to one never enqueued."""
    idx = [i for i, op in enumerate(h)
           if op.type == "ok" and op.f == "dequeue"]
    if not idx:
        return h
    i = rng.choice(idx)
    h = list(h)
    h[i] = replace(h[i], value=999_983)
    return h
