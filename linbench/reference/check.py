"""The plain reference: is a cas-register history linearizable?

A straightforward Wing-Gong-Lowe search in plain Python over the
benchmark's own events (``gen.py``), independent of the program: it
imports nothing of it, nor ``jax``, nor the JAX package.

Semantics, as Jepsen and knossos state them for a cas-register that
starts unset:

* an op's ``:ok`` completion means it took effect once, between its
  invocation and its completion; ``:fail`` means it took no effect and
  the op is dropped; ``:info`` (or no completion) means it may have
  taken effect at any time after its invocation, or never;
* ``write v`` sets the value; ``cas [a b]`` needs the value ``a`` and
  sets ``b``; ``read v`` needs the value ``v``.  A read that returns
  nothing (``None``) constrains nothing, the convention of the program's
  encoding for an unknown value; a crashed read is dropped;
* linearizability: every op is ordered after each op that completed
  before it was invoked (the real-time order).

The search walks configurations (the completed ops placed so far, the
crashed ops placed so far, the value) depth first, and places next only
ops invoked before the earliest completion among those not placed
(just-in-time linearization).  Visited configurations are memoized.
Crashed ops of the same function and value are interchangeable once
invoked, so only the earliest unplaced one of each such group is tried,
and a configuration is dropped where one with the same completed ops
and value, but fewer crashed ops of every group placed, was already
seen: it could do all this one can.

``real_time=False`` drops the real-time order and keeps only each
process's own order (sequential consistency).  That is the control of
the benchmark's comparison: it breaks the guarantee the configurations
state, and it accepts the traffic's stale reads or runs out of its
search budget on them.
"""

from __future__ import annotations

VALID, INVALID, UNKNOWN = True, False, "unknown"
INF = float("inf")


def parse(events) -> tuple[list[tuple], list[tuple]]:
    """The completed ops and the crashed ops of a history, each as
    ``(invoke index, return index, process, f, value, completion
    index)`` in invocation order, where a crashed op's return index is
    infinite and its completion index that of its ``:info`` (the end of
    the history where it has none); ``:fail`` ops and crashed reads are
    dropped, nemesis events ignored."""
    open_: dict = {}
    done, crashed = [], []
    for i, e in enumerate(events):
        p, typ, f, v = e[0], e[1], e[2], e[3]
        if p == "nemesis":
            continue
        if typ == "invoke":
            if p in open_:
                raise ValueError(f"process {p} invoked twice at {i}")
            open_[p] = (i, f, v)
            continue
        if p not in open_:
            raise ValueError(f"completion without invocation at {i}")
        inv, f0, v0 = open_.pop(p)
        if f0 != f:
            raise ValueError(f"completion of another f at {i}")
        if typ == "ok":
            done.append((inv, i, p, f, v if f == "read" else v0, i))
        elif typ == "info":
            if f != "read":
                crashed.append((inv, INF, p, f, v0, i))
        elif typ != "fail":
            raise ValueError(f"unknown type {typ!r} at {i}")
    for p, (inv, f, v) in open_.items():
        if f != "read":
            crashed.append((inv, INF, p, f, v, len(events)))
    done.sort()
    crashed.sort()
    return done, crashed


def step(state, f, v):
    """The cas-register's step: the next value, or None where the op
    cannot take effect on ``state``.  A value is wrapped in a tuple so
    that the unset register (``(None,)``) differs from a refusal."""
    if f == "read":
        return state if v is None or state == (v,) else None
    if f == "write":
        return (v,)
    if f == "cas":
        return (v[1],) if state == (v[0],) else None
    raise ValueError(f"unknown f {f!r}")


def check(events, *, real_time: bool = True,
          max_configs: int = 5_000_000) -> dict:
    """``{"valid": True | False | "unknown", "configs"}`` for one
    history; "unknown" once ``max_configs`` configurations were seen."""
    done, crashed = parse(events)
    if not real_time:
        return _check_sc(done, crashed, max_configs)
    n = len(done)
    inv = [o[0] for o in done]
    ret = [o[1] for o in done]
    fv = [(o[3], o[4]) for o in done]
    groups: dict = {}
    for o in crashed:
        key = (o[3], o[4] if o[3] != "cas" else tuple(o[4]))
        groups.setdefault(key, []).append(o[0])
    gkeys = list(groups)
    ginv = [groups[k] for k in gkeys]
    full = (1 << n) - 1
    start = (0, (0,) * len(gkeys), (None,))
    seen: dict = {}
    stack = [start]
    configs = 0
    while stack:
        lin, used, state = stack.pop()
        if lin == full:
            return {"valid": VALID, "configs": configs}
        marks = seen.setdefault((lin, state), [])
        if any(all(a <= b for a, b in zip(u, used)) for u in marks):
            continue
        marks.append(used)
        configs += 1
        if configs > max_configs:
            return {"valid": UNKNOWN, "configs": configs}
        # the first op not placed, then every op invoked before the
        # earliest completion among those not placed
        i = (~lin & (lin + 1)).bit_length() - 1
        m = INF
        cand = []
        while i < n and inv[i] < m:
            if not lin >> i & 1:
                cand.append(i)
                if ret[i] < m:
                    m = ret[i]
            i += 1
        nxt = []
        for g, invs in enumerate(ginv):
            k = used[g]
            if k < len(invs) and invs[k] < m:
                f, v = gkeys[g]
                s = step(state, f, v)
                if s is not None:
                    u = used[:g] + (k + 1,) + used[g + 1:]
                    nxt.append((lin, u, s))
        # the stack pops the last first: completed ops by earliest
        # completion, before crashed ones
        for i in sorted(cand, key=lambda j: -ret[j]):
            s = step(state, *fv[i])
            if s is not None:
                nxt.append((lin | 1 << i, used, s))
        stack.extend(nxt)
    return {"valid": INVALID, "configs": configs}


def _check_sc(done, crashed, max_configs: int) -> dict:
    """Sequential consistency: each process's ops in its own order, no
    real-time order between processes; a process's crashed op (its last)
    may be placed or left out."""
    procs: dict = {}
    for o in sorted(done + crashed):
        procs.setdefault(o[2], []).append(o)
    lists = list(procs.values())
    need = [sum(1 for o in ops if o[1] != INF) for ops in lists]
    start = ((0,) * len(lists), (None,))
    seen: set = set()
    stack = [start]
    configs = 0
    while stack:
        pos, state = stack.pop()
        if all(p >= k for p, k in zip(pos, need)):
            return {"valid": VALID, "configs": configs}
        if (pos, state) in seen:
            continue
        seen.add((pos, state))
        configs += 1
        if configs > max_configs:
            return {"valid": UNKNOWN, "configs": configs}
        nxt = []
        for j, ops in enumerate(lists):
            if pos[j] < len(ops):
                o = ops[pos[j]]
                s = step(state, o[3], o[4])
                if s is not None:
                    nxt.append((o[5], (pos[:j] + (pos[j] + 1,)
                                       + pos[j + 1:], s)))
        # earliest completion first, the nearest to real time
        nxt.sort(key=lambda x: -x[0])
        stack.extend(c for _, c in nxt)
    return {"valid": INVALID, "configs": configs}


def check_keys(events, *, real_time: bool = True,
               max_configs: int = 5_000_000) -> dict:
    """Each key's verdict of a keyed history (events with a key in their
    fifth field), by key."""
    by_key: dict = {}
    for e in events:
        if len(e) > 4:
            by_key.setdefault(e[4], []).append(e)
    return {k: check(ev, real_time=real_time, max_configs=max_configs)
            for k, ev in by_key.items()}
