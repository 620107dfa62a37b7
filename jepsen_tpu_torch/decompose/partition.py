"""History partitions; every split is verdict-exact.

* :func:`partition_by_key`: Herlihy-Wing locality.  A multi-register
  history is linearizable iff each key's projection is, as a single
  register; pending (:info) ops stay in their cell.
* :func:`value_block_verdict`: P-compositionality for registers, exact
  on the unique-writes class.  Every linearization is a concatenation of
  per-value blocks (the write of v, then the reads of v), so the search
  becomes per-block interval tests plus an acyclicity test of the forced
  block order.  Projecting per value alone is not sound (two projections
  can each linearize while their blocks interleave irreconcilably),
  which is why the cross-block order is part of the test.
* :func:`quiescence_segments`: cut wherever no op is pending.  Every op
  before a cut returns before every op after it invokes, so segments
  compose through the set of reachable final states (``engine.py``).
  A crashed op never returns, so crash rows land in the final segment.

:func:`merge_linearizations` and :func:`value_block_witness` are the
constructive halves: per-cell and per-block witnesses become one
linearization of the whole history, which the audit replays.
"""

from __future__ import annotations

import numpy as np

from ..analyze.plan import quiescence_cuts, value_block_gate
from ..history import NIL, OpSeq
from ..models import R_READ, register
from .canonical import event_ranks


def subseq(seq: OpSeq, rows) -> OpSeq:
    """Project an OpSeq onto a row subset, re-ranking events densely."""
    rows = np.asarray(rows, dtype=np.int64)
    inv_r, ret_r = event_ranks(np.asarray(seq.inv, dtype=np.int64)[rows],
                               np.asarray(seq.ret, dtype=np.int64)[rows])
    return OpSeq(
        process=np.asarray(seq.process)[rows],
        f=np.asarray(seq.f)[rows],
        v1=np.asarray(seq.v1)[rows],
        v2=np.asarray(seq.v2)[rows],
        inv=np.array(inv_r, dtype=np.int64),
        ret=np.array(ret_r, dtype=np.int64),
        ok=np.asarray(seq.ok)[rows],
        ops=[seq.ops[i] for i in rows.tolist()] if seq.ops else [],
        encoder=seq.encoder,
    )


def quiescence_segments(seq: OpSeq) -> list[np.ndarray]:
    """Row-index segments split at quiescent points
    (``analyze.plan.quiescence_cuts``)."""
    n = len(seq)
    if n <= 1:
        return [np.arange(n)]
    cuts = quiescence_cuts(seq)
    bounds = [0, *cuts.tolist(), n]
    return [np.arange(bounds[i], bounds[i + 1])
            for i in range(len(bounds) - 1)]


def key_partition_rows(seq: OpSeq, model):
    """The key-partition scan: ``(key -> parent rows, bad_rows)``, or
    ``(None, None)`` when the model is not multi-register.

    ``bad_rows`` are :ok rows whose key can never step (NIL or out of
    range); any such row decides the history invalid, and those rows are
    its blocking frontier.  A crashed row with such a key is never
    required to linearize and is dropped."""
    if model.name != "multi-register":
        return None, None
    width = model.state_width
    v1 = np.asarray(seq.v1)
    ok = np.asarray(seq.ok)
    by_key: dict[int, list[int]] = {}
    bad_rows: list[int] = []
    for i in range(len(seq)):
        k = int(v1[i])
        if k == NIL or not 0 <= k < width:
            if bool(ok[i]):
                bad_rows.append(i)
            continue
        by_key.setdefault(k, []).append(i)
    return by_key, bad_rows


def cells_from_rows(seq: OpSeq, model, by_key: dict):
    """``(cells, cell_model)`` from a :func:`key_partition_rows` scan:
    each key's projection as a register history (its value moved from
    the v2 lane to v1)."""
    cell_model = register(int(model.init[0]))
    cells = {}
    for k, rows in by_key.items():
        sub = subseq(seq, rows)
        sub.v1 = np.asarray(sub.v2).copy()
        sub.v2 = np.full(len(sub.v1), NIL, dtype=sub.v1.dtype)
        cells[k] = sub
    return cells, cell_model


def partition_by_key(seq: OpSeq, model):
    """Split a multi-register history into per-key register cells:
    ``(cells, cell_model, early_verdict)``, or ``(None, None, None)``
    for another model.  ``early_verdict`` is False when an :ok row can
    never step (:func:`key_partition_rows`), which decides the history
    with no search."""
    by_key, bad_rows = key_partition_rows(seq, model)
    if by_key is None:
        return None, None, None
    if bad_rows:
        return {}, None, False
    cells, cell_model = cells_from_rows(seq, model, by_key)
    return cells, cell_model, None


def _blocks_conflict(m: np.ndarray, M: np.ndarray) -> bool:
    """Is the forced block order cyclic?  Block A precedes B iff
    ``minret(A) < maxinv(B)``.  That threshold digraph is a Ferrers
    digraph, in which every cycle holds a 2-cycle, so acyclicity is "no
    pair with m_A < M_B and m_B < M_A", tested pairwise in chunks."""
    k = len(m)
    step = max(1, 4_000_000 // max(1, k))
    for lo in range(0, k, step):
        hi = min(k, lo + step)
        # the strict upper triangle of the pairwise test, one chunk
        cross = (m[lo:hi, None] < M[None, :]) & (m[None, :] < M[lo:hi, None])
        cross &= ~np.tri(hi - lo, k, k=lo, dtype=bool)
        if cross.any():
            return True
    return False


def value_block_verdict(seq: OpSeq, model):
    """The exact verdict by per-value blocks, or None when the history
    is outside ``analyze.plan.value_block_gate``'s class.  Reads of NIL
    constrain nothing and drop out; a read of a value nothing wrote (and
    not the initial value) is invalid outright; otherwise invalid iff a
    read returns before its value's write invokes or the block order is
    cyclic.  Reads of the initial value form a pseudo-block pinned first
    by a [-1, -1] pseudo-write."""
    applies, _reason, writes = value_block_gate(seq, model)
    if not applies:
        return None
    n = len(seq)
    if n == 0:
        return True
    f = np.asarray(seq.f)
    v1 = [int(x) for x in seq.v1]
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    init = int(model.init[0])

    # block -> (minret, maxinv); the NIL key is the init pseudo-block
    m: dict[int, int] = {v: ret[i] for v, i in writes.items()}
    M: dict[int, int] = {v: inv[i] for v, i in writes.items()}
    have_init_block = False
    for i in range(n):
        if int(f[i]) != R_READ:
            continue
        v = v1[i]
        if v == NIL:
            continue
        if v == init and init != NIL:
            if not have_init_block:
                have_init_block = True
                m[NIL], M[NIL] = -1, -1
            m[NIL] = min(m[NIL], ret[i])
            M[NIL] = max(M[NIL], inv[i])
            continue
        wi = writes.get(v)
        if wi is None:
            return False  # a read of a value nothing wrote
        if ret[i] < inv[wi]:
            return False  # a read forced before its own write
        m[v] = min(m[v], ret[i])
        M[v] = max(M[v], inv[i])

    vals = list(m)
    return not _blocks_conflict(
        np.array([m[v] for v in vals], dtype=np.int64),
        np.array([M[v] for v in vals], dtype=np.int64))


def merge_linearizations(seq: OpSeq, lins: list[list[int]]):
    """Interleave per-cell linearizations into one witness of ``seq``.

    ``lins`` are disjoint row sequences, each a valid linearization of
    its own cell.  Returns one order over their union that respects the
    parent history's real-time order, or None when none exists (which,
    by locality, only a caller's error causes).  A cell head may go next
    iff no unplaced op returned before it invoked; heads are tried in
    invocation order against a lazy-deletion heap of outstanding
    returns."""
    import heapq

    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    lins = [[int(r) for r in lin] for lin in lins if len(lin)]
    total = sum(len(lin) for lin in lins)
    ptr = [0] * len(lins)
    ret_heap = [(ret[r], r) for lin in lins for r in lin]
    heapq.heapify(ret_heap)
    placed: set[int] = set()
    out: list[int] = []
    while len(out) < total:
        while ret_heap and ret_heap[0][1] in placed:
            heapq.heappop(ret_heap)
        heads = sorted((inv[lins[c][ptr[c]]], c)
                       for c in range(len(lins)) if ptr[c] < len(lins[c]))
        chosen = -1
        for _iv, c in heads:
            h = lins[c][ptr[c]]
            if ret_heap and ret_heap[0][1] == h:
                # least outstanding return other than h's own
                top = heapq.heappop(ret_heap)
                while ret_heap and ret_heap[0][1] in placed:
                    heapq.heappop(ret_heap)
                thr = ret_heap[0][0] if ret_heap else None
                heapq.heappush(ret_heap, top)
            else:
                thr = ret_heap[0][0] if ret_heap else None
            if thr is None or inv[h] < thr:
                chosen = c
                break
        if chosen < 0:
            return None
        h = lins[chosen][ptr[chosen]]
        ptr[chosen] += 1
        placed.add(h)
        out.append(h)
    return out


def value_block_witness(seq: OpSeq, model):
    """A linearization of a history :func:`value_block_verdict` calls
    valid, or None (outside the class, invalid, or blocks that cannot
    order).  Each block is its write then its reads by return; blocks go
    in a topological order of the forced precedence (``A`` before ``B``
    iff ``minret(A) < maxinv(B)``); NIL reads go last, each at its
    earliest real-time-consistent slot.  A block runs contiguously, so
    its value is the register's while it runs.

    In this threshold digraph a source is always the remaining block of
    least ``maxinv`` or the one holding the least ``minret``, so the
    order costs O(k log k)."""
    import heapq

    applies, _reason, writes = value_block_gate(seq, model)
    if not applies:
        return None
    n = len(seq)
    if n == 0:
        return []
    f = np.asarray(seq.f)
    v1 = [int(x) for x in seq.v1]
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    init = int(model.init[0])

    rows_of: dict = {v: [i] for v, i in writes.items()}
    m: dict = {v: ret[i] for v, i in writes.items()}
    M: dict = {v: inv[i] for v, i in writes.items()}
    nil_reads: list[int] = []
    for i in range(n):
        if int(f[i]) != R_READ:
            continue
        v = v1[i]
        if v == NIL:
            nil_reads.append(i)
            continue
        if v == init and init != NIL:
            # the init pseudo-block, pinned first as in the verdict
            rows_of.setdefault(NIL, [])
            m[NIL] = min(m.get(NIL, -1), ret[i])
            M[NIL] = max(M.get(NIL, -1), inv[i])
            rows_of[NIL].append(i)
            continue
        wi = writes.get(v)
        if wi is None or ret[i] < inv[wi]:
            return None  # invalid: no witness
        m[v] = min(m[v], ret[i])
        M[v] = max(M[v], inv[i])
        rows_of[v].append(i)
    for v, rows in rows_of.items():
        head = rows[:1] if v in writes else []
        rows_of[v] = head + sorted(rows[len(head):], key=ret.__getitem__)

    keys = list(rows_of)
    alive = set(keys)
    by_M = [(M[k], k) for k in keys]
    by_m = [(m[k], k) for k in keys]
    heapq.heapify(by_M)
    heapq.heapify(by_m)
    order: list = []
    while alive:
        while by_M and by_M[0][1] not in alive:
            heapq.heappop(by_M)
        while by_m and by_m[0][1] not in alive:
            heapq.heappop(by_m)
        chosen = None
        for x in (by_M[0][1], by_m[0][1]):
            # a source: maxinv(x) below every other block's minret
            if by_m[0][1] == x:
                top = heapq.heappop(by_m)
                while by_m and by_m[0][1] not in alive:
                    heapq.heappop(by_m)
                thr = by_m[0][0] if by_m else None
                heapq.heappush(by_m, top)
            else:
                thr = by_m[0][0]
            if thr is None or M[x] < thr:
                chosen = x
                break
        if chosen is None:
            return None  # a block cycle: invalid
        order.append(chosen)
        alive.discard(chosen)
    out: list[int] = []
    for k in order:
        out.extend(rows_of[k])
    # a NIL read is legal anywhere: the earliest slot after every op
    # that returned before it invoked
    for r in sorted(nil_reads, key=inv.__getitem__):
        at = 0
        for pos, q in enumerate(out):
            if ret[q] < inv[r]:
                at = pos + 1
        out.insert(at, r)
    return out
