"""History partitions; so far the projection onto a row subset and the
merge of per-cell witnesses into one."""

from __future__ import annotations

import numpy as np

from ..history import OpSeq
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
