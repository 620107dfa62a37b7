"""History partitions; so far only the projection onto a row subset."""

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
