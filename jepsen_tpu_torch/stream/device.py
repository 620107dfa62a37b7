"""Device folds of closed stream segments: ``search_batch`` applied to
the stream.

A closed quiescence segment folds to the set of states it can reach;
``decompose.engine.segment_states`` is an exact host sweep, but a wide
segment makes it the stage that would stall ingest.  For the
single-value register family the fold reduces to ordinary
linearizability checks the batched device engine runs:

  * a **prepended pseudo-write** of a candidate input state ``s_in``
    (interval ``[-2, -1]``: it returns before any real op invokes, so
    every linearization runs it first, as if the model started in
    ``s_in``);
  * an **appended pseudo-read** of a candidate output state ``s_out``
    (invoked after every real op returned: forced last, legal iff the
    register ends holding ``s_out``).

``(s_in, s_out)`` is feasible iff that decorated segment linearizes, so
the fold is one ``search_batch`` over the candidate pairs: uniformly
shaped variants of one segment, which the batch runs as one grid over
keys on the card.  The candidate outputs are the segment's
state-changing values (every row of a crash-free segment is :ok, so the
final state is the last write's or successful cas's value).

:func:`device_fold_states` returns None where the trick does not apply
(no state-changing op, more than :data:`MAX_VARIANTS` pairs, or a
variant left undecided by ``budget``); the caller then folds on the
host.  That is a routing rule.  An exception, from ``search_batch``, a
kernel's build or its launch, is not: nothing here catches it.  Which
segments come here is ``analyze.plan.segment_fold_route``'s rule.
"""

from __future__ import annotations

import numpy as np

from ..history import NIL, OpSeq
from ..models import R_CAS, R_READ, R_WRITE

class DeviceFoldError(RuntimeError):
    """A device-routed segment fold raised (``search_batch``, a kernel's
    build or launch).  The stream raises it to its caller, chained to
    the original; it never becomes a host fold."""


#: candidate (s_in, s_out) pairs past which the fold stays on the host:
#: each pair is one key of the device batch
MAX_VARIANTS = 512


def _decorate(sseq: OpSeq, s_in: int, s_out: int) -> OpSeq:
    """The segment with its state-pinning pseudo-ops attached."""
    n = len(sseq)
    lo = int(np.min(sseq.inv)) if n else 0
    hi = int(np.max(sseq.ret)) if n else 0
    return OpSeq(
        process=np.concatenate([[np.int32(-1)], sseq.process,
                                [np.int32(-2)]]).astype(np.int32),
        f=np.concatenate([[R_WRITE], sseq.f, [R_READ]]).astype(np.int32),
        v1=np.concatenate([[s_in], sseq.v1, [s_out]]).astype(np.int32),
        v2=np.concatenate([[NIL], sseq.v2, [NIL]]).astype(np.int32),
        inv=np.concatenate([[lo - 2], sseq.inv, [hi + 1]]).astype(np.int64),
        ret=np.concatenate([[lo - 1], sseq.ret, [hi + 2]]).astype(np.int64),
        ok=np.concatenate([[True], sseq.ok, [True]]).astype(bool),
    )


def device_fold_states(sseq: OpSeq, model, in_states, *,
                       budget: int = 2_000_000, device="cuda"):
    """The states a crash-free register-family segment can reach from
    ``in_states``, through the batched device engine on ``device``.

    Returns ``(states, configs)``: the set ``segment_states`` would
    compute and the configs the searches billed; or None where the
    fold does not apply or a variant is undecided."""
    if model.name not in ("register", "cas-register"):
        return None
    n = len(sseq)
    if n == 0 or not bool(np.asarray(sseq.ok).all()):
        return None
    f = np.asarray(sseq.f)
    changers = set()
    for i in range(n):
        fc = int(f[i])
        if fc == R_WRITE:
            changers.add(int(sseq.v1[i]))
        elif fc == R_CAS:
            changers.add(int(sseq.v2[i]))
        elif fc != R_READ:
            return None  # a foreign op code: not this model family
    if not changers:
        # all reads: the state never moves and the host fold is linear
        return None
    ins = sorted({int(s[0]) for s in in_states})
    outs = sorted(changers)
    pairs = [(a, b) for a in ins for b in outs]
    if not pairs or len(pairs) > MAX_VARIANTS:
        return None
    from ..checker.linearizable import search_batch

    variants = [_decorate(sseq, a, b) for a, b in pairs]
    results = search_batch(variants, model, budget=budget, lint=False,
                           device=device)
    configs = sum(int(r.get("configs", 0) or 0) for r in results)
    states = set()
    for (_a, b), r in zip(pairs, results):
        v = r.get("valid")
        if v is True:
            states.add((b,))
        elif v is not False:
            return None  # an undecided variant: the fold must stay exact
    return states, configs
