"""Counterexample minimization: delta-debug invalid verdicts.

An invalid verdict on a long history is true but hard to read: the
defect usually lives in a handful of ops.  :func:`shrink_invalid` is a
ddmin-style delta debugger over the rows of an OpSeq: it removes row
chunks while a bounded engine still answers invalid, halving the chunk
size down to single rows, and ends in a 1-minimal failing subhistory
(removing any one remaining op makes the engine stop answering
invalid).  :func:`brute_force_check`, a naive exact permutation search
that shares no code with the engines, confirms the core independently.

Removing ops can change a verdict either way, so every removal is
re-checked: each link of the chain, the final core included, is a
machine-confirmed invalid history.  ``checker/linear_report.py``
renders the core at the head of the failure report.
"""

from __future__ import annotations

from ..history import INF_RET, OpSeq

#: engine calls one shrink may make
MAX_CHECKS = 400
#: configurations each bounded re-check of a candidate may visit
MAX_CONFIGS = 200_000
#: the brute-force confirmation takes cores up to this many rows, and
#: gives up past this many search nodes
BRUTE_MAX_OPS = 16
BRUTE_MAX_NODES = 2_000_000


def brute_force_check(seq: OpSeq, model):
    """Exhaustive linearizability check by permutation enumeration.

    True/False exactly; None when the history has more than
    :data:`BRUTE_MAX_OPS` rows or the node budget runs out.  A plain DFS that at each step
    tries every unlinearized op the pairwise real-time test allows (op
    ``j`` may go next iff no other unlinearized op returned before ``j``
    invoked) and the model allows; a visited set on (linearized set,
    state) keeps it finite."""
    n = len(seq)
    if n > BRUTE_MAX_OPS:
        return None
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    f = [int(x) for x in seq.f]
    v1 = [int(x) for x in seq.v1]
    v2 = [int(x) for x in seq.v2]
    ok_mask = 0
    for i in range(n):
        if bool(seq.ok[i]):
            ok_mask |= 1 << i
    pystep = model.pystep
    visited: set = set()
    stack = [(0, model.init)]
    nodes = 0
    while stack:
        mask, state = stack.pop()
        if (mask, state) in visited:
            continue
        visited.add((mask, state))
        nodes += 1
        if nodes > BRUTE_MAX_NODES:
            return None
        if mask & ok_mask == ok_mask:
            return True
        for j in range(n):
            if (mask >> j) & 1:
                continue
            if any(not (mask >> k) & 1 and k != j and ret[k] < inv[j]
                   for k in range(n)):
                continue  # another unlinearized op returned before j
            ns = pystep(state, f[j], v1[j], v2[j])
            if ns is None:
                continue
            stack.append((mask | (1 << j), ns))
    return False


def shrink_invalid(seq: OpSeq, model) -> dict:
    """ddmin an invalid history down to a minimal failing subhistory.

    The WGL oracle, bounded to :data:`MAX_CONFIGS` (its prepass and
    reductions on, the lint off), re-verdicts candidates; a removal is
    kept only while the answer stays False.
    Returns ``{"rows": kept rows, "n_from", "n_to", "checks": engine
    calls, "minimal": 1-minimality proven, "brute_force":
    True|False|None}``.  ``minimal`` is False when :data:`MAX_CHECKS`
    ran out first (the core is still a confirmed invalid subhistory);
    ``brute_force`` is None when the core has more than
    :data:`BRUTE_MAX_OPS` rows."""
    from ..checker.seq import check_opseq
    from ..decompose.partition import subseq

    checks = 0

    def still_invalid(rows: list[int]) -> bool:
        nonlocal checks
        checks += 1
        return check_opseq(subseq(seq, rows), model,
                           max_configs=MAX_CONFIGS,
                           lint=False).get("valid") is False

    rows = list(range(len(seq)))
    out = {"rows": rows, "n_from": len(seq), "n_to": len(rows),
           "checks": 0, "minimal": False, "brute_force": None}
    if not rows or not still_invalid(rows):
        # the bounded re-check does not reproduce an invalid verdict
        out["checks"] = checks
        return out

    chunk = max(1, len(rows) // 2)
    minimal = False
    while checks < MAX_CHECKS:
        i = 0
        removed = False
        while i < len(rows) and checks < MAX_CHECKS:
            cand = rows[:i] + rows[i + chunk:]
            if cand and still_invalid(cand):
                rows = cand
                removed = True
            else:
                i += chunk
        if chunk == 1:
            if not removed:
                minimal = True  # a clean single-row pass: 1-minimal
                break
        else:
            chunk = max(1, chunk // 2)

    sub = subseq(seq, rows)
    out.update({
        "rows": [int(r) for r in rows],
        "n_to": len(rows),
        "checks": checks,
        "minimal": minimal,
        "brute_force": brute_force_check(sub, model),
    })
    return out


def shrink_summary(seq: OpSeq, shrunk: dict) -> dict:
    """The report-ready form of a shrink outcome: the stats, plus the
    core as op dicts when the OpSeq carries its source ops."""
    out = {k: shrunk[k] for k in ("rows", "n_from", "n_to", "checks",
                                  "minimal", "brute_force")}
    if seq.ops:
        ops = []
        for r in shrunk["rows"]:
            d = seq.ops[r].to_dict()
            d["crashed"] = int(seq.ret[r]) == INF_RET
            ops.append(d)
        out["ops"] = ops
    return out
