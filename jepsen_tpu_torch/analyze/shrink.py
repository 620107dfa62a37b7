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

:func:`shrink_invalid_events` runs the same loop (:func:`ddmin_list`)
over an event history's invoke/completion pairs, for the corpus's
minimal repros (``live/corpus.py``).
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

    rows, minimal = _ddmin(rows, still_invalid,
                           lambda: checks < MAX_CHECKS)
    sub = subseq(seq, rows)
    out.update({
        "rows": [int(r) for r in rows],
        "n_to": len(rows),
        "checks": checks,
        "minimal": minimal,
        "brute_force": brute_force_check(sub, model),
    })
    return out


def ddmin_list(items: list, still_failing, *,
               max_checks: int = 200) -> dict:
    """ddmin over any list: :func:`shrink_invalid`'s chunk loop
    (:func:`_ddmin`), which :func:`shrink_invalid_events` runs over
    event units.

    ``still_failing(sub_items) -> bool`` re-checks a candidate (one that
    raises counts as not failing); a removal is kept only while it
    answers True, so the chain starts and ends at a confirmed failing
    list.  Returns ``{"items": the minimal list, "n_from", "n_to",
    "checks": calls, "minimal": 1-minimality proven}``."""
    checks = 0

    def check(sub: list) -> bool:
        nonlocal checks
        checks += 1
        try:
            return bool(still_failing(sub))
        except Exception:  # noqa: BLE001 — a candidate that crashes is
            return False   # not a confirmed failing one

    out = {"items": list(items), "n_from": len(items),
           "n_to": len(items), "checks": 0, "minimal": False}
    kept = list(items)
    if not kept or not check(kept):
        out["checks"] = checks
        return out
    kept, minimal = _ddmin(kept, check, lambda: checks < max_checks)
    out.update({"items": kept, "n_to": len(kept), "checks": checks,
                "minimal": minimal})
    return out


def _ddmin(kept: list, check, budget_left) -> tuple[list, bool]:
    """Remove chunks of ``kept`` while ``check`` holds, halving the
    chunk down to single items; (the list left, whether a clean pass at
    chunk 1 proved it 1-minimal before ``budget_left()`` ran out)."""
    chunk = max(1, len(kept) // 2)
    while budget_left():
        i = 0
        removed = False
        while i < len(kept) and budget_left():
            cand = kept[:i] + kept[i + chunk:]
            if cand and check(cand):
                kept = cand
                removed = True
            else:
                i += chunk
        if chunk == 1:
            if not removed:
                return kept, True  # a clean single-item pass
        else:
            chunk = max(1, chunk // 2)
    return kept, False


def shrink_invalid_events(ops: list, check, *,
                          max_checks: int = 200) -> dict:
    """ddmin an invalid event history down to a minimal failing
    subhistory: the corpus's shrinker at bank time (``live/corpus.py``).

    Events group into removal units (an invoke and its process's next
    event; an event with no open invoke is a unit of its own), so every
    candidate is a well-formed history.  ``check(ops) -> bool`` answers
    "still invalid" (one that raises counts as not invalid), and a
    removal is kept only while it says True.  Returns ``{"ops": the
    minimal event list, "n_from": units, "n_to": units, "checks",
    "minimal"}``."""
    units: list[list[int]] = []
    open_of: dict = {}
    for i, op in enumerate(ops):
        if op.type == "invoke":
            open_of[op.process] = len(units)
            units.append([i])
        else:
            u = open_of.pop(op.process, None)
            if u is None:
                units.append([i])
            else:
                units[u].append(i)

    def build(kept: list[int]) -> list:
        return [ops[i] for i in sorted(i for u in kept for i in units[u])]

    out = ddmin_list(list(range(len(units))),
                     lambda kept: check(build(kept)),
                     max_checks=max_checks)
    return {"ops": build(out["items"]), "n_from": out["n_from"],
            "n_to": out["n_to"], "checks": out["checks"],
            "minimal": out["minimal"]}


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
