"""Exact host linearizability oracle: Wing-Gong/Lowe depth-first search.

A configuration is (set of linearized ops, model state).  From one, op
``j`` may linearize next iff it is not linearized, no unlinearized op
returned before ``j`` was invoked (``inv[j] < ret[k]`` for every other
unlinearized ``k``), and the model step is legal.  The history is valid
iff a configuration holding every ok op is reachable; crashed (:info) ops
never block and may linearize any time after invocation, or never.

DFS with a visited memo on (linearized-set bitmask, state).  Used for
short histories, as a leg of the competition race, and to confirm
invalid device verdicts with a certificate.  ``max_configs``,
``deadline`` and ``cancel`` bound the work ("unknown" past them).
"""

from __future__ import annotations

import time

from ..history import INF_RET, OpSeq


def _walk_parents(parent_of: dict, key) -> list[int]:
    """Rebuild a linearization (op rows, in order) by walking parents."""
    lin: list[int] = []
    while True:
        p = parent_of.get(key)
        if p is None:
            break
        op, key = p
        lin.append(op)
    lin.reverse()
    return lin


def check_opseq(seq: OpSeq, model, *,
                max_configs: int = 5_000_000,
                deadline: float | None = None,
                cancel=None) -> dict:
    """Search a columnar history.  Returns ``valid`` (True, False or
    "unknown"), ``configs`` explored and ``max_depth``; a valid verdict
    carries its ``linearization`` (rows in order), an invalid one the
    candidate rows at the deepest frontier (``final_ops``) and up to ten
    deepest partial linearizations (``final_paths``).

    ``deadline`` (``time.perf_counter()`` clock) and ``cancel`` (a
    ``threading.Event``, how the competition race retires a loser) are
    tested every 4096 configs and give "unknown" with ``info``
    "exceeded deadline" or "cancelled"."""
    n = len(seq)
    if n == 0:
        return {"valid": True, "configs": 0, "linearization": [],
                "max_depth": 0}
    ok_mask = 0
    for i in range(n):
        if bool(seq.ok[i]):
            ok_mask |= 1 << i
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    f = [int(x) for x in seq.f]
    v1 = [int(x) for x in seq.v1]
    v2 = [int(x) for x in seq.v2]
    pystep = model.pystep

    visited: set = set()
    configs = 0
    max_depth = -1
    best_frontier: list[int] = []
    best_keys: list[tuple] = []
    init = model.init
    stack: list[tuple[int, tuple]] = [(0, init)]
    parent_of: dict = {(0, init): None}

    while stack:
        key = stack.pop()
        if key in visited:
            continue
        visited.add(key)
        mask, state = key
        configs += 1
        if configs > max_configs:
            return {"valid": "unknown", "configs": configs,
                    "max_depth": max_depth,
                    "info": f"exceeded max_configs={max_configs}"}
        if configs % 4096 == 0:
            if deadline is not None and time.perf_counter() > deadline:
                return {"valid": "unknown", "configs": configs,
                        "max_depth": max_depth, "info": "exceeded deadline"}
            if cancel is not None and cancel.is_set():
                return {"valid": "unknown", "configs": configs,
                        "max_depth": max_depth, "info": "cancelled"}
        if (mask & ok_mask) == ok_mask:
            lin = _walk_parents(parent_of, key)
            return {"valid": True, "configs": configs,
                    "linearization": lin, "max_depth": len(lin)}

        # candidates: unlinearized ops in invocation order while their
        # invocation precedes the least return seen so far (invocations
        # are sorted, so nothing later can be enabled)
        cand: list[int] = []
        rets: list[int] = []
        minret = INF_RET + 1
        for j in range(n):
            if (mask >> j) & 1:
                continue
            if inv[j] >= minret:
                break
            cand.append(j)
            rets.append(ret[j])
            minret = min(minret, ret[j])

        depth = mask.bit_count()
        if depth > max_depth:
            max_depth = depth
            best_frontier = list(cand)
            best_keys = [key]
        elif depth == max_depth and len(best_keys) < 10:
            best_keys.append(key)

        # the least return excluding the candidate itself: (min, second
        # min), the second used only by the unique holder of the min
        if rets:
            m1 = min(rets)
            m1_count = rets.count(m1)
            m2 = INF_RET + 1
            first = True
            for r in rets:
                if r == m1 and first:
                    first = False
                elif r < m2:
                    m2 = r
        for idx, j2 in enumerate(cand):
            excl = m2 if rets[idx] == m1 and m1_count == 1 else m1
            if inv[j2] >= excl:
                continue
            new_state = pystep(state, f[j2], v1[j2], v2[j2])
            if new_state is None:
                continue
            nk = (mask | (1 << j2), new_state)
            if nk not in visited:
                if nk not in parent_of:
                    parent_of[nk] = (j2, key)
                stack.append(nk)

    final_paths = [{"linearized": _walk_parents(parent_of, k),
                    "state": k[1]} for k in best_keys[:10]]
    return {"valid": False, "configs": configs, "max_depth": max_depth,
            "final_ops": best_frontier, "final_paths": final_paths}
