"""Exact host linearizability oracle: Wing-Gong/Lowe depth-first search.

A configuration is (set of linearized ops, model state).  From one, op
``j`` may linearize next iff it is not linearized, no unlinearized op
returned before ``j`` was invoked (``inv[j] < ret[k]`` for every other
unlinearized ``k``), and the model step is legal.  The history is valid
iff a configuration holding every ok op is reachable; crashed (:info) ops
never block and may linearize any time after invocation, or never.

DFS with a visited memo on (linearized-set bitmask, state), behind the
lint and the static prepass, and with the dynamic reductions
(``analyze/dpor.py``).  Used for short histories, as a leg of the
competition race, and to confirm invalid device verdicts with a
certificate.  ``max_configs``, ``deadline`` and ``cancel`` bound the
work ("unknown" past them).
"""

from __future__ import annotations

import random
import time

from ..history import INF_RET, NIL, OpSeq


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
                cancel=None,
                order_seed: int | None = None,
                decompose: bool = False,
                decompose_cache=None,
                lint: bool | None = None,
                audit: bool | None = None,
                hb: bool | None = None,
                dpor: bool | None = None) -> dict:
    """Search a columnar history.  Returns ``valid`` (True, False or
    "unknown"), ``configs`` explored and ``max_depth``; a valid verdict
    carries its ``linearization`` (rows in order), an invalid one the
    candidate rows at the deepest frontier (``final_ops``) and up to ten
    deepest partial linearizations (``final_paths``).

    ``deadline`` (``time.perf_counter()`` clock) and ``cancel`` (a
    ``threading.Event``, how the competition race retires a loser) are
    tested every 4096 configs and give "unknown" with ``info``
    "exceeded deadline" or "cancelled".

    ``order_seed`` shuffles the order in which each configuration's
    candidates are pushed (``Random(order_seed ^ hash(key))`` per
    configuration ``key``): the verdict is the same, but seeds dive into
    different subtrees first, the diversity of the portfolio race
    (``checker/parallel.py``).

    ``lint`` (None: on) lints the OpSeq first and raises
    ``HistoryLintError`` on errors.  ``hb`` (None: on) runs the static
    prepass: a decided history returns at once with its certificate and
    0 configs, an undecided one is searched under its must-order mask.
    ``dpor`` (None: on) adds the duplicate-op edges to that mask, sleep
    sets over the commuting siblings, and the dead-value quotient of
    register states; the result then carries ``dpor`` stats.
    ``audit=True`` replays the certificate (``analyze/audit.py``).

    ``decompose=True`` checks through the decomposition layer
    (``decompose/engine.py``) with this search as the engine of cells
    and segments and of the ``direct`` fallback; the verdict is the
    same.  ``decompose_cache`` is its VerdictCache or jsonl path."""
    from ..analyze.audit import maybe_audit
    from ..analyze.dpor import (_M_DEDUP, _M_MASK, _M_SLEEP, SleepSets,
                                resolve_dpor, sleep_visit)
    from ..analyze.hb import attach, maybe_hb
    from ..analyze.lint import maybe_lint

    maybe_lint(seq, model, lint)
    if decompose:
        from ..decompose.engine import check_opseq_decomposed

        def _direct(s):
            return check_opseq(s, model, max_configs=max_configs,
                               deadline=deadline, cancel=cancel,
                               order_seed=order_seed, lint=False,
                               hb=hb, dpor=dpor)

        def _sub(s, m, *, max_configs=max_configs, deadline=deadline):
            return check_opseq(s, m, max_configs=max_configs,
                               deadline=deadline, cancel=cancel,
                               order_seed=order_seed, lint=False,
                               hb=hb, dpor=dpor)

        # the entry was linted above; the search keeps parent chains
        # anyway, so the decomposed route stitches witnesses for free
        return check_opseq_decomposed(seq, model, cache=decompose_cache,
                                      direct=_direct, sub_check=_sub,
                                      sub_max_configs=max_configs,
                                      deadline=deadline, lint=False,
                                      witness=True, audit=audit, hb=hb)
    dpor_stats: dict | None = None
    hbres = maybe_hb(seq, model, hb, dpor)

    def finish(out: dict) -> dict:
        if dpor_stats is not None:
            out.setdefault("dpor", dpor_stats)
        return maybe_audit(seq, model, attach(out, hbres), audit)

    if hbres is not None and hbres.decided is not None:
        return finish(dict(hbres.decided))
    n = len(seq)
    if n == 0:
        return finish({"valid": True, "configs": 0, "linearization": [],
                       "max_depth": 0})
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

    # must-order mask: op j may linearize only once every must-
    # predecessor is linearized
    preds = [0] * n
    if hbres is not None:
        for dst, srcs in hbres.must_pred.items():
            for s_ in srcs:
                preds[dst] |= 1 << s_

    # the dynamic layer: sleep sets and the dead-value quotient
    sleep_sets = None
    cmp_masks = None
    dead_tok = 0
    if resolve_dpor(dpor):
        from ..decompose.canonical import comparison_row_masks

        sleep_sets = SleepSets(seq, model)
        cm = comparison_row_masks(seq, model)
        if cm is not None:
            cmp_masks, dv = cm
            dead_tok = dv.token
        dpor_stats = {"enabled": True, "sleep_prunes": 0,
                      "dedup_rewrites": 0, "dedup_hits": 0,
                      "mask_skips": 0}

    # visited: (mask, state) -> the intersection of the sleep masks it
    # was expanded under (dpor off: always 0, the plain visited set)
    visited: dict = {}
    configs = 0
    max_depth = -1
    best_frontier: list[int] = []
    best_keys: list[tuple] = []

    def covered(key, sleep: int) -> bool:
        """Read-only peek before a push (the pop records the visit)."""
        z1 = visited.get(key)
        return z1 is not None and z1 & ~sleep == 0

    init = model.init
    stack: list[tuple[int, tuple, int]] = [(0, init, 0)]
    parent_of: dict = {(0, init): None}

    while stack:
        mask, state, sleep = stack.pop()
        key = (mask, state)
        first_visit = key not in visited
        missing = sleep_visit(visited, key, sleep)
        if missing is None:
            continue
        if first_visit:
            # a revisit expands only its missing transitions: clean-up,
            # not a new configuration
            configs += 1
        if configs > max_configs:
            return finish({"valid": "unknown", "configs": configs,
                           "max_depth": max_depth,
                           "info": f"exceeded max_configs={max_configs}"})
        if configs % 4096 == 0:
            if deadline is not None and time.perf_counter() > deadline:
                return finish({"valid": "unknown", "configs": configs,
                               "max_depth": max_depth,
                               "info": "exceeded deadline"})
            if cancel is not None and cancel.is_set():
                return finish({"valid": "unknown", "configs": configs,
                               "max_depth": max_depth,
                               "info": "cancelled"})
        if (mask & ok_mask) == ok_mask:
            lin = _walk_parents(parent_of, key)
            return finish({"valid": True, "configs": configs,
                           "linearization": lin, "max_depth": len(lin)})

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
        order = range(len(cand))
        if order_seed is not None:
            order = list(order)
            random.Random(order_seed ^ hash(key)).shuffle(order)
        pushes: list[tuple[int, tuple]] = []
        explorable = 0  # candidates past the real-time and mask tests
        for idx in order:
            j2 = cand[idx]
            excl = m2 if rets[idx] == m1 and m1_count == 1 else m1
            if inv[j2] >= excl:
                continue
            if preds[j2] & ~mask:
                if dpor_stats is not None:
                    dpor_stats["mask_skips"] += 1
                    _M_MASK.inc(site="dfs")
                continue  # a must-predecessor is not linearized yet
            explorable |= 1 << j2
            if missing and not (missing >> j2) & 1:
                continue  # a revisit re-explores only missing ones
            if (sleep >> j2) & 1:
                # covered through a commuting sibling explored first
                dpor_stats["sleep_prunes"] += 1
                _M_SLEEP.inc()
                continue
            new_state = pystep(state, f[j2], v1[j2], v2[j2])
            if new_state is None:
                continue
            nm = mask | (1 << j2)
            if cmp_masks is not None:
                v = new_state[0]
                if v != dead_tok and v != NIL:
                    cmpm = cmp_masks.get(v)
                    if cmpm is None or (cmpm & ~nm) == 0:
                        # every row comparing v is linearized: the value
                        # is dead, so collapse onto the token
                        new_state = (dead_tok,)
                        dpor_stats["dedup_rewrites"] += 1
                        _M_DEDUP.inc(site="dfs", event="rewrite")
            pushes.append((j2, (nm, new_state)))
        # child sleep sets: a child pushed at t is popped after
        # pushes[t+1:], so those siblings are explored first and join
        # its sleep set where they commute with it at this state
        child_sleeps = [0] * len(pushes)
        if sleep_sets is not None and pushes:
            # on a revisit the non-missing candidates were explored by
            # earlier visits: they may sleep too
            prior = (explorable & ~missing) if missing else 0
            suffix = 0
            for t in range(len(pushes) - 1, -1, -1):
                j2 = pushes[t][0]
                base = (sleep | prior | suffix) & ~(1 << j2)
                if base:
                    child_sleeps[t] = sleep_sets.child_sleep(
                        state, j2, base)
                suffix |= 1 << j2
        for (j2, nk), csl in zip(pushes, child_sleeps):
            if not covered(nk, csl):
                if nk not in parent_of:
                    parent_of[nk] = (j2, key)
                stack.append((nk[0], nk[1], csl))
            elif cmp_masks is not None and nk[1] == (dead_tok,):
                dpor_stats["dedup_hits"] += 1
                _M_DEDUP.inc(site="dfs", event="hit")

    final_paths = [{"linearized": _walk_parents(parent_of, k),
                    "state": k[1]} for k in best_keys[:10]]
    return finish({"valid": False, "configs": configs,
                   "max_depth": max_depth, "final_ops": best_frontier,
                   "final_paths": final_paths})
