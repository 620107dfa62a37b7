"""Dynamic partial-order reduction: the reductions that act during the
search.

**Duplicate-op edges.**  Two rows with identical content (``f``,
``v1``, ``v2`` and ``ok``) are interchangeable in any linearization:
swapping their labels leaves the op sequence unchanged.  When their
intervals also form a staircase (``inv_a <= inv_b`` and ``ret_a <=
ret_b``), forcing a before b loses no linearization, for every model.
The edges join the prepass's must-order predecessor map, which the host
DFS, the ``linear`` frames and the device search's lane mask read.

**Sleep sets** (host DFS).  After a candidate's subtree is explored,
later siblings carry it in their sleep set when the two commute at the
concrete state (``step(step(s,a),b) == step(step(s,b),a)``, both
illegal counting as equal), and a sleeping op is not taken next: its
continuation was covered through the sibling.  Sleep sets compose with
the visited memo through :func:`sleep_visit`.

**Dead-value dedup** lives in ``decompose/canonical.py`` and the
engines: register states whose value no remaining op compares are
rewritten to one token and merge.

``dpor=False`` turns the layer off; None means on.
"""

from __future__ import annotations

import numpy as np

from ..history import OpSeq
from ..models import R_READ
from ..obs.metrics import REGISTRY

_M_SLEEP = REGISTRY.counter(
    "jtpu_dpor_sleep_prunes_total",
    "Host-DFS candidates skipped because they were sleeping "
    "(covered by an already-explored commuting sibling)")
_M_DEDUP = REGISTRY.counter(
    "jtpu_dpor_dedup_total",
    "Canonical-state frontier dedup events, by site/kind "
    "(rewrite = a successor state collapsed onto the dead token; "
    "hit = a rewritten config merged with an existing frontier row)",
    ("site", "event"))
_M_MASK = REGISTRY.counter(
    "jtpu_dpor_mask_total",
    "Must-order mask effects, by site (lanes/candidates killed on "
    "host frames and the DFS; masked rows shipped to device planes)",
    ("site",))
_M_EDGES = REGISTRY.counter(
    "jtpu_dpor_dup_edges_total",
    "Duplicate-op canonical must-order edges inferred")

#: cap on duplicate-op edges (per history)
DUP_EDGE_CAP_FACTOR = 2
DUP_EDGE_CAP_MIN = 128

#: sleep masks stop growing past this popcount (a truncated sleep set
#: prunes less, never wrongly)
SLEEP_SCAN_CAP = 24
#: commute memo bound; past it the memo resets
COMMUTE_MEMO_CAP = 200_000


def resolve_dpor(flag: bool | None) -> bool:
    """None means on."""
    return True if flag is None else bool(flag)


def duplicate_op_edges(seq: OpSeq, cap: int | None = None
                       ) -> list[tuple[int, int, str]]:
    """Staircase chains over identical-content rows, as must-order
    edges ``(src, dst, "dup")``.  Rows group by ``(f, v1, v2, ok)``;
    each group chains in invocation order, an edge wherever the returns
    do not decrease and real time does not already imply it.  Crashed
    duplicates share ``ret = +inf``, so their group chains whole."""
    n = len(seq)
    if n < 2:
        return []
    if cap is None:
        cap = max(DUP_EDGE_CAP_MIN, DUP_EDGE_CAP_FACTOR * n)
    f = np.asarray(seq.f)
    v1 = np.asarray(seq.v1)
    v2 = np.asarray(seq.v2)
    ok = np.asarray(seq.ok, dtype=bool)
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    groups: dict[tuple, list[int]] = {}
    for i in range(n):
        groups.setdefault(
            (int(f[i]), int(v1[i]), int(v2[i]), bool(ok[i])),
            []).append(i)
    out: list[tuple[int, int, str]] = []
    for rows in groups.values():
        if len(rows) < 2:
            continue
        chain = sorted(rows, key=lambda i: (inv[i], i))
        prev = chain[0]
        for nxt in chain[1:]:
            if ret[nxt] >= ret[prev]:
                if not ret[prev] < inv[nxt]:  # real time gives it
                    out.append((prev, nxt, "dup"))
                    if len(out) >= cap:
                        return out
                prev = nxt
    return out


def merge_dup_edges(seq: OpSeq, model, hb, flag: bool | None = None):
    """Merge the duplicate-op edges into a prepass result's must-order
    map, in place; a no-op when dpor is off, the history is decided or
    ``hb`` is None.  Returns ``hb``."""
    if hb is None or hb.decided is not None or not resolve_dpor(flag):
        return hb
    edges = duplicate_op_edges(seq)
    st = hb.stats.setdefault("dpor", {})
    st["dup_edges"] = len(edges)
    st["enabled"] = True
    if not edges:
        return hb
    _M_EDGES.inc(len(edges))
    must = {d: list(s) for d, s in hb.must_pred.items()}
    for (src, dst, _k) in edges:
        must.setdefault(int(dst), []).append(int(src))
    hb.must_pred = {d: tuple(sorted(set(s))) for d, s in must.items()}
    hb.applies = True
    return hb


class SleepSets:
    """Commutation oracle and sleep-mask bookkeeping for one DFS run.

    ``commutes(state, a, b)``: both orders give the same outcome (the
    same state, or both illegal).  Two plain reads of a register model
    always commute, and so do identical rows; everything else runs the
    model's ``pystep`` four ways, memoized per (state, a, b)."""

    __slots__ = ("_f", "_v1", "_v2", "_pystep", "_read", "_memo")

    def __init__(self, seq: OpSeq, model):
        self._f = [int(x) for x in seq.f]
        self._v1 = [int(x) for x in seq.v1]
        self._v2 = [int(x) for x in seq.v2]
        self._pystep = model.pystep
        fam = model.name in ("register", "cas-register",
                             "multi-register")
        # plain reads never change state, and their legality ignores
        # the other read
        self._read = [fam and fi == R_READ for fi in self._f]
        self._memo: dict = {}

    def commutes(self, state, a: int, b: int) -> bool:
        if self._read[a] and self._read[b]:
            return True
        if (self._f[a], self._v1[a], self._v2[a]) == \
                (self._f[b], self._v1[b], self._v2[b]):
            return True
        if a > b:
            a, b = b, a
        key = (state, a, b)
        r = self._memo.get(key)
        if r is not None:
            return r
        step = self._pystep
        sa = step(state, self._f[a], self._v1[a], self._v2[a])
        sb = step(state, self._f[b], self._v1[b], self._v2[b])
        sab = step(sa, self._f[b], self._v1[b], self._v2[b]) \
            if sa is not None else None
        sba = step(sb, self._f[a], self._v1[a], self._v2[a]) \
            if sb is not None else None
        r = sab == sba
        if len(self._memo) > COMMUTE_MEMO_CAP:
            self._memo.clear()
        self._memo[key] = r
        return r

    def child_sleep(self, state, taken: int, base: int) -> int:
        """The sleep mask a child inherits after linearizing ``taken``:
        the members of ``base`` (the parent's sleep and the siblings
        explored first) that commute with ``taken`` at the parent's
        state, scanning at most :data:`SLEEP_SCAN_CAP` of them."""
        out = 0
        scanned = 0
        z = base
        while z and scanned < SLEEP_SCAN_CAP:
            bit = z & -z
            z ^= bit
            scanned += 1
            if self.commutes(state, bit.bit_length() - 1, taken):
                out |= bit
        return out


def sleep_visit(visited: dict, key, sleep: int) -> int | None:
    """The sleep-aware visited check (Godefroid's state-caching fix, in
    its missing-transitions form).  ``visited[key]`` holds the
    intersection of the sleep sets the state was expanded under.  An
    arrival with sleep ``Z``:

      * first visit: record ``Z``, return 0 (expand all but ``Z``);
      * stored ``Z1`` a subset of ``Z``: covered, return None;
      * else: return ``Z1 - Z``, the transitions never taken from this
        state (the caller expands only those), and store ``Z1 & Z``.

    With dpor off every sleep is 0 and this is the plain visited set."""
    z1 = visited.get(key)
    if z1 is None:
        visited[key] = sleep
        return 0
    if z1 & ~sleep == 0:
        return None
    missing = z1 & ~sleep
    visited[key] = z1 & sleep
    return missing


def plan_block(seq: OpSeq, model, raw_bound: int, hb_analysis=None, *,
               dpor: bool | None = None) -> dict:
    """The static ``dpor`` block of ``analyze.plan.explain``: the
    duplicate-op edge count, the device mask's coverage once those edges
    join the prepass's, the dead-value dedup's predicted hit rate, and a
    sleep-set size bound from the reads open at once.  A description
    only: it runs ``analyze_hb``, never ``maybe_hb``, so no live counter
    moves.  ``hb_analysis`` shares one solve with the plan's ``hb``
    block; ``dpor`` (None: on) is reported as ``enabled``."""
    from ..decompose.canonical import dead_value_cutoffs
    from .hb import _TLS, _window_effective, analyze_hb

    n = len(seq)
    out: dict = {"enabled": resolve_dpor(dpor), "applies": n > 0}
    edges = duplicate_op_edges(seq) if n else []
    out["dup_edges"] = len(edges)

    # the rows with at least one must-order predecessor once the
    # prepass's edges and the duplicate-op edges merge: the rows the
    # device planes mask
    hb = (hb_analysis if hb_analysis is not None
          else analyze_hb(seq, model)) if n else None
    must = dict(hb.must_pred) if hb is not None else {}
    for (_s, d, _k) in edges:
        must.setdefault(int(d), ())
    out["masked_rows"] = len(must)
    out["mask_coverage"] = round(len(must) / n, 4) if n else 0.0

    # the dedup's hit-rate proxy: the share of (value, position) pairs
    # past each value's death
    dv = dead_value_cutoffs(seq, model)
    if dv is None:
        out["dedup"] = {"applies": False}
    else:
        n_det = int(np.asarray(seq.ok, dtype=bool).sum())
        vals = list(dv.cutoffs.values())
        dead = [c for c in vals if c < n_det]
        out["dedup"] = {
            "applies": True,
            "values": len(vals),
            "dead_values": len(dead),
            "hit_rate_prediction": round(
                sum(max(0, n_det - c) for c in dead)
                / max(1, n_det * max(1, len(vals))), 4),
        }

    # the sleep-set bound: the most reads (state-transparent rows) open
    # at once
    if model.name in ("register", "cas-register", "multi-register") and n:
        reads = np.nonzero(np.asarray(seq.f) == R_READ)[0]
        events = sorted([(int(seq.inv[i]), 1) for i in reads]
                        + [(int(seq.ret[i]), -1) for i in reads])
        cur = peak = 0
        for _t, d in events:
            cur += d
            peak = max(peak, cur)
        out["sleep_set_bound"] = peak
    else:
        out["sleep_set_bound"] = 0

    # the pruned bound with the duplicate-op edges added to the
    # prepass's
    if edges and hb is not None and hb.applies and n:
        _TLS.inv = [int(x) for x in seq.inv]
        _TLS.ret = [int(x) for x in seq.ret]
        try:
            all_edges = edges + [(s, d, "hb") for d, ss in
                                 hb.must_pred.items() for s in ss]
            _w_raw, w_eff = _window_effective(seq, all_edges)
        finally:
            _TLS.inv = _TLS.ret = None
        nd = int(np.asarray(seq.ok, dtype=bool).sum())
        pruned = min((nd + 1) << (max(0, w_eff - 1) + (n - nd)), raw_bound)
        out["pruned_upper_bound"] = pruned
        out["prune_ratio"] = (round(pruned / raw_bound, 6)
                              if raw_bound else None)
    else:
        out["pruned_upper_bound"] = raw_bound
        out["prune_ratio"] = 1.0
    return out
