"""Happens-before constraint analysis: the static order solver.

One cheap host pass over a history, before any search, that builds the
forced order the engines would otherwise rediscover configuration by
configuration:

  * **real time**: ``ret[i] < inv[j]`` forces i before j;
  * **read-from**: under unique writes, an :ok read of v forces the one
    write of v before it;
  * **block order**: under unique writes each value's ops form a
    contiguous block in any linearization, so any real-time edge
    between members of two blocks orients the whole blocks (the cluster
    argument of Gibbons and Korach);
  * **init order**: a read of the initial value precedes every write.

Three passes use it.  **Decide**: a cycle of forced edges is an invalid
verdict with an op-level cycle certificate (audited by
``audit.py``, W006); all-:ok read/write histories decide completely,
valid with a constructed linearization that is replayed against the
model before it is returned.  **Propagate**: histories it cannot decide
still yield forced edges beyond real time.  **Prune**: those edges and
canonical chains over concurrent same-value reads (exchange-safe) form
a must-order predecessor map that the engines mask candidates with.

Register-family models run this solver; :func:`maybe_hb` sends the
queue and lock families to ``constraints.py``, which returns the same
:class:`HBAnalysis`.  ``hb=False`` turns the pass off; None means on.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field

import numpy as np

from ..history import INF_RET, NIL, OpSeq
from ..models import R_CAS, R_READ, R_WRITE
from ..obs.metrics import REGISTRY

_M_PREPASS = REGISTRY.counter(
    "jtpu_hb_prepass_total",
    "HB pre-pass outcomes (decided_valid/decided_invalid/undecided/"
    "skipped)", ("outcome",))
_M_EDGES = REGISTRY.counter(
    "jtpu_hb_edges_total",
    "Forced/canonical HB edges inferred beyond real time, by kind",
    ("kind",))
_M_RATIO = REGISTRY.gauge(
    "jtpu_hb_prune_ratio",
    "pruned/raw config-bound ratio of the most recent HB pre-pass "
    "(0 = decided without search)")
_M_FOLDS = REGISTRY.counter(
    "jtpu_hb_fold_total",
    "Streamed/decomposed segment folds answered by the HB interval "
    "pass")

#: cap on emitted edges: the prune degrades (fewer mask edges) instead
#: of going quadratic on pathological cluster structures
EDGE_CAP_FACTOR = 4
EDGE_CAP_MIN = 256

#: NIL (unknown-value) reads are re-inserted into the constructed
#: witness one scan each; past this many the decision is left to the
#: engines
NIL_INSERT_CAP = 512

#: input states a segment fold runs the interval pass for before it
#: leaves the fold to the sweep
FOLD_INSTATE_CAP = 8
#: distinct reachable output states the fold builds witnesses for
FOLD_WITNESS_STATES = 8


def resolve_hb(flag: bool | None) -> bool:
    """None means on."""
    return True if flag is None else bool(flag)


@dataclass
class HBAnalysis:
    """The prepass output one engine entry consumes."""

    n: int
    applies: bool
    #: engine-style result (verdict and certificate), or None
    decided: dict | None
    #: row -> tuple of must-predecessor rows (beyond real time)
    must_pred: dict = field(default_factory=dict)
    #: json-able summary for ``result["hb"]``
    stats: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# the cluster scan every pass reads
# ---------------------------------------------------------------------------


def _family(model) -> str | None:
    if model.name in ("register", "cas-register"):
        return "register"
    if model.name == "multi-register":
        return "multi"
    return None


class _Cluster:
    """One value's block on one key: the (unique) write and the :ok
    reads of the value.  ``anchored``: the block must appear in every
    linearization (an ok write, or a crashed write some :ok read saw)."""

    __slots__ = ("val", "write", "write_ok", "ok_reads", "s", "e")

    def __init__(self, val: int, write: int, write_ok: bool):
        self.val = val
        self.write = write
        self.write_ok = write_ok
        self.ok_reads: list[int] = []

    @property
    def anchored(self) -> bool:
        return self.write_ok or bool(self.ok_reads)

    def members(self) -> list[int]:
        return [self.write, *self.ok_reads]


class _KeyScan:
    __slots__ = ("key", "init_val", "clusters", "init_reads",
                 "nil_reads", "impossible", "tainted", "crashed_reads",
                 "read_classes")

    def __init__(self, key: int, init_val: int):
        self.key = key
        self.init_val = init_val
        self.clusters: dict[int, _Cluster] = {}   # val -> cluster
        self.init_reads: list[int] = []           # :ok reads of init
        self.nil_reads: list[int] = []            # :ok reads of NIL
        self.impossible: list[int] = []           # :ok reads, no writer
        self.tainted = False                      # no rf/block inference
        self.crashed_reads: list[int] = []
        #: value -> read rows (ok and crashed), for the canonical
        #: read-order chains; NIL reads under key NIL
        self.read_classes: dict[int, list[int]] = {}


class _Scan:
    __slots__ = ("keys", "all_ok", "has_cas", "n")

    def __init__(self):
        self.keys: dict[int, _KeyScan] = {}
        self.all_ok = True
        self.has_cas = False
        self.n = 0


def _scan(seq: OpSeq, model) -> _Scan | None:
    """One O(n) pass building the per-key clusters; None when the model
    is out of scope or a foreign op code appears."""
    fam = _family(model)
    if fam is None:
        return None
    n = len(seq)
    f = np.asarray(seq.f)
    v1 = np.asarray(seq.v1)
    v2 = np.asarray(seq.v2)
    ok = np.asarray(seq.ok, dtype=bool)

    sc = _Scan()
    sc.n = n
    sc.all_ok = bool(ok.all())
    if bool((f == R_CAS).any()) and model.name == "cas-register":
        # a cas reads and writes: no unique-writes algebra, but the
        # canonical read-order exchange still holds (reads are
        # state-transparent), so read classes are still collected
        sc.has_cas = True

    if fam == "multi":
        keys = v1
        vals = v2
        if bool((keys == NIL).any()):
            return None  # an un-keyed row: the model rejects it anyway
        init_of = {int(k): int(model.init[int(k)])
                   if 0 <= int(k) < model.state_width else 0
                   for k in np.unique(keys)}
    else:
        keys = np.zeros(n, dtype=np.int64)
        vals = v1
        init_of = {0: int(model.init[0])}

    for i in range(n):
        k = int(keys[i])
        ks = sc.keys.get(k)
        if ks is None:
            ks = sc.keys[k] = _KeyScan(k, init_of.get(k, 0))
        fi = int(f[i])
        val = int(vals[i])
        if fi == R_WRITE:
            if val == NIL or val == ks.init_val or val in ks.clusters:
                ks.tainted = True  # NIL/init/duplicate write: no algebra
            if val not in ks.clusters:
                ks.clusters[val] = _Cluster(val, i, bool(ok[i]))
        elif fi == R_READ:
            if val == NIL:
                (ks.nil_reads if ok[i] else ks.crashed_reads).append(i)
                ks.read_classes.setdefault(NIL, []).append(i)
            else:
                ks.read_classes.setdefault(val, []).append(i)
                if not ok[i]:
                    ks.crashed_reads.append(i)
                elif val == ks.init_val:
                    ks.init_reads.append(i)
        elif fi == R_CAS and sc.has_cas:
            continue  # cas rows carry no read class
        else:
            return None  # foreign op code
    if sc.has_cas:
        for ks in sc.keys.values():
            ks.tainted = True
        return sc
    # attach ok reads to their clusters; find impossible reads
    for ks in sc.keys.values():
        for val, rows in ks.read_classes.items():
            if val == NIL or val == ks.init_val:
                continue
            cl = ks.clusters.get(val)
            for i in rows:
                if not ok[i]:
                    continue
                if cl is None:
                    ks.impossible.append(i)
                else:
                    cl.ok_reads.append(i)
        if ks.init_val != NIL and ks.init_val in ks.clusters:
            # a write re-creates the initial value: init reads are no
            # longer forced before every write
            ks.tainted = True
    return sc


# ---------------------------------------------------------------------------
# forced-edge checks
# ---------------------------------------------------------------------------


def _edge(src: int, dst: int, kind: str, via=None) -> dict:
    e = {"src": int(src), "dst": int(dst), "kind": kind}
    if via is not None:
        e["via"] = [int(via[0]), int(via[1])]
    return e


def _spans(ks: _KeyScan) -> list[tuple[int, int, _Cluster]]:
    """(s, e, cluster) per anchored cluster: s the least member return,
    e the greatest member invocation.  Block u is forced wholly before
    block v iff s(u) < e(v)."""
    inv, ret = _ranks()
    out = []
    for cl in ks.clusters.values():
        if not cl.anchored:
            continue
        mem = cl.members()
        s = min(int(ret[i]) for i in mem)
        e = max(int(inv[i]) for i in mem)
        cl.s, cl.e = s, e
        out.append((s, e, cl))
    return out


# per-thread rank views for the duration of one analysis: the three
# legs of the competition race run the prepass at once
_TLS = threading.local()


def _ranks():
    return _TLS.inv, _TLS.ret


def _find_cycle(seq: OpSeq, sc: _Scan) -> list[dict] | None:
    """Complete cycle search over the forced edges, per key; returns an
    op-level edge cycle or None.  Real time alone is acyclic and
    numerically transitive, so every forced cycle projects to (a) a read
    real-time before its own write, (b) an init read after a block
    member, or (c) a 2-cycle between anchored block spans."""
    inv, ret = _ranks()
    for ks in sc.keys.values():
        if ks.tainted:
            continue
        # (a) a read real-time before its (unique) write
        for cl in ks.clusters.values():
            w = cl.write
            for r in cl.ok_reads:
                if ret[r] < inv[w]:
                    return [_edge(w, r, "rf"), _edge(r, w, "rt")]
        spans = _spans(ks)
        # (b) init reads precede every anchored write; a block member
        # real-time before an init read inverts that
        if ks.init_reads:
            ri_by_inv = max(ks.init_reads, key=lambda i: inv[i])
            for s, _e, cl in spans:
                if s < inv[ri_by_inv]:
                    x = min(cl.members(), key=lambda i: ret[i])
                    ri = next(i for i in ks.init_reads
                              if ret[x] < inv[i])
                    cyc = []
                    if x != cl.write:
                        cyc.append(_edge(cl.write, x, "rf"))
                    cyc.append(_edge(x, ri, "rt"))
                    cyc.append(_edge(ri, cl.write, "init"))
                    return cyc
        # (c) overlapping anchored spans, each forced before the other:
        # sweep in s order with a prefix max of e
        spans.sort(key=lambda t: t[0])
        pref: list[tuple[int, _Cluster]] = []  # (prefix max e, argmax)
        ss = []
        for s, e, cl in spans:
            if pref:
                # rightmost previous span with s(prev) < e(cur)
                hi = bisect.bisect_left(ss, e)
                if hi > 0 and pref[hi - 1][0] > s:
                    u = pref[hi - 1][1]
                    # member witnesses for both directions
                    a1 = min(u.members(), key=lambda i: ret[i])
                    b1 = next(i for i in cl.members()
                              if ret[a1] < inv[i])
                    a2 = min(cl.members(), key=lambda i: ret[i])
                    b2 = next(i for i in u.members()
                              if ret[a2] < inv[i])
                    return [_edge(a1, b1, "ww", via=(a1, b1)),
                            _edge(b1, a1, "ww", via=(a2, b2))]
            best = max(pref[-1][0], e) if pref else e
            pref.append((best, cl if not pref or e >= pref[-1][0]
                         else pref[-1][1]))
            ss.append(s)
    return None


# ---------------------------------------------------------------------------
# decide valid: the interval construction
# ---------------------------------------------------------------------------


def _topo_clusters(spans: list[tuple[int, int, _Cluster]]
                   ) -> list[_Cluster] | None:
    """Topological order of anchored blocks under ``u -> v iff s(u) <
    e(v)``, O(C log C) with lazy heaps; None when no source exists."""
    import heapq

    C = len(spans)
    if C <= 1:
        return [cl for _s, _e, cl in spans]
    hs = [(s, i) for i, (s, _e, _c) in enumerate(spans)]
    he = [(e, i) for i, (_s, e, _c) in enumerate(spans)]
    heapq.heapify(hs)
    heapq.heapify(he)
    done = [False] * C
    out: list[_Cluster] = []
    INF = INF_RET + 1
    for _ in range(C):
        while hs and done[hs[0][1]]:
            heapq.heappop(hs)
        while he and done[he[0][1]]:
            heapq.heappop(he)
        s1, u1 = hs[0]
        # second-least s: pop the head, peek the next live entry, push
        # the head back
        heapq.heappop(hs)
        while hs and done[hs[0][1]]:
            heapq.heappop(hs)
        s2 = hs[0][0] if hs else INF
        heapq.heappush(hs, (s1, u1))
        e1, v1 = he[0]
        pick = None
        if v1 != u1 and e1 <= s1:
            pick = v1
        elif v1 == u1 and e1 <= s2:
            pick = v1
        elif v1 != u1 and spans[u1][1] <= s2:
            pick = u1
        if pick is None:
            return None
        done[pick] = True
        out.append(spans[pick][2])
    return out


def _insert_by_rt(order: list[int], rows: list[int]) -> list[int] | None:
    """Insert NIL (state-transparent) reads into a real-time consistent
    order, each right after its last real-time predecessor; None past
    :data:`NIL_INSERT_CAP`."""
    if not rows:
        return order
    if len(rows) > NIL_INSERT_CAP:
        return None
    inv, ret = _ranks()
    for x in sorted(rows, key=lambda i: inv[i]):
        pos = 0
        for j, y in enumerate(order):
            if ret[y] < inv[x]:
                pos = j + 1
        order.insert(pos, x)
    return order


def _gk_key_order(ks: _KeyScan) -> list[int] | None:
    """A linearization of one all-:ok key that passed the cycle checks:
    init reads, then blocks in topological order (write first, reads by
    invocation), NIL reads re-inserted by real time."""
    inv, _ret = _ranks()
    spans = _spans(ks)
    topo = _topo_clusters(sorted(spans, key=lambda t: t[0]))
    if topo is None:
        return None
    order: list[int] = sorted(ks.init_reads, key=lambda i: inv[i])
    for cl in topo:
        order.append(cl.write)
        order.extend(sorted(cl.ok_reads, key=lambda i: inv[i]))
    return _insert_by_rt(order, ks.nil_reads)


def _verify_witness(seq: OpSeq, model, order: list[int]) -> bool:
    """The self-check before a decided-valid leaves: the witness covers
    every :ok row once, respects real time and replays through the
    model."""
    n = len(seq)
    ok = np.asarray(seq.ok, dtype=bool)
    if sorted(order) != sorted(int(i) for i in range(n) if ok[i]):
        return False
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    max_inv = -1
    for r in order:
        if ret[r] < max_inv:
            return False
        max_inv = max(max_inv, inv[r])
    state = model.init
    for r in order:
        state = model.pystep(state, int(seq.f[r]), int(seq.v1[r]),
                             int(seq.v2[r]))
        if state is None:
            return False
    return True


# ---------------------------------------------------------------------------
# must-order edges (the prune)
# ---------------------------------------------------------------------------


def _forced_edges(sc: _Scan, cap: int) -> list[tuple[int, int, str]]:
    """rf, init and block edges that real time does not already imply,
    up to ``cap``."""
    inv, ret = _ranks()
    out: list[tuple[int, int, str]] = []

    def rt(a: int, b: int) -> bool:
        return ret[a] < inv[b]

    for ks in sc.keys.values():
        if ks.tainted:
            continue
        spans = _spans(ks)
        for _s, _e, cl in spans:
            for r in cl.ok_reads:
                if not rt(cl.write, r):
                    out.append((cl.write, r, "rf"))
                    if len(out) >= cap:
                        return out
        # init reads precede every anchored write
        for ri in ks.init_reads:
            for _s, _e, cl in spans:
                if not rt(ri, cl.write):
                    out.append((ri, cl.write, "init"))
                    if len(out) >= cap:
                        return out
        # block order: pairs forced one way only (both ways is a cycle,
        # found before this runs).  The pair scan is budgeted too, so
        # real-time-implied pairs cannot make it quadratic
        spans.sort(key=lambda t: t[0])
        budget = 8 * cap
        for j, (s_v, e_v, cv) in enumerate(spans):
            for (s_u, e_u, cu) in spans:
                if s_u >= e_v or budget <= 0:
                    break
                budget -= 1
                if cu is cv or s_v < e_u:
                    continue  # itself, or mutual
                # u wholly before v: u's members precede w(v)
                if not rt(cu.write, cv.write):
                    out.append((cu.write, cv.write, "ww"))
                for r in cu.ok_reads:
                    if not rt(r, cv.write):
                        out.append((r, cv.write, "ww"))
                if len(out) >= cap:
                    return out
            if budget <= 0:
                break
    return out


def _canon_edges(sc: _Scan, cap: int) -> list[tuple[int, int, str]]:
    """Canonical-order chains over same-key same-value reads: a
    staircase (inv and ret both non-decreasing) is exchange-safe, so
    forcing it loses no linearization."""
    inv, ret = _ranks()
    out: list[tuple[int, int, str]] = []
    for ks in sc.keys.values():
        for _val, rows in ks.read_classes.items():
            if len(rows) < 2:
                continue
            chain = sorted(rows, key=lambda i: (inv[i], i))
            prev = chain[0]
            for nxt in chain[1:]:
                if ret[nxt] >= ret[prev]:
                    if not ret[prev] < inv[nxt]:  # real time gives it
                        out.append((prev, nxt, "canon"))
                        if len(out) >= cap:
                            return out
                    prev = nxt
    return out


def _window_effective(seq: OpSeq, edges) -> tuple[int, int]:
    """(raw, effective) window bounds: the effective one with each
    must-order edge taking one slot off its source's freedom span."""
    ok = np.asarray(seq.ok, dtype=bool)
    det_rows = np.nonzero(ok)[0]
    nd = len(det_rows)
    if nd == 0:
        return 1, 1
    pos_of = {int(r): p for p, r in enumerate(det_rows)}
    det_inv = np.asarray(seq.inv, dtype=np.int64)[det_rows]
    det_ret = np.asarray(seq.ret, dtype=np.int64)[det_rows]
    upper = np.searchsorted(det_inv, det_ret, side="left")
    spans = (upper - np.arange(nd)).astype(np.int64)
    raw = max(1, int(spans.max()))
    for (src, dst, _k) in edges:
        ps, pd = pos_of.get(src), pos_of.get(dst)
        if ps is None or pd is None or ps >= pd:
            continue
        if pd < int(upper[ps]):
            spans[ps] -= 1
    return raw, max(1, int(spans.max()))


def _prune_bound(seq: OpSeq, edges, stats: dict) -> None:
    """The raw and pruned configuration bounds into ``stats``."""
    w_raw, w_eff = _window_effective(seq, edges)
    n = len(seq)
    nd = int(np.asarray(seq.ok, dtype=bool).sum())
    raw = (nd + 1) << (max(0, w_raw - 1) + (n - nd))
    pruned = min((nd + 1) << (max(0, w_eff - 1) + (n - nd)), raw)
    stats["window_effective"] = w_eff
    stats["pruned_upper_bound"] = pruned
    stats["prune_ratio"] = round(pruned / raw, 6) if raw else None


def _must_pred(edges) -> dict:
    """Edges -> row -> sorted tuple of its must-predecessors."""
    must: dict[int, list[int]] = {}
    for (src, dst, _k) in edges:
        must.setdefault(int(dst), []).append(int(src))
    return {d: tuple(sorted(set(s))) for d, s in must.items()}


# ---------------------------------------------------------------------------
# the prepass
# ---------------------------------------------------------------------------


def _decided_result(valid, *, certificate: dict, stats: dict) -> dict:
    stats["pruned_upper_bound"] = 0
    stats["prune_ratio"] = 0.0
    out = {"valid": valid, "configs": 0, "max_depth": 0,
           "engine": "hb-decide"}
    out.update(certificate)
    out["hb"] = stats
    return out


def analyze_hb(seq: OpSeq, model, *, canon: bool = True) -> HBAnalysis:
    """The register-family prepass.  Never raises on in-scope inputs;
    anything out of scope comes back ``applies=False``, undecided."""
    n = len(seq)
    stats = {"applies": False, "decided": None, "reason": None,
             "edges": {"rf": 0, "ww": 0, "init": 0, "canon": 0},
             "must_edges": 0}
    hb = HBAnalysis(n=n, applies=False, decided=None, stats=stats)
    if n == 0:
        stats["reason"] = "empty history"
        return hb
    sc = _scan(seq, model)
    if sc is None:
        stats["reason"] = f"model {model.name!r} out of scope"
        return hb
    if sc.has_cas:
        stats["reason"] = ("cas ops present (no unique-writes "
                           "algebra; canonical read-order only)")
    hb.applies = True
    stats["applies"] = True
    stats["keys"] = len(sc.keys)
    stats["clusters"] = sum(len(ks.clusters) for ks in sc.keys.values())

    _TLS.inv = [int(x) for x in seq.inv]
    _TLS.ret = [int(x) for x in seq.ret]
    try:
        impossible = sorted(r for ks in sc.keys.values()
                            for r in ks.impossible)
        if impossible:
            stats["decided"] = False
            stats["reason"] = "impossible-read"
            hb.decided = _decided_result(
                False, certificate={"final_ops": impossible},
                stats=stats)
            return hb

        cyc = _find_cycle(seq, sc)
        if cyc is not None:
            stats["decided"] = False
            stats["reason"] = "hb-cycle"
            hb.decided = _decided_result(
                False, certificate={"hb_cycle": cyc}, stats=stats)
            return hb

        if sc.all_ok and all(not ks.tainted for ks in sc.keys.values()):
            orders = []
            for ks in sc.keys.values():
                o = _gk_key_order(ks)
                if o is None:
                    orders = None
                    break
                orders.append(o)
            if orders is not None:
                if len(orders) == 1:
                    order = orders[0]
                else:
                    from ..decompose.partition import \
                        merge_linearizations

                    order = merge_linearizations(seq, orders)
                if order is not None and \
                        _verify_witness(seq, model, order):
                    stats["decided"] = True
                    stats["reason"] = "gk-interval"
                    hb.decided = _decided_result(
                        True,
                        certificate={
                            "linearization": [int(r) for r in order],
                            "max_depth": len(order)},
                        stats=stats)
                    return hb

        # undecided: emit the prune
        cap = max(EDGE_CAP_MIN, EDGE_CAP_FACTOR * n)
        edges = _forced_edges(sc, cap)
        if canon:
            edges += _canon_edges(sc, max(0, cap - len(edges)))
        for (_s, _d, k) in edges:
            stats["edges"][k] += 1
        stats["must_edges"] = len(edges)
        hb.must_pred = _must_pred(edges)
        _prune_bound(seq, edges, stats)
        return hb
    finally:
        _TLS.inv = _TLS.ret = None


def maybe_hb(seq: OpSeq, model, flag: bool | None = None,
             dpor: bool | None = None) -> HBAnalysis | None:
    """The engines' prepass slot: None when ``flag`` is False or the
    history is empty; else register-family models run
    :func:`analyze_hb` in an ``hb.prepass`` span, feeding the
    ``jtpu_hb_*`` metrics, and the queue and lock families the
    constraint compiler (``constraints.maybe_constraints``), and the
    dpor layer's duplicate-op edges join the must-order map
    (``dpor.merge_dup_edges``)."""
    if not resolve_hb(flag) or len(seq) == 0:
        return None
    from .. import obs
    from .constraints import family_of, maybe_constraints
    from .dpor import merge_dup_edges

    if family_of(model) is not None:
        return merge_dup_edges(seq, model, maybe_constraints(seq, model),
                               dpor)
    with obs.span("hb.prepass", cat="analyze", rows=len(seq)):
        hb = analyze_hb(seq, model)
    merge_dup_edges(seq, model, hb, dpor)
    if not hb.applies:
        _M_PREPASS.inc(outcome="skipped")
        return hb
    if hb.decided is not None:
        _M_PREPASS.inc(outcome="decided_valid"
                       if hb.decided["valid"] else "decided_invalid")
        _M_RATIO.set(0.0)
    else:
        _M_PREPASS.inc(outcome="undecided")
        _M_RATIO.set(hb.stats.get("prune_ratio") or 1.0)
        for k, v in hb.stats["edges"].items():
            if v:
                _M_EDGES.inc(v, kind=k)
    return hb


def hb_dispose(seq: OpSeq, model, flag: bool | None = True) -> dict | None:
    """Decide-fast only: the prepass's decided result (certificate
    included) for one key, or None when the key must be searched.  Goes
    through :func:`maybe_hb`, so queue and lock keys dispose on the
    constraint compiler's verdicts as register keys do on this
    solver's."""
    hbres = maybe_hb(seq, model, flag)
    if hbres is not None and hbres.decided is not None:
        return dict(hbres.decided)
    return None


def attach(result: dict, hb: HBAnalysis | None) -> dict:
    """Record the prepass summary on an engine result (decided results
    carry it already): ``result["hb"]`` for this solver,
    ``result["constraints"]`` for the constraint compiler."""
    if hb is not None and hb.applies:
        key = "constraints" if hb.stats.get("solver") == "constraints" \
            else "hb"
        if key not in result:
            result[key] = hb.stats
    return result


def plan_block(seq: OpSeq, model, raw_bound: int, n_crash: int,
               window: int, hb_analysis=None, *,
               hb: bool | None = None) -> dict:
    """The static ``hb`` block of ``analyze.plan.explain``: decidability,
    the inferred edge counts, and the pruned config bound beside the raw
    one.  A description only: it runs :func:`analyze_hb`, never
    :func:`maybe_hb`, so a plan moves neither the prepass counters nor
    ``jtpu_hb_prune_ratio``.  ``hb_analysis`` shares one solve between
    the plan's blocks; ``hb`` (None: on) is the flag the searches would
    run with, reported as ``enabled``."""
    res = hb_analysis if hb_analysis is not None else analyze_hb(seq, model)
    st = dict(res.stats)
    st["enabled"] = resolve_hb(hb)
    if "pruned_upper_bound" not in st:
        st["pruned_upper_bound"] = raw_bound
        st["prune_ratio"] = 1.0
    return st


def hb_fold_states(sseq: OpSeq, model, instates, *, witness: bool = False):
    """One crash-free segment's fold by the interval pass: the set of
    final states reachable from ``instates`` (the value of each block
    that can come last, per input state) without the level sweep.
    Returns ``states``, or ``(states, wit)`` with ``witness=True``
    (``wit`` maps each output state to ``(input state, row chain)``),
    or None outside the decidable class, where the caller sweeps.  Every
    witness replays clean or the whole fold is left to the sweep, so the
    state set is exact or absent, never truncated."""
    from dataclasses import replace as _dc_replace

    if _family(model) != "register":
        return None
    n = len(sseq)
    instates = [tuple(int(x) for x in s) for s in instates]
    if not instates or len(instates) > FOLD_INSTATE_CAP:
        return None
    if n and not bool(np.asarray(sseq.ok, dtype=bool).all()):
        return None
    states: set = set()
    wit: dict | None = {} if witness else None
    for ins in instates:
        m = _dc_replace(model, init=ins)
        sc = _scan(sseq, m)
        if sc is None or sc.has_cas or \
                any(ks.tainted for ks in sc.keys.values()):
            return None
        _TLS.inv = [int(x) for x in sseq.inv]
        _TLS.ret = [int(x) for x in sseq.ret]
        try:
            if any(ks.impossible for ks in sc.keys.values()) or \
                    _find_cycle(sseq, sc) is not None:
                continue  # no linearization from this input state
            ks = sc.keys.get(0)
            if ks is None:  # an empty segment
                states.add(ins)
                if wit is not None:
                    wit.setdefault(ins, (ins, []))
                continue
            spans = _spans(ks)
            if not spans:
                # no writes: the state cannot move
                order = _gk_key_order(ks)
                if order is None or \
                        not _verify_witness(sseq, m, order):
                    return None
                states.add(ins)
                if wit is not None:
                    wit.setdefault(ins, (ins, [int(r) for r in order]))
                continue
            # blocks that can come last: no outgoing span edge
            e_sorted = sorted(e for s, e, _c in spans)
            lasts = []
            for s, e, cl in spans:
                e_max = e_sorted[-1] if e_sorted[-1] != e \
                    else (e_sorted[-2] if len(e_sorted) > 1 else -1)
                if s >= e_max:
                    lasts.append(cl)
            if not lasts:
                return None  # acyclic spans always have a sink
            if len(lasts) > FOLD_WITNESS_STATES:
                # a truncated state set would be a wrong frontier (and
                # would poison the shared segment cache)
                return None
            for cl in lasts:
                st = (int(cl.val),)
                others = [(s, e, c) for s, e, c in spans if c is not cl]
                topo = _topo_clusters(sorted(others,
                                             key=lambda t: t[0]))
                if topo is None:
                    return None
                _inv = _TLS.inv
                order = sorted(ks.init_reads, key=lambda i: _inv[i])
                for c in [*topo, cl]:
                    order.append(c.write)
                    order.extend(sorted(c.ok_reads,
                                        key=lambda i: _inv[i]))
                order = _insert_by_rt(order, ks.nil_reads)
                if order is None or \
                        not _verify_witness(sseq, m, order):
                    return None
                states.add(st)
                if wit is not None:
                    wit.setdefault(st, (ins, [int(r) for r in order]))
        finally:
            _TLS.inv = _TLS.ret = None
    _M_FOLDS.inc()
    if witness:
        return states, wit
    return states
