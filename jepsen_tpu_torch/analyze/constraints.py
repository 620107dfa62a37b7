"""The constraint compiler: static order solving for the queue and lock
families, in the prepass slot ``hb.maybe_hb`` dispatches to.

  * **queue** (``unordered-queue-N``, ``fifo-queue-N``): an :ok dequeue
    of v reads from the (unique-payload) enqueue of v, a forced edge;
    under FIFO, real time between two enqueues forces the same order on
    their dequeues.  Decided invalid: a dequeue of a value never
    enqueued, a duplicate delivery, a dequeue wholly before its only
    enqueue, a FIFO inversion, each with a certificate ``audit.py``
    checks (W007/W008).  All-:ok unique-payload unordered-queue
    histories decide valid with a completion-order schedule that is
    replayed against the model first.
  * **lock** (``mutex``): at any rank t, the acquires forced linearized
    (:ok, returned by t) minus the releases that could have linearized
    (invoked before t) bound the held count from below; two is a forced
    double hold, and the dual sweep finds a release with no possible
    acquire.  Crashed rows count as possible, never as forced.

Undecided histories yield their forced edges as a must-order
predecessor map; anything out of scope comes back ``applies=False``.
"""

from __future__ import annotations

import bisect
from collections import Counter

import numpy as np

from ..history import NIL, OpSeq
from ..obs.metrics import REGISTRY
from .hb import (EDGE_CAP_FACTOR, EDGE_CAP_MIN, HBAnalysis, _edge,
                 _must_pred, _prune_bound, _verify_witness)

_M_PREPASS = REGISTRY.counter(
    "jtpu_constraint_prepass_total",
    "Constraint-compiler pre-pass outcomes by model family",
    ("family", "outcome"))
_M_EDGES = REGISTRY.counter(
    "jtpu_constraint_edges_total",
    "Forced constraint edges inferred beyond real time, by kind",
    ("kind",))
# declared in obs/metrics.py, so a scrape shows them before any fold
_M_FOLD_FLIPS = REGISTRY.get("jtpu_constraint_fold_flips_total")
_M_FOLD_EVENTS = REGISTRY.get("jtpu_constraint_fold_events_total")


def family_of(model) -> str | None:
    """The constraint family of a model, or None when the
    register-family solver (or nothing) owns it."""
    name = getattr(model, "name", "") or ""
    if name.startswith("unordered-queue-"):
        return "queue"
    if name.startswith("fifo-queue-"):
        return "fifo-queue"
    if name == "mutex":
        return "lock"
    return None


def analyze_prepass(seq: OpSeq, model) -> HBAnalysis:
    """The static prepass by family: registers to the happens-before
    solver, queues and locks to this compiler."""
    from .hb import analyze_hb

    if family_of(model) is None:
        return analyze_hb(seq, model)
    return analyze_constraints(seq, model)


def maybe_constraints(seq: OpSeq, model) -> HBAnalysis:
    """:func:`analyze_constraints` in a ``constraints.prepass`` span,
    feeding the ``jtpu_constraint_*`` metrics: the queue and lock
    families' side of ``hb.maybe_hb`` (which resolved the flag)."""
    from .. import obs

    fam = family_of(model) or "none"
    with obs.span("constraints.prepass", cat="analyze", rows=len(seq),
                  family=fam):
        a = analyze_constraints(seq, model)
    if not a.applies:
        _M_PREPASS.inc(family=fam, outcome="skipped")
        return a
    if a.decided is not None:
        _M_PREPASS.inc(family=fam, outcome="decided_valid"
                       if a.decided["valid"] else "decided_invalid")
    else:
        _M_PREPASS.inc(family=fam, outcome="undecided")
        for k, v in a.stats["edges"].items():
            if v:
                _M_EDGES.inc(v, kind=k)
    return a


def _decided(valid, *, certificate: dict, stats: dict) -> dict:
    stats["pruned_upper_bound"] = 0
    stats["prune_ratio"] = 0.0
    out = {"valid": valid, "configs": 0, "max_depth": 0,
           "engine": "constraint-decide"}
    out.update(certificate)
    out["constraints"] = stats
    return out


def analyze_constraints(seq: OpSeq, model) -> HBAnalysis:
    """The prepass for the queue and lock families."""
    fam = family_of(model)
    n = len(seq)
    stats = {"solver": "constraints", "family": fam, "applies": False,
             "decided": None, "reason": None,
             "edges": {"rf": 0, "fifo": 0}, "must_edges": 0}
    out = HBAnalysis(n=n, applies=False, decided=None, stats=stats)
    if fam is None:
        stats["reason"] = f"model {getattr(model, 'name', None)!r} " \
                          f"out of scope"
        return out
    if n == 0:
        stats["reason"] = "empty history"
        return out
    if fam == "lock":
        return _analyze_lock(seq, model, out)
    return _analyze_queue(seq, model, out, fifo=fam == "fifo-queue")


class _QVal:
    """One payload value's rows."""

    __slots__ = ("enq", "enq_ok", "deq_ok", "deq_info")

    def __init__(self):
        self.enq: list[int] = []       # enqueue rows, ok and crashed
        self.enq_ok: list[int] = []
        self.deq_ok: list[int] = []
        self.deq_info: list[int] = []


def _analyze_queue(seq: OpSeq, model, out: HBAnalysis,
                   *, fifo: bool) -> HBAnalysis:
    from ..models import Q_DEQ, Q_EMPTY, Q_ENQ

    stats = out.stats
    n = len(seq)
    if tuple(model.init) != (Q_EMPTY,) * model.state_width:
        stats["reason"] = "non-empty initial queue state"
        return out
    f = np.asarray(seq.f)
    if not bool(np.isin(f, (Q_ENQ, Q_DEQ)).all()):
        stats["reason"] = "foreign op code"
        return out
    out.applies = True
    stats["applies"] = True

    v1 = [int(x) for x in seq.v1]
    ok = [bool(x) for x in seq.ok]
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    fl = [int(x) for x in f]
    vals: dict[int, _QVal] = {}
    n_enq = 0
    for i in range(n):
        v = v1[i]
        if v == NIL:
            continue  # a NIL-valued row never constrains the multiset
        q = vals.get(v)
        if q is None:
            q = vals[v] = _QVal()
        if fl[i] == Q_ENQ:
            n_enq += 1
            q.enq.append(i)
            if ok[i]:
                q.enq_ok.append(i)
        elif ok[i]:
            q.deq_ok.append(i)
        else:
            q.deq_info.append(i)
    stats["values"] = len(vals)

    def rt(a: int, b: int) -> bool:
        return ret[a] < inv[b]

    # a dequeue of a value never enqueued
    impossible = sorted(r for q in vals.values() if not q.enq
                        for r in q.deq_ok)
    if impossible:
        stats["decided"] = False
        stats["reason"] = "impossible-dequeue"
        out.decided = _decided(False, certificate={
            "final_ops": impossible,
            "queue_evidence": {"family": "queue",
                               "kind": "unexpected-dequeue",
                               "rows": impossible}}, stats=stats)
        return out

    # more :ok dequeues of a value than enqueue rows of it
    for q in vals.values():
        if len(q.deq_ok) > len(q.enq):
            stats["decided"] = False
            stats["reason"] = "duplicate-delivery"
            out.decided = _decided(False, certificate={
                "final_ops": sorted(q.deq_ok),
                "queue_dup": {"dequeues": sorted(q.deq_ok),
                              "enqueues": sorted(q.enq)}}, stats=stats)
            return out

    # a dequeue wholly before the only enqueue that could feed it
    for q in vals.values():
        if len(q.enq) != 1:
            continue
        e = q.enq[0]
        for d in q.deq_ok:
            if rt(d, e):
                stats["decided"] = False
                stats["reason"] = "rf-cycle"
                out.decided = _decided(False, certificate={
                    "queue_cycle": [_edge(e, d, "rf"),
                                    _edge(d, e, "rt")]}, stats=stats)
                return out

    # unique (enqueue, dequeue) pairs
    pairs = [(q.enq[0], q.deq_ok[0]) for q in vals.values()
             if len(q.enq) == 1 and len(q.deq_ok) == 1
             and not q.deq_info]

    if fifo and len(pairs) >= 2:
        # a FIFO inversion: enq_i wholly before enq_j and deq_j wholly
        # before deq_i.  Sweep j by enqueue invocation; the admitted
        # prefix (ret(enq_i) < inv(enq_j)) only grows, and only its
        # member with the latest dequeue invocation can witness it
        by_einv = sorted(pairs, key=lambda p: inv[p[0]])
        by_eret = sorted(pairs, key=lambda p: ret[p[0]])
        k = 0
        best = None  # (inv(deq_i), pair_i) over the admitted prefix
        for (ej, dj) in by_einv:
            while k < len(by_eret) and ret[by_eret[k][0]] < inv[ej]:
                p = by_eret[k]
                if best is None or inv[p[1]] > best[0]:
                    best = (inv[p[1]], p)
                k += 1
            if best is not None and ret[dj] < best[0]:
                ei, di = best[1]
                if ei != ej:
                    stats["decided"] = False
                    stats["reason"] = "fifo-inversion"
                    out.decided = _decided(False, certificate={
                        "queue_cycle": [
                            _edge(di, dj, "fifo", via=(ei, ej)),
                            _edge(dj, di, "rt")]}, stats=stats)
                    return out

    # decided valid (unordered only): completion order with each
    # enqueue pulled in front of its dequeue, replayed before it leaves
    all_ok = all(ok)
    unique = all(len(q.enq) <= 1 and len(q.deq_ok) <= 1
                 for q in vals.values())
    if not fifo and all_ok and unique and not any(v == NIL for v in v1) \
            and model.state_width >= n_enq:
        key = {}
        for q in vals.values():
            if q.enq and q.deq_ok:
                e, d = q.enq[0], q.deq_ok[0]
                key[e] = min(ret[e], ret[d])
        order = sorted(range(n),
                       key=lambda i: (key.get(i, ret[i]),
                                      0 if fl[i] == Q_ENQ else 1, i))
        if _verify_witness(seq, model, order):
            stats["decided"] = True
            stats["reason"] = "completion-schedule"
            out.decided = _decided(True, certificate={
                "linearization": [int(r) for r in order],
                "max_depth": n}, stats=stats)
            return out

    # undecided: emit the prune
    cap = max(EDGE_CAP_MIN, EDGE_CAP_FACTOR * n)
    edges: list[tuple[int, int, str]] = []
    for q in vals.values():
        if len(q.enq) != 1:
            continue  # no unique writer: no forced read-from
        e = q.enq[0]
        for d in (*q.deq_ok, *q.deq_info):
            if not rt(e, d):
                edges.append((e, d, "rf"))
                if len(edges) >= cap:
                    break
        if len(edges) >= cap:
            break
    if fifo and len(edges) < cap and len(pairs) >= 2:
        # one FIFO predecessor per dequeue: the least-returning enqueue
        # wholly before it forces its dequeue first
        by_einv = sorted(pairs, key=lambda p: inv[p[0]])
        best = None  # (ret(enq), deq) with the least ret(enq) so far
        for (e, d) in by_einv:
            if best is not None and best[0] < inv[e] \
                    and not rt(best[1], d):
                edges.append((best[1], d, "fifo"))
                if len(edges) >= cap:
                    break
            if best is None or ret[e] < best[0]:
                best = (ret[e], d)
    for (_s, _d, k) in edges:
        stats["edges"][k] += 1
    stats["must_edges"] = len(edges)
    out.must_pred = _must_pred(edges)
    _prune_bound(seq, edges, stats)
    return out


def _analyze_lock(seq: OpSeq, model, out: HBAnalysis) -> HBAnalysis:
    from ..models import M_ACQUIRE, M_RELEASE

    stats = out.stats
    if tuple(model.init) != (0,):
        stats["reason"] = "non-free initial lock state"
        return out
    f = np.asarray(seq.f)
    if not bool(np.isin(f, (M_ACQUIRE, M_RELEASE)).all()):
        stats["reason"] = "foreign op code"
        return out
    out.applies = True
    stats["applies"] = True
    ok = [bool(x) for x in seq.ok]
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    fl = [int(x) for x in f]
    n = len(seq)
    acq_rows = [i for i in range(n) if fl[i] == M_ACQUIRE]
    rel_rows = [i for i in range(n) if fl[i] == M_RELEASE]
    stats["acquires"] = len(acq_rows)
    stats["releases"] = len(rel_rows)

    # forced double hold: at the k-th :ok acquire completion, fewer
    # than k-1 releases could have linearized
    acq_ok = sorted((i for i in acq_rows if ok[i]), key=lambda i: ret[i])
    rel_inv = sorted(inv[i] for i in rel_rows)
    for k, i in enumerate(acq_ok, start=1):
        possible_rel = bisect.bisect_left(rel_inv, ret[i])
        if k - possible_rel >= 2:
            stats["decided"] = False
            stats["reason"] = "lock-overhold"
            out.decided = _decided(False, certificate={
                "final_ops": sorted(acq_ok[max(0, k - 2):k])},
                stats=stats)
            return out

    # forced release of a free lock: at the k-th :ok release completion,
    # fewer than k acquires could have linearized
    rel_ok = sorted((i for i in rel_rows if ok[i]), key=lambda i: ret[i])
    acq_inv = sorted(inv[i] for i in acq_rows)
    for k, i in enumerate(rel_ok, start=1):
        possible_acq = bisect.bisect_left(acq_inv, ret[i])
        if k - possible_acq >= 1:
            stats["decided"] = False
            stats["reason"] = "release-unheld"
            out.decided = _decided(False, certificate={
                "final_ops": [i]}, stats=stats)
            return out

    # alternation has no unique-writer structure: no forced edges, and
    # deciding valid stays with the engines
    _prune_bound(seq, [], stats)
    return out


def plan_block(seq: OpSeq, model, *, hb: bool | None = None) -> dict:
    """The static ``constraints`` block of ``analyze.plan.explain``:
    family, decidability, the inferred edge counts and which streamed
    fold route the family has.  A description only: no live metric
    moves.  ``hb`` (None: on) is the prepass flag, reported as
    ``enabled``."""
    from .hb import resolve_hb

    fam = family_of(model)
    if fam is None:
        return {"applies": False, "family": None, "enabled": resolve_hb(hb),
                "reason": "register-family model (see the hb block)",
                "stream_fold": {"eligible": False, "route": None}}
    a = analyze_constraints(seq, model)
    st = dict(a.stats)
    st["enabled"] = resolve_hb(hb)
    queue = fam in ("queue", "fifo-queue")
    st["stream_fold"] = {"eligible": queue,
                         "route": "total-queue" if queue else None}
    if "pruned_upper_bound" not in st:
        st.setdefault("pruned_upper_bound", None)
        st.setdefault("prune_ratio", 1.0)
    return st


# ---------------------------------------------------------------------------
# event-level multiset analysis (the checkers' and the fold's substrate)
# ---------------------------------------------------------------------------


def analyze_queue_events(history) -> dict:
    """The multiset analysis of an event-level queue history: the
    verdict ``checker.basic.total_queue`` computes, carried as row-level
    evidence (event indices) the audit re-justifies (W007).  Returns
    ``{"valid", "evidence", "edges", "lost", "unexpected"}``.  Drains
    expand as the checker expands them; a crashed drain gives
    ``{"valid": "unknown"}``."""
    from ..history import is_invoke, is_ok

    attempts: Counter = Counter()
    enq_ok: Counter = Counter()
    enq_ok_row: dict = {}
    deq: Counter = Counter()
    first_deq_row: dict = {}
    edges = 0
    for i, op in enumerate(history):
        if not isinstance(op.process, int):
            continue
        if op.f == "enqueue":
            if is_invoke(op):
                attempts[op.value] += 1
            elif is_ok(op):
                enq_ok[op.value] += 1
                enq_ok_row.setdefault(op.value, i)
        elif op.f == "dequeue" and is_ok(op):
            deq[op.value] += 1
            first_deq_row.setdefault(op.value, i)
            if op.value in enq_ok_row:
                edges += 1  # enqueue -> dequeue read-from
        elif op.f == "drain":
            if is_ok(op) and isinstance(op.value, (list, tuple)):
                for element in op.value:
                    deq[element] += 1
                    first_deq_row.setdefault(element, i)
                    if element in enq_ok_row:
                        edges += 1
            elif not is_invoke(op) and op.type != "fail":
                return {"valid": "unknown", "evidence": None,
                        "edges": edges,
                        "info": "crashed drain: removed elements "
                                "unidentifiable"}
    lost = enq_ok - deq
    unexpected = Counter({v: c for v, c in deq.items()
                          if v not in attempts})
    evidence = None
    if unexpected:
        rows = sorted(first_deq_row[v] for v in unexpected)
        evidence = {"family": "queue", "kind": "unexpected-dequeue",
                    "rows": rows, "values": sorted(map(str, unexpected))}
    elif lost:
        rows = sorted(enq_ok_row[v] for v in lost if v in enq_ok_row)
        evidence = {"family": "queue", "kind": "lost-acked-enqueue",
                    "rows": rows, "values": sorted(map(str, lost))}
    return {"valid": not lost and not unexpected, "evidence": evidence,
            "edges": edges, "lost": dict(lost),
            "unexpected": dict(unexpected)}


def analyze_set_events(history) -> dict:
    """The set analysis: add -> member-read edges and the set checker's
    verdict (lost and unexpected against the final read) with row-level
    evidence."""
    from ..history import is_invoke, is_ok

    attempts: set = set()
    add_ok_row: dict = {}
    final_read = None
    final_row = None
    for i, op in enumerate(history):
        if not isinstance(op.process, int):
            continue
        if op.f == "add":
            if is_invoke(op):
                attempts.add(op.value)
            elif is_ok(op):
                add_ok_row.setdefault(op.value, i)
        elif op.f == "read" and is_ok(op):
            final_read, final_row = set(op.value or ()), i
    if final_read is None:
        return {"valid": "unknown", "evidence": None, "edges": 0}
    edges = sum(1 for v in final_read if v in add_ok_row)
    lost = set(add_ok_row) - final_read
    unexpected = final_read - attempts
    evidence = None
    if unexpected:
        evidence = {"family": "set", "kind": "unexpected-member",
                    "rows": [final_row],
                    "values": sorted(map(str, unexpected))}
    elif lost:
        evidence = {"family": "set", "kind": "lost-acked-add",
                    "rows": sorted(add_ok_row[v] for v in lost),
                    "values": sorted(map(str, lost))}
    return {"valid": not lost and not unexpected, "evidence": evidence,
            "edges": edges, "lost": sorted(map(str, lost)),
            "unexpected": sorted(map(str, unexpected))}


class MultisetFold:
    """The incremental form of the multiset analysis, one event at a
    time: what the streamed total-queue route runs.

    ``step(op, i)`` folds event ``i`` and returns flip evidence (shaped
    as :func:`analyze_queue_events`'s ``evidence``) the first time the
    running state proves the history invalid, else None.  Two rules,
    each confirmed at finalize by the post-hoc checker:

      * **unexpected**: an :ok dequeue (or drained element) of a value
        no enqueue ever attempted, flagged at that event;
      * **lost**: at an :ok drain's own completion with no client op
        pending, acked enqueues missing from every delivery so far.
        Never at other completions: an enqueue acked after the drain
        is not lost the instant its :ok lands.

    ``family="set"``: adds and reads, the read standing for the drain.
    """

    def __init__(self, family: str = "total-queue"):
        self.family = "set" if family == "set" else "total-queue"
        self.attempts: Counter = Counter()
        self.enq_ok: Counter = Counter()
        self.enq_ok_row: dict = {}
        self.deq: Counter = Counter()
        self.pending: dict = {}     # process -> f
        self.drained = False        # an :ok drain/read has landed
        self.lossy = False          # a crashed drain: lost undecidable
        self.last_read: set | None = None
        self.last_read_row: int | None = None

    def step(self, op, i: int) -> dict | None:
        from ..history import INVOKE

        _M_FOLD_EVENTS.inc()
        if not isinstance(op.process, int):
            return None
        if op.type == INVOKE:
            self.pending[op.process] = op.f
            if op.f in ("enqueue", "add"):
                self.attempts[op.value] += 1
            return None
        self.pending.pop(op.process, None)
        if self.family == "set":
            flip = self._step_set(op, i)
        else:
            flip = self._step_queue(op, i)
        if flip is not None:
            _M_FOLD_FLIPS.inc(kind=flip["kind"])
        return flip

    def _step_queue(self, op, i: int) -> dict | None:
        from ..history import is_ok

        if op.f == "enqueue" and is_ok(op):
            self.enq_ok[op.value] += 1
            self.enq_ok_row.setdefault(op.value, i)
        elif op.f == "dequeue" and is_ok(op):
            self.deq[op.value] += 1
            if op.value not in self.attempts:
                return {"family": "queue", "kind": "unexpected-dequeue",
                        "rows": [i], "values": [str(op.value)]}
        elif op.f == "drain":
            if is_ok(op) and isinstance(op.value, (list, tuple)):
                self.drained = True
                for element in op.value:
                    self.deq[element] += 1
                    if element not in self.attempts:
                        return {"family": "queue",
                                "kind": "unexpected-dequeue",
                                "rows": [i],
                                "values": [str(element)]}
                if not self.lossy and not self.pending:
                    lost = self.enq_ok - self.deq
                    if lost:
                        rows = sorted(self.enq_ok_row[v] for v in lost
                                      if v in self.enq_ok_row)
                        return {"family": "queue",
                                "kind": "lost-acked-enqueue",
                                "rows": rows,
                                "values": sorted(map(str, lost))}
            elif op.type == "info":
                self.lossy = True  # removed elements unidentifiable
        return None

    def _step_set(self, op, i: int) -> dict | None:
        from ..history import is_ok

        if op.f == "add" and is_ok(op):
            self.enq_ok[op.value] += 1
            self.enq_ok_row.setdefault(op.value, i)
        elif op.f == "read" and is_ok(op):
            self.drained = True
            self.last_read = set(op.value or ())
            self.last_read_row = i
            unexpected = self.last_read - set(self.attempts)
            if unexpected:
                return {"family": "set", "kind": "unexpected-member",
                        "rows": [i],
                        "values": sorted(map(str, unexpected))}
            # as with drains: lost is judged only at the read itself
            if not self.pending:
                lost = set(self.enq_ok_row) - self.last_read
                if lost:
                    return {"family": "set", "kind": "lost-acked-add",
                            "rows": sorted(self.enq_ok_row[v]
                                           for v in lost),
                            "values": sorted(map(str, lost))}
        return None
