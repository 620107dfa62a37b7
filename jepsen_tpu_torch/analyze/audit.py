"""Certificate audit: an independent replay of the certificate each
verdict carries.

A valid result carries ``linearization`` (rows of the checked OpSeq in
linearization order) or a ``witness_dropped`` reason; an invalid one
``final_ops`` (the blocking frontier), a cycle of forced edges
(``hb_cycle``, ``queue_cycle``), a duplicate delivery (``queue_dup``),
queue evidence, or a ``frontier_dropped`` reason.  This module replays
those against the history and the model in plain Python, sharing no
code with the engines: a certificate that fails its audit is an engine
bug the verdict alone would hide.

==== =================================================================
W001 the certificate names a row not in the history
W002 a duplicate or missing op (an :ok row absent from the witness, a
     row linearized twice, or a verdict with neither a certificate nor
     a drop reason)
W003 the witness violates real-time order
W004 the model rejects a step of the witness
W005 a stitched witness violates cross-cell precedence
W006 an HB-cycle certificate fails its independent check
W007 queue/set multiset evidence fails its independent check
W008 a queue order certificate (duplicate delivery, FIFO inversion,
     read-from cycle) fails its independent check
==== =================================================================

:func:`audit` reports and never raises; :func:`maybe_audit` attaches
the report to the result and raises :class:`AuditError` on any W-code.
``audit=True`` turns it on; None and False leave it off.
"""

from __future__ import annotations

from ..history import OpSeq, encode_ops
from .lint import Diagnostic

AUDIT_CODES = {
    "W001": "certificate references an op not in the history",
    "W002": "duplicate or missing op in the certificate",
    "W003": "witness violates real-time order",
    "W004": "model step rejects a witness transition",
    "W005": "stitched witness violates cross-cell precedence",
    "W006": "HB-cycle certificate fails independent validation",
    "W007": "queue/set multiset evidence fails independent validation "
            "(lost-acked-enqueue / unexpected-dequeue rows unjustified)",
    "W008": "queue order certificate fails independent validation "
            "(duplicate-delivery or FIFO-inversion/rf-cycle edges "
            "unjustified)",
}


class AuditError(ValueError):
    """A certificate failed its audit.  ``diagnostics`` carries every
    W-code finding, ``audit`` the whole report."""

    def __init__(self, audit: dict):
        self.audit = audit
        self.diagnostics = list(audit.get("diagnostics", ()))
        head = "; ".join(str(d) for d in self.diagnostics[:5])
        more = (f" (+{len(self.diagnostics) - 5} more)"
                if len(self.diagnostics) > 5 else "")
        super().__init__(f"certificate failed audit: {head}{more}")


def _as_seq(history, model) -> OpSeq:
    if isinstance(history, OpSeq):
        return history
    return encode_ops(history, model.f_codes)


def _audit_witness(seq: OpSeq, model, result: dict, diags: list) -> None:
    """Replay a ``linearization`` certificate: coverage (W001/W002),
    real-time order (W003/W005), model legality (W004)."""
    lin = result["linearization"]
    n = len(seq)
    # W005 needs a row -> cell map; for the key-partitioned (stitched)
    # route the cell IS the key lane, so it is derivable from the
    # history itself — the result does not have to ship a row map
    stitched = bool((result.get("decompose") or {}).get("stitched"))
    cell_of = None
    if stitched and getattr(model, "name", "") == "multi-register":
        cell_of = [int(x) for x in seq.v1]

    seen: set[int] = set()
    rows: list[int] = []
    for pos, r in enumerate(lin):
        if not isinstance(r, int) or isinstance(r, bool) \
                or not 0 <= r < n:
            diags.append(Diagnostic(
                "W001", "error",
                f"witness position {pos} references row {r!r}, not a "
                f"row of this {n}-op history", index=pos))
            continue
        if r in seen:
            diags.append(Diagnostic(
                "W002", "error",
                f"row {r} appears more than once in the witness "
                f"(position {pos})", index=r))
            continue
        seen.add(r)
        rows.append(r)

    ok = seq.ok
    missing = [i for i in range(n) if bool(ok[i]) and i not in seen]
    for i in missing[:8]:
        diags.append(Diagnostic(
            "W002", "error",
            f":ok row {i} is missing from the witness (every ok op "
            f"must linearize)", index=i))
    if len(missing) > 8:
        diags.append(Diagnostic(
            "W002", "error",
            f"...and {len(missing) - 8} more :ok rows missing"))

    # real-time: no witness op may precede an op that returned before
    # it invoked.  One pass tracking the running max invocation rank
    # (and which row holds it): a later row returning below that max
    # was really ordered after its own return.
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    max_inv = -1
    max_inv_row = -1
    for r in rows:
        if ret[r] < max_inv:
            code, extra = "W003", ""
            if cell_of is not None and cell_of[r] != cell_of[max_inv_row]:
                code = "W005"
                extra = (f" (cells {cell_of[max_inv_row]} vs "
                         f"{cell_of[r]}: the stitch broke cross-cell "
                         f"precedence)")
            diags.append(Diagnostic(
                code, "error",
                f"row {r} (returns at rank {ret[r]}) is linearized "
                f"after row {max_inv_row} (invokes at rank "
                f"{inv[max_inv_row]}) although it returned first"
                f"{extra}", index=r))
        if inv[r] > max_inv:
            max_inv, max_inv_row = inv[r], r

    # model replay, the independent legality check (plain pystep, no
    # engine encodings)
    pystep = model.pystep
    state = model.init
    f = seq.f
    v1 = seq.v1
    v2 = seq.v2
    for r in rows:
        ns = pystep(state, int(f[r]), int(v1[r]), int(v2[r]))
        if ns is None:
            op = seq.ops[r] if seq.ops else None
            what = (f"{op.process} {op.f} {op.value!r}" if op is not None
                    else f"f={int(f[r])} v1={int(v1[r])} v2={int(v2[r])}")
            diags.append(Diagnostic(
                "W004", "error",
                f"model {model.name!r} rejects witness step at row {r} "
                f"({what}) from state {tuple(state)}", index=r))
            break  # later steps run from a state that never existed
        state = ns


def _audit_hb_cycle(seq: OpSeq, model, result: dict,
                    diags: list) -> None:
    """Independently re-justify an HB-cycle certificate (analyze/hb.py)
    edge by edge — sharing no code with the solver that emitted it.

    The certificate claims a cycle of FORCED order: each edge must hold
    in every valid linearization, and the chain must close.  Edge
    kinds:

      rt    ret[src] < inv[dst] (real time; self-evident)
      rf    src is THE unique write of value v, dst an :ok read of v
      ww    src's value-block must wholly precede dst's, witnessed by
            ``via=[a, b]`` — a in src's block, b in dst's block,
            ret[a] < inv[b] (block contiguity under unique writes)
      init  src is an :ok read of the initial value (never written),
            dst a member of an anchored write block

    Preconditions re-checked here (W006 when violated): register-family
    model, no cas rows, unique non-NIL non-init writes for every value
    the certificate touches, anchored blocks for ww edges.
    """
    from ..models import R_CAS, R_READ, R_WRITE

    cyc = result["hb_cycle"]
    n = len(seq)

    def bad(msg, index=None):
        diags.append(Diagnostic("W006", "error", msg, index=index))

    if not isinstance(cyc, (list, tuple)) or len(cyc) < 2:
        bad("hb_cycle must be a chain of at least two edges")
        return
    name = getattr(model, "name", "")
    multi = name == "multi-register"
    if name not in ("register", "cas-register", "multi-register"):
        bad(f"model {name!r} is outside the unique-writes block "
            f"algebra the certificate relies on")
        return
    f = [int(x) for x in seq.f]
    if any(x == R_CAS for x in f) and name == "cas-register":
        bad("history contains cas ops: writes are not unique and the "
            "block algebra does not apply")
        return
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    ok = [bool(x) for x in seq.ok]
    key = [int(x) for x in seq.v1] if multi else [0] * n
    val = [int(x) for x in (seq.v2 if multi else seq.v1)]
    init_of = (lambda k: int(model.init[k])
               if 0 <= k < model.state_width else None) if multi \
        else (lambda k: int(model.init[0]))

    # value -> write rows, for uniqueness + membership checks
    writes: dict = {}
    for i in range(n):
        if f[i] == R_WRITE:
            writes.setdefault((key[i], val[i]), []).append(i)

    def block_of(i):
        """(key, value) block of a row, or None when the row cannot
        belong to one (NIL value, foreign op)."""
        if f[i] not in (R_READ, R_WRITE):
            return None
        from ..history import NIL

        if val[i] == NIL:
            return None
        return (key[i], val[i])

    def block_sound(b, index):
        """Unique, non-init, anchored write block."""
        from ..history import NIL

        ws = writes.get(b, [])
        if len(ws) != 1:
            bad(f"value {b[1]} has {len(ws)} writes — block reasoning "
                f"needs exactly one", index=index)
            return False
        if b[1] == NIL or b[1] == init_of(b[0]):
            bad(f"value {b[1]} collides with NIL/initial value — "
                f"blocks do not apply", index=index)
            return False
        w = ws[0]
        if not ok[w] and not any(
                f[i] == R_READ and ok[i] and block_of(i) == b
                for i in range(n)):
            bad(f"block of value {b[1]} is not anchored (crashed "
                f"write, no :ok read): it need not linearize at all",
                index=index)
            return False
        return True

    rows_ok = True
    for e in cyc:
        for fld in ("src", "dst"):
            r = e.get(fld)
            if not isinstance(r, int) or isinstance(r, bool) \
                    or not 0 <= r < n:
                diags.append(Diagnostic(
                    "W001", "error",
                    f"hb_cycle edge references row {r!r}, not a row "
                    f"of this {n}-op history"))
                rows_ok = False
    if not rows_ok:
        return
    for i, e in enumerate(cyc):
        nxt = cyc[(i + 1) % len(cyc)]
        src, dst, kind = e["src"], e["dst"], e.get("kind")
        if dst != nxt["src"]:
            bad(f"edge {i} ends at row {dst} but edge "
                f"{(i + 1) % len(cyc)} starts at row {nxt['src']} — "
                f"the chain does not close", index=dst)
        if kind == "rt":
            if not ret[src] < inv[dst]:
                bad(f"rt edge {src}->{dst} unjustified: row {src} did "
                    f"not return before row {dst} invoked", index=src)
        elif kind == "rf":
            b = block_of(dst)
            if f[dst] != R_READ or not ok[dst] or b is None:
                bad(f"rf edge {src}->{dst}: row {dst} is not an :ok "
                    f"read of a concrete value", index=dst)
            elif not block_sound(b, src):
                pass
            elif writes[b][0] != src:
                bad(f"rf edge {src}->{dst}: row {src} is not the "
                    f"write of value {b[1]}", index=src)
        elif kind == "ww":
            via = e.get("via") or (src, dst)
            a, b2 = int(via[0]), int(via[1])
            bs, bd = block_of(src), block_of(dst)
            if bs is None or bd is None or bs == bd:
                bad(f"ww edge {src}->{dst}: rows are not members of "
                    f"two distinct value blocks", index=src)
                continue
            if not (block_sound(bs, src) and block_sound(bd, dst)):
                continue
            if block_of(a) != bs or block_of(b2) != bd or \
                    (f[a] == R_READ and not ok[a]) or \
                    (f[b2] == R_READ and not ok[b2]):
                bad(f"ww edge {src}->{dst}: via pair ({a},{b2}) does "
                    f"not witness these blocks", index=src)
            elif not ret[a] < inv[b2]:
                bad(f"ww edge {src}->{dst}: via pair ({a},{b2}) is "
                    f"not a real-time edge", index=a)
        elif kind == "init":
            iv = init_of(key[src])
            from ..history import NIL

            if f[src] != R_READ or not ok[src] or iv is None \
                    or iv == NIL or val[src] != iv:
                bad(f"init edge {src}->{dst}: row {src} is not an "
                    f":ok read of the initial value", index=src)
                continue
            if writes.get((key[src], iv)):
                bad(f"init edge {src}->{dst}: the initial value "
                    f"{iv} is re-written, so init reads are not "
                    f"forced first", index=src)
                continue
            bd = block_of(dst)
            if bd is None or bd[0] != key[src] or bd not in writes \
                    or not block_sound(bd, dst):
                bad(f"init edge {src}->{dst}: row {dst} is not a "
                    f"member of an anchored write block on the same "
                    f"key", index=dst)
        else:
            bad(f"edge {i} has unknown kind {kind!r}", index=src)


def _queue_fs(model) -> tuple[int, int]:
    from ..models import Q_DEQ, Q_ENQ

    return Q_ENQ, Q_DEQ


def _audit_queue_order(seq: OpSeq, model, result: dict,
                       diags: list) -> None:
    """Independently re-justify a queue ORDER certificate
    (analyze/constraints.py) — ``queue_cycle`` (rf/rt/fifo forced-edge
    chain) or ``queue_dup`` (duplicate delivery) — sharing no code
    with the compiler that emitted it.  W008 on any unjustified edge,
    open chain, or incomplete row set."""
    name = getattr(model, "name", "") or ""

    def bad(msg, index=None):
        diags.append(Diagnostic("W008", "error", msg, index=index))

    if not (name.startswith("unordered-queue-")
            or name.startswith("fifo-queue-")):
        bad(f"model {name!r} is outside the queue multiset algebra "
            f"the certificate relies on")
        return
    Q_ENQ, Q_DEQ = _queue_fs(model)
    n = len(seq)
    f = [int(x) for x in seq.f]
    v1 = [int(x) for x in seq.v1]
    ok = [bool(x) for x in seq.ok]
    inv = [int(x) for x in seq.inv]
    ret = [int(x) for x in seq.ret]
    from ..history import NIL

    enq_of: dict = {}
    deq_ok_of: dict = {}
    for i in range(n):
        if v1[i] == NIL:
            continue
        if f[i] == Q_ENQ:
            enq_of.setdefault(v1[i], []).append(i)
        elif f[i] == Q_DEQ and ok[i]:
            deq_ok_of.setdefault(v1[i], []).append(i)

    dup = result.get("queue_dup")
    if dup is not None:
        deqs = sorted(int(r) for r in dup.get("dequeues", ()))
        enqs = sorted(int(r) for r in dup.get("enqueues", ()))
        if any(not 0 <= r < n for r in (*deqs, *enqs)):
            diags.append(Diagnostic(
                "W001", "error",
                f"queue_dup references a row outside this {n}-op "
                f"history"))
            return
        if not deqs:
            bad("queue_dup names no dequeue rows")
            return
        val = v1[deqs[0]]
        if deqs != sorted(deq_ok_of.get(val, ())):
            bad(f"queue_dup dequeue rows are not exactly the :ok "
                f"dequeues of value {val}", index=deqs[0])
        elif enqs != sorted(enq_of.get(val, ())):
            bad(f"queue_dup enqueue rows are not exactly the enqueue "
                f"rows of value {val}", index=deqs[0])
        elif len(deqs) <= len(enqs):
            bad(f"value {val} has {len(enqs)} enqueue row(s) for "
                f"{len(deqs)} :ok dequeue(s) — no duplicate delivery",
                index=deqs[0])
        return

    cyc = result.get("queue_cycle")
    if not isinstance(cyc, (list, tuple)) or len(cyc) < 2:
        bad("queue_cycle must be a chain of at least two edges")
        return
    for e in cyc:
        for fld in ("src", "dst"):
            r = e.get(fld)
            if not isinstance(r, int) or isinstance(r, bool) \
                    or not 0 <= r < n:
                diags.append(Diagnostic(
                    "W001", "error",
                    f"queue_cycle edge references row {r!r}, not a row "
                    f"of this {n}-op history"))
                return
    for i, e in enumerate(cyc):
        nxt = cyc[(i + 1) % len(cyc)]
        src, dst, kind = e["src"], e["dst"], e.get("kind")
        if dst != nxt["src"]:
            bad(f"edge {i} ends at row {dst} but edge "
                f"{(i + 1) % len(cyc)} starts at row {nxt['src']} — "
                f"the chain does not close", index=dst)
        if kind == "rt":
            if not ret[src] < inv[dst]:
                bad(f"rt edge {src}->{dst} unjustified: row {src} did "
                    f"not return before row {dst} invoked", index=src)
        elif kind == "rf":
            val = v1[dst]
            if f[dst] != Q_DEQ or not ok[dst] or val == NIL:
                bad(f"rf edge {src}->{dst}: row {dst} is not an :ok "
                    f"dequeue of a concrete value", index=dst)
            elif enq_of.get(val, []) != [src]:
                bad(f"rf edge {src}->{dst}: row {src} is not the "
                    f"unique enqueue of value {val}", index=src)
        elif kind == "fifo":
            if not name.startswith("fifo-queue-"):
                bad(f"fifo edge {src}->{dst} on non-FIFO model "
                    f"{name!r}", index=src)
                continue
            via = e.get("via") or ()
            if len(via) != 2:
                bad(f"fifo edge {src}->{dst} carries no enqueue "
                    f"witness pair", index=src)
                continue
            ei, ej = int(via[0]), int(via[1])
            if not (0 <= ei < n and 0 <= ej < n):
                diags.append(Diagnostic(
                    "W001", "error",
                    f"fifo edge via pair ({ei},{ej}) is outside this "
                    f"{n}-op history"))
                continue
            vi, vj = v1[src], v1[dst]
            if f[src] != Q_DEQ or not ok[src] or f[dst] != Q_DEQ \
                    or not ok[dst] or vi == NIL or vj == NIL \
                    or vi == vj:
                bad(f"fifo edge {src}->{dst}: rows are not :ok "
                    f"dequeues of two distinct values", index=src)
            elif enq_of.get(vi, []) != [ei] \
                    or enq_of.get(vj, []) != [ej]:
                bad(f"fifo edge {src}->{dst}: via pair ({ei},{ej}) is "
                    f"not the unique enqueues of values {vi}/{vj}",
                    index=ei)
            elif not ret[ei] < inv[ej]:
                bad(f"fifo edge {src}->{dst}: enqueue {ei} did not "
                    f"return before enqueue {ej} invoked — FIFO forces "
                    f"nothing", index=ei)
        else:
            bad(f"edge {i} has unknown kind {kind!r}", index=src)


def _audit_queue_evidence_seq(seq: OpSeq, model, result: dict,
                              diags: list) -> None:
    """W007 over an OpSeq-level ``queue_evidence`` certificate: each
    named row must be an :ok dequeue whose value no enqueue row (of any
    status) could have produced."""
    ev = result.get("queue_evidence") or {}
    Q_ENQ, Q_DEQ = _queue_fs(model)
    n = len(seq)
    f = [int(x) for x in seq.f]
    v1 = [int(x) for x in seq.v1]
    ok = [bool(x) for x in seq.ok]
    from ..history import NIL

    enq_vals = {v1[i] for i in range(n) if f[i] == Q_ENQ}
    if ev.get("kind") != "unexpected-dequeue":
        diags.append(Diagnostic(
            "W007", "error",
            f"OpSeq queue evidence of kind {ev.get('kind')!r} is not "
            f"independently checkable (expected unexpected-dequeue)"))
        return
    rows = ev.get("rows") or ()
    if not rows:
        diags.append(Diagnostic(
            "W007", "error", "queue_evidence names no rows"))
        return
    for r in rows:
        if not isinstance(r, int) or isinstance(r, bool) \
                or not 0 <= r < n:
            diags.append(Diagnostic(
                "W001", "error",
                f"queue_evidence references row {r!r}, not a row of "
                f"this {n}-op history"))
            continue
        if f[r] != Q_DEQ or not ok[r] or v1[r] == NIL:
            diags.append(Diagnostic(
                "W007", "error",
                f"row {r} is not an :ok dequeue of a concrete value",
                index=r))
        elif v1[r] in enq_vals:
            diags.append(Diagnostic(
                "W007", "error",
                f"row {r} dequeues value {v1[r]}, which some enqueue "
                f"row could have produced — not unexpected", index=r))


def _audit_multiset_evidence(ops, result: dict, diags: list) -> None:
    """W007 over EVENT-level multiset evidence (the streamed
    total-queue/set fold's certificate): re-derive lost / unexpected
    from the raw history — independently of both the fold and the
    post-hoc checker — and check every named event row justifies the
    claimed kind."""
    ev = result.get("queue_evidence") or {}
    kind = ev.get("kind")
    rows = list(ev.get("rows") or ())
    n = len(ops)

    def bad(msg, index=None):
        diags.append(Diagnostic("W007", "error", msg, index=index))

    if not rows:
        bad("multiset evidence names no rows")
        return
    for r in rows:
        if not isinstance(r, int) or isinstance(r, bool) \
                or not 0 <= r < n:
            diags.append(Diagnostic(
                "W001", "error",
                f"multiset evidence references event {r!r}, not an "
                f"event of this {n}-event history"))
            return
    from collections import Counter

    attempts: set = set()
    acked: Counter = Counter()      # :ok enqueues per value
    delivered: Counter = Counter()  # :ok dequeues/drained per value
    last_read: set | None = None
    for op in ops:
        if not isinstance(op.process, int):
            continue
        if op.type == "invoke" and op.f in ("enqueue", "add"):
            attempts.add(op.value)
        elif op.type == "ok" and op.f == "enqueue":
            acked[op.value] += 1
        elif op.type == "ok" and op.f == "dequeue":
            delivered[op.value] += 1
        elif op.type == "ok" and op.f == "drain" \
                and isinstance(op.value, (list, tuple)):
            delivered.update(op.value)
        elif op.type == "ok" and op.f == "read":
            last_read = set(op.value or ())
    if kind == "unexpected-dequeue":
        for r in rows:
            op = ops[r]
            if op.type != "ok" or op.f not in ("dequeue", "drain"):
                bad(f"event {r} is not an :ok dequeue/drain", index=r)
                continue
            got = op.value if op.f == "dequeue" \
                else list(op.value or ())
            vals = got if isinstance(got, list) else [got]
            if all(v in attempts for v in vals):
                bad(f"event {r}'s value(s) were all attempted by some "
                    f"enqueue — not unexpected", index=r)
    elif kind == "lost-acked-enqueue":
        for r in rows:
            op = ops[r]
            if op.type != "ok" or op.f != "enqueue":
                bad(f"event {r} is not an :ok enqueue", index=r)
            elif delivered[op.value] >= acked[op.value]:
                # multiset semantics, as the checker counts: a value
                # is lost only while its acked copies outnumber its
                # delivered ones (a duplicate payload with one copy
                # delivered and one lost IS lost)
                bad(f"event {r}'s value {op.value!r} was delivered as "
                    f"often as it was acked — not lost", index=r)
    elif kind == "unexpected-member":
        if last_read is None:
            bad("unexpected-member evidence on a history with no :ok "
                "read")
            return
        if not (last_read - attempts):
            bad("every member of the final read was attempted by some "
                "add — not unexpected")
    elif kind == "lost-acked-add":
        if last_read is None:
            bad("lost-acked-add evidence on a history with no :ok read")
            return
        for r in rows:
            op = ops[r]
            if op.type != "ok" or op.f != "add":
                bad(f"event {r} is not an :ok add", index=r)
            elif op.value in last_read:
                bad(f"event {r}'s value {op.value!r} appears in the "
                    f"final read — not lost", index=r)
    else:
        bad(f"unknown multiset evidence kind {kind!r}")


def audit_events(history, result: dict) -> dict:
    """Audit one MODEL-LESS (event-level, multiset-semantics) result —
    the streamed total-queue/set fold's certificate contract.  Same
    return shape as :func:`audit`.  Lenient where the multiset
    checkers themselves carry no certificate: an invalid verdict with
    no ``queue_evidence`` is reported as unchecked, not failed."""
    ops = list(history or ())
    diags: list[Diagnostic] = []
    out: dict = {"ok": True, "checked": "undecided", "codes": [],
                 "diagnostics": diags, "witness_ops": None}
    if result.get("valid") is False:
        if result.get("queue_evidence") is not None:
            out["checked"] = "queue_evidence"
            _audit_multiset_evidence(ops, result, diags)
        else:
            out["checked"] = "no_certificate"
    elif result.get("valid") is True:
        out["checked"] = "multiset"
    out["codes"] = sorted({d.code for d in diags})
    out["ok"] = not diags
    return out


def audit(history, model, result: dict) -> dict:
    """Audit one engine result's certificate.  Returns::

        {"ok": bool, "checked": what-was-audited, "codes": [...],
         "diagnostics": [Diagnostic...], "witness_ops": n | None}

    ``checked`` is ``"linearization"`` (full replay ran),
    ``"witness_dropped"`` / ``"frontier_dropped"`` (explicit drop reason
    accepted, nothing to replay), ``"final_ops"`` (frontier rows
    range-checked), or ``"undecided"``.  Never raises on a bad
    certificate — :func:`maybe_audit` applies the raising policy.
    """
    if model is None:
        # model-less (multiset-semantics) result: the event-level
        # audit owns it — there is no OpSeq encoding to replay
        return audit_events(history, result)
    seq = _as_seq(history, model)
    diags: list[Diagnostic] = []
    v = result.get("valid")
    out: dict = {"ok": True, "checked": "undecided", "codes": [],
                 "diagnostics": diags, "witness_ops": None}

    if v is True:
        lin = result.get("linearization")
        if lin is None:
            out["checked"] = "witness_dropped"
            reason = result.get("witness_dropped")
            if reason is None:
                diags.append(Diagnostic(
                    "W002", "error",
                    "valid verdict carries neither `linearization` nor "
                    "a `witness_dropped` reason — the certificate "
                    "contract requires one of the two"))
            else:
                out["witness_dropped"] = reason
        else:
            out["checked"] = "linearization"
            out["witness_ops"] = len(lin)
            _audit_witness(seq, model, result, diags)
    elif v is False:
        frontier = result.get("final_ops")
        if result.get("hb_cycle") is not None:
            out["checked"] = "hb_cycle"
            _audit_hb_cycle(seq, model, result, diags)
        elif result.get("queue_cycle") is not None \
                or result.get("queue_dup") is not None:
            out["checked"] = "queue_order"
            _audit_queue_order(seq, model, result, diags)
        elif result.get("queue_evidence") is not None:
            out["checked"] = "queue_evidence"
            _audit_queue_evidence_seq(seq, model, result, diags)
        elif frontier is None:
            out["checked"] = "frontier_dropped"
            reason = result.get("frontier_dropped")
            if reason is None:
                diags.append(Diagnostic(
                    "W002", "error",
                    "invalid verdict carries neither `final_ops`, an "
                    "`hb_cycle`, nor a `frontier_dropped` reason — the "
                    "certificate contract requires one of the three"))
            else:
                out["frontier_dropped"] = reason
        else:
            out["checked"] = "final_ops"
            n = len(seq)
            for r in frontier:
                if not isinstance(r, int) or isinstance(r, bool) \
                        or not 0 <= r < n:
                    diags.append(Diagnostic(
                        "W001", "error",
                        f"blocking frontier references row {r!r}, not a "
                        f"row of this {n}-op history"))

    out["codes"] = sorted({d.code for d in diags})
    out["ok"] = not diags
    return out


def _summary(a: dict) -> dict:
    """The JSON-serializable form attached to result dicts."""
    out = {"ok": a["ok"], "checked": a["checked"], "codes": a["codes"]}
    if a.get("witness_ops") is not None:
        out["witness_ops"] = a["witness_ops"]
    if not a["ok"]:
        out["diagnostics"] = [d.to_dict() for d in a["diagnostics"]]
    return out


def maybe_audit_events(history, result: dict,
                       audit_flag: bool | None = None) -> dict:
    """The event-level twin of :func:`maybe_audit` (the streamed
    multiset fold's postamble): with ``audit_flag`` True, audit, attach
    the summary and raise :class:`AuditError` on any W-code."""
    if not audit_flag:
        return result
    a = audit_events(history, result)
    result["audit"] = _summary(a)
    if not a["ok"]:
        raise AuditError(a)
    return result


def maybe_audit(seq, model, result: dict,
                audit_flag: bool | None = None) -> dict:
    """The engines' audit postamble: with ``audit_flag`` True, audit the
    result, attach the summary as ``result["audit"]`` and raise
    :class:`AuditError` on any W-code; None and False do nothing."""
    if not audit_flag:
        return result
    a = audit(seq, model, result)
    result["audit"] = _summary(a)
    if not a["ok"]:
        raise AuditError(a)
    return result
