"""Well-formedness lint: one O(n) scan, structured diagnostics.

``history.pair_index``/``complete`` tolerate malformed input quietly: a
double invoke overwrites the open op, an orphan completion is dropped,
an unknown completion type falls through as if it were a completion.
Each of those can reach the search and give a wrong verdict.  This
module is the cheap host-side guard in front of every entry point.

==== ======== ==========================================================
code severity meaning
==== ======== ==========================================================
H001 error    double invoke: a process invoked with an op still open
H002 error    orphan completion: a completion with no open invoke
H003 error    event type not in {invoke, ok, fail, info}
H004 warning* non-monotone ``op.index`` values (event level); at the
              OpSeq level (``inv``/``ret`` rank defects) it is an error
H005 error    value not encodable by ValueEncoder (unhashable)
H006 warning  an ok completion's value conflicts with the invocation's
H007 error    OpSeq column shape mismatch
M001 error    op ``f`` unknown to the model's f_codes
Q001 error    ack of a job no :ok dequeue/claim ever delivered
Q002 error    double ack: the same job acked :ok twice
Q003 warning  :ok dequeue (or drained element) of a value no enqueue
              ever attempted
==== ======== ==========================================================

(*) the engines index events by position, so a stale ``op.index``
cannot change a verdict; it only misleads a reader of the report.

Q003 is the violation the multiset checkers judge, so the lint warns
and leaves the verdict to them; Q001/Q002 describe claim/ack streams no
checker reads, so a malformed one is an error.

On a well-formed history every check passes and the engines run as
without the lint; an error raises :class:`HistoryLintError` instead of
an undefined search result.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from ..history import FAIL, INF_RET, INFO, INVOKE, OK, OpSeq, is_client_op

#: the four legal event types
EVENT_TYPES = (INVOKE, OK, FAIL, INFO)

ERROR_CODES = {
    "H001": "double-invoke on a process with an open op",
    "H002": "orphan completion (no open invoke on the process)",
    "H003": "event type not in {invoke, ok, fail, info}",
    "H004": "non-monotone indices",
    "H005": "value not encodable by ValueEncoder",
    "H006": "ok completion value conflicts with the invocation value",
    "H007": "OpSeq column shape mismatch",
    "M001": "op f unknown to the model",
    "Q001": "ack of a job no :ok dequeue/claim ever delivered",
    "Q002": "double-ack: the same job acked :ok twice",
    "Q003": ":ok dequeue of a value no enqueue ever attempted",
}

#: the queue-history codes, runnable on their own through
#: ``scan_events(history, codes=QUEUE_CODES)``
QUEUE_CODES = ("Q001", "Q002", "Q003")


@dataclass(frozen=True)
class Diagnostic:
    """One finding.  ``index`` is the event index (or OpSeq row),
    ``process``/``f`` the op's coordinates when known."""

    code: str
    severity: str  # "error" | "warning"
    message: str
    index: int | None = None
    process: Any = None
    f: Any = None

    def to_dict(self) -> dict:
        d = {"code": self.code, "severity": self.severity,
             "message": self.message}
        if self.index is not None:
            d["index"] = self.index
        if self.process is not None:
            d["process"] = self.process
        if self.f is not None:
            d["f"] = self.f
        return d

    def __str__(self) -> str:
        where = f" @{self.index}" if self.index is not None else ""
        return f"{self.code}{where}: {self.message}"


class HistoryLintError(ValueError):
    """A history failed the lint.  ``diagnostics`` carries every
    finding, not just the first."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = list(diagnostics)
        errs = [d for d in self.diagnostics if d.severity == "error"]
        head = "; ".join(str(d) for d in errs[:5])
        more = f" (+{len(errs) - 5} more)" if len(errs) > 5 else ""
        super().__init__(f"malformed history: {head}{more}")


@dataclass
class HistoryScan:
    """What one O(n) pass over an event history learns: the
    diagnostics and the history's shape."""

    diagnostics: list[Diagnostic] = field(default_factory=list)
    n_events: int = 0
    n_invoke: int = 0
    n_ok: int = 0
    n_fail: int = 0
    n_info: int = 0
    #: client invokes whose fate is indeterminate (:info completion or
    #: none at all)
    n_crashed: int = 0
    #: peak simultaneously open client ops (crashed ops stay open)
    concurrency: int = 0
    processes: list = field(default_factory=list)
    has_nemesis: bool = False
    #: event index -> partner event index (the map pair_index builds)
    pairs: dict = field(default_factory=dict)

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]


def _value_drift(inv_v, comp_v) -> bool:
    """Does an ok completion's value conflict with the invocation's?  A
    nil lane of the invocation is a wildcard the completion fills in."""
    if inv_v is None or comp_v is None:
        return False
    a, b = _lanes_view(inv_v), _lanes_view(comp_v)
    if a is not None and b is not None and len(a) == len(b):
        return any(x is not None and y is not None and x != y
                   for x, y in zip(a, b))
    return inv_v != comp_v


def _lanes_view(v):
    """A value's nil-capable lanes, when it has that shape: a 2-seq, a
    ``[key value]`` pair object, or the ``"[k v]"`` string a stored
    history round-trips one to."""
    if isinstance(v, (tuple, list)):
        return list(v)
    if hasattr(v, "key") and hasattr(v, "value"):
        return [v.key, v.value]
    if isinstance(v, str) and len(v) > 2 and v[0] == "[" and v[-1] == "]":
        parts = v[1:-1].split(" ")
        if len(parts) == 2:
            return [None if p in ("None", "nil") else p for p in parts]
    return None


def _encodable(value) -> bool:
    """As ``encode_ops`` lanes it: a 2-tuple/list per lane, anything
    else whole; both need hashable parts."""
    if isinstance(value, (tuple, list)) and len(value) == 2:
        parts = value
    else:
        parts = (value,)
    return all(_hashable(p) for p in parts)


def _hashable(v) -> bool:
    try:
        hash(v)
    except TypeError:
        return False
    return True


def _q_scan(op, i: int, t: str, want: set, diags: list,
            attempts: set, claimed: set, acked: set,
            flagged: set) -> None:
    """The Q-code checks for one client event: ``enqueue`` invokes
    register attempts; :ok ``dequeue``/``claim`` completions (and :ok
    ``drain`` elements) register deliveries and trip Q003 on values no
    enqueue attempted; ``ack`` trips Q001 at its invoke and Q002 at its
    :ok completion.  Unhashable values are H005's."""
    f, v = op.f, op.value
    if f == "enqueue":
        if t == INVOKE and _hashable(v):
            attempts.add(v)
        return
    if f in ("dequeue", "claim"):
        if t == OK and _hashable(v):
            claimed.add(v)
            if "Q003" in want and f == "dequeue" \
                    and v is not None and v not in attempts \
                    and v not in flagged:
                flagged.add(v)
                diags.append(Diagnostic(
                    "Q003", "warning",
                    f":ok dequeue of {v!r} at event {i}, a value no "
                    f"enqueue ever attempted (the multiset checker "
                    f"will judge it unexpected)",
                    index=i, process=op.process, f=f))
        return
    if f == "drain" and t == OK and isinstance(v, (list, tuple)):
        for element in v:
            if _hashable(element):
                claimed.add(element)
                if "Q003" in want and element not in attempts \
                        and element not in flagged:
                    flagged.add(element)
                    diags.append(Diagnostic(
                        "Q003", "warning",
                        f":ok drain at event {i} delivered "
                        f"{element!r}, a value no enqueue ever "
                        f"attempted", index=i, process=op.process,
                        f=f))
        return
    if f == "ack" and _hashable(v):
        if t == INVOKE and "Q001" in want and v not in claimed:
            diags.append(Diagnostic(
                "Q001", "error",
                f"ack of {v!r} at event {i} but no :ok dequeue/claim "
                f"ever delivered it (ack-without-claim: the recorded "
                f"protocol stream is inconsistent)",
                index=i, process=op.process, f=f))
        elif t == OK and "Q002" in want:
            if v in acked:
                diags.append(Diagnostic(
                    "Q002", "error",
                    f"double-ack of {v!r} at event {i} (already acked "
                    f":ok earlier)", index=i, process=op.process, f=f))
            acked.add(v)


def scan_events(history: Sequence, model=None, *,
                codes: Sequence[str] | None = None) -> HistoryScan:
    """The O(n) event-level pass.  ``model`` turns on the model-facing
    checks (M001, and H005 on the rows that will be encoded); ``codes``
    restricts the checks that run (None: all)."""
    want = set(codes) if codes is not None else set(ERROR_CODES)
    sc = HistoryScan()
    open_by_process: dict[Any, int] = {}
    f_codes = getattr(model, "f_codes", None)
    check_f = bool(f_codes) and "M001" in want  # empty/noop table: skip
    last_index: int | None = None
    indices_flagged = False
    diags = sc.diagnostics
    q_want = bool(want & {"Q001", "Q002", "Q003"})
    q_attempts: set = set()   # enqueue-invoke values
    q_claimed: set = set()    # values an :ok dequeue/claim delivered
    q_acked: set = set()      # values :ok acked
    q_flagged: set = set()    # one Q003 per value

    for i, op in enumerate(history):
        sc.n_events += 1
        t = op.type
        if t == INVOKE:
            sc.n_invoke += 1
        elif t == OK:
            sc.n_ok += 1
        elif t == FAIL:
            sc.n_fail += 1
        elif t == INFO:
            sc.n_info += 1
        elif "H003" in want:
            diags.append(Diagnostic(
                "H003", "error",
                f"event type {t!r} not in {{invoke, ok, fail, info}}",
                index=i, process=op.process, f=op.f))
            continue  # neither an invoke nor a completion

        if op.process not in open_by_process and \
                op.process not in sc.processes:
            sc.processes.append(op.process)
        client = is_client_op(op)
        if not client:
            sc.has_nemesis = sc.has_nemesis or op.process == "nemesis"

        if op.index is not None and "H004" in want:
            if last_index is not None and op.index <= last_index \
                    and not indices_flagged:
                diags.append(Diagnostic(
                    "H004", "warning",
                    f"op.index {op.index} at event {i} not greater than "
                    f"previous index {last_index} (engines re-index "
                    f"positionally; reports may mislabel ops)",
                    index=i, process=op.process, f=op.f))
                indices_flagged = True  # once per history
            last_index = op.index

        if not client:
            # the nemesis journals :info events freely: the pairing and
            # model rules apply to client processes only
            continue

        if q_want:
            _q_scan(op, i, t, want, diags, q_attempts, q_claimed,
                    q_acked, q_flagged)

        if t == INVOKE:
            prev = open_by_process.get(op.process)
            if prev is not None and "H001" in want:
                diags.append(Diagnostic(
                    "H001", "error",
                    f"process {op.process!r} invoked {op.f!r} at event "
                    f"{i} while its invoke at event {prev} is still "
                    f"open (single-threaded-process invariant, "
                    f"core.clj:387-404)",
                    index=i, process=op.process, f=op.f))
            open_by_process[op.process] = i
        elif t in (OK, FAIL, INFO):
            j = open_by_process.pop(op.process, None)
            if j is None:
                if "H002" in want:
                    diags.append(Diagnostic(
                        "H002", "error",
                        f"{t} completion for process {op.process!r} at "
                        f"event {i} has no open invoke "
                        f"(pair_index would silently drop it)",
                        index=i, process=op.process, f=op.f))
            else:
                sc.pairs[j] = i
                sc.pairs[i] = j
                inv_op = history[j]
                if inv_op.f != op.f and "H006" in want:
                    diags.append(Diagnostic(
                        "H006", "warning",
                        f"completion f={op.f!r} at event {i} differs "
                        f"from invocation f={inv_op.f!r} at event {j}",
                        index=i, process=op.process, f=op.f))
                elif (t == OK and "H006" in want
                        and _value_drift(inv_op.value, op.value)):
                    diags.append(Diagnostic(
                        "H006", "warning",
                        f"ok completion at event {i} carries value "
                        f"{op.value!r} but the invocation at event {j} "
                        f"had {inv_op.value!r} (complete() will "
                        f"overwrite the invocation's value)",
                        index=i, process=op.process, f=op.f))
                if t != FAIL:
                    # this row survives encode_ops: model-facing checks
                    val = op.value if (t == OK and op.value is not None) \
                        else inv_op.value
                    if "H005" in want and not _encodable(val):
                        diags.append(Diagnostic(
                            "H005", "error",
                            f"value {val!r} for {inv_op.f!r} at event "
                            f"{j} is not encodable by ValueEncoder "
                            f"(unhashable)",
                            index=j, process=op.process, f=inv_op.f))
                    if check_f and inv_op.f not in f_codes:
                        diags.append(Diagnostic(
                            "M001", "error",
                            f"op f={inv_op.f!r} at event {j} unknown to "
                            f"model {model.name!r} "
                            f"(f_codes: {sorted(map(str, f_codes))})",
                            index=j, process=op.process, f=inv_op.f))
            if t == INFO:
                sc.n_crashed += 1

    # crashed invokes with no completion at all
    for p, j in open_by_process.items():
        sc.n_crashed += 1
        inv_op = history[j]
        if "H005" in want and not _encodable(inv_op.value):
            diags.append(Diagnostic(
                "H005", "error",
                f"value {inv_op.value!r} for {inv_op.f!r} at event {j} "
                f"is not encodable by ValueEncoder (unhashable)",
                index=j, process=p, f=inv_op.f))
        if check_f and inv_op.f not in f_codes:
            diags.append(Diagnostic(
                "M001", "error",
                f"op f={inv_op.f!r} at event {j} unknown to model "
                f"{model.name!r} (f_codes: {sorted(map(str, f_codes))})",
                index=j, process=p, f=inv_op.f))

    # client concurrency: +1 per invoke, -1 per paired ok/fail; info
    # completions and invokes never completed stay open
    cur = peak = 0
    for i, op in enumerate(history):
        if not is_client_op(op):
            continue
        if op.type == INVOKE:
            cur += 1
            peak = max(peak, cur)
        elif op.type in (OK, FAIL) and sc.pairs.get(i) is not None:
            cur -= 1
    sc.concurrency = peak
    return sc


def lint_history(history: Sequence, model=None) -> list[Diagnostic]:
    """Event-level lint: every diagnostic, raising nothing."""
    return scan_events(history, model).diagnostics


def check_history(history: Sequence, model=None) -> list[Diagnostic]:
    """Event-level lint that raises on errors and returns the
    warnings: the checkers' policy (a malformed history never reaches
    the search; warnings ride the result)."""
    diags = lint_history(history, model)
    if any(d.severity == "error" for d in diags):
        raise HistoryLintError(diags)
    return diags


def lint_opseq(seq: OpSeq, model=None) -> list[Diagnostic]:
    """Columnar lint of an encoded OpSeq: the invariants the engines and
    the device encoding rely on (``inv`` strictly increasing, ``ret``
    after ``inv``, ok rows completed, f codes known).  ``encode_ops``
    output passes by construction; hand-built OpSeqs may not."""
    diags: list[Diagnostic] = []
    n = len(seq)
    cols = {"process": seq.process, "f": seq.f, "v1": seq.v1,
            "v2": seq.v2, "inv": seq.inv, "ret": seq.ret, "ok": seq.ok}
    bad_shape = [name for name, c in cols.items() if len(c) != n]
    if bad_shape:
        diags.append(Diagnostic(
            "H007", "error",
            f"OpSeq columns {bad_shape} disagree with len(process)={n}"))
        return diags  # nothing below is safe to vectorize
    if n == 0:
        return diags

    inv = np.asarray(seq.inv, dtype=np.int64)
    ret = np.asarray(seq.ret, dtype=np.int64)
    ok = np.asarray(seq.ok, dtype=bool)

    nonmono = np.nonzero(inv[1:] <= inv[:-1])[0]
    for i in nonmono[:8]:
        diags.append(Diagnostic(
            "H004", "error",
            f"inv not strictly increasing at row {int(i) + 1} "
            f"(inv[{int(i)}]={int(inv[i])}, "
            f"inv[{int(i) + 1}]={int(inv[i + 1])}); rows must be "
            f"sorted by invocation", index=int(i) + 1))
    completed = ret != INF_RET
    bad_ret = np.nonzero(completed & (ret <= inv))[0]
    for i in bad_ret[:8]:
        diags.append(Diagnostic(
            "H004", "error",
            f"row {int(i)} returns at rank {int(ret[i])} <= its "
            f"invocation rank {int(inv[i])}", index=int(i)))
    never_ret = np.nonzero(ok & ~completed)[0]
    for i in never_ret[:8]:
        diags.append(Diagnostic(
            "H002", "error",
            f"row {int(i)} is :ok but has ret=INF_RET (an ok op must "
            f"have completed)", index=int(i)))

    f_codes = getattr(model, "f_codes", None)
    if f_codes:
        known = np.array(sorted(set(int(c) for c in f_codes.values())),
                         dtype=np.int64)
        f = np.asarray(seq.f, dtype=np.int64)
        unknown = np.nonzero(~np.isin(f, known))[0]
        for i in unknown[:8]:
            diags.append(Diagnostic(
                "M001", "error",
                f"row {int(i)} f code {int(f[i])} unknown to model "
                f"{model.name!r} (codes: {known.tolist()})",
                index=int(i), f=int(f[i])))
    return diags


def check_opseq_lint(seq: OpSeq, model=None) -> list[Diagnostic]:
    """OpSeq lint that raises on errors and returns the warnings."""
    diags = lint_opseq(seq, model)
    if any(d.severity == "error" for d in diags):
        raise HistoryLintError(diags)
    return diags


def maybe_lint(seq: OpSeq, model=None,
               lint: bool | None = None) -> list[Diagnostic]:
    """The engines' lint preamble: ``lint`` None or True runs
    :func:`check_opseq_lint`, False skips it."""
    if lint is None or lint:
        return check_opseq_lint(seq, model)
    return []
