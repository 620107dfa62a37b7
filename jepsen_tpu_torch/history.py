"""Operation and history substrate: the checker's input format.

An operation is a plain record ``{process, type, f, value}`` where
``type`` is ``invoke``, ``ok``, ``fail`` or ``info``:

  * ``ok``   — the operation definitely happened
  * ``fail`` — the operation definitely did NOT happen
  * ``info`` — indeterminate; it may take effect at any time after its
               invocation, forever (a crashed op never returns)

:func:`encode_ops` merges invoke/completion pairs into the columnar
:class:`OpSeq` the search consumes: one row per logical operation, sorted
by invocation, with int32 value lanes (``None`` maps to :data:`NIL`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Iterable, Sequence

import numpy as np

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

#: int32 lane value for "no value / unknown"
NIL = -(2**31)

#: completion rank of ops that never complete (crashed / :info)
INF_RET = 2**31 - 1


@dataclass
class Op:
    """One history event."""

    process: Any  # int client process, or "nemesis"
    type: str  # invoke | ok | fail | info
    f: Any  # operation function, e.g. "read", "write", "cas"
    value: Any = None
    time: int | None = None
    index: int | None = None
    error: Any = None

    def to_dict(self) -> dict:
        d = {"process": self.process, "type": self.type, "f": self.f,
             "value": self.value}
        if self.time is not None:
            d["time"] = self.time
        if self.index is not None:
            d["index"] = self.index
        if self.error is not None:
            d["error"] = self.error
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Op":
        return cls(process=d.get("process"), type=d.get("type"),
                   f=d.get("f"), value=d.get("value"), time=d.get("time"),
                   index=d.get("index"), error=d.get("error"))


def invoke_op(process, f, value=None, **kw) -> Op:
    return Op(process=process, type=INVOKE, f=f, value=value, **kw)


def ok_op(process, f, value=None, **kw) -> Op:
    return Op(process=process, type=OK, f=f, value=value, **kw)


def fail_op(process, f, value=None, **kw) -> Op:
    return Op(process=process, type=FAIL, f=f, value=value, **kw)


def info_op(process, f, value=None, **kw) -> Op:
    return Op(process=process, type=INFO, f=f, value=value, **kw)


def is_invoke(op: Op) -> bool:
    return op.type == INVOKE


def is_ok(op: Op) -> bool:
    return op.type == OK


def is_fail(op: Op) -> bool:
    return op.type == FAIL


def is_info(op: Op) -> bool:
    return op.type == INFO


def is_client_op(op: Op) -> bool:
    """Client processes are integers; the nemesis is not."""
    return isinstance(op.process, int)


def index(history: Iterable[Op]) -> list[Op]:
    """Every event with its sequential ``index`` (knossos.history/index);
    new ops, the history is not mutated."""
    return [replace(op, index=i) for i, op in enumerate(history)]


def _strict_pairing(history: Sequence[Op]) -> None:
    """Raise :class:`~.analyze.lint.HistoryLintError` when pairing would
    have to tolerate a malformed event (H001 double invoke, H002 orphan
    completion, H003 unknown type): the ``strict`` mode of
    :func:`pair_index` and :func:`complete`."""
    from .analyze.lint import HistoryLintError, scan_events

    sc = scan_events(history, codes=("H001", "H002", "H003"))
    if sc.errors:
        raise HistoryLintError(sc.diagnostics)


def pair_index(history: Sequence[Op], *,
               strict: bool = False) -> dict[int, int]:
    """Map each event's index to its partner's (invoke <-> completion).

    A process has at most one outstanding op, so pairing is a
    per-process scan; by default a double invoke overwrites the open one
    and an orphan completion is dropped, as knossos does.  Crashed
    invokes are absent.  ``strict=True`` raises instead
    (:func:`_strict_pairing`)."""
    if strict:
        _strict_pairing(history)
    pairs: dict[int, int] = {}
    open_by_process: dict[Any, int] = {}
    for i, op in enumerate(history):
        if op.type == INVOKE:
            open_by_process[op.process] = i
        else:
            j = open_by_process.pop(op.process, None)
            if j is not None:
                pairs[j] = i
                pairs[i] = j
    return pairs


def complete(history: Sequence[Op], *, strict: bool = False) -> list[Op]:
    """Copy each ok completion's value back onto its invocation (an ok'd
    read is invoked with value None).  ``strict=True`` raises on
    malformed pairing, as :func:`pair_index` does."""
    if strict:
        _strict_pairing(history)
    out = list(history)
    open_by_process: dict[Any, int] = {}
    for i, op in enumerate(out):
        if op.type == INVOKE:
            open_by_process[op.process] = i
        else:
            j = open_by_process.pop(op.process, None)
            if j is not None and op.type == OK and op.value is not None:
                out[j] = replace(out[j], value=op.value)
    return out


def processes(history: Iterable[Op]) -> list:
    """The distinct processes of a history, in first-seen order
    (knossos.history/processes)."""
    seen: dict = {}
    for op in history:
        seen.setdefault(op.process, None)
    return list(seen)


class ValueEncoder:
    """Interns hashable values as dense int32 ids.  Integers that fit
    the identity band encode as themselves; others get ids from 2**30
    up; ``None`` is :data:`NIL`."""

    def __init__(self):
        self._fwd: dict = {}
        self._next = 0

    def encode(self, v) -> int:
        if v is None:
            return NIL
        if isinstance(v, int) and -(2**30) < v < 2**30:
            return v
        if v in self._fwd:
            return self._fwd[v]
        vid = 2**30 + self._next
        self._next += 1
        self._fwd[v] = vid
        return vid


@dataclass
class OpSeq:
    """Columnar, merged operation sequence (ok and info ops; fail ops
    are dropped).  Rows are sorted by invocation, so real-time
    precedence "i returned before j invoked" is ``ret[i] < inv[j]``.

    Columns: ``process``/``f``/``v1``/``v2`` int32, ``inv``/``ret``
    int64 event ranks (``ret`` is :data:`INF_RET` for crashed ops),
    ``ok`` bool (True: must linearize)."""

    process: np.ndarray
    f: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    inv: np.ndarray
    ret: np.ndarray
    ok: np.ndarray
    ops: list = field(default_factory=list)
    encoder: ValueEncoder | None = None

    def __len__(self) -> int:
        return len(self.process)

    @property
    def n_must(self) -> int:
        """Rows that must linearize (the ok ops)."""
        return int(self.ok.sum())


def encode_ops(history: Sequence[Op], f_codes: dict, *,
               encoder: ValueEncoder | None = None) -> OpSeq:
    """Build the columnar :class:`OpSeq` from an event history.

    ``f_codes`` maps f names to the model's integer codes.  A two-element
    tuple/list value (cas) fills both lanes; anything else fills ``v1``
    with ``v2 = NIL``."""
    enc = encoder or ValueEncoder()

    def lanes(value):
        if isinstance(value, (tuple, list)) and len(value) == 2:
            return enc.encode(value[0]), enc.encode(value[1])
        return enc.encode(value), NIL

    completed = complete(history)
    pairs = pair_index(completed)
    rows = []
    for i, op in enumerate(completed):
        if op.type != INVOKE or not is_client_op(op):
            continue
        j = pairs.get(i)
        ctype = INFO if j is None else completed[j].type
        if ctype == FAIL:
            continue
        ret = INF_RET if ctype == INFO else j
        if op.f not in f_codes:
            raise KeyError(f"op f={op.f!r} not in model f_codes "
                           f"{list(f_codes)}")
        v1, v2 = lanes(op.value)
        rows.append((i, ret, op.process, f_codes[op.f], v1, v2,
                     ctype == OK, op))
    rows.sort(key=lambda r: r[0])
    n = len(rows)

    def col(k, dtype):
        return np.array([r[k] for r in rows], dtype=dtype).reshape(n)

    return OpSeq(process=col(2, np.int32), f=col(3, np.int32),
                 v1=col(4, np.int32), v2=col(5, np.int32),
                 inv=col(0, np.int64), ret=col(1, np.int64),
                 ok=col(6, bool), ops=[r[7] for r in rows], encoder=enc)


def max_concurrency(seq: OpSeq) -> int:
    """The most ops open at once (invoked, not returned).  A crashed op
    never returns, so it counts against every later instant."""
    events = []
    for i in range(len(seq)):
        events.append((int(seq.inv[i]), 1))
        if int(seq.ret[i]) != INF_RET:
            events.append((int(seq.ret[i]), -1))
    events.sort()
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    return peak
