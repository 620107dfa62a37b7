"""O(n) checkers over event-level histories: the multiset ones the
streamed total-queue route (``stream/checker.py::TotalFoldStream``)
recomputes its final verdict with.

Ported from the JAX package's ``checker/basic.py`` (jepsen's
``checker.clj``: ``set`` 163, ``expand-queue-drain-ops`` 213,
``total-queue`` 246): :class:`SetChecker`, :func:`expand_queue_drain_ops`
and :class:`TotalQueueChecker`, with the Q-code queue lint they run
first.  The rest of that module (the queue and unique-ids checkers, the
counter, bank and G2 checkers and their kin) is queue item A14(a) of
``ROADMAP.md``.

Each checker consumes a list of ``history.Op`` and returns a dict with
at least ``{"valid": True | False | "unknown"}``.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import replace
from typing import Iterable

from ..history import is_invoke, is_ok
from .core import Checker


def fraction(a: int, b: int):
    """a/b, or 1 when b is zero."""
    return a / b if b else 1


def integer_interval_set_str(xs: Iterable[int]) -> str:
    """A set of integers as a compact string: ``'#{1-5 7 9-11}'``."""
    xs = sorted(set(xs))
    if not xs:
        return "#{}"
    parts = []
    lo = prev = xs[0]
    for x in xs[1:]:
        if x == prev + 1:
            prev = x
            continue
        parts.append(str(lo) if lo == prev else f"{lo}-{prev}")
        lo = prev = x
    parts.append(str(lo) if lo == prev else f"{lo}-{prev}")
    return "#{" + " ".join(parts) + "}"


def queue_lint(history) -> list[dict]:
    """The Q-code history lint the multiset queue checkers run first:
    Q001/Q002 (a malformed claim or ack stream) raise
    :class:`~..analyze.lint.HistoryLintError`; Q003 rides the result as
    ``lint_warnings``."""
    from ..analyze.lint import QUEUE_CODES, HistoryLintError, scan_events

    diags = scan_events(history, codes=QUEUE_CODES).diagnostics
    if any(d.severity == "error" for d in diags):
        raise HistoryLintError(diags)
    return [d.to_dict() for d in diags]


# ---------------------------------------------------------------------------
# set: adds followed by a final read
# ---------------------------------------------------------------------------


class SetChecker(Checker):
    def check(self, test, history, opts=None):
        attempts = {op.value for op in history
                    if is_invoke(op) and op.f == "add"}
        adds = {op.value for op in history if is_ok(op) and op.f == "add"}
        final_read = None
        for op in history:
            if is_ok(op) and op.f == "read":
                final_read = op.value
        if final_read is None:
            return {"valid": "unknown", "error": "Set was never read"}
        final_read = set(final_read)

        ok = final_read & attempts          # read values we tried to add
        unexpected = final_read - attempts  # never attempted
        lost = adds - final_read            # definitely added, not read
        recovered = ok - adds               # indeterminate adds that showed

        return {
            "valid": not lost and not unexpected,
            "ok": integer_interval_set_str(ok),
            "lost": integer_interval_set_str(lost),
            "unexpected": integer_interval_set_str(unexpected),
            "recovered": integer_interval_set_str(recovered),
            "ok_frac": fraction(len(ok), len(attempts)),
            "unexpected_frac": fraction(len(unexpected), len(attempts)),
            "lost_frac": fraction(len(lost), len(attempts)),
            "recovered_frac": fraction(len(recovered), len(attempts)),
        }


def set_checker() -> Checker:
    return SetChecker()


# ---------------------------------------------------------------------------
# total-queue: what goes in must come out
# ---------------------------------------------------------------------------


def expand_queue_drain_ops(history) -> list:
    """Each ok :drain op (value: the list of elements) as dequeue
    invoke/ok pairs; a crashed drain raises (its elements are
    unknown)."""
    out = []
    for op in history:
        if op.f != "drain":
            out.append(op)
        elif is_invoke(op) or op.type == "fail":
            continue
        elif is_ok(op):
            for element in op.value or []:
                out.append(replace(op, type="invoke", f="dequeue",
                                   value=None))
                out.append(replace(op, type="ok", f="dequeue",
                                   value=element))
        else:
            raise ValueError(
                f"not sure how to handle a crashed drain operation: {op}")
    return out


class TotalQueueChecker(Checker):
    def check(self, test, history, opts=None):
        warnings = queue_lint(history)
        history = expand_queue_drain_ops(history)
        attempts = Counter(op.value for op in history
                           if is_invoke(op) and op.f == "enqueue")
        enqueues = Counter(op.value for op in history
                           if is_ok(op) and op.f == "enqueue")
        dequeues = Counter(op.value for op in history
                           if is_ok(op) and op.f == "dequeue")

        ok = dequeues & attempts  # multiset intersection
        unexpected = Counter({v: n for v, n in dequeues.items()
                              if v not in attempts})
        duplicated = dequeues - attempts - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues

        def total(ms):
            return sum(ms.values())

        n_att = total(attempts)
        out = {
            "valid": not lost and not unexpected,
            "lost": dict(lost),
            "unexpected": dict(unexpected),
            "duplicated": dict(duplicated),
            "recovered": dict(recovered),
            "ok_frac": fraction(total(ok), n_att),
            "unexpected_frac": fraction(total(unexpected), n_att),
            "duplicated_frac": fraction(total(duplicated), n_att),
            "lost_frac": fraction(total(lost), n_att),
            "recovered_frac": fraction(total(recovered), n_att),
        }
        if warnings:
            out["lint_warnings"] = warnings
        return out


def total_queue() -> Checker:
    return TotalQueueChecker()
