"""O(n) checkers over event-level histories (jepsen's ``checker.clj``:
``queue`` 141, ``set`` 163, ``expand-queue-drain-ops`` 213,
``total-queue`` 246, ``unique-ids`` 305, ``counter`` 353; ``bank.clj``'s
checker at 41; ``adya.clj``'s g2-checker at 57): linear scans on the
host, the device being for the exponential search
(``checker/linearizable.py``).  :class:`QueueLinearizable` is the
exception: it runs the device search over the queue models.

Each checker consumes a list of ``history.Op`` and returns a dict with
at least ``{"valid": True | False | "unknown"}``.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import replace

from ..history import Op, is_fail, is_invoke, is_ok
from ..util import integer_interval_set_str
from .core import Checker

def fraction(a: int, b: int):
    """a/b, or 1 when b is zero."""
    return a / b if b else 1


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


class Inconsistent:
    """Host-model inconsistency marker (knossos.model/inconsistent)."""

    def __init__(self, msg: str):
        self.msg = msg

    def __repr__(self):
        return f"Inconsistent({self.msg!r})"


class UnorderedQueue:
    """knossos.model/unordered-queue: enqueue always legal; dequeue legal
    iff the element is present (any order)."""

    def __init__(self, contents: Counter | None = None):
        self.contents = contents if contents is not None else Counter()

    def step(self, op: Op):
        if op.f == "enqueue":
            c = Counter(self.contents)
            c[op.value] += 1
            return UnorderedQueue(c)
        if op.f == "dequeue":
            if self.contents.get(op.value, 0) <= 0:
                return Inconsistent(
                    f"can't dequeue {op.value!r}: not in queue")
            c = Counter(self.contents)
            c[op.value] -= 1
            if c[op.value] == 0:
                del c[op.value]
            return UnorderedQueue(c)
        return Inconsistent(f"unordered-queue: unknown op f={op.f!r}")


class FIFOQueue:
    """knossos.model/fifo-queue: dequeue must return the oldest element."""

    def __init__(self, contents: tuple = ()):
        self.contents = contents

    def step(self, op: Op):
        if op.f == "enqueue":
            return FIFOQueue(self.contents + (op.value,))
        if op.f == "dequeue":
            if not self.contents:
                return Inconsistent("can't dequeue an empty queue")
            if self.contents[0] != op.value:
                return Inconsistent(
                    f"expecting {self.contents[0]!r}, got {op.value!r}")
            return FIFOQueue(self.contents[1:])
        return Inconsistent(f"fifo-queue: unknown op f={op.f!r}")


# ---------------------------------------------------------------------------
# queue — reduce a queue model over enqueue-invokes + dequeue-oks
# (checker.clj:140-160)
# ---------------------------------------------------------------------------


class QueueChecker(Checker):
    """Every dequeue must come from somewhere: assume every non-failing
    enqueue succeeded and only ok dequeues happened, then reduce the model.
    Use with an unordered queue model (checker.clj:141-147)."""

    def __init__(self, model=None):
        self.model = model

    def check(self, test, history, opts=None):
        warnings = queue_lint(history)
        model = self.model or test.get("model") or UnorderedQueue()
        out = None
        for op in history:
            take = (is_invoke(op) if op.f == "enqueue"
                    else is_ok(op) if op.f == "dequeue" else False)
            if not take:
                continue
            model = model.step(op)
            if isinstance(model, Inconsistent):
                out = {"valid": False, "error": model.msg}
                break
        if out is None:
            out = {"valid": True,
                   "final_queue": getattr(model, "contents", None)}
        if warnings:
            out["lint_warnings"] = warnings
        return out


def queue(model=None) -> Checker:
    return QueueChecker(model)


class QueueLinearizable(Checker):
    """FULL linearizability search over queue semantics — beyond the
    reference, whose queue checker can only model-reduce under the
    assumption that every non-failing enqueue happened and dequeues ran
    in completion order (checker.clj:141-147).  This checker instead
    asks whether ANY real-time-consistent linearization explains the
    history, crashed enqueue/dequeue ops included, using the device
    engine with the bounded multiset/ring models
    (models.unordered_queue/fifo_queue).

    Drains: an ok drain whose value is the drained element LIST becomes
    one dequeue per element, each spanning the drain's WHOLE interval
    on its own fresh process — the elements left at unknown moments
    within the window, so the full window is exactly each dequeue's
    real-time interval (the reference's zero-width expansion is only
    sound for its order-insensitive reduce).  Count-valued, crashed, or
    failed drains pin down no elements and contribute no constraints to
    the multiset check; under ``fifo=True`` ANY element-removing drain
    yields "unknown" (see _expand_drains for why neither identifiable
    nor unidentifiable removals can be checked soundly against a FIFO).

    The model capacity is sized from the history (#enqueues + 1 is
    always sufficient).  Linearizability search is exponential where
    the model-reduce is O(n): gate with ``max_ops`` (histories beyond
    it return "unknown" with a note instead of burning the budget) and
    keep queue keys small via ``independent``.  Wire it as an
    OPT-IN checker: past the gate it reports "unknown", which
    checker.compose's merge treats as non-True.  ``device`` is the
    search's (the package rule: "cuda" by default; the queue models run
    the card's torch step).
    """

    name = "queue-linearizable"

    def __init__(self, *, fifo: bool = False, max_ops: int = 2000,
                 budget: int = 5_000_000, device="cuda"):
        self.fifo = fifo
        self.max_ops = max_ops
        self.budget = budget
        self.device = device

    @staticmethod
    def _expand_drains(history) -> tuple[list, bool]:
        """Returns (expanded ops, lossy).  ``lossy`` marks any drain
        that removed (or may have removed) elements — it defeats a
        sound FIFO check two ways: unidentifiable removals (count
        values, crashed or dangling drains) leave a stale head for
        later dequeues to be judged against, and identifiable ones
        carry an intra-drain service ORDER that static op intervals
        cannot encode (the k dequeues are sequential within the window,
        but splitting the window would invent real-time constraints).
        The unordered multiset needs neither: leftovers never make
        another op illegal and its dequeues are order-free, so only
        the relaxed window expansion matters there.  A failed or
        empty-handed drain removed nothing and is never lossy."""
        out = []
        lossy = False
        fresh = 1 + max((op.process for op in history
                         if isinstance(op.process, int)), default=0)
        pending: dict = {}  # drain process -> invoke buffer position
        for op in history:
            if op.f != "drain":
                out.append(op)
                continue
            if is_invoke(op):
                pending[op.process] = len(out)
                continue
            at = pending.pop(op.process, len(out))
            if is_fail(op):
                continue
            if is_ok(op) and isinstance(op.value, (list, tuple)):
                lossy = lossy or len(op.value) > 0
                # k concurrent dequeues spanning [drain invoke, ok]:
                # invokes inserted at the drain's invoke position,
                # completions here, each on its own fresh process
                invs, oks = [], []
                for element in op.value:
                    invs.append(replace(op, type="invoke", f="dequeue",
                                        value=None, process=fresh))
                    oks.append(replace(op, type="ok", f="dequeue",
                                       value=element, process=fresh))
                    fresh += 1
                out[at:at] = invs
                # concurrent drains buffered earlier positions past the
                # insertion point: shift them with the inserted block
                for k2 in pending:
                    if pending[k2] >= at:
                        pending[k2] += len(invs)
                out.extend(oks)
            else:
                lossy = True  # removed elements unidentifiable
        if pending:
            # dangling drain invokes (process died, no completion ever
            # journaled) are crashed drains in the harness's encoding:
            # they may have removed elements we cannot identify
            lossy = True
        return out, lossy

    def check(self, test, history, opts=None):
        from ..models import fifo_queue, unordered_queue
        from .linearizable import Linearizable

        ops, lossy = self._expand_drains(list(history))
        if lossy and self.fifo:
            return {"valid": "unknown",
                    "info": "history contains drains that removed "
                            "elements; FIFO cannot be checked soundly "
                            "(unidentifiable removals leave a stale "
                            "head, and a drained list's service order "
                            "is not expressible as op intervals)"}
        n_pairs = sum(1 for op in ops if is_invoke(op))
        if n_pairs > self.max_ops:
            return {"valid": "unknown",
                    "info": f"{n_pairs} ops > max_ops={self.max_ops}; "
                            "shard the queue (independent keys) or "
                            "raise max_ops"}
        n_enq = sum(1 for op in ops
                    if is_invoke(op) and op.f == "enqueue")
        make = fifo_queue if self.fifo else unordered_queue
        # capacity rounds up to a power of two: model.name embeds it and
        # keys the kernel cache, so similar-sized histories must share
        # compiled kernels instead of compiling one family per enqueue
        # count
        cap = max(4, n_enq + 1)
        cap = 1 << (cap - 1).bit_length()
        model = make(cap)
        out = Linearizable(model, budget=self.budget,
                           device=self.device).check(
            test, ops, opts)
        out["model"] = model.name
        return out


def queue_linearizable(**kw) -> Checker:
    return QueueLinearizable(**kw)


def add_queue_linear_opts(p) -> None:
    """CLI flags for the opt-in linearizability check, shared by the
    queue suites (rabbitmq, disque)."""
    p.add_argument("--queue-linear", action="store_true",
                   help="Also run the device linearizability search "
                        "over the multiset model (short runs only)")
    p.add_argument("--queue-linear-max-ops", type=int, default=2000)


def queue_linear_entry(opts: dict, **kw) -> dict:
    """The compose entry for --queue-linear: {} when the flag is off
    (past its op gate the checker reports "unknown", which would
    degrade a long run's composed verdict — so it stays opt-in)."""
    if not opts.get("queue_linear"):
        return {}
    return {"queue_linear": queue_linearizable(
        max_ops=opts.get("queue_linear_max_ops", 2000), **kw)}


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


# ---------------------------------------------------------------------------
# unique-ids (checker.clj:305-351)
# ---------------------------------------------------------------------------


class UniqueIdsChecker(Checker):
    def check(self, test, history, opts=None):
        attempted = sum(1 for op in history
                        if is_invoke(op) and op.f == "generate")
        acks = [op.value for op in history
                if is_ok(op) and op.f == "generate"]
        counts = Counter(acks)
        dups = {k: n for k, n in counts.items() if n > 1}
        rng = [min(acks), max(acks)] if acks else None
        return {
            "valid": not dups,
            "attempted_count": attempted,
            "acknowledged_count": len(acks),
            "duplicated_count": len(dups),
            "duplicated": dict(sorted(dups.items(), key=lambda kv: -kv[1])
                               [:48]),
            "range": rng,
        }


def unique_ids() -> Checker:
    return UniqueIdsChecker()


# ---------------------------------------------------------------------------
# counter — reads bounded by [sum of ok adds, sum of attempted adds]
# (checker.clj:353-406)
# ---------------------------------------------------------------------------


class CounterChecker(Checker):
    def check(self, test, history, opts=None):
        lower = 0            # sum of ok increments
        upper = 0            # sum of attempted increments
        pending = {}         # process -> [lower-at-invoke, read-value]
        reads = []           # [lower, value, upper]
        for op in history:
            key = (op.type, op.f)
            if key == ("invoke", "read"):
                pending[op.process] = [lower, op.value]
            elif key == ("ok", "read"):
                r = pending.pop(op.process, None)
                if r is not None:
                    # the ok's value is authoritative (invoke carried nil)
                    reads.append([r[0], op.value, upper])
            elif key == ("invoke", "add"):
                upper += op.value
            elif key == ("ok", "add"):
                lower += op.value
        errors = [r for r in reads
                  if r[1] is None or not (r[0] <= r[1] <= r[2])]
        return {"valid": not errors, "reads": reads, "errors": errors}


def counter() -> Checker:
    return CounterChecker()


# ---------------------------------------------------------------------------
# bank — transfers conserve the total and never go negative
# (jepsen/src/jepsen/tests/bank.clj:41-64)
# ---------------------------------------------------------------------------


class BankChecker(Checker):
    def check(self, test, history, opts=None):
        total = test.get("total_amount", 100)
        bad_reads = []
        for op in history:
            if not (is_ok(op) and op.f == "read"):
                continue
            balances = list((op.value or {}).values())
            if sum(balances) != total:
                bad_reads.append({"type": "wrong-total",
                                  "total": sum(balances),
                                  "op": op.to_dict()})
            elif any(b < 0 for b in balances):
                bad_reads.append({"type": "negative-value",
                                  "negative": [b for b in balances if b < 0],
                                  "op": op.to_dict()})
        return {"valid": not bad_reads, "bad_reads": bad_reads}


def bank() -> Checker:
    return BankChecker()


# ---------------------------------------------------------------------------
# Adya G2 — at most one insert per key succeeds (adya.clj:57-83)
# ---------------------------------------------------------------------------


class G2Checker(Checker):
    """History values are KV tuples [key, [a_id, b_id]]; at most one
    :insert may succeed per key."""

    def check(self, test, history, opts=None):
        keys: dict = {}
        for op in history:
            if op.f != "insert" or op.value is None:
                continue
            k = op.value[0] if isinstance(op.value, (tuple, list)) else \
                getattr(op.value, "key", None)
            if op.type == "ok":
                keys[k] = keys.get(k, 0) + 1
            else:
                keys.setdefault(k, 0)
        illegal = {k: n for k, n in keys.items() if n > 1}
        insert_count = sum(1 for n in keys.values() if n > 0)
        return {
            "valid": not illegal,
            "key_count": len(keys),
            "legal_count": insert_count - len(illegal),
            "illegal_count": len(illegal),
            "illegal": illegal,
        }


def g2() -> Checker:
    return G2Checker()
