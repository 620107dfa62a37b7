"""Additional consistency checkers from the suite layer.

Ports of the cockroachdb suite's reusable analyses:

  * sequential — client order must match DB visibility order
    (cockroachdb/src/jepsen/cockroach/sequential.clj:136-163): process A
    inserts x then y in separate transactions; process B reads y then x.
    Reading y (the later insert) but not x (the earlier) — a nil after a
    non-nil in the read vector — violates sequential consistency.
  * monotonic — timestamps and values must proceed in order
    (cockroachdb/src/jepsen/cockroach/monotonic.clj:144-230): a final
    read returns rows {val, sts, proc, node, tb}; checks global timestamp
    order, global/per-process/node/table value order, plus lost /
    duplicate / recovered accounting.

Both consume event-level histories like the rest of checker/.
"""

from __future__ import annotations

from collections import Counter

from ..history import is_fail, is_info, is_ok
from .core import Checker


def trailing_nil(coll) -> bool:
    """A nil anywhere after a non-nil element (sequential.clj:136-139)."""
    seen_value = False
    for x in coll:
        if x is None:
            if seen_value:
                return True
        else:
            seen_value = True
    return False


class SequentialChecker(Checker):
    """sequential.clj:141-163.  Reads carry values of [k, [reads...]]
    where the read vector is in reverse insert order."""

    def __init__(self, subkeys=None):
        # subkeys(key_count, k) -> the full expected subkey list
        self.subkeys = subkeys or (
            lambda key_count, k: [f"{k}_{i}" for i in range(key_count)])

    def check(self, test, history, opts=None):
        key_count = test.get("key_count")
        reads = [op.value for op in history
                 if is_ok(op) and op.f == "read" and op.value is not None]
        none = [r for r in reads if all(v is None for v in r[1])]
        some = [r for r in reads if any(v is None for v in r[1])]
        bad = [r for r in reads if trailing_nil(r[1])]
        all_ = [r for r in reads
                if key_count is not None
                and list(self.subkeys(key_count, r[0])) ==
                list(reversed(list(r[1])))]
        return {
            "valid": not bad,
            "all_count": len(all_),
            "some_count": len(some),
            "none_count": len(none),
            "bad_count": len(bad),
            "bad": bad,
        }


def sequential(subkeys=None) -> Checker:
    return SequentialChecker(subkeys)


def non_monotonic(cmp, key, xs) -> list:
    """Successive pairs where cmp(key(x), key(x')) fails
    (monotonic.clj:144-151)."""
    out = []
    for a, b in zip(xs, xs[1:]):
        if not cmp(key(a), key(b)):
            out.append((a, b))
    return out


def non_monotonic_by(group, cmp, key, xs) -> dict:
    """non_monotonic within groups (monotonic.clj:153-161)."""
    groups: dict = {}
    for x in xs:
        groups.setdefault(group(x), []).append(x)
    return {g: non_monotonic(cmp, key, sub) for g, sub in
            sorted(groups.items(), key=lambda kv: str(kv[0]))}


def _field(name):
    return lambda row: row[name] if isinstance(row, dict) else \
        getattr(row, name)


class MonotonicChecker(Checker):
    """monotonic.clj:163-230.  add ops carry {val, ...}; the final read
    carries an ordered list of {val, sts, proc, node, tb} rows."""

    def __init__(self, global_order: bool = True):
        self.global_order = global_order

    def check(self, test, history, opts=None):
        add_ok = [op.value for op in history
                  if is_ok(op) and op.f == "add"]
        add_fail = [op.value for op in history
                    if is_fail(op) and op.f == "add"]
        add_info = [op.value for op in history
                    if is_info(op) and op.f == "add"]
        final = None
        for op in history:
            if is_ok(op) and op.f == "read":
                final = op.value
        if final is None:
            return {"valid": "unknown", "error": "Set was never read"}

        val = _field("val")
        off_order_stss = non_monotonic(
            lambda a, b: a <= b, _field("sts"), final)
        off_order_vals = non_monotonic(lambda a, b: a < b, val, final)
        by_proc = non_monotonic_by(_field("proc"),
                                   lambda a, b: a < b, val, final)
        by_node = non_monotonic_by(_field("node"),
                                   lambda a, b: a < b, val, final)
        by_table = non_monotonic_by(_field("tb"),
                                    lambda a, b: a < b, val, final)

        def vals(rows):
            return {val(r) if isinstance(r, dict) else r for r in rows}

        adds = {v["val"] if isinstance(v, dict) else v for v in add_ok}
        infos = {v["val"] if isinstance(v, dict) else v for v in add_info}
        final_vals = [val(r) for r in final]
        dups = {v for v, n in Counter(final_vals).items() if n > 1}
        final_set = set(final_vals)
        lost = adds - final_set
        recovered = final_set & infos

        per_key_violations = (
            off_order_vals if self.global_order
            else [p for sub in by_proc.values() for p in sub])
        valid = not (lost or dups or off_order_stss or per_key_violations)
        return {
            "valid": valid,
            "lost": sorted(lost),
            "duplicates": sorted(dups),
            "recovered": sorted(recovered),
            "off_order_stss": off_order_stss,
            "off_order_vals": off_order_vals,
            "off_order_vals_per_process": by_proc,
            "off_order_vals_per_node": by_node,
            "off_order_vals_per_table": by_table,
        }


def monotonic(global_order: bool = True) -> Checker:
    return MonotonicChecker(global_order)
