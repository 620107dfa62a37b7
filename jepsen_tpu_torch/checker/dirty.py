"""Dirty-read detection checkers.

Two members of the family, both absent from jepsen's core library but
carried by its suites:

  * ``dirty_reads`` — the galera/percona flavor
    (galera/src/jepsen/galera/dirty_reads.clj:72-95): writers race to set
    every row of a table to their op's unique value inside a serializable
    txn; readers snapshot all rows.  A read containing a FAILED write's
    value is a dirty read (the txn's effects were visible before it
    aborted).  A read whose rows are not all equal is an inconsistent
    (non-atomic) read.

  * ``strong_dirty_read`` — the elasticsearch flavor
    (elasticsearch/src/jepsen/elasticsearch/dirty_read.clj:106-157):
    processes write unique ids and read back the most recent in-flight
    id; after quiescence every process takes a final "strong read" of
    the full set.  A successful read of an id absent from every strong
    read is dirty (saw uncommitted state); a successful write absent
    from every strong read is lost; strong reads disagreeing across
    nodes is divergence.

Both consume event-level histories (Op dataclasses) like the rest of
checker/.
"""

from __future__ import annotations

from ..history import is_fail, is_ok
from .core import Checker


class DirtyReadsChecker(Checker):
    """galera dirty_reads.clj:72-95."""

    def check(self, test, history, opts=None):
        failed_writes = {op.value for op in history
                         if is_fail(op) and op.f == "write"}
        reads = [op.value for op in history
                 if is_ok(op) and op.f == "read" and op.value is not None]
        inconsistent = [r for r in reads if len(set(r)) > 1]
        dirty = [r for r in reads
                 if any(x in failed_writes for x in r)]
        return {
            "valid": not dirty,
            "read_count": len(reads),
            "inconsistent_reads": inconsistent,
            "dirty_reads": dirty,
        }


def dirty_reads() -> Checker:
    return DirtyReadsChecker()


class StrongDirtyReadChecker(Checker):
    """elasticsearch dirty_read.clj:106-157.

    Expects ops: write(value=id) / read(value=id, :ok iff found) /
    strong-read(value=set-of-ids).
    """

    def check(self, test, history, opts=None):
        ok = [op for op in history if is_ok(op)]
        writes = {op.value for op in ok if op.f == "write"}
        reads = {op.value for op in ok if op.f == "read"}
        strong = [set(op.value) for op in ok if op.f == "strong-read"
                  and op.value is not None]
        if not strong:
            return {"valid": "unknown",
                    "error": "no strong reads completed"}
        on_all = set.intersection(*strong)
        on_some = set.union(*strong)
        not_on_all = on_some - on_all
        unchecked = on_some - reads
        dirty = reads - on_some
        lost = writes - on_some
        some_lost = writes - on_all
        nodes_agree = on_all == on_some
        return {
            "valid": bool(nodes_agree and not dirty and not lost),
            "nodes_agree": nodes_agree,
            "read_count": len(reads),
            "strong_read_count": len(strong),
            "on_all_count": len(on_all),
            "on_some_count": len(on_some),
            "unchecked_count": len(unchecked),
            "not_on_all_count": len(not_on_all),
            "not_on_all": sorted(not_on_all, key=str),
            "dirty_count": len(dirty),
            "dirty": sorted(dirty, key=str),
            "lost_count": len(lost),
            "lost": sorted(lost, key=str),
            "some_lost_count": len(some_lost),
            "some_lost": sorted(some_lost, key=str),
        }


def strong_dirty_read() -> Checker:
    return StrongDirtyReadChecker()
