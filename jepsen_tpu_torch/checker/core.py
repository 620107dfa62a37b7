"""The checker protocol and its combinators (jepsen's ``checker.clj``):
a ``Checker`` returns a map with at least ``"valid"``; :func:`check_safe`
turns a crash into ``"unknown"``; :func:`merge_valid` merges verdicts,
false over unknown over true; :func:`compose` runs a named map of
checkers over one history in parallel; :func:`concurrency_limit` caps
the concurrent runs of one checker."""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Iterable

from ..util import bounded_pmap

UNKNOWN = "unknown"


class Checker:
    """Validity analysis over a complete history: ``check(test, history,
    opts)`` returns a dict with at least ``{"valid": True | False |
    "unknown"}``."""

    def check(self, test: dict, history: list,
              opts: dict | None = None) -> dict:
        raise NotImplementedError

    def __call__(self, test, history, opts=None):
        return self.check(test, history, opts)


class CheckerFn(Checker):
    """A plain function ``(test, history, opts) -> result`` as a
    checker."""

    def __init__(self, f: Callable, name: str | None = None):
        self.f = f
        self.name = name or getattr(f, "__name__", "checker-fn")

    def check(self, test, history, opts=None):
        return self.f(test, history, opts)


def merge_valid(valids: Iterable) -> Any:
    """False if any is False, else "unknown" if any is not True (a
    missing verdict included), else True; True for none."""
    out: Any = True
    for v in valids:
        if v is False:
            return False
        if v is not True:
            out = UNKNOWN
    return out


def check_safe(checker: Checker, test: dict, history: list,
               opts: dict | None = None) -> dict:
    """``checker.check`` that never raises: a crash gives
    ``{"valid": "unknown", "error": <traceback>}``."""
    try:
        return checker.check(test, history, opts or {})
    except Exception:
        return {"valid": UNKNOWN, "error": traceback.format_exc()}


class Compose(Checker):
    """A named map of checkers over the same history, run in parallel
    (checker.clj:77-89).  Result: ``{"valid": merged, <name>: result,
    ...}``; a checker that raises reads "unknown"."""

    def __init__(self, checkers: dict):
        self.checkers = dict(checkers)

    def check(self, test, history, opts=None):
        names = list(self.checkers)
        results = bounded_pmap(
            lambda name: check_safe(self.checkers[name], test, history, opts),
            names)
        out = dict(zip(names, results))
        out["valid"] = merge_valid(r.get("valid") for r in results)
        return out


def compose(checkers: dict) -> Checker:
    return Compose(checkers)


class ConcurrencyLimit(Checker):
    """At most ``limit`` concurrent runs of a memory-hungry checker
    (checker.clj:91-106), for many keys fanned out over one checker."""

    def __init__(self, limit: int, checker: Checker):
        self.checker = checker
        self._sem = threading.Semaphore(limit)

    def check(self, test, history, opts=None):
        with self._sem:
            return self.checker.check(test, history, opts)


def concurrency_limit(limit: int, checker: Checker) -> Checker:
    return ConcurrencyLimit(limit, checker)


class _Unbridled(Checker):
    """A checker which is always happy (checker.clj:108-112)."""

    def check(self, test, history, opts=None):
        return {"valid": True}


unbridled_dionysus = _Unbridled()
noop = unbridled_dionysus
