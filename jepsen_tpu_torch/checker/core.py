"""The checker protocol, and the two combinators the independent-keys
checker needs (jepsen's ``checker.clj``): a ``Checker`` returns a map
with at least ``"valid"``; :func:`check_safe` turns a crash into
``"unknown"``; :func:`merge_valid` merges verdicts, false over unknown
over true."""

from __future__ import annotations

import traceback
from typing import Any, Iterable

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
