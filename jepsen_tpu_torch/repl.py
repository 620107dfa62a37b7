"""Interactive exploration helpers.

Reference: jepsen/src/jepsen/repl.clj — `last-test` loads the most recent
run from the store for poking at histories offline (repl.clj:6-13).
"""

from __future__ import annotations

from . import store


def last_test(base: str | None = None):
    """The most recently run test, reloaded from disk (repl.clj:6-13)."""
    return store.latest(base)
