"""DB automation protocols (reference L1).

Reference: jepsen/src/jepsen/db.clj — protocols DB (setup!/teardown!),
Primary (setup-primary!), LogFiles (log-files), plus `cycle!` which tears
down any leftover state before setup (db.clj:20-25).
"""

from __future__ import annotations


class DB:
    def setup(self, test: dict, node) -> None:
        """Install and start the database on this node."""

    def teardown(self, test: dict, node) -> None:
        """Tear the database down on this node."""


class Primary:
    """Mixin: one-time setup on the primary node (db.clj:8)."""

    def setup_primary(self, test: dict, node) -> None:
        pass


class LogFiles:
    """Mixin: which files to snarf from each node (db.clj:11)."""

    def log_files(self, test: dict, node) -> list[str]:
        return []


class _Noop(DB):
    pass


noop = _Noop()


def cycle(db: DB, test: dict, node) -> None:
    """Teardown (ignoring errors), then setup (db.clj:20-25)."""
    try:
        db.teardown(test, node)
    except Exception:
        pass
    db.setup(test, node)
