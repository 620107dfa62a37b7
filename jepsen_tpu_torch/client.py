"""Client protocol — applies operations to the system under test.

Reference: jepsen/src/jepsen/client.clj:8-26.  Five-phase lifecycle:

  open(test, node)    -> connection-ready client (no logical state change)
  setup(test)         -> one-time database state preparation
  invoke(test, op)    -> completion Op (type ok/fail/info)
  teardown(test)      -> logical cleanup
  close(test)         -> connection cleanup

The worker loop (core.py) opens one client per worker, reopens after
crashes, and converts invoke exceptions into :info completions
(core.clj:248-281).
"""

from __future__ import annotations

from dataclasses import replace

from .history import Op


class Client:
    def open(self, test: dict, node) -> "Client":
        """Bind to a node; return a client ready for invoke (may be a new
        instance).  Must not change the logical state of the test."""
        return self

    def setup(self, test: dict) -> None:
        """One-time database state setup."""

    def invoke(self, test: dict, op: Op) -> Op:
        """Apply op; return the completion (type ok/fail/info)."""
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        """Tear down logical state when work is complete."""

    def close(self, test: dict) -> None:
        """Release the connection."""


class _Noop(Client):
    """Acks every op (client.clj:28-36)."""

    def invoke(self, test, op):
        return replace(op, type="ok")


noop = _Noop()
