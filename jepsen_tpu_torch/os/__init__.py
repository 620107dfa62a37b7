"""OS automation protocol (reference L1).

Reference: jepsen/src/jepsen/os.clj:4-12 — protocol OS with setup!
(ensure the node is ready: packages, users, time sync) and teardown!.
Concrete implementations: os/debian.py (apt), os/smartos.py (pkgin).
"""

from __future__ import annotations


class OS:
    def setup(self, test: dict, node) -> None:
        pass

    def teardown(self, test: dict, node) -> None:
        pass


class _Noop(OS):
    pass


noop = _Noop()
