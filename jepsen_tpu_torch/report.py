"""Report helpers.

Reference: jepsen/src/jepsen/report.clj — `to` redirects stdout into a
store file while also printing (report.clj:7-16).
"""

from __future__ import annotations

import contextlib
import io
import sys


class to(contextlib.AbstractContextManager):
    """Tee stdout into a file for the duration of the block
    (report.clj:7-16)."""

    def __init__(self, filename: str):
        self.filename = filename

    def __enter__(self):
        self._f = open(self.filename, "w")
        self._old = sys.stdout
        outer = self

        class Tee(io.TextIOBase):
            def write(self, s):
                outer._old.write(s)
                outer._f.write(s)
                return len(s)

            def flush(self):
                outer._old.flush()
                outer._f.flush()

        sys.stdout = Tee()
        return self

    def __exit__(self, *exc):
        sys.stdout = self._old
        self._f.close()
        return False
