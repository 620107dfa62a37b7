"""The fleet's shared verdict-cache store over the jsonl verdict cache.

``decompose/cache.py``'s :class:`VerdictCache` is one jsonl file every
writer appends to under one file lock.  The fleet splits the store so
that workers on one shared directory never contend on an insert:

.. code-block:: text

    <root>/
      verdicts.jsonl          # the compacted base (merge target)
      segments/<worker>.jsonl # one write-ahead segment PER WORKER
      .store.lock             # serializes spills (base rewrites)

Each worker appends only to its own segment.  A **spill**
(:meth:`FleetCacheStore.compact`, armed when the worker's segment
outgrows ``compact_bytes``) takes the store lock, merge-reads the base
and every segment, atomically rewrites the base, then truncates only
the spiller's own segment: a line another worker appends mid-spill stays
in its segment and reaches the base on a later spill.  Two spills
serialize on the store lock, so the second re-reads the first's base.

Loads read the base and every segment, so a restarted worker sees all
the fleet decided, and :meth:`~FleetCacheStore.refresh` picks up peers'
verdicts mid-run.  The layout, the lines and the canonical keys are the
JAX package's ``fleet/cachestore.py``'s: a store root written by either
package's workers serves the other's.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX fallback
    fcntl = None  # type: ignore[assignment]

from ..decompose.cache import VerdictCache

_WID_RE = re.compile(r"[^A-Za-z0-9._-]+")

#: fleet segments are expected to spill far more often than the
#: single-file cache compacts — the base absorbs the volume
_DEFAULT_SEGMENT_BYTES = 8 << 20


def _safe_wid(worker_id: str | None) -> str:
    wid = worker_id if worker_id else f"w{os.getpid()}"
    return _WID_RE.sub("_", str(wid)) or f"w{os.getpid()}"


def store_paths(root: str) -> dict:
    """The store layout for ``root`` (tests, tooling)."""
    return {
        "base": os.path.join(root, "verdicts.jsonl"),
        "segments": os.path.join(root, "segments"),
        "lock": os.path.join(root, ".store.lock"),
    }


class FleetCacheStore(VerdictCache):
    """Per-worker write-ahead segment + shared compacted base.

    The public surface is the VerdictCache one (``get`` /
    ``put_verdict`` / ``put_states`` / ``compact`` / ``close``), so
    stream/service.py and the engines use it unchanged; only the
    persistence layout differs."""

    def __init__(self, root: str, worker_id: str | None = None,
                 compact_bytes: int | None = None):
        self.root = os.path.abspath(root)
        self.worker_id = _safe_wid(worker_id)
        p = store_paths(self.root)
        self.base_path = p["base"]
        self.segment_dir = p["segments"]
        self._store_lock_path = p["lock"]
        self._store_lockfh = None
        os.makedirs(self.segment_dir, exist_ok=True)
        seg = os.path.join(self.segment_dir,
                           f"{self.worker_id}.jsonl")
        super().__init__(
            seg,
            compact_bytes=_DEFAULT_SEGMENT_BYTES
            if compact_bytes is None else compact_bytes)
        # super().__init__ loaded our own (leftover) segment; fold in
        # the base and every peer segment for fleet-wide hit ratios
        self.refresh()

    # -- store-wide lock (spill serialization) -------------------------

    @contextlib.contextmanager
    def _store_locked(self):
        """Exclusive spill section across every worker on the store:
        flock on <root>/.store.lock.  Segment appends do NOT take it —
        they are single-writer per file by construction."""
        with self._tlock:
            if fcntl is None:  # pragma: no cover — non-POSIX
                yield
                return
            if self._store_lockfh is None:
                os.makedirs(self.root, exist_ok=True)
                self._store_lockfh = open(self._store_lock_path, "a")
            fcntl.flock(self._store_lockfh.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(self._store_lockfh.fileno(),
                            fcntl.LOCK_UN)

    # -- loading / peers -----------------------------------------------

    def _segment_paths(self) -> list[str]:
        return sorted(
            glob.glob(os.path.join(self.segment_dir, "*.jsonl")))

    def _read_into(self, path: str, dst: dict) -> int:
        """Merge a jsonl file into ``dst`` (setdefault — entries for a
        key are equal by determinism).  Returns lines read."""
        lines = 0
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    lines += 1
                    try:
                        e = json.loads(line)
                        dst.setdefault(e["k"], e)
                    except (ValueError, KeyError):
                        continue  # torn tail line
        except OSError:
            pass
        return lines

    def refresh(self) -> int:
        """Merge the base and every peer segment into memory — a
        worker picks up fleet-wide verdicts decided since its load.
        Returns how many new keys appeared."""
        before = len(self._d)
        self._read_into(self.base_path, self._d)
        for seg in self._segment_paths():
            if seg != self.path:
                self._read_into(seg, self._d)
        return len(self._d) - before

    # -- spill (the fleet compact) -------------------------------------

    def compact(self) -> int:
        """Spill: merge base + all segments into a fresh base, then
        truncate OUR segment only.  Returns superseded lines dropped
        across the files read."""
        if self.path is None:  # pragma: no cover — super() contract
            return 0
        with self._store_locked(), self._locked():
            merged = dict(self._d)
            lines = self._read_into(self.base_path, merged)
            for seg in self._segment_paths():
                lines += self._read_into(seg, merged)
            tmp = f"{self.base_path}.spill.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    for e in merged.values():
                        f.write(json.dumps(e, separators=(",", ":"))
                                + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.base_path)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return 0
            self._d = merged
            # truncate our own write-ahead segment: its lines are in
            # the base now.  Replace-with-empty keeps the inode-change
            # signal a restarted twin's _repoint_fh watches for.
            try:
                tmp2 = f"{self.path}.spill.{os.getpid()}"
                with open(tmp2, "w") as f:
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp2, self.path)
            except OSError:
                pass
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            # counters under the lock: concurrent spill/merge cycles
            # from two checker threads must not lose increments
            dropped = max(0, lines - len(merged))
            self.compactions += 1
            self.compacted_away += dropped
        return dropped

    def close(self) -> None:
        super().close()
        if self._store_lockfh is not None:
            self._store_lockfh.close()
            self._store_lockfh = None
