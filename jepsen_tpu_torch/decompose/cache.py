"""The canonical-hash verdict cache, persisted under the store tree.

It maps :func:`canonical.canonical_key` hashes to a decided verdict
(``{"v": true|false}``, a whole cell) or a set of reachable final
states (``{"out": [[..], ..]}``, a quiescence segment under one set of
input states).  "unknown" is never stored: a budget miss is not a
property of the history.

The file (by default ``<store.BASE>/verdict_cache/verdicts.jsonl``) is
the JAX package's format, so either package reads the other's: one JSON
object per line, append-only, the newest entry of a key winning, a torn
last line skipped on load.  Appends and compactions hold an
interprocess lock (``flock`` on a ``<path>.lock`` sidecar, and an
in-process RLock for threads sharing one instance), and every append
first checks that its handle still points at the file's inode (another
process's compaction may have replaced it).  Past ``compact_bytes`` the
file is rewritten to its live entries (:meth:`VerdictCache.compact`),
merging what other writers appended since the load.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading

try:
    import fcntl
except ImportError:  # pragma: no cover - not POSIX
    fcntl = None  # type: ignore[assignment]

from ..obs.metrics import REGISTRY

#: every cache in the process feeds one registry metric; results keep
#: their own exact per-run counts
_M_VCACHE = REGISTRY.counter(
    "jtpu_verdict_cache_total",
    "Verdict-cache lookups/writes (hit/miss/insert)", ("event",))

#: the default size past which an append compacts the file (bytes)
DEFAULT_COMPACT_BYTES = 64 << 20

#: appends between two size checks: a stat per write buys nothing
_COMPACT_CHECK_EVERY = 256


def default_cache_path(base: str | None = None) -> str:
    """``<base>/verdict_cache/verdicts.jsonl``, ``base`` defaulting to
    ``store.BASE``."""
    from .. import store

    return os.path.join(base if base is not None else store.BASE,
                        "verdict_cache", "verdicts.jsonl")


class VerdictCache:
    """An in-memory dict with append-through jsonl persistence.

    ``path=None`` keeps it in memory.  ``hits``/``misses`` count
    :meth:`get` outcomes and ``inserts`` the entries stored, since the
    last :meth:`reset_stats`; the engines put them on their results.
    ``compact_bytes`` (default 64 MiB) is the file size past which an
    append compacts; 0 turns that off (:meth:`compact` still works)."""

    def __init__(self, path: str | None = None,
                 compact_bytes: int = DEFAULT_COMPACT_BYTES):
        self.path = path
        self._d: dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.compact_bytes = compact_bytes
        self.compactions = 0
        self.compacted_away = 0  # superseded lines dropped, in all
        self._appends = 0  # since the last size check
        self._fh = None
        # the RLock is held across the whole locked section, so the
        # flock depth count is race-free and reentrant (compact() from
        # _append())
        self._tlock = threading.RLock()
        self._lockfh = None
        self._lock_depth = 0
        if path is not None:
            self._load(path)

    @contextlib.contextmanager
    def _locked(self):
        """The exclusive append/compact section: the RLock in process,
        ``flock`` across processes where there is one."""
        if self.path is None:
            yield
            return
        with self._tlock:
            if self._lock_depth == 0 and fcntl is not None:
                if self._lockfh is None:
                    os.makedirs(os.path.dirname(self.path) or ".",
                                exist_ok=True)
                    self._lockfh = open(f"{self.path}.lock", "a")
                fcntl.flock(self._lockfh.fileno(), fcntl.LOCK_EX)
            self._lock_depth += 1
            try:
                yield
            finally:
                self._lock_depth -= 1
                if self._lock_depth == 0 and self._lockfh is not None \
                        and fcntl is not None:
                    fcntl.flock(self._lockfh.fileno(), fcntl.LOCK_UN)

    def _repoint_fh(self) -> None:
        """Drop the append handle when another process replaced the
        file: a handle on the dead inode would write into the void."""
        if self._fh is None:
            return
        try:
            if os.fstat(self._fh.fileno()).st_ino \
                    != os.stat(self.path).st_ino:
                self._fh.close()
                self._fh = None
        except OSError:
            self._fh.close()
            self._fh = None

    def _load(self, path: str) -> None:
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        e = json.loads(line)
                        self._d[e["k"]] = e
                    except (ValueError, KeyError):
                        continue  # a torn last line
        except OSError:
            pass

    def __len__(self) -> int:
        return len(self._d)

    def reset_stats(self) -> None:
        self.hits = 0
        self.misses = 0
        self.inserts = 0

    def get(self, key: str) -> dict | None:
        e = self._d.get(key)
        if e is None:
            self.misses += 1
            _M_VCACHE.inc(event="miss")
            return None
        self.hits += 1
        _M_VCACHE.inc(event="hit")
        return e

    def _append(self, e: dict) -> None:
        if self.path is None:
            return
        compact_due = False
        with self._locked():
            # under the lock no compaction is mid-replace, and the inode
            # check runs on every append
            self._repoint_fh()
            if self._fh is None:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                self._fh = open(self.path, "a")
            # no fsync: a torn last line is skipped on load, so a crash
            # costs at most the last buffered entries
            self._fh.write(json.dumps(e, separators=(",", ":")) + "\n")
            self._fh.flush()
            self._appends += 1
            if self.compact_bytes \
                    and self._appends >= _COMPACT_CHECK_EVERY:
                self._appends = 0
                try:
                    compact_due = self._fh.tell() > self.compact_bytes
                except OSError:
                    pass
        if compact_due:
            self.compact()

    def compact(self) -> int:
        """Rewrite the file to the live entries; returns the number of
        superseded lines dropped.  What other processes appended since
        the load is merged in first, and the merge-read, the write of a
        temporary file and the atomic replace all hold the lock, so no
        writer's append falls between them.  A reader mid-scan of the
        old file keeps its complete (stale) view."""
        if self.path is None:
            return 0
        with self._locked():
            lines = 0
            try:
                with open(self.path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        lines += 1
                        try:
                            e = json.loads(line)
                            self._d.setdefault(e["k"], e)
                        except (ValueError, KeyError):
                            continue
            except OSError:
                pass
            tmp = f"{self.path}.compact.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    for e in self._d.values():
                        f.write(json.dumps(e, separators=(",", ":"))
                                + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return 0
            # the append handle points at the replaced inode
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            dropped = max(0, lines - len(self._d))
            self.compactions += 1
            self.compacted_away += dropped
            if self.compact_bytes:
                try:
                    size = os.path.getsize(self.path)
                except OSError:
                    size = 0
                if size > self.compact_bytes // 2:
                    # the live set itself nears the threshold: raise it,
                    # or every check would rewrite the file for nothing
                    self.compact_bytes = max(self.compact_bytes,
                                             size) * 2
        return dropped

    def put_verdict(self, key: str, valid) -> None:
        if valid not in (True, False):
            return  # "unknown" is a budget artefact, not a verdict
        e = {"k": key, "v": bool(valid)}
        with self._tlock:
            self._d[key] = e
            self.inserts += 1
        _M_VCACHE.inc(event="insert")
        self._append(e)

    def put_states(self, key: str, out_states: list[list[int]]) -> None:
        e = {"k": key, "out": [list(s) for s in out_states]}
        with self._tlock:
            self._d[key] = e
            self.inserts += 1
        _M_VCACHE.inc(event="insert")
        self._append(e)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._lockfh is not None:
            self._lockfh.close()
            self._lockfh = None
