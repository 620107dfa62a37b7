"""Results persistence: a run's files under
``<store_base>/<test name>/<start time>/`` (jepsen's ``store.clj``).

The JAX package's store, file for file: the history one op per JSON
line (``history.jsonl``, :func:`write_history`/:func:`read_history`),
the test map without its live objects (``test.json``, :func:`save_1`),
the analysis results (``results.json``, :func:`save_2`), the ``latest``
symlinks, and the run log (``jepsen.log``, :func:`start_logging`).  The
bytes written are the JAX package's for the same test, so either package
loads the other's runs (:func:`tests`, :func:`load`, :func:`latest`).
``store_base`` in the test map, else ``store`` under the working
directory, is the root."""

from __future__ import annotations

import json
import logging
import os
import time as _time
from typing import Any, Iterable

from .history import Op

BASE = "store"

#: test-map keys that hold live objects and never serialize
#: (store.clj:155-163)
NONSERIALIZABLE_KEYS = [
    "db", "os", "net", "client", "checker", "nemesis", "generator", "model",
    "remote", "barrier", "active_histories", "sessions", "history",
]


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_. " else "_" for c in name)


def time_str(t: float | None = None) -> str:
    return _time.strftime("%Y%m%dT%H%M%S", _time.localtime(t))


def base_dir(test: dict) -> str:
    return test.get("store_base", BASE)


def path(test: dict, *more: str) -> str:
    """``<base>/<name>/<start time>/<more...>``."""
    name = _sanitize(test.get("name") or "noname")
    t = test.get("start_time") or time_str()
    return os.path.join(base_dir(test), name, t, *[str(m) for m in more])


def path_mkdirs(test: dict, *more: str) -> str:
    p = path(test, *more)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    return p


def _jsonable(v: Any):
    if isinstance(v, Op):
        return v.to_dict()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (set, frozenset)):
        return sorted(_jsonable(x) for x in v)
    try:
        import numpy as np

        if isinstance(v, np.generic):
            return v.item()
    except Exception:
        pass
    return repr(v)


def serializable_test(test: dict) -> dict:
    """The test map without :data:`NONSERIALIZABLE_KEYS`, as JSON
    values."""
    return {k: _jsonable(v) for k, v in test.items()
            if k not in NONSERIALIZABLE_KEYS}


#: ops per buffered write of a history
HISTORY_CHUNK = 16384


def write_history(test: dict, history: Iterable[Op],
                  fname: str = "history.jsonl") -> str:
    """Write ``history`` to ``<store path>/<fname>``, one op per line,
    flushed every :data:`HISTORY_CHUNK` ops; returns the path."""
    p = path_mkdirs(test, fname)
    with open(p, "w") as f:
        buf: list[str] = []
        for op in history:
            d = op.to_dict() if isinstance(op, Op) else op
            buf.append(json.dumps(_jsonable(d)))
            if len(buf) >= HISTORY_CHUNK:
                f.write("\n".join(buf) + "\n")
                buf.clear()
        if buf:
            f.write("\n".join(buf) + "\n")
    return p


def read_history(p: str) -> list[Op]:
    with open(p) as f:
        return [Op.from_dict(json.loads(line)) for line in f if line.strip()]


def save_1(test: dict, history: Iterable[Op]) -> str:
    """Post-run save: history + test map (store.clj:281-292)."""
    write_history(test, history)
    p = path_mkdirs(test, "test.json")
    with open(p, "w") as f:
        json.dump(serializable_test(test), f, indent=2, default=repr)
    update_symlinks(test)
    return p


def save_2(test: dict, results: dict) -> str:
    """Post-analysis save: results.json (store.clj:294-304)."""
    p = path_mkdirs(test, "results.json")
    with open(p, "w") as f:
        json.dump(_jsonable(results), f, indent=2, default=repr)
    update_symlinks(test)
    return p


def update_symlinks(test: dict) -> None:
    """store/latest and store/<name>/latest (store.clj:237-249)."""
    run_dir = os.path.dirname(path(test, "x"))

    def relink(link: str, target: str):
        try:
            if os.path.islink(link):
                os.unlink(link)
            elif os.path.exists(link):
                return
            os.symlink(os.path.relpath(target, os.path.dirname(link)), link)
        except OSError:
            pass

    name_dir = os.path.dirname(run_dir)
    relink(os.path.join(name_dir, "latest"), run_dir)
    relink(os.path.join(base_dir(test), "latest"), run_dir)


def tests(name: str | None = None,
          base: str | None = None) -> dict:
    """Map of test name -> {start-time -> run dir} (store.clj:216-234).

    ``base`` defaults to BASE at call time, so module-level overrides
    (tests, store_base plumbing) are honored."""
    base = BASE if base is None else base
    out: dict = {}
    if not os.path.isdir(base):
        return out
    for n in sorted(os.listdir(base)):
        d = os.path.join(base, n)
        if not os.path.isdir(d) or n == "latest":
            continue
        if name is not None and n != name:
            continue
        runs = {t: os.path.join(d, t) for t in sorted(os.listdir(d))
                if t != "latest" and os.path.isdir(os.path.join(d, t))}
        out[n] = runs
    return out


def load(name: str, start_time: str,
         base: str | None = None) -> dict:
    """Reload a saved test: test map + history + results
    (store.clj:165-181)."""
    base = BASE if base is None else base
    d = os.path.join(base, name, start_time)
    out: dict = {}
    tj = os.path.join(d, "test.json")
    if os.path.exists(tj):
        with open(tj) as f:
            out = json.load(f)
    hj = os.path.join(d, "history.jsonl")
    if os.path.exists(hj):
        out["history"] = read_history(hj)
    rj = os.path.join(d, "results.json")
    if os.path.exists(rj):
        with open(rj) as f:
            out["results"] = json.load(f)
    return out


def latest(base: str | None = None) -> dict | None:
    """The most recent run, via the latest symlink (repl.clj:6-13)."""
    base = BASE if base is None else base
    link = os.path.join(base, "latest")
    if not os.path.exists(link):
        return None
    d = os.path.realpath(link)
    name = os.path.basename(os.path.dirname(d))
    return load(name, os.path.basename(d), base)


# ---------------------------------------------------------------------------
# logging (store.clj:306-328): console + per-test jepsen.log file
# ---------------------------------------------------------------------------

_handlers: dict = {}


def start_logging(test: dict) -> None:
    logger = logging.getLogger("jepsen")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(
            "%(asctime)s %(threadName)s %(levelname)s: %(message)s"))
        logger.addHandler(sh)
    if not test.get("name"):
        return  # unnamed tests don't persist anything
    p = path_mkdirs(test, "jepsen.log")
    fh = logging.FileHandler(p)
    fh.setFormatter(logging.Formatter(
        "%(asctime)s %(threadName)s %(levelname)s: %(message)s"))
    logger.addHandler(fh)
    _handlers[id(test)] = fh


def stop_logging(test: dict | None = None) -> None:
    logger = logging.getLogger("jepsen")
    if test is not None:
        fh = _handlers.pop(id(test), None)
        if fh:
            logger.removeHandler(fh)
            fh.close()
        return
    for fh in _handlers.values():
        logger.removeHandler(fh)
        fh.close()
    _handlers.clear()
