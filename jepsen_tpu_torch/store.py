"""Where a run's files go: ``<store_base>/<test name>/<start time>/``.

The paths of the JAX package's store (``store_base`` in the test map,
else ``store`` under the working directory) and its history file:
:func:`write_history` and :func:`read_history`, one op per JSON line,
so either package reads the other's ``history.jsonl``.  Writing results
and logs comes with the CLI."""

from __future__ import annotations

import json
import os
import time as _time
from typing import Any, Iterable

from .history import Op

BASE = "store"


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
