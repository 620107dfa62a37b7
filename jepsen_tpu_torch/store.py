"""Where a run's files go: ``<store_base>/<test name>/<start time>/``.

Only the paths of the JAX package's store (``store_base`` in the test
map, else ``store`` under the working directory); writing results,
histories and logs comes with the CLI."""

from __future__ import annotations

import os
import time as _time

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
