"""Linearizability checking and the checker library: the protocol and
its combinators (``core.py``), the O(n) checkers (``basic.py``,
``extra.py``, ``dirty.py``, ``schedule.py``), the timeline and
performance graphs (``timeline.py``, ``perf.py``), and the device search
with the ``Linearizable`` checker (``linearizable.py``).  Importing this
package builds no kernel."""

from .core import (  # noqa: F401
    Checker,
    CheckerFn,
    check_safe,
    compose,
    merge_valid,
    unbridled_dionysus,
)
