"""The least time the CUDA level loop (B1) needs for a window's device
searches: the work counted from the histories, and the H100's peaks.

Frozen copies of ``chip_smoke.py``'s rule, so that a later change to the
program cannot move the yardstick:

* peaks (``chip_smoke.py:269-274``): 3.35e12 B/s of HBM, and the
  67e12/s float32 rate outside the tensor cores standing in for 32-bit
  integer work (the card's int32 rate is at most that), NVIDIA's data
  sheet for the H100 SXM at 700 W;
* operations (``chip_smoke.py:1506-1516``, ``:1670-1680``): every
  configuration tests each of its candidate lanes, at least 8 int32
  operations a lane (the window bit, two return compares, the model's
  step);
* bytes: every table read once, the carry read and written once.

The counts are worked out from the history alone, never from the
configurations the program reports, so they read the same work whatever
implements the search, and they are a floor:

* configurations: a search that proves a history linearizable reaches
  its full depth, one configuration per completed op at the least; a
  history found not linearizable or undecided counts none;
* candidate lanes: the most completed ops pending at one moment of the
  history, plus its crashed ops (a crashed op stays a candidate once
  invoked);
* tables: five 32-bit words an op (function, two value lanes, invocation
  and completion); carry: one configuration (its depth, a bit per lane,
  the register's word).
"""

from __future__ import annotations

import math

from reference.check import parse

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
OPS_PER_LANE = 8
TABLE_WORDS_PER_OP = 5


def lanes(done, crashed) -> int:
    """The most completed ops pending at one event, plus the crashed
    ops."""
    edges = sorted([(o[0], 1) for o in done] + [(o[1], -1) for o in done])
    most = cur = 0
    for _, d in edges:
        cur += d
        most = max(most, cur)
    return most + len(crashed)


def work(events, valid) -> tuple[int, int]:
    """``(int32 operations, bytes)`` the least search of one history
    needs, given the verdict ``valid`` it reached."""
    done, crashed = parse(events)
    n_lanes = lanes(done, crashed)
    configs = len(done) if valid is True else 0
    ops = configs * n_lanes * OPS_PER_LANE
    words = 1 + math.ceil(n_lanes / 32) + 1
    n_bytes = 4 * (TABLE_WORDS_PER_OP * (len(done) + len(crashed))
                   + 2 * words)
    return ops, n_bytes


def least_seconds(ops: int, n_bytes: int) -> float:
    """The least time for the work on one H100: the larger of the
    operations over the int32 peak and the bytes over the HBM peak."""
    return max(ops / INT32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)
