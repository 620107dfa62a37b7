"""Arithmetic the metric readers share."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-quantile of all ``values``."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def covered(intervals, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` that the union of ``(start, end, ...)``
    intervals covers."""
    total = 0.0
    end = lo
    for iv in sorted((max(i[0], lo), min(i[1], hi)) for i in intervals):
        s, e = iv
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total
