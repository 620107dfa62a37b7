"""The device's side of a traced window, read from a ``torch.profiler``
trace: activity intervals, their union, kernel time by name and the idle
gaps between them.

The profiler records device activity only (kernels, copies, sets).  A
marker kernel is launched on an idle card just before the window and
just after it, so the first and the last device event of the trace are
the markers: the window in the device's clock lies between them, and
the first marker's launch gives the offset between the host's clock and
the device's.

The device-time reading follows ``chip_smoke.py``'s ``_grid_split``
(``chip_smoke.py:1404-1444``), which sums the ``level_loop`` kernels'
device time from the profiler; the union of intervals is this file's
own, replacing the span-based ``device_idle_fraction``.
"""

from __future__ import annotations

import time

#: cycles of the marker kernel (a few microseconds on an H100)
MARKER_CYCLES = 2000


def start():
    """Start a device-only profiler after a marker; returns
    ``(profiler, host time of the marker's launch)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(MARKER_CYCLES)
    return prof, t


def stop(prof) -> None:
    """Close the window with the second marker and stop the profiler."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)


def device_events(prof) -> list[tuple[float, float, str]]:
    """Every device activity of the trace as ``(start, end, name)`` in
    seconds of the device's clock, in start order."""
    from torch.autograd import DeviceType

    out = []
    try:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns() / 1e9
                out.append((s, s + e.duration_ns() / 1e9, e.name()))
    except (AttributeError, RuntimeError):
        out = []
    if not out:
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                out.append((e.time_range.start / 1e6,
                            e.time_range.end / 1e6, e.name))
    out.sort()
    return out


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end, ...)`` intervals as disjoint sorted
    ``(start, end)`` pairs."""
    merged: list[list[float]] = []
    for iv in sorted(intervals):
        s, e = iv[0], iv[1]
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def read(prof, host_t0: float) -> dict | None:
    """The window's device side: ``busy_s`` (the union of activity
    between the markers), ``by_name`` (seconds per kernel name),
    ``gaps`` (idle intervals in host ``perf_counter`` seconds, longest
    first) and ``offset`` (device clock minus host clock).  None where
    the trace holds no device activity besides the markers."""
    ev = device_events(prof)
    if len(ev) < 3:
        return None
    first, last, body = ev[0], ev[-1], ev[1:-1]
    lo, hi = first[1], last[0]
    body = [(max(s, lo), min(e, hi), n) for s, e, n in body if e > lo
            and s < hi]
    busy = union(body)
    by_name: dict = {}
    for s, e, n in body:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    offset = first[0] - host_t0
    gaps = []
    t = lo
    for s, e in busy:
        if s > t:
            gaps.append((t - offset, s - offset))
        t = max(t, e)
    if hi > t:
        gaps.append((t - offset, hi - offset))
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"busy_s": sum(e - s for s, e in busy), "by_name": by_name,
            "gaps": gaps, "offset": offset, "device_window_s": hi - lo}
