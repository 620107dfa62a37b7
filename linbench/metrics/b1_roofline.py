"""``b1_roofline``: the least time the window's device searches need on
one H100 (``roofline.py``: the work counted from the histories of the
keys a device engine proved linearizable), over the device time of the
``level_loop`` kernels in the profiler's trace, in percent.  Nothing to
read where no such kernel ran or no device engine decided a key."""

from roofline import least_seconds, work


def _keyed_events(events):
    by_key: dict = {}
    for e in events:
        if len(e) > 4:
            by_key.setdefault(e[4], []).append(e)
    return by_key


def read(ctx):
    dev = ctx["device"]
    if dev is None:
        return None
    kernel_s = sum(s for n, s in dev["by_name"].items() if "level_loop" in n)
    if kernel_s <= 0:
        return None
    ops = n_bytes = 0
    split: dict = {}
    for c in ctx["checks"]:
        events = ctx["pool"][c["pool_index"]]["events"]
        for k, engine in c["engines"].items():
            if not ctx["is_device_engine"](engine):
                continue
            if k is None:
                ev = events
            else:
                i = c["pool_index"]
                if i not in split:
                    split[i] = _keyed_events(events)
                ev = split[i][k]
            o, b = work(ev, c["verdicts"].get(k))
            ops += o
            n_bytes += b
    if not n_bytes:
        return None
    return 100.0 * least_seconds(ops, n_bytes) / kernel_s
