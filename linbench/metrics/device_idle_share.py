"""``device_idle_share``: 1 minus the union of the device's activity in
the profiler's trace of the window, over the window."""


def read(ctx):
    dev = ctx["device"]
    if dev is None:
        return None
    return 1.0 - dev["busy_s"] / ctx["window_s"]
