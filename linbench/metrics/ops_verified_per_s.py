"""``ops_verified_per_s``: the history operations of every check that
reached a decided verdict in the window, over the window's whole time
(up to the return of the check in flight at its end)."""


def read(ctx):
    return sum(c["ops"] for c in ctx["decided"]) / ctx["window_s"]
