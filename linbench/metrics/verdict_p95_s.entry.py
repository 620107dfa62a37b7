"""``verdict_p95_s.entry``: the 95th percentile of time to verdict over
every check of the window, one sample a check, from the call to its
return.  A per-layer metric: a window holds tens of checks, too few for
a tail to stand as an end-to-end metric."""

from stats import percentile


def read(ctx):
    return percentile([c["seconds"] for c in ctx["checks"]], 0.95)
