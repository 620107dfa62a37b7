"""``confirm_share``: the share of the window's host wall spent in the
re-check of invalid verdicts, their host confirmation and their report
(``probes.py``'s timers named in ``CONFIRM``, their union).  Nothing to
read in a window with no invalid verdict."""

from probes import CONFIRM
from stats import covered


def read(ctx):
    spans = [p for p in ctx["probes"] if p[2] in CONFIRM]
    if not spans:
        return None
    lo = ctx["t_w0"]
    return covered(spans, lo, lo + ctx["window_s"]) / ctx["window_s"]
