"""``prepass_share``: the share of the window's host wall covered by the
port's ``hb.prepass`` and ``constraints.prepass`` spans, in any thread
(their union)."""

from stats import covered

NAMES = ("hb.prepass", "constraints.prepass")


def read(ctx):
    spans = [s for s in ctx["spans"] if s[2] in NAMES]
    if not spans:
        return None
    lo = ctx["t_w0"]
    return covered(spans, lo, lo + ctx["window_s"]) / ctx["window_s"]
