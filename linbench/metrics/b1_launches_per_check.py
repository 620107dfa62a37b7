"""``b1_launches_per_check``: launches of the CUDA level loop in the
window, both forms (the port's ``level_kernel.LAUNCHES_BY_FORM``), per
check.  ``GRID_LAUNCHES`` splits the same grid launches by rung, so it
is not added again."""


def read(ctx):
    return ctx["counters"]["launches"] / len(ctx["checks"])
