"""K5, the encode wavefront: its share of its roofline, %. The least time
of its launches in the profiled tail (roofline/k5.py) over their
measured device time."""
ROOFLINE = "k5"


def read(ctx):
    return ctx.roofline_share("k5")
