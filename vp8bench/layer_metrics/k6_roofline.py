"""K6, the trellis: its share of its roofline, %. The least time of its
launches in the profiled tail (roofline/k6.py) over their measured
device time."""
ROOFLINE = "k6"


def read(ctx):
    return ctx.roofline_share("k6")
