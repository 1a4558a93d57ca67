"""K2, the loop-filter wavefront, in the decoder: its share of its
roofline, %. The least time of its launches in the profiled tail
(roofline/k2.py) over their measured device time."""
ROOFLINE = "k2"


def read(ctx):
    return ctx.roofline_share("k2")
