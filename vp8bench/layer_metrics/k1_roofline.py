"""K1, the intra wavefront, in the decoder: its share of its roofline, %.
The least time of its launches in the profiled tail (roofline/k1.py)
over their measured device time."""
ROOFLINE = "k1"


def read(ctx):
    return ctx.roofline_share("k1")
