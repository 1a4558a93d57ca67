"""K3, the SAD grid of the motion search: its share of its roofline, %. The
least time of its launches in the profiled tail (roofline/k3.py) over
their measured device time."""
ROOFLINE = "k3"


def read(ctx):
    return ctx.roofline_share("k3")
