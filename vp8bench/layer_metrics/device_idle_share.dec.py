"""Device idle share, %: the part of the profiled tail in which no device
operation ran (busy time as the union of the operations' intervals)."""


def read(ctx):
    return ctx.idle_share()
