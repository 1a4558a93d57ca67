"""Device idle share, %: the part of the profiled tail in which no card
ran any device operation (busy time as the union of every card's
operations' intervals)."""


def read(ctx):
    return ctx.idle_share()
