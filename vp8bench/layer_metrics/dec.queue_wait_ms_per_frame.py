"""Dispatch worker's queue wait, ms per frame: the program's span
`dec.queue_wait`, from the entropy thread's hand-off of a frame to the
moment the worker starts it (the interpreter lock's hand-over included),
over the window's frames."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    return PT.per_frame(ctx, "dec.queue_wait")
