"""Share of the window's frames whose stages 1-2 ran as the one kernel
launch, %: the attribute `kernel` (1 for the launch, 0 for the plain torch
ops) of the program's span `dec.inter`, summed over the window's frames.
A program without the span reads null."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    v = PT.per_frame(ctx, "dec.inter", "kernel_per_frame")
    return None if v is None else 100.0 * v
