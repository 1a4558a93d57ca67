"""Stages 1-2 of the decoder (residuals, motion compensation, the inter
reconstruction), ms per frame: the program's span `dec.inter` inside the
dispatch worker's `dec.enqueue`, over the window's frames. A program
without the span reads null."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    return PT.per_frame(ctx, "dec.inter")
