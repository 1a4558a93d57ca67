"""Decoder API's readback, ms per frame: the program's span
`dec.readback_copy` (the visible planes cropped, concatenated and copied
to the host) inside `dec.get_frame`, over the window's frames."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    return PT.per_frame(ctx, "dec.readback_copy")
