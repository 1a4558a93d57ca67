"""Decoder API's wait for the card, ms per frame: the program's span
`dec.device_wait` (the frame's `ready` event synchronised) inside
`dec.get_frame`, over the window's frames."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    return PT.per_frame(ctx, "dec.device_wait")
