"""Stream-set straggler, ms per set: the program's span `gop.set_wait`,
from the first stream's frame on the host to the last one's
(`parallel/gop.py:StreamSetDecoder.decode`), over the window's sets."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    return PT.per_frame(ctx, "gop.set_wait")
