"""One stream's frame on its group thread, ms per stream frame: the
program's span `gop.stream` (decode and readback of one stream's frame)
per set, over the streams per set (its calls over `gop.set`'s)."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    s = PT.window_summary(ctx)
    if not s or "gop.stream" not in s or "gop.set" not in s:
        return None
    streams = s["gop.stream"]["calls"] / s["gop.set"]["calls"]
    return s["gop.stream"]["ms_per_frame"] / streams
