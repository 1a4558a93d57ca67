"""Host entropy threads off their CPU, ms per stream frame: the wall time
of the streams' `dec.decode` spans less their threads' CPU time in them
(the interpreter lock, core contention, waits), per set, over the
streams per set (`dec.decode`'s calls over `gop.set`'s)."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    s = PT.window_summary(ctx)
    if not s or "dec.decode" not in s or "gop.set" not in s:
        return None
    d = s["dec.decode"]
    if "cpu_ms_per_frame" not in d:
        return None
    streams = d["calls"] / s["gop.set"]["calls"]
    return (d["ms_per_frame"] - d["cpu_ms_per_frame"]) / streams
