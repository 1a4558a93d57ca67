"""95th percentile over every frame of the window of the time from the
decode() call until get_frame() has returned the frame's host planes."""
from vp8bench.harness.bench import p95


def value(window):
    return p95(window["latencies_s"]) * 1e3
