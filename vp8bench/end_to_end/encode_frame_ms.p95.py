"""95th percentile over every frame of the window of the time from the
encode() call until get_cx_data() has returned the frame's packets."""
from vp8bench.harness.bench import p95


def value(window):
    return p95(window["latencies_s"]) * 1e3
