"""Encoder decision on the card, ms per frame: the card's busy time
(the union of its operations' intervals in the profiled tail) inside the
program's span `enc.decision`, placed on the profiler's timeline by
harness/program_trace.py, over the tail's frames. Beside the decision's
host time it says how much of it the card works. The `enc.decision`
wrapper's synchronize() brackets, on in a traced run, add idle time to the
span but no busy time. Null without device operations."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    return PT.device_ms_inside(ctx, "enc.decision")
