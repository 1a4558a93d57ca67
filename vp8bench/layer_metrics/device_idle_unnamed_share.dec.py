"""Device idle time that no stage span names, %: of the profiled tail's
device-idle time, the part in which no program span but a frame's root
is open on any thread (program spans placed on the profiler's timeline by
harness/program_trace.py), time-weighted. Null without device
operations."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    return PT.idle_unnamed_share(ctx)
