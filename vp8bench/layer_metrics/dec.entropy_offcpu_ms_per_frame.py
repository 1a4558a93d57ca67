"""Host entropy thread off its CPU, ms per frame: the wall time of the
program's root span `dec.decode` less the thread's CPU time in it (the
interpreter lock, preemption, waits), over the window's frames."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    wall = PT.per_frame(ctx, "dec.decode")
    cpu = PT.per_frame(ctx, "dec.decode", "cpu_ms_per_frame")
    return None if wall is None or cpu is None else wall - cpu
