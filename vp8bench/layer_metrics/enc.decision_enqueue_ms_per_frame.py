"""Encoder decision's host time less its waits for the card, ms per frame:
the self time of the program's span `enc.decision` (its length less its
`enc.host_wait` children), the time the host spends enqueueing the
decision's work, over the window's frames. A traced run reads it with the
benchmark's `enc.decision` wrapper on, which brackets `_decide_*_fn` with
synchronize(): the wait for the decision's outputs then falls in the
wrapper's trailing synchronize, inside this span's self time."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    return PT.per_frame(ctx, "enc.decision", "self_ms_per_frame")
