"""Decoder API's wait for the dispatch worker, ms per frame: the program's
span `dec.join_wait` (`FrameFuture` waiting on the worker's upload and
enqueue) inside `dec.get_frame`, over the window's frames."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    return PT.per_frame(ctx, "dec.join_wait")
