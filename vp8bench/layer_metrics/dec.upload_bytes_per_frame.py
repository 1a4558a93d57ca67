"""Bytes uploaded per frame by the dispatch worker: the attribute `bytes`
of the program's span `dec.upload` (the per-MB table, the int16
coefficients, the inter-MB list, the SPLITMV lists, the MC taps when
first sent), over the window's frames."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    return PT.per_frame(ctx, "dec.upload", "bytes_per_frame")
