"""Encoder's host waits for the card, ms per frame: every program span
`enc.host_wait` (the reads of the decision's and the encode wavefront's
outputs, K3's argument check, K5's flags, the trellis' inter list, the
blocking B_PRED table upload), over the window's frames. A traced run reads
it with the benchmark's `enc.decision` and `enc.host_pack` wrappers on,
whose synchronize() brackets take up the wait for the decision's outputs:
there it counts the other waits."""
from vp8bench.harness import program_trace as PT


def read(ctx):
    return PT.per_frame(ctx, "enc.host_wait")
