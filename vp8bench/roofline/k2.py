"""K2, the loop-filter wavefront (`csrc/lf_wavefront.cu`): one launch per
frame in the decoder and in the encoder, through
`ops/wavefront.py:loop_filter_planes`.

Least work: bytes, a 4-byte level per MB and, per MB with a level above
0, its parameter row (8 int32) and its 384 pixels read and written once
(chip_smoke.py's bound). Instructions are not counted (0): no sourced
floor on what its edge filters must issue.
"""
TARGET = "libvpx_opencl_tpu_torch.ops.wavefront:loop_filter_planes"
KERNEL = "lf_rowlag_kernel"
LF_COLS = 8            # flevel, mblim, blim, lim, hev, noskip, -, -


def capture(args, kwargs):
    """(R, C, params): params [N, >= 6] int32, col 0 the filter level."""
    return args[0], args[1], args[6] if len(args) > 6 else kwargs["params"]


def work(rec):
    R, C, params = rec
    na = int((params[:, 0] > 0).sum())
    return (R * C * 4 + na * (LF_COLS * 4 + 2 * 384),
            0)
