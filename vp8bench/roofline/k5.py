"""K5, the encode wavefront (`csrc/encode_wavefront.cu`): one launch per
encoded frame for its intra MBs, through `models/wavefront.py:_k5_launch`.

Least work: bytes, the parameter row of every MB (10 int32) and, per
intra MB, its source (384 int32), its neighbours' 71 pixels, its 384
output pixels and its levels and eobs (425 int32), and 16 sub-block modes
per B_PRED MB, each read or written once (chip_smoke.py's bound).
Instructions are not counted (0): no sourced floor on what its predict,
transform and quantize chain must issue.
"""
TARGET = "libvpx_opencl_tpu_torch.models.wavefront:_k5_launch"
KERNEL = "encode_rowlag_kernel"
ENC_COLS = 10          # mode, uv_mode, intra, qidx, 3 dequantizer pairs
B_PRED = 4


def capture(args, kwargs):
    """(R, C, params): params [N, ENC_COLS] int32 (col 0 mode, col 2
    intra flag)."""
    return args[0], args[1], args[5]


def work(rec):
    R, C, params = rec
    intra = params[:, 2] != 0
    ni = int(intra.sum())
    nb = int((intra & (params[:, 0] == B_PRED)).sum())
    return (R * C * ENC_COLS * 4 + ni * (384 * 4 + 71 + 384 + 425 * 4)
            + nb * 16 * 4,
            0)
