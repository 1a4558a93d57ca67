"""K1, the intra wavefront (`csrc/intra_wavefront.cu`): one launch per
decoded frame, through `ops/wavefront.py:intra_recon_planes`.

Least work: bytes, the intra flag of every MB (4 B) and, per intra MB,
its residual (384 int32), its parameter row (20 int32) and its 384 output
pixels, each read or written once (chip_smoke.py's bound). Instructions
are not counted (0): no sourced floor on what its predictors must issue,
and by chip_smoke.py's operation estimate the kernel is bound by bytes.
"""
TARGET = "libvpx_opencl_tpu_torch.ops.wavefront:intra_recon_planes"
KERNEL = "intra_rowlag_kernel"
INTRA_COLS = 20        # mode, uv_mode, intra, -, 16 sub-block modes


def capture(args, kwargs):
    """(R, C, params): params [N, >= INTRA_COLS] int32, the launch's
    parameter rows (col 0 mode, col 2 intra flag)."""
    return args[0], args[1], args[8] if len(args) > 8 else kwargs["params"]


def work(rec):
    """(bytes, 32-bit integer lane instructions) of one launch."""
    R, C, params = rec
    intra = params[:, 2] != 0
    ni = int(intra.sum())
    return (R * C * 4 + ni * (384 * 4 + INTRA_COLS * 4 + 384),
            0)
