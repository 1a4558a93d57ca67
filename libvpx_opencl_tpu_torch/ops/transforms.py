"""Batched integer inverse transforms for the decode path (PyTorch).

Port of the decode half of libvpx_opencl_tpu/ops/transforms.py: dequant,
inverse WHT and inverse DCT for every 4x4 block of a frame in one pass of
tensor ops (vp8/common/idctllm.c, dequantize.c, idct_blk.c). There is no
dependency between blocks, so this stays plain PyTorch on either device.

All math is int32 with explicit int16 wrapping where the C code stores to
`short`; right shifts of negative values are arithmetic, as in C and JAX.
"""
import torch

COSPI8SQRT2MINUS1 = 20091
SINPI8SQRT2 = 35468


def _s16(v):
    """Wrap int32 to the int16 range (C short store)."""
    return ((v + 32768) & 0xFFFF) - 32768


def idct4x4_lanes(x):
    """vp8_short_idct4x4llm_c (idctllm.c:28-119) with the block index in
    the last axis: x [..., 4, 4, N] int32 -> [..., 4, 4, N] residual."""
    def butterfly(i0, i1, i2, i3):
        a1 = i0 + i2
        b1 = i0 - i2
        c1 = ((i1 * SINPI8SQRT2) >> 16) - (i3 + ((i3 * COSPI8SQRT2MINUS1)
                                                 >> 16))
        d1 = (i1 + ((i1 * COSPI8SQRT2MINUS1) >> 16)) + \
            ((i3 * SINPI8SQRT2) >> 16)
        return a1, b1, c1, d1

    # vertical pass (C first loop: columns)
    a1, b1, c1, d1 = butterfly(x[..., 0, :, :], x[..., 1, :, :],
                               x[..., 2, :, :], x[..., 3, :, :])
    tmp = torch.stack([_s16(a1 + d1), _s16(b1 + c1),
                       _s16(b1 - c1), _s16(a1 - d1)], dim=-3)
    # horizontal pass (C second loop: rows)
    a1, b1, c1, d1 = butterfly(tmp[..., 0, :], tmp[..., 1, :],
                               tmp[..., 2, :], tmp[..., 3, :])
    return torch.stack([_s16((a1 + d1 + 4) >> 3), _s16((b1 + c1 + 4) >> 3),
                        _s16((b1 - c1 + 4) >> 3), _s16((a1 - d1 + 4) >> 3)],
                       dim=-2)


def inv_walsh_lanes(x):
    """vp8_short_inv_walsh4x4_c (idctllm.c:140-192) with lanes last:
    x [4, 4, N] -> [16, N] DC values in block raster order."""
    a1 = x[0] + x[3]
    b1 = x[1] + x[2]
    c1 = x[1] - x[2]
    d1 = x[0] - x[3]
    tmp = torch.stack([_s16(a1 + b1), _s16(c1 + d1),
                       _s16(a1 - b1), _s16(d1 - c1)], dim=0)
    a1 = tmp[:, 0] + tmp[:, 3]
    b1 = tmp[:, 1] + tmp[:, 2]
    c1 = tmp[:, 1] - tmp[:, 2]
    d1 = tmp[:, 0] - tmp[:, 3]
    out = torch.stack([_s16((a1 + b1 + 3) >> 3), _s16((c1 + d1 + 3) >> 3),
                       _s16((a1 - b1 + 3) >> 3), _s16((d1 - c1 + 3) >> 3)],
                      dim=1)
    return out.reshape(16, -1)


def compute_residual_blocks(qcoeff, y2_big, dq_y1, dq_y2, dq_uv, has_y2):
    """Whole-frame dequant + WHT + IDCT (decodframe.c:247-305).

    qcoeff [N,25,16] int (raster coefficient order); y2_big [N] bool
    (eobs[24] > 1 selects the full WHT over the dc-only variant); dq_* [N,2]
    (dc, ac) per-MB dequant factors; has_y2 [N] bool. Returns MB images
    y [N,16,16], u/v [N,8,8] int32 on qcoeff's device.
    """
    n = qcoeff.shape[0]
    qt = qcoeff.to(torch.int32).permute(1, 2, 0)           # [25, 16, N]
    dq_y1 = dq_y1.to(torch.int32).T                        # [2, N]
    dq_y2 = dq_y2.to(torch.int32).T
    dq_uv = dq_uv.to(torch.int32).T
    ac = (torch.arange(16, device=qcoeff.device) != 0)[:, None]

    def dq_vec(dq):                                        # [16, N]
        return torch.where(ac, dq[1][None], dq[0][None])

    # --- Y2 ---
    y2 = _s16(qt[24] * dq_vec(dq_y2))
    wht_full = inv_walsh_lanes(y2.reshape(4, 4, n))
    dc1 = _s16((_s16(qt[24, 0] * dq_y2[0]) + 3) >> 3)
    wht = torch.where(y2_big[None, :], wht_full, dc1[None, :])
    # --- Y ---
    dq_y = _s16(qt[:16] * dq_vec(dq_y1)[None])             # [16, 16, N]
    dc = torch.where(has_y2[None, :], wht, dq_y[:, 0])
    dq_y = torch.cat([dc[:, None], dq_y[:, 1:]], dim=1)
    ry = idct4x4_lanes(dq_y.reshape(16, 4, 4, n))
    # --- UV ---
    uvq = _s16(qt[16:24] * dq_vec(dq_uv)[None])
    ruv = idct4x4_lanes(uvq.reshape(8, 4, 4, n))

    def to_mb(x, g):
        # [blk, 4, 4, N] with blk = by*g+bx -> [N, g*4, g*4]
        b = x.reshape(g, g, 4, 4, n)
        return b.permute(4, 0, 2, 1, 3).reshape(n, g * 4, g * 4)

    return to_mb(ry, 4), to_mb(ruv[:4], 2), to_mb(ruv[4:], 2)
