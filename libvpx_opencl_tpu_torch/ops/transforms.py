"""Batched integer transforms and quantizers (PyTorch).

Port of libvpx_opencl_tpu/ops/transforms.py. Decode half: dequant,
inverse WHT and inverse DCT for every 4x4 block of a frame in one pass of
tensor ops (vp8/common/idctllm.c, dequantize.c, idct_blk.c). Encode half:
forward DCT/WHT (vp8/encoder/dct.c) and the fast and regular quantizers
(vp8/encoder/quantize.c). There is no dependency between blocks, so this
stays plain PyTorch on either device.

All math is int32 with explicit int16 wrapping where the C code stores to
`short`; right shifts of negative values are arithmetic, as in C and JAX.
"""
import functools

import numpy as np
import torch

from . import tables as T

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


# ---------------------------------------------------------------------------
# batch forms ([..., 4, 4] blocks) used by the encoder

def idct4x4_batch(blocks):
    """vp8_short_idct4x4llm_c over [..., 4, 4] int32 dequantized
    coefficients; returns [..., 4, 4] int32 residual."""
    return idct4x4_lanes(blocks.unsqueeze(-1)).squeeze(-1)


def inv_walsh_batch(blocks):
    """vp8_short_inv_walsh4x4_c over [..., 4, 4] int32; returns [..., 16]
    DC values in block raster order."""
    x = blocks
    a1 = x[..., 0, :] + x[..., 3, :]
    b1 = x[..., 1, :] + x[..., 2, :]
    c1 = x[..., 1, :] - x[..., 2, :]
    d1 = x[..., 0, :] - x[..., 3, :]
    tmp = torch.stack([_s16(a1 + b1), _s16(c1 + d1),
                       _s16(a1 - b1), _s16(d1 - c1)], dim=-2)
    a1 = tmp[..., 0] + tmp[..., 3]
    b1 = tmp[..., 1] + tmp[..., 2]
    c1 = tmp[..., 1] - tmp[..., 2]
    d1 = tmp[..., 0] - tmp[..., 3]
    out = torch.stack([_s16((a1 + b1 + 3) >> 3), _s16((c1 + d1 + 3) >> 3),
                       _s16((a1 - b1 + 3) >> 3), _s16((d1 - c1 + 3) >> 3)],
                      dim=-1)
    return out.reshape(*out.shape[:-2], 16)


def fdct4x4_batch(blocks):
    """vp8_short_fdct4x4_c (dct.c:14-56) over [..., 4, 4] int32 residuals;
    returns [..., 4, 4] coefficients. Row pass then column pass."""
    x = blocks
    a1 = (x[..., :, 0] + x[..., :, 3]) << 3
    b1 = (x[..., :, 1] + x[..., :, 2]) << 3
    c1 = (x[..., :, 1] - x[..., :, 2]) << 3
    d1 = (x[..., :, 0] - x[..., :, 3]) << 3
    t1 = (c1 * 2217 + d1 * 5352 + 14500) >> 12
    t3 = (d1 * 2217 - c1 * 5352 + 7500) >> 12
    tmp = torch.stack([a1 + b1, t1, a1 - b1, t3], dim=-1)
    a1 = tmp[..., 0, :] + tmp[..., 3, :]
    b1 = tmp[..., 1, :] + tmp[..., 2, :]
    c1 = tmp[..., 1, :] - tmp[..., 2, :]
    d1 = tmp[..., 0, :] - tmp[..., 3, :]
    o0 = (a1 + b1 + 7) >> 4
    o2 = (a1 - b1 + 7) >> 4
    o1 = ((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0)
    o3 = (d1 * 2217 - c1 * 5352 + 51000) >> 16
    return torch.stack([o0, o1, o2, o3], dim=-2)


def walsh4x4_batch(dcs):
    """vp8_short_walsh4x4_c (dct.c:64-116) over [..., 16] Y-block DCs
    (raster); returns [..., 16] Y2 coefficients."""
    x = dcs.reshape(*dcs.shape[:-1], 4, 4)
    a1 = (x[..., :, 0] + x[..., :, 2]) << 2
    d1 = (x[..., :, 1] + x[..., :, 3]) << 2
    c1 = (x[..., :, 1] - x[..., :, 3]) << 2
    b1 = (x[..., :, 0] - x[..., :, 2]) << 2
    tmp = torch.stack([a1 + d1 + (a1 != 0), b1 + c1, b1 - c1, a1 - d1],
                      dim=-1)
    a1 = tmp[..., 0, :] + tmp[..., 2, :]
    d1 = tmp[..., 1, :] + tmp[..., 3, :]
    c1 = tmp[..., 1, :] - tmp[..., 3, :]
    b1 = tmp[..., 0, :] - tmp[..., 2, :]
    out = torch.stack([(v + (v < 0) + 3) >> 3
                       for v in (a1 + d1, b1 + c1, b1 - c1, a1 - d1)],
                      dim=-2)
    return out.reshape(*dcs.shape[:-1], 16)


_ZZ = [int(v) for v in np.asarray(T.ZIGZAG)]           # scan -> raster
_INV_ZZ = [int(v) for v in np.argsort(np.asarray(_ZZ))]  # raster -> scan
_ZBIN_BOOST = [0, 0, 8, 10, 12, 14, 16, 20, 24, 28, 32, 36, 40, 44, 44, 44]


@functools.lru_cache(maxsize=None)
def _boost_table(device):
    """Zero-run zbin boost table on `device` (uploaded once: a host-to-
    device copy inside a per-diagonal loop would stall the stream)."""
    return torch.tensor(_ZBIN_BOOST, dtype=torch.int32, device=device)


def _first0_mask(first0, y):
    """y with the blocks flagged by first0 (a bool, or a bool tensor
    broadcastable to y) set to 0."""
    if isinstance(first0, bool):
        return torch.zeros_like(y) if first0 else y
    return torch.where(first0, 0, y)


def _eob(levels):
    """1 + the last zig-zag scan index holding a non-zero level."""
    idx = torch.arange(1, 17, dtype=torch.int32, device=levels.device)
    return torch.where(levels[..., _ZZ] != 0, idx, 0).amax(-1) \
        .to(torch.int32)


def fast_quant_batch(coeffs, dq, first0):
    """vp8_fast_quantize_b_c (quantize.c:70-100) over [..., 16] raster
    coefficients. dq [..., 2] (dc, ac); first0 a bool or a [...] bool
    tensor (True = quantize from zig-zag position 1, the Y-with-Y2 case).
    Returns (levels[...,16],
    eob[...]) with levels clamped to the cat6 token range."""
    q16 = torch.full_like(dq, 1 << 16) // dq
    rnd = (48 * dq) >> 7
    is_ac = torch.arange(16, device=coeffs.device) != 0
    qv = torch.where(is_ac, q16[..., 1:2], q16[..., 0:1])
    rv = torch.where(is_ac, rnd[..., 1:2], rnd[..., 0:1])
    y = (((coeffs.abs() + rv) * qv) >> 16).clamp(max=2047)
    if not isinstance(first0, bool):
        first0 = first0[..., None]
    y = torch.cat([_first0_mask(first0, y[..., :1]), y[..., 1:]], -1)
    levels = torch.where(coeffs < 0, -y, y)
    return levels, _eob(levels)


def regular_quant_batch(coeffs, dq, qidx, first0):
    """vp8_regular_quantize_b_c (quantize.c:106-156) over [..., 16] raster
    coefficients: zbin dead zone with zero-run boost and the
    improved-quant reciprocal (vp8cx_init_quantizer, quantize.c:411-440).
    The zero-run carry is sequential along the zig-zag scan: a 16-step
    loop, each step vectorized over every block.

    dq [..., 2] (dc, ac); qidx [...] frame/segment Q (zbin factor 84
    below Q48 else 80); first0 a bool or a [...] bool tensor (Y-with-Y2:
    skip position 0).
    All int32, with int32 wrap-around in the reciprocal product as in C.
    Returns (levels [..., 16] raster, eob [...])."""
    dev = coeffs.device
    boost_tab = _boost_table(dev)
    zf = torch.where(qidx < 48, 84, 80).to(torch.int32)
    zbin = ((zf[..., None] * dq) + 64) >> 7                # [..., 2]
    rnd = (48 * dq) >> 7
    # improved reciprocal: shift = floor(log2(dq)), quant in (-2^16, 2^16)
    shift = torch.zeros_like(dq)
    for k in range(1, 10):
        shift = shift + (dq >= (1 << k))
    quant = 1 + (torch.full_like(dq, 1 << 16) << shift) // dq - (1 << 16)
    # everything but the dead-zone test is independent of the scan: the
    # candidate level of all 16 positions at once (raster position 0 = DC)
    is_ac = torch.arange(16, device=dev) != 0

    def per_coef(t):                                       # [..., 16]
        return torch.where(is_ac, t[..., 1:2], t[..., 0:1])

    x = coeffs.abs()
    xq = x + per_coef(rnd)
    cand = ((((xq * per_coef(quant)) >> 16) + xq) >> per_coef(shift)) \
        .clamp(max=2047)
    slack = x - per_coef(zbin)                 # hit <=> slack >= boost
    boost_ac = dq[..., 1]
    batch = torch.broadcast_shapes(cand.shape, slack.shape)[:-1]
    eob = torch.zeros(batch, dtype=torch.int32, device=dev)
    zrun = torch.zeros(batch, dtype=torch.int32, device=dev)
    scan = []
    for i in range(16):
        rc = _ZZ[i]
        boost = (boost_ac * boost_tab[zrun.clamp(max=15)]) >> 7
        y = torch.where(slack[..., rc] >= boost, cand[..., rc], 0)
        if i == 0:
            y = _first0_mask(first0, y)
        nz = y > 0
        scan.append(y)
        eob = torch.where(nz, i + 1, eob)
        zrun = torch.where(nz, 0, zrun + 1)
    mag = torch.stack(torch.broadcast_tensors(*scan), -1)[..., _INV_ZZ]
    levels = torch.where(coeffs < 0, -mag, mag)
    return levels, eob


def mbs_to_plane(blocks, R, C, bw):
    """[R*C, bw, bw] per-MB blocks -> [R*bw, C*bw] plane."""
    return blocks.reshape(R, C, bw, bw).permute(0, 2, 1, 3) \
        .reshape(R * bw, C * bw)
