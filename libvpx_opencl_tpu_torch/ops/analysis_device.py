"""Device twins of the encoder's analysis kernels, in torch: whole-frame
full-pel match, ARNR temporal-filter accumulate, block variance, SSIM.

Port of libvpx_opencl_tpu/ops/analysis_device.py, which writes them as
plain XLA (no Pallas kernel), so here they are plain torch ops on tensors
of the caller's device. Roles in the reference: vp8_variance16x16
(vp8/encoder/variance_c.c), vp8_ssim_parms_8x8 (vp8/encoder/ssim.c:14),
vp8_temporal_filter_apply (vp8/encoder/temporal_filter.c:88-135), and the
pass-1/ARNR motion match (vp8/encoder/firstpass.c:481,
temporal_filter.c:139).

Every function but the SSIM is integer math and equals its host twin
(models/me_host.py, models/arnr.py) and the JAX function exactly; the
SSIM's similarity ratio is float32 in the JAX function's order of
operations (tests/test_torch_analysis.py).
"""
from __future__ import annotations

import torch


def edge_pad(plane, pad):
    """np.pad(plane, pad, mode="edge") for a 2-D tensor of any dtype."""
    H, W = plane.shape
    rows = torch.arange(-pad, H + pad, device=plane.device).clamp(0, H - 1)
    cols = torch.arange(-pad, W + pad, device=plane.device).clamp(0, W - 1)
    return plane[rows][:, cols]


def _block_sum(x, R, C, n=16):
    return x.reshape(R, n, C, n).sum((1, 3))


def fullpel_match_device(cur16, ref16, mc_range, step=2):
    """Twin of models/me_host.fullpel_match: step-`step` offset grid in
    the same order + per-MB +-1 refine, whole-plane abs-diff +
    non-overlapping 16x16 block sums, strict-less tie-breaking.

    cur16/ref16: [H, W] (multiples of 16) integer tensors on one device.
    Returns (dy, dx, sse, zsse) int32 [R, C] on that device."""
    H, W = cur16.shape
    R, C = H // 16, W // 16
    K = 2 * mc_range + 1
    cur = cur16.to(torch.int32)
    pi = edge_pad(ref16.to(torch.int32), mc_range)

    grid = list(range(-mc_range, mc_range + 1, step))
    if 0 not in grid:
        grid.append(0)
        grid.sort()
    best = bi = bj = None
    for dy in grid:
        for dx in grid:
            i, j = dy + mc_range, dx + mc_range
            sad = _block_sum((pi[i:i + H, j:j + W] - cur).abs(), R, C)
            if best is None:
                best = sad
                bi = torch.full((R, C), i, dtype=torch.int32,
                                device=cur.device)
                bj = torch.full_like(bi, j)
            else:
                better = sad < best
                best = torch.where(better, sad, best)
                bi = torch.where(better, i, bi)
                bj = torch.where(better, j, bj)

    # +-1 refine: per-MB offsets differ, gather 16x16 windows
    wins = pi.unfold(0, 16, 1).unfold(1, 16, 1)          # [.., .., 16, 16]
    rr = torch.arange(R, device=cur.device)[:, None] * 16
    cc = torch.arange(C, device=cur.device)[None, :] * 16
    base = cur.reshape(R, 16, C, 16).permute(0, 2, 1, 3)  # [R,C,16,16]

    def gather(ci, cj):
        return wins[(rr + ci).long(), (cc + cj).long()]

    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            ci = (bi + di).clamp(0, K - 1)
            cj = (bj + dj).clamp(0, K - 1)
            sad = (gather(ci, cj) - base).abs().sum((2, 3))
            better = sad < best
            best = torch.where(better, sad, best)
            bi = torch.where(better, ci, bi)
            bj = torch.where(better, cj, bj)

    # 16*16*255^2 < 2^31: the sums fit int32
    sse = ((base - gather(bi, bj)) ** 2).sum((2, 3), dtype=torch.int32)
    zsse = ((base - gather(mc_range, mc_range)) ** 2).sum(
        (2, 3), dtype=torch.int32)
    return bi - mc_range, bj - mc_range, sse, zsse


def temporal_filter_apply_device(base, pred, strength, weight, accum,
                                 count):
    """vp8_temporal_filter_apply_c (temporal_filter.c:88-135): per-pixel
    weights 16 - min((3*d^2 + 2^(s-1)) >> s, 16), scaled by the per-pixel
    match weight, accumulated into (accum, count). Returns new int32
    (accum, count)."""
    p = pred.to(torch.int32)
    d = p - base.to(torch.int32)
    mod = (d * d * 3 + (1 << (strength - 1))) >> strength
    mod = (16 - mod.clamp(max=16)) * weight.to(torch.int32)
    return accum + mod * p, count + mod


def temporal_filter_normalize_device(accum, count, base):
    """Rounded normalize (temporal_filter.c:668); zero-count pixels keep
    the anchor value. Returns uint8."""
    cnt1 = count.clamp(min=1)
    out = torch.div(accum + (cnt1 >> 1), cnt1, rounding_mode="floor")
    return torch.where(count > 0, out, base.to(out.dtype)).to(torch.uint8)


def variance_blocks_device(src, pred):
    """vp8_variance16x16 over every aligned MB at once
    (vp8/encoder/variance_c.c:81-106 role): (sse, var) int32 [R, C] with
    var = sse - floor(sum^2 / 256), computed in int64 (the JAX function's
    hi/lo split exists only because JAX has no int64 by default)."""
    H, W = src.shape
    R, C = H // 16, W // 16
    d = src.to(torch.int64) - pred.to(torch.int64)
    s = _block_sum(d, R, C)
    sse = _block_sum(d * d, R, C)
    var = sse - ((s * s) >> 8)
    return sse.to(torch.int32), var.to(torch.int32)


def ssim_plane_device(a, b):
    """8x8-window integer-parameterized SSIM (ssim.c vp8_ssim_parms_8x8 +
    similarity), averaged over windows stepped by 4 like vp8_ssim2
    (ssim.c:104-128). Window moment sums are exact integers (2x2 sums of
    disjoint 4x4 tile sums); the similarity ratio is float32 in the JAX
    function's order, with its c1 (0.01^2 * 255^2 * 64, not ssim.c's
    26634: the reference package's quirk, kept). Returns a 0-d float32
    tensor."""
    c1 = 0.01 * 0.01 * 255 * 255 * 64
    c2 = 0.03 * 0.03 * 255 * 255 * 64 * 64
    h, w = a.shape
    ny = (h - 8) // 4 + 1
    nx = (w - 8) // 4 + 1
    hh, ww = (ny + 1) * 4, (nx + 1) * 4
    ai = a.to(torch.int64)[:hh, :ww]
    bi = b.to(torch.int64)[:hh, :ww]

    def wins(x):
        t = _block_sum(x, hh // 4, ww // 4, 4)
        return (t[:ny, :nx] + t[1:ny + 1, :nx] +
                t[:ny, 1:nx + 1] + t[1:ny + 1, 1:nx + 1]).to(torch.float32)

    sa, sb = wins(ai), wins(bi)
    saa, sbb, sab = wins(ai * ai), wins(bi * bi), wins(ai * bi)
    ssim_n = (2.0 * sa * sb + c1) * (2.0 * (64.0 * sab - sa * sb) + c2)
    ssim_d = (sa * sa + sb * sb + c1) * \
        (64.0 * saa - sa * sa + 64.0 * sbb - sb * sb + c2)
    return (ssim_n / ssim_d).mean()
