"""Quality metrics: PSNR and SSIM (the roles of vp8/encoder/psnr.c and
ssim.c — vp8_mse2psnr psnr.c:18, vp8_ssim_parms_16x16_c ssim.c:14)."""
from __future__ import annotations

import numpy as np


def mse2psnr(samples, sse, peak=255.0):
    """vp8_mse2psnr (psnr.c:18-36)."""
    if sse == 0:
        return 99.0  # summing short-circuit like the reference MAX_PSNR
    mse = sse / samples
    return min(99.0, 10.0 * np.log10(peak * peak / mse))


def frame_psnr(src, rec):
    """Per-plane + combined PSNR over (y, u, v) tuples, matching the
    generate_psnr_packet aggregation (onyx_if.c:2378-2422)."""
    sses = []
    samples = 0
    total_sse = 0.0
    out = {}
    for name, a, b in zip("yuv", src, rec):
        d = a.astype(np.float64) - b.astype(np.float64)
        sse = float((d * d).sum())
        out[name] = mse2psnr(a.size, sse)
        total_sse += sse
        samples += a.size
    out["all"] = mse2psnr(samples, total_sse)
    return out


def ssim_plane(a, b, c1=0.01 * 0.01 * 255 * 255 * 64,
               c2=0.03 * 0.03 * 255 * 255 * 64 * 64):
    """8x8-window SSIM in the reference's integer-parameterized form
    (ssim.c vp8_ssim_parms_8x8 + similarity)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    h, w = a.shape
    total = 0.0
    count = 0
    for i in range(0, h - 7, 4):
        for j in range(0, w - 7, 4):
            x = a[i:i + 8, j:j + 8]
            y = b[i:i + 8, j:j + 8]
            sx, sy = x.sum(), y.sum()
            sxx, syy, sxy = (x * x).sum(), (y * y).sum(), (x * y).sum()
            ssim_n = (2 * sx * sy + c1) * (64 * 2 * sxy - 2 * sx * sy + c2)
            ssim_d = (sx * sx + sy * sy + c1) * \
                (64 * sxx - sx * sx + 64 * syy - sy * sy + c2)
            total += ssim_n / ssim_d
            count += 1
    return total / max(1, count)
