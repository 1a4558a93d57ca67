"""Frame scalers (vpx_scale re-design).

The reference ships two scaler families: the generic bicubic scaler
(vpx_scale/generic/bicubic_scaler.c — Catmull-Rom taps, separable
two-pass with a fixed-point horizontal buffer) and the hardcoded-ratio
polyphase scalers (vpx_scale/generic/gen_scalers.c: 4-to-5, 3-to-5,
1-to-2, ...).  Both are display/preprocess-side (non-normative), so this
re-design keeps the same separable Catmull-Rom math but vectorizes each
pass as whole-plane gathers + tap blends instead of per-pixel loops —
one [H, W] x [4 taps] weighted sum per axis, which XLA/numpy fuse.
"""
from __future__ import annotations

import numpy as np


def _catmull_rom_weights(t):
    """Catmull-Rom kernel at phase t in [0,1) for taps [-1, 0, 1, 2]
    (bicubic_scaler.c:30-62 c0..c3 polynomial)."""
    t2, t3 = t * t, t * t * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return w0, w1, w2, w3


def _scale_axis(plane, out_n, axis):
    """Separable bicubic along one axis (the reference's horizontal /
    vertical passes, bicubic_scaler.c:120-230)."""
    n = plane.shape[axis]
    if out_n == n:
        return plane.astype(np.float64) if plane.dtype != np.float64 \
            else plane
    # source sampling positions, edge-clamped (the reference replicates
    # border pixels into its work buffer)
    pos = (np.arange(out_n) + 0.5) * n / out_n - 0.5
    i0 = np.floor(pos).astype(np.int64)
    t = pos - i0
    w = _catmull_rom_weights(t)
    idx = [np.clip(i0 + k, 0, n - 1) for k in (-1, 0, 1, 2)]
    src = plane.astype(np.float64)
    out = sum(wk[(slice(None),) if axis == 1 else (slice(None), None)]
              * np.take(src, ik, axis=axis)
              for wk, ik in zip(w, idx))
    return out


def bicubic_scale_plane(plane, out_h, out_w):
    """vp8_bicubic_scale (bicubic_scaler.c:304-343): separable two-pass
    resample of one uint8 plane to (out_h, out_w)."""
    tmp = _scale_axis(plane, out_w, axis=1)
    out = _scale_axis(tmp, out_h, axis=0)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def scale_frame(y, u, v, out_w, out_h):
    """vpx_scale_frame role: scale a YV12 triple; chroma at half dims
    (rounded up, matching the frame-buffer layout)."""
    return (bicubic_scale_plane(y, out_h, out_w),
            bicubic_scale_plane(u, (out_h + 1) // 2, (out_w + 1) // 2),
            bicubic_scale_plane(v, (out_h + 1) // 2, (out_w + 1) // 2))
