"""Post-processing filters (vp8/common/postproc.c TPU re-design).

Display-side (non-normative) filters, vectorized as whole-plane array ops:
  * deblock: vp8_post_proc_down_and_across (postproc.c:132-230) — the
    5-tap conditional convolution. The reference's across pass delays
    writes by two columns through a ring buffer, which makes it a pure
    function of the down-pass output — both passes vectorize exactly.
  * demacroblock: vp8_mbpost_proc_{down,across_ip} (postproc.c:230-330) —
    variance-gated smoothing with a running-window feedback; the row
    recursion is expressed as a lax.scan (the reference seeds its dither
    from rand(); we use a fixed seed for reproducibility).
  * add_noise: vp8_plane_add_noise (postproc.c:489) with a deterministic
    generator.
  * q2mbl / deblock strength mapping (postproc.c:283,348-362).
  * mfqe_frame: vp8_multiframe_quality_enhance (postproc.c:802-899),
    vectorized block-wise temporal blending.
  * debug_overlay: the CLR_BLK_MODES / CLR_FRM_REF_BLKS visualizations
    (vp8.h:44-47) as per-MB chroma tints.
"""
from __future__ import annotations

import numpy as np

KERNEL5 = np.array([1, 1, 4, 1, 1], np.int32)


def ppl_from_q(q):
    """deblocking strength from quantizer (vp8_deblock postproc.c:354)."""
    level = 6.0e-05 * q ** 3 - .0067 * q * q + .306 * q + .0065
    return int(level + 0.5)


def q2mbl(x):
    """postproc.c:283-289."""
    x = max(x, 20)
    x = 50 + (x - 50) * 10 // 8
    return x * x // 3


def deblock_plane(plane, flimit):
    """vp8_post_proc_down_and_across over one uint8 plane [H, W]."""
    src = plane.astype(np.int32)
    h, w = src.shape
    # down pass (vertical 5-tap, gated per-tap by |v - tap| > flimit)
    padded = np.pad(src, ((2, 2), (0, 0)), mode="edge")
    taps = [padded[i:i + h, :] for i in range(5)]
    center = src
    ok = np.ones_like(center, bool)
    acc = np.full_like(center, 4)
    for k, t in zip(KERNEL5, taps):
        ok &= np.abs(center - t) <= flimit
        acc += k * t
    down = np.where(ok, acc >> 3, center)
    # across pass on the down output (edge-replicated by 8 in the ref;
    # 2-tap reach means edge mode suffices)
    padded = np.pad(down, ((0, 0), (2, 2)), mode="edge")
    taps = [padded[:, i:i + w] for i in range(5)]
    center = down
    ok = np.ones_like(center, bool)
    acc = np.full_like(center, 4)
    for k, t in zip(KERNEL5, taps):
        ok &= np.abs(center - t) <= flimit
        acc += k * t
    across = np.where(ok, acc >> 3, center)
    return np.clip(across, 0, 255).astype(np.uint8)


def deblock(y, u, v, q):
    ppl = ppl_from_q(q)
    return deblock_plane(y, ppl), deblock_plane(u, ppl), deblock_plane(v, ppl)


def demacroblock_plane(plane, q, seed=0):
    """vp8_mbpost_proc_down-style variance-gated smoothing (column pass).

    Running 16-tap window with write-back feedback, vectorized across
    columns; scan over rows."""
    flimit = q2mbl(q)
    rng = np.random.RandomState(seed)
    rv = rng.randint(-4, 5, size=(plane.shape[1], 128)).astype(np.int32)
    src = plane.astype(np.int32)
    h, w = src.shape
    buf = np.pad(src, ((8, 17), (0, 0)), mode="edge")
    out = buf.copy()
    sumsq = (buf[0:15] ** 2).sum(axis=0)
    ssum = buf[0:15].sum(axis=0)
    for r in range(h):
        i = r + 8  # position of current row in buf
        sumsq = sumsq + out[i + 7] ** 2 - out[i - 8] ** 2
        ssum = ssum + out[i + 7] - out[i - 8]
        gated = sumsq * 15 - ssum * ssum < flimit
        filt = (rv[np.arange(w), r & 127] + ssum + out[i]) >> 4
        out[i] = np.where(gated, filt, out[i])
    return np.clip(out[8:8 + h], 0, 255).astype(np.uint8)


def add_noise(plane, noise_level, seed=0):
    """vp8_plane_add_noise (postproc.c:489) with a deterministic
    gaussian-ish charmap."""
    rng = np.random.RandomState(seed)
    noise = np.clip(rng.normal(0, noise_level, plane.shape), -31, 31) \
        .astype(np.int32)
    return np.clip(plane.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def _block_view(plane, bs):
    """[H,W] -> [H//bs, W//bs, bs, bs] (MB-aligned input)."""
    h, w = plane.shape
    return plane.reshape(h // bs, bs, w // bs, bs).swapaxes(1, 2)


def _mfqe_pass(cur, dest, gate, qdiff, qprev, bs):
    """Blend cur into dest per bs×bs luma block where gate holds
    (multiframe_quality_enhance_block, postproc.c:695-799, vectorized).
    cur/dest: (y, u, v) MB-aligned uint8 planes; gate: [R, C] per-block
    bool at the luma-bs granularity. Returns new dest planes."""
    cy, cu, cv = (p.astype(np.int32) for p in cur)
    dy, du, dv = (p.astype(np.int32) for p in dest)
    by, dby = _block_view(cy, bs), _block_view(dy, bs)
    shift = {16: 8, 8: 6}[bs]
    rnd = 1 << (shift - 1)
    n = bs * bs
    s = dby.sum(axis=(2, 3))
    ss = (dby * dby).sum(axis=(2, 3))
    act = ((ss - s * s // n) + rnd) >> shift          # vp8_variance vs 0
    sad = (np.abs(by - dby).sum(axis=(2, 3)) + rnd) >> shift
    # thr = qdiff/8 + log2(act) + log4(qprev)
    thr = np.full(act.shape, qdiff >> 3, np.int32)
    thr += np.where(act > 0, np.floor(np.log2(np.maximum(act, 1))), 0) \
        .astype(np.int32)
    qp = qprev
    while qp >= 4:
        thr += 1
        qp >>= 2
    thr = np.maximum(thr, 1)
    sad_ok = gate & (sad < thr)
    ifactor = (sad << MFQE_PRECISION) // thr
    if qdiff >> 5:
        ifactor >>= (qdiff >> 5)
    blend = sad_ok & (ifactor > 0)
    keep = sad_ok & (ifactor == 0)   # ydp untouched: previous output
    icfactor = (1 << MFQE_PRECISION) - ifactor
    ro = 1 << (MFQE_PRECISION - 1)

    def mix(c, d, lbs):
        bv_c, bv_d = _block_view(c, lbs), _block_view(d, lbs)
        i_f = ifactor[:, :, None, None]
        ic_f = icfactor[:, :, None, None]
        mixed = (bv_c * i_f + bv_d * ic_f + ro) >> MFQE_PRECISION
        sel = np.where(blend[:, :, None, None], mixed,
                       np.where(keep[:, :, None, None], bv_d, bv_c))
        h, w = c.shape
        return sel.swapaxes(1, 2).reshape(h, w)

    # every non-blend case except ifactor==0 copies the current frame in
    # (the reference's vp8_copy_mem fallthroughs)
    ny = mix(cy, dy, bs)
    nu = mix(cu, du, bs // 2)
    nv = mix(cv, dv, bs // 2)
    return (np.clip(ny, 0, 255).astype(np.uint8),
            np.clip(nu, 0, 255).astype(np.uint8),
            np.clip(nv, 0, 255).astype(np.uint8))


MFQE_PRECISION = 4  # postproc.c:32


def mfqe_frame(cur, prev_out, qcurr, qprev, mode, mv, keyframe):
    """vp8_multiframe_quality_enhance (postproc.c:802-899): temporal
    blend of the newly decoded frame with the previous enhanced output,
    gated per MB by motion magnitude and a SAD/activity threshold.

    cur/prev_out: (y, u, v) uint8 planes (same shape, MB-aligned or not —
    ragged edges are processed at whatever granularity fits); mode/mv:
    the decoder's padded [R+1, C+1] grids. Returns enhanced planes."""
    from ..models.refdec import B_PRED, SPLITMV
    y, u, v = cur
    h, w = y.shape
    R, C = h // 16, w // 16
    if R == 0 or C == 0:
        return cur
    ha, wa = R * 16, C * 16
    cur_a = (y[:ha, :wa], u[:ha // 2, :wa // 2], v[:ha // 2, :wa // 2])
    prev_a = (prev_out[0][:ha, :wa], prev_out[1][:ha // 2, :wa // 2],
              prev_out[2][:ha // 2, :wa // 2])
    m = mode[1:R + 1, 1:C + 1]
    mvg = mv[1:R + 1, 1:C + 1]
    low_motion = keyframe | ((np.abs(mvg[..., 0]) <= 10) &
                             (np.abs(mvg[..., 1]) <= 10))
    qdiff = qcurr - qprev
    split = (m == B_PRED) | (m == SPLITMV)
    # 16x16 pass for non-split MBs, 8x8 pass for split MBs
    gate16 = low_motion & ~split
    out = _mfqe_pass(cur_a, prev_a, gate16, qdiff, qprev, 16)
    gate8 = np.repeat(np.repeat(low_motion & split, 2, 0), 2, 1)
    # blocks already handled by the 16 pass must keep their result: the
    # 8 pass gates them out and copies `cur`... so feed it `out` as cur
    out = _mfqe_pass(out, prev_a, gate8, qdiff, qprev, 8)
    oy, ou, ov = (np.array(p) for p in cur)
    oy[:ha, :wa] = out[0]
    ou[:ha // 2, :wa // 2] = out[1]
    ov[:ha // 2, :wa // 2] = out[2]
    return oy, ou, ov


# MB tint palette for the debug overlays (vp8.h:44-47 / postproc.c
# blit helpers redesigned as pure per-MB chroma tints: no text fonts)
_MODE_TINT = np.array(
    [[128, 128], [84, 110], [170, 110], [110, 170], [170, 170],
     [60, 140], [200, 90], [90, 200], [200, 200], [40, 216],
     [216, 40]], np.int32)
_REF_TINT = np.array(
    [[128, 128], [90, 160], [160, 90], [200, 128]], np.int32)


def _tint_mbs(u, v, idx_grid, palette, strength=96):
    """Blend each MB's chroma toward palette[idx] (the CLR_BLK_MODES /
    CLR_FRM_REF_BLKS visualizations, ppflags.h:24-27)."""
    uu, vv = u.astype(np.int32), v.astype(np.int32)
    h, w = uu.shape
    R, C = h // 8, w // 8
    idx = np.clip(idx_grid[:R, :C], 0, len(palette) - 1)
    tu = np.repeat(np.repeat(palette[idx][..., 0], 8, 0), 8, 1)
    tv = np.repeat(np.repeat(palette[idx][..., 1], 8, 0), 8, 1)
    ha, wa = R * 8, C * 8
    uu[:ha, :wa] = (uu[:ha, :wa] * (256 - strength) +
                    tu * strength) >> 8
    vv[:ha, :wa] = (vv[:ha, :wa] * (256 - strength) +
                    tv * strength) >> 8
    return (np.clip(uu, 0, 255).astype(np.uint8),
            np.clip(vv, 0, 255).astype(np.uint8))


def mv_overlay(y, mvs, intensity=255):
    """VP8D_DEBUG_DRAW_MV (vp8.h:44, postproc.c blit_line role): draw
    each MB's motion vector as a bright line from the MB center toward
    center + mv (eighth-pel), sampled at 16 points and scattered into the
    luma plane — the whole field is drawn with one fancy-index store."""
    yy = np.asarray(y).copy()
    h, w = yy.shape
    m = np.asarray(mvs)
    if m.ndim == 3 and m.shape[0] == h // 16 + (1 if h % 16 else 0) + 1:
        m = m[1:, 1:]                 # padded grid -> [R, C, 2]
    R, C = m.shape[:2]
    cy = (np.arange(R) * 16 + 8)[:, None]
    cx = (np.arange(C) * 16 + 8)[None, :]
    ey = cy + (m[:, :, 0] >> 3)
    ex = cx + (m[:, :, 1] >> 3)
    t = np.linspace(0.0, 1.0, 16)[:, None, None]
    py = np.round(cy[None] * (1 - t) + ey[None] * t).astype(np.int64)
    px = np.round(cx[None] * (1 - t) + ex[None] * t).astype(np.int64)
    keep = (py >= 0) & (py < h) & (px >= 0) & (px < w)
    yy[py[keep], px[keep]] = intensity
    return yy


def debug_overlay(y, u, v, flags, mode=None, ref_frame=None, mvs=None):
    """VP8D_DEBUG_CLR_BLK_MODES / VP8D_DEBUG_CLR_FRM_REF_BLKS /
    VP8D_DEBUG_DRAW_MV (vp8.h:44-47): colorize MBs by prediction mode /
    reference frame, draw motion vectors."""
    if "debug_clr_blk_modes" in flags and mode is not None:
        u, v = _tint_mbs(u, v, np.asarray(mode)[1:, 1:], _MODE_TINT)
    if "debug_clr_frm_ref_blks" in flags and ref_frame is not None:
        u, v = _tint_mbs(u, v, np.asarray(ref_frame)[1:, 1:], _REF_TINT)
    if "debug_draw_mv" in flags and mvs is not None:
        y = mv_overlay(y, mvs)
    return y, u, v


def post_proc_frame(y, u, v, q, flags, noise_level=0):
    """vp8_post_proc_frame (postproc.c:903): flag-driven pipeline.
    flags: set of strings from {'deblock', 'demacroblock', 'addnoise'}
    (VP8D_DEBLOCK / VP8D_DEMACROBLOCK / VP8D_ADDNOISE, ppflags.h:17-27)."""
    if "demacroblock" in flags:
        y, u, v = deblock(y, u, v, q)
        y = demacroblock_plane(y, q)
    elif "deblock" in flags:
        y, u, v = deblock(y, u, v, q)
    if "addnoise" in flags and noise_level > 0:
        y = add_noise(y, noise_level)
    return y, u, v
