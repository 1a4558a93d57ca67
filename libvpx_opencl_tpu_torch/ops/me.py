"""Device motion estimation (PyTorch): whole-frame batched SAD search.

Port of libvpx_opencl_tpu/ops/me.py (the reference's mcomp.c
diamond/hex/full searches as one dense window search for every MB): an
exhaustive step-1 grid over +-16 full-pel, or a step-2 grid with a +-1
full-pel refine, then half- and quarter-pel refines through the
production MC filter.

The step-1 SAD grid is K3 (ops/me_sad.py: the hand-written CUDA kernel
on a CUDA tensor, its plain version on a CPU tensor); the MV-rate penalty
and the argmin after it are shared code, so the two routes cannot differ
in a decision. Ties go to the first index of the flattened grid, as
jnp.argmin and torch.argmin both do.

`near_mv_lattice` and `intra_mode_preds` take the JAX functions'
row-sharding parameters (row_off, above_mv, n_rows_total) for the
row-sharded encoder (parallel/sharded_encode.py); their defaults give the
whole-frame result.
"""
from __future__ import annotations

import numpy as np
import torch

from . import me_sad
from . import predict as P

RNG = me_sad.RNG  # full-pel search radius

# sad_per_bit16lut (rdopt.c:152-185): SAD-domain rate weight per qindex
SAD_PER_BIT16 = np.array(
    [2] * 16 + [3] * 14 + [4] * 12 + [5] * 12 + [6] * 12 + [7] * 12 +
    [8] * 12 + [9] * 12 + [10] * 8 + [11] * 6 + [12] * 6 + [13] * 4 +
    [14] * 2, np.int32)


def _mv_penalty(mvcost, d8_r, d8_c, sadpb):
    """mvsad_err_cost (mcomp.c:62-75): component-cost lookup on the
    1/4-pel grid, scaled by sad-per-bit."""
    ir = (d8_r.abs() >> 1).clamp(0, 1023).long()
    ic = (d8_c.abs() >> 1).clamp(0, 1023).long()
    return ((mvcost[0][ir] + mvcost[1][ic]) * sadpb + 128) >> 8


def full_search(ref_plane, src_blocks, centers, mb_pos, mv_pen=None,
                step=2):
    """Full-pel window search: step-1 exhaustive (vp8_full_search_sad
    mcomp.c:1295) or step-2 + refine for the fast ladder.

    ref_plane [H, W] uint8 padded; src_blocks [N, 16, 16] int32;
    centers [N, 2] full-pel search centers (dy, dx) relative to the MB
    position, pre-clamped by the caller so that every window lies inside
    the plane; mb_pos [N, 2] padded top-left plane coords of each MB;
    mv_pen (mvcost [2,1024], pred8 [N,2], sadpb) or None.
    Returns (mv_fp [N,2] full-pel offsets relative to MB, sad [N]).

    step == 1 goes through K3: on a CUDA tensor always the kernel.
    """
    n = src_blocks.shape[0]
    dev = ref_plane.device
    w = 2 * RNG + 16
    wy = mb_pos[:, 0] + centers[:, 0] - RNG
    wx = mb_pos[:, 1] + centers[:, 1] - RNG
    if step == 1:
        sads = me_sad.sad_grid(ref_plane, wy, wx, src_blocks, RNG)
        win = None
    else:
        # window top-left follows the dynamic_slice start rule, as the
        # JAX gather does (_gather_windows places a window at starts-2)
        win = P._gather_windows(ref_plane[None],
                                torch.zeros(n, dtype=torch.long, device=dev),
                                torch.stack([wy + 2, wx + 2], 1), w)
        rows = []
        for dy in range(-RNG, RNG + 1, step):
            # [N, 16 rows, k offsets, 16 columns]
            cols = win[:, dy + RNG:dy + RNG + 16, :].unfold(2, 16, step)
            rows.append((cols - src_blocks[:, :, None, :]).abs()
                        .sum((1, 3)))
        sads = torch.stack(rows, 1).to(torch.int32)        # [N,k,k]
    cand = torch.arange(-RNG, RNG + 1, step, dtype=torch.int32, device=dev)
    k = cand.shape[0]
    if mv_pen is not None:
        # MV-rate costing over the whole grid (vp8_full_search_sad's
        # mvsad_err_cost per candidate, mcomp.c:1432-1495)
        mvcost, pred8, sadpb = mv_pen
        d8_r = (centers[:, 0:1] + cand[None, :]) * 8 - pred8[:, 0:1]
        d8_c = (centers[:, 1:2] + cand[None, :]) * 8 - pred8[:, 1:2]
        pen_r = mvcost[0][(d8_r.abs() >> 1).clamp(0, 1023).long()]  # [N,k]
        pen_c = mvcost[1][(d8_c.abs() >> 1).clamp(0, 1023).long()]
        sads = sads + (((pen_r[:, :, None] + pen_c[:, None, :]) * sadpb
                        + 128) >> 8)
    flat = sads.reshape(n, k * k)
    best = torch.argmin(flat, dim=1)
    bdy = cand[best // k]
    bdx = cand[best % k]
    best_sad = flat.gather(1, best[:, None])[:, 0]
    bmv = torch.stack([bdy, bdx], 1)
    if step == 1:
        # the exhaustive grid already holds every +-1 neighbour
        return bmv + centers, best_sad
    # +-1 refine (8 candidates, clamped inside the window)
    a16 = torch.arange(16, device=dev)
    ar = torch.arange(n, device=dev)[:, None, None]
    for ddy in (-1, 0, 1):
        for ddx in (-1, 0, 1):
            if ddy == 0 and ddx == 0:
                continue
            cy = (bdy + ddy).clamp(-RNG, RNG)
            cx = (bdx + ddx).clamp(-RNG, RNG)
            idx_r = (cy + RNG)[:, None, None] + a16[None, :, None]
            idx_c = (cx + RNG)[:, None, None] + a16[None, None, :]
            cnd = win[ar, idx_r.long(), idx_c.long()]
            sad = (cnd - src_blocks).abs().sum((1, 2)).to(torch.int32)
            if mv_pen is not None:
                mvcost, pred8, sadpb = mv_pen
                sad = sad + _mv_penalty(
                    mvcost, (centers[:, 0] + cy) * 8 - pred8[:, 0],
                    (centers[:, 1] + cx) * 8 - pred8[:, 1], sadpb)
            better = sad < best_sad
            best_sad = torch.where(better, sad, best_sad)
            bmv = torch.where(better[:, None], torch.stack([cy, cx], 1), bmv)
    return bmv + centers, best_sad


def subpel_refine(ref_plane, src_blocks, mb_pos, mv_fp, best_sad, taps,
                  bounds, mv_pen=None):
    """Half- then quarter-pel refine via the production MC filter.

    mv_fp [N,2] full-pel; bounds (lo_r, hi_r, lo_c, hi_c) [N] tensors in
    1/8-pel units. Returns (mv [N,2] eighth-pel with even components,
    sad)."""
    n = src_blocks.shape[0]
    dev = ref_plane.device
    mv = mv_fp * 8
    lo_r, hi_r, lo_c, hi_c = bounds
    ref3 = ref_plane[None]
    zero_ref = torch.zeros(8 * n, dtype=torch.long, device=dev)
    ar = torch.arange(n, device=dev)
    for sub in (4, 2):
        offs = [(-sub, 0), (sub, 0), (0, -sub), (0, sub),
                (-sub, -sub), (-sub, sub), (sub, -sub), (sub, sub)]
        cmv = torch.stack([
            torch.stack([torch.minimum(torch.maximum(mv[:, 0] + ddy, lo_r),
                                       hi_r),
                         torch.minimum(torch.maximum(mv[:, 1] + ddx, lo_c),
                                       hi_c)], 1)
            for ddy, ddx in offs], 0)                      # [8, N, 2]
        allc = cmv.reshape(8 * n, 2)
        starts = torch.stack([mb_pos[:, 0].repeat(8) + (allc[:, 0] >> 3),
                              mb_pos[:, 1].repeat(8) + (allc[:, 1] >> 3)], 1)
        preds = P.mc_predict_blocks(ref3, zero_ref, starts, allc[:, 1] & 7,
                                    allc[:, 0] & 7, taps, 16)
        sads = (preds - src_blocks.repeat(8, 1, 1)).abs().sum((1, 2)) \
            .to(torch.int32).reshape(8, n)
        if mv_pen is not None:
            mvcost, pred8, sadpb = mv_pen
            sads = sads + _mv_penalty(
                mvcost, cmv[:, :, 0] - pred8[None, :, 0],
                cmv[:, :, 1] - pred8[None, :, 1], sadpb)
        bi = torch.argmin(sads, dim=0)
        bs = sads.gather(0, bi[None])[0]
        picked = cmv[bi, ar]
        better = bs < best_sad
        best_sad = torch.where(better, bs, best_sad)
        mv = torch.where(better[:, None], picked, mv)
    return mv, best_sad


def near_mv_lattice(mvf, R, C, above_mv=None, row_off=0,
                    n_rows_total=None):
    """Batched vp8_find_near_mvs (findnearmv.c:24-140, decodemv.c:348-407)
    under the device-decision approximation that every in-frame neighbour
    is an inter MB coded with the given motion field (sign bias 0, no
    SPLITMV neighbours). The pack layer recomputes the exact lattice from
    final modes; this one prices NEAREST/NEAR/ZERO candidates during the
    batched decision.

    mvf [N, 2] int32 eighth-pel. A row shard passes `above_mv` [C, 2]
    (the last MV row of the rows above it; ignored where row_off == 0),
    `row_off` (the frame row of its row 0) and `n_rows_total` (the frame's
    MB rows), so that the neighbours and the vp8_clamp_mv2 bounds are the
    frame's. Returns (nearest, near, best) [N, 2] clamped MVs and cnt
    [N, 4] for MODE_CONTEXTS indexing."""
    dev = mvf.device
    i32 = torch.int32
    if n_rows_total is None:
        n_rows_total = R
    mv = mvf.reshape(R, C, 2)
    zero2 = torch.zeros(R, C, 2, dtype=mv.dtype, device=dev)
    above_row = zero2[0] if above_mv is None else \
        above_mv.reshape(C, 2).to(mv.dtype)
    amv = torch.cat([above_row[None], mv[:-1]], 0)
    lmv = torch.cat([zero2[:, :1], mv[:, :-1]], 1)
    al_row0 = torch.cat([zero2[0, :1], above_row[:-1]], 0)
    almv = torch.cat([al_row0[None],
                      torch.cat([zero2[1:, :1], mv[:-1, :-1]], 1)], 0)
    rows = torch.arange(R, device=dev)[:, None] + row_off
    cols = torch.arange(C, device=dev)[None, :]
    va = (rows > 0).expand(R, C)
    vl = (cols > 0).expand(R, C)
    val = va & vl

    def nz(m):
        return (m != 0).any(-1)

    def w(cond, x):
        return torch.where(cond, x, 0).to(i32)

    # above neighbour (weight 2)
    a_nz = va & nz(amv)
    near1 = torch.where(a_nz[..., None], amv, 0)
    near2 = zero2
    cnt0 = w(va & ~a_nz, 2)
    cnt1 = w(a_nz, 2)
    cnt2 = torch.zeros(R, C, dtype=i32, device=dev)
    cnt3 = torch.zeros(R, C, dtype=i32, device=dev)
    nmv = a_nz.to(i32)
    # left neighbour (weight 2)
    l_nz = vl & nz(lmv)
    same_l = l_nz & (nmv == 1) & (lmv == near1).all(-1)
    cnt1 = cnt1 + w(same_l, 2)
    new_l = l_nz & ~same_l
    to2 = new_l & (nmv == 1)
    to1 = new_l & (nmv == 0)
    near2 = torch.where(to2[..., None], lmv, near2)
    near1 = torch.where(to1[..., None], lmv, near1)
    cnt2 = cnt2 + w(to2, 2)
    cnt1 = cnt1 + w(to1, 2)
    cnt0 = cnt0 + w(vl & ~l_nz, 2)
    nmv = nmv + new_l.to(i32)
    # above-left neighbour (weight 1), compared against the most recently
    # entered MV only (near_mvs[nmv]), like the reference
    al_nz = val & nz(almv)
    cur_top = torch.where((nmv == 2)[..., None], near2, near1)
    same_al = al_nz & (nmv > 0) & (almv == cur_top).all(-1)
    cnt1 = cnt1 + (same_al & (nmv == 1)).to(i32)
    cnt2 = cnt2 + (same_al & (nmv == 2)).to(i32)
    new_al = al_nz & ~same_al
    t1 = new_al & (nmv == 0)
    t2 = new_al & (nmv == 1)
    t3 = new_al & (nmv == 2)
    near1 = torch.where(t1[..., None], almv, near1)
    near2 = torch.where(t2[..., None], almv, near2)
    cnt1 = cnt1 + t1.to(i32)
    cnt2 = cnt2 + t2.to(i32)
    cnt3 = cnt3 + t3.to(i32)
    cnt0 = cnt0 + w(val & ~al_nz, 1)
    # "if cnt[3] && near_mvs[nmv] == near_mvs[1]: cnt[1] += 1"
    cnt1 = cnt1 + (t3 & (almv == near1).all(-1)).to(i32)
    cnt3 = torch.zeros(R, C, dtype=i32, device=dev)  # SPLITMV neighbours: none
    # order NEAREST/NEAR by count
    swap = cnt2 > cnt1
    n1 = torch.where(swap[..., None], near2, near1)
    n2 = torch.where(swap[..., None], near1, near2)
    c1 = torch.where(swap, cnt2, cnt1)
    c2 = torch.where(swap, cnt1, cnt2)
    best = torch.where((c1 >= cnt0)[..., None], n1, 0)
    # vp8_clamp_mv2 bounds (MARGIN = 16<<3)
    lo_r = (-(rows * 16) << 3) - 128
    hi_r = (((n_rows_total - 1 - rows) * 16) << 3) + 128
    lo_c = (-(cols * 16) << 3) - 128
    hi_c = (((C - 1 - cols) * 16) << 3) + 128

    def clamp(m):
        return torch.stack(
            [torch.minimum(torch.maximum(m[..., 0], lo_r), hi_r),
             torch.minimum(torch.maximum(m[..., 1], lo_c), hi_c)],
            -1).to(mvf.dtype)

    N = R * C
    cnt = torch.stack([cnt0, c1, c2, cnt3], -1).reshape(N, 4)
    return (clamp(n1).reshape(N, 2), clamp(n2).reshape(N, 2),
            clamp(best).reshape(N, 2), cnt)


def intra_mode_preds(src_plane, mb_pos, n_rows, n_cols, bw, row_off=0):
    """Batched DC/V/H/TM 16x16/8x8 predictions from SOURCE neighbours
    (decision approximation; reconstruction later uses true reconstructed
    neighbours in the encode wavefront). mb_pos [N,2] padded plane coords
    of each block, at least one pixel inside the plane's border; row_off:
    the frame row of the blocks' row 0 (a row shard's; the 127 edge
    applies only on the frame's top row).
    Returns [N, 4, bw, bw] int32."""
    n = mb_pos.shape[0]
    dev = src_plane.device
    py, px = mb_pos[:, 0].long(), mb_pos[:, 1].long()
    a = torch.arange(bw, device=dev)
    above = src_plane[(py - 1)[:, None], px[:, None] + a].to(torch.int32)
    left = src_plane[py[:, None] + a, (px - 1)[:, None]].to(torch.int32)
    tl = src_plane[py - 1, px - 1].to(torch.int32)
    idx = torch.arange(n, device=dev)
    r0 = (idx // n_cols + row_off) == 0
    c0 = (idx % n_cols) == 0
    above = torch.where(r0[:, None], 127, above)
    left = torch.where(c0[:, None], 129, left)
    tl = torch.where(r0 | c0, torch.where(r0, 127, 129), tl).to(torch.int32)
    up_av = (~r0).to(torch.int32)
    lf_av = (~c0).to(torch.int32)
    total = above.sum(1) * up_av + left.sum(1) * lf_av
    shift = {16: 3, 8: 2}[bw] + up_av + lf_av
    dc = torch.where((up_av | lf_av) != 0,
                     (total + (torch.ones_like(shift) << (shift - 1))) >> shift,
                     128).to(torch.int32)
    pred_dc = dc[:, None, None].expand(n, bw, bw)
    pred_v = above[:, None, :].expand(n, bw, bw)
    pred_h = left[:, :, None].expand(n, bw, bw)
    pred_tm = (left[:, :, None] + above[:, None, :]
               - tl[:, None, None]).clamp(0, 255)
    return torch.stack([pred_dc, pred_v, pred_h, pred_tm], 1)


def intra_mode_costs(src_plane, src_blocks, mb_pos, n_rows, n_cols, bw):
    """Batched DC/V/H/TM SAD cost vs SOURCE neighbours. [N, 4]."""
    preds = intra_mode_preds(src_plane, mb_pos, n_rows, n_cols, bw)
    return (preds - src_blocks[:, None]).abs().sum((2, 3)).to(torch.int32)
