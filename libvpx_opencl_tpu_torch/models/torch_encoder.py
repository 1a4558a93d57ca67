"""VP8 encoder with the pixel pipeline in PyTorch on a CUDA card.

Port of libvpx_opencl_tpu/models/tpu_encoder.py (the encoder twin of
torch_decoder):

  A. decision: whole-frame batched motion search (ops/me.py: the
     exhaustive step-1 SAD grid through K3, the hand-written CUDA kernel
     csrc/sad_grid.cu, or the step-2 grid + refine; then half/quarter-pel
     refine through the production MC filter) and token-cost RD choice
     among {DC,V,H,TM} intra, B_PRED and {ZERO,NEAREST,NEAR,NEW} x
     references;
  B. encode: MC predictions for the chosen MVs, the trellis (optimize_b)
     on the inter MBs' levels, then the encode wavefront
     (models/wavefront.py): intra predictions from true reconstructed
     neighbours, the B_PRED sub-block recursion, FDCT/WHT + regular
     quantization, decoder-exact in-loop reconstruction;
  C. loop filter through K2 (csrc/lf_wavefront.cu) in place on the
     reconstructed planes + border extension -> device-resident reference
     frames for the next frame's search.

The host packs the bitstream (the mode/MV/token entropy layer of the host
Encoder); MVs are mapped to their cheapest coding mode against the exact
near-MV lattice at pack time.

Every speed feature the JAX class reads is supported, on or off:
`exhaustive_me`, `multi_ref`, `bpred` (the B_PRED candidate in the inter
decision, `_bpred_rd`, and the encode wavefront's B_PRED lanes) and
`trellis` (optimize_b on the inter MBs' levels before their
reconstruction, `_trellis_mbs`). The default is the host ladder's speed 0,
with all of them on; SLICE2_SF (no B_PRED, no trellis) is kept as a named
feature set. Callers may set `enc.sf` after construction, as on the JAX
class.

Entry points run on `device="cuda"` unless the caller passes "cpu" (the
tests do); there is no fallback from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import me as ME
from ..ops import predict as P
from ..ops import rd_device as RD
from ..ops import tables as T
from ..ops import transforms as tf
from ..ops import wavefront as W
from ..utils import native, trace
from . import rdopt, refdec, wavefront as wf
from .encoder import Encoder, SpeedFeatures, _default_token_costs
from .refdec import (DC_PRED, INTRA_FRAME, LAST_FRAME, GOLDEN_FRAME,
                     ALTREF_FRAME, BORDER, dequant_factors)
from .torch_decoder import B, B2, DeviceFrame, _extend_borders

#: a faster feature set: exhaustive search and multi-reference, no B_PRED,
#: no trellis
SLICE2_SF = SpeedFeatures(rd=True, trellis=False, splitmv=False, bpred=False,
                          exhaustive_me=True, multi_ref=True)


def _tcb_tables(device):
    """Banded device token-cost tables under the default coefficient
    probabilities (the host encoder's _tc model). Types: 0 Y-with-Y2,
    1 Y2, 2 UV, 3 Y-without-Y2 (B_PRED)."""
    tc = _default_token_costs()
    return tuple(RD.banded_token_costs(tc, t).to(device) for t in range(4))


def _chroma_mv(mv):
    """Chroma MV of a luma MV component (reconinter.c:418-424): halve
    toward zero after rounding away from it."""
    w = mv + torch.where(mv >= 0, 1, -1)
    return torch.sign(w) * (w.abs() // 2)


def _mc_uv(refs_u, refs_v, ref_idx, mb_r, mb_c, mv8, taps):
    """Chroma MC predictions (pu, pv) [M,8,8] for luma MVs mv8 [M,2]."""
    uv_r, uv_c = _chroma_mv(mv8[:, 0]), _chroma_mv(mv8[:, 1])
    cstarts = torch.stack([B2 + mb_r * 8 + (uv_r >> 3),
                           B2 + mb_c * 8 + (uv_c >> 3)], 1)
    return tuple(P.mc_predict_blocks(refs, ref_idx, cstarts, uv_c & 7,
                                     uv_r & 7, taps, 8)
                 for refs in (refs_u, refs_v))


def _uv_inter_rd(R, C, ref_u, ref_v, ub, vb, mv8, taps, dqu, qidx, tcb2):
    """Chroma rate/dist of an inter candidate: derive the chroma MV,
    MC-predict, cost (rd_inter16x16_uv role)."""
    N = R * C
    mb = torch.arange(N, device=ub.device)
    zero = torch.zeros(N, dtype=torch.long, device=ub.device)
    pu, pv = _mc_uv(ref_u[None], ref_v[None], zero, mb // C, mb % C, mv8,
                    taps)
    return RD.rd_uv(ub - pu, vb - pv, dqu, qidx, tcb2)


def _uv_intra_rd(R, C, src_u_pl, src_v_pl, ub, vb, dqu, qidx, tcb2,
                 uvmode_cost, rdmult, rddiv, row_off=0):
    """RD-pick the chroma intra mode (rd_pick_intra_mbuv_mode role) of
    the R x C MBs from frame row row_off on.
    Returns (best mode [N], its rate incl. signaling [N], dist [N])."""
    N = R * C
    mb = torch.arange(N, device=ub.device)
    cpos = torch.stack([B2 + (mb // C + row_off) * 8, B2 + (mb % C) * 8], 1)
    ipu = ME.intra_mode_preds(src_u_pl, cpos, R, C, 8, row_off) \
        .transpose(0, 1)
    ipv = ME.intra_mode_preds(src_v_pl, cpos, R, C, 8, row_off) \
        .transpose(0, 1)
    ruv, duv = RD.rd_uv(ub[None] - ipu, vb[None] - ipv,
                        dqu[None].expand(4, N, 2), qidx[None].expand(4, N),
                        tcb2)
    ruv = ruv + uvmode_cost[:, None]
    rd_ = RD.rdc(ruv, duv / 4.0, rdmult, rddiv)
    best = torch.argmin(rd_, dim=0)
    return (best.to(torch.int32), ruv.gather(0, best[None])[0],
            duv.gather(0, best[None])[0])


def _bpred_rd(R, C, src_y_pl, yb, dq1, qidx, tcb3, bmode_cost, rdmult,
              rddiv):
    """B_PRED candidate rate/dist from SOURCE neighbours
    (rd_pick_intra4x4mby_modes role, rdopt.c; decision only: the encode
    wavefront re-picks the sub-modes from true reconstructed neighbours).
    All N*16 sub-blocks at once: each takes the best of 10 sub-modes under
    context-0 token rates, then the MB rate is re-costed with the contexts
    chained inside the MB.

    src_y_pl: the bordered source luma plane the encoder uploads (row and
    column B-1 and one tile past the MB grid's right edge are read).
    Returns (rate [N] int32, dist [N] float32). The squared errors are
    summed exactly (int64) and rounded once, as `RD.rd_y16`'s; the JAX
    function sums float32 squares, which is the same below 2^24."""
    N = R * C
    SR, SC = 4 * R, 4 * C                       # sub-block grid
    # neighbours of every sub-block position by strided slices: the row
    # above each sub-block row, with one extra tile right for above-right
    rows_a = src_y_pl[B - 1:B - 1 + 16 * R:4].to(torch.int32)
    tiles = rows_a[:, B:B + 4 * (SC + 1)].reshape(SR, SC + 1, 4)
    a8g = torch.cat([tiles[:, :SC], tiles[:, 1:]], 2)      # [SR, SC, 8]
    colw = src_y_pl[B:B + 16 * R, B - 1:B - 1 + 16 * C:4].to(torch.int32)
    l4g = colw.reshape(SR, 4, SC).transpose(1, 2)          # [SR, SC, 4]
    tlg = rows_a[:, B - 1:B - 1 + 16 * C:4]                # [SR, SC]

    def to_mb_major(x):
        """raster sub-block grid -> (MB, sub-block) order"""
        t = x.reshape(R, 4, C, 4, *x.shape[2:]).transpose(1, 2)
        return t.reshape(N * 16, *x.shape[2:])

    preds = P.bpred_4x4_all(to_mb_major(a8g), to_mb_major(l4g),
                            to_mb_major(tlg))              # [10,NB,4,4]
    NB = N * 16
    resid = RD._mb_blocks(yb).reshape(NB, 4, 4)[None] - preds
    coefs = tf.fdct4x4_batch(resid.reshape(10 * NB, 4, 4)).reshape(10, NB, 16)
    dqb = dq1.repeat_interleave(16, 0)                     # [NB, 2]
    q, _ = tf.regular_quant_batch(coefs, dqb[None],
                                  qidx.repeat_interleave(16, 0)[None], False)
    dist10 = RD._sq_err(coefs, q, RD._dq_vec(dqb)[None])   # [10, NB] int64
    rate10, _ = RD.block_rate(q, tcb3, 0, 0)
    rd10 = RD.rdc(rate10 + bmode_cost[:, None], dist10.double() / 4.0,
                  rdmult, rddiv)
    bm = torch.argmin(rd10, 0)                             # [NB]
    q_best = q.gather(0, bm[None, :, None].expand(1, NB, 16))[0]
    dist_best = dist10.gather(0, bm[None])[0]
    # within-MB chained contexts for the final MB rate
    nz = (q_best != 0).any(-1).to(torch.int32).reshape(N, 16)
    rate_f, _ = RD.block_rate(q_best, tcb3, 0,
                              RD._ctx_grid(nz, 4).reshape(NB))
    b_rate = (rate_f + bmode_cost[bm]).reshape(N, 16).sum(-1)
    return b_rate.to(torch.int32), \
        dist_best.reshape(N, 16).sum(-1).to(torch.float32)


def _decide_rd_inter(R, C, n_refs, me_step, use_bpred,
                     refs_y, refs_u, refs_v, src_y_pl, src_u_pl, src_v_pl,
                     yb, ub, vb, centers, taps, lo_r, hi_r, lo_c, hi_c,
                     mvcost, prev8, sadpb, tcb0, tcb1, tcb2, tcb3,
                     dq1, dq2, dqu, qidx, rdmult, rddiv, ymode_cost,
                     uvmode_cost, bmode_cost, ci0, ci1, modectx, c0tab,
                     c1tab):
    """Program A (RD form): per-reference motion search + token-cost RD
    mode decision over {DC,V,H,TM} intra and
    {ZEROMV, NEARESTMV, NEARMV, NEWMV} x {LAST, GOLDEN, ALTREF}: the
    vp8_rd_pick_inter_mode reference-frame candidate loop (rdopt.c:1714)
    batched over every MB at once. NEAREST/NEAR candidates and their
    mode-signaling costs come from a device near-MV lattice built over the
    LAST search field. Intra predictions come from source neighbours
    (decision approximation; the encode wavefront reconstructs from true
    neighbours). With use_bpred the B_PRED candidate (`_bpred_rd`, fixed
    inter-frame sub-mode costs bmode_cost) joins them.

    refs_y [nr,H,W], refs_u/refs_v [nr,Hc,Wc]; ci1 [nr] per-ref header
    cost; ymode_cost [5]; modectx [6,4] MODE_CONTEXTS; c0tab/c1tab [256]
    bit-cost tables.
    Returns (mv [N,2], ref_k [N] -1=intra else 0..nr-1, ymode, uvmode)."""
    mvs = _search_refs(R, C, n_refs, me_step, refs_y, yb, centers, taps,
                       lo_r, hi_r, lo_c, hi_c, mvcost, prev8, sadpb)
    return _rd_inter(R, C, n_refs, use_bpred, mvs,
                     ME.near_mv_lattice(mvs[0], R, C), refs_y, refs_u,
                     refs_v, src_y_pl, src_u_pl, src_v_pl, yb, ub, vb, taps,
                     mvcost, tcb0, tcb1, tcb2, tcb3, dq1, dq2, dqu, qidx,
                     rdmult, rddiv, ymode_cost, uvmode_cost, bmode_cost, ci0,
                     ci1, modectx, c0tab, c1tab)


def _mb_pos(R, C, device, row_off=0):
    """[N,2] int32 padded luma plane coordinates of the R x C MBs from
    frame row row_off on."""
    mb = torch.arange(R * C, device=device)
    return torch.stack([B + (mb // C + row_off) * 16, B + (mb % C) * 16],
                       1).to(torch.int32)


def _search_refs(R, C, n_refs, me_step, refs_y, yb, centers, taps, lo_r,
                 hi_r, lo_c, hi_c, mvcost, prev8, sadpb, row_off=0):
    """Per-reference full-pel search + sub-pel refine of the R x C MBs
    from frame row row_off on: a list of [N,2] eighth-pel MVs, one per
    reference."""
    mb_pos = _mb_pos(R, C, yb.device, row_off)
    pen = (mvcost, prev8, sadpb)
    bounds = (lo_r, hi_r, lo_c, hi_c)
    mvs = []
    for k in range(n_refs):
        mv_fp, sad_fp = ME.full_search(refs_y[k], yb, centers, mb_pos,
                                       mv_pen=pen, step=me_step)
        mv8k, _ = ME.subpel_refine(refs_y[k], yb, mb_pos, mv_fp, sad_fp,
                                   taps, bounds, mv_pen=pen)
        mvs.append(mv8k)
    return mvs


def _rd_inter(R, C, n_refs, use_bpred, mvs, lattice, refs_y, refs_u, refs_v,
              src_y_pl, src_u_pl, src_v_pl, yb, ub, vb, taps, mvcost, tcb0,
              tcb1, tcb2, tcb3, dq1, dq2, dqu, qidx, rdmult, rddiv,
              ymode_cost, uvmode_cost, bmode_cost, ci0, ci1, modectx, c0tab,
              c1tab, row_off=0):
    """The RD half of `_decide_rd_inter` over the R x C MBs from frame row
    row_off on, given the searched MVs and the near-MV lattice over them
    (ME.near_mv_lattice's 4-tuple). B_PRED (use_bpred) only for a whole
    frame (row_off 0)."""
    N = R * C
    dev = yb.device
    mb = torch.arange(N, device=dev)
    mb_r, mb_c = mb // C + row_off, mb % C
    mb_pos = _mb_pos(R, C, dev, row_off)
    nearest, near, best_mv, cnt = lattice
    cnt = cnt.long()
    p0, p1, p2, p3 = (modectx[cnt[:, i], i].long() for i in range(4))
    czero = c0tab[p0]
    cnearest = c1tab[p0] + c0tab[p1]
    cnear = cnearest - c0tab[p1] + c1tab[p1] + c0tab[p2]
    cnew = cnear - c0tab[p2] + c1tab[p2] + c0tab[p3]

    # Y candidates: 4 intra + (zero, nearest, near, new) per reference
    ipreds = ME.intra_mode_preds(src_y_pl, mb_pos, R, C, 16, row_off) \
        .transpose(0, 1)                                  # [4,N,16,16]
    zero2 = torch.zeros(N, 2, dtype=torch.int32, device=dev)
    cand_mvs = []
    for k in range(n_refs):
        cand_mvs += [zero2, nearest, near, mvs[k]]
    Kin = 4 * n_refs
    allmv = torch.stack(cand_mvs, 0)                      # [Kin, N, 2]
    flat_mv = allmv.reshape(Kin * N, 2)
    flat_ref = torch.arange(n_refs, device=dev).repeat_interleave(4 * N)
    pos_t = mb_pos.repeat(Kin, 1)
    starts = torch.stack([pos_t[:, 0] + (flat_mv[:, 0] >> 3),
                          pos_t[:, 1] + (flat_mv[:, 1] >> 3)], 1)
    pred_in = P.mc_predict_blocks(refs_y, flat_ref, starts,
                                  flat_mv[:, 1] & 7, flat_mv[:, 0] & 7,
                                  taps, 16).reshape(Kin, N, 16, 16)
    preds = torch.cat([ipreds, pred_in], 0)
    K = 4 + Kin
    ry, dy, _ = RD.rd_y16(yb[None] - preds, dq1[None].expand(K, N, 2),
                          dq2[None].expand(K, N, 2),
                          qidx[None].expand(K, N), tcb0, tcb1)

    # UV: best intra mode (shared by intra candidates) + per-candidate MC
    uvbest, ruv_i, duv_i = _uv_intra_rd(R, C, src_u_pl, src_v_pl, ub, vb,
                                        dqu, qidx, tcb2, uvmode_cost,
                                        rdmult, rddiv, row_off)
    pu, pv = _mc_uv(refs_u, refs_v, flat_ref, mb_r.repeat(Kin),
                    mb_c.repeat(Kin), flat_mv, taps)
    ruv_in, duv_in = RD.rd_uv(ub[None] - pu.reshape(Kin, N, 8, 8),
                              vb[None] - pv.reshape(Kin, N, 8, 8),
                              dqu[None].expand(Kin, N, 2),
                              qidx[None].expand(Kin, N), tcb2)

    # NEWMV signaling cost per reference (vp8_mv_bit_cost vs the lattice
    # best_ref_mv, weight 96)
    def mv_rate(mv8):
        dr = ((mv8[:, 0] - best_mv[:, 0]).abs() >> 1).clamp(0, 1023).long()
        dc_ = ((mv8[:, 1] - best_mv[:, 1]).abs() >> 1).clamp(0, 1023).long()
        return ((mvcost[0][dr] + mvcost[1][dc_]) * 96) >> 7

    mode_costs = [czero, cnearest, cnear, cnew]
    rate_rows = [ci0 + ymode_cost[m] + ry[m] + ruv_i for m in range(4)]
    dist_rows = [dy[m] / 4.0 + duv_i / 4.0 for m in range(4)]
    for k in range(n_refs):
        for j in range(4):
            i = 4 * k + j
            extra = mv_rate(mvs[k]) if j == 3 else 0
            rate_rows.append(ci1[k] + mode_costs[j] + extra +
                             ry[4 + i] + ruv_in[i])
            dist_rows.append(dy[4 + i] / 4.0 + duv_in[i] / 4.0)
    if use_bpred:
        if row_off:
            raise ValueError("the B_PRED candidate is costed over whole "
                             "frames only")
        br, bd = _bpred_rd(R, C, src_y_pl, yb, dq1, qidx, tcb3, bmode_cost,
                           rdmult, rddiv)
        rate_rows.append(ci0 + ymode_cost[4] + br + ruv_i)
        dist_rows.append(bd / 4.0 + duv_i / 4.0)
    rdall = RD.rdc(torch.stack(rate_rows, 0), torch.stack(dist_rows, 0),
                   rdmult, rddiv)
    best = torch.argmin(rdall, dim=0)
    is_bpred = best == 4 + Kin        # never true without the B_PRED row
    ymode = torch.where(is_bpred, 4, torch.argmin(rdall[:4], dim=0)) \
        .to(torch.int32)
    inter = (best >= 4) & ~is_bpred
    ref_k = torch.where(inter, (best - 4) // 4, -1).to(torch.int32)
    picked = allmv.gather(
        0, (best - 4).clamp(0, Kin - 1)[None, :, None].expand(1, N, 2))[0]
    mv_out = torch.where(inter[:, None], picked, 0)
    return mv_out, ref_k, ymode, uvbest


def _decide_rd_key(R, C, src_y_pl, src_u_pl, src_v_pl, yb, ub, vb,
                   tcb0, tcb1, tcb2, dq1, dq2, dqu, qidx, rdmult, rddiv,
                   ymode_cost, uvmode_cost, row_off=0):
    """Keyframe RD decision over {DC,V,H,TM} (vp8_rd_pick_intra_mode
    role, rdopt.c:2374) of the R x C MBs from frame row row_off on."""
    N = R * C
    mb_pos = _mb_pos(R, C, yb.device, row_off)
    ipreds = ME.intra_mode_preds(src_y_pl, mb_pos, R, C, 16, row_off) \
        .transpose(0, 1)
    ry, dy, _ = RD.rd_y16(yb[None] - ipreds, dq1[None].expand(4, N, 2),
                          dq2[None].expand(4, N, 2),
                          qidx[None].expand(4, N), tcb0, tcb1)
    uvbest, ruv_i, duv_i = _uv_intra_rd(R, C, src_u_pl, src_v_pl, ub, vb,
                                        dqu, qidx, tcb2, uvmode_cost,
                                        rdmult, rddiv, row_off)
    rate = ymode_cost[:, None] + ry + ruv_i[None]
    dist = dy / 4.0 + duv_i[None] / 4.0
    rdall = RD.rdc(rate, dist, rdmult, rddiv)
    return torch.argmin(rdall, dim=0).to(torch.int32), uvbest


def _trellis_mbs(coefs, q0, e0, dq_y1, dq_y2, dq_uv, tcb0, tcb1, tcb2,
                 rdmult, rddiv):
    """optimize_b on M macroblocks' levels (the vp8_optimize_mby/mbuv
    role): coefs, q0 [M,25,16] and e0 [M,25] as `wf.transform_quant`
    returns them. Returns (qcoeff [M,25,16], eobs [M,25]), Y eobs at least
    1: one K6 launch on the card, the plain version on the CPU
    (`RD.trellis_mbs`)."""
    return RD.trellis_mbs(coefs, q0, e0, dq_y1, dq_y2, dq_uv, tcb0, tcb1,
                          tcb2, rdmult, rddiv)


def _encode_device(R, C, use_trellis, refs_y, refs_u, refs_v, refk,
                   src_y_blocks, src_u_blocks, src_v_blocks,
                   mode, uv_mode, intra, mv8, taps, dq_y1, dq_y2, dq_uv,
                   qidx, tcb0, tcb1, tcb2, bmode_cost, rdmult, rddiv,
                   row_off=0, top=None):
    """Program B: MC predictions (per-MB reference selection), the trellis
    on the inter MBs (use_trellis: SpeedFeatures.trellis), then the encode
    wavefront (one K5 launch on the card), whose B_PRED MBs read
    bmode_cost (the caller passes None on frames without a B_PRED MB). The JAX function
    runs the trellis on every MB and keeps it for the inter ones; each
    block's result depends only on its own MB, so running it on the inter
    MBs alone gives the same levels. A row shard passes row_off (the frame
    row of its row 0) and `top` (wf.encode_recon_planes': the
    reconstructed pixel rows above it). Returns (qcoeff int16 [N,25,16],
    eobs [N,25], uv_mode, y, u, v, bmodes): the reconstruction as fresh
    zero-bordered uint8 planes, not yet loop-filtered."""
    N = R * C
    dev = src_y_blocks.device
    mb = torch.arange(N, device=dev)
    mb_r, mb_c = mb // C + row_off, mb % C
    rk = refk.clamp(0, refs_y.shape[0] - 1)
    starts = torch.stack([B + mb_r * 16 + (mv8[:, 0] >> 3),
                          B + mb_c * 16 + (mv8[:, 1] >> 3)], 1)
    pred_y = P.mc_predict_blocks(refs_y, rk, starts, mv8[:, 1] & 7,
                                 mv8[:, 0] & 7, taps, 16)
    pred_u, pred_v = _mc_uv(refs_u, refs_v, rk, mb_r, mb_c, mv8, taps)
    # chroma intra mode: RD-chosen by the decision program for intra MBs
    uv_mode = torch.where(intra, uv_mode, DC_PRED)
    ext = None
    if use_trellis:
        # the wavefront's inter batch, in MB order (one small host copy)
        with trace.host_wait():
            intra_np = intra.cpu().numpy()
        idx = torch.from_numpy(np.flatnonzero(~intra_np)).to(dev)
        if idx.shape[0]:
            dqs = (dq_y1[idx], dq_y2[idx], dq_uv[idx])
            coefs, q0, e0 = wf.transform_quant(
                src_y_blocks[idx], src_u_blocks[idx], src_v_blocks[idx],
                pred_y[idx], pred_u[idx], pred_v[idx], *dqs, qidx[idx])
            ext = _trellis_mbs(coefs, q0, e0, *dqs, tcb0, tcb1, tcb2, rdmult,
                               rddiv)
    qcoeff, eobs, y, u, v, bmodes = wf.encode_recon_planes(
        R, C, src_y_blocks, src_u_blocks, src_v_blocks, pred_y, pred_u,
        pred_v, mode, uv_mode, intra, dq_y1, dq_y2, dq_uv, qidx, ext,
        bmode_cost, rdmult, rddiv, top)
    return qcoeff.to(torch.int16), eobs, uv_mode, y, u, v, bmodes


def _lf_device(R, C, do_lf, y, u, v, lf_params):
    """Program C: loop filter (K2, in place on the planes the encode
    program returned) + border extension. lf_params [N, W.LF_COLS] int32
    (W.pack_lf_params)."""
    if do_lf:
        W.loop_filter_planes(R, C, False, y, u, v, lf_params)
    _extend_borders(y, B, C * 16, R * 16)
    _extend_borders(u, B2, C * 8, R * 8)
    _extend_borders(v, B2, C * 8, R * 8)
    return y, u, v


class TorchEncoder(Encoder):
    """VP8 encoder with the pixel pipeline in PyTorch + CUDA kernels
    (decision + transform + reconstruction + loop filter on the device;
    entropy packing on the host)."""

    # device-program dispatch hooks (parallel/sharded_encode.py overrides
    # them with equivalents of identical global-view signatures)
    _decide_key_fn = staticmethod(_decide_rd_key)
    _decide_inter_fn = staticmethod(_decide_rd_inter)
    _encode_fn = staticmethod(_encode_device)
    _lf_fn = staticmethod(_lf_device)

    def __init__(self, *args, device="cuda", **kwargs):
        super().__init__(*args, **kwargs)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchEncoder(device='cuda') needs a CUDA card; pass "
                    "device='cpu' to encode on the CPU")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {device!r}")
        R, C = self.R, self.C
        z = DeviceFrame(*(torch.zeros(shape, dtype=torch.uint8,
                                      device=self.device)
                          for shape in W.plane_shapes(R, C)),
                        self.w, self.h)
        # device reference ring (last/golden/altref share the zero frame
        # until refreshed: update_reference_frames onyx_if.c:2980 role)
        self.ref_last = z
        self.ref_gold = z
        self.ref_alt = z
        self.prev_mv = np.zeros((R * C, 2), np.int32)
        self._pending = None
        #: the last committed frame's reconstruction, as a decoder shows it
        self.frame_to_show = None
        self._tcb = _tcb_tables(self.device)

    def _dev(self, a, dtype=np.int32):
        """Host array -> tensor of `dtype` on the encoder's device."""
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)) \
            .to(self.device)

    def encode_frame(self, y, u, v, keyframe=None, refresh_last=True,
                     refresh_golden=None, commit=True, show=True,
                     refresh_alt=False):
        with trace.span("enc.encode", new_frame=True):
            return self._encode_frame(y, u, v, keyframe, refresh_last,
                                      refresh_golden, commit, show,
                                      refresh_alt)

    def _encode_frame(self, y, u, v, keyframe, refresh_last, refresh_golden,
                      commit, show, refresh_alt):
        if keyframe is None:
            keyframe = self.frame_count == 0
        if keyframe:
            self._reset_key_frame_state()
            self.prev_mv = np.zeros((self.R * self.C, 2), np.int32)
        self.refresh_last_flag = bool(refresh_last) or keyframe
        if refresh_golden is None:
            refresh_golden = bool(
                self.golden_interval and
                self.frame_count % self.golden_interval == 0)
        self.refresh_golden = bool(refresh_golden) or keyframe
        self.refresh_alt = bool(refresh_alt) or keyframe
        self.show_frame = bool(show) or keyframe
        R, C = self.R, self.C
        N = R * C
        with trace.span("enc.source"):
            # source planes, aligned + padded like the host encoder
            src = refdec.FrameBuffer(self.w, self.h)
            sy_, su_, sv_ = src.visible()
            sy_[:] = y
            su_[:] = u
            sv_[:] = v
            bb, bb2 = BORDER, BORDER // 2
            src.y[bb:bb + src.ah, bb + self.w:bb + src.aw] = \
                src.y[bb:bb + src.ah, bb + self.w - 1:bb + self.w]
            src.y[bb + self.h:bb + src.ah, bb:bb + src.aw] = \
                src.y[bb + self.h - 1:bb + self.h, bb:bb + src.aw]
            cw, ch = (self.w + 1) // 2, (self.h + 1) // 2
            for p in (src.u, src.v):
                p[bb2:bb2 + src.ah // 2, bb2 + cw:bb2 + src.aw // 2] = \
                    p[bb2:bb2 + src.ah // 2, bb2 + cw - 1:bb2 + cw]
                p[bb2 + ch:bb2 + src.ah // 2, bb2:bb2 + src.aw // 2] = \
                    p[bb2 + ch - 1:bb2 + ch, bb2:bb2 + src.aw // 2]

            j = self._dev
            src_y_pl = j(src.y, np.uint8)
            src_u_pl = j(src.u, np.uint8)
            src_v_pl = j(src.v, np.uint8)
            yb, ub, vb = W.planes_to_blocks(R, C, src_y_pl, src_u_pl, src_v_pl)
            taps = j(P.SIXTAP_TABLE)

            mbr = np.arange(N) // C
            mbc = np.arange(N) % C
            lo_r = j((-(mbr * 16) - 16) * 8)
            hi_r = j(((R - 1 - mbr) * 16 + 16) * 8)
            lo_c = j((-(mbc * 16) - 16) * 8)
            hi_c = j(((C - 1 - mbc) * 16 + 16) * 8)

            dqs = dequant_factors(self.qindex, 0, 0, 0, 0, 0)
            self.dq_y1, self.dq_y2, self.dq_uv = dqs
            if self.seg_map_enc is not None:
                # per-segment quantizers (the decoder applies per-segment
                # dequant, mb_init_dequantizer decodframe.c:74-89: the device
                # quantizer must match or the closed loop drifts)
                per = [dequant_factors(
                    min(127, max(0, self.qindex + self.seg_q_deltas[s])),
                    0, 0, 0, 0, 0) for s in range(4)]
                tab = np.asarray(per, np.int32)            # [4, 3, 2]
                segs = self.seg_map_enc.reshape(N)
                dq1, dq2, dqu = (j(tab[segs, k]) for k in range(3))
                # per-MB quantizer index (zbin factor + RD), segment-aware
                qdel = np.asarray(self.seg_q_deltas, np.int32)
                qx_np = np.clip(self.qindex + qdel[segs], 0, 127)
            else:
                dq1, dq2, dqu = (j(np.tile(np.asarray(d, np.int32), (N, 1)))
                                 for d in dqs)
                qx_np = np.full(N, self.qindex, np.int32)
            qidx = j(qx_np)

            # RD decision constants (vp8_initialize_rd_consts behavior)
            rdm, rdd, _epb = rdopt.rd_consts(self.qindex)
            rdm_f = torch.tensor(float(rdm), dtype=torch.float32,
                                 device=self.device)
            rdd_f = torch.tensor(float(rdd), dtype=torch.float32,
                                 device=self.device)
            tcb0, tcb1, tcb2, tcb3 = self._tcb
            bmode_cost = j(rdopt.BMODE_COST)

        with trace.span("enc.decision", device=self.device) as sp:
            if keyframe:
                mv8 = np.zeros((N, 2), np.int32)
                refk = np.full(N, -1, np.int32)
                ref_ids = [LAST_FRAME]
                ymode_d, uvb_d = self._decide_key_fn(
                    R, C, src_y_pl, src_u_pl, src_v_pl, yb, ub, vb,
                    tcb0, tcb1, tcb2, dq1, dq2, dqu, qidx, rdm_f, rdd_f,
                    j(rdopt.KF_YMODE_COST[:4]), j(rdopt.KF_UV_MODE_COST))
                ref_frames = [(self.ref_last, LAST_FRAME)]
            else:
                # reference set (rdopt.c:1714 candidate refs; identity dedup
                # like the host encoder's refs list)
                ref_frames = [(self.ref_last, LAST_FRAME)]
                if self.sf.multi_ref:
                    if self.ref_gold is not self.ref_last:
                        ref_frames.append((self.ref_gold, GOLDEN_FRAME))
                    if (self.ref_alt is not self.ref_last and
                            self.ref_alt is not self.ref_gold):
                        ref_frames.append((self.ref_alt, ALTREF_FRAME))
                ref_ids = [rid for _, rid in ref_frames]
            refs_y, refs_u, refs_v = (
                torch.stack([getattr(f, p) for f, _ in ref_frames])
                for p in ("y", "u", "v"))
            if not keyframe:
                lo = np.stack([-(mbr * 16) - 16, -(mbc * 16) - 16], 1)
                hi = np.stack([(R - 1 - mbr) * 16 + 16,
                               (C - 1 - mbc) * 16 + 16], 1)
                centers = np.clip(self.prev_mv >> 3, lo, hi)
                # MV-rate cost tables + per-MB predictor (the previous frame's
                # MV stands in for best_ref_mv during the search; the lattice
                # best_mv prices the NEWMV candidates) + sad-per-bit
                mvcost = j(np.stack([rdopt.MV_COST[0], rdopt.MV_COST[1]]))
                sadpb = int(ME.SAD_PER_BIT16[self.qindex])
                # per-ref header signaling costs (intra/last/gf tree)
                c_in = rdopt.cost1(self.prob_intra)
                ci0 = rdopt.cost0(self.prob_intra)
                ci1_list = []
                for rid in ref_ids:
                    if rid == LAST_FRAME:
                        ci1_list.append(c_in + rdopt.cost0(self.prob_last))
                    elif rid == GOLDEN_FRAME:
                        ci1_list.append(c_in + rdopt.cost1(self.prob_last) +
                                        rdopt.cost0(self.prob_gf))
                    else:
                        ci1_list.append(c_in + rdopt.cost1(self.prob_last) +
                                        rdopt.cost1(self.prob_gf))
                me_step = 1 if self.sf.exhaustive_me else 2
                mv8_d, refk_d, ymode_d, uvb_d = self._decide_inter_fn(
                    R, C, len(ref_frames), me_step, bool(self.sf.bpred),
                    refs_y, refs_u, refs_v,
                    src_y_pl, src_u_pl, src_v_pl, yb, ub, vb,
                    j(centers), taps, lo_r, hi_r, lo_c, hi_c,
                    mvcost, j(self.prev_mv), sadpb, tcb0, tcb1, tcb2, tcb3,
                    dq1, dq2, dqu, qidx, rdm_f, rdd_f,
                    j(rdopt.YMODE_COST[:5]), j(rdopt.UV_MODE_COST), bmode_cost,
                    ci0, j(ci1_list),
                    j(T.MODE_CONTEXTS), j(rdopt._C0), j(rdopt._C1))
            sp.device_end()
            with trace.host_wait():
                if not keyframe:
                    mv8 = mv8_d.cpu().numpy().astype(np.int32)
                    refk = refk_d.cpu().numpy().astype(np.int32)
                ymode = ymode_d.cpu().numpy().astype(np.int32)
                uvmode = uvb_d.cpu().numpy().astype(np.int32)
            intra = refk < 0

        with trace.span("enc.encode_mbs", device=self.device) as sp:
            # frames without a B_PRED MB (every keyframe: _decide_rd_key has
            # no B_PRED candidate) skip the wavefront's B_PRED lanes
            has_bpred = bool((ymode == W.B_PRED_M).any())
            (qcoeff_d, eobs_d, uv_mode_d, ry, ru, rv,
             bmodes_d) = self._encode_fn(
                R, C, bool(self.sf.trellis), refs_y, refs_u, refs_v, j(refk),
                yb, ub, vb, j(ymode), j(uvmode), j(intra, bool), j(mv8), taps,
                dq1, dq2, dqu, qidx, tcb0, tcb1, tcb2,
                bmode_cost if has_bpred else None, rdm_f, rdd_f)
            sp.device_end()
            with trace.host_wait():
                qcoeff = qcoeff_d.cpu().numpy()
                eobs = eobs_d.cpu().numpy()
                uv_mode = uv_mode_d.cpu().numpy()
                bmodes = bmodes_d.cpu().numpy()

        # host-side grids for packing
        self.mode = np.zeros((R + 1, C + 1), np.int32)
        self.uvmode = uv_mode.reshape(R, C).astype(np.int32)
        self.reff = np.zeros((R + 1, C + 1), np.int32)
        self.mv = np.zeros((R + 1, C + 1, 2), np.int32)
        self.bmode = np.zeros((R + 1, C + 1, 16), np.int32)
        self.bmode[1:, 1:] = bmodes.reshape(R, C, 16)
        self.qcoeff = qcoeff.reshape(R, C, 25, 16).astype(np.int32)
        self.eobs = eobs.reshape(R, C, 25)
        self.mode[1:, 1:] = ymode.reshape(R, C)
        ref_id_arr = np.asarray(ref_ids, np.int32)
        self.reff[1:, 1:] = np.where(
            intra.reshape(R, C), INTRA_FRAME,
            ref_id_arr[np.clip(refk, 0, len(ref_ids) - 1)].reshape(R, C))
        self.mv[1:, 1:, 0] = mv8[:, 0].reshape(R, C)
        self.mv[1:, 1:, 1] = mv8[:, 1].reshape(R, C)
        # map chosen MVs to the cheapest coding mode at pack time (exact
        # near-MV lattice, native C++)
        if not keyframe:
            # the skip grid is computed below; the lattice does not read
            # it, pass zeros
            self.skip = np.zeros((R, C), np.int32)
            with trace.span("enc.mv_modes"):
                native.map_mv_modes_native(native.get_lib(), self)

        # skip decision (B_PRED MBs have no Y2: e[24] == 0 and their Y
        # eobs start at 0; every other MB's 16 Y eobs start at 1)
        self.skip = np.zeros((R, C), np.int32)
        if self.mb_no_coeff_skip:
            skip16 = self.eobs.sum(axis=2) - 16 == 0
            skip_bp = self.eobs[:, :, :24].sum(axis=2) == 0
            self.skip = np.where(self.mode[1:, 1:] == W.B_PRED_M, skip_bp,
                                 skip16).astype(np.int32)

        # LF/pack overlap (the loopfilter_thread role, ethreading.c:29-57
        # / onyx_if.c:3071): enqueue the loop filter BEFORE packing. CUDA
        # work is asynchronous, so the filter runs on the card while the
        # host packs the bitstream; a recode discards the pending result.
        with trace.span("enc.lf"):
            lf_params = W.pack_lf_params(
                *(j(a) for a in self._lf_params(keyframe)))
            lf_out = self._lf_fn(R, C, self.filter_level > 0, ry, ru, rv,
                                 lf_params)
        with trace.span("enc.pack"):
            payload = self._pack(keyframe)
        self._pending = (keyframe, lf_out, mv8)
        if commit:
            self.commit_frame(payload)
        return payload

    def commit_frame(self, payload):
        """Reference-ring update for the accepted frame (split out for
        the RC recode loop; update_reference_frames onyx_if.c:2980
        semantics). The loop filter was already enqueued before pack."""
        keyframe, (cy, cu, cv), mv8 = self._pending
        self._pending = None
        new = DeviceFrame(cy, cu, cv, self.w, self.h)
        self.frame_to_show = new
        if self.refresh_golden:
            self.ref_gold = new
        if self.refresh_alt:
            self.ref_alt = new
        if self.refresh_last_flag:
            self.ref_last = new
        self.prev_mv = mv8.copy()
        self.frame_count += 1

    def _lf_params(self, keyframe):
        """Per-MB loop filter params (loopfilter.c:25-95, sharpness 0).
        With segmentation active the per-MB level applies the per-segment
        LF delta exactly like the decoder will (vp8_loop_filter_frame_init
        lvl lattice), so the closed loop stays exact."""
        R, C = self.R, self.C
        N = R * C
        base = self.filter_level
        if self.seg_map_enc is not None:
            segs = self.seg_map_enc.reshape(N)
            deltas = np.asarray(self.seg_lf_deltas, np.int32)
            fl = np.clip(base + deltas[segs], 0, 63)
        else:
            fl = np.full(N, base, np.int32)
        inner = np.maximum(1, fl)  # block_inside_limit at sharpness 0
        hev = np.zeros(N, np.int32)
        hev = np.where(fl >= 15, 1, hev)
        hev = np.where(fl >= 20, (1 if keyframe else 2), hev)
        hev = np.where(fl >= 40, (2 if keyframe else 3), hev)
        # skipped B_PRED/SPLITMV MBs still get inner edges filtered
        # (loopfilter.c: the dc_diff test exempts modes without Y2):
        # mirror the decoder's noskip = ~(has_y2 & skip)
        has_y2 = (self.mode[1:, 1:].reshape(N) != 4)
        noskip = ~(has_y2 & (self.skip.reshape(N) != 0))
        return (fl.astype(np.int32),
                (2 * (fl + 2) + inner).astype(np.int32),
                (2 * fl + inner).astype(np.int32),
                inner.astype(np.int32),
                hev.astype(np.int32), noskip)


def load_encoder_state(enc, state):
    """Put a TorchEncoder into a mid-stream state given as plain numpy
    arrays and ints, e.g. taken from another encoder (the encoder's
    counterpart of torch_decoder.load_reference_ring).

    `state` is a dict:
      refs        three (y, u, v) tuples of bordered uint8 planes: last,
                  golden, altref ([R*16+64, C*16+64] luma, [R*8+32,
                  C*8+32] chroma);
      same        which of them are one frame: (golden is last,
                  altref is last, altref is golden). The encoder searches
                  a reference once, so identity matters;
      prev_mv     [R*C, 2] int32, the previous frame's MVs (eighth-pel);
      frame_count, qindex, prob_intra, prob_last, prob_gf,
      prob_skip_false   ints;
      roi         None, or (seg_map [R,C], q_deltas[4], lf_deltas[4]).
    Raises ValueError if a plane or array does not fit the encoder's
    geometry."""
    R, C = enc.R, enc.C
    shapes = W.plane_shapes(R, C)
    frames = []
    for planes in state["refs"]:
        ts = []
        for a, shape in zip(planes, shapes):
            a = np.asarray(a)
            if a.dtype != np.uint8 or a.shape != shape:
                raise ValueError(f"reference plane must be uint8 {shape}, "
                                 f"got {a.dtype} {a.shape}")
            # own copy: the encoder never aliases the caller's array
            ts.append(torch.from_numpy(np.array(a)).to(enc.device))
        frames.append(DeviceFrame(*ts, enc.w, enc.h))
    prev_mv = np.asarray(state["prev_mv"])
    if prev_mv.shape != (R * C, 2):
        raise ValueError(f"prev_mv must be [{R * C}, 2], got {prev_mv.shape}")
    gold_is_last, alt_is_last, alt_is_gold = state["same"]
    last, gold, alt = frames
    if gold_is_last:
        gold = last
    if alt_is_last:
        alt = last
    elif alt_is_gold:
        alt = gold
    enc._pending = None
    enc.ref_last, enc.ref_gold, enc.ref_alt = last, gold, alt
    enc.prev_mv = prev_mv.astype(np.int32)
    enc.frame_count = int(state["frame_count"])
    enc.qindex = int(state["qindex"])
    for name in ("prob_intra", "prob_last", "prob_gf", "prob_skip_false"):
        setattr(enc, name, int(state[name]))
    if state["roi"] is None:
        enc.set_roimap(None, None)
    else:
        seg_map, q_deltas, lf_deltas = state["roi"]
        if np.asarray(seg_map).shape != (R, C):
            raise ValueError(f"ROI map must be [{R}, {C}], got "
                             f"{np.asarray(seg_map).shape}")
        enc.set_roimap(seg_map, q_deltas, lf_deltas)
