"""Encode wavefront (PyTorch): predict -> FDCT/WHT -> quant -> decoder-exact
reconstruction, for every macroblock of a frame.

Port of libvpx_opencl_tpu/models/wavefront.py:encode_recon_blocks, with its
B_PRED lanes and its externally optimized (trellis) coefficients. Intra
predictions read true reconstructed neighbours; residuals are transformed
and quantized (dct.c / quantize.c duals) and reconstructed as the decoder
will (decodframe.c residual path).

Layout and schedule are the port's own. The JAX function keeps the frame
in diagonal-major block stores and sends every MB, inter ones too, through
a scan over the offset-2 diagonals 2r+c, because that suits XLA on a TPU.
Here the frame lives in zero-bordered raster uint8 planes (as for K1/K2,
ops/wavefront.py). An inter MB's prediction does not depend on its
neighbours, so all inter MBs are transformed, quantized (or take the
trellis levels the caller passes) and reconstructed in one batch first. A
16x16 / 8x8 intra prediction reads the MB's left, above and above-left
neighbours, and a B_PRED MB's sub-blocks also read the above-right MB's
bottom row; an intra MB waits only for those of its neighbours that are
intra themselves. The intra MBs are walked in dependency levels
(`intra_levels`), each level one batch, and the level's B_PRED MBs go
through the 16-step sub-block recursion together (`_bpred_lanes`). A
keyframe has R + C - 1 levels, an inter frame as many as its longest chain
of dependent intra MBs. The outputs equal the JAX function's.

This stage is plain tensor code in the JAX package too (an XLA scan, not a
Pallas kernel). One level costs several hundred small tensor ops, and a
level with B_PRED MBs 16 sequential sub-block steps more, so a keyframe is
slow at large sizes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import predict as P
from ..ops import rd_device as RD
from ..ops import transforms as tf
from ..ops import wavefront as W


@functools.lru_cache(maxsize=None)
def _first0(device):
    """[25] bool on `device`: blocks 0-15 are Y-with-Y2 (quantized from
    zig-zag position 1), 16-23 chroma, 24 the Y2 block."""
    return torch.arange(25, device=device) < 16


def _uv_blocks(x):
    """[M, 8, 8] -> [M, 4, 4, 4]: the four 4x4 blocks in raster order."""
    m = x.shape[0]
    return x.reshape(m, 2, 4, 2, 4).transpose(2, 3).reshape(m, 4, 4, 4)


def _blocks_to_mb(x, g):
    """[M, g*g, 4, 4] raster blocks -> [M, 4g, 4g] MB image."""
    m = x.shape[0]
    return x.reshape(m, g, g, 4, 4).transpose(2, 3).reshape(m, 4 * g, 4 * g)


def intra_levels(R, C, intra, bpred=None):
    """Dependency level of every MB of an R x C grid, [R*C] int64 numpy:
    -1 for inter MBs, and for an intra MB one more than the highest level
    among its left, above and above-left neighbours, and for a B_PRED MB
    (`bpred` [R*C] bool, optional) its above-right neighbour too (0 where
    none of them is intra). MBs of one level do not read each other's
    pixels."""
    lvl = np.full((R + 1, C + 2), -1, np.int64)       # top/left/right apron
    grid = np.asarray(intra, bool).reshape(R, C)
    bp = np.zeros((R, C), bool) if bpred is None else \
        np.asarray(bpred, bool).reshape(R, C)
    for r in range(R):
        for c in np.flatnonzero(grid[r]):
            dep = max(lvl[r + 1, c], lvl[r, c + 1], lvl[r, c])
            if bp[r, c] and c + 1 < C:
                dep = max(dep, lvl[r, c + 2])
            lvl[r + 1, c + 1] = 1 + dep
    return lvl[1:, 1:C + 1].reshape(-1)


def transform_quant(src_y, src_u, src_v, pred_y, pred_u, pred_v, dq_y1, dq_y2,
                    dq_uv, qidx):
    """Forward transform and regular quantization of M macroblocks with
    known predictions.

    src_*/pred_* [M,16,16] / [M,8,8] int32; dq_* [M,2] (dc, ac); qidx [M].
    Returns (coefs, qcoeff [M,25,16], eobs [M,25]), int32, blocks in the
    bitstream's order (16 Y, 4 U, 4 V, Y2); Y-block eobs are at least 1
    (their DC travels in Y2)."""
    m = src_y.shape[0]
    ycoef = tf.fdct4x4_batch(RD._mb_blocks(src_y - pred_y)).reshape(m, 16, 16)
    y2 = tf.walsh4x4_batch(ycoef[:, :, 0])
    uvcoef = tf.fdct4x4_batch(torch.cat(
        [_uv_blocks(src_u - pred_u), _uv_blocks(src_v - pred_v)], 1)) \
        .reshape(m, 8, 16)
    coefs = torch.cat([ycoef, uvcoef, y2[:, None]], 1)          # [M,25,16]
    dq = torch.cat([dq_y1[:, None].expand(m, 16, 2),
                    dq_uv[:, None].expand(m, 8, 2), dq_y2[:, None]], 1)
    qall, eall = tf.regular_quant_batch(coefs, dq, qidx[:, None],
                                        _first0(src_y.device))
    eall = torch.cat([eall[:, :16].clamp(min=1), eall[:, 16:]], 1)
    return coefs, qall, eall


def reconstruct(qall, eall, pred_y, pred_u, pred_v, dq_y1, dq_y2, dq_uv):
    """Decoder-exact in-loop reconstruction of M macroblocks with a Y2
    block from their levels (qcoeff [M,25,16], eobs [M,25]). Returns
    (rec_y [M,16,16], rec_u, rec_v [M,8,8]) int32."""
    m = qall.shape[0]
    q2, e2 = qall[:, 24], eall[:, 24]
    dqv2 = RD._dq_vec(dq_y2).to(torch.int32)
    dcs_full = tf.inv_walsh_batch(tf._s16(q2 * dqv2).reshape(m, 4, 4))
    dc1 = tf._s16((tf._s16(q2[:, 0] * dq_y2[:, 0]) + 3) >> 3)
    dcs = torch.where((e2 > 1)[:, None], dcs_full, dc1[:, None])
    dqy = tf._s16(qall[:, :16, 1:] * dq_y1[:, None, 1:2])
    dqy = torch.cat([dcs[:, :, None], dqy], 2)
    rec_y = (pred_y + _blocks_to_mb(
        tf.idct4x4_batch(dqy.reshape(m, 16, 4, 4)), 4)).clamp(0, 255)
    dquv = tf._s16(qall[:, 16:24] *
                   RD._dq_vec(dq_uv).to(torch.int32)[:, None, :])
    uvres = tf.idct4x4_batch(dquv.reshape(m, 8, 4, 4))
    rec_u = (pred_u + _blocks_to_mb(uvres[:, :4], 2)).clamp(0, 255)
    rec_v = (pred_v + _blocks_to_mb(uvres[:, 4:], 2)).clamp(0, 255)
    return rec_y, rec_u, rec_v


def transform_quant_recon(src_y, src_u, src_v, pred_y, pred_u, pred_v,
                          dq_y1, dq_y2, dq_uv, qidx, ext=None):
    """`transform_quant` then `reconstruct`: returns (qcoeff [M,25,16],
    eobs [M,25], rec_y [M,16,16], rec_u, rec_v [M,8,8]), int32. ext: None,
    or (qcoeff, eobs) to code instead of the regular quantizer's levels
    (the trellis's); the reconstruction is then taken from them."""
    if ext is None:
        _, qall, eall = transform_quant(src_y, src_u, src_v, pred_y, pred_u,
                                        pred_v, dq_y1, dq_y2, dq_uv, qidx)
    else:
        qall, eall = ext
    return (qall, eall) + reconstruct(qall, eall, pred_y, pred_u, pred_v,
                                      dq_y1, dq_y2, dq_uv)


def _bpred_lanes(plane, C, r, c, src_y, dq_y1, qidx, bmode_cost, rdmult,
                 rddiv, top_interior=False):
    """B_PRED luma of M MBs (r, c) whose neighbours are reconstructed in
    `plane`: the 16-step sub-block recursion over a [M,17,21] workspace
    (row 0 = top-left, above and above-right; column 0 = left; rows 4, 8,
    12 carry the above-right pixels in columns 17-20). Each step predicts
    the ten sub-modes, picks the one of least rdc(mode cost, prediction
    SSE) (first on ties: pick_intra4x4mby_modes's fast pick), then
    transforms, quantizes (from position 0), dequantizes and reconstructs
    the winner into the workspace.
    Returns (qcoeff [M,16,16], eobs [M,16], rec [M,16,16], bmodes [M,16]),
    int32; eobs count from position 0 and are not clamped."""
    m = r.shape[0]
    dev = plane.device
    b = W.BORDER
    y0, x0, above, left, tl = W._edges(plane, b, 16, r, c, top_interior)
    ar = W.above_right(plane, C, r, c, y0, x0, above, top_interior)
    ws = torch.zeros(m, 17, 21, dtype=torch.int32, device=dev)
    ws[:, 0, 0] = tl
    ws[:, 0, 1:17] = above
    for row in (0, 4, 8, 12):
        ws[:, row, 17:21] = ar
    ws[:, 1:17, 0] = left
    dqv = RD._dq_vec(dq_y1).to(torch.int32)
    q = torch.zeros(m, 16, 16, dtype=torch.int32, device=dev)
    e = torch.zeros(m, 16, dtype=torch.int32, device=dev)
    bmodes = torch.zeros(m, 16, dtype=torch.int32, device=dev)
    lanes = torch.arange(m, device=dev)
    for k in range(16):
        ir, ic = k >> 2, k & 3
        preds = P.bpred_4x4_all(ws[:, 4 * ir, 1 + 4 * ic:9 + 4 * ic],
                                ws[:, 1 + 4 * ir:5 + 4 * ir, 4 * ic],
                                ws[:, 4 * ir, 4 * ic])     # [10, M, 4, 4]
        resid = src_y[None, :, 4 * ir:4 * ir + 4, 4 * ic:4 * ic + 4] - preds
        sse = (resid * resid).sum((-1, -2))
        best = torch.argmin(RD.rdc(bmode_cost[:, None], sse, rdmult, rddiv),
                            0)
        qk, ek = tf.regular_quant_batch(
            tf.fdct4x4_batch(resid[best, lanes]).reshape(m, 16), dq_y1, qidx,
            False)
        rec = preds[best, lanes] + tf.idct4x4_batch(
            tf._s16(qk * dqv).reshape(m, 4, 4))
        ws[:, 1 + 4 * ir:5 + 4 * ir, 1 + 4 * ic:5 + 4 * ic] = rec.clamp(0, 255)
        q[:, k] = qk
        e[:, k] = ek
        bmodes[:, k] = best.to(torch.int32)
    return q, e, ws[:, 1:17, 1:17], bmodes


def encode_recon_planes(R, C, src_y_b, src_u_b, src_v_b, inter_y, inter_u,
                        inter_v, mode, uv_mode, intra, dq_y1, dq_y2, dq_uv,
                        qidx, ext=None, bmode_cost=None, rdmult=None,
                        rddiv=None, top=None):
    """Whole-frame encode pass. Arguments as `encode_recon_blocks`; `top`,
    for a row shard below the first (parallel/sharded_encode.py): None, or
    the (y, u, v) reconstructed pixel rows just above the grid, each as
    wide as its bordered plane. They go into the planes' border row -1 and
    MB row 0 predicts from them as an interior row (ops/wavefront.py's
    top_interior).
    Returns (qcoeff [N,25,16] i32, eobs [N,25] i32, y, u, v, bmodes [N,16]
    i32): the reconstruction as fresh zero-bordered uint8 planes
    (ops/wavefront.py layout), not yet loop-filtered (with `top`, border
    row -1 holds it)."""
    N = R * C
    dev = src_y_b.device
    srcs = (src_y_b, src_u_b, src_v_b)
    dqs = (dq_y1, dq_y2, dq_uv, qidx)
    qcoeff = torch.zeros(N, 25, 16, dtype=torch.int32, device=dev)
    eobs = torch.zeros(N, 25, dtype=torch.int32, device=dev)
    bmodes = torch.zeros(N, 16, dtype=torch.int32, device=dev)
    planes = tuple(torch.zeros(shape, dtype=torch.uint8, device=dev)
                   for shape in W.plane_shapes(R, C))
    top_interior = top is not None
    if top_interior:
        for plane, b, row in zip(planes, (W.BORDER, W.BORDER // 2,
                                          W.BORDER // 2), top):
            plane[b - 1] = row
    # the wavefront's shape is decided on the host: one small copy
    intra_np = intra.cpu().numpy().astype(bool)
    bpred_np = intra_np & (mode.cpu().numpy() == W.B_PRED_M)
    if bpred_np.any() and bmode_cost is None:
        raise ValueError("B_PRED macroblocks need bmode_cost, rdmult and "
                         "rddiv")

    def put(idx, q, e, rec, r, c):
        qcoeff[idx] = q
        eobs[idx] = e
        for plane, n, blk in zip(planes, (16, 8, 8), rec):
            W.mb_view(plane, R, C, n)[r, c] = blk.to(torch.uint8)

    inter_idx = torch.from_numpy(np.flatnonzero(~intra_np)).to(dev)
    if inter_idx.shape[0]:
        q, e, *rec = transform_quant_recon(
            *(s[inter_idx] for s in srcs), inter_y[inter_idx],
            inter_u[inter_idx], inter_v[inter_idx],
            *(t[inter_idx] for t in dqs), ext=ext)
        put(inter_idx, q, e, rec, inter_idx // C, inter_idx % C)
    if intra_np.any():
        # intra MBs sorted by level, a level's B_PRED MBs last, uploaded
        # once; each level is a slice and its B_PRED MBs the slice's tail
        # (no boolean masks: they would read sizes back from the card)
        lvl = intra_levels(R, C, intra_np, bpred_np)
        intra_idx = np.flatnonzero(intra_np)
        by_level = intra_idx[np.lexsort((bpred_np[intra_idx],
                                         lvl[intra_idx]))]
        order = torch.from_numpy(by_level).to(dev)
        ends = np.cumsum(np.bincount(lvl[intra_idx]))
        n_bp = np.bincount(lvl[intra_idx], weights=bpred_np[intra_idx],
                           minlength=len(ends)).astype(np.int64)
        for start, end, nb in zip(np.concatenate([[0], ends[:-1]]), ends,
                                  n_bp):
            idx = order[start:end]
            r, c = idx // C, idx % C
            up, lf = (r > 0) | top_interior, c > 0
            preds = []
            for plane, n, b, md in zip(planes, (16, 8, 8),
                                       (W.BORDER, W.BORDER // 2,
                                        W.BORDER // 2),
                                       (mode, uv_mode, uv_mode)):
                _, _, above, left, tl = W._edges(plane, b, n, r, c,
                                                 top_interior)
                preds.append(P.pred_nxn(md[idx], above, left, tl, up, lf, n))
            q, e, *rec = transform_quant_recon(
                *(s[idx] for s in srcs), *preds, *(t[idx] for t in dqs))
            if nb:
                # B_PRED MBs: Y from the sub-block recursion, no Y2 block,
                # chroma from the batch above
                k = end - start - nb
                bi = idx[k:]
                qb, eb, rec_b, bm = _bpred_lanes(
                    planes[0], C, r[k:], c[k:], src_y_b[bi], dq_y1[bi],
                    qidx[bi], bmode_cost, rdmult, rddiv, top_interior)
                rec[0][k:] = rec_b
                bmodes[bi] = bm
                q[k:, :16] = qb
                q[k:, 24] = 0
                e[k:, :16] = eb
                e[k:, 24] = 0
            put(idx, q, e, rec, r, c)
    return (qcoeff, eobs) + planes + (bmodes,)


def encode_recon_blocks(R, C, src_y_b, src_u_b, src_v_b, inter_y, inter_u,
                        inter_v, mode, uv_mode, intra, dq_y1, dq_y2, dq_uv,
                        qidx, ext=None, bmode_cost=None, rdmult=None,
                        rddiv=None):
    """The JAX function's contract (without a schedule argument: the port
    needs none).

    src_*_b [N,16,16] / [N,8,8] int32 source blocks; inter_* [N,...] int32
    inter predictions (ignored where intra); mode [N] intra modes DC/V/H/TM
    or B_PRED (4), uv_mode [N]; intra [N] bool; dq_* [N,2]; qidx [N].
    ext: None, or (qcoeff [Ni,25,16], eobs [Ni,25]) to code for the Ni
    inter MBs in MB order (the JAX function's q_ext/e_ext where use_ext is
    ~intra). bmode_cost [10], rdmult, rddiv: the B_PRED lanes' mode costs
    and RD constants, needed when an intra MB has mode 4 (the JAX function
    gates its lanes on tcb3, which they do not read).
    Returns (qcoeff [N,25,16] i32, eobs [N,25] i32, recon y/u/v blocks
    i32, bmodes [N,16] i32, zero outside B_PRED MBs)."""
    qcoeff, eobs, y, u, v, bmodes = encode_recon_planes(
        R, C, src_y_b, src_u_b, src_v_b, inter_y, inter_u, inter_v, mode,
        uv_mode, intra, dq_y1, dq_y2, dq_uv, qidx, ext, bmode_cost, rdmult,
        rddiv)
    return (qcoeff, eobs) + W.planes_to_blocks(R, C, y, u, v) + (bmodes,)
