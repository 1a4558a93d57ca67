"""Encode wavefront (PyTorch + CUDA): predict -> FDCT/WHT -> quant ->
decoder-exact reconstruction, for every macroblock of a frame.

Port of libvpx_opencl_tpu/models/wavefront.py:encode_recon_blocks, with its
B_PRED lanes and its externally optimized (trellis) coefficients. Intra
predictions read true reconstructed neighbours; residuals are transformed
and quantized (dct.c / quantize.c duals) and reconstructed as the decoder
will (decodframe.c residual path).

Layout and schedule are the port's own. The JAX function keeps the frame
in diagonal-major block stores and sends every MB, inter ones too, through
a scan over the offset-2 diagonals 2r+c (one XLA program per frame, no
Pallas kernel). Here the frame lives in zero-bordered raster uint8 planes
(as for K1/K2, ops/wavefront.py). An inter MB's prediction does not depend
on its neighbours, so all inter MBs are transformed, quantized (or take the
trellis levels the caller passes) and reconstructed in one batch first. A
16x16 / 8x8 intra prediction reads the MB's left, above and above-left
neighbours, and a B_PRED MB's sub-blocks also read the above-right MB's
bottom row. Then:

  * on the card, one launch of K5 (csrc/encode_wavefront.cu) encodes every
    intra MB: MB rows in start order, a 16x16 MB (r,c) once row r-1 has
    finished min(c+1, C) MBs, a B_PRED MB once it has finished min(c+2,
    C), a run of consecutive B_PRED MBs as one sub-block wavefront
    (`encode_recon_planes`);
  * the plain version (`_encode_planes_plain`, any device; the wrapper's
    choice for CPU tensors) walks the intra MBs in dependency levels
    (`intra_levels`): an intra MB waits only for those of its neighbours
    that are intra themselves, each level is one batch through
    `_encode_mb_step`, and the level's B_PRED MBs go through the 16-step
    sub-block recursion together (`_bpred_lanes`). A keyframe has R + C - 1
    levels, an inter frame as many as its longest chain of dependent intra
    MBs, and a level costs several hundred small tensor ops.

Both give the JAX function's outputs; tests/test_torch_encode_rowlag.py
shows that every row order of `_encode_mb_step` under K5's per-MB lag
gives the level batches' result, and that K5's sub-block steps over a
run of B_PRED MBs give the plain version's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import predict as P
from ..ops import rd_device as RD
from ..ops import transforms as tf
from ..ops import wavefront as W
from ..utils import trace

#: columns of K5's per-MB parameter rows (pack_encode_params)
ENC_COLS = 10


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


#: the order in which K5 runs a lone B_PRED MB's sub-blocks: the 10
#: diagonals 2*ir + ic, top row first within one (a sub-block reads only
#: its left, above and above-right neighbours, so any such order gives the
#: raster order's result)
BPRED_DIAG_ORDER = tuple(4 * ir + d - 2 * ir for d in range(10)
                         for ir in range(4) if 0 <= d - 2 * ir <= 3)


def _bpred_lanes(plane, C, r, c, src_y, dq_y1, qidx, bmode_cost, rdmult,
                 rddiv, top_interior=False, order=range(16)):
    """B_PRED luma of M MBs (r, c) whose neighbours are reconstructed in
    `plane`: the 16-step sub-block recursion over a [M,17,21] workspace
    (row 0 = top-left, above and above-right; column 0 = left; rows 4, 8,
    12 carry the above-right pixels in columns 17-20). Each step predicts
    the ten sub-modes, picks the one of least rdc(mode cost, prediction
    SSE) (first on ties: pick_intra4x4mby_modes's fast pick), then
    transforms, quantizes (from position 0), dequantizes and reconstructs
    the winner into the workspace. `order`: the sub-blocks' order, raster
    (k = 0..15) or any order that keeps their dependencies, such as
    BPRED_DIAG_ORDER.
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
    for k in order:
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


def _put_mbs(planes, out, idx, q, e, rec, r, c):
    """Write M encoded MBs: their levels and eobs into `out` (qcoeff,
    eobs, bmodes) and their reconstruction into the planes."""
    out[0][idx] = q
    out[1][idx] = e
    for plane, n, blk in zip(planes, (16, 8, 8), rec):
        b = W.BORDER if n == 16 else W.BORDER // 2
        W._put_blocks(plane, b + r * n, b + c * n, blk)


def _frame_setup(R, C, srcs, inters, mode, intra, dqs, ext, bmode_cost,
                 top):
    """What both versions do first: zeroed outputs and planes, `top` in
    the planes' border row -1, and every inter MB transformed, quantized
    (or given the levels `ext`) and reconstructed in one batch. Returns
    (planes, (qcoeff, eobs, bmodes), intra_np, bpred_np)."""
    N = R * C
    dev = srcs[0].device
    out = (torch.zeros(N, 25, 16, dtype=torch.int32, device=dev),
           torch.zeros(N, 25, dtype=torch.int32, device=dev),
           torch.zeros(N, 16, dtype=torch.int32, device=dev))
    planes = tuple(torch.zeros(shape, dtype=torch.uint8, device=dev)
                   for shape in W.plane_shapes(R, C))
    if top is not None:
        for plane, b, row in zip(planes, (W.BORDER, W.BORDER // 2,
                                          W.BORDER // 2), top):
            plane[b - 1] = row
    # the inter batch is chosen on the host: one small copy, which also
    # says which intra MBs are B_PRED
    ib = intra.bool()
    flags = ib.to(torch.uint8) | (((mode == W.B_PRED_M) & ib)
                                  .to(torch.uint8) << 1)
    with trace.host_wait():
        flags = flags.cpu().numpy()
    intra_np, bpred_np = (flags & 1) > 0, (flags & 2) > 0
    if bpred_np.any() and bmode_cost is None:
        raise ValueError("B_PRED macroblocks need bmode_cost, rdmult and "
                         "rddiv")
    inter_idx = torch.from_numpy(np.flatnonzero(~intra_np)).to(dev)
    if inter_idx.shape[0]:
        q, e, *rec = transform_quant_recon(
            *(s[inter_idx] for s in srcs), *(p[inter_idx] for p in inters),
            *(t[inter_idx] for t in dqs), ext=ext)
        _put_mbs(planes, out, inter_idx, q, e, rec, inter_idx // C,
                 inter_idx % C)
    return planes, out, intra_np, bpred_np


def _encode_mb_step(C, planes, out, srcs, dqs, mode, uv_mode, idx, nb,
                    bmode_cost=None, rdmult=None, rddiv=None,
                    top_interior=False):
    """Encode the intra MBs `idx` ([M] MB indices on the planes' device,
    the last `nb` of them B_PRED) in place: their rows of `out` (qcoeff,
    eobs, bmodes) and their pixels in the planes. Every MB they read must
    be done, and none may read another's pixels (any device)."""
    r, c = idx // C, idx % C
    up, lf = (r > 0) | top_interior, c > 0
    preds = []
    for plane, n, b, md in zip(planes, (16, 8, 8),
                               (W.BORDER, W.BORDER // 2, W.BORDER // 2),
                               (mode, uv_mode, uv_mode)):
        _, _, above, left, tl = W._edges(plane, b, n, r, c, top_interior)
        preds.append(P.pred_nxn(md[idx], above, left, tl, up, lf, n))
    q, e, *rec = transform_quant_recon(*(s[idx] for s in srcs), *preds,
                                       *(t[idx] for t in dqs))
    if nb:
        # B_PRED MBs: Y from the sub-block recursion, no Y2 block, chroma
        # from the batch above
        k = idx.shape[0] - nb
        bi = idx[k:]
        qb, eb, rec_b, bm = _bpred_lanes(
            planes[0], C, r[k:], c[k:], srcs[0][bi], dqs[0][bi], dqs[3][bi],
            bmode_cost, rdmult, rddiv, top_interior)
        rec[0][k:] = rec_b
        out[2][bi] = bm
        q[k:, :16] = qb
        q[k:, 24] = 0
        e[k:, :16] = eb
        e[k:, 24] = 0
    _put_mbs(planes, out, idx, q, e, rec, r, c)


def _encode_planes_plain(R, C, src_y_b, src_u_b, src_v_b, inter_y, inter_u,
                         inter_v, mode, uv_mode, intra, dq_y1, dq_y2, dq_uv,
                         qidx, ext=None, bmode_cost=None, rdmult=None,
                         rddiv=None, top=None):
    """Plain PyTorch version of `encode_recon_planes` (any device): the
    intra MBs in dependency levels, one batch per level."""
    srcs = (src_y_b, src_u_b, src_v_b)
    dqs = (dq_y1, dq_y2, dq_uv, qidx)
    planes, out, intra_np, bpred_np = _frame_setup(
        R, C, srcs, (inter_y, inter_u, inter_v), mode, intra, dqs, ext,
        bmode_cost, top)
    if intra_np.any():
        # intra MBs sorted by level, a level's B_PRED MBs last, uploaded
        # once; each level is a slice and its B_PRED MBs the slice's tail
        # (no boolean masks: they would read sizes back from the card)
        lvl = intra_levels(R, C, intra_np, bpred_np)
        intra_idx = np.flatnonzero(intra_np)
        by_level = intra_idx[np.lexsort((bpred_np[intra_idx],
                                         lvl[intra_idx]))]
        order = torch.from_numpy(by_level).to(src_y_b.device)
        ends = np.cumsum(np.bincount(lvl[intra_idx]))
        n_bp = np.bincount(lvl[intra_idx], weights=bpred_np[intra_idx],
                           minlength=len(ends)).astype(np.int64)
        for start, end, nb in zip(np.concatenate([[0], ends[:-1]]), ends,
                                  n_bp):
            _encode_mb_step(C, planes, out, srcs, dqs, mode, uv_mode,
                            order[start:end], int(nb), bmode_cost, rdmult,
                            rddiv, top is not None)
    return out[:2] + planes + out[2:]


def pack_encode_params(mode, uv_mode, intra, dq_y1, dq_y2, dq_uv, qidx):
    """[N, ENC_COLS] int32 rows for K5: mode, uv_mode, intra, qidx, dq_y1
    (dc, ac), dq_y2, dq_uv (made on their device: no host read)."""
    cols = (mode[:, None], uv_mode[:, None], intra.bool()[:, None],
            qidx[:, None], dq_y1, dq_y2, dq_uv)
    return torch.cat([x.to(torch.int32) for x in cols], 1).contiguous()


def _encode_planes_cuda(R, C, src_y_b, src_u_b, src_v_b, inter_y, inter_u,
                        inter_v, mode, uv_mode, intra, dq_y1, dq_y2, dq_uv,
                        qidx, ext, bmode_cost, rdmult, rddiv, top):
    """`encode_recon_planes` on the card: the inter batch, then one K5
    launch for every intra MB."""
    N = R * C
    dev = src_y_b.device
    if C > W.MAX_COLS:
        raise ValueError(f"K5 takes at most {W.MAX_COLS} MB columns, got {C}")
    # read by the kernel as they are
    read = [("src_y", src_y_b, torch.int32, (N, 16, 16)),
            ("src_u", src_u_b, torch.int32, (N, 8, 8)),
            ("src_v", src_v_b, torch.int32, (N, 8, 8))]
    if bmode_cost is not None:
        read += [("bmode_cost", bmode_cost, torch.int32, (10,)),
                 ("rdmult", rdmult, torch.float32, ()),
                 ("rddiv", rddiv, torch.float32, ())]
    for name, t, dtype, shape in read:
        if not isinstance(t, torch.Tensor) or t.device != dev or \
                t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor on {dev}")
    # packed on the card by pack_encode_params
    for name, t, shape in (("mode", mode, (N,)), ("uv_mode", uv_mode, (N,)),
                           ("intra", intra, (N,)), ("qidx", qidx, (N,)),
                           ("dq_y1", dq_y1, (N, 2)), ("dq_y2", dq_y2, (N, 2)),
                           ("dq_uv", dq_uv, (N, 2))):
        if t.device != dev or tuple(t.shape) != shape or \
                t.is_floating_point() or t.is_complex():
            raise ValueError(f"{name} must be an integer {shape} tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    srcs = (src_y_b, src_u_b, src_v_b)
    planes, out, _, _ = _frame_setup(
        R, C, srcs, (inter_y, inter_u, inter_v), mode, intra,
        (dq_y1, dq_y2, dq_uv, qidx), ext, bmode_cost, top)
    rd = (None,) * 3 if bmode_cost is None else (bmode_cost, rdmult, rddiv)
    params = pack_encode_params(mode, uv_mode, intra, dq_y1, dq_y2, dq_uv,
                                qidx)
    _k5_launch(R, C, planes, out, srcs, params, rd, top is not None)
    return out[:2] + planes + out[2:]


def _k5_launch(R, C, planes, out, srcs, params, rd, top_interior):
    """One K5 launch, in place on the planes and on `out` (qcoeff, eobs,
    bmodes), which hold the inter MBs already; rd: (bmode_cost, rdmult,
    rddiv) tensors, or Nones on a frame without B_PRED MBs."""
    W._launch("encode_wavefront", R, planes,
              *(t.data_ptr() for t in srcs), params.data_ptr(),
              *(None if x is None else x.data_ptr() for x in rd), R, C,
              int(bool(top_interior)), *(t.data_ptr() for t in out))


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
    row -1 holds it).

    CUDA tensors: the inter batch, then one launch of
    csrc/encode_wavefront.cu (K5) for the intra MBs, counted in
    launches["encode_wavefront"]; the int32 source blocks must be
    contiguous, and bmode_cost (when given) an int32 [10] tensor and
    rdmult/rddiv float32 scalar tensors on the card, as TorchEncoder holds
    them. CPU tensors: the plain version, `_encode_planes_plain`."""
    args = (R, C, src_y_b, src_u_b, src_v_b, inter_y, inter_u, inter_v, mode,
            uv_mode, intra, dq_y1, dq_y2, dq_uv, qidx, ext, bmode_cost,
            rdmult, rddiv, top)
    if W._all_on_cpu(src_y_b, src_u_b, src_v_b, inter_y, inter_u, inter_v,
                     mode, uv_mode, intra, dq_y1, dq_y2, dq_uv, qidx):
        return _encode_planes_plain(*args)
    return _encode_planes_cuda(*args)


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
