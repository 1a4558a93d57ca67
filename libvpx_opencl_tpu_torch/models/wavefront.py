"""Encode wavefront (PyTorch): predict -> FDCT/WHT -> quant -> decoder-exact
reconstruction, for every macroblock of a frame.

Port of libvpx_opencl_tpu/models/wavefront.py:encode_recon_blocks without
its B_PRED lanes and without the externally optimized (trellis)
coefficients. Intra predictions read true reconstructed neighbours;
residuals are transformed and quantized (dct.c / quantize.c duals) and
reconstructed as the decoder will (decodframe.c residual path).

Layout and schedule are the port's own. The JAX function keeps the frame
in diagonal-major block stores and sends every MB, inter ones too, through
a scan over the offset-2 diagonals 2r+c, because that suits XLA on a TPU.
Here the frame lives in zero-bordered raster uint8 planes (as for K1/K2,
ops/wavefront.py). An inter MB's prediction does not depend on its
neighbours, so all inter MBs are transformed, quantized and reconstructed
in one batch first. A 16x16 / 8x8 intra prediction reads the MB's left,
above and above-left neighbours only, so an intra MB must wait only for
those of the three that are intra themselves: the intra MBs are walked in
dependency levels (`intra_levels`), each level one batch. A keyframe has
R + C - 1 levels, an inter frame as many as its longest chain of adjacent
intra MBs. The outputs equal the JAX function's. (B_PRED sub-blocks also
read the above-right MB; when B_PRED is ported that neighbour joins the
levels' dependencies.)

This stage is plain tensor code in the JAX package too (an XLA scan, not a
Pallas kernel). One level costs several hundred small tensor ops, so a
keyframe is slow at large sizes.
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


def intra_levels(R, C, intra):
    """Dependency level of every MB of an R x C grid, [R*C] int64 numpy:
    -1 for inter MBs, and for an intra MB one more than the highest level
    among its left, above and above-left neighbours (0 where none of them
    is intra). MBs of one level do not read each other's pixels."""
    lvl = np.full((R + 1, C + 1), -1, np.int64)       # top/left apron
    grid = np.asarray(intra, bool).reshape(R, C)
    for r in range(R):
        for c in np.flatnonzero(grid[r]):
            lvl[r + 1, c + 1] = 1 + max(lvl[r + 1, c], lvl[r, c + 1],
                                        lvl[r, c])
    return lvl[1:, 1:].reshape(-1)


def transform_quant_recon(src_y, src_u, src_v, pred_y, pred_u, pred_v,
                          dq_y1, dq_y2, dq_uv, qidx):
    """Forward transform, regular quantization and in-loop reconstruction
    of M macroblocks with known predictions.

    src_*/pred_* [M,16,16] / [M,8,8] int32; dq_* [M,2] (dc, ac); qidx [M].
    Returns (qcoeff [M,25,16], eobs [M,25], rec_y [M,16,16], rec_u, rec_v
    [M,8,8]), int32; Y-block eobs are at least 1 (their DC travels in
    Y2)."""
    m = src_y.shape[0]
    dev = src_y.device
    ycoef = tf.fdct4x4_batch(RD._mb_blocks(src_y - pred_y)).reshape(m, 16, 16)
    y2 = tf.walsh4x4_batch(ycoef[:, :, 0])
    uvcoef = tf.fdct4x4_batch(torch.cat(
        [_uv_blocks(src_u - pred_u), _uv_blocks(src_v - pred_v)], 1)) \
        .reshape(m, 8, 16)
    coefs = torch.cat([ycoef, uvcoef, y2[:, None]], 1)          # [M,25,16]
    dq = torch.cat([dq_y1[:, None].expand(m, 16, 2),
                    dq_uv[:, None].expand(m, 8, 2), dq_y2[:, None]], 1)
    qall, eall = tf.regular_quant_batch(coefs, dq, qidx[:, None],
                                        _first0(dev))
    eall = torch.cat([eall[:, :16].clamp(min=1), eall[:, 16:]], 1)

    # in-loop reconstruction (decoder-exact)
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
    return qall, eall, rec_y, rec_u, rec_v


def encode_recon_planes(R, C, src_y_b, src_u_b, src_v_b, inter_y, inter_u,
                        inter_v, mode, uv_mode, intra, dq_y1, dq_y2, dq_uv,
                        qidx):
    """Whole-frame encode pass. Arguments as `encode_recon_blocks`.
    Returns (qcoeff [N,25,16] i32, eobs [N,25] i32, y, u, v): the
    reconstruction as fresh zero-bordered uint8 planes (ops/wavefront.py
    layout), not yet loop-filtered."""
    N = R * C
    dev = src_y_b.device
    srcs = (src_y_b, src_u_b, src_v_b)
    dqs = (dq_y1, dq_y2, dq_uv, qidx)
    qcoeff = torch.zeros(N, 25, 16, dtype=torch.int32, device=dev)
    eobs = torch.zeros(N, 25, dtype=torch.int32, device=dev)
    planes = tuple(torch.zeros(shape, dtype=torch.uint8, device=dev)
                   for shape in W.plane_shapes(R, C))
    # the wavefront's shape is decided on the host: one small copy
    intra_np = intra.cpu().numpy().astype(bool)

    def encode(idx, preds, r, c):
        q, e, *rec = transform_quant_recon(
            *(s[idx] for s in srcs), *preds, *(t[idx] for t in dqs))
        qcoeff[idx] = q
        eobs[idx] = e
        for plane, n, blk in zip(planes, (16, 8, 8), rec):
            W.mb_view(plane, R, C, n)[r, c] = blk.to(torch.uint8)

    inter_idx = torch.from_numpy(np.flatnonzero(~intra_np)).to(dev)
    if inter_idx.shape[0]:
        encode(inter_idx, (inter_y[inter_idx], inter_u[inter_idx],
                           inter_v[inter_idx]),
               inter_idx // C, inter_idx % C)
    if intra_np.any():
        # intra MBs sorted by level, uploaded once; each level is a slice
        lvl = intra_levels(R, C, intra_np)
        intra_idx = np.flatnonzero(intra_np)
        by_level = intra_idx[np.argsort(lvl[intra_idx], kind="stable")]
        order = torch.from_numpy(by_level).to(dev)
        ends = np.cumsum(np.bincount(lvl[intra_idx]))
        for start, end in zip(np.concatenate([[0], ends[:-1]]), ends):
            idx = order[start:end]
            r, c = idx // C, idx % C
            up, lf = r > 0, c > 0
            preds = []
            for plane, n, b, md in zip(planes, (16, 8, 8),
                                       (W.BORDER, W.BORDER // 2,
                                        W.BORDER // 2),
                                       (mode, uv_mode, uv_mode)):
                _, _, above, left, tl = W._edges(plane, b, n, r, c)
                preds.append(P.pred_nxn(md[idx], above, left, tl, up, lf, n))
            encode(idx, preds, r, c)
    return (qcoeff, eobs) + planes


def encode_recon_blocks(R, C, src_y_b, src_u_b, src_v_b, inter_y, inter_u,
                        inter_v, mode, uv_mode, intra, dq_y1, dq_y2, dq_uv,
                        qidx):
    """The JAX function's contract (without a schedule argument: the port
    needs none).

    src_*_b [N,16,16] / [N,8,8] int32 source blocks; inter_* [N,...] int32
    inter predictions (ignored where intra); mode, uv_mode [N] intra modes
    DC/V/H/TM (B_PRED is not supported here); intra [N] bool; dq_* [N,2];
    qidx [N]. Returns (qcoeff [N,25,16] i32, eobs [N,25] i32, recon y/u/v
    blocks i32, bmodes [N,16] i32 zeros)."""
    qcoeff, eobs, y, u, v = encode_recon_planes(
        R, C, src_y_b, src_u_b, src_v_b, inter_y, inter_u, inter_v, mode,
        uv_mode, intra, dq_y1, dq_y2, dq_uv, qidx)
    bmodes = torch.zeros(R * C, 16, dtype=torch.int32, device=qcoeff.device)
    return (qcoeff, eobs) + W.planes_to_blocks(R, C, y, u, v) + (bmodes,)
