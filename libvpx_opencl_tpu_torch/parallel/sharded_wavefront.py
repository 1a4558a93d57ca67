"""Cross-shard wavefronts: K1 (intra reconstruction) and K2 (loop filter)
over the MB-row shards of one frame. Port of
libvpx_opencl_tpu/parallel/sharded_wavefront.py.

The JAX module runs the decoder's two wavefronts as XLA scans over the
frame's global diagonals, SPMD over the mesh, with a `ppermute` of
bottom-row strips at every step and the loop filter's seam edits sent up
once after the scan. Here every shard runs the hand-written kernels on
its own bordered planes (ops/wavefront.py's layout, plane_shapes(Rs, C)),
and the stitching is a few row copies between the shards' planes. What
makes the result equal the whole-frame wavefront, shard s > 0 having
`top_interior` set in both kernels:

  * unfiltered row first: VP8 predicts intra from the unfiltered frame,
    so shard s-1's last unfiltered pixel row (full plane width: the last
    MB column's above-right reads pixel 15 of it) goes into shard s's top
    border row -1 after K1(s-1) and before K2(s-1);
  * seam down, then up: K2(s) runs after K2(s-1) with shard s-1's 4
    filtered last rows in its border rows -4..-1; its row-0 top-edge
    filter writes at most rows -3..-1, which go back into shard s-1's last
    3 rows (the JAX "U seam up one shard" step). Raster-order filtering
    touches those rows in the same order: shard s-1 entirely, then row 0
    of shard s;
  * then each shard's left and right borders are extended
    (vp8_yv12_extend_frame_borders over its rows; the frame's top and
    bottom borders are built where a reference is read,
    parallel/sharded_decode.py).

Ordering on the card: one CUDA stream per shard and events between them,
with no host synchronisation. The K1 chain (K1(0), copy, K1(1), ...) and
the K2 chain (K2(0), copy, K2(1), write-back, ...) each run in shard
order, and the chains overlap: K2(s) may run while K1(s+1) does. A copy
into shard d is enqueued on d's stream after an event of the source's
stream; between two cards, torch's cross-device copy orders it against
both current streams (the source stream is made current too). On the CPU
(streams None) the same steps run one after another.
"""
from __future__ import annotations

import contextlib

import torch

from ..ops import wavefront as W

B, B2 = W.BORDER, W.BORDER // 2


def split_rows(R, n):
    """MB-row ranges [(r0, r1)] of min(n, R) shards of an R-row frame: the
    first R % n shards take one row more than the others (no dummy rows;
    a shard has at least one row)."""
    n = min(int(n), R)
    q, m = divmod(R, n)
    out, r0 = [], 0
    for s in range(n):
        r1 = r0 + q + (1 if s < m else 0)
        out.append((r0, r1))
        r0 = r1
    return out


def on_stream(stream):
    """Make `stream` current (a no-op for None, the CPU)."""
    return contextlib.nullcontext() if stream is None else \
        torch.cuda.stream(stream)


def record(stream):
    """An event recorded on `stream` now (None for None, the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _wait(stream, event):
    if stream is not None and event is not None:
        stream.wait_event(event)


def _mb_rows(planes):
    return (planes[0].shape[0] - 2 * B) // 16


def _copy_rows(dst, dst_rows, src, src_rows, st_dst, st_src, ev_src):
    """Copy full-width pixel rows of shard planes `src` (y, u, v) into
    `dst`: *_rows = ((luma first row, count), (chroma first row, count)).
    The copy comes after `ev_src` (recorded on st_src after the rows'
    producer) and after st_dst's work so far; st_dst's later work sees
    it."""
    if st_dst is not None and st_dst.device != st_src.device:
        # torch orders a cross-device copy after both current streams and
        # makes the destination's wait for it
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.stream(st_src))
        ctx.enter_context(torch.cuda.stream(st_dst))
    else:
        _wait(st_dst, ev_src)
        ctx = on_stream(st_dst)
    with ctx:
        for k, (d, s) in enumerate(zip(dst, src)):
            (d0, n), (s0, _) = dst_rows[k > 0], src_rows[k > 0]
            d[d0:d0 + n].copy_(s[s0:s0 + n], non_blocking=True)


def _extend_lr(planes):
    """Left and right borders of a shard's interior rows, in place
    (vp8_yv12_extend_frame_borders over those rows)."""
    for pl, b in zip(planes, (B, B2, B2)):
        h, w = pl.shape[0] - 2 * b, pl.shape[1] - 2 * b
        pl[b:b + h, :b] = pl[b:b + h, b:b + 1]
        pl[b:b + h, b + w:] = pl[b:b + h, b + w - 1:b + w]


def keep_alive(planes, streams):
    """Tell the caching allocator that every shard's planes are used on
    every shard's stream (the copies read and write them across streams)."""
    live = [st for st in streams if st is not None]
    for pls in planes:
        for t in pls:
            if t.is_cuda:
                for st in live:
                    t.record_stream(st)


def intra_sharded(planes, streams, resid, params):
    """K1 over the shards of one frame, in place. planes[s]: shard s's
    bordered (y, u, v) uint8 planes, its inter MBs reconstructed;
    streams[s]: its CUDA stream (None on the CPU); resid[s]: its
    (resid_y, resid_u, resid_v) int32 blocks; params[s]: its
    [Ns, >=W.INTRA_COLS] int32 rows. Returns, per shard, the event after
    which shard s-1's last unfiltered row has been taken into shard s's
    border (None for shard 0, and on the CPU): `filter_sharded` waits
    for it before it changes shard s-1."""
    S = len(planes)
    C = (planes[0][0].shape[1] - 2 * B) // 16
    keep_alive(planes, streams)
    taken = [None] * S
    k1_done = None
    for s in range(S):
        st = streams[s]
        if s:
            r = _mb_rows(planes[s - 1])
            _copy_rows(planes[s], ((B - 1, 1), (B2 - 1, 1)), planes[s - 1],
                       ((B + 16 * r - 1, 1), (B2 + 8 * r - 1, 1)), st,
                       streams[s - 1], k1_done)
            taken[s] = record(st)
        with on_stream(st):
            W.intra_recon_planes(_mb_rows(planes[s]), C, *planes[s],
                                 *resid[s], params[s], top_interior=s > 0)
        k1_done = record(st)
    return taken


def filter_sharded(planes, streams, params, simple, taken=None):
    """K2 over the shards of one frame, in place, then each shard's left
    and right borders. params[s]: shard s's [Ns, >=6] int32 rows, or
    params None for no filter (borders only); `taken`: intra_sharded's
    events. Returns, per shard, an event (None on the CPU) after which
    shard s's planes are final."""
    S = len(planes)
    C = (planes[0][0].shape[1] - 2 * B) // 16
    taken = taken or [None] * S
    keep_alive(planes, streams)
    ready = [None] * S
    k2_done = None
    for s in range(S):
        st = streams[s]
        if s + 1 < S:
            _wait(st, taken[s + 1])
        if params is not None:
            if s:
                r = _mb_rows(planes[s - 1])
                _copy_rows(planes[s], ((B - 4, 4), (B2 - 4, 4)),
                           planes[s - 1],
                           ((B + 16 * r - 4, 4), (B2 + 8 * r - 4, 4)), st,
                           streams[s - 1], k2_done)
            with on_stream(st):
                W.loop_filter_planes(_mb_rows(planes[s]), C, simple,
                                     *planes[s], params[s],
                                     top_interior=s > 0)
            k2_done = record(st)
            if s:
                # the seam edits of row 0's top edge, back into shard s-1
                r = _mb_rows(planes[s - 1])
                _copy_rows(planes[s - 1],
                           ((B + 16 * r - 3, 3), (B2 + 8 * r - 3, 3)),
                           planes[s], ((B - 3, 3), (B2 - 3, 3)),
                           streams[s - 1], st, k2_done)
        if s:
            with on_stream(streams[s - 1]):
                _extend_lr(planes[s - 1])
            ready[s - 1] = record(streams[s - 1])
    with on_stream(streams[S - 1]):
        _extend_lr(planes[S - 1])
    ready[S - 1] = record(streams[S - 1])
    return ready
