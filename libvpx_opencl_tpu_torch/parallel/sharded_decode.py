"""MB-row-sharded VP8 decode: port of
libvpx_opencl_tpu/parallel/sharded_decode.py (ShardedTPUDecoder).

The frame's MB rows are split over the shards of a ('row',) mesh
(parallel/mesh.py): min(n, R) shards, the first R % n taking one row
more, so there are no dummy rows (the JAX class pads R up to a multiple
of the mesh). Each shard keeps its rows of every frame as its own
bordered planes (ops/wavefront.plane_shapes(Rs, C)) on its device. Per
frame and shard, on the shard's CUDA stream:

  1. residuals (ops/transforms.compute_residual_blocks) of its MBs;
  2. inter MC of its inter MBs (ops/predict, SPLITMV per 4x4 tile) from
     a halo-extended reference: the padded rows of the whole frame's
     bordered reference planes that its MC windows read, assembled from
     the shards that hold them (rows outside the frame repeat the
     nearest frame row: yv12extend.c's top and bottom borders). The halo
     is sized exactly from the frame's MVs, with each window placed as
     the whole-plane gather places it (ops/predict._slice_start, which
     reproduces jax.lax.dynamic_slice for MVs reaching more than
     BORDER-2 px above the frame), so every prediction equals
     TorchDecoder's; the JAX class's HALO_BUCKETS exist to bound XLA
     compiles and have no counterpart;
  3. K1 and K2 across the shards (parallel/sharded_wavefront.py), then
     each shard's left and right borders;
  4. the reference-ring swap (handles only), as TorchDecoder's.

Threading: TorchDecoder's ordered dispatch worker is kept. The entropy
thread (the caller) decodes frame N+1 while the worker uploads frame N's
arrays and enqueues every shard's work on the shards' streams; nothing
in the worker waits for the card. Pixels reach the host only through
`frame_to_show` (visible(), packed()), which waits for every shard.

MD5-identical to TorchDecoder and to the golden decoder for every shard
count (tests/test_torch_sharded_decode.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import torch_decoder as TD
from ..models.torch_decoder import (B, B2, COL_INTRA, COL_LF, COL_MV,
                                    COL_UVMV, TorchDecoder)
from ..ops import wavefront as W
from . import sharded_wavefront as SW
from .mesh import make_row_mesh


def _slice_start(s, dim, w):
    """ops/predict._slice_start on numpy arrays."""
    return np.clip(np.where(s < 0, s + dim, s), 0, dim - w)


def halo_rows(R, C, rows, table, inter_idx, split):
    """Per shard, the padded rows of the frame's bordered reference planes
    that its inter MBs' MC windows read: ((luma lo, hi), (chroma lo, hi)),
    or None for a shard without inter MBs. table, inter_idx and split as
    TorchDecoder._prep_arrays returns them; the windows are placed as
    ops/predict places them in the whole planes (6-tap support: 21 rows a
    luma block, 13 a chroma block, 9 a 4x4 tile)."""
    H, Hc = R * 16 + 2 * B, R * 8 + 2 * B2
    r = inter_idx // C
    mv = table[inter_idx, COL_MV].astype(np.int64)
    uv = table[inter_idx, COL_UVMV].astype(np.int64)
    y_lo = _slice_start(B + r * 16 + (mv >> 3) - 2, H, 21)
    c_lo = _slice_start(B2 + r * 8 + (uv >> 3) - 2, Hc, 13)
    spans = [(r, y_lo, y_lo + 21, c_lo, c_lo + 13)]
    if split is not None:
        pos, y_mv, uv_mv = split
        sr = inter_idx[pos] // C
        k = np.arange(16)
        ty = _slice_start(B + sr[:, None] * 16 + (k >> 2) * 4 +
                          (y_mv[..., 0].astype(np.int64) >> 3) - 2, H, 9)
        q = np.arange(4)
        qy = _slice_start(B2 + sr[:, None] * 8 + (q >> 1) * 4 +
                          (uv_mv[..., 0].astype(np.int64) >> 3) - 2, Hc, 9)
        spans.append((sr, ty.min(1), ty.max(1) + 9, qy.min(1),
                      qy.max(1) + 9))
    out = []
    for r0, r1 in rows:
        parts = [[a[(span[0] >= r0) & (span[0] < r1)] for a in span[1:]]
                 for span in spans]
        if not any(p[0].size for p in parts):
            out.append(None)
            continue
        cat = [np.concatenate([p[i] for p in parts]) for i in range(4)]
        out.append(((int(cat[0].min()), int(cat[1].max())),
                    (int(cat[2].min()), int(cat[3].max()))))
    return out


class ShardedFrame:
    """A decoded frame as the shards hold it: `planes[s]` the bordered
    (y, u, v) uint8 planes of shard s's MB rows `rows[s]` (left and right
    borders extended), `streams[s]` the stream that wrote them and
    `ready[s]` an event after which they are final (None on the CPU)."""

    def __init__(self, planes, rows, w, h, streams, ready):
        self.planes, self.rows = planes, rows
        self.w, self.h = w, h
        self.streams, self.ready = streams, ready
        self._packed = None

    def window(self, k, lo, hi, device, stream):
        """Padded rows lo..hi-1 of the whole frame's bordered plane k
        (0 y, 1 u, 2 v), as yv12extend.c would border it, on `device`:
        enqueued on `stream` (None on the CPU), which must have waited for
        `ready`."""
        b, n = (B, 16) if k == 0 else (B2, 8)
        height = self.rows[-1][1] * n
        pieces = []
        gy = lo
        while gy < hi:
            fy = gy - b
            if fy < 0 or fy >= height:
                # above or below the frame: its first or last row
                s = 0 if fy < 0 else len(self.rows) - 1
                cnt = min(hi, b) - gy if fy < 0 else hi - gy
                loc = b if fy < 0 else b + (self.rows[s][1] -
                                            self.rows[s][0]) * n - 1
                src = self.planes[s][k][loc:loc + 1].expand(cnt, -1)
            else:
                s = next(i for i, (r0, r1) in enumerate(self.rows)
                         if fy < r1 * n)
                r0, r1 = self.rows[s]
                cnt = min(hi - gy, r1 * n - fy)
                loc = b + fy - r0 * n
                src = self.planes[s][k][loc:loc + cnt]
            if src.device != device:
                with torch.cuda.stream(self.streams[s]), \
                        torch.cuda.stream(stream):
                    src = src.to(device)
            pieces.append(src)
            gy += cnt
        with SW.on_stream(stream):
            return torch.cat(pieces)

    def packed(self):
        """Visible pixels, cropped and concatenated into one host uint8
        buffer (after every shard's work)."""
        if self._packed is None:
            for ev in self.ready:
                if ev is not None:
                    ev.synchronize()
            ch, cw = (self.h + 1) // 2, (self.w + 1) // 2
            flat = []
            for k, (b, rows, cols) in enumerate(((B, self.h, self.w),
                                                 (B2, ch, cw), (B2, ch, cw))):
                n = 16 if k == 0 else 8
                full = torch.cat([p[k][b:b + (r1 - r0) * n, b:b + cols].cpu()
                                  for p, (r0, r1) in zip(self.planes,
                                                         self.rows)])
                flat.append(full[:rows].reshape(-1))
            self._packed = torch.cat(flat).numpy()
        return self._packed

    def visible(self):
        ch, cw = (self.h + 1) // 2, (self.w + 1) // 2
        buf = self.packed()
        ny, nc = self.h * self.w, ch * cw
        return (buf[:ny].reshape(self.h, self.w),
                buf[ny:ny + nc].reshape(ch, cw),
                buf[ny + nc:].reshape(ch, cw))


class ShardedTorchDecoder(TorchDecoder):
    """TorchDecoder whose pixel pipeline is sharded by MB rows over a
    ('row',) mesh (module docstring). Keeps TorchDecoder's dispatch
    worker; MD5-identical to it for every shard count."""

    def __init__(self, mesh=None, n_devices=None, device="cuda"):
        self.mesh = mesh if mesh is not None else \
            make_row_mesh(n_devices, device=device)
        self.n_row = self.mesh.shape["row"]
        self._devs = list(self.mesh.devices.reshape(-1))
        super().__init__(device=self._devs[0])
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self._devs]
        self.rows = None

    def _zero_frame(self):
        """The all-zero frame of a new geometry, split over the shards."""
        self.rows = SW.split_rows(self.mb_rows, self.n_row)
        planes = []
        for s, (r0, r1) in enumerate(self.rows):
            with SW.on_stream(self._streams[s]):
                planes.append(tuple(
                    torch.zeros(shape, dtype=torch.uint8,
                                device=self._devs[s])
                    for shape in W.plane_shapes(r1 - r0, self.mb_cols)))
        return self._frame(planes)

    def _frame(self, planes):
        """A ShardedFrame of this decoder's shards holding `planes`, ready
        after the work enqueued on their streams so far."""
        streams = self._streams[:len(planes)]
        SW.keep_alive(planes, streams)
        return ShardedFrame(planes, self.rows, self.w, self.h, streams,
                            [SW.record(st) for st in streams])

    def _upload_frame(self, planes):
        """A ShardedFrame holding the decoder's own copy of whole-frame
        bordered numpy uint8 planes (y, u, v), split over its shards."""
        arrs = TD.checked_planes(self.mb_rows, self.mb_cols, planes)
        out = []
        for s, (r0, r1) in enumerate(self.rows):
            shard = []
            for a, (b, n) in zip(arrs, ((B, 16), (B2, 8), (B2, 8))):
                # the shard's rows with a border of the frame's rows
                # around them (only the rows between are ever read)
                part = np.ascontiguousarray(
                    a[r0 * n:r1 * n + 2 * b])
                with SW.on_stream(self._streams[s]):
                    shard.append(_upload(part, self._devs[s]))
            out.append(tuple(shard))
        return self._frame(out)

    def _frame_device(self, np_args, meta):
        """Every shard's work for one frame, enqueued on the shards'
        streams; returns the ShardedFrame."""
        R, C, simple_lf, do_lf = meta.R, meta.C, meta.simple_lf, meta.do_lf
        w, h = meta.w, meta.h
        table, qcoeff, inter_idx, taps, split = np_args
        halos = halo_rows(R, C, self.rows, table, inter_idx, split)
        refs = [f for i, f in enumerate((self.last, self.golden,
                                         self.altref))
                if f not in (self.last, self.golden, self.altref)[:i]]
        slot = [refs.index(f) for f in (self.last, self.golden, self.altref)]
        origin_h = (R * 16 + 2 * B, R * 8 + 2 * B2)
        planes, resid, intra_p, lf_p = [], [], [], []
        with torch.inference_mode():
            for s, (r0, r1) in enumerate(self.rows):
                dev, st = self._devs[s], self._streams[s]
                n0, n1 = r0 * C, r1 * C
                with SW.on_stream(st):
                    tab = _upload(table[n0:n1], dev)
                    sel = (inter_idx >= n0) & (inter_idx < n1)
                    mb = {"table": tab, "qcoeff": _upload(qcoeff[n0:n1], dev),
                          "inter_idx": _upload(inter_idx[sel] - n0, dev)}
                    ref_wins, sp, origin = None, None, None
                    if halos[s] is not None:
                        for f in refs:
                            for ev in f.ready:
                                if ev is not None:
                                    st.wait_event(ev)
                        wins = [[f.window(k, *halos[s][min(k, 1)], dev, st)
                                 for k in range(3)] for f in refs]
                        ref_wins = tuple(
                            torch.stack([wins[j][k] for j in slot])
                            for k in range(3))
                        origin = tuple((halos[s][k][0], origin_h[k])
                                       for k in range(2))
                        if split is not None:
                            sp = _shard_split(split, inter_idx, sel, dev)
                    pl, res = TD.inter_planes(
                        r1 - r0, C, ref_wins, mb, _upload(taps, dev), sp,
                        r0, origin)
                planes.append(pl)
                resid.append(res)
                intra_p.append(tab[:, COL_INTRA:COL_INTRA + W.INTRA_COLS])
                lf_p.append(tab[:, COL_LF:COL_LF + W.LF_COLS])
            streams = self._streams[:len(self.rows)]
            taken = SW.intra_sharded(planes, streams, resid, intra_p)
            ready = SW.filter_sharded(planes, streams,
                                      lf_p if do_lf else None, simple_lf,
                                      taken)
        return ShardedFrame(planes, self.rows, w, h, streams, ready)


def _upload(a, device):
    """numpy array -> tensor on `device` (on a card through pinned memory,
    without waiting: the current stream orders the copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _shard_split(split, inter_idx, sel, device):
    """The SPLITMV worklist of a shard whose inter MBs are
    inter_idx[sel]: positions renumbered within them."""
    pos, y_mv, uv_mv = split
    mine = sel[pos]
    if not mine.any():
        return None
    local = np.cumsum(sel) - 1
    return (_upload(local[pos[mine]], device), _upload(y_mv[mine], device),
            _upload(uv_mv[mine], device))
