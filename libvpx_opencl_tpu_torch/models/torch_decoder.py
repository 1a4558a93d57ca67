"""VP8 decoder with the pixel pipeline in PyTorch on a CUDA card.

Port of libvpx_opencl_tpu/models/tpu_decoder.py:
  * host: container I/O, frame headers, mode/MV decode and detokenize (the
    serial entropy layer, RefDecoder + the native C++ runtime) -> per-frame
    arrays (`_prep_arrays`);
  * device, per frame (`decode_frame_device`):
      1. dequant + inverse WHT + IDCT for every block;
      2. sub-pel MC for every inter MB, SPLITMV per 4x4, the inter
         reconstruction written into fresh bordered planes: stages 1-2,
         one launch of csrc/inter_recon.cu (`inter_recon_planes`; its
         plain version `inter_planes` in torch ops);
      3. the intra wavefront K1 and the loop-filter wavefront K2 in place
         (hand-written CUDA kernels, ops/wavefront.py);
      4. border extension (yv12extend.c);
  * the reference ring (last/golden/altref) stays on the device.

Every decoded frame gets fresh planes, so the in-place kernels never
write a plane that the reference ring still holds.

Entry points run on `device="cuda"` unless the caller passes "cpu" (the
tests do); there is no fallback from one to the other.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _cuda
from ..ops import predict as P
from ..ops import transforms as tf
from ..ops import wavefront as W
from ..utils import trace
from .refdec import (B_PRED, SPLITMV, INTRA_FRAME, BORDER, RefDecoder,
                     dequant_factors, _s16)

B = BORDER          # luma pad
B2 = BORDER // 2    # chroma pad
assert W.BORDER == BORDER

# per-MB int32 table uploaded once per frame: the kernels read their
# parameter rows straight out of it (row stride MB_COLS)
COL_INTRA = 0                       # W.INTRA_COLS: mode, uv, intra, -, bm
COL_LF = COL_INTRA + W.INTRA_COLS   # W.LF_COLS: flevel, mblim, blim, ...
(COL_REF, COL_HASY2, COL_Y2BIG, COL_DQ, COL_MV, COL_UVMV) = (
    COL_LF + W.LF_COLS + k for k in (0, 1, 2, 3, 9, 11))
MB_COLS = COL_UVMV + 2


def use_card(device):
    """Make `device`'s card the calling thread's current one: a thread
    that enqueues a decoder's work or reads its frames back works under
    the decoder's card, whichever card its process started on. Nothing
    for the CPU or for "cuda" without an index (the current card)."""
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)


def _extend_borders(plane, pad, aw, ah):
    """vp8_yv12_extend_frame_borders (yv12extend.c:23-145), in place, over
    the MB-aligned aw x ah interior."""
    plane[pad:pad + ah, :pad] = plane[pad:pad + ah, pad:pad + 1]
    plane[pad:pad + ah, pad + aw:] = plane[pad:pad + ah, pad + aw - 1:pad + aw]
    plane[:pad, :] = plane[pad:pad + 1, :]
    plane[pad + ah:, :] = plane[pad + ah - 1:pad + ah, :]
    return plane


def _predict_inter(C, refs, mb, taps, split, row0=0, origin=None):
    """MC for every inter MB: [K,16,16] / [K,8,8] int32 predictions of the
    inter MBs `mb["inter_idx"]`, SPLITMV MBs per 4x4 tile.

    A row shard passes row0, the frame MB row of its table's row 0, and,
    where `refs` hold only padded rows lo.. of the frame's bordered planes
    (H rows high), origin = ((luma lo, luma H), (chroma lo, chroma H)):
    each window is then placed as it would be in the whole plane
    (P._slice_start over H) and read lo rows up."""
    ref_y, ref_u, ref_v = refs
    idx = mb["inter_idx"]
    t = mb["table"][idx]
    r, c = idx // C + row0, idx % C

    def place(start, w, k):
        if origin is None:
            return start
        lo, dim = origin[k]
        return P._slice_start(start - 2, dim, w) + 2 - lo

    ref = t[:, COL_REF]
    mv, uv = t[:, COL_MV:COL_MV + 2], t[:, COL_UVMV:COL_UVMV + 2]
    sy = torch.stack([place(B + r * 16 + (mv[:, 0] >> 3), 21, 0),
                      B + c * 16 + (mv[:, 1] >> 3)], 1)
    pred_y = P.mc_predict_blocks(ref_y, ref, sy, mv[:, 1] & 7, mv[:, 0] & 7,
                                 taps, 16)
    sc = torch.stack([place(B2 + r * 8 + (uv[:, 0] >> 3), 13, 1),
                      B2 + c * 8 + (uv[:, 1] >> 3)], 1)
    pred_u = P.mc_predict_blocks(ref_u, ref, sc, uv[:, 1] & 7, uv[:, 0] & 7,
                                 taps, 8)
    pred_v = P.mc_predict_blocks(ref_v, ref, sc, uv[:, 1] & 7, uv[:, 0] & 7,
                                 taps, 8)
    if split is not None:
        # SPLITMV (reconinter.c:449-525): per-sub-block luma MVs, per-quad
        # chroma MVs; `pos` = each split MB's row in the inter list
        pos, y_mv, uv_mv = split
        S = pos.shape[0]
        sidx = idx[pos]
        sr, sc_ = sidx // C + row0, sidx % C
        k = torch.arange(16, device=pos.device)
        ty = place(B + sr[:, None] * 16 + (k >> 2) * 4 + (y_mv[..., 0] >> 3),
                   9, 0)
        tx = B + sc_[:, None] * 16 + (k & 3) * 4 + (y_mv[..., 1] >> 3)
        sref = ref[pos]
        tiles = P.mc_predict_tiles(
            ref_y, sref.repeat_interleave(16),
            torch.stack([ty, tx], -1).reshape(-1, 2),
            (y_mv[..., 1] & 7).reshape(-1), (y_mv[..., 0] & 7).reshape(-1),
            taps)
        pred_y[pos] = tiles.view(S, 4, 4, 4, 4).permute(0, 1, 3, 2, 4) \
            .reshape(S, 16, 16)
        q = torch.arange(4, device=pos.device)
        qy = place(B2 + sr[:, None] * 8 + (q >> 1) * 4 + (uv_mv[..., 0] >> 3),
                   9, 1)
        qx = B2 + sc_[:, None] * 8 + (q & 1) * 4 + (uv_mv[..., 1] >> 3)
        qstarts = torch.stack([qy, qx], -1).reshape(-1, 2)
        qref = sref.repeat_interleave(4)
        qxp = (uv_mv[..., 1] & 7).reshape(-1)
        qyp = (uv_mv[..., 0] & 7).reshape(-1)
        for pred, plane in ((pred_u, ref_u), (pred_v, ref_v)):
            quads = P.mc_predict_tiles(plane, qref, qstarts, qxp, qyp, taps)
            pred[pos] = quads.view(S, 2, 2, 4, 4).permute(0, 1, 3, 2, 4) \
                .reshape(S, 8, 8)
    return pred_y, pred_u, pred_v


def inter_planes(R, C, refs, mb, taps, split, row0=0, origin=None):
    """Stages 1-2 of a frame (or of a row shard of R rows, row0 and
    origin as in `_predict_inter`): the residual blocks, and fresh
    bordered planes that hold every inter MB's reconstruction. Returns
    ((y, u, v), (resid_y, resid_u, resid_v))."""
    tab = mb["table"]
    dq = tab[:, COL_DQ:COL_DQ + 6]
    resid = tf.compute_residual_blocks(
        mb["qcoeff"], tab[:, COL_Y2BIG] != 0, dq[:, 0:2], dq[:, 2:4],
        dq[:, 4:6], tab[:, COL_HASY2] != 0)
    planes = W.alloc_planes(R, C, tab.device)
    idx = mb["inter_idx"]
    if idx.shape[0]:
        preds = _predict_inter(C, refs, mb, taps, split, row0, origin)
        r, c = idx // C, idx % C
        for plane, n, pred, res in zip(planes, (16, 8, 8), preds, resid):
            W.mb_view(plane, R, C, n)[r, c] = \
                (pred + res[idx]).clamp(0, 255).to(torch.uint8)
    return planes, resid


def _check_inter_args(R, C, refs, mb, taps, split):
    """Validate `inter_recon_planes`' CUDA arguments; raise ValueError on
    anything the kernel does not take. Returns the reference planes as
    [plane][last, golden, altref] (None without inter MBs)."""
    tab, qcoeff, idx = mb["table"], mb["qcoeff"], mb["inter_idx"]
    dev = tab.device
    N, K = R * C, idx.shape[0]

    def need(name, t, dtype, shape):
        if t.device != dev or t.dtype != dtype or \
                tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} "
                             f"{tuple(shape)} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")

    need("table", tab, torch.int32, (N, MB_COLS))
    need("qcoeff", qcoeff, torch.int16, (N, 25, 16))
    if qcoeff.data_ptr() % 16:
        raise ValueError("qcoeff must start on a 16-byte boundary")
    need("inter_idx", idx, torch.int64, (K,))
    need("taps", taps, torch.int32, (8, 6))
    if split is not None:
        S = split[0].shape[0]
        for name, t, dtype, shape in zip(
                ("pos", "y_mv", "uv_mv"), split,
                (torch.int64, torch.int32, torch.int32),
                ((S,), (S, 16, 2), (S, 4, 2))):
            need(f"split {name}", t, dtype, shape)
    if K == 0:
        return None
    if refs is None or len(refs) != 3:
        raise ValueError("inter MBs need refs = (ref_y, ref_u, ref_v)")
    planes = []
    for p, shape in zip(refs, _plane_shapes(R, C)):
        if len(p) != 3:
            raise ValueError("each of refs holds the last, golden and "
                             "altref planes")
        for t in p:
            need("reference plane", t, torch.uint8, shape)
        planes.append(tuple(p))
    return planes


def inter_recon_planes(R, C, refs, mb, taps, split):
    """Stages 1-2 of a frame, as `inter_planes(R, C, refs, mb, taps,
    split)`: the residual blocks and fresh bordered planes that hold every
    inter MB's reconstruction. refs = (ref_y, ref_u, ref_v), each the
    last, golden and altref planes (a [3,H,W] stack or three [H,W]
    planes; None without inter MBs). The SPLITMV rows `pos` increase, as
    `_prep_arrays` makes them.

    CUDA tensors: one launch of csrc/inter_recon.cu, counted in
    launches["inter_recon"], or ValueError on what the kernel does not
    take. CPU tensors: the plain version `inter_planes`."""
    tab = mb["table"]
    if tab.device.type == "cpu":
        if refs is not None:
            refs = tuple(p if torch.is_tensor(p) else torch.stack(tuple(p))
                         for p in refs)
        return inter_planes(R, C, refs, mb, taps, split)
    ref_planes = _check_inter_args(R, C, refs, mb, taps, split)
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError(f"stages 1-2 run on CUDA or CPU tensors, not {dev}")
    N, K = R * C, mb["inter_idx"].shape[0]
    ptrs = (ctypes.c_void_p * 9)(*(
        [t.data_ptr() for p in ref_planes for t in p] if ref_planes
        else [None] * 9))
    if split is None:
        split_args = (None, None, None, 0)
    else:
        split_args = (*(t.data_ptr() for t in split), split[0].shape[0])
    fn = _cuda.load()["inter_recon"]
    with torch.cuda.device(dev):
        planes = W.alloc_planes(R, C, dev)
        resid = tuple(torch.empty((N, n, n), dtype=torch.int32, device=dev)
                      for n in (16, 8, 8))
        y, u, v = planes
        rc = fn(tab.data_ptr(), tab.stride(0), COL_REF, COL_HASY2,
                COL_Y2BIG, COL_DQ, COL_MV, COL_UVMV, mb["qcoeff"].data_ptr(),
                mb["inter_idx"].data_ptr(), K, *split_args,
                taps.data_ptr(), ptrs, *(r.data_ptr() for r in resid),
                y.data_ptr(), y.stride(0), u.data_ptr(), v.data_ptr(),
                u.stride(0), R, C, torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(rc, "inter_recon")
    _cuda.count_launch("inter_recon")
    return planes, resid


def decode_frame_device(R, C, simple_lf, do_lf, refs, mb, taps, split):
    """One frame on the device. `mb` holds the uploaded per-frame tensors
    (table [N,MB_COLS] int32, qcoeff [N,25,16] int16, inter_idx [K]
    int64); refs = (ref_y, ref_u, ref_v), each the last, golden and
    altref planes (a [3,H,W] uint8 stack or three [H,W] planes; None on
    keyframes). Returns fresh bordered (y, u, v) uint8 planes."""
    tab = mb["table"]
    with trace.span("dec.inter") as sp:
        (y, u, v), resid = inter_recon_planes(R, C, refs, mb, taps, split)
        if sp:
            sp.attrs.update(
                kernel=int(tab.device.type == "cuda"),
                inter_mbs=int(mb["inter_idx"].shape[0]),
                split_mbs=0 if split is None else int(split[0].shape[0]))
    W.intra_recon_planes(R, C, y, u, v, *resid,
                         tab[:, COL_INTRA:COL_INTRA + W.INTRA_COLS])
    if do_lf:
        W.loop_filter_planes(R, C, simple_lf, y, u, v,
                             tab[:, COL_LF:COL_LF + W.LF_COLS])
    _extend_borders(y, B, C * 16, R * 16)
    _extend_borders(u, B2, C * 8, R * 8)
    _extend_borders(v, B2, C * 8, R * 8)
    return y, u, v


# ---------------------------------------------------------------------------
# host integration

class DeviceFrame:
    """Device-resident frame with the FrameBuffer interface pieces the
    decoder lifecycle uses. `ready` (CUDA only) is recorded on the decode
    stream once the frame's work is enqueued; `frame` is the trace's frame
    id of the frame that made it (None while tracing is off)."""

    def __init__(self, y, u, v, w, h, ready=None):
        self.y, self.u, self.v = y, u, v
        self.w, self.h = w, h
        self.ready = ready
        self.frame = trace.frame()
        self._packed = None

    def packed(self):
        """Visible pixels, cropped and concatenated into one host uint8
        buffer (one device-to-host copy)."""
        if self._packed is None:
            with trace.span("dec.device_wait"):
                if self.ready is not None:
                    self.ready.synchronize()
            ch, cw = (self.h + 1) // 2, (self.w + 1) // 2
            with trace.span("dec.readback_copy"):
                self._packed = torch.cat([
                    self.y[B:B + self.h, B:B + self.w].reshape(-1),
                    self.u[B2:B2 + ch, B2:B2 + cw].reshape(-1),
                    self.v[B2:B2 + ch, B2:B2 + cw].reshape(-1)]) \
                    .cpu().numpy()
        return self._packed

    def visible(self):
        ch, cw = (self.h + 1) // 2, (self.w + 1) // 2
        buf = self.packed()
        ny, nc = self.h * self.w, ch * cw
        return (buf[:ny].reshape(self.h, self.w),
                buf[ny:ny + nc].reshape(ch, cw),
                buf[ny + nc:].reshape(ch, cw))


class FrameFuture:
    """frame_to_show handle while the dispatch worker is still uploading /
    enqueueing the frame: resolves to the DeviceFrame on first pixel access
    so the host entropy thread never blocks on the device. `frame` is the
    trace's frame id, as DeviceFrame's."""

    def __init__(self, fut, dec):
        self._fut = fut
        self._dec = dec
        self.frame = trace.frame()

    def _f(self):
        try:
            with trace.span("dec.join_wait"):
                return self._fut.result()
        except BaseException:
            # the decoder's first failure is reported here, not again
            self._dec._raise_dispatch_error()
            raise

    @property
    def y(self):
        return self._f().y

    @property
    def u(self):
        return self._f().u

    @property
    def v(self):
        return self._f().v

    @property
    def w(self):
        return self._f().w

    @property
    def h(self):
        return self._f().h

    def packed(self):
        return self._f().packed()

    def visible(self):
        return self._f().visible()


class FrameMeta(NamedTuple):
    """One frame's header values that the entropy thread hands the
    dispatch worker with its arrays (`_reconstruct`)."""
    R: int
    C: int
    simple_lf: bool
    do_lf: bool
    frame_type: int
    copy_to_arf: int
    copy_to_gf: int
    refresh_golden: int
    refresh_alt: int
    refresh_last: int
    use_bilinear: bool
    w: int
    h: int


class TorchDecoder(RefDecoder):
    """VP8 decoder with the pixel pipeline in PyTorch + CUDA kernels.

    Reuses RefDecoder's host entropy layer (headers, mode/MV, detokenize,
    in the native C++ runtime) and replaces reconstruction, loop filter and
    borders with device work per frame. The entropy thread (the caller)
    hands each frame's prepared numpy arrays to one ordered dispatch
    worker, which uploads them, enqueues the device work on its own CUDA
    stream and swaps the reference ring: upload of frame N overlaps entropy
    decode of frame N+1 (threading.c:252-478's decode/filter overlap).
    """

    use_native = True

    _dispatch_pool = None
    _pending = None
    _dispatch_error = None     # the worker's first failure, until reported

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchDecoder(device='cuda') needs a CUDA card; pass "
                    "device='cpu' to decode on the CPU")
            self._stream = torch.cuda.Stream(self.device)
        elif self.device.type == "cpu":
            self._stream = None
        else:
            raise ValueError(f"unsupported device {device!r}")
        self._taps = {}
        self._pinned = None
        self._pinned_free = None

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _alloc(self):
        self._sync()
        super()._alloc()
        if self._dispatch_pool is None:
            self._dispatch_pool = cf.ThreadPoolExecutor(
                max_workers=1, initializer=use_card, initargs=(self.device,))
        self.last = self.golden = self.altref = self._zero_frame()

    def close(self):
        """Let the dispatch worker finish its frames and end its thread.
        The decoder takes no frame after it."""
        pool, self._dispatch_pool = self._dispatch_pool, None
        self._pending = None
        if pool is not None:
            pool.shutdown(wait=True)

    def _zero_frame(self):
        """The all-zero frame a new geometry's ring starts from."""
        with self._on_stream():
            return DeviceFrame(*(torch.zeros(shape, dtype=torch.uint8,
                                             device=self.device)
                                 for shape in _plane_shapes(self.mb_rows,
                                                            self.mb_cols)),
                               self.w, self.h)

    def _sync(self):
        """Join the dispatch worker (before any main-thread access to the
        device reference ring: _alloc, concealment, load_reference{,_ring},
        the API's get_reference), then raise a dispatch failure not yet
        reported."""
        if self._pending is not None:
            cf.wait([self._pending])
            self._pending = None
        self._raise_dispatch_error()

    def _raise_dispatch_error(self):
        """Raise the worker's first failure, once. The frames queued behind
        it are refused (`_dispatch`); they are waited out before the
        failure is cleared, so the reference ring stays at the last
        committed frame and the stream can continue."""
        err = self._dispatch_error
        if err is None:
            return
        if self._pending is not None:
            cf.wait([self._pending])
            self._pending = None
        self._dispatch_error = None
        raise err

    def conceal_missing_frame(self):
        self._sync()
        return super().conceal_missing_frame()

    def _reconstruct(self):
        # report a failure the worker has had; a dispatch still running is
        # not waited for, so the entropy thread keeps its overlap with it
        self._raise_dispatch_error()
        with trace.span("dec.detokenize"):
            self._detokenize_all()
        with trace.span("dec.prep"):
            np_args = self._prep_arrays()
        meta = FrameMeta(self.mb_rows, self.mb_cols, bool(self.simple_filter),
                         self.filter_level > 0, self.frame_type,
                         getattr(self, "copy_to_arf", 0),
                         getattr(self, "copy_to_gf", 0),
                         getattr(self, "refresh_golden", 0),
                         getattr(self, "refresh_alt", 0),
                         getattr(self, "refresh_last", 1),
                         bool(self.use_bilinear), self.w, self.h)
        with trace.span("dec.submit"):
            self._pending = self._dispatch_pool.submit(
                self._dispatch, np_args, meta, trace.handoff())

    def _dispatch(self, np_args, meta, origin=None):
        """The dispatch worker's job for one frame. It keeps its first
        failure for the entropy thread and refuses the frames queued behind
        it until that has been reported, so none of them advances the ring
        past the last committed frame. `origin` (trace.handoff) carries
        the frame id and parent span from the entropy thread."""
        frame, parent = trace.picked_up("dec.queue_wait", origin)
        if self._dispatch_error is not None:
            raise RuntimeError("frame not dispatched: an earlier dispatch "
                               "failed")
        try:
            with trace.span("dec.dispatch", frame=frame, parent=parent):
                return self._worker_dispatch(np_args, meta)
        except BaseException as e:
            self._dispatch_error = e
            raise

    def _upload_qcoeff(self, qcoeff):
        """int16 coefficients to the device; on CUDA through a pinned
        staging buffer, reused once its previous copy has finished."""
        if self._stream is None:
            return torch.from_numpy(qcoeff)
        if self._pinned is None or self._pinned.shape != qcoeff.shape:
            self._pinned = torch.empty(qcoeff.shape, dtype=torch.int16,
                                       pin_memory=True)
            self._pinned_free = None
        if self._pinned_free is not None:
            with trace.span("dec.pinned_wait"):
                self._pinned_free.synchronize()
        self._pinned.numpy()[...] = qcoeff
        dev = self._pinned.to(self.device, non_blocking=True)
        self._pinned_free = torch.cuda.Event()
        self._pinned_free.record(self._stream)
        return dev

    def _worker_dispatch(self, np_args, meta):
        """Dispatch-worker thread: upload, run the device work, build the
        frame, apply the reference-ring swap (handles only)."""
        cur = self._frame_device(np_args, meta)
        if meta.frame_type == 0:
            self.golden = self.altref = self.last = cur
        else:
            if meta.copy_to_arf == 1:
                self.altref = self.last
            elif meta.copy_to_arf == 2:
                self.altref = self.golden
            if meta.copy_to_gf == 1:
                self.golden = self.last
            elif meta.copy_to_gf == 2:
                self.golden = self.altref
            if meta.refresh_golden:
                self.golden = cur
            if meta.refresh_alt:
                self.altref = cur
            if meta.refresh_last:
                self.last = cur
        return cur

    def _frame_device(self, np_args, meta):
        """Upload one frame's arrays and enqueue its device work; returns
        the DeviceFrame."""
        R, C, simple_lf, do_lf = meta.R, meta.C, meta.simple_lf, meta.do_lf
        use_bilinear, w, h = meta.use_bilinear, meta.w, meta.h
        table, qcoeff, inter_idx, taps, split = np_args
        dev = self.device
        with self._on_stream(), torch.inference_mode():
            with trace.span("dec.upload") as sp:
                tdev = self._taps.get(use_bilinear)
                if sp:
                    sent = (table, qcoeff, inter_idx, *(split or ()),
                            *((taps,) if tdev is None else ()))
                    sp.attrs["bytes"] = sum(a.nbytes for a in sent)
                if tdev is None:
                    tdev = torch.from_numpy(taps).to(dev)
                    self._taps[use_bilinear] = tdev
                mb = {"table": torch.from_numpy(table).to(dev),
                      "qcoeff": self._upload_qcoeff(qcoeff),
                      "inter_idx": torch.from_numpy(inter_idx).to(dev)}
                if split is not None:
                    split = tuple(torch.from_numpy(a).to(dev)
                                  for a in split)
            with trace.span("dec.enqueue"):
                refs = None
                if len(inter_idx):
                    refs = tuple(tuple(getattr(f, p) for f in (
                        self.last, self.golden, self.altref))
                        for p in ("y", "u", "v"))
                cy, cu, cv = decode_frame_device(R, C, simple_lf, do_lf,
                                                 refs, mb, tdev, split)
                ready = None
                if self._stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
        return DeviceFrame(cy, cu, cv, w, h, ready)

    def _upload_frame(self, planes):
        """A DeviceFrame holding the decoder's own copy of bordered numpy
        uint8 planes (y, u, v), validated against its geometry."""
        arrs = checked_planes(self.mb_rows, self.mb_cols, planes)
        with self._on_stream():
            ts = [torch.from_numpy(a).to(self.device) for a in arrs]
            ready = None
            if self._stream is not None:
                ready = torch.cuda.Event()
                ready.record(self._stream)
        return DeviceFrame(*ts, self.w, self.h, ready)

    def _swap_and_filter(self):
        # the device-side swap runs on the dispatch worker; here only the
        # entropy-context restore (sequential with the entropy thread)
        self.frame_to_show = FrameFuture(self._pending, self)
        if not self.refresh_entropy:
            self.fc = self.lfc.copy()

    # -- host array prep ---------------------------------------------------

    def _prep_arrays(self):
        """Per-frame host arrays: the per-MB int32 table (kernel parameter
        rows, dequant, MVs), dense int16 coefficients, the inter-MB list,
        the MC taps and the SPLITMV worklist (or None)."""
        R, C = self.mb_rows, self.mb_cols
        N = R * C
        mode = self.mode[1:, 1:].reshape(N)
        ref_frame = self.ref_frame[1:, 1:].reshape(N)
        intra = ref_frame == INTRA_FRAME
        has_y2 = (mode != B_PRED) & (mode != SPLITMV)
        tab = np.zeros((N, MB_COLS), np.int32)
        tab[:, COL_INTRA + 0] = mode
        tab[:, COL_INTRA + 1] = self.uv_mode.reshape(N)
        tab[:, COL_INTRA + 2] = intra
        tab[:, COL_INTRA + 4:COL_INTRA + 20] = self.bmode[1:, 1:].reshape(N,
                                                                        16)
        tab[:, COL_REF] = np.clip(ref_frame - 1, 0, 2)
        tab[:, COL_HASY2] = has_y2
        tab[:, COL_Y2BIG] = self.eobs.reshape(N, 25)[:, 24] > 1
        qcoeff = np.ascontiguousarray(self.qcoeff.reshape(N, 25, 16),
                                      dtype=np.int16)

        # per-MB dequant vectors (mb_init_dequantizer, decodframe.c:67-109):
        # at most 4 segment variants, gathered by segment id
        segs = self.seg_map.reshape(N)
        base_dq = dequant_factors(self.base_qindex, self.y1dc_d, self.y2dc_d,
                                  self.y2ac_d, self.uvdc_d, self.uvac_d)
        if self.segmentation_enabled:
            seg_dq = {}
            per_seg = [self._mb_dequant_seg(s, base_dq, seg_dq)
                       for s in range(4)]
            tab[:, COL_DQ:COL_DQ + 6] = np.asarray(
                per_seg, np.int32).reshape(4, 6)[segs]
        else:
            tab[:, COL_DQ:COL_DQ + 6] = np.asarray(base_dq,
                                                   np.int32).reshape(6)

        # loop filter per-MB params, all table gathers
        if self.filter_level:
            lim, blim, mblim = self._lf_limits()
            lvl = self._lf_levels()
            mode_lut = np.zeros(10, np.int32)
            for k, v in self._MODE_LF_LUT.items():
                mode_lut[k] = v
            hev_lut = np.asarray([self._hev_threshold(f) for f in range(64)],
                                 np.int32)
            flevel = lvl[segs, ref_frame, mode_lut[mode]]
            lf = tab[:, COL_LF:COL_LF + W.LF_COLS]
            lf[:, 0] = flevel
            lf[:, 1] = mblim[flevel]
            lf[:, 2] = blim[flevel]
            lf[:, 3] = lim[flevel]
            lf[:, 4] = hev_lut[flevel]
            lf[:, 5] = ~(has_y2 & (self.skip.reshape(N) != 0))

        y_mv, uv_mv = self._prep_mvs()
        tab[:, COL_MV:COL_MV + 2] = y_mv[:, 0]
        tab[:, COL_UVMV:COL_UVMV + 2] = uv_mv[:, 0]
        inter_idx = np.flatnonzero(~intra).astype(np.int64)
        split = None
        is_split = mode[inter_idx] == SPLITMV
        if is_split.any():
            pos = np.flatnonzero(is_split)
            sp = inter_idx[pos]
            split = (pos.astype(np.int64),
                     np.ascontiguousarray(y_mv[sp], dtype=np.int32),
                     np.ascontiguousarray(uv_mv[sp], dtype=np.int32))
        taps = P.BILINEAR_AS_SIXTAP if self.use_bilinear else P.SIXTAP_TABLE
        return tab, qcoeff, inter_idx, np.asarray(taps, np.int32), split

    def _mb_dequant_seg(self, seg, base_dq, cache):
        """Per-segment dequant variant (mb_init_dequantizer decodframe.c:74-89)."""
        if self.mb_segment_abs_delta:
            q = int(self.segment_feature_data[0, seg])
        else:
            q = min(127, max(0, self.base_qindex +
                             int(self.segment_feature_data[0, seg])))
        if q not in cache:
            cache[q] = dequant_factors(q, self.y1dc_d, self.y2dc_d,
                                       self.y2ac_d, self.uvdc_d, self.uvac_d)
        return cache[q]

    def _prep_mvs(self):
        """Clamped per-tile MVs (the host half of vp8_build_inter_predictors_mb
        reconinter.c:384-593: UMV clamping + chroma MV derivation).
        Vectorized for the common non-SPLITMV case; SPLITMV MBs (rare) loop.
        """
        R, C = self.mb_rows, self.mb_cols
        N = R * C
        mode = self.mode[1:, 1:].reshape(N)
        inter = self.ref_frame[1:, 1:].reshape(N) != INTRA_FRAME
        mrow = self.mv[1:, 1:, 0].reshape(N).astype(np.int64)
        mcol = self.mv[1:, 1:, 1].reshape(N).astype(np.int64)
        nclamp = self.need_clamp.reshape(N) != 0
        cidx = np.arange(N) % C
        ridx = np.arange(N) // C
        m2l = -(cidx * 16) << 3
        m2r = ((C - 1 - cidx) * 16) << 3
        m2t = -(ridx * 16) << 3
        m2b = ((R - 1 - ridx) * 16) << 3
        fullmask = 0xFFFFFFF8 if self.full_pixel else 0xFFFFFFFF

        def fpmask_v(v):
            w = (v & fullmask & 0xFFFF).astype(np.int64)
            return np.where(w >= 0x8000, w - 0x10000, w)

        def clamp_umv_v(row, col):
            col = np.where(col < m2l - (19 << 3), m2l - (16 << 3),
                           np.where(col > m2r + (18 << 3), m2r + (16 << 3),
                                    col))
            row = np.where(row < m2t - (19 << 3), m2t - (16 << 3),
                           np.where(row > m2b + (18 << 3), m2b + (16 << 3),
                                    row))
            return row, col

        crow, ccol = clamp_umv_v(mrow, mcol)
        crow = np.where(nclamp, crow, mrow)
        ccol = np.where(nclamp, ccol, mcol)
        # chroma derivation (reconinter.c:418-424): toward-zero halving
        def half_tz(v):
            w = v + np.where(v >= 0, 1, -1)
            return np.where(w >= 0, w // 2, -((-w) // 2))

        urow = fpmask_v(half_tz(crow))
        ucol = fpmask_v(half_tz(ccol))

        y_mv = np.zeros((N, 16, 2), np.int32)
        uv_mv = np.zeros((N, 4, 2), np.int32)
        y_mv[:, :, 0] = np.where(inter, crow, 0)[:, None]
        y_mv[:, :, 1] = np.where(inter, ccol, 0)[:, None]
        uv_mv[:, :, 0] = np.where(inter, urow, 0)[:, None]
        uv_mv[:, :, 1] = np.where(inter, ucol, 0)[:, None]

        # SPLITMV MBs: per-sub-block MVs (loop; typically few per frame)
        for n in np.nonzero(mode == SPLITMV)[0]:
            r, c = int(n) // C, int(n) % C
            pr, pc = r + 1, c + 1
            l2, r2, t2, b2 = int(m2l[n]), int(m2r[n]), int(m2t[n]), int(m2b[n])
            nc = bool(nclamp[n])

            def clamp_umv(mv):
                row, col = mv
                if col < l2 - (19 << 3):
                    col = l2 - (16 << 3)
                elif col > r2 + (18 << 3):
                    col = r2 + (16 << 3)
                if row < t2 - (19 << 3):
                    row = t2 - (16 << 3)
                elif row > b2 + (18 << 3):
                    row = b2 + (16 << 3)
                return row, col

            def clamp_uvmv(mv):
                row, col = mv
                col = ((l2 - (16 << 3)) >> 1) if 2 * col < l2 - (19 << 3) \
                    else col
                col = ((r2 + (16 << 3)) >> 1) if 2 * col > r2 + (18 << 3) \
                    else col
                row = ((t2 - (16 << 3)) >> 1) if 2 * row < t2 - (19 << 3) \
                    else row
                row = ((b2 + (16 << 3)) >> 1) if 2 * row > b2 + (18 << 3) \
                    else row
                return row, col

            def fpmask(v):
                return _s16(v & fullmask & 0xFFFF)

            bmv = [(int(self.bmv[pr, pc, i, 0]), int(self.bmv[pr, pc, i, 1]))
                   for i in range(16)]
            for i in range(16):
                y_mv[n, i] = clamp_umv(bmv[i]) if nc else bmv[i]
            for i in range(2):
                for jq in range(2):
                    yoffs = i * 8 + jq * 2
                    tr = sum(bmv[yoffs + k][0] for k in (0, 1, 4, 5))
                    tc = sum(bmv[yoffs + k][1] for k in (0, 1, 4, 5))
                    tr = tr + 4 + (-8 if tr < 0 else 0)
                    tc = tc + 4 + (-8 if tc < 0 else 0)
                    mr = fpmask(tr // 8 if tr >= 0 else -((-tr) // 8))
                    mc = fpmask(tc // 8 if tc >= 0 else -((-tc) // 8))
                    if nc:
                        mr, mc = clamp_uvmv((mr, mc))
                    uv_mv[n, i * 2 + jq] = (mr, mc)
        return y_mv, uv_mv


_plane_shapes = W.plane_shapes


def checked_planes(R, C, planes):
    """Own numpy copies of bordered uint8 reference planes (y, u, v) of
    an R x C MB frame; raises ValueError on any other dtype or shape."""
    out = []
    for a, shape in zip(planes, _plane_shapes(R, C)):
        a = np.asarray(a)
        if a.dtype != np.uint8 or a.shape != shape:
            raise ValueError(f"reference plane must be uint8 {shape},"
                             f" got {a.dtype} {a.shape}")
        # own copy: the decoder never aliases the caller's array
        out.append(np.array(a))
    return out


def load_reference(dec, which, planes):
    """Install one reference slot of a TorchDecoder (the set_reference
    control): `which` is "last", "golden" or "altref", `planes` a (y, u, v)
    tuple of bordered numpy uint8 planes ([R*16+64, C*16+64] luma,
    [R*8+32, C*8+32] chroma). The other two slots stay on the device as
    they are. Joins the dispatch worker first, so the ring it changes is
    the one the last decoded frame left. The decoder must already know
    the frame geometry (a keyframe was decoded)."""
    if which not in ("last", "golden", "altref"):
        raise KeyError(which)
    dec._sync()
    setattr(dec, which, dec._upload_frame(planes))


def load_reference_ring(dec, last, golden, altref):
    """Install a whole reference ring in a TorchDecoder: each of
    last/golden/altref as in `load_reference`, e.g. another decoder's
    reference frames. A sharded decoder (parallel/sharded_decode.py)
    splits each frame over its shards."""
    dec._sync()
    frames = [dec._upload_frame(p) for p in (last, golden, altref)]
    dec.last, dec.golden, dec.altref = frames


def _frames(dec, stream, limit):
    count = 0
    for payload, _pts in stream.frames:
        show, planes = dec.decode_frame(payload)
        if show:
            yield planes
            count += 1
            if limit and count >= limit:
                return


def decode_ivf_torch(path_or_bytes, limit=None, device="cuda"):
    """Decode an IVF stream; returns an iterator of visible (y, u, v) numpy
    planes per shown frame. Raises at once if `device` is unusable."""
    from ..utils.ivf import read_ivf
    dec = TorchDecoder(device=device)
    return _frames(dec, read_ivf(path_or_bytes), limit)
