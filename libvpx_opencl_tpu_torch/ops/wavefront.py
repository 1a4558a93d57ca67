"""Intra-reconstruction (K1) and loop-filter (K2) wavefronts.

Ports libvpx_opencl_tpu/models/wavefront.py (intra_recon_blocks,
loop_filter_blocks) and the two Pallas TPU kernels of
libvpx_opencl_tpu/ops/pallas_wavefront.py (_intra_kernel, _lf_kernel).

Both stages work in place on bordered raster uint8 planes (luma border
BORDER, chroma BORDER/2):

  * K1 (csrc/intra_wavefront.cu) reconstructs the intra MBs; the caller
    has already written every inter MB's reconstruction into the planes.
  * K2 (csrc/lf_wavefront.cu) loop-filters the planes in place, with the
    result of raster-order filtering; the TPU kernel's deferred L/U edit
    strips and lf_compose have no counterpart.

MB (r,c) of either stage depends only on MBs (r,c-1) and (r-1, c-1..c+1).
The plain versions, which are the specification, walk offset-2 diagonals
(MB (r,c) lies on diagonal 2r+c) through a per-MB-set step. The kernels
run one persistent launch per call in which MB rows go to thread blocks in
start order and MB (r,c) waits until row r-1 has finished min(c+2, C) MBs;
tests/test_torch_rowlag.py shows with the plain step that every such
order gives the diagonal result.

The TPU kernels' diag-major lane layout exists for the TPU's 128-lane
vector memory and is not carried over.

Both stages take `top_interior`, for a row shard of a taller frame
(parallel/sharded_wavefront.py): MB row 0 is then an interior row whose
above pixels lie in the plane's top border. K1 reads the above row,
above-right and top-left pixels there instead of the frame-edge values
(the caller has put the last unfiltered pixel row above into border row
-1); K2 filters row 0's top MB edge against border rows -4..-1 (the
filtered last rows above) and changes at most rows -3..-1. With the flag
off every call gives what it gave before the flag existed.

Per kernel there are three entry points:
  * `*_planes`: the plane-level wrapper the decoder calls. For CUDA
    tensors it launches the kernel (one launch per call, counted in
    `launches`) or raises; for CPU tensors it runs the plain version.
    There is no fallback from one to the other.
  * `intra_recon` / `loop_filter`: the JAX package's block layout
    ([N,16,16] / [N,8,8] int32 per MB), over the plane-level wrapper.
  * `intra_recon_plain` / `loop_filter_plain`: the same block layout over
    the plain PyTorch version, on any device, with the JAX package's
    integer arithmetic.
"""
from __future__ import annotations

import torch

from . import _cuda
from . import loopfilter as lfops
from . import predict as P

BORDER = 32                # luma plane border; chroma uses BORDER // 2
B_PRED_M = 4
INTRA_COLS = 20            # mode, uv_mode, intra, unused, bmodes[16]
LF_COLS = 8                # flevel, mblim, blim, lim, hev, noskip, unused x2
MAX_COLS = 1024            # MB columns K1 takes: VP8 widths are 14 bits

#: kernel launches per kernel (shared with every kernel wrapper)
launches = _cuda.launches


def diag_depth(R, C):
    return 2 * (R - 1) + C


def _diag_mbs(R, C, d, device):
    """MB rows and columns on diagonal d (c = d - 2r, 0 <= c < C)."""
    r_lo = max(0, (d - C + 2) // 2)
    r_hi = min(R - 1, d // 2)
    r = torch.arange(r_lo, r_hi + 1, device=device)
    return r, d - 2 * r


# ---------------------------------------------------------------------------
# layout helpers

def plane_shapes(R, C):
    """Shapes of the bordered (y, u, v) planes of an R x C MB grid."""
    b, b2 = BORDER, BORDER // 2
    return ((R * 16 + 2 * b, C * 16 + 2 * b),
            (R * 8 + 2 * b2, C * 8 + 2 * b2),
            (R * 8 + 2 * b2, C * 8 + 2 * b2))


def alloc_planes(R, C, device):
    """Uninitialised bordered uint8 planes (y, u, v) for an R x C MB grid."""
    return tuple(torch.empty(shape, dtype=torch.uint8, device=device)
                 for shape in plane_shapes(R, C))


def mb_view(plane, R, C, n):
    """[R, C, n, n] strided view of the MB grid inside a bordered plane."""
    b = BORDER if n == 16 else BORDER // 2
    return plane[b:b + R * n, b:b + C * n].view(R, n, C, n).permute(0, 2, 1,
                                                                    3)


def blocks_to_planes(R, C, yb, ub, vb):
    """[N,16,16] / [N,8,8] blocks holding 0..255 -> zero-bordered planes."""
    planes = []
    for blk, n in ((yb, 16), (ub, 8), (vb, 8)):
        b = BORDER if n == 16 else BORDER // 2
        pl = torch.zeros(R * n + 2 * b, C * n + 2 * b, dtype=torch.uint8,
                         device=blk.device)
        mb_view(pl, R, C, n)[...] = blk.reshape(R, C, n, n).to(torch.uint8)
        planes.append(pl)
    return planes


def planes_to_blocks(R, C, y, u, v):
    """Bordered planes -> [N,16,16] / [N,8,8] int32 blocks."""
    return tuple(mb_view(pl, R, C, n).reshape(R * C, n, n).to(torch.int32)
                 for pl, n in ((y, 16), (u, 8), (v, 8)))


def pack_intra_params(mode, uv_mode, intra, bmodes):
    """[N,INTRA_COLS] int32 rows: mode, uv_mode, intra, 0, bmodes[16]."""
    n = mode.shape[0]
    p = torch.zeros(n, INTRA_COLS, dtype=torch.int32, device=mode.device)
    p[:, 0] = mode
    p[:, 1] = uv_mode
    p[:, 2] = intra.to(torch.int32)
    p[:, 4:20] = bmodes
    return p


def pack_lf_params(flevel, mblim, blim, lim, hev, noskip):
    """[N,LF_COLS] int32 rows: flevel, mblim, blim, lim, hev, noskip."""
    cols = (flevel, mblim, blim, lim, hev, noskip)
    p = torch.zeros(flevel.shape[0], LF_COLS, dtype=torch.int32,
                    device=flevel.device)
    for k, col in enumerate(cols):
        p[:, k] = col.to(torch.int32)
    return p


def _origin(plane, border):
    """Device address of MB-grid pixel (0,0) inside a bordered plane."""
    return plane.data_ptr() + border * plane.stride(0) + border


def _check_cuda(R, C, planes, arrays):
    """Validate the plane-level kernel arguments; raise on anything the
    kernels do not take."""
    dev = planes[0].device
    b, b2 = BORDER, BORDER // 2
    shapes = [(R * 16 + 2 * b, C * 16 + 2 * b)] + \
        [(R * 8 + 2 * b2, C * 8 + 2 * b2)] * 2
    for pl, shp in zip(planes, shapes):
        if pl.device != dev or pl.dtype != torch.uint8 or \
                tuple(pl.shape) != shp or pl.stride(1) != 1:
            raise ValueError(f"plane must be uint8 {shp} with unit column "
                             f"stride on {dev}, got {pl.dtype} "
                             f"{tuple(pl.shape)} on {pl.device}")
    if planes[1].stride(0) != planes[2].stride(0):
        raise ValueError("u and v planes must share a row stride")
    for name, (t, shp, contiguous) in arrays.items():
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if contiguous:
            if tuple(t.shape) != shp or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous {shp}, got "
                                 f"{tuple(t.shape)}")
        elif t.dim() != 2 or t.shape[0] != shp[0] or \
                t.shape[1] < shp[1] or t.stride(1) != 1:
            raise ValueError(f"{name} must be [{shp[0]}, >={shp[1]}] with "
                             f"unit-stride rows, got {tuple(t.shape)}")


def _all_on_cpu(*ts):
    return all(t.device.type == "cpu" for t in ts)


def _launch(name, R, planes, *args):
    """One launch of kernel `name` on the current stream of the planes'
    device over bordered planes (y, u, v), with an R+1 int32 zero scratch
    (row ticket and per-row progress counters) allocated on that stream."""
    y, u, v = planes
    fn = _cuda.load()[name]
    with torch.cuda.device(y.device):
        sync = torch.zeros(R + 1, dtype=torch.int32, device=y.device)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        b, b2 = BORDER, BORDER // 2
        rc = fn(_origin(y, b), y.stride(0), _origin(u, b2), _origin(v, b2),
                u.stride(0), *args, sync.data_ptr(), stream)
    _cuda.check(rc, name)
    _cuda.count_launch(name)


# ---------------------------------------------------------------------------
# K1: intra reconstruction

def _edges(plane, border, n, r, c, top_interior=False):
    """Above row, left column and top-left pixel of MBs (r, c), with the
    frame-edge values (above 127, left 129, top-left 127 on MB row 0 and
    129 on MB column 0); with top_interior, row 0 reads the top border."""
    y0 = border + r * n
    x0 = border + c * n
    a = torch.arange(n, device=plane.device)
    up, lf = (r > 0) | top_interior, c > 0
    above = plane[(y0 - 1)[:, None], x0[:, None] + a].to(torch.int32)
    above = torch.where(up[:, None], above, 127)
    left = plane[y0[:, None] + a, (x0 - 1)[:, None]].to(torch.int32)
    left = torch.where(lf[:, None], left, 129)
    corner = plane[y0 - 1, x0 - 1].to(torch.int32)
    tl = torch.where(~up, 127, torch.where(~lf, 129, corner))
    return y0, x0, above, left, tl


def _put_blocks(plane, y0, x0, blocks):
    a = torch.arange(blocks.shape[-1], device=plane.device)
    plane[y0[:, None, None] + a[None, :, None],
          x0[:, None, None] + a[None, None, :]] = blocks.to(torch.uint8)


def above_right(plane, C, r, c, y0, x0, above, top_interior=False):
    """[M,4] above-right pixels of B_PRED MBs (r, c) whose above rows are
    `above`: the row above past the MB, its pixel 15 in the last MB column,
    127 on MB row 0 unless top_interior."""
    a4 = torch.arange(4, device=plane.device)
    ar = plane[(y0 - 1)[:, None], x0[:, None] + 16 + a4].to(torch.int32)
    ar = torch.where(c[:, None] == C - 1, above[:, 15:16], ar)
    return torch.where(((r > 0) | top_interior)[:, None], ar, 127)


def _bpred_mbs(plane, C, r, c, y0, x0, above, left, tl, resid, bmodes,
               top_interior):
    """B_PRED luma: 16 sub-blocks in raster order over a [M,17,21]
    workspace (row 0 = top-left, above and above-right; column 0 = left)."""
    m = r.shape[0]
    ar = above_right(plane, C, r, c, y0, x0, above, top_interior)
    ws = torch.zeros(m, 17, 21, dtype=torch.int32, device=plane.device)
    ws[:, 0, 0] = tl
    ws[:, 0, 1:17] = above
    for row in (0, 4, 8, 12):
        ws[:, row, 17:21] = ar
    ws[:, 1:17, 0] = left
    for k in range(16):
        ir, ic = k >> 2, k & 3
        a8 = ws[:, 4 * ir, 1 + 4 * ic:9 + 4 * ic]
        l4 = ws[:, 1 + 4 * ir:5 + 4 * ir, 4 * ic]
        tl4 = ws[:, 4 * ir, 4 * ic]
        blk = P.bpred_4x4(bmodes[:, k], a8, l4, tl4)
        rs = resid[:, 4 * ir:4 * ir + 4, 4 * ic:4 * ic + 4]
        ws[:, 1 + 4 * ir:5 + 4 * ir, 1 + 4 * ic:5 + 4 * ic] = \
            (blk + rs).clamp(0, 255)
    return ws[:, 1:17, 1:17]


def _intra_step(C, y, u, v, resid_y, resid_u, resid_v, params, r, c,
                top_interior=False):
    """Reconstruct the intra MBs among MBs (r, c) in place, given that
    every MB they depend on is done (any device)."""
    b, b2 = BORDER, BORDER // 2
    n = r * C + c
    sel = params[n, 2] != 0
    if not bool(sel.any()):
        return
    r, c, n = r[sel], c[sel], n[sel]
    mode, uv_mode = params[n, 0], params[n, 1]
    up, lf = (r > 0) | top_interior, c > 0
    y0, x0, above, left, tl = _edges(y, b, 16, r, c, top_interior)
    rec = (P.pred_nxn(mode, above, left, tl, up, lf, 16)
           + resid_y[n]).clamp(0, 255)
    isb = mode == B_PRED_M
    if bool(isb.any()):
        rec[isb] = _bpred_mbs(y, C, r[isb], c[isb], y0[isb], x0[isb],
                              above[isb], left[isb], tl[isb],
                              resid_y[n[isb]], params[n[isb], 4:20],
                              top_interior)
    _put_blocks(y, y0, x0, rec)
    for plane, resid in ((u, resid_u), (v, resid_v)):
        y0, x0, above, left, tl = _edges(plane, b2, 8, r, c, top_interior)
        rec = (P.pred_nxn(uv_mode, above, left, tl, up, lf, 8)
               + resid[n]).clamp(0, 255)
        _put_blocks(plane, y0, x0, rec)


def _intra_planes_plain(R, C, y, u, v, resid_y, resid_u, resid_v, params,
                        top_interior=False):
    """Plain PyTorch K1 over bordered planes, in place (any device)."""
    for d in range(diag_depth(R, C)):
        r, c = _diag_mbs(R, C, d, y.device)
        _intra_step(C, y, u, v, resid_y, resid_u, resid_v, params, r, c,
                    top_interior)


def intra_recon_planes(R, C, y, u, v, resid_y, resid_u, resid_v, params,
                       top_interior=False):
    """K1 in place on bordered uint8 planes that hold every inter MB's
    reconstruction. resid_* [N,16,16] / [N,8,8] int32; params
    [N, >=INTRA_COLS] int32 (pack_intra_params; rows may be strided);
    top_interior: MB row 0 reads its above pixels from the top border
    (module docstring).

    CUDA tensors: one launch of csrc/intra_wavefront.cu, counted in
    launches["intra_wavefront"]. CPU tensors: the plain version."""
    if _all_on_cpu(y, u, v, resid_y, resid_u, resid_v, params):
        _intra_planes_plain(R, C, y, u, v, resid_y, resid_u, resid_v, params,
                            top_interior)
        return
    N = R * C
    if C > MAX_COLS:
        raise ValueError(f"K1 takes at most {MAX_COLS} MB columns, got {C}")
    _check_cuda(R, C, (y, u, v), {
        "resid_y": (resid_y, (N, 16, 16), True),
        "resid_u": (resid_u, (N, 8, 8), True),
        "resid_v": (resid_v, (N, 8, 8), True),
        "params": (params, (N, INTRA_COLS), False)})
    _launch("intra_wavefront", R, (y, u, v), resid_y.data_ptr(),
            resid_u.data_ptr(), resid_v.data_ptr(), params.data_ptr(),
            params.stride(0), R, C, int(bool(top_interior)))


def _intra_blocks(planes_fn, R, C, inter_y, inter_u, inter_v,
                  resid_y, resid_u, resid_v, mode, uv_mode, intra, bmodes):
    y, u, v = blocks_to_planes(R, C, inter_y, inter_u, inter_v)
    params = pack_intra_params(mode, uv_mode, intra, bmodes)
    planes_fn(R, C, y, u, v, resid_y.to(torch.int32).contiguous(),
              resid_u.to(torch.int32).contiguous(),
              resid_v.to(torch.int32).contiguous(), params)
    return planes_to_blocks(R, C, y, u, v)


def intra_recon(R, C, inter_y, inter_u, inter_v, resid_y, resid_u, resid_v,
                mode, uv_mode, intra, bmodes):
    """wavefront.intra_recon_blocks' contract on the kernel path.

    inter_* [N,16,16] / [N,8,8] inter reconstructions in 0..255 (ignored
    for intra MBs); resid_* residual blocks; mode, uv_mode, intra [N];
    bmodes [N,16]. Returns reconstructed y/u/v blocks, int32."""
    return _intra_blocks(intra_recon_planes, R, C, inter_y, inter_u,
                         inter_v, resid_y, resid_u, resid_v, mode, uv_mode,
                         intra, bmodes)


def intra_recon_plain(R, C, inter_y, inter_u, inter_v, resid_y, resid_u,
                      resid_v, mode, uv_mode, intra, bmodes):
    """intra_recon through the plain PyTorch version, on any device."""
    return _intra_blocks(_intra_planes_plain, R, C, inter_y, inter_u,
                         inter_v, resid_y, resid_u, resid_v, mode, uv_mode,
                         intra, bmodes)


# ---------------------------------------------------------------------------
# K2: loop filter

def _filter_mbs(planes, border, n, r, c, simple, mblim, blim, lim, hev,
                noskip, top_interior=False):
    """Filter MBs (r, c) of one diagonal of each plane in `planes` (same
    geometry) as one [P*M, n+4, n+4] patch batch (rows and columns 0-3:
    the above and left neighbours' pixels) and write it back. Edge order:
    left MB edge, inner vertical, top MB edge (on row 0 only with
    top_interior), inner horizontal."""
    a = torch.arange(n + 4, device=r.device)
    rows = (border + r * n - 4)[:, None, None] + a[None, :, None]
    cols = (border + c * n - 4)[:, None, None] + a[None, None, :]
    patch = torch.cat([pl[rows, cols] for pl in planes]).to(torch.int32)
    k = len(planes)
    r, c = r.repeat(k), c.repeat(k)
    mblim, blim, lim, hev, noskip = (
        x.repeat(k, 1) for x in (mblim, blim, lim, hev, noskip))

    def edge(pos, vert, mb_edge, apply):
        if vert:
            pix8 = patch[:, 4:, pos - 4:pos + 4]
        else:
            pix8 = patch[:, pos - 4:pos + 4, 4:].transpose(1, 2)
        lim_b = mblim if mb_edge else blim
        if simple:
            out = lfops.simple_filter_edge(pix8, lim_b, apply)
        else:
            out = lfops.filter_edge(pix8, lim_b, lim, hev, mb_edge, apply)
        if vert:
            patch[:, 4:, pos - 4:pos + 4] = out
        else:
            patch[:, pos - 4:pos + 4, 4:] = out.transpose(1, 2)

    edge(4, True, True, (c > 0)[:, None])
    for pos in range(8, n + 4, 4):
        edge(pos, True, False, noskip)
    edge(4, False, True, ((r > 0) | top_interior)[:, None])
    for pos in range(8, n + 4, 4):
        edge(pos, False, False, noskip)
    for pl, part in zip(planes, patch.to(torch.uint8).chunk(k)):
        pl[rows, cols] = part


def _lf_step(C, simple, y, u, v, params, r, c, top_interior=False):
    """Loop-filter MBs (r, c) in place, given that every MB they depend on
    is done and no two of them touch the same pixels (any device)."""
    b, b2 = BORDER, BORDER // 2
    n = r * C + c
    act = params[n, 0] > 0
    if not bool(act.any()):
        return
    r, c, n = r[act], c[act], n[act]
    mblim, blim, lim, hev = (params[n, k][:, None] for k in range(1, 5))
    noskip = (params[n, 5] != 0)[:, None]
    _filter_mbs((y,), b, 16, r, c, simple, mblim, blim, lim, hev, noskip,
                top_interior)
    if not simple:
        _filter_mbs((u, v), b2, 8, r, c, False, mblim, blim, lim, hev,
                    noskip, top_interior)


def _lf_planes_plain(R, C, simple, y, u, v, params, top_interior=False):
    """Plain PyTorch K2 over bordered planes, in place (any device)."""
    for d in range(diag_depth(R, C)):
        r, c = _diag_mbs(R, C, d, y.device)
        _lf_step(C, simple, y, u, v, params, r, c, top_interior)


def loop_filter_planes(R, C, simple, y, u, v, params, top_interior=False):
    """K2 in place on bordered uint8 planes. params [N, >=6] int32
    (pack_lf_params; rows may be strided); top_interior: MB row 0's top
    edge is filtered against the top border (module docstring).

    CUDA tensors: one launch of csrc/lf_wavefront.cu, counted in
    launches["lf_wavefront"]. CPU tensors: the plain version."""
    if _all_on_cpu(y, u, v, params):
        _lf_planes_plain(R, C, simple, y, u, v, params, top_interior)
        return
    _check_cuda(R, C, (y, u, v),
                {"params": (params, (R * C, 6), False)})
    _launch("lf_wavefront", R, (y, u, v), params.data_ptr(),
            params.stride(0), R, C, int(bool(simple)),
            int(bool(top_interior)))


def _lf_blocks(planes_fn, R, C, simple, y, u, v, flevel, mblim, blim, lim,
               hev, noskip):
    yp, up_, vp = blocks_to_planes(R, C, y, u, v)
    planes_fn(R, C, simple, yp, up_, vp,
              pack_lf_params(flevel, mblim, blim, lim, hev, noskip))
    return planes_to_blocks(R, C, yp, up_, vp)


def loop_filter(R, C, simple, y, u, v, flevel, mblim, blim, lim, hev,
                noskip):
    """wavefront.loop_filter_blocks' contract on the kernel path: y/u/v
    [N,16,16] / [N,8,8] blocks in 0..255 and per-MB [N] parameters.
    Returns the filtered blocks, int32."""
    return _lf_blocks(loop_filter_planes, R, C, simple, y, u, v, flevel,
                      mblim, blim, lim, hev, noskip)


def loop_filter_plain(R, C, simple, y, u, v, flevel, mblim, blim, lim, hev,
                      noskip):
    """loop_filter through the plain PyTorch version, on any device."""
    return _lf_blocks(_lf_planes_plain, R, C, simple, y, u, v, flevel,
                      mblim, blim, lim, hev, noskip)
