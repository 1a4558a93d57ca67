"""K3: the exhaustive full-pel SAD grid of the encoder's motion search.

Counterpart of libvpx_opencl_tpu/ops/me_pallas.py (sad_grid_pallas): for
each MB, the int32 SAD of its 16x16 source block at all (2*rng+1)^2
full-pel offsets of a (2*rng+16)^2 window of the reference
(vp8_full_search_sad, mcomp.c:1295).

Unlike the JAX function, which takes windows already gathered into an
[N,W,W] int32 tensor, both versions here read the windows from the
bordered reference plane, given each window's top-left corner.

  * `sad_grid`: for CUDA tensors it launches csrc/sad_grid.cu (one launch
    per call, counted in `launches["sad_grid"]`) or raises; for CPU
    tensors it runs `sad_grid_plain`. There is no fallback from one to the
    other.
  * `sad_grid_plain`: the same function in plain PyTorch, on any device.

Both raise if a window does not lie inside the plane; nothing is clamped.
"""
from __future__ import annotations

import torch

from . import _cuda

RNG = 16  # full-pel search radius
launches = _cuda.launches
_MAX_SHARED = 48 * 1024   # static limit of a block's shared memory


def _check(ref_plane, wy, wx, src_blocks, rng):
    """Validate the arguments of either version; returns the window size."""
    w = 2 * rng + 16
    n = src_blocks.shape[0]
    if ref_plane.dtype != torch.uint8 or ref_plane.dim() != 2:
        raise ValueError(f"ref_plane must be a 2-D uint8 plane, got "
                         f"{ref_plane.dtype} {tuple(ref_plane.shape)}")
    if tuple(src_blocks.shape) != (n, 16, 16) or \
            src_blocks.dtype != torch.int32:
        raise ValueError(f"src_blocks must be int32 [N,16,16], got "
                         f"{src_blocks.dtype} {tuple(src_blocks.shape)}")
    for name, t in (("wy", wy), ("wx", wx)):
        if tuple(t.shape) != (n,) or t.dtype not in (torch.int32,
                                                     torch.int64):
            raise ValueError(f"{name} must be an integer [N] tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    devs = {t.device for t in (ref_plane, wy, wx, src_blocks)}
    if len(devs) != 1:
        raise ValueError(f"arguments lie on different devices: {devs}")
    hp, wp = ref_plane.shape
    if hp < w or wp < w:
        raise ValueError(f"plane {hp}x{wp} is smaller than a {w}x{w} window")
    if n and bool(((wy < 0) | (wy > hp - w) | (wx < 0) | (wx > wp - w))
                  .any()):
        raise ValueError(f"a search window leaves the {hp}x{wp} plane: "
                         f"wy in [{int(wy.min())}, {int(wy.max())}], "
                         f"wx in [{int(wx.min())}, {int(wx.max())}], "
                         f"window {w}")
    return w


def sad_grid_plain(ref_plane, wy, wx, src_blocks, rng=RNG):
    """Plain PyTorch K3 (any device); same contract as `sad_grid`."""
    w = _check(ref_plane, wy, wx, src_blocks, rng)
    a = torch.arange(w, device=ref_plane.device)
    win = ref_plane[(wy[:, None] + a)[:, :, None].long(),
                    (wx[:, None] + a)[:, None, :].long()].to(torch.int32)
    src = src_blocks[:, :, None, :]
    rows = []
    for i in range(2 * rng + 1):
        # [N, 16 rows, n_c offsets, 16 columns]
        cols = win[:, i:i + 16, :].unfold(2, 16, 1)
        rows.append((cols - src).abs().sum((1, 3)))
    return torch.stack(rows, 1).to(torch.int32)


def sad_grid(ref_plane, wy, wx, src_blocks, rng=RNG):
    """SAD of every MB's source block at every full-pel offset.

    ref_plane [HP,WP] uint8 bordered reference plane (unit column stride);
    wy, wx [N] top-left of each MB's (2*rng+16)^2 window in the plane;
    src_blocks [N,16,16] int32. Returns [N, 2*rng+1, 2*rng+1] int32 with
    offset (dy, dx) = (-rng + i, -rng + j) at [n, i, j].

    CUDA tensors: launches csrc/sad_grid.cu once and adds one to
    launches["sad_grid"]. CPU tensors: the plain version."""
    if ref_plane.device.type == "cpu":
        return sad_grid_plain(ref_plane, wy, wx, src_blocks, rng)
    w = _check(ref_plane, wy, wx, src_blocks, rng)
    if ref_plane.stride(1) != 1:
        raise ValueError("ref_plane must have unit column stride")
    if 1024 + w * w > _MAX_SHARED:
        raise ValueError(f"rng={rng}: a {w}x{w} window does not fit a "
                         f"block's shared memory")
    n = src_blocks.shape[0]
    n_c = 2 * rng + 1
    out = torch.empty(n, n_c, n_c, dtype=torch.int32,
                      device=ref_plane.device)
    if n == 0:
        return out
    wy = wy.to(torch.int32).contiguous()
    wx = wx.to(torch.int32).contiguous()
    src = src_blocks.contiguous()
    fn = _cuda.load()["sad_grid"]
    with torch.cuda.device(ref_plane.device):
        stream = torch.cuda.current_stream(ref_plane.device).cuda_stream
        rc = fn(ref_plane.data_ptr(), ref_plane.stride(0), wy.data_ptr(),
                wx.data_ptr(), src.data_ptr(), out.data_ptr(), n, rng,
                stream)
    _cuda.check(rc, "sad_grid")
    launches["sad_grid"] += 1
    return out
