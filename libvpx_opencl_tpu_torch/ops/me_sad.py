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

Both raise if a window does not lie inside the plane or a source value
lies outside [0, 255] (the kernel packs source pixels into bytes); nothing
is clamped. The wrapper takes radii 1..MAX_RNG; `_plan` gives the kernel's
launch geometry for each.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import trace
from . import _cuda

RNG = 16  # full-pel search radius
MAX_RNG = 16              # largest radius the wrapper takes
launches = _cuda.launches
_MAX_SHARED = 48 * 1024   # static limit of a block's shared memory
# as compiled into csrc/sad_grid.cu
K = 11                    # consecutive dx offsets per thread
_NW = (K + 14) // 4 + 2   # 32-bit window words a thread loads per row
_SRC_BYTES = 17 * 16      # one MB's packed source rows, padded by a row
_THREADS = 512            # most threads per block (launch bounds)


class Plan(NamedTuple):
    threads_per_mb: int   # (2*rng+1) dy x groups
    k: int                # dx offsets per thread
    groups: int           # runs of k dx per dy (the last may be ragged)
    mbs: int              # MBs per thread block
    pitch: int            # window row pitch in shared memory, bytes
    shared: int           # shared-memory bytes per block


def _plan(rng):
    """Launch geometry of csrc/sad_grid.cu at radius `rng`: one thread per
    (dy, run of K consecutive dx), `mbs` MBs per block, each MB's window
    staged with a 16-byte-multiple row pitch. A thread loads _NW words from
    its run's first word, so the last row of the last window may read past
    its pitch into a zero tail that `shared` includes."""
    if not 1 <= rng <= MAX_RNG:
        raise ValueError(f"rng={rng}: the SAD-grid kernel takes radii "
                         f"1..{MAX_RNG}")
    n_c = 2 * rng + 1
    w = n_c + 15
    groups = -(-n_c // K)
    tpm = n_c * groups
    pitch = -(-w // 16) * 16
    reach = 4 * ((groups - 1) * K // 4 + _NW)
    tail = -(-max(0, reach - pitch) // 16) * 16
    per_mb = _SRC_BYTES + w * pitch
    mbs = max(1, min(_THREADS // tpm, (_MAX_SHARED - tail) // per_mb))
    return Plan(tpm, K, groups, mbs, pitch, mbs * per_mb + tail)


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
    if n:
        # both conditions come back in one host read
        checks = torch.stack([
            ((wy < 0) | (wy > hp - w) | (wx < 0) | (wx > wp - w)).any(),
            ((src_blocks < 0) | (src_blocks > 255)).any()])
        with trace.host_wait():
            bad_win, bad_src = checks.tolist()
        if bad_win:
            raise ValueError(f"a search window leaves the {hp}x{wp} plane: "
                             f"wy in [{int(wy.min())}, {int(wy.max())}], "
                             f"wx in [{int(wx.min())}, {int(wx.max())}], "
                             f"window {w}")
        if bad_src:
            raise ValueError(f"src_blocks values must lie in [0, 255], got "
                             f"[{int(src_blocks.min())}, "
                             f"{int(src_blocks.max())}]")
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

    rng must lie in 1..MAX_RNG.

    CUDA tensors: launches csrc/sad_grid.cu once and adds one to
    launches["sad_grid"]. CPU tensors: the plain version."""
    plan = _plan(rng)
    if ref_plane.device.type == "cpu":
        return sad_grid_plain(ref_plane, wy, wx, src_blocks, rng)
    _check(ref_plane, wy, wx, src_blocks, rng)
    if ref_plane.stride(1) != 1:
        raise ValueError("ref_plane must have unit column stride")
    n = src_blocks.shape[0]
    n_c = 2 * rng + 1
    out = torch.empty(n, n_c, n_c, dtype=torch.int32,
                      device=ref_plane.device)
    if n:
        _launch(ref_plane, wy.to(torch.int32).contiguous(),
                wx.to(torch.int32).contiguous(), src_blocks.contiguous(),
                out, rng, plan)
    return out


def _launch(ref_plane, wy, wx, src, out, rng, plan):
    """One launch of csrc/sad_grid.cu on the current stream, counted in
    launches["sad_grid"]. No checks: `sad_grid` makes them (wy, wx int32
    and src int32 contiguous, out [N, 2*rng+1, 2*rng+1] int32, N > 0)."""
    fn = _cuda.load()["sad_grid"]
    with torch.cuda.device(ref_plane.device):
        stream = torch.cuda.current_stream(ref_plane.device).cuda_stream
        rc = fn(ref_plane.data_ptr(), ref_plane.stride(0), wy.data_ptr(),
                wx.data_ptr(), src.data_ptr(), out.data_ptr(),
                src.shape[0], rng, plan.k, plan.groups, plan.mbs,
                plan.pitch, plan.shared, stream)
    _cuda.check(rc, "sad_grid")
    _cuda.count_launch("sad_grid")
