"""Prediction ops (PyTorch): batched motion compensation + intra block math.

Port of libvpx_opencl_tpu/ops/predict.py. Every prediction block gathers
its (bw+5)^2 reference window with one advanced-indexing gather and runs
the separable 6-tap filter in two passes (filter.c; the window math is
position-independent, so a 16x16 block equals its sixteen 4x4 tiles):

  * full-pel motion uses phase 0, whose taps {0,0,128,0,0,0} reproduce
    vp8_copy_mem exactly ((128*x+64)>>7 == x);
  * bilinear streams (version >= 1) pass a tap table with the 2-tap
    kernels embedded as {0,0,a,b,0,0}: identical rounding.

The JAX package also has ops/mc_dense.py, a gather-free formulation that
exists only because gathers are slow on a TPU. A GPU gathers well, so the
port has no counterpart: every inter MB goes through mc_predict_blocks,
and SPLITMV sub-blocks through mc_predict_tiles.

Window starts follow jax.lax.dynamic_slice exactly: a negative start is
first counted from the end of the axis (once), then every start is clamped
so that the window fits. Torch indexing does neither by itself. In a
decode, only a motion vector reaching more than BORDER-2 pixels above or
left of the frame produces such a start.

The intra block math (pred_nxn, bpred_4x4) mirrors reconintra.c and
reconintra4x4.c, batched over macroblocks; ops/wavefront.py's plain intra
recon uses it.
"""
import numpy as np
import torch

from . import tables as T

# unified 6-tap tables (int32): index 0..7 = subpel phase
SIXTAP_TABLE = np.ascontiguousarray(T.SUBPEL_FILTERS, dtype=np.int32)
BILINEAR_AS_SIXTAP = np.zeros((8, 6), dtype=np.int32)
BILINEAR_AS_SIXTAP[:, 2] = T.BILINEAR_FILTERS[:, 0]
BILINEAR_AS_SIXTAP[:, 3] = T.BILINEAR_FILTERS[:, 1]


def _slice_start(s, dim, w):
    """jax.lax.dynamic_slice's start rule: a negative start counts from
    the end (once, as Python indexing does), then the start is clamped so
    that the whole window fits."""
    return torch.where(s < 0, s + dim, s).clamp(0, dim - w)


def _gather_windows(ref_planes, ref_idx, starts, w):
    """[B, w, w] int32 windows whose top-left is starts-2, placed by
    dynamic_slice's start rule."""
    _, H, W = ref_planes.shape
    dev = ref_planes.device
    y0 = _slice_start(starts[:, 0] - 2, H, w)
    x0 = _slice_start(starts[:, 1] - 2, W, w)
    a = torch.arange(w, device=dev)
    rows = (y0[:, None] + a[None, :])[:, :, None]
    cols = (x0[:, None] + a[None, :])[:, None, :]
    return ref_planes[ref_idx.long()[:, None, None], rows.long(),
                      cols.long()].to(torch.int32)


def _sixtap(win, tx, ty, bw):
    """Separable 6-tap over windows [B, bw+5, bw+5] -> [B, bw, bw]."""
    h = torch.zeros(win.shape[0], bw + 5, bw, dtype=torch.int32,
                    device=win.device)
    for j in range(6):
        h = h + win[:, :, j:j + bw] * tx[:, j, None, None]
    h = ((h + 64) >> 7).clamp(0, 255)
    v = torch.zeros(win.shape[0], bw, bw, dtype=torch.int32,
                    device=win.device)
    for j in range(6):
        v = v + h[:, j:j + bw, :] * ty[:, j, None, None]
    return ((v + 64) >> 7).clamp(0, 255)


def mc_predict_blocks(ref_planes, ref_idx, starts, xphase, yphase, taps, bw):
    """Batched bw x bw sub-pel prediction with one gather per block.

    ref_planes [nref, H, W] uint8; ref_idx [B]; starts [B,2] full-pel
    top-left (y, x) in padded coordinates; x/yphase [B] subpel phase 0..7;
    taps [8,6] int32; bw = 16 (luma) or 8 (chroma). Returns [B,bw,bw]
    int32.
    """
    win = _gather_windows(ref_planes, ref_idx, starts, bw + 5)
    return _sixtap(win, taps[xphase.long()], taps[yphase.long()], bw)


def mc_predict_tiles(ref_planes, ref_idx, starts, xphase, yphase, taps):
    """Batched 4x4 sub-pel prediction (SPLITMV sub-blocks and chroma
    quads); same contract as mc_predict_blocks with bw = 4."""
    return mc_predict_blocks(ref_planes, ref_idx, starts, xphase, yphase,
                             taps, 4)


# ---------------------------------------------------------------------------
# intra prediction block math (int32 in, int32 out), batched over MBs

def pred_nxn(mode, above, left, tl, up_avail, left_avail, n):
    """16x16 / 8x8 intra prediction (reconintra.c:136-470), batched.

    mode [M]; above [M,n]; left [M,n]; tl [M]; up/left_avail [M] bool.
    Modes DC=0, V=1, H=2, TM=3 (other values clip to that range).
    Returns [M, n, n] int32.
    """
    up_i = up_avail.to(torch.int32)
    left_i = left_avail.to(torch.int32)
    total = above.sum(1) * up_i + left.sum(1) * left_i
    shift = (n.bit_length() - 2) + up_i + left_i
    dc = torch.where(up_avail | left_avail,
                     (total + (1 << (shift - 1))) >> shift,
                     128).to(torch.int32)
    m = above.shape[0]
    dc_blk = dc[:, None, None].expand(m, n, n)
    v_blk = above[:, None, :].expand(m, n, n)
    h_blk = left[:, :, None].expand(m, n, n)
    tm_blk = (left[:, :, None] + above[:, None, :]
              - tl[:, None, None]).clamp(0, 255)
    mode = mode.clamp(0, 3)[:, None, None]
    out = torch.where(mode == 1, v_blk, dc_blk)
    out = torch.where(mode == 2, h_blk, out)
    return torch.where(mode == 3, tm_blk, out)


# Each 4x4 B_PRED mode picks its 16 pixels from one bank of per-MB values:
# the reference's two filters e3(a,b,c) = (a+2b+c+2)>>2 and
# h2(a,b) = (a+b+1)>>1 over every window of the edge sequence
#   S = L3 L3 L2 L1 L0 tl A0 A1 A2 A3 A4 A5 A6 A7 A7
# (e3 is symmetric, so e3(L2,L3,L3) = e3(L3,L3,L2); h2(L3,L3) = L3), then
# DC and the TM block. Bank columns: E(k) = e3(S[k..k+2]) at k (0-12),
# H(k) = h2(S[k..k+1]) at 13+k (0-13), DC at 27, TM at 28-43 (row-major).
_BANK_IDX = np.array([
    [27] * 16,                                                   # B_DC
    list(range(28, 44)),                                         # B_TM
    [5, 6, 7, 8] * 4,                                            # B_VE
    [3] * 4 + [2] * 4 + [1] * 4 + [0] * 4,                       # B_HE
    [6 + i + j for i in range(4) for j in range(4)],             # B_LD
    [4 - i + j for i in range(4) for j in range(4)],             # B_RD
    [18, 19, 20, 21, 4, 5, 6, 7, 3, 18, 19, 20, 2, 4, 5, 6],     # B_VR
    [19, 20, 21, 22, 6, 7, 8, 9, 20, 21, 22, 10, 7, 8, 9, 11],   # B_VL
    [17, 4, 5, 6, 16, 3, 17, 4, 15, 2, 16, 3, 14, 1, 15, 2],     # B_HD
    [16, 2, 15, 1, 15, 1, 14, 0, 14, 0, 13, 13, 13, 13, 13, 13],  # B_HU
], dtype=np.int64)


def _bpred_bank(above8, left4, tl):
    """[M, 44] int32 bank of candidate pixel values (see _BANK_IDX)."""
    A, L, t = above8, left4, tl[:, None]
    S = torch.cat([L[:, 3:], L.flip(1), t, A, A[:, 7:]], 1)
    e3 = (S[:, :-2] + 2 * S[:, 1:-1] + S[:, 2:] + 2) >> 2
    h2 = (S[:, :-1] + S[:, 1:] + 1) >> 1
    dc = (A[:, :4].sum(1) + L.sum(1) + 4) >> 3
    tm = (L[:, :, None] + A[:, None, :4] - t[:, :, None]).clamp(0, 255)
    return torch.cat([e3, h2, dc[:, None], tm.reshape(-1, 16)],
                     1).to(torch.int32)


def bpred_4x4_all(above8, left4, tl):
    """All ten 4x4 B_PRED predictions (vp8_intra4x4_predict_c,
    reconintra4x4.c:17-289), batched: above8 [M,8], left4 [M,4], tl [M]
    int32. Returns [10, M, 4, 4] in bmode order B_DC, B_TM, B_VE, B_HE,
    B_LD, B_RD, B_VR, B_VL, B_HD, B_HU."""
    bank = _bpred_bank(above8, left4, tl)
    idx = torch.from_numpy(_BANK_IDX).to(bank.device)
    return bank[:, idx].permute(1, 0, 2).reshape(10, -1, 4, 4)


def bpred_4x4(mode, above8, left4, tl):
    """One 4x4 B_PRED block per MB: mode [M] (clipped to 0..9), above8
    [M,8], left4 [M,4], tl [M]. Returns [M, 4, 4] int32."""
    bank = _bpred_bank(above8, left4, tl)
    idx = torch.from_numpy(_BANK_IDX).to(bank.device)[mode.clamp(0, 9).long()]
    return bank.gather(1, idx).reshape(-1, 4, 4)
