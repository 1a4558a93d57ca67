"""Golden NumPy VP8 decoder — the bit-exact host reference model.

This plays the role the RTCD C kernels play in the reference (SURVEY.md §4.4
"dual-implementation differential testing"): a slow, scalar, obviously-correct
decoder validated by MD5 against the reference `vpxdec --md5`, against which
every TPU kernel is tested.

Behavioral citations (reference = the libvpx v1.0.0 sources):
  frame header ......... vp8/decoder/decodframe.c:690-1181
  mode/MV decode ....... vp8/decoder/decodemv.c
  detokenize ........... vp8/decoder/detokenize.c
  dequant/IDCT ......... vp8/common/{dequantize.c,idctllm.c,idct_blk.c}
  intra prediction ..... vp8/common/{reconintra.c,reconintra4x4.c}
  inter prediction ..... vp8/common/{reconinter.c,filter.c}
  loop filter .......... vp8/common/{loopfilter.c,loopfilter_filters.c}
  frame lifecycle ...... vp8/decoder/onyxd_if.c:318-707
  borders .............. vp8/common/{setupintrarecon.c,extend.c},
                         vpx_scale/generic/yv12extend.c
"""
from __future__ import annotations

import numpy as np

from ..ops import tables as T
from ..utils import trace
from .boolcoder import BoolDecoder

# MB prediction modes (blockd.h MB_PREDICTION_MODE)
DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED = 0, 1, 2, 3, 4
NEARESTMV, NEARMV, ZEROMV, NEWMV, SPLITMV = 5, 6, 7, 8, 9
# B modes
B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU = range(10)
# reference frames
INTRA_FRAME, LAST_FRAME, GOLDEN_FRAME, ALTREF_FRAME = 0, 1, 2, 3

BORDER = 32  # yv12config.c VP8BORDERINPIXELS

BLOCK2ABOVE = [0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3,
               4, 5, 4, 5, 6, 7, 6, 7, 8]                       # blockd.c:19
BLOCK2LEFT = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
              4, 4, 5, 5, 6, 6, 7, 7, 8]                        # blockd.c:15

# 16x16-mode -> B-mode for keyframe context (findnearmv.h:129-182)
MODE_TO_BMODE = {DC_PRED: B_DC, V_PRED: B_VE, H_PRED: B_HE, TM_PRED: B_TM}

ZIGZAG = T.ZIGZAG.tolist()
COEF_BANDS = T.COEF_BANDS.tolist()
CAT_PROBS = [T.PCAT1.tolist(), T.PCAT2.tolist(), T.PCAT3.tolist(),
             T.PCAT4.tolist(), T.PCAT5.tolist(), T.PCAT6.tolist()]
CAT_MIN = [5, 7, 11, 19, 35, 67]
SUBPEL = T.SUBPEL_FILTERS.astype(np.int32)
BILINEAR = T.BILINEAR_FILTERS.astype(np.int32)

MBSPLIT_COUNT = T.MBSPLIT_COUNT.tolist()
MBSPLIT_OFFSET = [[0, 8], [0, 2], [0, 2, 8, 10], list(range(16))]  # findnearmv.c:14
MBSPLIT_FILL_COUNT = [8, 8, 4, 1]                                  # decodemv.c:163
MBSPLIT_FILL_OFFSET = [                                            # decodemv.c:164
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15],
    [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
]
SUB_MV_REF_PROB3 = [  # decodemv.c:224 (indexed by (aez<<2)|(lez<<1)|lea)
    [147, 136, 18], [223, 1, 34], [106, 145, 1], [208, 1, 1],
    [179, 121, 1], [223, 1, 34], [179, 121, 1], [208, 1, 1],
]


def _clamp_q(q):
    return min(127, max(0, q))


def dequant_factors(qidx, y1dc_d, y2dc_d, y2ac_d, uvdc_d, uvac_d):
    """Per-Q dequant pairs (decodframe.c:50-65, quant_common.c:38-130)."""
    dcq, acq = T.DC_QLOOKUP, T.AC_QLOOKUP
    y1 = (int(dcq[_clamp_q(qidx + y1dc_d)]), int(acq[_clamp_q(qidx)]))
    y2 = (int(dcq[_clamp_q(qidx + y2dc_d)]) * 2,
          max(8, (int(acq[_clamp_q(qidx + y2ac_d)]) * 155) // 100))
    uv = (min(132, int(dcq[_clamp_q(qidx + uvdc_d)])),
          int(acq[_clamp_q(qidx + uvac_d)]))
    return y1, y2, uv


# ---------------------------------------------------------------------------
# transforms (idctllm.c — all exact int32 math)

def idct4x4_add(block16, dst, y, x):
    """vp8_short_idct4x4llm_c + add/clamp (idctllm.c:28-119)."""
    c1, c2 = 20091, 35468
    ip = [int(v) for v in block16]
    tmp = [0] * 16
    for i in range(4):
        a1 = ip[i] + ip[8 + i]
        b1 = ip[i] - ip[8 + i]
        t1 = (ip[4 + i] * c2) >> 16
        t2 = ip[12 + i] + ((ip[12 + i] * c1) >> 16)
        cc1 = t1 - t2
        t1 = ip[4 + i] + ((ip[4 + i] * c1) >> 16)
        t2 = (ip[12 + i] * c2) >> 16
        d1 = t1 + t2
        tmp[i] = _s16(a1 + d1)
        tmp[12 + i] = _s16(a1 - d1)
        tmp[4 + i] = _s16(b1 + cc1)
        tmp[8 + i] = _s16(b1 - cc1)
    out = [0] * 16
    for i in range(4):
        r = 4 * i
        a1 = tmp[r] + tmp[r + 2]
        b1 = tmp[r] - tmp[r + 2]
        t1 = (tmp[r + 1] * c2) >> 16
        t2 = tmp[r + 3] + ((tmp[r + 3] * c1) >> 16)
        cc1 = t1 - t2
        t1 = tmp[r + 1] + ((tmp[r + 1] * c1) >> 16)
        t2 = (tmp[r + 3] * c2) >> 16
        d1 = t1 + t2
        out[r] = _s16((a1 + d1 + 4) >> 3)
        out[r + 3] = _s16((a1 - d1 + 4) >> 3)
        out[r + 1] = _s16((b1 + cc1 + 4) >> 3)
        out[r + 2] = _s16((b1 - cc1 + 4) >> 3)
    blk = np.array(out, dtype=np.int32).reshape(4, 4)
    region = dst[y:y + 4, x:x + 4].astype(np.int32)
    dst[y:y + 4, x:x + 4] = np.clip(region + blk, 0, 255).astype(np.uint8)


def _s16(v):
    """short truncation (intermediate rows are stored in C shorts)."""
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


def dc_only_idct_add(dc, dst, y, x):
    """vp8_dc_only_idct_add_c (idctllm.c:112-139)."""
    a1 = (int(dc) + 4) >> 3
    region = dst[y:y + 4, x:x + 4].astype(np.int32)
    dst[y:y + 4, x:x + 4] = np.clip(region + a1, 0, 255).astype(np.uint8)


def inv_walsh(block16):
    """vp8_short_inv_walsh4x4_c (idctllm.c:140-192) -> 16 DC values."""
    ip = [int(v) for v in block16]
    tmp = [0] * 16
    for i in range(4):
        a1 = ip[i] + ip[12 + i]
        b1 = ip[4 + i] + ip[8 + i]
        c1 = ip[4 + i] - ip[8 + i]
        d1 = ip[i] - ip[12 + i]
        tmp[i] = _s16(a1 + b1)
        tmp[4 + i] = _s16(c1 + d1)
        tmp[8 + i] = _s16(a1 - b1)
        tmp[12 + i] = _s16(d1 - c1)
    out = [0] * 16
    for i in range(4):
        r = 4 * i
        a1 = tmp[r] + tmp[r + 3]
        b1 = tmp[r + 1] + tmp[r + 2]
        c1 = tmp[r + 1] - tmp[r + 2]
        d1 = tmp[r] - tmp[r + 3]
        out[r] = _s16((a1 + b1 + 3) >> 3)
        out[r + 1] = _s16((c1 + d1 + 3) >> 3)
        out[r + 2] = _s16((a1 - b1 + 3) >> 3)
        out[r + 3] = _s16((d1 - c1 + 3) >> 3)
    return out


# ---------------------------------------------------------------------------
# sub-pixel interpolation (filter.c)

def _sixtap_2d(src, sy, sx, w, h, stride_unused, xoff, yoff):
    """Generic 2-pass 6-tap (filter_block2d_* filter.c:41-130).

    src: padded uint8 plane; (sy, sx): top-left of the block in src coords.
    Always runs both passes (offset 0 selects the exact identity filter).
    """
    hf = SUBPEL[xoff]
    vf = SUBPEL[yoff]
    # first pass: horizontal, rows sy-2 .. sy+h+2 inclusive (h+5 rows)
    rows = src[sy - 2:sy + h + 3, sx - 2:sx + w + 3].astype(np.int32)
    fdata = np.zeros((h + 5, w), dtype=np.int32)
    for j in range(6):
        fdata += rows[:, j:j + w] * int(hf[j])
    fdata = np.clip((fdata + 64) >> 7, 0, 255)
    # second pass: vertical
    out = np.zeros((h, w), dtype=np.int32)
    for j in range(6):
        out += fdata[j:j + h, :] * int(vf[j])
    return np.clip((out + 64) >> 7, 0, 255).astype(np.uint8)


def _bilinear_2d(src, sy, sx, w, h, xoff, yoff):
    """vp8_bilinear_predict* (filter.c:224-500): 2-pass bilinear."""
    hf = BILINEAR[xoff]
    vf = BILINEAR[yoff]
    rows = src[sy:sy + h + 1, sx:sx + w + 1].astype(np.int32)
    fdata = (rows[:, 0:w] * int(hf[0]) + rows[:, 1:w + 1] * int(hf[1]) + 64) >> 7
    out = (fdata[0:h, :] * int(vf[0]) + fdata[1:h + 1, :] * int(vf[1]) + 64) >> 7
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# loop filter scalar math (loopfilter_filters.c)

def _sclamp(t):
    return max(-128, min(127, t))


def _u2s(v):
    return int(v) - 128  # value ^ 0x80 as signed


def _s2u(v):
    return (v + 128) & 0xFF


def _filter_mask(limit, blimit, p3, p2, p1, p0, q0, q1, q2, q3):
    m = (abs(p3 - p2) > limit or abs(p2 - p1) > limit or abs(p1 - p0) > limit
         or abs(q1 - q0) > limit or abs(q2 - q1) > limit
         or abs(q3 - q2) > limit
         or abs(p0 - q0) * 2 + abs(p1 - q1) // 2 > blimit)
    return not m  # True = apply filter


def _hevmask(thresh, p1, p0, q0, q1):
    return abs(p1 - p0) > thresh or abs(q1 - q0) > thresh


def _lf_filter4(mask, hev, pix, idx):
    """vp8_filter (loopfilter_filters.c:51-98). pix: list-like of ints
    (uint8), idx = (i_p1, i_p0, i_q0, i_q1)."""
    i1, i0, j0, j1 = idx
    ps1, ps0 = _u2s(pix[i1]), _u2s(pix[i0])
    qs0, qs1 = _u2s(pix[j0]), _u2s(pix[j1])
    f = _sclamp(ps1 - qs1)
    if not hev:
        f = 0
    f = _sclamp(f + 3 * (qs0 - ps0))
    if not mask:
        f = 0
    f1 = _sclamp(f + 4) >> 3
    f2 = _sclamp(f + 3) >> 3
    pix[j0] = _s2u(_sclamp(qs0 - f1))
    pix[i0] = _s2u(_sclamp(ps0 + f2))
    f = (f1 + 1) >> 1
    if hev:
        f = 0
    pix[j1] = _s2u(_sclamp(qs1 - f))
    pix[i1] = _s2u(_sclamp(ps1 + f))


def _lf_mbfilter(mask, hev, pix, idx):
    """vp8_mbfilter (loopfilter_filters.c:161-227)."""
    i2, i1, i0, j0, j1, j2 = idx
    ps2, ps1, ps0 = _u2s(pix[i2]), _u2s(pix[i1]), _u2s(pix[i0])
    qs0, qs1, qs2 = _u2s(pix[j0]), _u2s(pix[j1]), _u2s(pix[j2])
    f = _sclamp(ps1 - qs1)
    f = _sclamp(f + 3 * (qs0 - ps0))
    if not mask:
        f = 0
    f2 = f if hev else 0
    f1 = _sclamp(f2 + 4) >> 3
    f2 = _sclamp(f2 + 3) >> 3
    qs0 = _sclamp(qs0 - f1)
    ps0 = _sclamp(ps0 + f2)
    f2 = 0 if hev else f
    u = _sclamp((63 + f2 * 27) >> 7)
    pix[j0] = _s2u(_sclamp(qs0 - u))
    pix[i0] = _s2u(_sclamp(ps0 + u))
    u = _sclamp((63 + f2 * 18) >> 7)
    pix[j1] = _s2u(_sclamp(qs1 - u))
    pix[i1] = _s2u(_sclamp(ps1 + u))
    u = _sclamp((63 + f2 * 9) >> 7)
    pix[j2] = _s2u(_sclamp(qs2 - u))
    pix[i2] = _s2u(_sclamp(ps2 + u))


def _lf_simple_filter(mask, pix, idx):
    """vp8_simple_filter (loopfilter_filters.c:300-330)."""
    i1, i0, j0, j1 = idx
    p1, p0 = _u2s(pix[i1]), _u2s(pix[i0])
    q0, q1 = _u2s(pix[j0]), _u2s(pix[j1])
    if not mask:
        return
    f = _sclamp(p1 - q1)
    f = _sclamp(f + 3 * (q0 - p0))
    f1 = _sclamp(f + 4) >> 3
    f2 = _sclamp(f + 3) >> 3
    pix[j0] = _s2u(_sclamp(q0 - f1))
    pix[i0] = _s2u(_sclamp(p0 + f2))


class _EdgeFilter:
    """Applies normal/simple loop filters along an 8*count-pixel edge.

    Works directly on a padded uint8 numpy plane.  `vertical=True` means a
    vertical edge (filter across columns, iterate down rows)."""

    def __init__(self, plane):
        self.pl = plane

    def _run(self, y0, x0, count, vertical, fn, span, *maskargs):
        pl = self.pl
        for i in range(count * 8):
            if vertical:
                y, x = y0 + i, x0
                sl = pl[y, x - 4:x + 4].astype(np.int32).tolist()
            else:
                y, x = y0, x0 + i
                sl = pl[y - 4:y + 4, x].astype(np.int32).tolist()
            fn(sl, *maskargs)
            arr = np.array(sl, dtype=np.uint8)
            if vertical:
                pl[y, x - 4:x + 4] = arr
            else:
                pl[y - 4:y + 4, x] = arr

    def normal(self, y0, x0, count, vertical, blimit, limit, thresh, mb_edge):
        def fn(sl, blimit, limit, thresh):
            mask = _filter_mask(limit, blimit, *sl)
            hev = _hevmask(thresh, sl[2], sl[3], sl[4], sl[5])
            if mb_edge:
                _lf_mbfilter(mask, hev, sl, (1, 2, 3, 4, 5, 6))
            else:
                _lf_filter4(mask, hev, sl, (2, 3, 4, 5))
        self._run(y0, x0, count, vertical, fn, 8, blimit, limit, thresh)

    def simple(self, y0, x0, count, vertical, blimit):
        def fn(sl, blimit):
            p1, p0, q0, q1 = sl[2], sl[3], sl[4], sl[5]
            mask = abs(p0 - q0) * 2 + abs(p1 - q1) // 2 <= blimit
            _lf_simple_filter(mask, sl, (2, 3, 4, 5))
        self._run(y0, x0, count, vertical, fn, 8, blimit)


# ---------------------------------------------------------------------------

class FrameBuffer:
    """YV12 buffer with borders (yv12config.c:54-120 semantics)."""

    def __init__(self, width, height):
        self.w, self.h = width, height
        self.aw = (width + 15) & ~15
        self.ah = (height + 15) & ~15
        b, b2 = BORDER, BORDER // 2
        self.y = np.zeros((self.ah + 2 * b, self.aw + 2 * b), dtype=np.uint8)
        self.u = np.zeros((self.ah // 2 + 2 * b2, self.aw // 2 + 2 * b2),
                          dtype=np.uint8)
        self.v = np.zeros_like(self.u)

    def visible(self):
        b, b2 = BORDER, BORDER // 2
        return (self.y[b:b + self.h, b:b + self.w],
                self.u[b2:b2 + (self.h + 1) // 2, b2:b2 + (self.w + 1) // 2],
                self.v[b2:b2 + (self.h + 1) // 2, b2:b2 + (self.w + 1) // 2])

    def setup_intra_recon(self):
        """Borders for intra prediction (setupintrarecon.c:15-32)."""
        b, b2 = BORDER, BORDER // 2
        self.y[b - 1, b - 1:b + self.aw + 4] = 127
        self.y[b:b + self.ah, b - 1] = 129
        for p in (self.u, self.v):
            p[b2 - 1, b2 - 1:b2 + self.aw // 2 + 4] = 127
            p[b2:b2 + self.ah // 2, b2 - 1] = 129

    def extend_mb_row(self, mb_row):
        """vp8_extend_mb_row (extend.c:160-186): after finishing MB row,
        extend rows 14-15 (y) / 6-7 (uv) four pixels past the right edge."""
        b, b2 = BORDER, BORDER // 2
        for dy in (14, 15):
            yy = b + mb_row * 16 + dy
            self.y[yy, b + self.aw:b + self.aw + 4] = self.y[yy, b + self.aw - 1]
        for dy in (6, 7):
            yy = b2 + mb_row * 8 + dy
            for p in (self.u, self.v):
                p[yy, b2 + self.aw // 2:b2 + self.aw // 2 + 4] = \
                    p[yy, b2 + self.aw // 2 - 1]

    def extend_borders(self):
        """vp8_yv12_extend_frame_borders (yv12extend.c:23-145)."""
        for p, b, w, h in ((self.y, BORDER, self.aw, self.ah),
                           (self.u, BORDER // 2, self.aw // 2, self.ah // 2),
                           (self.v, BORDER // 2, self.aw // 2, self.ah // 2)):
            p[b:b + h, :b] = p[b:b + h, b:b + 1]
            p[b:b + h, b + w:] = p[b:b + h, b + w - 1:b + w]
            p[:b, :] = p[b:b + 1, :]
            p[b + h:, :] = p[b + h - 1:b + h, :]


class FrameContext:
    """Entropy context persisting across frames (onyxc_int.h fc)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.coef_probs = T.DEFAULT_COEF_PROBS.copy()
        self.ymode_prob = T.YMODE_PROB.copy()
        self.uv_mode_prob = T.UV_MODE_PROB.copy()
        self.bmode_prob = T.BMODE_PROB.copy()
        self.sub_mv_ref_prob = T.SUB_MV_REF_PROB.copy()
        self.mvc = T.DEFAULT_MV_CONTEXT.copy()

    def copy(self):
        fc = FrameContext.__new__(FrameContext)
        fc.coef_probs = self.coef_probs.copy()
        fc.ymode_prob = self.ymode_prob.copy()
        fc.uv_mode_prob = self.uv_mode_prob.copy()
        fc.bmode_prob = self.bmode_prob.copy()
        fc.sub_mv_ref_prob = self.sub_mv_ref_prob.copy()
        fc.mvc = self.mvc.copy()
        return fc


class RefDecoder:
    """Bit-exact golden VP8 decoder (single stream, show-frame output)."""

    #: when True (and the toolchain is available) the serial entropy layer
    #: (mode/MV + token decode) runs in the native C++ runtime
    #: (native/vp8_entropy.cpp); the pure-Python layer is the golden model.
    use_native = False
    #: error-concealment mode (VPX_CODEC_USE_ERROR_CONCEALMENT,
    #: error_concealment.c role): corrupt/truncated frames are concealed
    #: from the LAST reference instead of raising
    ec_enabled = False

    def __init__(self):
        self.w = self.h = 0
        self.fc = FrameContext()
        self.lfc = self.fc.copy()
        self.last = self.golden = self.altref = None
        self.seg_map = None
        # persistent header state
        self.segment_feature_data = np.zeros((2, 4), dtype=np.int32)
        self.mb_segment_abs_delta = 0
        self.mb_segment_tree_probs = np.full(3, 255, dtype=np.int32)
        self.ref_lf_deltas = np.zeros(4, dtype=np.int32)
        self.mode_lf_deltas = np.zeros(4, dtype=np.int32)
        self.y1dc_d = self.y2dc_d = self.y2ac_d = self.uvdc_d = self.uvac_d = 0
        self.sign_bias = [0, 0, 0, 0]
        self.decoded_key_frame = False
        # per-MB error-concealment state (error_concealment.c:408,559,589)
        self.prev_mv = None       # previous frame's padded MV grid (1/8 pel)
        self.prev_ref = None      # previous frame's padded ref-frame grid
        self.corrupt_mb = None    # [R,C] bool: MBs concealed this frame
        self.mvs_corrupt_from = None

    # -- header ------------------------------------------------------------

    def decode_frame(self, data: bytes):
        """Decode one compressed frame; returns (show, (y,u,v)) where the
        planes are the visible post-loop-filter reconstruction."""
        show = self.decode_frame_core(data)
        y, u, v = self.frame_to_show.visible()
        return show, (y.copy(), u.copy(), v.copy())

    def decode_frame_core(self, data: bytes) -> int:
        """Decode without materializing pixels to the host (the TPU path
        leaves the frame device-resident; read via self.frame_to_show).
        Returns the show_frame flag."""
        with trace.span("dec.decode", new_frame=True, cpu=True):
            self.corrupted = False
            if self.ec_enabled and self.decoded_key_frame:
                try:
                    return self._decode_frame_core(data)
                except Exception:
                    return self.conceal_missing_frame()
            return self._decode_frame_core(data)

    def conceal_missing_frame(self) -> int:
        """Conceal a missing/corrupt frame from the LAST reference
        (the decode_with_drops / onyxd_if.c:375-407 semantics: the frame
        is replaced and the reference is flagged corrupt)."""
        if self.last is None:
            raise ValueError("no reference to conceal from")
        self.frame_to_show = self.last
        self.corrupted = True
        return 1

    def _decode_frame_core(self, data: bytes) -> int:
        with trace.span("dec.header"):
            show_frame, bc = self._read_header(data)
        with trace.span("dec.modes"):
            self._decode_modes(bc)
        if bc.error():
            # read past the end of partition 0 (vp8dx_bool_error,
            # corruption tracking decodframe.c:1139-1143)
            self.corrupted = True
            if self.ec_enabled and self.mvs_corrupt_from is None:
                # keyframe / no motion history: whole-frame concealment
                raise ValueError("corrupt partition 0")
        self._reconstruct()
        if any(p.error() for p in self.bool_parts):
            self.corrupted = True
        self._swap_and_filter()
        # motion history for next frame's per-MB concealment
        # (error_concealment.c estimate_missing_mvs reads prior-frame MVs)
        self.prev_mv = self.mv.copy()
        self.prev_ref = self.ref_frame.copy()
        self.decoded_key_frame = True
        return show_frame

    def _read_header(self, data):
        """The frame header and the token partitions' bounds
        (decodframe.c:690-1054); returns (show_frame, partition 0's bool
        decoder, positioned at the modes)."""
        tag = data[0] | (data[1] << 8) | (data[2] << 16)
        frame_type = tag & 1
        version = (tag >> 1) & 7
        show_frame = (tag >> 4) & 1
        part0_size = tag >> 5
        pos = 3
        if frame_type == 0:  # key frame
            assert data[3:6] == b"\x9d\x01\x2a", "bad sync code"
            self.w = (data[6] | (data[7] << 8)) & 0x3FFF
            self.h = (data[8] | (data[9] << 8)) & 0x3FFF
            pos = 10
            self._alloc()
        if not self.decoded_key_frame and frame_type != 0:
            raise ValueError("no keyframe yet")
        self.frame_type = frame_type
        self.version = version
        # version semantics (vp8/common/alloccommon.c vp8_setup_version):
        # 0: normal filter, sixtap; 1,2: simple/bilinear variants; 3: full-pel
        self.use_bilinear = version >= 1
        self.full_pixel = version == 3
        simple_filter_from_version = version >= 1

        self._init_frame()

        bc = BoolDecoder(data[pos:pos + part0_size])
        if frame_type == 0:
            self.clr_type = bc.read_bit()
            self.clamp_type = bc.read_bit()
        self._parse_segmentation(bc)
        self.filter_type_bit = bc.read_bit()
        self.filter_level = bc.read_literal(6)
        self.sharpness = bc.read_literal(3)
        self.simple_filter = self.filter_type_bit  # LOOPFILTERTYPE
        self._parse_lf_deltas(bc)
        # token partitions (decodframe.c:501-592 setup_token_decoder)
        log2_parts = bc.read_literal(2)
        nparts = 1 << log2_parts
        part_data = data[3 + part0_size if frame_type else 10 + part0_size:]
        parts = []
        part_bytes = []
        off = 3 * (nparts - 1)
        # per-MB EC is possible when there is motion history to estimate
        # from; otherwise truncation falls back to whole-frame concealment
        ec_per_mb = (self.ec_enabled and frame_type != 0 and
                     self.prev_mv is not None and self.last is not None)
        if len(part_data) < off or part0_size > len(data) - pos:
            # truncated packet (read_available_partition_size's
            # "Truncated partition size data" case)
            self.corrupted = True
            if self.ec_enabled and not ec_per_mb:
                raise ValueError("truncated packet")
        for i in range(nparts):
            if i < nparts - 1:
                if (i + 1) * 3 <= len(part_data):
                    sz = part_data[i * 3] | (part_data[i * 3 + 1] << 8) | \
                         (part_data[i * 3 + 2] << 16)
                else:
                    sz = -1
            else:
                sz = len(part_data) - off
            if sz < 0 or off + sz > len(part_data):
                self.corrupted = True
                if self.ec_enabled and not ec_per_mb:
                    raise ValueError("truncated partition")
                sz = max(0, len(part_data) - off)
            part_bytes.append(bytes(part_data[off:off + sz]))
            parts.append(BoolDecoder(part_bytes[-1]))
            off += sz
        self.bool_parts = parts
        self.part_bytes = part_bytes
        # quantizers (decodframe.c:926-943)
        self.base_qindex = bc.read_literal(7)
        self.y1dc_d = self._get_delta_q(bc, self.y1dc_d)
        self.y2dc_d = self._get_delta_q(bc, self.y2dc_d)
        self.y2ac_d = self._get_delta_q(bc, self.y2ac_d)
        self.uvdc_d = self._get_delta_q(bc, self.uvdc_d)
        self.uvac_d = self._get_delta_q(bc, self.uvac_d)
        # refresh flags (decodframe.c:949-1031)
        if frame_type != 0:
            self.refresh_golden = bc.read_bit()
            self.refresh_alt = bc.read_bit()
            self.copy_to_gf = 0 if self.refresh_golden else bc.read_literal(2)
            self.copy_to_arf = 0 if self.refresh_alt else bc.read_literal(2)
            self.sign_bias[GOLDEN_FRAME] = bc.read_bit()
            self.sign_bias[ALTREF_FRAME] = bc.read_bit()
        self.refresh_entropy = bc.read_bit()
        if not self.refresh_entropy:
            self.lfc = self.fc.copy()
        self.refresh_last = 1 if frame_type == 0 else bc.read_bit()
        # coef prob updates (decodframe.c:1036-1054)
        cp = self.fc.coef_probs
        up = T.COEF_UPDATE_PROBS
        for i in range(4):
            for j in range(8):
                for k in range(3):
                    for l in range(11):
                        if bc.read(int(up[i, j, k, l])):
                            cp[i, j, k, l] = bc.read_literal(8)
        self.mb_no_coeff_skip = bc.read_bit()

        self.mvs_corrupt_from = None
        self.corrupt_mb = None
        return show_frame, bc

    def _get_delta_q(self, bc, prev):
        if bc.read_bit():
            v = bc.read_literal(4)
            if bc.read_bit():
                v = -v
            return v
        return 0

    def _parse_segmentation(self, bc):
        """decodframe.c:829-875."""
        self.segmentation_enabled = bc.read_bit()
        self.update_mb_seg_map = 0
        if self.segmentation_enabled:
            self.update_mb_seg_map = bc.read_bit()
            update_data = bc.read_bit()
            if update_data:
                self.mb_segment_abs_delta = bc.read_bit()
                self.segment_feature_data[:] = 0
                for i in range(2):
                    bits = (7, 6)[i]
                    for j in range(4):
                        if bc.read_bit():
                            v = bc.read_literal(bits)
                            if bc.read_bit():
                                v = -v
                            self.segment_feature_data[i, j] = v
            if self.update_mb_seg_map:
                self.mb_segment_tree_probs[:] = 255
                for i in range(3):
                    if bc.read_bit():
                        self.mb_segment_tree_probs[i] = bc.read_literal(8)

    def _parse_lf_deltas(self, bc):
        """decodframe.c:877-919."""
        self.lf_delta_enabled = bc.read_bit()
        if self.lf_delta_enabled:
            if bc.read_bit():  # update
                for arr in (self.ref_lf_deltas, self.mode_lf_deltas):
                    for i in range(4):
                        if bc.read_bit():
                            v = bc.read_literal(6)
                            if bc.read_bit():
                                v = -v
                            arr[i] = v

    def _alloc(self):
        self.mb_rows = (self.h + 15) >> 4
        self.mb_cols = (self.w + 15) >> 4
        self.seg_map = np.zeros((self.mb_rows, self.mb_cols), dtype=np.int32)
        self.last = FrameBuffer(self.w, self.h)
        self.golden = FrameBuffer(self.w, self.h)
        self.altref = FrameBuffer(self.w, self.h)

    def _init_frame(self):
        """init_frame (decodframe.c:608-687)."""
        if self.frame_type == 0:
            self.fc.reset()
            self.segment_feature_data[:] = 0
            self.mb_segment_abs_delta = 0
            self.ref_lf_deltas[:] = 0
            self.mode_lf_deltas[:] = 0
            self.refresh_golden = 1
            self.refresh_alt = 1
            self.copy_to_gf = 0
            self.copy_to_arf = 0
            self.sign_bias[GOLDEN_FRAME] = 0
            self.sign_bias[ALTREF_FRAME] = 0

    # -- mode / mv decode --------------------------------------------------

    def _decode_modes(self, bc):
        """vp8_decode_mode_mvs (decodemv.c:583-664) + mb_mode_mv_init."""
        R, C = self.mb_rows, self.mb_cols
        # padded (+1 top row / left col) neighbor grids; border entries are
        # intra DC with zero MVs (calloc'd MODE_INFO border, alloccommon.c)
        self.mode = np.zeros((R + 1, C + 1), dtype=np.int32)
        self.uv_mode = np.zeros((R, C), dtype=np.int32)
        self.ref_frame = np.zeros((R + 1, C + 1), dtype=np.int32)
        self.mv = np.zeros((R + 1, C + 1, 2), dtype=np.int32)  # (row, col)
        self.bmode = np.zeros((R + 1, C + 1, 16), dtype=np.int32)
        self.bmv = np.zeros((R + 1, C + 1, 16, 2), dtype=np.int32)
        self.partitioning = np.zeros((R, C), dtype=np.int32)
        self.need_clamp = np.zeros((R, C), dtype=np.int32)
        self.skip = np.zeros((R, C), dtype=np.int32)

        if self.use_native and not self.ec_enabled:
            # the native runtime has no mid-stream error-position report;
            # EC mode stays on the Python layer (EC frames are rare)
            from ..utils import native
            native.decode_modes_native(native.get_lib(), bc, self)
            return

        self.prob_skip_false = 0
        if self.mb_no_coeff_skip:
            self.prob_skip_false = bc.read_literal(8)
        if self.frame_type != 0:
            self.prob_intra = bc.read_literal(8)
            self.prob_last = bc.read_literal(8)
            self.prob_gf = bc.read_literal(8)
            if bc.read_bit():
                for i in range(4):
                    self.fc.ymode_prob[i] = bc.read_literal(8)
            if bc.read_bit():
                for i in range(3):
                    self.fc.uv_mode_prob[i] = bc.read_literal(8)
            # read_mvcontexts (decodemv.c:117-137)
            for comp in range(2):
                for i in range(19):
                    if bc.read(int(T.MV_UPDATE_PROBS[comp, i])):
                        x = bc.read_literal(7)
                        self.fc.mvc[comp, i] = (x << 1) if x else 1

        for r in range(R):
            for c in range(C):
                self._decode_mb_mode(bc, r, c)
                if self.ec_enabled and bc.error():
                    # estimate_missing_mvs semantics
                    # (error_concealment.c:408): every MB from the first
                    # corrupt one onward gets an interpolated MV
                    if (self.frame_type != 0 and self.last is not None
                            and self.prev_mv is not None):
                        self.mvs_corrupt_from = (r, c)
                        self._ec_estimate_missing_modes(r, c)
                    return

    # -- per-MB error concealment (error_concealment.c) --------------------

    def _ec_interpolate_mv(self, r, c):
        """Overlap-weighted MV estimate for MB (r,c) from the previous
        frame's motion field (estimate_mv / calculate_overlaps,
        error_concealment.c:166-268, at MB rather than 4x4 granularity:
        each prev-frame MB is advanced along its own motion and its MV is
        weighted by the area overlapping this MB)."""
        num_r = num_c = den = 0
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                rr, cc = r + dr, c + dc
                if not (0 <= rr < self.mb_rows and 0 <= cc < self.mb_cols):
                    continue
                if int(self.prev_ref[rr + 1, cc + 1]) == INTRA_FRAME:
                    continue
                mvr, mvc = (int(self.prev_mv[rr + 1, cc + 1, 0]),
                            int(self.prev_mv[rr + 1, cc + 1, 1]))
                # prev MB advanced by its own motion, in 1/8-pel units
                # (content at X-mv moved to X: it continues to X+(-mv)?
                #  no — predictor is ref[X+mv], so content moved by -mv;
                #  constant-motion extrapolation puts it at pos - mv)
                pr8 = 128 * rr - mvr
                pc8 = 128 * cc - mvc
                ov_r = min(pr8 + 128, 128 * r + 128) - max(pr8, 128 * r)
                ov_c = min(pc8 + 128, 128 * c + 128) - max(pc8, 128 * c)
                if ov_r <= 0 or ov_c <= 0:
                    continue
                w = ov_r * ov_c
                num_r += w * mvr
                num_c += w * mvc
                den += w
        if den == 0:
            return 0, 0
        est_r = int(round(num_r / den))
        est_c = int(round(num_c / den))
        # keep the estimate inside the UMV-extended window for this MB
        # (the reference clamps in vp8_interpolate_motion via
        #  clamp_mv_to_umv_border, reconinter.c:349-370)
        MARGIN = 18 << 3
        est_r = max(-(r * 16) * 8 - MARGIN,
                    min(((self.mb_rows - 1 - r) * 16) * 8 + MARGIN, est_r))
        est_c = max(-(c * 16) * 8 - MARGIN,
                    min(((self.mb_cols - 1 - c) * 16) * 8 + MARGIN, est_c))
        return est_r & ~1, est_c & ~1  # full MV grid is even (1/4-pel *2)

    def _ec_conceal_tokens_mb(self, r, c):
        """Residual data for MB (r,c) was lost: keep the (intact) mode/MV
        from partition 0 and reconstruct prediction-only."""
        R, C = self.mb_rows, self.mb_cols
        if self.corrupt_mb is None:
            self.corrupt_mb = np.zeros((R, C), bool)
        self.qcoeff[r, c] = 0
        self.eobs[r, c] = 0
        self.skip[r, c] = 1
        self.corrupt_mb[r, c] = True
        self.corrupted = True

    def _ec_estimate_missing_modes(self, r0, c0):
        """Fill modes/MVs for every MB at/after (r0,c0) in raster order:
        inter NEWMV from LAST with the interpolated MV, no residual
        (vp8_estimate_missing_mvs, error_concealment.c:389-428)."""
        R, C = self.mb_rows, self.mb_cols
        if self.corrupt_mb is None:
            self.corrupt_mb = np.zeros((R, C), bool)
        for r in range(R):
            for c in range(C):
                if r < r0 or (r == r0 and c < c0):
                    continue
                pr, pc = r + 1, c + 1
                mvr, mvc = self._ec_interpolate_mv(r, c)
                self.mode[pr, pc] = NEWMV
                self.uv_mode[r, c] = DC_PRED
                self.ref_frame[pr, pc] = LAST_FRAME
                self.mv[pr, pc] = (mvr, mvc)
                self.bmv[pr, pc] = 0
                self.partitioning[r, c] = 0
                self.need_clamp[r, c] = 1
                self.skip[r, c] = 1
                self.corrupt_mb[r, c] = True

    def _decode_mb_mode(self, bc, r, c):
        """decode_mb_mode_mvs (decodemv.c:596-620)."""
        if self.update_mb_seg_map:
            # read_mb_features (decodemv.c:582-594)
            p = self.mb_segment_tree_probs
            if bc.read(int(p[0])):
                seg = 2 + bc.read(int(p[2]))
            else:
                seg = bc.read(int(p[1]))
            self.seg_map[r, c] = seg
        elif self.frame_type == 0:
            self.seg_map[r, c] = 0
        if self.mb_no_coeff_skip:
            self.skip[r, c] = bc.read(self.prob_skip_false)
        if self.frame_type == 0:
            self._read_kf_modes(bc, r, c)
        else:
            self._read_mb_modes_mv(bc, r, c)

    # (padded-grid helpers: index [r+1][c+1] addresses MB (r,c))
    def _read_kf_modes(self, bc, r, c):
        """read_kf_modes (decodemv.c:49-74)."""
        pr, pc = r + 1, c + 1
        ymode = bc.read_tree(T.KF_YMODE_TREE.tolist(), T.KF_YMODE_PROB.tolist())
        self.mode[pr, pc] = ymode
        self.ref_frame[pr, pc] = INTRA_FRAME
        self.mv[pr, pc] = 0
        if ymode == B_PRED:
            tree = T.BMODE_TREE.tolist()
            for i in range(16):
                a = self._above_bmode(pr, pc, i)
                l = self._left_bmode(pr, pc, i)
                m = bc.read_tree(tree, T.KF_BMODE_PROB[a][l].tolist())
                self.bmode[pr, pc, i] = m
        self.uv_mode[r, c] = bc.read_tree(T.UV_MODE_TREE.tolist(),
                                          T.KF_UV_MODE_PROB.tolist())

    def _above_bmode(self, pr, pc, b):
        if b < 4:
            m = self.mode[pr - 1, pc]
            if m == B_PRED:
                return int(self.bmode[pr - 1, pc, b + 12])
            return MODE_TO_BMODE.get(int(m), B_DC)
        return int(self.bmode[pr, pc, b - 4])

    def _left_bmode(self, pr, pc, b):
        if b % 4 == 0:
            m = self.mode[pr, pc - 1]
            if m == B_PRED:
                return int(self.bmode[pr, pc - 1, b + 3])
            return MODE_TO_BMODE.get(int(m), B_DC)
        return int(self.bmode[pr, pc, b - 1])

    def _above_bmv(self, pr, pc, b):
        """above_block_mv (findnearmv.h:114-128)."""
        if b < 4:
            if self.mode[pr - 1, pc] != SPLITMV:
                return tuple(self.mv[pr - 1, pc])
            return tuple(self.bmv[pr - 1, pc, b + 12])
        return tuple(self.bmv[pr, pc, b - 4])

    def _left_bmv(self, pr, pc, b):
        """left_block_mv (findnearmv.h:100-113)."""
        if b % 4 == 0:
            if self.mode[pr, pc - 1] != SPLITMV:
                return tuple(self.mv[pr, pc - 1])
            return tuple(self.bmv[pr, pc - 1, b + 3])
        return tuple(self.bmv[pr, pc, b - 1])

    def _read_mv_component(self, bc, mvc_row):
        """read_mvcomponent (decodemv.c:76-107)."""
        p = [int(x) for x in mvc_row]
        MVPsign, MVPshort, MVPbits = 1, 2, 9
        if bc.read(p[0]):  # long
            x = 0
            for i in range(3):
                x += bc.read(p[MVPbits + i]) << i
            for i in range(9, 3, -1):
                x += bc.read(p[MVPbits + i]) << i
            if not (x & 0xFFF0) or bc.read(p[MVPbits + 3]):
                x += 8
        else:
            x = bc.read_tree(T.SMALL_MV_TREE.tolist(), p[MVPshort:])
        if x and bc.read(p[MVPsign]):
            x = -x
        return x

    def _read_mv(self, bc):
        row = self._read_mv_component(bc, self.fc.mvc[0]) * 2
        col = self._read_mv_component(bc, self.fc.mvc[1]) * 2
        return row, col

    def _read_mb_modes_mv(self, bc, r, c):
        """read_mb_modes_mv (decodemv.c:320-580)."""
        pr, pc = r + 1, c + 1
        if not bc.read(self.prob_intra):
            # intra in inter frame
            self.ref_frame[pr, pc] = INTRA_FRAME
            self.mv[pr, pc] = 0
            ymode = bc.read_tree(T.YMODE_TREE.tolist(),
                                 [int(x) for x in self.fc.ymode_prob])
            self.mode[pr, pc] = ymode
            if ymode == B_PRED:
                tree = T.BMODE_TREE.tolist()
                probs = [int(x) for x in self.fc.bmode_prob]
                for i in range(16):
                    self.bmode[pr, pc, i] = bc.read_tree(tree, probs)
            self.uv_mode[r, c] = bc.read_tree(
                T.UV_MODE_TREE.tolist(), [int(x) for x in self.fc.uv_mode_prob])
            return

        ref = LAST_FRAME
        if bc.read(self.prob_last):
            ref = 2 + bc.read(self.prob_gf)
        self.ref_frame[pr, pc] = ref
        self.uv_mode[r, c] = DC_PRED

        # near-MV accumulation (decodemv.c:348-407)
        CNT_INTRA, CNT_NEAREST, CNT_NEAR, CNT_SPLITMV = 0, 1, 2, 3
        near_mvs = [(0, 0), (0, 0), (0, 0), (0, 0)]
        cnt = [0, 0, 0, 0]
        cntx = 0
        nmv = 0
        sb = self.sign_bias

        def bias(mv, nb_ref):
            if sb[nb_ref] != sb[ref]:
                return (-mv[0], -mv[1])
            return mv

        above_ref = int(self.ref_frame[pr - 1, pc])
        left_ref = int(self.ref_frame[pr, pc - 1])
        al_ref = int(self.ref_frame[pr - 1, pc - 1])
        above_mv = tuple(int(x) for x in self.mv[pr - 1, pc])
        left_mv = tuple(int(x) for x in self.mv[pr, pc - 1])
        al_mv = tuple(int(x) for x in self.mv[pr - 1, pc - 1])

        if above_ref != INTRA_FRAME:
            if above_mv != (0, 0):
                nmv += 1
                near_mvs[nmv] = bias(above_mv, above_ref)
                cntx += 1
            cnt[cntx] += 2
        if left_ref != INTRA_FRAME:
            if left_mv != (0, 0):
                this = bias(left_mv, left_ref)
                if this != near_mvs[nmv]:
                    nmv += 1
                    near_mvs[nmv] = this
                    cntx += 1
                cnt[cntx] += 2
            else:
                cnt[CNT_INTRA] += 2
        if al_ref != INTRA_FRAME:
            if al_mv != (0, 0):
                this = bias(al_mv, al_ref)
                if this != near_mvs[nmv]:
                    nmv += 1
                    near_mvs[nmv] = this
                    cntx += 1
                cnt[cntx] += 1
            else:
                cnt[CNT_INTRA] += 1

        if not bc.read(int(T.MODE_CONTEXTS[cnt[CNT_INTRA], 0])):
            self.mode[pr, pc] = ZEROMV
            self.mv[pr, pc] = 0
            return

        mb_to_left = -(c * 16) << 3
        mb_to_right = ((self.mb_cols - 1 - c) * 16) << 3
        mb_to_top = -(r * 16) << 3
        mb_to_bottom = ((self.mb_rows - 1 - r) * 16) << 3
        MARGIN = 16 << 3
        lo_col, hi_col = mb_to_left - MARGIN, mb_to_right + MARGIN
        lo_row, hi_row = mb_to_top - MARGIN, mb_to_bottom + MARGIN

        def clamp2(mv):
            return (min(max(mv[0], lo_row), hi_row),
                    min(max(mv[1], lo_col), hi_col))

        if cnt[CNT_SPLITMV] and near_mvs[nmv] == near_mvs[CNT_NEAREST]:
            cnt[CNT_NEAREST] += 1
        cnt[CNT_SPLITMV] = ((int(self.mode[pr - 1, pc]) == SPLITMV) +
                            (int(self.mode[pr, pc - 1]) == SPLITMV)) * 2 + \
                           (int(self.mode[pr - 1, pc - 1]) == SPLITMV)
        if cnt[CNT_NEAR] > cnt[CNT_NEAREST]:
            cnt[CNT_NEAREST], cnt[CNT_NEAR] = cnt[CNT_NEAR], cnt[CNT_NEAREST]
            near_mvs[CNT_NEAREST], near_mvs[CNT_NEAR] = \
                near_mvs[CNT_NEAR], near_mvs[CNT_NEAREST]

        if not bc.read(int(T.MODE_CONTEXTS[cnt[CNT_NEAREST], 1])):
            self.mode[pr, pc] = NEARESTMV
            self.mv[pr, pc] = clamp2(near_mvs[CNT_NEAREST])
            return
        if not bc.read(int(T.MODE_CONTEXTS[cnt[CNT_NEAR], 2])):
            self.mode[pr, pc] = NEARMV
            self.mv[pr, pc] = clamp2(near_mvs[CNT_NEAR])
            return

        if cnt[CNT_NEAREST] >= cnt[CNT_INTRA]:
            near_mvs[CNT_INTRA] = near_mvs[CNT_NEAREST]
        best = clamp2(near_mvs[CNT_INTRA])

        def check_bounds(mv):
            return (mv[1] < mb_to_left - MARGIN or mv[1] > mb_to_right + MARGIN
                    or mv[0] < mb_to_top - MARGIN
                    or mv[0] > mb_to_bottom + MARGIN)

        if bc.read(int(T.MODE_CONTEXTS[cnt[CNT_SPLITMV], 3])):
            # SPLITMV (decode_split_mv, decodemv.c:250-318)
            self.mode[pr, pc] = SPLITMV
            need_clamp = 0
            if bc.read(110):
                s = 2
                if bc.read(111):
                    s = bc.read(150)
            else:
                s = 3
            num_p = MBSPLIT_COUNT[s]
            mvc = self.fc.mvc
            for j in range(num_p):
                k = MBSPLIT_OFFSET[s][j]
                leftmv = self._left_bmv(pr, pc, k)
                abovemv = self._above_bmv(pr, pc, k)
                lez = leftmv == (0, 0)
                aez = abovemv == (0, 0)
                lea = leftmv == abovemv
                prob = SUB_MV_REF_PROB3[(aez << 2) | (lez << 1) | lea]
                if bc.read(prob[0]):
                    if bc.read(prob[1]):
                        if bc.read(prob[2]):
                            mvrow, mvcol = self._read_mv(bc)
                            blockmv = (mvrow + best[0], mvcol + best[1])
                        else:
                            blockmv = (0, 0)
                    else:
                        blockmv = abovemv
                else:
                    blockmv = leftmv
                need_clamp |= check_bounds(blockmv)
                fc_n = MBSPLIT_FILL_COUNT[s]
                for fo in MBSPLIT_FILL_OFFSET[s][j * fc_n:(j + 1) * fc_n]:
                    self.bmv[pr, pc, fo] = blockmv
            self.partitioning[r, c] = s
            self.need_clamp[r, c] = need_clamp
            self.mv[pr, pc] = self.bmv[pr, pc, 15]
        else:
            self.mode[pr, pc] = NEWMV
            mvrow, mvcol = self._read_mv(bc)
            mv = (mvrow + best[0], mvcol + best[1])
            self.need_clamp[r, c] = check_bounds(mv)
            self.mv[pr, pc] = mv

    # -- detokenize --------------------------------------------------------

    def _decode_mb_tokens(self, bc, has_y2, ctx_above, ctx_left, coef_probs):
        """vp8_decode_mb_tokens (detokenize.c:183-384).

        Returns (qcoeff[25,16] int32, eobs[25], eobtotal)."""
        qcoeff = np.zeros((25, 16), dtype=np.int32)
        eobs = [0] * 25
        eobtotal = -16 if has_y2 else 0
        if has_y2:
            order = [24] + list(range(16)) + list(range(16, 24))
        else:
            order = list(range(16)) + list(range(16, 24))
        for i in order:
            if has_y2:
                btype = 1 if i == 24 else (0 if i < 16 else 2)
            else:
                btype = 3 if i < 16 else 2
            start = 1 if (has_y2 and i < 16) else 0
            ia, il = BLOCK2ABOVE[i], BLOCK2LEFT[i]
            ctx = ctx_above[ia] + ctx_left[il]
            ctx_above[ia] = ctx_left[il] = 0
            probs = coef_probs[btype]
            c = start
            check_eob = True
            while c < 16:
                p = probs[COEF_BANDS[c], ctx]
                if check_eob and not bc.read(int(p[0])):
                    break
                if not bc.read(int(p[1])):  # ZERO token
                    if c == 15:
                        # malformed-input guard, keeps eob==15
                        # (detokenize.c DECODE_AND_LOOP_IF_ZERO)
                        break
                    ctx = 0
                    check_eob = False
                    c += 1
                    continue
                check_eob = True
                ctx_above[ia] = ctx_left[il] = 1
                if not bc.read(int(p[2])):
                    val = 1
                    ctx = 1
                else:
                    ctx = 2
                    if not bc.read(int(p[3])):       # LOW_VAL: 2,3,4
                        if not bc.read(int(p[4])):
                            val = 2
                        elif not bc.read(int(p[5])):
                            val = 3
                        else:
                            val = 4
                    elif not bc.read(int(p[6])):     # cat1 / cat2
                        if not bc.read(int(p[7])):
                            val = self._read_cat(bc, 0)
                        else:
                            val = self._read_cat(bc, 1)
                    elif not bc.read(int(p[8])):     # cat3 / cat4
                        if not bc.read(int(p[9])):
                            val = self._read_cat(bc, 2)
                        else:
                            val = self._read_cat(bc, 3)
                    elif not bc.read(int(p[10])):
                        val = self._read_cat(bc, 4)
                    else:
                        val = self._read_cat(bc, 5)
                if bc.read_sign_det():
                    val = -val
                qcoeff[i, ZIGZAG[c]] = val
                if c == 15:
                    break
                c += 1
            # NOTE: when the 16th coeff (c==15) is coded, the reference
            # stores eob=15 (detokenize.c DECODE_SIGN_... exit path)
            eobs[i] = c
            eobtotal += c
        return qcoeff, eobs, eobtotal

    def _read_cat(self, bc, cat):
        """extra-bit categories (detokenize.c:281-330)."""
        probs = CAT_PROBS[cat]
        val = 0
        for p in probs:
            val = (val << 1) | bc.read(int(p))
        return CAT_MIN[cat] + val

    # -- reconstruction ----------------------------------------------------

    def _detokenize_all(self):
        """Token decode for the whole frame (entropy-only; no pixel deps).

        Mirrors the per-partition row round-robin of decodframe.c:1112-1129.
        Fills self.qcoeff [R,C,25,16] and self.eobs [R,C,25]; updates
        self.skip where eobtotal==0 (decode_macroblock decodframe.c:119-130).
        """
        R, C = self.mb_rows, self.mb_cols
        if self.use_native and not self.ec_enabled:
            from ..utils import native
            native.detokenize_native(native.get_lib(), self)
            return
        self.qcoeff = np.zeros((R, C, 25, 16), dtype=np.int32)
        self.eobs = np.zeros((R, C, 25), dtype=np.int32)
        nparts = len(self.bool_parts)
        # per-partition corruption: once a partition's bool decoder runs
        # dry, every later MB it feeds is concealed prediction-only
        # (vp8_conceal_corrupt_mbs role, error_concealment.c:559-589)
        part_bad = [p.error() for p in self.bool_parts]
        above_ctx = np.zeros((C, 9), dtype=np.int32)
        for r in range(R):
            left_ctx = np.zeros(9, dtype=np.int32)
            bc = self.bool_parts[r % nparts]
            for c in range(C):
                mode = int(self.mode[r + 1, c + 1])
                has_y2 = mode not in (B_PRED, SPLITMV)
                if self.ec_enabled and part_bad[r % nparts]:
                    self._ec_conceal_tokens_mb(r, c)
                    above_ctx[c] = 0
                    left_ctx[:] = 0
                    continue
                if self.skip[r, c]:
                    # vp8_reset_mb_tokens_context (detokenize.c:70-84)
                    above_ctx[c, :8] = 0
                    left_ctx[:8] = 0
                    if has_y2:
                        above_ctx[c, 8] = 0
                        left_ctx[8] = 0
                else:
                    q, eobs, eobtotal = self._decode_mb_tokens(
                        bc, has_y2, above_ctx[c], left_ctx,
                        self.fc.coef_probs)
                    if self.ec_enabled and bc.error():
                        part_bad[r % nparts] = True
                        self._ec_conceal_tokens_mb(r, c)
                        above_ctx[c] = 0
                        left_ctx[:] = 0
                        continue
                    self.qcoeff[r, c] = q
                    self.eobs[r, c] = eobs
                    if eobtotal == 0:
                        self.skip[r, c] = 1

    def _reconstruct(self):
        R, C = self.mb_rows, self.mb_cols
        self._detokenize_all()
        self.cur = FrameBuffer(self.w, self.h)
        self.cur.setup_intra_recon()
        dq = {}
        base_dq = dequant_factors(self.base_qindex, self.y1dc_d, self.y2dc_d,
                                  self.y2ac_d, self.uvdc_d, self.uvac_d)
        for r in range(R):
            for c in range(C):
                self._decode_recon_mb(r, c, base_dq, dq)
            self.cur.extend_mb_row(r)

    def _mb_dequant(self, r, c, base_dq, cache):
        """mb_init_dequantizer (decodframe.c:67-109)."""
        if not self.segmentation_enabled:
            return base_dq
        seg = int(self.seg_map[r, c])
        if seg in cache:
            return cache[seg]
        if self.mb_segment_abs_delta:
            q = int(self.segment_feature_data[0, seg])
        else:
            q = self.base_qindex + int(self.segment_feature_data[0, seg])
            q = min(127, max(0, q))
        v = dequant_factors(q, self.y1dc_d, self.y2dc_d, self.y2ac_d,
                            self.uvdc_d, self.uvac_d)
        cache[seg] = v
        return v

    def _decode_recon_mb(self, r, c, base_dq, dqcache):
        """decode_macroblock pixel path (decodframe.c:112-305)."""
        pr, pc = r + 1, c + 1
        mode = int(self.mode[pr, pc])
        skip = int(self.skip[r, c])
        qcoeff = self.qcoeff[r, c].copy()
        eobs = self.eobs[r, c]

        dq_y1, dq_y2, dq_uv = self._mb_dequant(r, c, base_dq, dqcache)

        fb = self.cur
        b = BORDER
        b2 = BORDER // 2
        y0, x0 = b + r * 16, c * 16 + b
        cy0, cx0 = b2 + r * 8, c * 8 + b2

        intra = int(self.ref_frame[pr, pc]) == INTRA_FRAME
        if intra:
            self._intra_uv_predict(r, c)
            if mode != B_PRED:
                self._intra_y16_predict(r, c, mode)
            else:
                self._bpred_recon(r, c, qcoeff, eobs, dq_y1, skip)
        else:
            self._inter_predict(r, c)

        if not skip:
            if mode != B_PRED:
                dqc0, dqc1 = dq_y1
                if mode != SPLITMV:
                    # 2nd-order WHT (decodframe.c:253-289)
                    if eobs[24] > 1:
                        # dequant stored to C short -> int16 wrap
                        d = (qcoeff[24] * np.array(
                            [dq_y2[0]] + [dq_y2[1]] * 15,
                            dtype=np.int32)).astype(np.int16)
                        dcs = inv_walsh(d)
                    else:
                        dc0 = _s16(int(qcoeff[24, 0]) * dq_y2[0] & 0xFFFF)
                        dcs = [_s16(((dc0 + 3) >> 3) & 0xFFFF)] * 16
                    qcoeff[24] = 0
                    for i in range(16):
                        qcoeff[i, 0] = dcs[i]
                    dqc0 = 1  # dequant_y1_dc[0] (decodframe.c:92)
                dqv = np.array([dqc0] + [dqc1] * 15, dtype=np.int32)
                for i in range(16):
                    by, bx = y0 + (i >> 2) * 4, x0 + (i & 3) * 4
                    if eobs[i] > 1:
                        idct4x4_add((qcoeff[i] * dqv).astype(np.int16),
                                    fb.y, by, bx)
                    else:
                        dc_only_idct_add(
                            _s16(int(qcoeff[i, 0]) * int(dqv[0]) & 0xFFFF),
                            fb.y, by, bx)
            dquv = np.array([dq_uv[0]] + [dq_uv[1]] * 15, dtype=np.int32)
            for i in range(16, 24):
                pl = fb.u if i < 20 else fb.v
                j = i - 16 if i < 20 else i - 20
                by = cy0 + (j >> 1) * 4
                bx = cx0 + (j & 1) * 4
                if eobs[i] > 1:
                    idct4x4_add((qcoeff[i] * dquv).astype(np.int16),
                                pl, by, bx)
                else:
                    dc_only_idct_add(
                        _s16(int(qcoeff[i, 0]) * int(dquv[0]) & 0xFFFF),
                        pl, by, bx)

    # -- intra prediction --------------------------------------------------

    def _intra_y16_predict(self, r, c, mode):
        """vp8_build_intra_predictors_mby_s (reconintra.c:136-255)."""
        fb = self.cur
        b = BORDER
        y0, x0 = b + r * 16, b + c * 16
        up_avail = r != 0
        left_avail = c != 0
        above = fb.y[y0 - 1, x0:x0 + 16].astype(np.int32)
        left = fb.y[y0:y0 + 16, x0 - 1].astype(np.int32)
        tl = int(fb.y[y0 - 1, x0 - 1])
        blk = self._pred_block_16x16(mode, above, left, tl, up_avail,
                                     left_avail, 16)
        fb.y[y0:y0 + 16, x0:x0 + 16] = blk

    def _intra_uv_predict(self, r, c):
        """vp8_build_intra_predictors_mbuv_s (reconintra.c:257-470)."""
        fb = self.cur
        b2 = BORDER // 2
        y0, x0 = b2 + r * 8, b2 + c * 8
        mode = int(self.uv_mode[r, c])
        up_avail = r != 0
        left_avail = c != 0
        for pl in (fb.u, fb.v):
            above = pl[y0 - 1, x0:x0 + 8].astype(np.int32)
            left = pl[y0:y0 + 8, x0 - 1].astype(np.int32)
            tl = int(pl[y0 - 1, x0 - 1])
            blk = self._pred_block_16x16(mode, above, left, tl, up_avail,
                                         left_avail, 8)
            pl[y0:y0 + 8, x0:x0 + 8] = blk

    @staticmethod
    def _pred_block_16x16(mode, above, left, tl, up_avail, left_avail, n):
        if mode == DC_PRED:
            if up_avail or left_avail:
                total = 0
                if up_avail:
                    total += int(above.sum())
                if left_avail:
                    total += int(left.sum())
                shift = (n.bit_length() - 2) + up_avail + left_avail
                dc = (total + (1 << (shift - 1))) >> shift
            else:
                dc = 128
            return np.full((n, n), dc, dtype=np.uint8)
        if mode == V_PRED:
            return np.tile(above.astype(np.uint8), (n, 1))
        if mode == H_PRED:
            return np.tile(left.astype(np.uint8).reshape(n, 1), (1, n))
        # TM_PRED
        p = left.reshape(n, 1) + above.reshape(1, n) - tl
        return np.clip(p, 0, 255).astype(np.uint8)

    def _bpred_recon(self, r, c, qcoeff, eobs, dq_y1, skip):
        """B_PRED: per-4x4 predict + idct-add (decode_macroblock
        decodframe.c:196-238, reconintra4x4.c)."""
        fb = self.cur
        b = BORDER
        y0, x0 = b + r * 16, b + c * 16
        # vp8_intra_prediction_down_copy (reconintra4x4.c:291-306)
        ar = fb.y[y0 - 1, x0 + 16:x0 + 20]
        fb.y[y0 + 3, x0 + 16:x0 + 20] = ar
        fb.y[y0 + 7, x0 + 16:x0 + 20] = ar
        fb.y[y0 + 11, x0 + 16:x0 + 20] = ar
        dqv = np.array([dq_y1[0]] + [dq_y1[1]] * 15, dtype=np.int32)
        pr, pc = r + 1, c + 1
        for i in range(16):
            by = y0 + (i >> 2) * 4
            bx = x0 + (i & 3) * 4
            bmode = int(self.bmode[pr, pc, i])
            self._intra4x4_predict(fb.y, by, bx, bmode)
            if not skip and eobs[i]:
                if eobs[i] > 1:
                    idct4x4_add((qcoeff[i] * dqv).astype(np.int16),
                                fb.y, by, bx)
                else:
                    dc_only_idct_add(
                        _s16(int(qcoeff[i, 0]) * int(dqv[0]) & 0xFFFF),
                        fb.y, by, bx)

    @staticmethod
    def _intra4x4_predict(pl, y, x, mode):
        """vp8_intra4x4_predict_c (reconintra4x4.c:17-289)."""
        A = pl[y - 1, x:x + 8].astype(np.int32)  # Above[0..7]
        L = pl[y:y + 4, x - 1].astype(np.int32)
        tl = int(pl[y - 1, x - 1])
        out = np.zeros((4, 4), dtype=np.int32)
        if mode == B_DC:
            dc = (int(A[:4].sum()) + int(L.sum()) + 4) >> 3
            out[:] = dc
        elif mode == B_TM:
            p = L.reshape(4, 1) + A[:4].reshape(1, 4) - tl
            out = np.clip(p, 0, 255)
        elif mode == B_VE:
            ap = [(tl + 2 * A[0] + A[1] + 2) >> 2,
                  (A[0] + 2 * A[1] + A[2] + 2) >> 2,
                  (A[1] + 2 * A[2] + A[3] + 2) >> 2,
                  (A[2] + 2 * A[3] + A[4] + 2) >> 2]
            out[:] = np.array(ap)
        elif mode == B_HE:
            lp = [(tl + 2 * L[0] + L[1] + 2) >> 2,
                  (L[0] + 2 * L[1] + L[2] + 2) >> 2,
                  (L[1] + 2 * L[2] + L[3] + 2) >> 2,
                  (L[2] + 2 * L[3] + L[3] + 2) >> 2]
            out[:] = np.array(lp).reshape(4, 1)
        elif mode == B_LD:
            p = A
            e = lambda a, b_, c_: (int(a) + 2 * int(b_) + int(c_) + 2) >> 2
            out[0, 0] = e(p[0], p[1], p[2])
            out[0, 1] = out[1, 0] = e(p[1], p[2], p[3])
            out[0, 2] = out[1, 1] = out[2, 0] = e(p[2], p[3], p[4])
            out[0, 3] = out[1, 2] = out[2, 1] = out[3, 0] = e(p[3], p[4], p[5])
            out[1, 3] = out[2, 2] = out[3, 1] = e(p[4], p[5], p[6])
            out[2, 3] = out[3, 2] = e(p[5], p[6], p[7])
            out[3, 3] = e(p[6], p[7], p[7])
        elif mode in (B_RD, B_VR, B_HD):
            pp = [int(L[3]), int(L[2]), int(L[1]), int(L[0]), tl,
                  int(A[0]), int(A[1]), int(A[2]), int(A[3])]
            e = lambda i: (pp[i] + 2 * pp[i + 1] + pp[i + 2] + 2) >> 2
            h = lambda i: (pp[i] + pp[i + 1] + 1) >> 1
            if mode == B_RD:
                out[3, 0] = e(0)
                out[3, 1] = out[2, 0] = e(1)
                out[3, 2] = out[2, 1] = out[1, 0] = e(2)
                out[3, 3] = out[2, 2] = out[1, 1] = out[0, 0] = e(3)
                out[2, 3] = out[1, 2] = out[0, 1] = e(4)
                out[1, 3] = out[0, 2] = e(5)
                out[0, 3] = e(6)
            elif mode == B_VR:
                out[3, 0] = e(1)
                out[2, 0] = e(2)
                out[3, 1] = out[1, 0] = e(3)
                out[2, 1] = out[0, 0] = h(4)
                out[3, 2] = out[1, 1] = e(4)
                out[2, 2] = out[0, 1] = h(5)
                out[3, 3] = out[1, 2] = e(5)
                out[2, 3] = out[0, 2] = h(6)
                out[1, 3] = e(6)
                out[0, 3] = h(7)
            else:  # B_HD
                out[3, 0] = h(0)
                out[3, 1] = e(0)
                out[2, 0] = out[3, 2] = h(1)
                out[2, 1] = out[3, 3] = e(1)
                out[2, 2] = out[1, 0] = h(2)
                out[2, 3] = out[1, 1] = e(2)
                out[1, 2] = out[0, 0] = h(3)
                out[1, 3] = out[0, 1] = e(3)
                out[0, 2] = e(4)
                out[0, 3] = e(5)
        elif mode == B_VL:
            p = A
            e = lambda i: (int(p[i]) + 2 * int(p[i + 1]) + int(p[i + 2]) + 2) >> 2
            h = lambda i: (int(p[i]) + int(p[i + 1]) + 1) >> 1
            out[0, 0] = h(0)
            out[1, 0] = e(0)
            out[2, 0] = out[0, 1] = h(1)
            out[1, 1] = out[3, 0] = e(1)
            out[2, 1] = out[0, 2] = h(2)
            out[3, 1] = out[1, 2] = e(2)
            out[0, 3] = out[2, 2] = h(3)
            out[1, 3] = out[3, 2] = e(3)
            out[2, 3] = e(4)
            out[3, 3] = e(5)
        elif mode == B_HU:
            p = [int(x_) for x_ in L]
            e = lambda i: (p[i] + 2 * p[i + 1] + p[i + 2] + 2) >> 2
            h = lambda i: (p[i] + p[i + 1] + 1) >> 1
            out[0, 0] = h(0)
            out[0, 1] = e(0)
            out[0, 2] = out[1, 0] = h(1)
            out[0, 3] = out[1, 1] = e(1)
            out[1, 2] = out[2, 0] = h(2)
            out[1, 3] = out[2, 1] = (p[2] + 2 * p[3] + p[3] + 2) >> 2
            out[2, 2] = out[2, 3] = out[3, 0] = out[3, 1] = out[3, 2] = \
                out[3, 3] = p[3]
        pl[y:y + 4, x:x + 4] = out.astype(np.uint8)

    # -- inter prediction --------------------------------------------------

    def _ref_fb(self, ref):
        return {LAST_FRAME: self.last, GOLDEN_FRAME: self.golden,
                ALTREF_FRAME: self.altref}[ref]

    def _predict_block(self, src, dsty, dstx, srcy, srcx, w, hgt,
                       mvrow, mvcol, dst):
        """Full/sub-pel block predict into dst (build_inter_predictors_b)."""
        sy = srcy + (mvrow >> 3)
        sx = srcx + (mvcol >> 3)
        xoff, yoff = mvcol & 7, mvrow & 7
        if xoff or yoff:
            if self.use_bilinear:
                blk = _bilinear_2d(src, sy, sx, w, hgt, xoff, yoff)
            else:
                blk = _sixtap_2d(src, sy, sx, w, hgt, 0, xoff, yoff)
        else:
            blk = src[sy:sy + hgt, sx:sx + w]
        dst[dsty:dsty + hgt, dstx:dstx + w] = blk

    def _inter_predict(self, r, c):
        """vp8_build_inter_predictors_mb (reconinter.c:560-593)."""
        pr, pc = r + 1, c + 1
        mode = int(self.mode[pr, pc])
        ref = self._ref_fb(int(self.ref_frame[pr, pc]))
        fb = self.cur
        b, b2 = BORDER, BORDER // 2
        y0, x0 = b + r * 16, b + c * 16
        cy0, cx0 = b2 + r * 8, b2 + c * 8
        mb_to_left = -(c * 16) << 3
        mb_to_right = ((self.mb_cols - 1 - c) * 16) << 3
        mb_to_top = -(r * 16) << 3
        mb_to_bottom = ((self.mb_rows - 1 - r) * 16) << 3
        need_clamp = int(self.need_clamp[r, c])

        def clamp_umv(mv):
            """clamp_mv_to_umv_border (reconinter.c:349-370)."""
            row, col = mv
            if col < mb_to_left - (19 << 3):
                col = mb_to_left - (16 << 3)
            elif col > mb_to_right + (18 << 3):
                col = mb_to_right + (16 << 3)
            if row < mb_to_top - (19 << 3):
                row = mb_to_top - (16 << 3)
            elif row > mb_to_bottom + (18 << 3):
                row = mb_to_bottom + (16 << 3)
            return row, col

        def clamp_uvmv(mv):
            """clamp_uvmv_to_umv_border (reconinter.c:372-383)."""
            row, col = mv
            col = ((mb_to_left - (16 << 3)) >> 1) \
                if 2 * col < mb_to_left - (19 << 3) else col
            col = ((mb_to_right + (16 << 3)) >> 1) \
                if 2 * col > mb_to_right + (18 << 3) else col
            row = ((mb_to_top - (16 << 3)) >> 1) \
                if 2 * row < mb_to_top - (19 << 3) else row
            row = ((mb_to_bottom + (16 << 3)) >> 1) \
                if 2 * row > mb_to_bottom + (18 << 3) else row
            return row, col

        fullmask = 0xFFFFFFF8 if self.full_pixel else 0xFFFFFFFF

        def fpmask(v):
            # int16 MV component & fullpixel_mask, keeping sign
            return _s16(v & fullmask & 0xFFFF)

        if mode != SPLITMV:
            mvrow, mvcol = int(self.mv[pr, pc, 0]), int(self.mv[pr, pc, 1])
            if need_clamp:
                mvrow, mvcol = clamp_umv((mvrow, mvcol))
            self._predict_block(ref.y, y0, x0, y0, x0, 16, 16, mvrow, mvcol,
                                fb.y)
            # chroma MV derivation (reconinter.c:418-424)
            cr = mvrow + (1 if mvrow >= 0 else -1)
            cc = mvcol + (1 if mvcol >= 0 else -1)
            cr = int(cr / 2) if cr >= 0 else -((-cr) // 2)
            cc = int(cc / 2) if cc >= 0 else -((-cc) // 2)
            cr, cc = fpmask(cr), fpmask(cc)
            self._predict_block(ref.u, cy0, cx0, cy0, cx0, 8, 8, cr, cc, fb.u)
            self._predict_block(ref.v, cy0, cx0, cy0, cx0, 8, 8, cr, cc, fb.v)
            return

        # SPLITMV: build uv mvs (reconinter.c build_4x4uvmvs:527-558)
        bmv = [(int(self.bmv[pr, pc, i, 0]), int(self.bmv[pr, pc, i, 1]))
               for i in range(16)]
        uvmv = [None] * 4
        for i in range(2):
            for j in range(2):
                yoffs = i * 8 + j * 2
                tr = sum(bmv[yoffs + k][0] for k in (0, 1, 4, 5))
                tc = sum(bmv[yoffs + k][1] for k in (0, 1, 4, 5))
                tr = tr + 4 + (-8 if tr < 0 else 0)
                tc = tc + 4 + (-8 if tc < 0 else 0)
                mr = fpmask(int(tr / 8) if tr >= 0 else -((-tr) // 8))
                mc = fpmask(int(tc / 8) if tc >= 0 else -((-tc) // 8))
                if need_clamp:
                    mr, mc = clamp_uvmv((mr, mc))
                uvmv[i * 2 + j] = (mr, mc)

        part = int(self.partitioning[r, c])
        if need_clamp:
            bmv_cl = [clamp_umv(m) for m in bmv]
        else:
            bmv_cl = bmv
        if part < 3:
            # four 8x8 (build_inter4x4_predictors_mb reconinter.c:449-476)
            for k in (0, 2, 8, 10):
                mr, mc = bmv_cl[k]
                by = y0 + (k >> 2) * 4
                bx = x0 + (k & 3) * 4
                self._predict_block(ref.y, by, bx, by, bx, 8, 8, mr, mc, fb.y)
        else:
            for i in range(0, 16, 2):
                m0, m1 = bmv_cl[i], bmv_cl[i + 1]
                by = y0 + (i >> 2) * 4
                bx = x0 + (i & 3) * 4
                if m0 == m1:
                    self._predict_block(ref.y, by, bx, by, bx, 8, 4,
                                        m0[0], m0[1], fb.y)
                else:
                    self._predict_block(ref.y, by, bx, by, bx, 4, 4,
                                        m0[0], m0[1], fb.y)
                    self._predict_block(ref.y, by, bx + 4, by, bx + 4, 4, 4,
                                        m1[0], m1[1], fb.y)
        # chroma: 4 uv sub-blocks (reconinter.c:306-320; pairwise 8x4 vs two
        # 4x4 calls are numerically identical for separable filters)
        for i in range(2):
            for j in range(2):
                mr, mc = uvmv[i * 2 + j]
                for refpl, dstpl in ((ref.u, fb.u), (ref.v, fb.v)):
                    by = cy0 + i * 4
                    bx = cx0 + j * 4
                    self._predict_block(refpl, by, bx, by, bx, 4, 4, mr, mc,
                                        dstpl)

    # -- frame lifecycle ---------------------------------------------------

    def _swap_and_filter(self):
        """swap_frame_buffers + LF + extend (onyxd_if.c:261-311,540-610)."""
        cur = self.cur
        if self.frame_type == 0:
            self.golden = cur
            self.altref = cur
            self.last = cur
        else:
            if self.copy_to_arf == 1:
                self.altref = self.last
            elif self.copy_to_arf == 2:
                self.altref = self.golden
            if self.copy_to_gf == 1:
                self.golden = self.last
            elif self.copy_to_gf == 2:
                self.golden = self.altref
            if self.refresh_golden:
                self.golden = cur
            if self.refresh_alt:
                self.altref = cur
            if self.refresh_last:
                self.last = cur
        self.frame_to_show = cur
        if self.filter_level:
            self._loop_filter_frame()
        cur.extend_borders()
        if not self.refresh_entropy:
            self.fc = self.lfc.copy()

    # -- loop filter -------------------------------------------------------

    def _lf_limits(self):
        """vp8_loop_filter_update_sharpness (loopfilter.c:66-95)."""
        lim = np.zeros(64, dtype=np.int32)
        blim = np.zeros(64, dtype=np.int32)
        mblim = np.zeros(64, dtype=np.int32)
        sh = self.sharpness
        for i in range(64):
            inner = i >> (1 if sh > 0 else 0)
            inner >>= (1 if sh > 4 else 0)
            if sh > 0:
                inner = min(inner, 9 - sh)
            inner = max(inner, 1)
            lim[i] = inner
            blim[i] = 2 * i + inner
            mblim[i] = 2 * (i + 2) + inner
        return lim, blim, mblim

    def _lf_levels(self):
        """vp8_loop_filter_frame_init lvl lattice (loopfilter.c:117-199)."""
        lvl = np.zeros((4, 4, 4), dtype=np.int32)
        for seg in range(4):
            lvl_seg = self.filter_level
            if self.segmentation_enabled:
                if self.mb_segment_abs_delta:
                    lvl_seg = int(self.segment_feature_data[1, seg])
                else:
                    lvl_seg = self.filter_level + \
                        int(self.segment_feature_data[1, seg])
                    lvl_seg = min(63, max(0, lvl_seg))
            if not self.lf_delta_enabled:
                lvl[seg, :, :] = lvl_seg
                continue
            lvl_ref = lvl_seg + int(self.ref_lf_deltas[INTRA_FRAME])
            lvl[seg, INTRA_FRAME, 0] = min(
                63, max(0, lvl_ref + int(self.mode_lf_deltas[0])))
            lvl[seg, INTRA_FRAME, 1] = min(63, max(0, lvl_ref))
            for ref in range(1, 4):
                lref = lvl_seg + int(self.ref_lf_deltas[ref])
                for mode_idx in range(1, 4):
                    lvl[seg, ref, mode_idx] = min(
                        63, max(0, lref + int(self.mode_lf_deltas[mode_idx])))
        return lvl

    _MODE_LF_LUT = {DC_PRED: 1, V_PRED: 1, H_PRED: 1, TM_PRED: 1, B_PRED: 0,
                    ZEROMV: 1, NEARESTMV: 2, NEARMV: 2, NEWMV: 2, SPLITMV: 3}

    def _hev_threshold(self, filter_level):
        """lf_init_lut (loopfilter.c:25-50)."""
        kf = self.frame_type == 0
        if filter_level >= 40:
            return 2 if kf else 3
        if filter_level >= 20:
            return 1 if kf else 2
        if filter_level >= 15:
            return 1
        return 0

    def _loop_filter_frame(self, row_start=0):
        """vp8_loop_filter_frame (loopfilter.c:203-330). row_start>0 gives
        the encoder's partial-frame probe band (vp8_loop_filter_partial_frame,
        picklpf.c:26-88)."""
        lim, blim, mblim = self._lf_limits()
        lvl = self._lf_levels()
        fb = self.frame_to_show
        ey = _EdgeFilter(fb.y)
        eu = _EdgeFilter(fb.u)
        ev = _EdgeFilter(fb.v)
        b, b2 = BORDER, BORDER // 2
        for r in range(row_start, self.mb_rows):
            for c in range(self.mb_cols):
                pr, pc = r + 1, c + 1
                mode = int(self.mode[pr, pc])
                skip_lf = (mode not in (B_PRED, SPLITMV)
                           and int(self.skip[r, c]))
                mode_idx = self._MODE_LF_LUT[mode]
                seg = int(self.seg_map[r, c])
                ref = int(self.ref_frame[pr, pc])
                flevel = int(lvl[seg, ref, mode_idx])
                if not flevel:
                    continue
                y0, x0 = b + r * 16, b + c * 16
                cy0, cx0 = b2 + r * 8, b2 + c * 8
                if not self.simple_filter:
                    hev = self._hev_threshold(flevel)
                    ml, bl, il = int(mblim[flevel]), int(blim[flevel]), \
                        int(lim[flevel])
                    if c > 0:
                        ey.normal(y0, x0, 2, True, ml, il, hev, True)
                        eu.normal(cy0, cx0, 1, True, ml, il, hev, True)
                        ev.normal(cy0, cx0, 1, True, ml, il, hev, True)
                    if not skip_lf:
                        for dx in (4, 8, 12):
                            ey.normal(y0, x0 + dx, 2, True, bl, il, hev, False)
                        eu.normal(cy0, cx0 + 4, 1, True, bl, il, hev, False)
                        ev.normal(cy0, cx0 + 4, 1, True, bl, il, hev, False)
                    if r > 0:
                        ey.normal(y0, x0, 2, False, ml, il, hev, True)
                        eu.normal(cy0, cx0, 1, False, ml, il, hev, True)
                        ev.normal(cy0, cx0, 1, False, ml, il, hev, True)
                    if not skip_lf:
                        for dy in (4, 8, 12):
                            ey.normal(y0 + dy, x0, 2, False, bl, il, hev,
                                      False)
                        eu.normal(cy0 + 4, cx0, 1, False, bl, il, hev, False)
                        ev.normal(cy0 + 4, cx0, 1, False, bl, il, hev, False)
                else:
                    ml, bl = int(mblim[flevel]), int(blim[flevel])
                    if c > 0:
                        ey.simple(y0, x0, 2, True, ml)
                    if not skip_lf:
                        for dx in (4, 8, 12):
                            ey.simple(y0, x0 + dx, 2, True, bl)
                    if r > 0:
                        ey.simple(y0, x0, 2, False, ml)
                    if not skip_lf:
                        for dy in (4, 8, 12):
                            ey.simple(y0 + dy, x0, 2, False, bl)


def decode_ivf(path_or_bytes, limit=None):
    """Decode an IVF stream; yields (y, u, v) visible planes per shown frame."""
    from ..utils.ivf import read_ivf
    stream = read_ivf(path_or_bytes)
    dec = RefDecoder()
    count = 0
    for payload, _pts in stream.frames:
        show, planes = dec.decode_frame(payload)
        if show:
            yield planes
            count += 1
            if limit and count >= limit:
                return
