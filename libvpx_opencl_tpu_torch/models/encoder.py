"""Golden VP8 encoder (host reference model).

A from-scratch encoder producing conforming VP8 streams, validated two ways:
round-trip bit-exactness through this framework's decoder (itself MD5-exact
vs the reference vpxdec) and, where the reference binaries are available,
directly through vpxdec.

Round-1 scope (the encoder grows toward SURVEY.md §2.4 parity in later
stages): keyframes + inter frames over the LAST reference; per-MB mode
decision among intra DC/V/H/TM and inter ZEROMV/NEARESTMV/NEARMV/NEWMV with
full-pel + half/quarter-pel motion search; forward DCT/WHT
(vp8_short_fdct4x4_c / vp8_short_walsh4x4_c, dct.c:14-116); fast
quantization (vp8_fast_quantize_b_c, quantize.c:70-100, round factor 48/128
per vp8cx_init_quantizer quantize.c:433-500); single token partition;
default probability tables; fixed Q per frame (rate control host layer comes
next).  Reference state is closed-loop: each packed frame is decoded by the
framework's own bit-exact decoder to produce the loop-filtered reference
frames the next frame predicts from (in-loop intra prediction uses the
encoder's unfiltered reconstruction, matching decodframe semantics).

Bitstream layout mirrors the parser in refdec.decode_frame_core
(decodframe.c:690-1181), mode coding mirrors decodemv.c, token coding
mirrors detokenize.c's state machine (incl. the skip-EOB-after-zero rule,
via tree writes starting at node 2), MV coding mirrors
read_mvcomponent (decodemv.c:76-107).
"""
from __future__ import annotations

import numpy as np

from ..ops import tables as T
from . import refdec
from .refdec import (B_PRED, DC_PRED, V_PRED, H_PRED, TM_PRED,
                     NEARESTMV, NEARMV, ZEROMV, NEWMV, SPLITMV,
                     INTRA_FRAME, LAST_FRAME, GOLDEN_FRAME, ALTREF_FRAME,
                     BORDER, RefDecoder, dequant_factors, _s16)
from .boolenc import BoolEncoder
from . import rdopt

_TC_CACHE = {}


def _default_token_costs():
    """Frame token-cost table under the default coefficient probabilities
    (fill_token_costs, rdopt.c:129; cached — the tables are constant)."""
    if "d" not in _TC_CACHE:
        _TC_CACHE["d"] = rdopt.build_token_costs(T.DEFAULT_COEF_PROBS)
    return _TC_CACHE["d"]

ZIGZAG = T.ZIGZAG.tolist()
COEF_BANDS = T.COEF_BANDS.tolist()
CAT_MIN = [5, 7, 11, 19, 35, 67]
CAT_PROBS = [T.PCAT1.tolist(), T.PCAT2.tolist(), T.PCAT3.tolist(),
             T.PCAT4.tolist(), T.PCAT5.tolist(), T.PCAT6.tolist()]
BLOCK2ABOVE = refdec.BLOCK2ABOVE
BLOCK2LEFT = refdec.BLOCK2LEFT


def fdct4x4(block):
    """vp8_short_fdct4x4_c (dct.c:14-56). block: 4x4 int array (residual).
    Returns 16 coeffs raster order."""
    ip = block.astype(np.int64)
    tmp = np.zeros((4, 4), np.int64)
    for i in range(4):
        a1 = (ip[i, 0] + ip[i, 3]) << 3
        b1 = (ip[i, 1] + ip[i, 2]) << 3
        c1 = (ip[i, 1] - ip[i, 2]) << 3
        d1 = (ip[i, 0] - ip[i, 3]) << 3
        tmp[i, 0] = a1 + b1
        tmp[i, 2] = a1 - b1
        tmp[i, 1] = (c1 * 2217 + d1 * 5352 + 14500) >> 12
        tmp[i, 3] = (d1 * 2217 - c1 * 5352 + 7500) >> 12
    out = np.zeros((4, 4), np.int64)
    for i in range(4):
        a1 = tmp[0, i] + tmp[3, i]
        b1 = tmp[1, i] + tmp[2, i]
        c1 = tmp[1, i] - tmp[2, i]
        d1 = tmp[0, i] - tmp[3, i]
        out[0, i] = (a1 + b1 + 7) >> 4
        out[2, i] = (a1 - b1 + 7) >> 4
        out[1, i] = ((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0)
        out[3, i] = (d1 * 2217 - c1 * 5352 + 51000) >> 16
    return out.reshape(16).astype(np.int32)


def walsh4x4(dcs):
    """vp8_short_walsh4x4_c (dct.c:64-116). dcs: 16 Y-block DC coeffs in
    raster order (as a 4x4). Returns 16 Y2 coeffs."""
    ip = np.asarray(dcs, np.int64).reshape(4, 4)
    tmp = np.zeros((4, 4), np.int64)
    for i in range(4):
        a1 = (ip[i, 0] + ip[i, 2]) << 2
        d1 = (ip[i, 1] + ip[i, 3]) << 2
        c1 = (ip[i, 1] - ip[i, 3]) << 2
        b1 = (ip[i, 0] - ip[i, 2]) << 2
        tmp[i, 0] = a1 + d1 + (a1 != 0)
        tmp[i, 1] = b1 + c1
        tmp[i, 2] = b1 - c1
        tmp[i, 3] = a1 - d1
    out = np.zeros((4, 4), np.int64)
    for i in range(4):
        a1 = tmp[0, i] + tmp[2, i]
        d1 = tmp[1, i] + tmp[3, i]
        c1 = tmp[1, i] - tmp[3, i]
        b1 = tmp[0, i] - tmp[2, i]
        a2 = a1 + d1
        b2 = b1 + c1
        c2 = b1 - c1
        d2 = a1 - d1
        out[0, i] = ((a2 + (a2 < 0)) + 3) >> 3
        out[1, i] = ((b2 + (b2 < 0)) + 3) >> 3
        out[2, i] = ((c2 + (c2 < 0)) + 3) >> 3
        out[3, i] = ((d2 + (d2 < 0)) + 3) >> 3
    return out.reshape(16).astype(np.int32)


def fast_quant(coeffs, dq, first=0):
    """vp8_fast_quantize_b_c (quantize.c:70-100): y=((x+round)*q16)>>16.
    round = (48 * dequant) >> 7 (qrounding factor, vp8cx_init_quantizer).
    coeffs raster [16]; dq = (dc, ac). Returns (levels[16] raster, eob)."""
    q16 = [(1 << 16) // dq[0], (1 << 16) // dq[1]]
    rnd = [(48 * dq[0]) >> 7, (48 * dq[1]) >> 7]
    levels = np.zeros(16, np.int32)
    eob = 0
    for i in range(first, 16):
        rc = ZIGZAG[i]
        z = int(coeffs[rc])
        sz = -1 if z < 0 else 0
        x = abs(z)
        k = 0 if rc == 0 else 1
        y = ((x + rnd[k]) * q16[k]) >> 16
        y = min(y, 2047)  # keep within coded token range (cat6 max)
        levels[rc] = -y if sz else y
        if y:
            eob = i + 1
    return levels, eob


# zero-run zbin boost: the dead zone widens with the distance from the
# previous nonzero coefficient (vp8cx_init_quantizer, quantize.c:438-440)
ZBIN_BOOST = [0, 0, 8, 10, 12, 14, 16, 20, 24, 28, 32, 36, 40, 44, 44, 44]


def regular_quant(coeffs, dq, qidx, first=0, act_adj=0):
    """vp8_regular_quantize_b_c (quantize.c:106-156): zbin dead zone with
    zero-run boost, improved-quant reciprocal (quantize.c:411-424).
    coeffs raster [16]; dq = (dc, ac); qidx = frame/segment Q for the
    zbin factor (84 below Q48 else 80); act_adj = the activity-masking
    zbin adjustment (x->act_zbin_adj, encodeframe.c:340-357), scaled into
    the dead zone like vp8_update_zbin_extra. Returns (levels, eob)."""
    zf = 84 if qidx < 48 else 80
    zextra = (dq[1] * act_adj) >> 7
    zbin = [(((zf * dq[0]) + 64) >> 7) + zextra,
            (((zf * dq[1]) + 64) >> 7) + zextra]
    rnd = [(48 * dq[0]) >> 7, (48 * dq[1]) >> 7]
    qsh = []
    for d in dq:
        t, l = int(d), 0
        while t > 1:
            t >>= 1
            l += 1
        qsh.append((1 + (1 << (16 + l)) // int(d) - (1 << 16), l))
    levels = np.zeros(16, np.int32)
    eob = 0
    zrun = first
    for i in range(first, 16):
        rc = ZIGZAG[i]
        z = int(coeffs[rc])
        k = 0 if rc == 0 else 1
        boost = (dq[1] * ZBIN_BOOST[min(zrun, 15)]) >> 7
        x = abs(z)
        if x >= zbin[k] + boost:
            x += rnd[k]
            quant, shift = qsh[k]
            y = (((x * quant) >> 16) + x) >> shift
            y = min(y, 2047)
            levels[rc] = -y if z < 0 else y
            if y:
                eob = i + 1
                zrun = 0
                continue
        zrun += 1
    return levels, eob


from dataclasses import dataclass


@dataclass
class SpeedFeatures:
    """Effort toggles (the vp8_set_speed_features ladder role,
    onyx_if.c:670): each level trades search breadth for speed."""
    rd: bool = True              # token-cost RD decision + trellis path
    trellis: bool = True         # optimize_b coefficient optimization
    splitmv: bool = True         # SPLITMV partition search
    bpred: bool = True           # B_PRED intra 4x4 mode search
    exhaustive_me: bool = True   # step-1 exhaustive full-pel (else step-2)
    multi_ref: bool = True       # search GOLDEN/ALTREF references


def speed_features(cpu_used):
    """Map a vpxenc-style --cpu-used value (0..16, sign ignored) to a
    SpeedFeatures ladder (vp8_set_speed_features, onyx_if.c:670)."""
    s = abs(int(cpu_used))
    if s == 0:
        return SpeedFeatures()
    if s <= 2:
        return SpeedFeatures(exhaustive_me=False)
    if s <= 4:
        return SpeedFeatures(exhaustive_me=False, splitmv=False)
    if s <= 7:
        return SpeedFeatures(exhaustive_me=False, splitmv=False,
                             trellis=False, bpred=False)
    if s <= 11:
        return SpeedFeatures(rd=False, trellis=False, splitmv=False,
                             bpred=False, exhaustive_me=False)
    return SpeedFeatures(rd=False, trellis=False, splitmv=False,
                         bpred=False, exhaustive_me=False,
                         multi_ref=False)


class Encoder:
    """VP8 encoder producing IVF-compatible frame payloads."""

    def __init__(self, width, height, qindex=24, filter_level=None,
                 token_parts=0, mb_no_coeff_skip=True, golden_interval=0,
                 rd=True, cpu_used=None):
        self.w, self.h = width, height
        self.qindex = qindex
        self.fixed_filter = filter_level
        self.token_parts = token_parts  # log2 of partition count (0..3)
        self.mb_no_coeff_skip = mb_no_coeff_skip
        self.golden_interval = golden_interval  # refresh golden every N (0=off)
        #: True = token-cost RD mode decision + trellis coefficient
        #: optimization (rdopt.c / encodemb.c roles); False = the fast
        #: SAD path (pickinter.c role, used by the TPU encoder twin)
        self.rd = rd
        #: --tune=ssim activity masking (encodeframe.c:81-357):
        #: per-MB source-activity zbin adjustment
        self.tune_ssim = False
        # speed-feature ladder (vp8_set_speed_features, onyx_if.c:670)
        if cpu_used is None:
            self.sf = speed_features(0 if rd else 9)
        else:
            self.sf = speed_features(cpu_used)
            self.rd = self.sf.rd
        self.R = (height + 15) >> 4
        self.C = (width + 15) >> 4
        self.dec = _mk_dec()
        self.frame_count = 0
        self.seg_map_enc = None       # [R, C] segment ids (0..3)
        self.seg_q_deltas = [0, 0, 0, 0]
        self.seg_lf_deltas = [0, 0, 0, 0]
        # mode-signal probabilities used for RD costs: carried over from
        # the previous frame's pack (cpi->prob_intra_coded role)
        self.prob_intra = 63
        self.prob_last = 255
        self.prob_gf = 128
        self.prob_skip_false = 192

    def _build_activity_map(self, src):
        """Activity masking (encodeframe.c:81-357): per-MB source
        variance (mb_activity_measure, VP8_ACTIVITY_AVG_MIN floor),
        frame average, and the adjust_act_zbin dead-zone deltas."""
        b = BORDER
        R, C = self.R, self.C
        y = src.y[b:b + R * 16, b:b + C * 16].astype(np.int64)
        blocks = y.reshape(R, 16, C, 16).transpose(0, 2, 1, 3) \
            .reshape(R, C, 256)
        s = blocks.sum(-1)
        sse = (blocks * blocks).sum(-1)
        act = np.maximum(sse - (s * s) // 256, 64)
        avg = max(64, int(act.sum() // act.size))
        a = act + 4 * avg
        bb = 4 * act + avg
        adj = np.where(act > avg, (bb + a // 2) // a - 1,
                       1 - (a + bb // 2) // bb).astype(np.int64)
        self._act_adj_map = adj
        self._act_map = act
        self._act_avg = avg

    def _reset_key_frame_state(self):
        """vp8_setup_key_frame (onyx_if.c): keyframes reset the adaptive
        mode-signaling probabilities to defaults, so a stream is
        bit-identical whether encoded straight through or restarted at
        each keyframe (the GOP-parallel encode invariant)."""
        self.prob_intra = 63
        self.prob_last = 255
        self.prob_gf = 128
        self.prob_skip_false = 192

    def set_roimap(self, seg_map, q_deltas, lf_deltas=(0, 0, 0, 0)):
        """vp8_set_roimap (onyx_if.c:5112) / VP8E_SET_ROI_MAP: per-MB
        segment ids with per-segment quantizer and loop-filter deltas
        (segmentation.c role). Pass seg_map=None to disable."""
        if seg_map is None:
            self.seg_map_enc = None
            return
        import numpy as _np
        m = _np.asarray(seg_map, _np.int32)
        assert m.shape == (self.R, self.C)
        self.seg_map_enc = m
        self.seg_q_deltas = [int(x) for x in q_deltas]
        self.seg_lf_deltas = [int(x) for x in lf_deltas]

    @property
    def filter_level(self):
        if self.fixed_filter is not None:
            return self.fixed_filter
        if getattr(self, "_picked_level", None) is not None:
            return self._picked_level
        return min(63, max(1, self.qindex // 4 + 2))

    # ------------------------------------------------------------------
    # loop-filter level search (vp8cx_pick_filter_level, picklpf.c:261)

    def _lf_sse(self, level, keyframe, row0, rows):
        """Luma SSE between the source and the reconstruction filtered at
        `level`, over a partial band of MB rows (the partial-frame probe of
        vp8_loop_filter_partial_frame, picklpf.c:26-88)."""
        if level == 0:
            fy = self.rec.y
        else:
            fb = type("FB", (), {})()
            fb.y = self.rec.y.copy()
            fb.u = self.rec.u.copy()
            fb.v = self.rec.v.copy()
            shim = type("LF", (), {
                "_lf_limits": RefDecoder._lf_limits,
                "_lf_levels": RefDecoder._lf_levels,
                "_hev_threshold": RefDecoder._hev_threshold,
                "_MODE_LF_LUT": RefDecoder._MODE_LF_LUT,
                "_loop_filter_frame": RefDecoder._loop_filter_frame})()
            shim.mb_rows = row0 + rows
            shim.mb_cols = self.C
            shim.filter_level = level
            shim.sharpness = 0
            shim.frame_type = 0 if keyframe else 1
            shim.segmentation_enabled = self.seg_map_enc is not None
            shim.mb_segment_abs_delta = 0
            sfd = np.zeros((2, 4), np.int32)
            sfd[1] = self.seg_lf_deltas
            shim.segment_feature_data = sfd
            shim.lf_delta_enabled = 0
            shim.simple_filter = 0
            shim.seg_map = self.seg_map_enc if self.seg_map_enc is not None \
                else np.zeros((self.R, self.C), np.int32)
            shim.mode = self.mode
            shim.ref_frame = self.reff
            shim.skip = self.skip
            shim.frame_to_show = fb
            # reuse the golden LF verbatim (bit-exact vs vpxdec)
            shim._loop_filter_frame(row_start=row0)
            fy = fb.y
        b = BORDER
        y0 = b + row0 * 16
        y1 = b + (row0 + rows) * 16
        src = self.src.y[y0:y1, b:b + self.C * 16].astype(np.int64)
        rec = fy[y0:y1, b:b + self.C * 16].astype(np.int64)
        return int(((src - rec) ** 2).sum())

    def _pick_filter_level(self, keyframe):
        """Coarse-to-fine level search on a middle band of the frame
        (picklpf.c:261-395 behavior: start from the previous level, halve
        the step while the partial-frame SSE improves)."""
        rows = max(2, self.R // 3)
        row0 = max(0, (self.R - rows) // 2)
        last = getattr(self, "_picked_level", None)
        mid = last if last is not None else min(63, max(1,
                                                        self.qindex // 4 + 2))
        cache = {}

        def sse(lv):
            lv = min(63, max(0, lv))
            if lv not in cache:
                cache[lv] = self._lf_sse(lv, keyframe, row0, rows)
            return cache[lv]

        best = mid
        step = 4 if mid < 16 else mid // 4
        while step >= 1:
            for cand in (best - step, best + step):
                cand = min(63, max(0, cand))
                if sse(cand) < sse(best):
                    best = cand
            step //= 2
        self._picked_level = max(1, best)
        return self._picked_level

    # ------------------------------------------------------------------
    def encode_frame(self, y, u, v, keyframe=None, refresh_last=True,
                     refresh_golden=None, commit=True, show=True,
                     refresh_alt=False):
        """Encode one I420 frame (uint8 planes). Returns the VP8 payload.
        refresh_last/refresh_golden control reference updates (temporal
        scalability patterns encode enhancement layers with no refreshes —
        vp8_scalable_patterns.c role). commit=False leaves the closed-loop
        reference state untouched so a rate-control recode loop can re-run
        the frame at a different Q (the reference's recode loop,
        onyx_if.c:3600-3800); call commit_frame(payload) to accept."""
        if keyframe is None:
            keyframe = self.frame_count == 0
        if keyframe:
            self._reset_key_frame_state()
        self.refresh_last_flag = bool(refresh_last) or keyframe
        R, C = self.R, self.C
        b = BORDER
        b2 = BORDER // 2
        # padded source (replicate to aligned dims)
        src = refdec.FrameBuffer(self.w, self.h)
        sy, su, sv = src.visible()
        sy[:] = y
        su[:] = u
        sv[:] = v
        # replicate into the aligned area (vp8_copy_and_extend_frame role)
        bb, bb2 = BORDER, BORDER // 2
        src.y[bb:bb + src.ah, bb + self.w:bb + src.aw] = \
            src.y[bb:bb + src.ah, bb + self.w - 1:bb + self.w]
        src.y[bb + self.h:bb + src.ah, bb:bb + src.aw] = \
            src.y[bb + self.h - 1:bb + self.h, bb:bb + src.aw]
        cw, ch = (self.w + 1) // 2, (self.h + 1) // 2
        for p in (src.u, src.v):
            p[bb2:bb2 + src.ah // 2, bb2 + cw:bb2 + src.aw // 2] = \
                p[bb2:bb2 + src.ah // 2, bb2 + cw - 1:bb2 + cw]
            p[bb2 + ch:bb2 + src.ah // 2, bb2:bb2 + src.aw // 2] = \
                p[bb2 + ch - 1:bb2 + ch, bb2:bb2 + src.aw // 2]
        src.extend_borders()
        self.src = src
        if self.tune_ssim:
            self._build_activity_map(src)
        # unfiltered in-loop reconstruction buffer
        self.rec = refdec.FrameBuffer(self.w, self.h)
        self.rec.setup_intra_recon()

        dq = dequant_factors(self.qindex, 0, 0, 0, 0, 0)
        self.dq_y1, self.dq_y2, self.dq_uv = dq
        # per-segment dequant variants (delta-coded, clamped like
        # mb_init_dequantizer decodframe.c:84-86)
        self.seg_dq = None
        if self.seg_map_enc is not None:
            self.seg_dq = []
            for s in range(4):
                qi = min(127, max(0, self.qindex + self.seg_q_deltas[s]))
                self.seg_dq.append(dequant_factors(qi, 0, 0, 0, 0, 0))

        # padded mode grids (decoder-mirroring layout)
        self.mode = np.zeros((R + 1, C + 1), np.int32)
        self.uvmode = np.zeros((R, C), np.int32)
        self.reff = np.zeros((R + 1, C + 1), np.int32)
        self.mv = np.zeros((R + 1, C + 1, 2), np.int32)
        self.bmode = np.zeros((R + 1, C + 1, 16), np.int32)
        self.bmv = np.zeros((R + 1, C + 1, 16, 2), np.int32)
        self.split_part = np.zeros((R, C), np.int32)
        self.qcoeff = np.zeros((R, C, 25, 16), np.int32)
        self.eobs = np.zeros((R, C, 25), np.int32)
        # RD state: lambda (vp8_initialize_rd_consts), frame token-cost
        # table (pre-update defaults, matching refresh_entropy_probs=0),
        # and the entropy-context mirror tracked in raster order
        self.rdmult, self.rddiv, self.errorperbit = rdopt.rd_consts(
            self.qindex)
        self._rdmult_base = self.rdmult
        self._epb_base = self.errorperbit
        self._tc = _default_token_costs()
        self._actx = np.zeros((C, 9), np.int32)

        if refresh_golden is None:
            refresh_golden = bool(
                self.golden_interval and
                self.frame_count % self.golden_interval == 0)
        self.refresh_golden = bool(refresh_golden)
        self.refresh_alt = bool(refresh_alt)
        self.show_frame = bool(show) or keyframe
        refs = None
        if not keyframe:
            refs = [(self.dec.last, LAST_FRAME)]
            if self.sf.multi_ref:
                if self.dec.golden is not self.dec.last:
                    refs.append((self.dec.golden, GOLDEN_FRAME))
                if (self.dec.altref is not self.dec.last and
                        self.dec.altref is not self.dec.golden):
                    refs.append((self.dec.altref, ALTREF_FRAME))
        for r in range(R):
            self._lctx = np.zeros(9, np.int32)
            for c in range(C):
                if self.rd:
                    self._encode_mb_rd(r, c, keyframe, refs)
                else:
                    self._encode_mb(r, c, keyframe, refs)

        # per-MB skip decision (decode_macroblock's eobtotal==0 semantics)
        self.skip = np.zeros((R, C), np.int32)
        if self.mb_no_coeff_skip:
            for r in range(R):
                for c in range(C):
                    has_y2 = int(self.mode[r + 1, c + 1]) not in (B_PRED,
                                                                  SPLITMV)
                    e = self.eobs[r, c]
                    total = int(e.sum()) - (16 if has_y2 else 0) \
                        - (int(e[24]) if not has_y2 else 0)
                    if has_y2:
                        self.skip[r, c] = int(total == 0)
                    else:
                        self.skip[r, c] = int(e[:24].sum() == 0)

        # in-encoder loop-filter level search (vp8cx_pick_filter_level,
        # picklpf.c:261) — only when the caller didn't pin a level
        if self.fixed_filter is None:
            self._pick_filter_level(keyframe)

        payload = self._pack(keyframe)
        if commit:
            self.commit_frame(payload)
        return payload

    def commit_frame(self, payload):
        """Advance the closed loop (decode the accepted payload into the
        reference ring) — split out for the RC recode loop."""
        self.dec.decode_frame_core(payload)
        self.frame_count += 1

    # ------------------------------------------------------------------
    def _encode_mb(self, r, c, keyframe, refs):
        self._act_adj_now = int(self._act_adj_map[r, c]) \
            if self.tune_ssim else 0
        if self.tune_ssim:
            # vp8_activity_masking (encodeframe.c:340-357): per-MB RD
            # multiplier scaled by activity vs the frame average
            act = int(self._act_map[r, c])
            avg = self._act_avg
            a_ = act + 2 * avg
            b_ = 2 * act + avg
            self.rdmult = max(1, (self._rdmult_base * b_ + a_ // 2) // a_)
            self.errorperbit = max(1, self._epb_base * b_ // a_)
        R, C = self.R, self.C
        b, b2 = BORDER, BORDER // 2
        y0, x0 = b + r * 16, b + c * 16
        cy0, cx0 = b2 + r * 8, b2 + c * 8
        src_y = self.src.y[y0:y0 + 16, x0:x0 + 16].astype(np.int32)
        up_avail = r != 0
        left_avail = c != 0

        # intra y16 candidates from the unfiltered recon neighbors
        above = self.rec.y[y0 - 1, x0:x0 + 16].astype(np.int32)
        left = self.rec.y[y0:y0 + 16, x0 - 1].astype(np.int32)
        tl = int(self.rec.y[y0 - 1, x0 - 1])
        best_mode, best_cost, best_pred = None, 1 << 60, None
        for m in (DC_PRED, V_PRED, H_PRED, TM_PRED):
            pred = RefDecoder._pred_block_16x16(m, above, left, tl,
                                               up_avail, left_avail, 16) \
                .astype(np.int32)
            cost = int(np.abs(src_y - pred).sum())
            if cost < best_cost:
                best_mode, best_cost, best_pred = m, cost, pred

        mode, mv, pred_y = best_mode, (0, 0), best_pred
        is_inter = False
        ref_used = LAST_FRAME
        ref = self.dec.last if not keyframe else None
        if not keyframe:
            best_ic = None
            for ref_fb, ref_id in refs:
                penalty = 0 if ref_id == LAST_FRAME else 200
                imode, imv, icost, ipred = self._inter_search(r, c, ref_fb,
                                                              src_y)
                if best_ic is None or icost + penalty < best_ic[0]:
                    best_ic = (icost + penalty, imode, imv, ipred, ref_fb,
                               ref_id)
            if best_ic[0] + 300 < best_cost:
                _, mode, mv, pred_y, ref, ref_used = best_ic
                is_inter = True

        pr, pc = r + 1, c + 1
        self.mode[pr, pc] = mode
        self.reff[pr, pc] = ref_used if is_inter else INTRA_FRAME
        self.mv[pr, pc] = mv

        # chroma prediction
        if is_inter:
            cr, cc2 = _uv_mv(mv)
            pred_u = self._mc_block(ref.u, cy0, cx0, cr, cc2, 8)
            pred_v = self._mc_block(ref.v, cy0, cx0, cr, cc2, 8)
            self.uvmode[r, c] = DC_PRED
        else:
            bu, bv = self.rec.u, self.rec.v
            src_u = self.src.u[cy0:cy0 + 8, cx0:cx0 + 8].astype(np.int32)
            src_v = self.src.v[cy0:cy0 + 8, cx0:cx0 + 8].astype(np.int32)
            bestm, bestc, bpu, bpv = None, 1 << 60, None, None
            for m in (DC_PRED, V_PRED, H_PRED, TM_PRED):
                pu = RefDecoder._pred_block_16x16(
                    m, bu[cy0 - 1, cx0:cx0 + 8].astype(np.int32),
                    bu[cy0:cy0 + 8, cx0 - 1].astype(np.int32),
                    int(bu[cy0 - 1, cx0 - 1]), up_avail, left_avail, 8) \
                    .astype(np.int32)
                pv = RefDecoder._pred_block_16x16(
                    m, bv[cy0 - 1, cx0:cx0 + 8].astype(np.int32),
                    bv[cy0:cy0 + 8, cx0 - 1].astype(np.int32),
                    int(bv[cy0 - 1, cx0 - 1]), up_avail, left_avail, 8) \
                    .astype(np.int32)
                cost = int(np.abs(src_u - pu).sum() +
                           np.abs(src_v - pv).sum())
                if cost < bestc:
                    bestm, bestc, bpu, bpv = m, cost, pu, pv
            self.uvmode[r, c] = bestm
            pred_u, pred_v = bpu, bpv

        # ---- transform + quant + in-loop recon ----
        if self.seg_dq is not None:
            seg = int(self.seg_map_enc[r, c])
            self.dq_y1, self.dq_y2, self.dq_uv = self.seg_dq[seg]
        resid = src_y - pred_y
        ycoef = np.zeros((16, 16), np.int32)
        for i in range(16):
            by, bx = (i >> 2) * 4, (i & 3) * 4
            ycoef[i] = fdct4x4(resid[by:by + 4, bx:bx + 4])
        y2 = walsh4x4(ycoef[:, 0].copy())
        q2, eob2 = fast_quant(y2, self.dq_y2)
        self.qcoeff[r, c, 24] = q2
        self.eobs[r, c, 24] = eob2
        for i in range(16):
            ql, eob = fast_quant(ycoef[i], self.dq_y1, first=1)
            self.qcoeff[r, c, i] = ql
            self.eobs[r, c, i] = max(eob, 1)
        # chroma
        src_u = self.src.u[cy0:cy0 + 8, cx0:cx0 + 8].astype(np.int32)
        src_v = self.src.v[cy0:cy0 + 8, cx0:cx0 + 8].astype(np.int32)
        for plane_i, (sp, pp) in enumerate(((src_u, pred_u), (src_v, pred_v))):
            residc = sp - pp
            for j in range(4):
                by, bx = (j >> 1) * 4, (j & 1) * 4
                coefs = fdct4x4(residc[by:by + 4, bx:bx + 4])
                ql, eob = fast_quant(coefs, self.dq_uv)
                self.qcoeff[r, c, 16 + plane_i * 4 + j] = ql
                self.eobs[r, c, 16 + plane_i * 4 + j] = eob

        # reconstruct exactly as the decoder does (decodframe.c:247-305)
        self._recon_mb(r, c, pred_y, pred_u, pred_v)
        # keep the bmode context grid consistent for B_PRED neighbors
        self.bmode[r + 1, c + 1] = 0

    # ------------------------------------------------------------------
    # RD path: token-cost mode decision (rdopt.c:560,1714,2374 roles) +
    # trellis coefficient optimization (encodemb.c:224 optimize_b)

    def _quant_y16(self, src_y, pred_y, dq_y1, dq_y2, qidx):
        """FDCT + WHT + regular zbin quant of a 16x16 Y residual (has_y2
        layout). Returns (coeffs [17,16] with Y2 at [16], q, eobs [17],
        tdist)."""
        resid = src_y - pred_y
        coeffs = np.zeros((17, 16), np.int32)
        for i in range(16):
            by, bx = (i >> 2) * 4, (i & 3) * 4
            coeffs[i] = fdct4x4(resid[by:by + 4, bx:bx + 4])
        coeffs[16] = walsh4x4(coeffs[:16, 0].copy())
        q = np.zeros((17, 16), np.int32)
        eobs = np.zeros(17, np.int32)
        adj = getattr(self, "_act_adj_now", 0)
        q[16], eobs[16] = regular_quant(coeffs[16], dq_y2, qidx,
                                        act_adj=adj)
        for i in range(16):
            q[i], e = regular_quant(coeffs[i], dq_y1, qidx, first=1,
                                    act_adj=adj)
            eobs[i] = max(e, 1)
        # transform-domain error, DC excluded for Y (vp8_mbblock_error
        # dc=0) + Y2 error (vp8_block_error); caller shifts >>2
        dqv2 = np.array([dq_y2[0]] + [dq_y2[1]] * 15, np.int64)
        err = int(((coeffs[:16, 1:] -
                    q[:16, 1:].astype(np.int64) * dq_y1[1]) ** 2).sum())
        err += int(((coeffs[16].astype(np.int64) - q[16] * dqv2) ** 2).sum())
        return coeffs, q, eobs, err

    def _quant_uv(self, src_u, pred_u, src_v, pred_v, dq_uv, qidx):
        """Returns (coeffs [8,16], q, eobs [8], tdist)."""
        coeffs = np.zeros((8, 16), np.int32)
        for pi, (sp, pp) in enumerate(((src_u, pred_u), (src_v, pred_v))):
            residc = sp - pp
            for j in range(4):
                by, bx = (j >> 1) * 4, (j & 1) * 4
                coeffs[pi * 4 + j] = fdct4x4(residc[by:by + 4, bx:bx + 4])
        q = np.zeros((8, 16), np.int32)
        eobs = np.zeros(8, np.int32)
        adj = getattr(self, "_act_adj_now", 0)
        for j in range(8):
            q[j], eobs[j] = regular_quant(coeffs[j], dq_uv, qidx,
                                          act_adj=adj)
        dqv = np.array([dq_uv[0]] + [dq_uv[1]] * 15, np.int64)
        err = int(((coeffs.astype(np.int64) - q * dqv[None]) ** 2).sum())
        return coeffs, q, eobs, err

    def _cost_y(self, q, eobs, has_y2, actx, lctx):
        """Token rate of the Y (+Y2) blocks; updates the ctx copies."""
        rate = 0
        if has_y2:
            r_, nz = rdopt.cost_block(q[16], int(eobs[16]), 0,
                                      int(actx[8] + lctx[8]), self._tc[1])
            rate += r_
            actx[8] = lctx[8] = nz
            btype, start = 0, 1
        else:
            btype, start = 3, 0
        for i in range(16):
            ia, il = BLOCK2ABOVE[i], BLOCK2LEFT[i]
            r_, nz = rdopt.cost_block(q[i], int(eobs[i]), start,
                                      int(actx[ia] + lctx[il]),
                                      self._tc[btype])
            rate += r_
            actx[ia] = lctx[il] = nz
        return rate

    def _cost_uv(self, q, eobs, actx, lctx):
        rate = 0
        for j in range(8):
            i = 16 + j
            ia, il = BLOCK2ABOVE[i], BLOCK2LEFT[i]
            r_, nz = rdopt.cost_block(q[j], int(eobs[j]), 0,
                                      int(actx[ia] + lctx[il]), self._tc[2])
            rate += r_
            actx[ia] = lctx[il] = nz
        return rate

    def _rdc(self, rate, dist):
        return ((128 + rate * self.rdmult) >> 8) + self.rddiv * dist

    def _above_bmode(self, pr, pc, b):
        if b < 4:
            m = int(self.mode[pr - 1, pc])
            if m == B_PRED:
                return int(self.bmode[pr - 1, pc, b + 12])
            return refdec.MODE_TO_BMODE.get(m, 0)
        return int(self.bmode[pr, pc, b - 4])

    def _above_bmv(self, pr, pc, b):
        if b < 4:
            if self.mode[pr - 1, pc] != SPLITMV:
                return tuple(self.mv[pr - 1, pc])
            return tuple(self.bmv[pr - 1, pc, b + 12])
        return tuple(self.bmv[pr, pc, b - 4])

    def _left_bmv(self, pr, pc, b):
        if b % 4 == 0:
            if self.mode[pr, pc - 1] != SPLITMV:
                return tuple(self.mv[pr, pc - 1])
            return tuple(self.bmv[pr, pc - 1, b + 3])
        return tuple(self.bmv[pr, pc, b - 1])

    def _left_bmode(self, pr, pc, b):
        if b % 4 == 0:
            m = int(self.mode[pr, pc - 1])
            if m == B_PRED:
                return int(self.bmode[pr, pc - 1, b + 3])
            return refdec.MODE_TO_BMODE.get(m, 0)
        return int(self.bmode[pr, pc, b - 1])

    def _pick_bpred(self, r, c, src_y, keyframe, actx, lctx, dq_y1, qidx,
                    commit=False):
        """rd_pick_intra4x4mby_modes (rdopt.c:670-760 role): greedy
        per-subblock bmode RD with in-loop reconstruction, trellis on the
        chosen coefficients. Returns (rate, dist, q [16,16], eobs [16],
        bmodes [16]); when commit, writes the reconstruction into rec."""
        b = BORDER
        y0, x0 = b + r * 16, b + c * 16
        # workspace window (row y0-1 .. y0+16, col x0-1 .. x0+20), with
        # the above-right down-copy (vp8_intra_prediction_down_copy)
        ws = self.rec.y[y0 - 1:y0 + 17, x0 - 1:x0 + 21].copy()
        ar = ws[0, 17:21].copy()
        ws[4, 17:21] = ar
        ws[8, 17:21] = ar
        ws[12, 17:21] = ar
        pr, pc = r + 1, c + 1
        dqv = np.array([dq_y1[0]] + [dq_y1[1]] * 15, np.int64)
        bmodes = np.zeros(16, np.int32)
        qout = np.zeros((16, 16), np.int32)
        eout = np.zeros(16, np.int32)
        rate_total, err_total = 0, 0
        local_bm = np.zeros(16, np.int32)
        for i in range(16):
            by = 1 + (i >> 2) * 4
            bx = 1 + (i & 3) * 4
            sb = src_y[(i >> 2) * 4:(i >> 2) * 4 + 4,
                       (i & 3) * 4:(i & 3) * 4 + 4]
            if keyframe:
                a = local_bm[i - 4] if i >= 4 else self._above_bmode(pr, pc, i)
                l = local_bm[i - 1] if i % 4 else self._left_bmode(pr, pc, i)
                bcost = rdopt.KF_BMODE_COST[int(a)][int(l)]
            else:
                bcost = rdopt.BMODE_COST
            ia, il = BLOCK2ABOVE[i], BLOCK2LEFT[i]
            ctx = int(actx[ia] + lctx[il])
            best = None
            for m in range(10):
                RefDecoder._intra4x4_predict(ws, by, bx, m)
                pred = ws[by:by + 4, bx:bx + 4].astype(np.int32)
                coefs = fdct4x4(sb - pred)
                ql, eob = regular_quant(
                    coefs, dq_y1, qidx,
                    act_adj=getattr(self, "_act_adj_now", 0))
                rate_, _nz = rdopt.cost_block(ql, eob, 0, ctx, self._tc[3])
                rate_ += bcost[m]
                err = int(((coefs.astype(np.int64) - ql * dqv) ** 2).sum())
                rd = self._rdc(rate_, err >> 2)
                if best is None or rd < best[0]:
                    best = (rd, m, coefs, ql, eob, rate_, err)
            _, m, coefs, ql, eob, rate_, err = best
            # trellis on the chosen block, then decoder-exact recon
            if self.sf.trellis:
                ql, eob = rdopt.trellis_block(coefs, ql, eob, dq_y1, 3,
                                              ctx, self._tc, self.rdmult,
                                              self.rddiv, True)
            RefDecoder._intra4x4_predict(ws, by, bx, m)
            if eob:
                if eob > 1:
                    refdec.idct4x4_add((ql * dqv.astype(np.int32))
                                       .astype(np.int16), ws, by, bx)
                else:
                    refdec.dc_only_idct_add(
                        _s16(int(ql[0]) * int(dqv[0]) & 0xFFFF), ws, by, bx)
            local_bm[i] = m
            bmodes[i] = m
            qout[i] = ql
            eout[i] = eob
            nz = int(eob != 0)
            actx[ia] = lctx[il] = nz
            rate_total += rate_
            err_total += err
        if commit:
            self.rec.y[y0:y0 + 16, x0:x0 + 16] = ws[1:17, 1:21][:, :16]
        return rate_total, err_total >> 2, qout, eout, bmodes

    def _encode_mb_rd(self, r, c, keyframe, refs):
        """Token-cost RD mode decision over intra 16x16 / B_PRED / inter
        NEW/NEAREST/NEAR/ZERO per reference frame (vp8_rd_pick_inter_mode
        rdopt.c:1714 / vp8_rd_pick_intra_mode rdopt.c:2374 roles)."""
        self._act_adj_now = int(self._act_adj_map[r, c]) \
            if self.tune_ssim else 0
        if self.tune_ssim:
            # vp8_activity_masking (encodeframe.c:340-357): per-MB RD
            # multiplier scaled by activity vs the frame average
            act = int(self._act_map[r, c])
            avg = self._act_avg
            a_ = act + 2 * avg
            b_ = 2 * act + avg
            self.rdmult = max(1, (self._rdmult_base * b_ + a_ // 2) // a_)
            self.errorperbit = max(1, self._epb_base * b_ // a_)
        b, b2 = BORDER, BORDER // 2
        y0, x0 = b + r * 16, b + c * 16
        cy0, cx0 = b2 + r * 8, b2 + c * 8
        pr, pc = r + 1, c + 1
        src_y = self.src.y[y0:y0 + 16, x0:x0 + 16].astype(np.int32)
        src_u = self.src.u[cy0:cy0 + 8, cx0:cx0 + 8].astype(np.int32)
        src_v = self.src.v[cy0:cy0 + 8, cx0:cx0 + 8].astype(np.int32)
        up_avail, left_avail = r != 0, c != 0
        if self.seg_dq is not None:
            seg = int(self.seg_map_enc[r, c])
            self.dq_y1, self.dq_y2, self.dq_uv = self.seg_dq[seg]
        dq_y1, dq_y2, dq_uv = self.dq_y1, self.dq_y2, self.dq_uv
        qidx = self.qindex
        if self.seg_dq is not None:
            qidx = min(127, max(0, self.qindex +
                                self.seg_q_deltas[int(
                                    self.seg_map_enc[r, c])]))
        actx0 = self._actx[c]
        lctx0 = self._lctx
        ymode_cost = rdopt.KF_YMODE_COST if keyframe else rdopt.YMODE_COST
        uv_cost = rdopt.KF_UV_MODE_COST if keyframe else rdopt.UV_MODE_COST

        # ---- intra 16x16 Y ----
        above = self.rec.y[y0 - 1, x0:x0 + 16].astype(np.int32)
        left = self.rec.y[y0:y0 + 16, x0 - 1].astype(np.int32)
        tl = int(self.rec.y[y0 - 1, x0 - 1])
        best_y16 = None
        for m in (DC_PRED, V_PRED, H_PRED, TM_PRED):
            pred = RefDecoder._pred_block_16x16(
                m, above, left, tl, up_avail, left_avail, 16).astype(np.int32)
            coeffs, q, eobs, err = self._quant_y16(src_y, pred, dq_y1,
                                                   dq_y2, qidx)
            a_, l_ = actx0.copy(), lctx0.copy()
            rate = ymode_cost[m] + self._cost_y(q, eobs, True, a_, l_)
            rd = self._rdc(rate, err >> 2)
            if best_y16 is None or rd < best_y16[0]:
                best_y16 = (rd, m, pred, coeffs, q, eobs, rate, err >> 2,
                            a_, l_)

        # ---- B_PRED ----
        y_is_bpred = False
        if self.sf.bpred:
            a_, l_ = actx0.copy(), lctx0.copy()
            bp_rate, bp_dist, bp_q, bp_eobs, bp_modes = self._pick_bpred(
                r, c, src_y, keyframe, a_, l_, dq_y1, qidx, commit=False)
            bp_rate += ymode_cost[B_PRED]
            bp_rd = self._rdc(bp_rate, bp_dist)
            y_is_bpred = bp_rd < best_y16[0]

        # ---- intra UV ----
        bu, bv = self.rec.u, self.rec.v
        best_uv = None
        for m in (DC_PRED, V_PRED, H_PRED, TM_PRED):
            pu = RefDecoder._pred_block_16x16(
                m, bu[cy0 - 1, cx0:cx0 + 8].astype(np.int32),
                bu[cy0:cy0 + 8, cx0 - 1].astype(np.int32),
                int(bu[cy0 - 1, cx0 - 1]), up_avail, left_avail, 8) \
                .astype(np.int32)
            pv = RefDecoder._pred_block_16x16(
                m, bv[cy0 - 1, cx0:cx0 + 8].astype(np.int32),
                bv[cy0:cy0 + 8, cx0 - 1].astype(np.int32),
                int(bv[cy0 - 1, cx0 - 1]), up_avail, left_avail, 8) \
                .astype(np.int32)
            coeffs, q, eobs, err = self._quant_uv(src_u, pu, src_v, pv,
                                                  dq_uv, qidx)
            a2, l2 = actx0.copy(), lctx0.copy()
            rate = uv_cost[m] + self._cost_uv(q, eobs, a2, l2)
            rd = self._rdc(rate, err >> 2)
            if best_uv is None or rd < best_uv[0]:
                best_uv = (rd, m, pu, pv, coeffs, q, eobs, rate, err >> 2)

        if y_is_bpred:
            intra_rate = bp_rate + best_uv[7]
            intra_dist = bp_dist + best_uv[8]
        else:
            intra_rate = best_y16[6] + best_uv[7]
            intra_dist = best_y16[7] + best_uv[8]
        if not keyframe:
            intra_rate += rdopt.cost0(self.prob_intra)
        intra_rd = self._rdc(intra_rate, intra_dist)

        # ---- inter ----
        best_inter = None
        if not keyframe and refs:
            near, nearest, best_mv, probs, cnt = self._find_near(r, c)
            for ref_fb, ref_id in refs:
                _m, smv, _sc, _sp = self._inter_search(r, c, ref_fb, src_y)
                # cheap-to-code modes first; duplicates (incl. a NEWMV that
                # landed on a predictor) keep the cheaper signaling
                cands = [(ZEROMV, (0, 0)), (NEARESTMV, tuple(nearest)),
                         (NEARMV, tuple(near)), (NEWMV, tuple(smv))]
                seen = set()
                for mode_, mv_ in cands:
                    if mv_ in seen:
                        continue
                    seen.add(mv_)
                    pred_y = self._mc_block(ref_fb.y, y0, x0,
                                            mv_[0], mv_[1], 16)
                    cmv = _uv_mv(mv_)
                    pred_u = self._mc_block(ref_fb.u, cy0, cx0,
                                            cmv[0], cmv[1], 8)
                    pred_v = self._mc_block(ref_fb.v, cy0, cx0,
                                            cmv[0], cmv[1], 8)
                    coeffs, q, eobs, erry = self._quant_y16(
                        src_y, pred_y, dq_y1, dq_y2, qidx)
                    cuv, quv, euv, erruv = self._quant_uv(
                        src_u, pred_u, src_v, pred_v, dq_uv, qidx)
                    a2, l2 = actx0.copy(), lctx0.copy()
                    rate = rdopt.cost1(self.prob_intra)
                    if ref_id == LAST_FRAME:
                        rate += rdopt.cost0(self.prob_last)
                    elif ref_id == GOLDEN_FRAME:
                        rate += rdopt.cost1(self.prob_last) + \
                            rdopt.cost0(self.prob_gf)
                    else:
                        rate += rdopt.cost1(self.prob_last) + \
                            rdopt.cost1(self.prob_gf)
                    rate += rdopt.mv_ref_cost(mode_, probs)
                    if mode_ == NEWMV:
                        rate += rdopt.mv_cost(mv_[0] - best_mv[0],
                                              mv_[1] - best_mv[1])
                    rate += self._cost_y(q, eobs, True, a2, l2)
                    rate += self._cost_uv(quv, euv, a2, l2)
                    dist = (erry >> 2) + (erruv >> 2)
                    rd = self._rdc(rate, dist)
                    if best_inter is None or rd < best_inter[0]:
                        best_inter = (rd, mode_, mv_, ref_fb, ref_id,
                                      pred_y, pred_u, pred_v,
                                      coeffs, q, eobs, cuv, quv, euv)
                if ref_id != LAST_FRAME or not self.sf.splitmv:
                    continue
                # SPLITMV candidates on LAST: 8x8 / 16x8 / 8x16 searched
                # always; 4x4 only when a coarser split is currently the
                # best inter mode (the ordering heuristic of
                # vp8_rd_pick_best_mbsegmentation, rdopt.c:1318)
                for s_ in (2, 0, 1, 3):
                    if s_ == 3 and (best_inter is None or
                                    best_inter[1] != SPLITMV):
                        continue
                    bmv16 = self._split_search(r, c, ref_fb, src_y, smv,
                                               best_mv, s_)
                    if len({tuple(v) for v in bmv16}) <= 1:
                        continue
                    pred_y, pred_u, pred_v = self._split_pred(
                        r, c, ref_fb, bmv16)
                    coeffs, q, eobs, erry = self._quant_y_nodc(
                        src_y, pred_y, dq_y1, qidx)
                    cuv, quv, euv, erruv = self._quant_uv(
                        src_u, pred_u, src_v, pred_v, dq_uv, qidx)
                    a2, l2 = actx0.copy(), lctx0.copy()
                    rate = rdopt.cost1(self.prob_intra) + \
                        rdopt.cost0(self.prob_last)
                    rate += self._split_rate_mv(r, c, bmv16, best_mv,
                                                probs, s_)
                    rate += self._cost_y(q, eobs, False, a2, l2)
                    rate += self._cost_uv(quv, euv, a2, l2)
                    dist = (erry >> 2) + (erruv >> 2)
                    rd = self._rdc(rate, dist)
                    if best_inter is None or rd < best_inter[0]:
                        best_inter = (rd, SPLITMV, (bmv16, s_), ref_fb,
                                      ref_id, pred_y, pred_u, pred_v,
                                      coeffs, q, eobs, cuv, quv, euv)

        # ---- choose + final encode (with trellis) ----
        if best_inter is not None and best_inter[0] < intra_rd:
            (_, mode_, mv_, ref_fb, ref_id, pred_y, pred_u, pred_v,
             coeffs, q, eobs, cuv, quv, euv) = best_inter
            self.mode[pr, pc] = mode_
            self.reff[pr, pc] = ref_id
            self.uvmode[r, c] = DC_PRED
            self.bmode[pr, pc] = 0
            if mode_ == SPLITMV:
                bmv16, s_ = mv_
                self.bmv[pr, pc] = bmv16
                self.split_part[r, c] = s_
                self.mv[pr, pc] = bmv16[15]
                self._store_mb_nodc(r, c, coeffs, q, eobs, cuv, quv, euv,
                                    dq_y1, dq_uv)
                self._recon_mb(r, c, pred_y, pred_u, pred_v, has_y2=False)
            else:
                self.mv[pr, pc] = mv_
                self._store_mb(r, c, coeffs, q, eobs, cuv, quv, euv,
                               dq_y1, dq_y2, dq_uv, intra=False)
                self._recon_mb(r, c, pred_y, pred_u, pred_v)
        else:
            _, uvm, pu, pv, cuv, quv, euv, _, _ = best_uv
            self.uvmode[r, c] = uvm
            self.reff[pr, pc] = INTRA_FRAME
            self.mv[pr, pc] = 0
            if y_is_bpred:
                self.mode[pr, pc] = B_PRED
                a_, l_ = actx0, lctx0  # committed in place by the re-run
                _, _, bq, beo, bm = self._pick_bpred(
                    r, c, src_y, keyframe, a_, l_, dq_y1, qidx, commit=True)
                self.bmode[pr, pc] = bm
                self.qcoeff[r, c, :16] = bq
                self.qcoeff[r, c, 16:] = 0
                self.eobs[r, c, :16] = beo
                self.eobs[r, c, 16:] = 0
                # chroma: trellis + store + recon (luma already in rec)
                quv2, euv2 = self._trellis_uv(cuv, quv, euv, dq_uv, True,
                                              actx0, lctx0)
                self.qcoeff[r, c, 16:24] = quv2
                self.eobs[r, c, 16:24] = euv2
                self._recon_uv(r, c, pu, pv)
                self.rec.extend_mb_row(r)
                return
            _, m, pred, coeffs, q, eobs, _, _, _, _ = best_y16
            self.mode[pr, pc] = m
            self.bmode[pr, pc] = 0
            self._store_mb(r, c, coeffs, q, eobs, cuv, quv, euv,
                           dq_y1, dq_y2, dq_uv, intra=True)
            self._recon_mb(r, c, pred, pu, pv)

    def _quant_y_nodc(self, src_y, pred_y, dq_y1, qidx):
        """FDCT + regular quant of 16 Y blocks WITHOUT a second-order pass
        (SPLITMV / B_PRED token layout: btype 3, DC in-band)."""
        resid = src_y - pred_y
        coeffs = np.zeros((16, 16), np.int32)
        q = np.zeros((16, 16), np.int32)
        eobs = np.zeros(16, np.int32)
        dqv = np.array([dq_y1[0]] + [dq_y1[1]] * 15, np.int64)
        err = 0
        for i in range(16):
            by, bx = (i >> 2) * 4, (i & 3) * 4
            coeffs[i] = fdct4x4(resid[by:by + 4, bx:bx + 4])
            q[i], eobs[i] = regular_quant(
                coeffs[i], dq_y1, qidx,
                act_adj=getattr(self, "_act_adj_now", 0))
            err += int(((coeffs[i].astype(np.int64) - q[i] * dqv) ** 2)
                       .sum())
        return coeffs, q, eobs, err

    def _split_pred(self, r, c, ref_fb, bmv16):
        """Decoder-exact SPLITMV prediction: per-4x4 luma tiles + derived
        per-quad chroma MVs (reconinter.c:449-525, toward-zero averaging
        reconinter.c:418-424)."""
        b, b2 = BORDER, BORDER // 2
        y0, x0 = b + r * 16, b + c * 16
        cy0, cx0 = b2 + r * 8, b2 + c * 8
        pred_y = np.zeros((16, 16), np.int32)
        for i in range(16):
            by, bx = (i >> 2) * 4, (i & 3) * 4
            mv = bmv16[i]
            pred_y[by:by + 4, bx:bx + 4] = self._mc_block(
                ref_fb.y, y0 + by, x0 + bx, int(mv[0]), int(mv[1]), 4)
        pred_u = np.zeros((8, 8), np.int32)
        pred_v = np.zeros((8, 8), np.int32)
        for i in range(2):
            for jq in range(2):
                yoffs = i * 8 + jq * 2
                tr = sum(int(bmv16[yoffs + k][0]) for k in (0, 1, 4, 5))
                tc = sum(int(bmv16[yoffs + k][1]) for k in (0, 1, 4, 5))
                tr = tr + 4 + (-8 if tr < 0 else 0)
                tc = tc + 4 + (-8 if tc < 0 else 0)
                mr = _s16((tr // 8 if tr >= 0 else -((-tr) // 8)) & 0xFFFF)
                mc2 = _s16((tc // 8 if tc >= 0 else -((-tc) // 8)) & 0xFFFF)
                qy, qx = i * 4, jq * 4
                pred_u[qy:qy + 4, qx:qx + 4] = self._mc_block(
                    ref_fb.u, cy0 + qy, cx0 + qx, mr, mc2, 4)
                pred_v[qy:qy + 4, qx:qx + 4] = self._mc_block(
                    ref_fb.v, cy0 + qy, cx0 + qx, mr, mc2, 4)
        return pred_y, pred_u, pred_v

    #: partition pixel geometry per mbsplit mode s: (height, width)
    _SPLIT_GEOM = {0: (8, 16), 1: (16, 8), 2: (8, 8), 3: (4, 4)}

    def _split_search(self, r, c, ref_fb, src_y, seed_mv, best_mv, s=2):
        """Sub-block motion search for mbsplit partitioning `s` (the SPLITMV
        encode role of vp8_rd_pick_best_mbsegmentation, rdopt.c:1318;
        s: 0=16x8, 1=8x16, 2=8x8, 3=4x4).  Full-pel full search around the
        seed + iterative half/quarter-pel refine per partition."""
        R, C = self.R, self.C
        b = BORDER
        y0, x0 = b + r * 16, b + c * 16
        rng = 4 if s == 3 else 8
        lo_r = max(-(r * 16) - 16, (seed_mv[0] >> 3) - rng)
        hi_r = min((R - 1 - r) * 16 + 16, (seed_mv[0] >> 3) + rng)
        lo_c = max(-(c * 16) - 16, (seed_mv[1] >> 3) - rng)
        hi_c = min((C - 1 - c) * 16 + 16, (seed_mv[1] >> 3) + rng)
        bmv16 = np.zeros((16, 2), np.int32)
        epb = self.errorperbit
        ph, pw = self._SPLIT_GEOM[s]
        offsets = refdec.MBSPLIT_OFFSET[s]
        fills = refdec.MBSPLIT_FILL_OFFSET[s]
        fc_n = refdec.MBSPLIT_FILL_COUNT[s]
        refy = ref_fb.y
        from numpy.lib.stride_tricks import sliding_window_view
        # per-candidate MV rate over the search grid, shared by partitions
        nR, nC = hi_r - lo_r + 1, hi_c - lo_c + 1
        mvrate = np.empty((nR, nC), np.int64)
        for i_, dy in enumerate(range(lo_r, hi_r + 1)):
            for j_, dx in enumerate(range(lo_c, hi_c + 1)):
                mvrate[i_, j_] = (rdopt.mv_cost(dy * 8 - best_mv[0],
                                                dx * 8 - best_mv[1])
                                  * epb + 128) >> 8
        for j, k in enumerate(offsets):
            br, bc_ = (k >> 2) * 4, (k & 3) * 4
            sb = src_y[br:br + ph, bc_:bc_ + pw]
            win = refy[y0 + br + lo_r:y0 + br + hi_r + ph,
                       x0 + bc_ + lo_c:x0 + bc_ + hi_c + pw]
            sads = np.abs(
                sliding_window_view(win, (ph, pw)).astype(np.int32) -
                sb[None, None]).sum((2, 3))
            costs = sads + mvrate
            am = int(np.argmin(costs))
            bdy, bdx = lo_r + am // nC, lo_c + am % nC
            bestc = int(costs[am // nC, am % nC])
            bmv = (bdy * 8, bdx * 8)
            for sub in (4, 2):
                improved = True
                while improved:
                    improved = False
                    for ddy, ddx in ((-sub, 0), (sub, 0), (0, -sub),
                                     (0, sub)):
                        cand = (bmv[0] + ddy, bmv[1] + ddx)
                        if not (lo_r * 8 <= cand[0] <= hi_r * 8 and
                                lo_c * 8 <= cand[1] <= hi_c * 8):
                            continue
                        pred = self._mc_block_wh(refy, y0 + br, x0 + bc_,
                                                 cand[0], cand[1], ph, pw)
                        cost = int(np.abs(sb - pred).sum()) + \
                            ((rdopt.mv_cost(cand[0] - best_mv[0],
                                            cand[1] - best_mv[1])
                              * epb + 128) >> 8)
                        if cost < bestc:
                            bestc, bmv = cost, cand
                            improved = True
            for fo in fills[j * fc_n:(j + 1) * fc_n]:
                bmv16[fo] = bmv
        return bmv16

    def _split_tree_cost(self, s):
        """mbsplit-tree signaling cost (write_split, bitstream.c:155-160;
        tree decode order: 110 -> {0: s=3}; 111 -> {0: s=2}; 150 -> s=0/1."""
        if s == 3:
            return rdopt.cost0(110)
        if s == 2:
            return rdopt.cost1(110) + rdopt.cost0(111)
        base = rdopt.cost1(110) + rdopt.cost1(111)
        return base + (rdopt.cost0(150) if s == 0 else rdopt.cost1(150))

    def _split_rate_mv(self, r, c, bmv16, best_mv, probs, s=2):
        """Signaling rate of a SPLITMV candidate at partitioning `s`,
        filling self.bmv[pr,pc] progressively for the sub_mv_ref context."""
        pr, pc = r + 1, c + 1
        rate = rdopt.mv_ref_cost(SPLITMV, probs)
        rate += self._split_tree_cost(s)
        fills = refdec.MBSPLIT_FILL_OFFSET[s]
        fc_n = refdec.MBSPLIT_FILL_COUNT[s]
        for j, k in enumerate(refdec.MBSPLIT_OFFSET[s]):
            blockmv = tuple(bmv16[k])
            leftmv = self._left_bmv(pr, pc, k)
            abovemv = self._above_bmv(pr, pc, k)
            lez = leftmv == (0, 0)
            aez = abovemv == (0, 0)
            lea = leftmv == abovemv
            prob = refdec.SUB_MV_REF_PROB3[(aez << 2) | (lez << 1) | lea]
            if blockmv == leftmv:
                rate += rdopt.cost0(prob[0])
            elif blockmv == abovemv:
                rate += rdopt.cost1(prob[0]) + rdopt.cost0(prob[1])
            elif blockmv == (0, 0):
                rate += rdopt.cost1(prob[0]) + rdopt.cost1(prob[1]) + \
                    rdopt.cost0(prob[2])
            else:
                rate += rdopt.cost1(prob[0]) + rdopt.cost1(prob[1]) + \
                    rdopt.cost1(prob[2]) + \
                    rdopt.mv_cost(blockmv[0] - best_mv[0],
                                  blockmv[1] - best_mv[1], 128)
            for fo in fills[j * fc_n:(j + 1) * fc_n]:
                self.bmv[pr, pc, fo] = blockmv
        return rate

    def _trellis_uv(self, cuv, quv, euv, dq_uv, intra, actx, lctx):
        if not self.sf.trellis:
            for j in range(8):
                i = 16 + j
                ia, il = BLOCK2ABOVE[i], BLOCK2LEFT[i]
                actx[ia] = lctx[il] = int(euv[j] != 0)
            return quv.copy(), euv.copy()
        qo = np.zeros_like(quv)
        eo = np.zeros_like(euv)
        for j in range(8):
            i = 16 + j
            ia, il = BLOCK2ABOVE[i], BLOCK2LEFT[i]
            ctx = int(actx[ia] + lctx[il])
            qo[j], eo[j] = rdopt.trellis_block(
                cuv[j], quv[j], int(euv[j]), dq_uv, 2, ctx, self._tc,
                self.rdmult, self.rddiv, intra)
            actx[ia] = lctx[il] = int(eo[j] != 0)
        return qo, eo

    def _store_mb(self, r, c, coeffs, q, eobs, cuv, quv, euv,
                  dq_y1, dq_y2, dq_uv, intra):
        """Trellis-optimize the chosen coefficients and store them,
        committing the entropy-context mirror (vp8_optimize_mb role)."""
        actx, lctx = self._actx[c], self._lctx
        # Y2 then Y (independent context chains)
        ctx = int(actx[8] + lctx[8])
        if self.sf.trellis:
            q2, e2 = rdopt.trellis_block(coeffs[16], q[16], int(eobs[16]),
                                         dq_y2, 1, ctx, self._tc,
                                         self.rdmult, self.rddiv, intra)
        else:
            q2, e2 = q[16], int(eobs[16])
        self.qcoeff[r, c, 24] = q2
        self.eobs[r, c, 24] = e2
        actx[8] = lctx[8] = int(e2 != 0)
        for i in range(16):
            ia, il = BLOCK2ABOVE[i], BLOCK2LEFT[i]
            ctx = int(actx[ia] + lctx[il])
            if self.sf.trellis:
                qi, ei = rdopt.trellis_block(coeffs[i], q[i], int(eobs[i]),
                                             dq_y1, 0, ctx, self._tc,
                                             self.rdmult, self.rddiv, intra)
            else:
                qi, ei = q[i], int(eobs[i])
            self.qcoeff[r, c, i] = qi
            self.eobs[r, c, i] = max(ei, 1)
            actx[ia] = lctx[il] = int(ei != 1)
        quv2, euv2 = self._trellis_uv(cuv, quv, euv, dq_uv, intra,
                                      actx, lctx)
        self.qcoeff[r, c, 16:24] = quv2
        self.eobs[r, c, 16:24] = euv2

    def _store_mb_nodc(self, r, c, coeffs, q, eobs, cuv, quv, euv,
                       dq_y1, dq_uv):
        """Trellis + store for SPLITMV MBs (btype 3, no second order)."""
        actx, lctx = self._actx[c], self._lctx
        self.qcoeff[r, c, 24] = 0
        self.eobs[r, c, 24] = 0
        for i in range(16):
            ia, il = BLOCK2ABOVE[i], BLOCK2LEFT[i]
            ctx = int(actx[ia] + lctx[il])
            if self.sf.trellis:
                qi, ei = rdopt.trellis_block(coeffs[i], q[i], int(eobs[i]),
                                             dq_y1, 3, ctx, self._tc,
                                             self.rdmult, self.rddiv, False)
            else:
                qi, ei = q[i], int(eobs[i])
            self.qcoeff[r, c, i] = qi
            self.eobs[r, c, i] = ei
            actx[ia] = lctx[il] = int(ei != 0)
        quv2, euv2 = self._trellis_uv(cuv, quv, euv, dq_uv, False,
                                      actx, lctx)
        self.qcoeff[r, c, 16:24] = quv2
        self.eobs[r, c, 16:24] = euv2

    def _recon_uv(self, r, c, pred_u, pred_v):
        """Chroma half of _recon_mb (for B_PRED MBs whose luma recon
        happens inside _pick_bpred)."""
        b2 = BORDER // 2
        cy0, cx0 = b2 + r * 8, b2 + c * 8
        self.rec.u[cy0:cy0 + 8, cx0:cx0 + 8] = np.clip(pred_u, 0, 255)
        self.rec.v[cy0:cy0 + 8, cx0:cx0 + 8] = np.clip(pred_v, 0, 255)
        q = self.qcoeff[r, c]
        eobs = self.eobs[r, c]
        dquv = np.array([self.dq_uv[0]] + [self.dq_uv[1]] * 15, np.int32)
        for i in range(16, 24):
            pl = self.rec.u if i < 20 else self.rec.v
            j = i - 16 if i < 20 else i - 20
            by = cy0 + (j >> 1) * 4
            bx = cx0 + (j & 1) * 4
            if eobs[i] > 1:
                refdec.idct4x4_add((q[i] * dquv).astype(np.int16),
                                   pl, by, bx)
            elif eobs[i]:
                refdec.dc_only_idct_add(
                    _s16(int(q[i, 0]) * int(dquv[0]) & 0xFFFF), pl, by, bx)

    def _recon_mb(self, r, c, pred_y, pred_u, pred_v, has_y2=True):
        b, b2 = BORDER, BORDER // 2
        y0, x0 = b + r * 16, b + c * 16
        cy0, cx0 = b2 + r * 8, b2 + c * 8
        self.rec.y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred_y, 0, 255)
        self.rec.u[cy0:cy0 + 8, cx0:cx0 + 8] = np.clip(pred_u, 0, 255)
        self.rec.v[cy0:cy0 + 8, cx0:cx0 + 8] = np.clip(pred_v, 0, 255)
        q = self.qcoeff[r, c].copy()
        eobs = self.eobs[r, c]
        if has_y2:
            dqy2v = np.array([self.dq_y2[0]] + [self.dq_y2[1]] * 15,
                             np.int32)
            if eobs[24] > 1:
                dcs = refdec.inv_walsh((q[24] * dqy2v).astype(np.int16))
            else:
                dc0 = _s16(int(q[24, 0]) * self.dq_y2[0] & 0xFFFF)
                dcs = [_s16(((dc0 + 3) >> 3) & 0xFFFF)] * 16
            dqv = np.array([1] + [self.dq_y1[1]] * 15, np.int32)
        else:
            dqv = np.array([self.dq_y1[0]] + [self.dq_y1[1]] * 15, np.int32)
        for i in range(16):
            by, bx = y0 + (i >> 2) * 4, x0 + (i & 3) * 4
            qb = q[i].copy()
            if has_y2:
                qb[0] = dcs[i]
            if eobs[i] > 1:
                refdec.idct4x4_add((qb * dqv).astype(np.int16),
                                   self.rec.y, by, bx)
            elif eobs[i] or has_y2:
                refdec.dc_only_idct_add(
                    _s16(int(qb[0]) * int(dqv[0]) & 0xFFFF),
                    self.rec.y, by, bx)
        dquv = np.array([self.dq_uv[0]] + [self.dq_uv[1]] * 15, np.int32)
        for i in range(16, 24):
            pl = self.rec.u if i < 20 else self.rec.v
            j = i - 16 if i < 20 else i - 20
            by = cy0 + (j >> 1) * 4
            bx = cx0 + (j & 1) * 4
            if eobs[i] > 1:
                refdec.idct4x4_add((q[i] * dquv).astype(np.int16),
                                   pl, by, bx)
            else:
                refdec.dc_only_idct_add(
                    _s16(int(q[i, 0]) * int(dquv[0]) & 0xFFFF), pl, by, bx)
        self.rec.extend_mb_row(r)

    # ------------------------------------------------------------------
    def _mc_block(self, plane, py, px, mvr, mvc, n):
        sy = py + (mvr >> 3)
        sx = px + (mvc >> 3)
        if (mvr & 7) or (mvc & 7):
            return refdec._sixtap_2d(plane, sy, sx, n, n, 0,
                                     mvc & 7, mvr & 7).astype(np.int32)
        return plane[sy:sy + n, sx:sx + n].astype(np.int32)

    def _mc_block_wh(self, plane, py, px, mvr, mvc, h, w):
        sy = py + (mvr >> 3)
        sx = px + (mvc >> 3)
        if (mvr & 7) or (mvc & 7):
            return refdec._sixtap_2d(plane, sy, sx, w, h, 0,
                                     mvc & 7, mvr & 7).astype(np.int32)
        return plane[sy:sy + h, sx:sx + w].astype(np.int32)

    def _inter_search(self, r, c, ref, src_y):
        """Full-pel diamond-ish search + half/quarter refine over LAST."""
        R, C = self.R, self.C
        b = BORDER
        y0, x0 = b + r * 16, b + c * 16
        near, nearest, best_mv, probs, cnt = self._find_near(r, c)
        # search center: best_mv full-pel (or the multi-res hint when it
        # scores better — get_lower_res_motion_info role, pickinter.c:397)
        cyc, cxc = best_mv[0] >> 3, best_mv[1] >> 3
        hints = getattr(self, "mv_hints", None)
        if hints is not None:
            hy, hx = int(hints[r, c, 0]) >> 3, int(hints[r, c, 1]) >> 3
            b = BORDER
            y0_, x0_ = b + r * 16, b + c * 16
            lo_r_ = -(r * 16) - 16
            hi_r_ = (self.R - 1 - r) * 16 + 16
            lo_c_ = -(c * 16) - 16
            hi_c_ = (self.C - 1 - c) * 16 + 16
            hy = min(max(hy, lo_r_), hi_r_)
            hx = min(max(hx, lo_c_), hi_c_)
            cyc0 = min(max(cyc, lo_r_), hi_r_)
            cxc0 = min(max(cxc, lo_c_), hi_c_)
            blk_h = ref.y[y0_ + hy:y0_ + hy + 16, x0_ + hx:x0_ + hx + 16]
            blk_c = ref.y[y0_ + cyc0:y0_ + cyc0 + 16,
                          x0_ + cxc0:x0_ + cxc0 + 16]
            import numpy as _np
            if _np.abs(src_y - blk_h.astype(_np.int32)).sum() < \
                    _np.abs(src_y - blk_c.astype(_np.int32)).sum():
                cyc, cxc = hy, hx
        # clamp center so candidates stay within the UMV border
        rng = 16
        lo_r = max(-(r * 16) - 16, cyc - rng)
        hi_r = min((R - 1 - r) * 16 + 16, cyc + rng)
        lo_c = max(-(c * 16) - 16, cxc - rng)
        hi_c = min((C - 1 - c) * 16 + 16, cxc + rng)
        refy = ref.y
        # exhaustive step-1 full-pel search, vectorized over the window
        # (vp8_full_search_sad role, mcomp.c:1295 — a step-2 grid misses
        # the delta-function SAD minima of textured content entirely).
        # The selection includes the MV signaling rate (mvsad_err_cost,
        # mcomp.c:1295+): without it the argmin over ~1k candidates
        # overfits noise with junk far-away MVs.
        from numpy.lib.stride_tricks import sliding_window_view
        win = refy[y0 + lo_r:y0 + hi_r + 16, x0 + lo_c:x0 + hi_c + 16]
        sw = sliding_window_view(win, (16, 16))
        mestep = 1 if self.sf.exhaustive_me else 2
        sw = sw[::mestep, ::mestep]
        sads = np.abs(sw.astype(np.int32) -
                      src_y[None, None]).sum((2, 3))
        epb = self.errorperbit
        dys = np.arange(lo_r, hi_r + 1, mestep) * 8 - best_mv[0]
        dxs = np.arange(lo_c, hi_c + 1, mestep) * 8 - best_mv[1]
        rowc = rdopt.MV_COST[0][np.minimum(np.abs(dys) >> 1, 1023)]
        colc = rdopt.MV_COST[1][np.minimum(np.abs(dxs) >> 1, 1023)]
        mvrate = ((rowc[:, None] + colc[None, :]) * 96) >> 7
        costs = sads + ((mvrate * epb + 128) >> 8)
        am = int(np.argmin(costs))
        nC = costs.shape[1]
        bdy = lo_r + mestep * (am // nC)
        bdx = lo_c + mestep * (am % nC)
        cost_fp = int(costs[am // nC, am % nC])
        # subpel refine (quarter-pel: mv components even in 1/8 units)
        bmv = (bdy * 8, bdx * 8)
        bcost = cost_fp
        for sub in (4, 2):
            improved = True
            while improved:
                improved = False
                for ddy, ddx in ((-sub, 0), (sub, 0), (0, -sub), (0, sub)):
                    cand = (bmv[0] + ddy, bmv[1] + ddx)
                    if not (lo_r * 8 <= cand[0] <= hi_r * 8 and
                            lo_c * 8 <= cand[1] <= hi_c * 8):
                        continue
                    pred = self._mc_block(refy, y0, x0, cand[0], cand[1], 16)
                    cost = int(np.abs(src_y - pred).sum()) + \
                        ((rdopt.mv_cost(cand[0] - best_mv[0],
                                        cand[1] - best_mv[1])
                          * epb + 128) >> 8)
                    if cost < bcost:
                        bcost, bmv = cost, cand
                        improved = True
        # choose coding mode for this mv
        if bmv == (0, 0):
            mode = ZEROMV
        elif bmv == nearest:
            mode = NEARESTMV
        elif bmv == near:
            mode = NEARMV
        else:
            mode = NEWMV
        pred = self._mc_block(refy, y0, x0, bmv[0], bmv[1], 16)
        return mode, bmv, bcost, pred

    def _find_near(self, r, c):
        """vp8_find_near_mvs + mv_ref_probs for the encoder-side grids
        (same lattice as refdec._read_mb_modes_mv)."""
        pr, pc = r + 1, c + 1
        R, C = self.R, self.C
        near_mvs = [(0, 0), (0, 0), (0, 0), (0, 0)]
        cnt = [0, 0, 0, 0]
        cntx = 0
        nmv = 0
        neigh = [((pr - 1, pc), 2), ((pr, pc - 1), 2), ((pr - 1, pc - 1), 1)]
        for idx, ((nr, nc), w) in enumerate(neigh):
            nref = int(self.reff[nr, nc])
            nmvv = (int(self.mv[nr, nc, 0]), int(self.mv[nr, nc, 1]))
            if nref != INTRA_FRAME:
                if nmvv != (0, 0):
                    if idx == 0:
                        nmv += 1
                        near_mvs[nmv] = nmvv
                        cntx += 1
                    else:
                        if nmvv != near_mvs[nmv]:
                            nmv += 1
                            near_mvs[nmv] = nmvv
                            cntx += 1
                    cnt[cntx] += w
                else:
                    cnt[0] += w
            # intra neighbor adds nothing except... (above doesn't add to
            # CNT_INTRA in the reference; left/al do only when mv==0)
        # NOTE: the reference adds cnt[0] only for left/al zero-MV inter
        # neighbors; above zero-MV inter adds cnt[cntx]+=2 with cntx=0 too.
        if cnt[3] and near_mvs[nmv] == near_mvs[1]:
            cnt[1] += 1
        cnt[3] = ((int(self.mode[pr - 1, pc]) == SPLITMV) +
                  (int(self.mode[pr, pc - 1]) == SPLITMV)) * 2 + \
                 (int(self.mode[pr - 1, pc - 1]) == SPLITMV)
        if cnt[2] > cnt[1]:
            cnt[1], cnt[2] = cnt[2], cnt[1]
            near_mvs[1], near_mvs[2] = near_mvs[2], near_mvs[1]
        if cnt[1] >= cnt[0]:
            near_mvs[0] = near_mvs[1]
        MARGIN = 16 << 3
        lo_c_, hi_c_ = -(c * 16 << 3) - MARGIN, ((C - 1 - c) * 16 << 3) + MARGIN
        lo_r_, hi_r_ = -(r * 16 << 3) - MARGIN, ((R - 1 - r) * 16 << 3) + MARGIN

        def clamp2(mv):
            return (min(max(mv[0], lo_r_), hi_r_),
                    min(max(mv[1], lo_c_), hi_c_))

        probs = [int(T.MODE_CONTEXTS[cnt[i], i]) for i in range(4)]
        return (clamp2(near_mvs[2]), clamp2(near_mvs[1]),
                clamp2(near_mvs[0]), probs, cnt)

    # ------------------------------------------------------------------
    # bitstream packing

    # -- per-frame mode/MV probability updates ------------------------------
    # (update_mbintra_mode_probs bitstream.c:108-133, vp8_write_mvprobs
    # encodemv.c:374-417; refresh_entropy_probs=0 keeps every frame's
    # updates relative to the defaults, like the coef-prob updates above)

    def _update_mode_probs(self, e, tree, cur_probs, counts):
        """update_mode (bitstream.c:63-106): send fresh tree probabilities
        when the branch-cost saving beats 256 bits per probability."""
        bct = _tree_branch_counts(tree, counts)
        n = len(cur_probs)
        c0, c1 = self._bitcost
        pnew = np.zeros(n, np.int32)
        new_b = old_b = 0
        for i in range(n):
            t0, t1 = int(bct[i, 0]), int(bct[i, 1])
            tot = t0 + t1
            if tot:
                p = (t0 * 256 + (tot >> 1)) // tot
                pnew[i] = 255 if p >= 256 else (p if p else 1)
            else:
                pnew[i] = 128
            cur = int(cur_probs[i])
            new_b += (t0 * c0[pnew[i]] + t1 * c1[pnew[i]]) >> 8
            old_b += (t0 * c0[cur] + t1 * c1[cur]) >> 8
        if new_b + (n << 8) < old_b:
            e.write_bit(1)
            for i in range(n):
                cur_probs[i] = int(pnew[i]) if pnew[i] else 1
                e.write_literal(int(cur_probs[i]), 8)
        else:
            e.write_bit(0)

    def _count_mv_component(self, comp, v):
        """MVcount accumulation (the per-component event histogram feeding
        write_component_probs, encodemv.c:227-335); v = component >> 1."""
        st = self._mvstats[comp]
        x = abs(v)
        if v > 0:
            st["sign"][0] += 1
        elif v < 0:
            st["sign"][1] += 1
        if x < 8:
            st["short_flag"][0] += 1
            st["short"][x] += 1
        else:
            st["short_flag"][1] += 1
            for k in range(10):
                st["bits"][k][(x >> k) & 1] += 1

    def _write_mv_probs(self, e):
        """vp8_write_mvprobs dual: per-probability update when the saving
        beats the ~7-9 bit signaling cost (update(), encodemv.c:200-222)."""
        c0, c1 = self._bitcost

        def calc_prob(ct):
            tot = ct[0] + ct[1]
            if not tot:
                return None
            x = ((int(ct[0]) * 255) // tot) & ~1
            return x if x else 1

        for comp in range(2):
            st = self._mvstats[comp]
            cur = self.mvc[comp]
            # counts in prob order: is_short, sign, short tree (7), bits (10)
            short_bct = _tree_branch_counts(T.SMALL_MV_TREE, st["short"])
            cts = [tuple(st["short_flag"]), tuple(st["sign"])]
            cts += [tuple(short_bct[j]) for j in range(7)]
            cts += [tuple(st["bits"][k]) for k in range(10)]
            for i, ct in enumerate(cts):
                upd_p = int(T.MV_UPDATE_PROBS[comp, i])
                default = int(T.DEFAULT_MV_CONTEXT[comp, i])
                newp = calc_prob(ct)
                if newp is None:
                    newp = default
                curp = int(cur[i])
                t0, t1 = int(ct[0]), int(ct[1])
                cur_b = (t0 * c0[curp] + t1 * c1[curp]) >> 8
                new_b = (t0 * c0[newp] + t1 * c1[newp]) >> 8
                cost = 7 - 1 + ((c1[upd_p] - c0[upd_p] + 128) >> 8)
                if cur_b - new_b > cost:
                    cur[i] = newp
                    e.write(1, upd_p)
                    e.write_literal(newp >> 1, 7)
                else:
                    e.write(0, upd_p)

    def _pack(self, keyframe):
        R, C = self.R, self.C
        # per-frame entropy contexts start from the defaults
        # (refresh_entropy_probs is always written 0)
        self.mvc = np.array(T.DEFAULT_MV_CONTEXT, np.int32).copy()
        self.ymode_prob = np.array(T.YMODE_PROB, np.int32).copy()
        self.uv_mode_prob = np.array(T.UV_MODE_PROB, np.int32).copy()
        self._bitcost = _BITCOST
        self._mode_counting = False
        first = BoolEncoder()
        if keyframe:
            first.write_bit(0)  # clr_type
            first.write_bit(0)  # clamp_type
        if self.seg_map_enc is None:
            first.write_bit(0)  # segmentation_enabled
        else:
            # segmentation header (decodframe.c:829-875 dual)
            first.write_bit(1)  # segmentation_enabled
            first.write_bit(1)  # update_mb_segmentation_map
            first.write_bit(1)  # update_segment_feature_data
            first.write_bit(0)  # delta coding
            for deltas, bits in ((self.seg_q_deltas, 7),
                                 (self.seg_lf_deltas, 6)):
                for v in deltas:
                    if v == 0:
                        first.write_bit(0)
                    else:
                        first.write_bit(1)
                        first.write_literal(abs(v), bits)
                        first.write_bit(1 if v < 0 else 0)
            # segment tree probs from the map's distribution
            counts = [int((self.seg_map_enc == s).sum()) for s in range(4)]
            tot = max(1, sum(counts))
            lo = counts[0] + counts[1]
            hi = counts[2] + counts[3]
            self.seg_tree_probs = [
                min(254, max(1, 255 * lo // tot)),
                min(254, max(1, 255 * counts[0] // max(1, lo))),
                min(254, max(1, 255 * counts[2] // max(1, hi)))]
            for pr_ in self.seg_tree_probs:
                first.write_bit(1)
                first.write_literal(pr_, 8)
        first.write_bit(0)      # filter_type (normal)
        first.write_literal(self.filter_level, 6)
        first.write_literal(0, 3)   # sharpness
        first.write_bit(0)      # lf delta enabled
        first.write_literal(self.token_parts, 2)  # log2 token partitions
        first.write_literal(self.qindex, 7)
        for _ in range(5):
            first.write_bit(0)  # q deltas absent
        if not keyframe:
            rg = 1 if getattr(self, "refresh_golden", False) else 0
            ra = 1 if getattr(self, "refresh_alt", False) else 0
            first.write_bit(rg)  # refresh_golden
            first.write_bit(ra)  # refresh_alt
            if not rg:
                first.write_literal(0, 2)  # copy to gf
            if not ra:
                first.write_literal(0, 2)  # copy to arf
            first.write_bit(0)  # sign bias gf
            first.write_bit(0)  # sign bias arf
        first.write_bit(0)      # refresh_entropy_probs
        if not keyframe:
            first.write_bit(1 if getattr(self, "refresh_last_flag", True)
                            else 0)
        # per-frame coefficient probability updates (bitstream.c:1202-1310):
        # count token branch usage with a dry packing pass, then send updates
        # wherever the bit savings beat the signaling cost
        self.coef_probs = np.array(T.DEFAULT_COEF_PROBS, np.int32)
        # native (C++) token walk when available; Python golden fallback
        from ..utils import native as _native
        _lib = _native.get_lib()
        _q16 = _e32 = _m32 = _s32 = None
        if _lib is not None and getattr(_lib, "vp8e_count_tokens", None):
            _q16 = np.ascontiguousarray(self.qcoeff.astype(np.int16))
            _e32 = np.ascontiguousarray(self.eobs.astype(np.int32))
            _m32 = np.ascontiguousarray(self.mode[1:, 1:].astype(np.int32))
            _s32 = np.ascontiguousarray(self.skip.astype(np.int32))
            counts = _native.count_tokens_native(
                _lib, _q16, _e32, _m32, _s32, self.mb_no_coeff_skip)
        else:
            counts = np.zeros((4, 8, 3, 11, 2), np.int64)
            self._count_tokens(counts)
        up = T.COEF_UPDATE_PROBS
        bitcost = _BITCOST

        def _cand_sav(c0, c1, oldp, fp):
            """prob_update_savings (bitstream.c:1221-1231): candidate
            prob + net bit savings of updating (negative = keep)."""
            if c0 + c1 == 0:
                return oldp, -(1 << 30)
            cand = min(255, max(1, int(255 * c0 // (c0 + c1))))
            if cand == oldp:
                return oldp, -(1 << 30)
            old_b = c0 * bitcost[0][oldp] + c1 * bitcost[1][oldp]
            new_b = c0 * bitcost[0][cand] + c1 * bitcost[1][cand]
            upd_cost = 8 * 256 + (bitcost[1][fp] - bitcost[0][fp])
            return cand, old_b - new_b - upd_cost

        # snapshot of the pre-update probs: the joint (independent-
        # partitions) decision must be made from the probs as they stood
        # BEFORE any context wrote its update, so all 3 prev-coef contexts
        # reach the same decision (bitstream.c precomputes
        # prev_coef_savings once per (i,j) before any write)
        probs0 = self.coef_probs.copy()

        def _joint_sav(i, j, l, cand):
            """Savings of forcing one candidate across the 3 prev-coef
            contexts (independent_coef_context_savings inner loop)."""
            s = 0
            for kk in range(3):
                kc0 = int(counts[i, j, kk, l, 0])
                kc1 = int(counts[i, j, kk, l, 1])
                op = int(probs0[i, j, kk, l])
                fp = int(up[i, j, kk, l])
                s += (kc0 * bitcost[0][op] + kc1 * bitcost[1][op]) - \
                    (kc0 * bitcost[0][cand] + kc1 * bitcost[1][cand]) - \
                    (8 * 256 + bitcost[1][fp] - bitcost[0][fp])
            return s

        # partition-independence savings search (bitstream.c:1232-1310,
        # independent_coef_context_savings): with multiple token
        # partitions, probabilities made EQUAL across the 3 prev-coef
        # contexts let partitions decode rows without cross-row context
        # cost; adopt the constraint when its total savings win
        use_ind = False
        if self.token_parts > 0:
            reg_sav = ind_sav = 0
            for i in range(4):
                for j in range(8):
                    for k in range(3):
                        for l in range(11):
                            _, s = _cand_sav(
                                int(counts[i, j, k, l, 0]),
                                int(counts[i, j, k, l, 1]),
                                int(self.coef_probs[i, j, k, l]),
                                int(up[i, j, k, l]))
                            reg_sav += max(0, s)
                    csum = counts[i, j].sum(axis=0)       # [11, 2]
                    for l in range(11):
                        c0, c1 = int(csum[l, 0]), int(csum[l, 1])
                        if c0 + c1 == 0:
                            continue
                        cand = min(255, max(1, int(255 * c0 // (c0 + c1))))
                        ind_sav += max(0, _joint_sav(i, j, l, cand))
            use_ind = ind_sav >= reg_sav and ind_sav > 0
        self.independent_partitions = bool(use_ind)

        for i in range(4):
            for j in range(8):
                csum = counts[i, j].sum(axis=0)
                # joint decision per band position, once, from the
                # pre-update snapshot — applied to all 3 contexts below
                joint = {}
                if use_ind:
                    for l in range(11):
                        c0, c1 = int(csum[l, 0]), int(csum[l, 1])
                        if c0 + c1 > 0:
                            cand = min(255, max(
                                1, int(255 * c0 // (c0 + c1))))
                            if _joint_sav(i, j, l, cand) > 0:
                                joint[l] = cand
                for k in range(3):
                    for l in range(11):
                        oldp = int(self.coef_probs[i, j, k, l])
                        fp = int(up[i, j, k, l])
                        if use_ind:
                            newp = joint.get(l, oldp)
                            upd = 1 if newp != oldp else 0
                        else:
                            cand, s = _cand_sav(
                                int(counts[i, j, k, l, 0]),
                                int(counts[i, j, k, l, 1]), oldp, fp)
                            upd = 1 if s > 0 else 0
                            newp = cand if upd else oldp
                        first.write(upd, fp)
                        if upd:
                            first.write_literal(newp, 8)
                            self.coef_probs[i, j, k, l] = newp
        first.write_bit(1 if self.mb_no_coeff_skip else 0)
        # mode/mv section (mb_mode_mv_init duals)
        if self.mb_no_coeff_skip:
            n = R * C
            nskip = int(self.skip.sum())
            self.prob_skip_false = min(255, max(1, 256 * (n - nskip) // n))
            first.write_literal(self.prob_skip_false, 8)
        if not keyframe:
            n_intra = int((self.reff[1:, 1:] == INTRA_FRAME).sum())
            n = R * C
            n_inter = n - n_intra
            n_last = int((self.reff[1:, 1:] == LAST_FRAME).sum())
            n_gf = int((self.reff[1:, 1:] == GOLDEN_FRAME).sum())
            n_arf = int((self.reff[1:, 1:] == ALTREF_FRAME).sum())
            self.prob_intra = min(254, max(1, 255 * n_inter // n))
            self.prob_last = min(254, max(1, 255 * n_last //
                                          max(1, n_inter)))
            self.prob_gf = min(254, max(1, 255 * n_gf //
                                        max(1, n_gf + n_arf)))
            first.write_literal(self.prob_intra, 8)
            first.write_literal(self.prob_last, 8)
            first.write_literal(self.prob_gf, 8)
            # mode/MV probability updates: dry-pack the mode section with
            # the defaults to collect event counts, decide updates, then
            # pack for real with the updated probabilities
            if _lib is not None and getattr(_lib, "vp8e_count_modes", None):
                self._ymode_ct, self._uv_ct, self._mvstats = \
                    _native.count_modes_native(_lib, self)
            else:
                self._mvstats = [{"sign": [0, 0], "short_flag": [0, 0],
                                  "short": [0] * 8,
                                  "bits": [[0, 0] for _ in range(10)]}
                                 for _ in range(2)]
                self._ymode_ct = np.zeros(5, np.int64)
                self._uv_ct = np.zeros(4, np.int64)
                self._mode_counting = True
                dry = BoolEncoder()
                for r in range(R):
                    for c in range(C):
                        self._pack_mb_modes(dry, r, c, keyframe)
                self._mode_counting = False
            self._update_mode_probs(first, T.YMODE_TREE, self.ymode_prob,
                                    self._ymode_ct)
            self._update_mode_probs(first, T.UV_MODE_TREE, self.uv_mode_prob,
                                    self._uv_ct)
            self._write_mv_probs(first)
        if not (_lib is not None and getattr(_lib, "vp8e_pack_modes", None)
                and _native.pack_modes_native(_lib, self, first, keyframe)):
            for r in range(R):
                for c in range(C):
                    self._pack_mb_modes(first, r, c, keyframe)
        part0 = first.stop()

        nparts = 1 << self.token_parts
        parts = None
        if _q16 is not None:
            parts = _native.pack_tokens_native(
                _lib, _q16, _e32, _m32, _s32, self.mb_no_coeff_skip,
                self.coef_probs, nparts)
        if parts is None:
            encs = [BoolEncoder() for _ in range(nparts)]
            above_ctx = np.zeros((C, 9), np.int32)
            for r in range(R):
                left_ctx = np.zeros(9, np.int32)
                tokens = encs[r % nparts]
                for c in range(C):
                    self._pack_mb_tokens(tokens, r, c, above_ctx[c],
                                         left_ctx)
            parts = [e.stop() for e in encs]
        sizes = b""
        for p in parts[:-1]:
            sizes += bytes([len(p) & 0xFF, (len(p) >> 8) & 0xFF,
                            (len(p) >> 16) & 0xFF])
        part1 = sizes + b"".join(parts)

        if keyframe:
            tag = (0 | (0 << 1) | (1 << 4) | (len(part0) << 5))
            hdr = bytes([tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF,
                         0x9D, 0x01, 0x2A,
                         self.w & 0xFF, (self.w >> 8) & 0x3F,
                         self.h & 0xFF, (self.h >> 8) & 0x3F])
        else:
            show = 1 if getattr(self, "show_frame", True) else 0
            tag = (1 | (0 << 1) | (show << 4) | (len(part0) << 5))
            hdr = bytes([tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF])
        # partition boundaries for VPX_CODEC_USE_OUTPUT_PARTITION
        # (vpx_encoder.h:76): packet 0 is header+modes(+size table, kept
        # so concatenating the fragments reproduces the normal stream),
        # then one packet per token partition
        self.last_partition_bytes = [hdr + part0 + sizes] + parts
        return hdr + part0 + part1

    def _pack_mb_modes(self, e, r, c, keyframe):
        pr, pc = r + 1, c + 1
        mode = int(self.mode[pr, pc])
        if self.seg_map_enc is not None:
            # read_mb_features dual (decodemv.c:582-594)
            seg = int(self.seg_map_enc[r, c])
            p = self.seg_tree_probs
            if seg < 2:
                e.write(0, p[0])
                e.write(seg, p[1])
            else:
                e.write(1, p[0])
                e.write(seg - 2, p[2])
        if self.mb_no_coeff_skip:
            e.write(int(self.skip[r, c]), self.prob_skip_false)
        if keyframe:
            e.write_tree(T.KF_YMODE_TREE.tolist(), T.KF_YMODE_PROB.tolist(),
                         mode)
            if mode == B_PRED:
                # write_kfmodes dual (bitstream.c:1103-1160): per-subblock
                # bmode trees with above/left bmode context
                tree = T.BMODE_TREE.tolist()
                for i in range(16):
                    a = self._above_bmode(pr, pc, i)
                    l = self._left_bmode(pr, pc, i)
                    e.write_tree(tree, T.KF_BMODE_PROB[a][l].tolist(),
                                 int(self.bmode[pr, pc, i]))
            e.write_tree(T.UV_MODE_TREE.tolist(), T.KF_UV_MODE_PROB.tolist(),
                         int(self.uvmode[r, c]))
            return
        is_inter = int(self.reff[pr, pc]) != INTRA_FRAME
        e.write(1 if is_inter else 0, self.prob_intra)
        if not is_inter:
            if self._mode_counting:
                self._ymode_ct[mode] += 1
                self._uv_ct[int(self.uvmode[r, c])] += 1
            e.write_tree(T.YMODE_TREE.tolist(), self.ymode_prob.tolist(),
                         mode)
            if mode == B_PRED:
                tree = T.BMODE_TREE.tolist()
                for i in range(16):
                    e.write_tree(tree, T.BMODE_PROB.tolist(),
                                 int(self.bmode[pr, pc, i]))
            e.write_tree(T.UV_MODE_TREE.tolist(),
                         self.uv_mode_prob.tolist(),
                         int(self.uvmode[r, c]))
            return
        ref_used = int(self.reff[pr, pc])
        if ref_used == LAST_FRAME:
            e.write(0, self.prob_last)
        else:
            e.write(1, self.prob_last)
            e.write(0 if ref_used == GOLDEN_FRAME else 1, self.prob_gf)
        near, nearest, best, probs, cnt = self._find_near(r, c)
        mv = (int(self.mv[pr, pc, 0]), int(self.mv[pr, pc, 1]))
        # mv_ref tree (decodemv.c:407-530 decision structure)
        if mode == ZEROMV:
            e.write(0, probs[0])
        elif mode == NEARESTMV:
            e.write(1, probs[0])
            e.write(0, probs[1])
        elif mode == NEARMV:
            e.write(1, probs[0])
            e.write(1, probs[1])
            e.write(0, probs[2])
        elif mode == NEWMV:
            e.write(1, probs[0])
            e.write(1, probs[1])
            e.write(1, probs[2])
            e.write(0, probs[3])
            self._write_mv(e, mv[0] - best[0], 0)
            self._write_mv(e, mv[1] - best[1], 1)
        else:  # SPLITMV (decode_split_mv dual, decodemv.c:250-318)
            e.write(1, probs[0])
            e.write(1, probs[1])
            e.write(1, probs[2])
            e.write(1, probs[3])
            s_ = int(self.split_part[r, c])
            e.write_tree(T.MBSPLIT_TREE.tolist(), T.MBSPLIT_PROBS.tolist(),
                         s_)
            num_p = int(T.MBSPLIT_COUNT[s_])
            for j in range(num_p):
                k = refdec.MBSPLIT_OFFSET[s_][j]
                blockmv = tuple(self.bmv[pr, pc, k])
                leftmv = self._left_bmv(pr, pc, k)
                abovemv = self._above_bmv(pr, pc, k)
                lez = leftmv == (0, 0)
                aez = abovemv == (0, 0)
                lea = leftmv == abovemv
                prob = refdec.SUB_MV_REF_PROB3[(aez << 2) | (lez << 1) | lea]
                if blockmv == leftmv:
                    e.write(0, prob[0])
                elif blockmv == abovemv:
                    e.write(1, prob[0])
                    e.write(0, prob[1])
                elif blockmv == (0, 0):
                    e.write(1, prob[0])
                    e.write(1, prob[1])
                    e.write(0, prob[2])
                else:
                    e.write(1, prob[0])
                    e.write(1, prob[1])
                    e.write(1, prob[2])
                    self._write_mv(e, blockmv[0] - best[0], 0)
                    self._write_mv(e, blockmv[1] - best[1], 1)

    def _write_mv(self, e, delta, comp):
        """Dual of read_mvcomponent (decodemv.c:76-107); delta in 1/8 units
        (must be even). Uses the frame's (possibly updated) MV context."""
        assert delta % 2 == 0
        if self._mode_counting:
            self._count_mv_component(comp, delta >> 1)
        x = abs(delta) >> 1
        p = [int(v) for v in self.mvc[comp]]
        MVPsign, MVPshort, MVPbits = 1, 2, 9
        if x < 8:
            e.write(0, p[0])
            e.write_tree(T.SMALL_MV_TREE.tolist(), p[MVPshort:], x)
        else:
            e.write(1, p[0])
            for i in range(3):
                e.write((x >> i) & 1, p[MVPbits + i])
            for i in range(9, 3, -1):
                e.write((x >> i) & 1, p[MVPbits + i])
            if x & 0xFFF0:
                e.write((x >> 3) & 1, p[MVPbits + 3])
        if x:
            e.write(1 if delta < 0 else 0, p[MVPsign])

    def _pack_mb_tokens(self, e, r, c, actx, lctx):
        """Dual of the detokenize state machine for one MB."""
        pr, pc = r + 1, c + 1
        mode = int(self.mode[pr, pc])
        has_y2 = mode not in (B_PRED, SPLITMV)
        if self.mb_no_coeff_skip and self.skip[r, c]:
            # vp8_reset_mb_tokens_context dual (detokenize.c:70-84)
            actx[:8] = 0
            lctx[:8] = 0
            if has_y2:
                actx[8] = 0
                lctx[8] = 0
            return
        cp = self.coef_probs
        order = ([24] + list(range(16)) + list(range(16, 24))) if has_y2 \
            else (list(range(16)) + list(range(16, 24)))
        for i in order:
            if has_y2:
                btype = 1 if i == 24 else (0 if i < 16 else 2)
            else:
                btype = 3 if i < 16 else 2
            start = 1 if (has_y2 and i < 16) else 0
            ia, il = BLOCK2ABOVE[i], BLOCK2LEFT[i]
            ctx = int(actx[ia] + lctx[il])
            q = self.qcoeff[r, c, i]
            eob = int(self.eobs[r, c, i])
            nonzero = self._pack_block_tokens(e, q, eob, start, ctx,
                                              cp[btype])
            actx[ia] = lctx[il] = 1 if nonzero else 0

    def _count_tokens(self, counts):
        """Dry token walk accumulating per-node branch counts (the role of
        the ENTROPY_STATS gathering feeding vp8_update_coef_probs)."""
        R, C = self.R, self.C
        above_ctx = np.zeros((C, 9), np.int32)
        for r in range(R):
            left_ctx = np.zeros(9, np.int32)
            for c in range(C):
                pr, pc = r + 1, c + 1
                mode = int(self.mode[pr, pc])
                has_y2 = mode not in (B_PRED, SPLITMV)
                if self.mb_no_coeff_skip and self.skip[r, c]:
                    above_ctx[c, :8] = 0
                    left_ctx[:8] = 0
                    if has_y2:
                        above_ctx[c, 8] = 0
                        left_ctx[8] = 0
                    continue
                order = ([24] + list(range(16)) + list(range(16, 24)))                     if has_y2 else (list(range(16)) + list(range(16, 24)))
                for i in order:
                    if has_y2:
                        btype = 1 if i == 24 else (0 if i < 16 else 2)
                    else:
                        btype = 3 if i < 16 else 2
                    start = 1 if (has_y2 and i < 16) else 0
                    ia, il = BLOCK2ABOVE[i], BLOCK2LEFT[i]
                    ctx = int(above_ctx[c, ia] + left_ctx[il])
                    nz = self._walk_block(self.qcoeff[r, c, i],
                                          int(self.eobs[r, c, i]), start,
                                          ctx, counts[btype])
                    above_ctx[c, ia] = left_ctx[il] = 1 if nz else 0

    @staticmethod
    def _walk_block(q, eob, start, ctx, cnt):
        cpos = start
        prev_zero = False
        nonzero = False
        while cpos < 16:
            band = COEF_BANDS[cpos]
            if cpos >= eob:
                if not prev_zero:
                    cnt[band, ctx, 0, 0] += 1  # EOB
                break
            v = int(q[ZIGZAG[cpos]])
            if not prev_zero:
                cnt[band, ctx, 0, 1] += 1
            if v == 0:
                cnt[band, ctx, 1, 0] += 1
                ctx = 0
                prev_zero = True
                cpos += 1
                continue
            cnt[band, ctx, 1, 1] += 1
            nonzero = True
            prev_zero = False
            av = abs(v)
            if av == 1:
                cnt[band, ctx, 2, 0] += 1
                ctx = 1
            else:
                cnt[band, ctx, 2, 1] += 1
                if av <= 4:
                    cnt[band, ctx, 3, 0] += 1
                    cnt[band, ctx, 4, 0 if av == 2 else 1] += 1
                    if av > 2:
                        cnt[band, ctx, 5, av - 3] += 1
                elif av <= 10:
                    cnt[band, ctx, 3, 1] += 1
                    cnt[band, ctx, 6, 0] += 1
                    cnt[band, ctx, 7, 0 if av <= 6 else 1] += 1
                elif av <= 34:
                    cnt[band, ctx, 3, 1] += 1
                    cnt[band, ctx, 6, 1] += 1
                    cnt[band, ctx, 8, 0] += 1
                    cnt[band, ctx, 9, 0 if av <= 18 else 1] += 1
                else:
                    cnt[band, ctx, 3, 1] += 1
                    cnt[band, ctx, 6, 1] += 1
                    cnt[band, ctx, 8, 1] += 1
                    cnt[band, ctx, 10, 0 if av <= 66 else 1] += 1
                ctx = 2
            cpos += 1
        return nonzero

    def _pack_block_tokens(self, e, q, eob, start, ctx, probs):
        cpos = start
        prev_zero = False
        nonzero = False
        while cpos < 16:
            p = [int(x) for x in probs[COEF_BANDS[cpos], ctx]]
            if cpos >= eob:
                if not prev_zero:
                    e.write(0, p[0])  # EOB
                break
            v = int(q[ZIGZAG[cpos]])
            if not prev_zero:
                e.write(1, p[0])
            if v == 0:
                e.write(0, p[1])
                ctx = 0
                prev_zero = True
                cpos += 1
                continue
            e.write(1, p[1])
            nonzero = True
            prev_zero = False
            av = abs(v)
            if av == 1:
                e.write(0, p[2])
                ctx = 1
            else:
                e.write(1, p[2])
                ctx = 2
                if av <= 4:
                    e.write(0, p[3])
                    if av == 2:
                        e.write(0, p[4])
                    else:
                        e.write(1, p[4])
                        e.write(av - 3, p[5])
                elif av <= 10:
                    e.write(1, p[3])
                    e.write(0, p[6])
                    if av <= 6:
                        e.write(0, p[7])
                        self._write_cat(e, 0, av)
                    else:
                        e.write(1, p[7])
                        self._write_cat(e, 1, av)
                elif av <= 34:
                    e.write(1, p[3])
                    e.write(1, p[6])
                    e.write(0, p[8])
                    if av <= 18:
                        e.write(0, p[9])
                        self._write_cat(e, 2, av)
                    else:
                        e.write(1, p[9])
                        self._write_cat(e, 3, av)
                elif av <= 66:
                    e.write(1, p[3])
                    e.write(1, p[6])
                    e.write(1, p[8])
                    e.write(0, p[10])
                    self._write_cat(e, 4, av)
                else:
                    e.write(1, p[3])
                    e.write(1, p[6])
                    e.write(1, p[8])
                    e.write(1, p[10])
                    self._write_cat(e, 5, av)
            e.write(1 if v < 0 else 0, 128)  # sign
            cpos += 1
        return nonzero

    def _write_cat(self, e, cat, av):
        extra = av - CAT_MIN[cat]
        probs = CAT_PROBS[cat]
        nb = len(probs)
        for i, p in enumerate(probs):
            e.write((extra >> (nb - 1 - i)) & 1, int(p))


import math


def _tree_branch_counts(tree, num_events):
    """Per-branch (0,1) event counts for a vp8 tree (branch_counts,
    treecoder.c:60-105; branch/prob index = node offset >> 1)."""
    nb = len(tree) // 2
    bct = np.zeros((nb, 2), np.int64)

    def walk(node):
        tot = 0
        for side in (0, 1):
            t = int(tree[node + side])
            cnt = int(num_events[-t]) if t <= 0 else walk(t)
            bct[node >> 1, side] += cnt
            tot += cnt
        return tot

    walk(0)
    return bct


def _prob_bitcost():
    """cost (in 1/256 bits) of a 0/1 decision at probability p (the
    vp8_prob_cost role, boolhuff.c:23-40)."""
    c0 = [0] * 256
    c1 = [0] * 256
    for p in range(1, 256):
        c0[p] = int(round(-math.log2(p / 256.0) * 256))
        c1[p] = int(round(-math.log2((256 - p) / 256.0) * 256))
    c0[0] = c1[0] = 1 << 20
    return c0, c1


_BITCOST = _prob_bitcost()


def _uv_mv(mv):
    """chroma MV derivation (reconinter.c:418-424)."""
    def h(v):
        w = v + (1 if v >= 0 else -1)
        return w // 2 if w >= 0 else -((-w) // 2)
    return h(mv[0]), h(mv[1])


def _mk_dec():
    cls = type("NativeDec", (RefDecoder,), {"use_native": True})
    return cls()
