"""Rate control (host layer).

Implements the reference encoder's one-pass rate control structure
(vp8/encoder/ratectrl.c):

  * frame bit targets — calc_iframe_target_size (ratectrl.c:356: keyframe
    boost scaled by Q and keyframe separation) and calc_pframe_target_size
    (:614: per-frame bandwidth, keyframe-overspend recovery, buffer-level
    adaptation with under/overshoot percentages for CBR);
  * Q selection — vp8_regulate_q (:1241): scan Q until the projected size
    (BITS_PER_MB estimate x per-frame-type correction factor) meets the
    target;
  * post-frame feedback — vp8_update_rate_correction_factors (:1137):
    damped multiplicative correction from projected vs actual size, kept
    separately for key / golden / normal frames; leaky-bucket buffer model
    (onyx_if.c:3974-4006 buffer_level / bits_off_target update);
  * recode bounds — vp8_compute_frame_size_bounds (:1373) and
    recode_loop_test (onyx_if.c:2934), driving encode_frame_with_rc's
    re-quantize loop (the reference's recode loop, onyx_if.c:3600-3800);
  * keyframe scheduling — forced interval plus the frames_to_key /
    frequency estimate roles (:1371,1424) in simplified form.

Q throughout is the frame qindex (0..127).
"""
from __future__ import annotations

import numpy as np

from ..ops import rc_tables as RT

MIN_BPB_FACTOR = 0.01
MAX_BPB_FACTOR = 50.0
BPER_MB_NORMBITS = 9


class RateController:
    def __init__(self, target_bitrate_kbps, fps, mb_count,
                 min_q=4, max_q=127, end_usage="cbr",
                 starting_buffer_ms=4000, optimal_buffer_ms=5000,
                 maximum_buffer_ms=6000,
                 undershoot_pct=100, overshoot_pct=100,
                 kf_max_dist=128, drop_frames_water_mark=0):
        self.target_bandwidth = target_bitrate_kbps * 1000.0  # bits/s
        self.fps = float(fps)
        self.mb_count = mb_count
        self.min_q = int(min_q)
        self.max_q = min(127, int(max_q))
        self.end_usage = end_usage          # "cbr" | "vbr"
        self.per_frame_bandwidth = int(self.target_bandwidth / self.fps)
        bl = self.target_bandwidth / 1000.0
        self.starting_buffer_level = int(starting_buffer_ms * bl)
        self.optimal_buffer_level = max(1, int(optimal_buffer_ms * bl))
        self.maximum_buffer_size = int(maximum_buffer_ms * bl)
        self.undershoot_pct = undershoot_pct
        self.overshoot_pct = overshoot_pct
        self.kf_max_dist = kf_max_dist

        # per-frame-type correction factors (ratectrl.c:1137)
        self.rate_correction_factor = 1.0
        self.key_frame_rate_correction_factor = 1.0
        self.gf_rate_correction_factor = 1.0

        # buffer model
        self.buffer_level = self.starting_buffer_level
        self.bits_off_target = self.starting_buffer_level
        self.total_byte_count = 0

        # Q averages (ni_av_qi role)
        self.avg_frame_qindex = (self.min_q + self.max_q) // 2
        self.ni_av_qi = self.max_q
        self.ni_tot_qi = 0
        self.ni_frames = 0

        self.active_worst_quality = self.max_q
        self.active_best_quality = self.min_q

        self.frames_since_key = 0
        self.frame_count = 0
        # keyframe overspend recovery (calc_pframe_target_size)
        self.kf_overspend_bits = 0
        self.kf_bitrate_adjustment = 0
        self.this_frame_target = self.per_frame_bandwidth

        # CBR frame dropping (drop_frames_allowed, onyx_if.c:1588;
        # rc_dropframe_thresh -> drop_frames_water_mark)
        self.drop_frames_water_mark = int(drop_frames_water_mark)
        self.drop_frames_allowed = self.drop_frames_water_mark > 0
        self.decimation_factor = 0
        self.decimation_count = 0
        self.drop_count = 0
        self.frames_dropped = 0

    # ------------------------------------------------------------------
    def want_keyframe(self):
        """Forced-interval keyframe scheduling (kf_max_dist role)."""
        return (self.frame_count == 0 or
                (self.kf_max_dist > 0 and
                 self.frames_since_key >= self.kf_max_dist))

    def check_frame_drop(self, keyframe):
        """CBR frame-drop decision: the buffer-driven decimation ladder
        (onyx_if.c:3272-3358, drop_mark 75/50/25 thresholds and
        decimation_factor 0..3) plus the buffer-underrun crisis drop
        (calc_pframe_target_size ratectrl.c:965-999).  Returns True when
        this frame must be dropped; performs the dropped-frame buffer
        bookkeeping itself (onyx_if.c:3323-3338)."""
        if not self.drop_frames_allowed or self.end_usage != "cbr":
            return False
        drop_mark = (self.drop_frames_water_mark *
                     self.optimal_buffer_level) // 100
        drop_mark75 = drop_mark * 2 // 3
        drop_mark50 = drop_mark // 4
        drop_mark25 = drop_mark // 8
        if self.buffer_level > drop_mark and self.decimation_factor > 0:
            self.decimation_factor -= 1
        if self.buffer_level > drop_mark75 and self.decimation_factor > 0:
            self.decimation_factor = 1
        elif (self.buffer_level < drop_mark25 and
              self.decimation_factor in (2, 3)):
            self.decimation_factor = 3
        elif (self.buffer_level < drop_mark50 and
              self.decimation_factor in (1, 2)):
            self.decimation_factor = 2
        elif (self.buffer_level < drop_mark75 and
              self.decimation_factor in (0, 1)):
            self.decimation_factor = 1
        if self.decimation_factor > 0:
            if keyframe:
                self.decimation_count = self.decimation_factor
            elif self.decimation_count > 0:
                self.decimation_count -= 1
                self._drop_bookkeeping()
                return True
            else:
                self.decimation_count = self.decimation_factor
        # buffer underrun crisis (ratectrl.c:973-985)
        if not keyframe and self.buffer_level < 0:
            self.drop_count += 1
            self._drop_bookkeeping()
            return True
        self.drop_count = 0
        return False

    def _drop_bookkeeping(self):
        self.bits_off_target += self.per_frame_bandwidth
        self.bits_off_target = min(self.bits_off_target,
                                   self.maximum_buffer_size)
        self.buffer_level = self.bits_off_target
        self.frames_since_key += 1
        self.frame_count += 1
        self.frames_dropped += 1

    def _correction_factor(self, keyframe, golden=False):
        if keyframe:
            return self.key_frame_rate_correction_factor
        if golden:
            return self.gf_rate_correction_factor
        return self.rate_correction_factor

    # ------------------------------------------------------------------
    def frame_target(self, keyframe, golden=False):
        """calc_iframe_target_size / calc_pframe_target_size."""
        if keyframe:
            if self.frame_count == 0:
                # first frame: half the starting buffer (ratectrl.c:378)
                target = self.starting_buffer_level // 2
                target = min(target, int(self.target_bandwidth * 3 // 2))
            else:
                q = self.avg_frame_qindex
                kf_boost = int(2 * self.fps - 16)
                kf_boost = kf_boost * int(RT.KF_BOOST_QADJ[q]) // 100
                if self.frames_since_key < self.fps / 2:
                    kf_boost = int(kf_boost * self.frames_since_key /
                                   (self.fps / 2))
                kf_boost = max(16, kf_boost)
                target = ((16 + kf_boost) * self.per_frame_bandwidth) >> 4
        else:
            min_frame_target = max(0, self.per_frame_bandwidth // 4)
            target = self.per_frame_bandwidth
            # recover keyframe overspend over following frames
            if self.kf_overspend_bits > 0:
                adj = min(self.kf_bitrate_adjustment, self.kf_overspend_bits)
                adj = min(adj, max(0, target - min_frame_target))
                self.kf_overspend_bits -= adj
                target -= adj
            # buffer-level adaptation (one-pass, buffered modes)
            one_pct = 1 + self.optimal_buffer_level // 100
            if (self.buffer_level < self.optimal_buffer_level or
                    self.bits_off_target < self.optimal_buffer_level):
                pct_low = 0
                if (self.end_usage == "cbr" and
                        self.buffer_level < self.optimal_buffer_level):
                    pct_low = int((self.optimal_buffer_level -
                                   self.buffer_level) / one_pct)
                elif self.bits_off_target < 0 and self.total_byte_count > 0:
                    pct_low = int(100 * -self.bits_off_target /
                                  (self.total_byte_count * 8))
                pct_low = min(max(pct_low, 0), self.undershoot_pct)
                target -= (target * pct_low) // 200
                self.active_worst_quality = self.max_q
            else:
                pct_high = 0
                if (self.end_usage == "cbr" and
                        self.buffer_level > self.optimal_buffer_level):
                    pct_high = int((self.buffer_level -
                                    self.optimal_buffer_level) / one_pct)
                elif (self.bits_off_target > self.optimal_buffer_level and
                      self.total_byte_count > 0):
                    pct_high = int(100 * self.bits_off_target /
                                   (self.total_byte_count * 8))
                pct_high = min(max(pct_high, 0), self.overshoot_pct)
                target += (target * pct_high) // 200
            target = max(target, min_frame_target)
        self.this_frame_target = int(target)
        return self.this_frame_target

    # ------------------------------------------------------------------
    def regulate_q(self, target_bits, keyframe, golden=False):
        """vp8_regulate_q (ratectrl.c:1241): smallest Q in
        [active_best, active_worst] whose projected size meets target."""
        ftype = 0 if keyframe else 1
        cf = self._correction_factor(keyframe, golden)
        target_bits_per_mb = (int(target_bits) << BPER_MB_NORMBITS) \
            // self.mb_count
        q = self.active_worst_quality
        last_error = 1 << 60
        i = self.active_best_quality
        while i <= self.active_worst_quality:
            bpm = int(0.5 + cf * int(RT.BITS_PER_MB[ftype, i]))
            if bpm <= target_bits_per_mb:
                if target_bits_per_mb - bpm <= last_error:
                    q = i
                else:
                    q = i - 1
                break
            last_error = bpm - target_bits_per_mb
            i += 1
        return min(self.max_q, max(self.min_q, q))

    def projected_size(self, q, keyframe, golden=False):
        ftype = 0 if keyframe else 1
        cf = self._correction_factor(keyframe, golden)
        return int((0.5 + cf * int(RT.BITS_PER_MB[ftype, q])) *
                   self.mb_count) >> BPER_MB_NORMBITS

    # ------------------------------------------------------------------
    def frame_size_bounds(self, keyframe, golden=False):
        """vp8_compute_frame_size_bounds (ratectrl.c:1373)."""
        t = self.this_frame_target
        if keyframe or golden:
            return t * 7 // 8, t * 9 // 8
        if self.end_usage == "cbr":
            if self.buffer_level >= ((self.optimal_buffer_level +
                                      self.maximum_buffer_size) >> 1):
                return t * 6 // 8, t * 12 // 8
            if self.buffer_level <= (self.optimal_buffer_level >> 1):
                return t * 4 // 8, t * 10 // 8
            return t * 5 // 8, t * 11 // 8
        return t * 3 // 8, t * 20 // 8

    def recode_needed(self, size_bits, q, keyframe, golden=False):
        """recode_loop_test (onyx_if.c:2934), recode-mode-1 semantics."""
        low, high = self.frame_size_bounds(keyframe, golden)
        if size_bits > high and q < self.active_worst_quality:
            return 1          # overshoot: move Q up
        if size_bits < low and q > self.active_best_quality:
            return -1         # undershoot: move Q down
        return 0

    # ------------------------------------------------------------------
    def update_rate_correction_factor(self, q, actual_bits, keyframe,
                                      golden=False, damp=0):
        """vp8_update_rate_correction_factors (ratectrl.c:1137)."""
        ftype = 0 if keyframe else 1
        cf = self._correction_factor(keyframe, golden)
        projected = int((0.5 + cf * int(RT.BITS_PER_MB[ftype, q])) *
                        self.mb_count) >> BPER_MB_NORMBITS
        correction = 100
        if projected > 0:
            correction = (100 * actual_bits) // projected
        limit = (0.75, 0.375, 0.25)[min(2, damp)]
        if correction > 102:
            correction = int(100.5 + (correction - 100) * limit)
            cf = min(MAX_BPB_FACTOR, cf * correction / 100.0)
        elif correction < 99:
            correction = int(100.5 - (100 - correction) * limit)
            cf = max(MIN_BPB_FACTOR, cf * correction / 100.0)
        if keyframe:
            self.key_frame_rate_correction_factor = cf
        elif golden:
            self.gf_rate_correction_factor = cf
        else:
            self.rate_correction_factor = cf

    def frame_done(self, q, actual_bits, keyframe, golden=False):
        """Post-frame buffer / average / overspend bookkeeping
        (onyx_if.c:3974-4070)."""
        self.update_rate_correction_factor(q, actual_bits, keyframe, golden)
        self.bits_off_target += self.per_frame_bandwidth - actual_bits
        self.bits_off_target = min(self.bits_off_target,
                                   self.maximum_buffer_size)
        self.buffer_level = self.bits_off_target
        self.total_byte_count += actual_bits // 8
        self.frame_count += 1
        if keyframe:
            # spread keyframe overspend over upcoming frames
            # (vp8_adjust_key_frame_context, ratectrl.c:1424)
            overspend = max(0, actual_bits - self.per_frame_bandwidth)
            self.kf_overspend_bits += overspend
            recovery_frames = max(1, int(self.fps))
            self.kf_bitrate_adjustment = \
                self.kf_overspend_bits // recovery_frames
            self.frames_since_key = 0
        else:
            self.frames_since_key += 1
            self.ni_frames += 1
            # running average Q of normal inter frames
            if self.ni_frames == 1:
                self.ni_tot_qi = q
                self.ni_av_qi = q
            else:
                self.ni_tot_qi += q
                self.ni_av_qi = self.ni_tot_qi // self.ni_frames
        self.avg_frame_qindex = (2 + 3 * self.avg_frame_qindex + q) >> 2

    # ------------------------------------------------------------------
    # compact legacy interface (layers.py / twopass.py / api.py callers)

    def frame_q(self, keyframe):
        target = self.frame_target(keyframe)
        return self.regulate_q(target, keyframe)

    def update(self, q, used_bits, keyframe):
        self.frame_done(q, used_bits, keyframe)


def encode_frame_with_rc(enc, rc, y, u, v, keyframe=None, golden=False,
                         max_recodes=4):
    """Drive one frame through `enc` under `rc` with the reference's
    recode loop (encode_frame_to_data_rate, onyx_if.c:3109,3600-3800):
    re-quantize while the produced size is outside the frame's bounds,
    bracketing Q between q_low/q_high."""
    if keyframe is None:
        keyframe = rc.want_keyframe()
    if rc.check_frame_drop(keyframe):
        return b""            # dropped frame: no packet is emitted
    target = rc.frame_target(keyframe, golden)
    q = rc.regulate_q(target, keyframe, golden)
    q_low, q_high = rc.active_best_quality, rc.active_worst_quality
    payload = None
    for _ in range(max_recodes + 1):
        enc.qindex = q
        payload = enc.encode_frame(y, u, v, keyframe=keyframe, commit=False)
        size_bits = len(payload) * 8
        direction = rc.recode_needed(size_bits, q, keyframe, golden)
        if direction == 0:
            break
        if direction > 0:
            q_low = max(q_low, q + 1)
        else:
            q_high = min(q_high, q - 1)
        if q_low > q_high:
            break
        rc.update_rate_correction_factor(q, size_bits, keyframe, golden,
                                         damp=0)
        nq = rc.regulate_q(target, keyframe, golden)
        q = min(max(nq, q_low), q_high)
    enc.commit_frame(payload)
    rc.frame_done(q, len(payload) * 8, keyframe, golden)
    return payload
