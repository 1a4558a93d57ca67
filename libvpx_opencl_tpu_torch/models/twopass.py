"""Two-pass encoding (vp8/encoder/firstpass.c host layer).

Pass 1 runs a cheap analysis pass collecting the reference's 17-field
per-frame statistics (FIRSTPASS_STATS, onyx_int.h:97-118): intra / best
prediction error, inter usage, motion usage and direction statistics.

Pass 2 follows the reference's allocation structure
(vp8_init_second_pass firstpass.c:1250, vp8_second_pass :2290,
find_next_key_frame :79, define_gf_group behavior):

  * modified prediction error per frame (calculate_modified_err: the
    error bent through a power curve around the clip average so easy
    frames give up bits to hard ones);
  * keyframe group segmentation — scene-cut candidates from the
    inter-usage / error-ratio tests (test_candidate_kf role), with a
    keyframe boost accumulated from the decaying prediction quality of
    the following frames;
  * golden-frame groups inside each KF group, interval scaled by motion
    (gf_interval_table role) with gfu_boost from the same decay model;
  * per-frame bit targets as each frame's modified-error share of its
    group's allocation, driven through RateController.regulate_q with the
    standard correction-factor feedback.

Stats serialize to a file for the vpxenc-style two-process workflow
(stats_open_file vpxenc.c:123-218).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, asdict, field

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


@dataclass
class FirstPassStats:
    """FIRSTPASS_STATS (onyx_int.h:97-118)."""
    frame: float = 0.0
    intra_error: float = 0.0
    coded_error: float = 0.0
    ssim_weighted_pred_err: float = 0.0
    pcnt_inter: float = 0.0
    pcnt_motion: float = 0.0
    pcnt_second_ref: float = 0.0
    pcnt_neutral: float = 0.0
    MVr: float = 0.0
    mvr_abs: float = 0.0
    MVc: float = 0.0
    mvc_abs: float = 0.0
    MVrv: float = 0.0
    MVcv: float = 0.0
    mv_in_out_count: float = 0.0
    new_mv_count: float = 0.0
    duration: float = 1.0
    count: float = 1.0


def analyze_frame(prev_y, gld_y, y, mc_range=8):
    """Pass-1 per-frame analysis (vp8_first_pass firstpass.c:481):
    per-MB DC-intra error, exhaustive full-pel motion error vs the
    previous frame (and the golden frame for pcnt_second_ref), and the
    motion-field statistics."""
    h, w = y.shape
    R, C = h // 16, w // 16
    yi = y[:R * 16, :C * 16].astype(np.int64)
    blocks = yi.reshape(R, 16, C, 16).transpose(0, 2, 1, 3)
    dc = (blocks.mean(axis=(2, 3), keepdims=True) + 0.5).astype(np.int64)
    intra_err = ((blocks - dc) ** 2).sum(axis=(2, 3)).astype(np.float64)
    s = FirstPassStats(intra_error=float(intra_err.sum()) / 256.0,
                       coded_error=float(intra_err.sum()) / 256.0)
    s.ssim_weighted_pred_err = s.coded_error
    if prev_y is None:
        return s

    def best_mc(ref_y):
        from .me_host import fullpel_match
        mvr, mvc, sse, zsse = fullpel_match(
            yi[:R * 16, :C * 16].astype(np.uint8),
            np.asarray(ref_y)[:R * 16, :C * 16], mc_range)
        return (sse.astype(np.float64), zsse.astype(np.float64),
                mvr.astype(np.int64), mvc.astype(np.int64))

    err_l, zerr_l, mvr, mvc = best_mc(prev_y)
    inter_mask = err_l < intra_err
    coded = np.where(inter_mask, err_l, intra_err)
    s.coded_error = float(coded.sum()) / 256.0
    s.ssim_weighted_pred_err = s.coded_error
    s.pcnt_inter = float(inter_mask.mean())
    moving = inter_mask & ((np.abs(mvr) + np.abs(mvc)) > 0)
    s.pcnt_motion = float(moving.mean())
    # neutral: inter MBs whose error is close to the zero-MV error
    neutral = inter_mask & (err_l * 2 > zerr_l)
    s.pcnt_neutral = float(neutral.mean())
    if moving.any():
        mr = mvr[moving].astype(np.float64)
        mc_ = mvc[moving].astype(np.float64)
        s.MVr, s.MVc = float(mr.mean()), float(mc_.mean())
        s.mvr_abs = float(np.abs(mr).mean())
        s.mvc_abs = float(np.abs(mc_).mean())
        s.MVrv = float(mr.var())
        s.MVcv = float(mc_.var())
        # fraction of motion pointing out of vs into the frame center
        rr, cc = np.mgrid[0:R, 0:C]
        out_r = np.sign(rr - R / 2.0)[moving] * np.sign(mr)
        out_c = np.sign(cc - C / 2.0)[moving] * np.sign(mc_)
        s.mv_in_out_count = float((out_r + out_c).mean() / 2.0)
        s.new_mv_count = float(moving.sum())
    if gld_y is not None:
        err_g, _, _, _ = best_mc(gld_y)
        s.pcnt_second_ref = float((err_g < coded).mean())
    return s


def first_pass(frames_iter, mc_range=8):
    """Run pass 1 over an iterable of (y, u, v); returns the stats list.
    The golden (second) reference is the most recent analysis keyframe."""
    stats = []
    prev = None
    gld = None
    for i, f in enumerate(frames_iter):
        y = np.asarray(f[0])
        s = analyze_frame(prev, gld, y, mc_range)
        s.frame = float(i)
        stats.append(s)
        if prev is None or s.pcnt_inter < 0.5:
            gld = y
        prev = y
    return stats


# ---------------------------------------------------------------------------
# pass 2

def modified_error(stats, s, pow_low=0.80, pow_high=0.80):
    """calculate_modified_err (firstpass.c:330-355): bend each frame's
    error through a power curve around the clip average."""
    av = max(1.0, sum(x.ssim_weighted_pred_err for x in stats) / len(stats))
    err = s.ssim_weighted_pred_err
    ratio = err / av
    p = pow_low if ratio < 1.0 else pow_high
    return av * (ratio ** p)


def is_scene_cut(stats, i):
    """test_candidate_kf flavor (firstpass.c:79+): sharp drop in inter
    usage plus a prediction-error jump vs the previous frame."""
    if i == 0:
        return True
    s = stats[i]
    prev = stats[i - 1]
    if s.pcnt_inter < 0.25:
        return True
    ii_ratio = s.intra_error / max(1.0, s.coded_error)
    return (s.pcnt_inter < 0.55 and ii_ratio < 1.25 and
            s.coded_error > 2.5 * max(1.0, prev.coded_error))


def boost_score(stats, start, max_frames=16):
    """Decaying prediction-quality accumulation (the kf_boost / gfu_boost
    computation shape of find_next_key_frame firstpass.c:79 and
    calc_frame_boost)."""
    score = 0.0
    decay = 1.0
    for j in range(start, min(start + max_frames, len(stats))):
        s = stats[j]
        ii = s.intra_error / max(1.0, s.coded_error)
        frame_boost = min(ii * 2.0, 16.0)
        score += decay * frame_boost
        pred_quality = s.pcnt_inter * 0.85
        decay *= min(1.0, max(0.1, pred_quality + 0.25))
        if decay < 0.05:
            break
    return score


def define_gf_group(stats, start, end, max_interval=15):
    """define_gf_group (firstpass.c:1250,2290 role): walk frames from
    `start` accumulating golden-frame-usefulness boost with the decaying
    prediction-quality model (calc_frame_boost shape); the group ends
    when the prediction chain collapses (high motion / poor inter) or the
    interval limit is hit.  Returns (interval, gfu_boost)."""
    boost = 0.0
    decay = 1.0
    i = start
    while i < end:
        s = stats[i]
        ii = s.intra_error / max(1.0, s.coded_error)
        boost += decay * min(ii * 2.0, 16.0)
        pred_quality = s.pcnt_inter * 0.85
        # motion amplitude erodes how useful a distant golden frame is
        amp = (s.mvr_abs + s.mvc_abs) / 32.0
        decay *= min(1.0, max(0.1, pred_quality + 0.25 - amp))
        i += 1
        n = i - start
        if n >= max_interval:
            break
        if n >= 4 and decay < 0.4:
            break
    return i - start, boost


class TwoPassController:
    """Pass-2 allocation driving RateController.regulate_q."""

    def __init__(self, stats, target_bitrate_kbps, fps, mb_count,
                 min_q=4, max_q=127, auto_altref=False):
        from .ratecontrol import RateController
        self.stats = stats
        self.n = len(stats)
        self.rc = RateController(target_bitrate_kbps, fps, mb_count,
                                 min_q=min_q, max_q=min(127, max_q),
                                 end_usage="vbr", kf_max_dist=1 << 30)
        self.bits_total = target_bitrate_kbps * 1000.0 / fps * self.n
        self.spent = 0.0
        self.idx = 0
        self.auto_altref = bool(auto_altref)

        # keyframe group segmentation
        self.kf_positions = [i for i in range(self.n)
                             if is_scene_cut(stats, i)]
        if 0 not in self.kf_positions:
            self.kf_positions.insert(0, 0)
        # per-frame modified error and per-KF-group budgets
        self.mod_err = [modified_error(stats, s) for s in stats]
        total_mod = max(1e-9, sum(self.mod_err))
        self.group_of = np.zeros(self.n, np.int64)
        bounds = self.kf_positions + [self.n]
        self.group_bits = []
        self.kf_boosts = []
        for g in range(len(self.kf_positions)):
            lo, hi = bounds[g], bounds[g + 1]
            self.group_of[lo:hi] = g
            share = sum(self.mod_err[lo:hi]) / total_mod
            self.group_bits.append(self.bits_total * share)
            self.kf_boosts.append(boost_score(stats, lo))
        self.group_spent = [0.0] * len(self.group_bits)

        # golden-frame groups inside each KF group (define_gf_group):
        # gf_positions are group starts (skipping the KF itself);
        # arf_center_of maps a gf position to the display index the
        # synthesized ARF should anchor on (the group's far end)
        self.gf_positions = []
        self.gf_boosts = {}
        self.arf_center_of = {}
        for g in range(len(self.kf_positions)):
            lo, hi = bounds[g], bounds[g + 1]
            i = lo
            while i < hi:
                interval, gboost = define_gf_group(stats, i, hi)
                if i != lo:
                    self.gf_positions.append(i)
                    self.gf_boosts[i] = gboost
                if interval <= 0:
                    break
                self.arf_center_of[i] = min(i + interval, self.n - 1)
                i += interval

    def want_keyframe(self):
        return self.idx in self.kf_positions

    def want_golden(self):
        """True at motion-scaled GF-group boundaries (non-KF)."""
        return self.idx in self.gf_positions

    def frame_target(self, keyframe):
        i = min(self.idx, self.n - 1)
        g = int(self.group_of[i])
        bounds = self.kf_positions + [self.n]
        lo, hi = bounds[g], bounds[g + 1]
        remaining = max(0.0, self.group_bits[g] - self.group_spent[g])
        if keyframe:
            # keyframe takes a boosted slice of its group's budget
            # (find_next_key_frame allocation, firstpass.c:79)
            boost = min(self.kf_boosts[g], 16.0 * 2)
            frames_in_group = hi - lo
            chunks = frames_in_group * 100.0 + boost * 100.0 / 16.0
            target = remaining * (100.0 + boost * 100.0 / 16.0) / chunks
        else:
            err_rest = sum(self.mod_err[i:hi]) or 1e-9
            target = remaining * (self.mod_err[i] / err_rest)
            if i in self.gf_boosts:
                # golden frames take a gfu_boost-scaled extra share
                # (define_gf_group allocation, firstpass.c:1250)
                gb = min(self.gf_boosts[i], 48.0)
                target *= (1.0 + gb / 32.0)
        return max(target, self.rc.per_frame_bandwidth / 8.0)

    def arf_done(self, q, used_bits):
        """Charge an out-of-band ARF frame to the current group without
        advancing the display-frame cursor."""
        g = int(self.group_of[min(self.idx, self.n - 1)])
        self.group_spent[g] += used_bits
        self.spent += used_bits
        self.rc.update_rate_correction_factor(q, used_bits, False,
                                              golden=True)

    def frame_q(self, keyframe):
        target = self.frame_target(keyframe)
        self._last_target = target
        self.rc.this_frame_target = int(target)
        return self.rc.regulate_q(target, keyframe)

    def update(self, q, used_bits, keyframe):
        g = int(self.group_of[min(self.idx, self.n - 1)])
        self.group_spent[g] += used_bits
        self.spent += used_bits
        self.idx += 1
        self.rc.update_rate_correction_factor(q, used_bits, keyframe)
        self.rc.frames_since_key = 0 if keyframe else \
            self.rc.frames_since_key + 1
        self.rc.frame_count += 1


def save_stats(path, stats):
    with open(path, "w") as f:
        json.dump([asdict(s) for s in stats], f)


def load_stats(path):
    with open(path) as f:
        return [FirstPassStats(**d) for d in json.load(f)]
