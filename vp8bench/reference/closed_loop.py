"""Encode check: the payloads against the plain reference decoder
(`host_decoder.py`, a frozen copy of the program's golden NumPy decoder),
and the reconstruction against the source.

Compared, each with its limit:
  * recon_mismatch_px (limit 0): over the sampled frames, the pixels of
    the MB-aligned Y, U and V planes where the reference's decode of the
    frame's payload differs from the encoder's reconstruction. Sampled:
    the last keyframe of the window (decoded from nothing: the start) and
    `config["check_samples"]` window frames drawn from the seed. A sampled
    inter frame is decoded from reference frames that are the encoder's
    own reconstructions of earlier frames, in the slots that the headers
    of every frame since the first keyframe assign them (refresh and copy
    flags); its probabilities come from parsing each of those headers.
    A ring the encoder failed to update, a reconstruction the payload
    does not describe, or an altered payload each show as a mismatch.
  * sample_errors (limit 0): sampled payloads the reference could not
    decode, or a header chain it could not parse.
  * qindex_off_frames (limit 0): window frames whose header's base
    quantizer index is not the configured `cq_level`.
  * mb_luma_mse_max (limit `config["mb_luma_mse_limit"]`): the largest
    luma mean squared error of one 16x16 MB between a window frame's
    source and the encoder's reconstruction, over the MBs that lie wholly
    in the visible area. (The frame's mean does not separate a coarser
    quantizer on a clip whose error is mostly uncoded noise; the worst MB,
    where the texture is, does.)

The configuration's effort level (its speed features), where the traffic
file gives the limits that its content allows:
  * inter_bytes_per_frame (limit `traffic["inter_bytes_limit"]`): the
    mean payload bytes of the window's inter frames. At a fixed quantizer
    a narrower motion search codes more residual: the stream grows.
  * bpred_free_samples (limit `traffic["bpred_free_samples_limit"]`): the
    sampled inter frames in which no MB is coded B_PRED (the reference
    decoder's modes), on content where the B_PRED search wins MBs in
    every inter frame.
Neither sees the trellis: at a fixed quantizer it moves bytes and
distortion by a percent or two, in opposite directions.

The sampled frames are decoded in worker processes (spawn), side by side;
the pool is shut down and waited for before the check returns.
"""
import multiprocessing
import os
import pickle
import random
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .host_decoder import (B_PRED, BORDER, INTRA_FRAME, FrameBuffer,
                           RefDecoder)


class _Pending:
    """A reference slot holding the encoder's reconstruction of frame j,
    read only when a sampled frame predicts from it."""

    def __init__(self, j):
        self.j = j

    def extend_borders(self):
        pass


class Follower(RefDecoder):
    """The reference decoder, which can also follow a frame: parse its
    header and frame-level probabilities, then take `follow` (the
    encoder's reconstruction) as the frame, without decoding it."""

    follow = None

    def _decode_modes(self, bc):
        if self.follow is None:
            return super()._decode_modes(bc)
        self._decode_mode_probs(bc)
        R, C = self.mb_rows, self.mb_cols
        self.mv = np.zeros((R + 1, C + 1, 2), np.int32)
        self.ref_frame = np.zeros((R + 1, C + 1), np.int32)

    def _reconstruct(self):
        if self.follow is None:
            return super()._reconstruct()
        self.cur = self.follow

    def _swap_and_filter(self):
        if self.follow is None:
            return super()._swap_and_filter()
        level, self.filter_level = self.filter_level, 0
        try:
            super()._swap_and_filter()
        finally:
            self.filter_level = level


def aligned(fb):
    """The MB-aligned area of a FrameBuffer's planes."""
    b, b2 = BORDER, BORDER // 2
    return (fb.y[b:b + fb.ah, b:b + fb.aw], fb.u[b2:b2 + fb.ah // 2,
                                                  b2:b2 + fb.aw // 2],
            fb.v[b2:b2 + fb.ah // 2, b2:b2 + fb.aw // 2])


def _frame(w, h, planes):
    fb = FrameBuffer(w, h)
    for dst, src in zip(aligned(fb), planes):
        dst[:] = src
    fb.extend_borders()
    return fb


def _materialize(dec, recon_of):
    made = {}
    for slot in ("last", "golden", "altref"):
        f = getattr(dec, slot)
        if isinstance(f, _Pending):
            if f.j not in made:
                made[f.j] = _frame(dec.w, dec.h, recon_of(f.j))
            setattr(dec, slot, made[f.j])


def decode_sample(state, payload):
    """Decode one payload from a pickled Follower; (the MB-aligned planes,
    the number of intra MBs coded B_PRED), or the error's text."""
    dec = pickle.loads(state)
    dec.follow = None
    try:
        dec.decode_frame_core(payload)
    except Exception as e:
        return repr(e)
    bpred = int(((dec.mode[1:, 1:] == B_PRED)
                 & (dec.ref_frame[1:, 1:] == INTRA_FRAME)).sum())
    return tuple(np.array(p) for p in aligned(dec.frame_to_show)), bpred


def check(config, traffic, outputs, seed, log):
    frames, first = outputs["frames"], outputs["first"]
    w, h = outputs["width"], outputs["height"]
    n = len(frames)
    keys = [i for i, (_, p, _) in enumerate(frames) if p and not p[0] & 1]
    window = range(first, n)
    rng = random.Random(seed)
    samples = set(rng.sample(window, min(len(window),
                                         config["check_samples"])))
    in_window = [i for i in keys if i >= first]
    samples.add(in_window[-1] if in_window else keys[0] if keys else 0)
    log(f"closed loop: {n} frames ({n - first} in the window), keyframes "
        f"{keys}, sampled {sorted(samples)}")

    dec = Follower()
    q_off = errors = 0
    jobs = {}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(len(samples),
                                             os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        for i, (_, payload, _) in enumerate(frames):
            try:
                if i in samples:
                    _materialize(dec, lambda j: frames[j][2]())
                    jobs[i] = pool.submit(decode_sample, pickle.dumps(dec),
                                          payload)
                dec.follow = _Pending(i)
                dec.decode_frame_core(payload)
            except Exception as e:
                log(f"closed loop: the header chain broke at frame {i}: "
                    f"{e!r}")
                errors += 1 + len([s for s in samples if s > i])
                break
            if i >= first and dec.base_qindex != config["cq_level"]:
                q_off += 1
        mse, mb_mse = [], []
        hm, wm = h // 16 * 16, w // 16 * 16
        for i in window:
            clip_idx, _, recon = frames[i]
            src = outputs["source"][clip_idx][0].astype(np.int64)
            err = (src - recon()[0][:h, :w].astype(np.int64)) ** 2
            mse.append(float(err.mean()))
            mb_mse.append(float(err[:hm, :wm].reshape(
                hm // 16, 16, wm // 16, 16).mean((1, 3)).max()))
        mismatch = bpred_free = 0
        for i, job in sorted(jobs.items()):
            got = job.result()
            if isinstance(got, str):
                log(f"closed loop: frame {i} does not decode: {got}")
                errors += 1
                continue
            planes, bpred = got
            diff = sum(int((a != b).sum())
                       for a, b in zip(planes, frames[i][2]()))
            log(f"closed loop: frame {i} ({'key' if i in keys else 'inter'})"
                f": {diff} pixels differ from the encoder's reconstruction,"
                f" {bpred} B_PRED MBs")
            mismatch += diff
            bpred_free += i not in keys and bpred == 0
    mb_max = max(mb_mse) if mb_mse else float("inf")
    log(f"closed loop: luma MSE over {len(mse)} frames: frame mean "
        f"{float(np.mean(mse)) if mse else float('nan'):.4f}, frame max "
        f"{max(mse) if mse else float('nan'):.4f}, worst MB {mb_max:.4f}")
    inter = [len(frames[i][1]) for i in window if i not in keys]
    inter_bytes = sum(inter) / len(inter) if inter else float("inf")
    log(f"closed loop: {len(inter)} inter frames in the window, "
        f"{inter_bytes:.2f} payload bytes each; {bpred_free} sampled inter "
        "frames without a B_PRED MB")
    checks = [
        {"name": "recon_mismatch_px", "value": mismatch, "limit": 0},
        {"name": "sample_errors", "value": errors, "limit": 0},
        {"name": "qindex_off_frames", "value": q_off, "limit": 0},
        {"name": "mb_luma_mse_max", "value": mb_max,
         "limit": config["mb_luma_mse_limit"]},
    ]
    if "inter_bytes_limit" in traffic:
        checks.append({"name": "inter_bytes_per_frame", "value": inter_bytes,
                       "limit": traffic["inter_bytes_limit"]})
    if "bpred_free_samples_limit" in traffic:
        checks.append({"name": "bpred_free_samples", "value": bpred_free,
                       "limit": traffic["bpred_free_samples_limit"]})
    return checks
