"""ARNR temporal filter — altref frame synthesis.

Implements the reference's motion-compensated temporal blur
(vp8/encoder/temporal_filter.c): for each MB of the altref anchor frame,
every window frame is motion-matched (find_matching_mb, :139) and
accumulated with per-pixel weights 16 - clip((3*d^2 + 2^(s-1)) >> s, 0, 16)
scaled by a per-MB match weight 2/1/0 from the match error thresholds
(:608: err < 10000 -> 2, < 20000 -> 1, else skipped), then normalized with
rounded division (:668). The synthesized frame is encoded as an invisible
ALTREF update (show_frame=0, refresh_alternate=1) that later frames can
predict from (onyx_if.c:4624-4649 scheduling).
"""
from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

THRESH_LOW = 10000
THRESH_HIGH = 20000


def _pad(plane, pad):
    return np.pad(plane, pad, mode="edge")


def _pad16(plane):
    """Edge-pad a plane up to multiples of 16."""
    h, w = plane.shape
    H, W = (h + 15) // 16 * 16, (w + 15) // 16 * 16
    return np.pad(plane, ((0, H - h), (0, W - w)), mode="edge")


def _match_all(anchor16, ref16, mc_range):
    """Whole-frame vectorized +-mc_range full-pel match
    (find_matching_mb, temporal_filter.c:139) via the shared step-2 grid
    + refine matcher.  Planes must be padded to multiples of 16.
    Returns (dy, dx, sse) arrays [R, C]."""
    from .me_host import fullpel_match
    dy, dx, sse, _ = fullpel_match(anchor16, ref16, mc_range)
    return dy, dx, sse


def _weighted_accumulate(base, pred, strength, weight, accum, count):
    """vp8_temporal_filter_apply_c (temporal_filter.c:88-135),
    vectorized over a whole plane."""
    d = pred.astype(np.int32) - base.astype(np.int32)
    mod = (d * d * 3 + (1 << (strength - 1))) >> strength
    mod = 16 - np.minimum(mod, 16)
    mod = mod * weight
    accum += mod * pred.astype(np.int32)
    count += mod


def _torch_device(device):
    """synthesize_altref's `device`: None for the NumPy path (False or
    None), else the torch.device to run on, True meaning "cuda"."""
    if device is None or device is False:
        return None
    import torch
    return torch.device("cuda" if device is True else device)


def synthesize_altref(frames, alt_index, strength=6, max_frames=5,
                      mc_range=7, device=False):
    """Synthesize the altref planes from `frames` (list of (y,u,v) uint8)
    centered at alt_index (center blur, arnr_type 3 of
    vp8_temporal_filter_prepare_c, temporal_filter.c:431-505).

    device=False runs the NumPy path. Otherwise the motion match and the
    weighted accumulation run as torch ops (ops/analysis_device.py, the
    vp8_temporal_filter SIMD-backend role) on `device`: a device name or
    torch.device, True meaning "cuda". Both paths give the same planes
    (tests/test_torch_analysis.py).

    Returns (y, u, v) uint8 numpy planes of the filtered frame."""
    dev = _torch_device(device)
    if dev is not None:
        import torch
        from ..ops import analysis_device as _AD

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n = len(frames)
    avail_back = alt_index
    avail_fwd = n - alt_index - 1
    m = min(avail_back, avail_fwd)      # center blur equalizes both sides
    fwd = min(m, (max_frames - 1) // 2)
    back = min(m, max_frames // 2)
    window = list(range(alt_index - back, alt_index + fwd + 1))

    cur = [np.asarray(p) for p in frames[alt_index][:3]]
    cy, cu, cv = cur
    h, w = cy.shape
    R, C = (h + 15) // 16, (w + 15) // 16

    if dev is None:
        acc = [np.zeros(p.shape, np.int32) for p in cur]
        cnt = [np.zeros(p.shape, np.int32) for p in cur]
    else:
        base = [up(p) for p in cur]
        cy16 = up(_pad16(cy))
        acc = [torch.zeros(p.shape, dtype=torch.int32, device=dev)
               for p in cur]
        cnt = [torch.zeros_like(a) for a in acc]

    for fi in window:
        fy, fu, fv = [np.asarray(p) for p in frames[fi][:3]]
        if fi == alt_index:
            wmap = np.full((R, C), 2, np.int32)
            py, pu, pv = fy, fu, fv
        else:
            # whole-frame vectorized match on the 16-padded grid
            if dev is not None:
                dy, dx, sse = [x.cpu().numpy() for x in
                               _AD.fullpel_match_device(
                                   cy16, up(_pad16(fy)), mc_range)[:3]]
            else:
                dy, dx, sse = _match_all(_pad16(cy), _pad16(fy), mc_range)
            wmap = np.where(sse < THRESH_LOW, 2,
                            np.where(sse < THRESH_HIGH, 1, 0)) \
                .astype(np.int32)
            # gather the matched luma predictions for every MB at once
            pyp16 = np.pad(_pad16(fy), mc_range, mode="edge")
            ywins = sliding_window_view(pyp16, (16, 16))
            rr = np.arange(R)[:, None] * 16
            cc = np.arange(C)[None, :] * 16
            predy = ywins[rr + dy + mc_range, cc + dx + mc_range]
            py = predy.transpose(0, 2, 1, 3).reshape(R * 16,
                                                     C * 16)[:h, :w]
            # chroma: nearest full-pel of mv/2 (round away from zero)
            cdy = np.where(dy >= 0, (dy + 1) // 2, (dy - 1) // 2)
            cdx = np.where(dx >= 0, (dx + 1) // 2, (dx - 1) // 2)
            hp = (mc_range + 1) // 2 + 1
            pup16 = np.pad(_pad16(fu)[:R * 8, :C * 8], hp, mode="edge")
            pvp16 = np.pad(_pad16(fv)[:R * 8, :C * 8], hp, mode="edge")
            uwins = sliding_window_view(pup16, (8, 8))
            vwins = sliding_window_view(pvp16, (8, 8))
            crr = np.arange(R)[:, None] * 8
            ccc = np.arange(C)[None, :] * 8
            predu = uwins[crr + cdy + hp, ccc + cdx + hp]
            predv = vwins[crr + cdy + hp, ccc + cdx + hp]
            pu = predu.transpose(0, 2, 1, 3).reshape(
                R * 8, C * 8)[:cu.shape[0], :cu.shape[1]]
            pv = predv.transpose(0, 2, 1, 3).reshape(
                R * 8, C * 8)[:cv.shape[0], :cv.shape[1]]

        # per-pixel weight maps from the per-MB match weights
        wy = np.repeat(np.repeat(wmap, 16, 0), 16, 1)[:h, :w]
        wc = np.repeat(np.repeat(wmap, 8, 0), 8, 1)[:cu.shape[0],
                                                    :cu.shape[1]]
        for k, (pred, wgt) in enumerate(((py, wy), (pu, wc), (pv, wc))):
            if dev is not None:
                acc[k], cnt[k] = _AD.temporal_filter_apply_device(
                    base[k], up(pred), strength, up(wgt), acc[k], cnt[k])
            else:
                _weighted_accumulate(cur[k], pred, strength, wgt, acc[k],
                                     cnt[k])

    if dev is not None:
        return tuple(_AD.temporal_filter_normalize_device(a, c, b)
                     .cpu().numpy() for a, c, b in zip(acc, cnt, base))

    def norm(acc, cnt, base):
        cnt1 = np.maximum(cnt, 1)
        out = (acc + (cnt1 >> 1)) // cnt1
        # pixels with no contributions keep the anchor value
        return np.where(cnt > 0, out, base).astype(np.uint8)

    return tuple(norm(a, c, b) for a, c, b in zip(acc, cnt, cur))


def _arnr_device(enc):
    """synthesize_altref's `device` for an altref encode with `enc`: the
    TorchEncoder's own device, so that ARNR runs where the encoder does;
    False (the NumPy path) for the host Encoder, as in the reference."""
    from .torch_encoder import TorchEncoder
    return enc.device if isinstance(enc, TorchEncoder) else False


def encode_stream_altref(enc, rc, frames_iter, lag=16, gf_interval=8,
                         max_frames=5, strength=6):
    """Streaming --auto-alt-ref encode: raw frames flow through a
    Lookahead ring of depth `lag` (vp8_lookahead_push/peek/pop,
    lookahead.c:63-208); at each GF boundary the ARNR window is built
    from lookahead peeks, so memory is bounded by the lag instead of the
    clip length (the onyx_if.c:4534/4624 source-buffering structure).
    Returns the payload list (invisible ARFs included)."""
    from .lookahead import Lookahead
    from .ratecontrol import encode_frame_with_rc
    la = Lookahead(max_lag=max(lag, max_frames + 2))
    payloads = []
    idx = 0
    it = iter(frames_iter)
    done = False
    while True:
        while not la.full() and not done:
            try:
                f = next(it)
            except StopIteration:
                done = True
                break
            la.push(f[0], f[1], f[2])
        if la.depth() == 0:
            break
        kf = rc.want_keyframe() if rc is not None else (idx == 0)
        if idx % gf_interval == 0 and not kf and la.depth() > 2:
            center = min(gf_interval, la.depth() - 1)
            window = [la.peek(j)[:3] for j in range(la.depth())]
            ay, au, av = synthesize_altref(window, center,
                                           strength=strength,
                                           max_frames=max_frames,
                                           device=_arnr_device(enc))
            saved_q = enc.qindex
            if rc is not None:
                target = rc.frame_target(False, golden=True) * 3
                q = rc.regulate_q(target, False, golden=True)
                enc.qindex = q
            else:
                q = max(4, saved_q * 3 // 5)
                enc.qindex = q
            p = enc.encode_frame(ay, au, av, keyframe=False, show=False,
                                 refresh_alt=True, refresh_last=False)
            enc.qindex = saved_q
            if rc is not None:
                rc.frame_done(q, len(p) * 8, False, golden=True)
            payloads.append(p)
        y, u, v, _pts = la.pop()
        if rc is not None:
            p = encode_frame_with_rc(enc, rc, y, u, v, keyframe=kf)
        else:
            p = enc.encode_frame(y, u, v, keyframe=kf)
        if p:                     # b"" = RC dropped the frame, no packet
            payloads.append(p)
        idx += 1
    return payloads


def encode_twopass_altref(enc, tp, frames, strength=6, max_frames=5):
    """Two-pass encode with pass-1-driven ARF placement: at each GF-group
    boundary found by define_gf_group (firstpass.c:1250 role) an ARNR-
    filtered frame anchored at the group's far end is encoded as an
    invisible ALTREF update at a gfu-boosted (lower) quantizer; golden
    frames inside the group take their boosted bit share via
    TwoPassController.frame_target.  Returns the payload list."""
    payloads = []
    for i, f in enumerate(frames):
        y, u, v = f[:3]
        kf = tp.want_keyframe()
        center = tp.arf_center_of.get(i)
        if (tp.auto_altref and not kf and center is not None and
                center > i + 1):
            ay, au, av = synthesize_altref(frames, center,
                                           strength=strength,
                                           max_frames=max_frames,
                                           device=_arnr_device(enc))
            gb = min(tp.gf_boosts.get(i, 12.0), 48.0)
            target = tp.frame_target(False) * (1.0 + gb / 8.0)
            q = tp.rc.regulate_q(target, False, golden=True)
            saved_q = enc.qindex
            enc.qindex = q
            p = enc.encode_frame(ay, au, av, keyframe=False, show=False,
                                 refresh_alt=True, refresh_last=False)
            enc.qindex = saved_q
            tp.arf_done(q, len(p) * 8)
            payloads.append(p)
        q = tp.frame_q(kf)
        enc.qindex = q
        p = enc.encode_frame(y, u, v, keyframe=kf)
        tp.update(q, len(p) * 8, kf)
        payloads.append(p)
    return payloads


def encode_sequence_altref(enc, rc, frames, gf_interval=8, max_frames=5,
                           strength=6):
    """Encode a frame sequence with periodic ARNR altref synthesis
    (the --auto-alt-ref pipeline: onyx_if.c:4624-4649 scheduling in
    display-order form). At each GF-group start a filtered future frame is
    encoded as an invisible ALTREF update; the following frames may
    predict from it. Returns the list of payloads (invisible ARF frames
    included — they carry show_frame=0)."""
    from .ratecontrol import encode_frame_with_rc
    payloads = []
    n = len(frames)
    for i, f in enumerate(frames):
        y, u, v = f[:3]
        kf = rc.want_keyframe() if rc is not None else (i == 0)
        if i % gf_interval == 0 and not kf and i + 1 < n:
            center = min(i + gf_interval, n - 1)
            ay, au, av = synthesize_altref(frames, center,
                                           strength=strength,
                                           max_frames=max_frames,
                                           device=_arnr_device(enc))
            # the ARF is a long-lived reference: encode it at a boosted
            # (lower) quantizer so prediction from it is high-fidelity
            # (the gfu_boost role, calc_gf_params ratectrl.c:448; without
            # the boost the ARF's quantization noise cancels the ARNR
            # denoising gain entirely)
            saved_q = enc.qindex
            if rc is not None:
                target = rc.frame_target(False, golden=True) * 3
                q = rc.regulate_q(target, False, golden=True)
                enc.qindex = q
            else:
                q = max(4, saved_q * 3 // 5)
                enc.qindex = q
            p = enc.encode_frame(ay, au, av, keyframe=False, show=False,
                                 refresh_alt=True, refresh_last=False)
            enc.qindex = saved_q
            if rc is not None:
                rc.frame_done(q, len(p) * 8, False, golden=True)
            payloads.append(p)
        if rc is not None:
            p = encode_frame_with_rc(enc, rc, y, u, v, keyframe=kf)
        else:
            p = enc.encode_frame(y, u, v, keyframe=kf)
        if p:                     # b"" = RC dropped the frame, no packet
            payloads.append(p)
    return payloads
