"""Temporal scalability (layers) — the reference's per-layer RC contexts and
encode patterns (onyx_if.c:226-304 save/restore_layer_context,
update_layer_contexts :1336; patterns from vp8_scalable_patterns.c).

A pattern assigns each frame a temporal layer; base-layer (L0) frames
refresh LAST (and periodically GOLDEN) while enhancement-layer frames leave
all references untouched, so decoding only the L0 frames yields a valid
lower-rate stream.
"""
from __future__ import annotations

from .ratecontrol import RateController

# frame-pattern templates: layer id per position (vp8_scalable_patterns.c)
PATTERNS = {
    "L1T2": [0, 1],              # 2 layers, alternating
    "L1T3": [0, 2, 1, 2],        # 3 layers, dyadic
}


class TemporalLayerEncoder:
    """Drives an Encoder with a temporal pattern + per-layer rate control."""

    def __init__(self, enc, pattern="L1T2", layer_bitrates_kbps=(128, 256),
                 fps=30.0):
        self.enc = enc
        self.pattern = PATTERNS[pattern] if isinstance(pattern, str) \
            else list(pattern)
        self.n_layers = max(self.pattern) + 1
        mb = enc.R * enc.C
        # per-layer contexts (save/restore_layer_context onyx_if.c:226-304
        # made implicit by one RateController per layer): layer i's
        # target is the CUMULATIVE bitrate of layers <= i, and its frame
        # rate is the layer's effective rate within the pattern
        # (cpi->layer_context[i].frame_rate, onyx_if.c:1336)
        self.rc = []
        for i in range(self.n_layers):
            frames_in = sum(1 for p in self.pattern if p <= i)
            layer_fps = fps * frames_in / len(self.pattern)
            self.rc.append(RateController(layer_bitrates_kbps[i],
                                          max(layer_fps, 1e-3), mb))
        self.idx = 0

    def encode_frame(self, y, u, v):
        layer = self.pattern[self.idx % len(self.pattern)]
        keyframe = self.idx == 0
        rc = self.rc[layer]
        self.enc.qindex = rc.frame_q(keyframe)
        payload = self.enc.encode_frame(
            y, u, v, keyframe=keyframe,
            refresh_last=(layer == 0),
            refresh_golden=keyframe)
        # update every layer context that includes this frame's layer
        for li in range(layer, self.n_layers):
            self.rc[li].update(self.enc.qindex, len(payload) * 8, keyframe)
        self.idx += 1
        return payload, layer
