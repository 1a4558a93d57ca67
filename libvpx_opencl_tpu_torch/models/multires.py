"""Multi-resolution simulcast encoding.

The reference's vpx_codec_enc_init_multi / mr_dissim flow
(vpx_encoder.h:701, mr_dissim.c, vp8e_mr_alloc_mem vp8_cx_iface.c:533):
the same content is encoded at several resolutions, and the lower
resolution's motion field seeds the higher resolution's search
(get_lower_res_motion_info, pickinter.c:397).

Each layer is a TorchEncoder on the CUDA card by default; use_device=False
encodes both with the host Encoder. The downsampling stays on the host.
"""
from __future__ import annotations

import functools

import numpy as np

from .encoder import Encoder


def downsample2(plane):
    """2x box downsample (the resampling role of vpx_scale)."""
    h, w = plane.shape
    h2, w2 = h // 2 * 2, w // 2 * 2
    p = plane[:h2, :w2].astype(np.uint16)
    return ((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] +
             p[1::2, 1::2] + 2) >> 2).astype(np.uint8)


class MultiResEncoder:
    """Simulcast at [full, half] resolutions (extendable to more levels)."""

    def __init__(self, width, height, qindices=(32, 28), device="cuda",
                 use_device=True, **kw):
        """use_device=True builds both layers as TorchEncoders on `device`
        (the default needs a CUDA card); use_device=False as host
        Encoders (the JAX class's behaviour)."""
        if use_device:
            from .torch_encoder import TorchEncoder
            make = functools.partial(TorchEncoder, device=device, **kw)
        else:
            make = functools.partial(Encoder, **kw)
        self.hi = make(width, height, qindex=qindices[0])
        self.lo = make(width // 2, height // 2, qindex=qindices[1])

    def encode_frame(self, y, u, v, keyframe=None):
        """Returns (hi_payload, lo_payload)."""
        ly, lu, lv = downsample2(y), downsample2(u), downsample2(v)
        lo_payload = self.lo.encode_frame(ly, lu, lv, keyframe=keyframe)
        # upscale the low-res motion field (x2 spatially, x2 magnitude)
        R, C = self.hi.R, self.hi.C
        hints = np.zeros((R, C, 2), np.int32)
        lo_mv = self.lo.mv[1:, 1:]
        for r in range(R):
            for c in range(C):
                lr, lc = min(r // 2, self.lo.R - 1), min(c // 2,
                                                         self.lo.C - 1)
                hints[r, c] = lo_mv[lr, lc] * 2
        self.hi.mv_hints = hints
        hi_payload = self.hi.encode_frame(y, u, v, keyframe=keyframe)
        return hi_payload, lo_payload
