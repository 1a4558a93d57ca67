"""Codec-agnostic public API of the port: the encoder half.

Twin of libvpx_opencl_tpu/api.py's encoder interface (vpx_codec_enc_init /
vpx_codec_encode / vpx_codec_get_cx_data, vpx/vpx_encoder.h:662,701;
control IDs vp8cx.h:126-180): `EncoderConfig` and `CodecEncoder`, plus
`CodecError` and the init-flag names. `CodecEncoder` drives TorchEncoder
on a CUDA card by default (`device="cuda"`; the tests pass "cpu"), or the
host Encoder when the caller asks for it (`use_device=False`, the JAX
class's use_tpu=False). Packets are identical to the JAX class's for the
same frames and configuration.

Frames are (y, u, v) uint8 numpy planes (the vpx_image_t role).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .models.encoder import Encoder
from .models.ratecontrol import RateController
from .models.torch_encoder import TorchEncoder
from .ops.metrics import frame_psnr

# init flags (vpx_decoder.h:68-71, vpx_encoder.h:75-76)
USE_POSTPROC = "postproc"
USE_ERROR_CONCEALMENT = "error_concealment"
USE_INPUT_FRAGMENTS = "input_fragments"
USE_PSNR = "psnr"
USE_OUTPUT_PARTITION = "output_partition"


class CodecError(Exception):
    pass


@dataclass
class EncoderConfig:
    """vpx_codec_enc_cfg_t essentials (vpx_encoder.h / vp8_cx_iface.c:138)."""
    width: int = 0
    height: int = 0
    target_bitrate: int = 256           # rc_target_bitrate (kbps)
    end_usage: str = "vbr"              # rc_end_usage
    cq_level: int = 24                  # VP8E_SET_CQ_LEVEL
    min_quantizer: int = 4
    max_quantizer: int = 63
    kf_max_dist: int = 128              # kf_max_dist
    kf_min_dist: int = 0
    token_partitions: int = 0           # VP8E_SET_TOKEN_PARTITIONS (log2)
    fps: tuple = (30, 1)
    threads: int = 1


class CodecEncoder:
    """vpx_codec_enc_init + vp8 encoder iface (vp8_cx_iface.c)."""

    def __init__(self, cfg: EncoderConfig, flags=(), device="cuda",
                 use_device=True):
        if cfg.width <= 0 or cfg.height <= 0:
            raise CodecError("invalid frame size")
        self.cfg = cfg
        self.flags = set(flags)
        kw = dict(qindex=cfg.cq_level, token_parts=cfg.token_partitions)
        self._enc = TorchEncoder(cfg.width, cfg.height, device=device,
                                 **kw) if use_device else \
            Encoder(cfg.width, cfg.height, **kw)
        self._rc = None
        if cfg.end_usage in ("vbr", "cbr"):
            mb = ((cfg.height + 15) // 16) * ((cfg.width + 15) // 16)
            self._rc = RateController(cfg.target_bitrate,
                                      cfg.fps[0] / max(1, cfg.fps[1]), mb,
                                      min_q=cfg.min_quantizer,
                                      max_q=cfg.max_quantizer)
        self._packets = []
        self._count = 0

    # --- vpx_codec_encode (vpx_encoder.h:884) ---
    def encode(self, frame, pts=None, flags=()):
        """frame = (y, u, v) planes or None to flush. flags may include
        'force_kf' (VPX_EFLAG_FORCE_KF)."""
        if frame is None:
            return
        y, u, v = frame
        kf = ("force_kf" in flags or self._count == 0 or
              (self.cfg.kf_max_dist and
               self._count % max(1, self.cfg.kf_max_dist) == 0))
        if self._rc is not None:
            self._enc.qindex = self._rc.frame_q(kf)
        payload = self._enc.encode_frame(y, u, v, keyframe=kf)
        if self._rc is not None:
            self._rc.update(self._enc.qindex, len(payload) * 8, kf)
        if USE_OUTPUT_PARTITION in self.flags:
            # one VPX_FRAME_IS_FRAGMENT packet per partition
            # (vpx_encoder.h:76,122; vp8e pack loop vp8_cx_iface.c)
            chunks = getattr(self._enc, "last_partition_bytes",
                             None) or [payload]
            for i, chunk in enumerate(chunks):
                self._packets.append(
                    {"kind": "frame", "data": chunk,
                     "pts": pts or self._count, "keyframe": kf,
                     "partition_id": i,
                     "fragment": i < len(chunks) - 1})
        else:
            self._packets.append({"kind": "frame", "data": payload,
                                  "pts": pts or self._count, "keyframe": kf})
        if USE_PSNR in self.flags:
            self._packets.append({"kind": "psnr", "psnr": frame_psnr(
                (y, u, v), self._ref_planes())})
        self._count += 1

    def _ref_planes(self):
        """The reconstruction a decoder shows for the frame just encoded.
        TorchEncoder keeps it on the device (`frame_to_show`); the host
        Encoder decodes its own payload. (The JAX class reads the host
        decoder's frame under TPUEncoder too, which that encoder never
        feeds, and raises AttributeError.)"""
        e = self._enc
        if isinstance(e, TorchEncoder):
            return e.frame_to_show.visible()
        return e.dec.frame_to_show.visible()

    # --- vpx_codec_get_cx_data (vpx_encoder.h:941) ---
    def get_cx_data(self):
        pkts, self._packets = self._packets, []
        yield from pkts

    # --- control calls (vp8cx.h:126-180) ---
    def set_cq_level(self, q):
        self.cfg.cq_level = q
        self._enc.qindex = q

    def set_token_partitions(self, log2n):
        self._enc.token_parts = log2n

    def set_roimap(self, seg_map, q_deltas, lf_deltas=(0, 0, 0, 0)):
        """VP8E_SET_ROI_MAP (vp8cx.h, vp8_set_roimap onyx_if.c:5112)."""
        self._enc.set_roimap(seg_map, q_deltas, lf_deltas)

    def set_active_map(self, active_map):
        """VP8E_SET_ACTIVEMAP (vp8_set_active_map onyx_if.c:5155):
        inactive MBs are forced to segment 3 with a strong q delta (the
        static-region treatment)."""
        m = np.asarray(active_map, bool)
        seg = np.where(m, 0, 3).astype(np.int32)
        self._enc.set_roimap(seg, q_deltas=(0, 0, 0, 40))
