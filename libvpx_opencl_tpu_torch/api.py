"""Codec-agnostic public API of the port (the vpx/ layer).

Twin of libvpx_opencl_tpu/api.py:
  * vpx_codec_dec_init / vpx_codec_decode / vpx_codec_get_frame
    (vpx/vpx_decoder.h:131,215,237)  ->  CodecDecoder, PostProcCfg
  * vpx_codec_enc_init / vpx_codec_encode / vpx_codec_get_cx_data
    (vpx/vpx_encoder.h:662,701)      ->  EncoderConfig, CodecEncoder
  * control IDs (vpx/vp8.h:41-47, vp8dx.h:53, vp8cx.h:126-180) -> methods
  * init-time flags (VPX_CODEC_USE_POSTPROC / USE_PSNR /
    USE_OUTPUT_PARTITION, vpx_decoder.h:68-71 / vpx_encoder.h:75-76)

Both classes run on a CUDA card by default (`device="cuda"`; the tests
pass "cpu"): CodecDecoder through TorchDecoder, CodecEncoder through
TorchEncoder. `use_device=False` (the JAX classes' use_tpu=False) picks
the host RefDecoder / Encoder instead. Frames and packets are identical
to the JAX classes' for the same input.

Frames are (y, u, v) uint8 numpy planes (the vpx_image_t role).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .models import refdec
from .models.encoder import Encoder
from .models.ratecontrol import RateController
from .models.torch_decoder import TorchDecoder, load_reference
from .models.torch_encoder import TorchEncoder
from .ops import postproc as PP
from .ops.metrics import frame_psnr
from .utils import trace

# init flags (vpx_decoder.h:68-71, vpx_encoder.h:75-76)
USE_POSTPROC = "postproc"
USE_ERROR_CONCEALMENT = "error_concealment"
USE_INPUT_FRAGMENTS = "input_fragments"
USE_PSNR = "psnr"
USE_OUTPUT_PARTITION = "output_partition"


@dataclass
class PostProcCfg:
    """vp8_postproc_cfg_t (vp8.h ppflags)."""
    flags: set = field(default_factory=set)
    deblocking_level: int = 4
    noise_level: int = 0


class CodecError(Exception):
    pass


class CodecDecoder:
    """vpx_codec_dec_init + vp8 decoder iface (vp8_dx_iface.c)."""

    def __init__(self, flags=(), threads=1, device="cuda", use_device=True):
        self.flags = set(flags)
        ec = USE_ERROR_CONCEALMENT in self.flags
        if use_device:
            self._dec = type("D", (TorchDecoder,),
                             {"ec_enabled": ec})(device=device)
        else:
            self._dec = type("D", (refdec.RefDecoder,),
                             {"use_native": True, "ec_enabled": ec})()
        self._pp = PostProcCfg()
        self._frames = []
        self._corrupted = False
        self._fragments = []
        self._mfqe_prev = None
        self._mfqe_qprev = None

    # --- vpx_codec_decode (vpx_decoder.h:215) ---
    def decode(self, data: bytes | None):
        """Feed one compressed frame (or a fragment when
        USE_INPUT_FRAGMENTS; None terminates the fragment group —
        onyxd_if.c:342-373 semantics). On the card a device failure
        surfaces at the next join of the dispatch worker or at the first
        pixel read of the frame, as in the JAX class."""
        if USE_INPUT_FRAGMENTS in self.flags:
            if data is not None:
                self._fragments.append(data)
                return
            data = b"".join(self._fragments)
            self._fragments = []
        if data is None:
            return
        try:
            show = self._dec.decode_frame_core(data)
            self._corrupted = bool(getattr(self._dec, "corrupted", False))
        except Exception as e:  # corrupt stream (EC disabled)
            self._corrupted = True
            raise CodecError(str(e)) from e
        if show:
            self._frames.append(self._dec.frame_to_show)

    # --- vpx_codec_get_frame (vpx_decoder.h:237) ---
    def get_frame(self):
        """Yield decoded frames since the last call (post-processed when
        USE_POSTPROC — vp8dx_get_raw_frame onyxd_if.c:707). Postproc and
        MFQE read the decoder's state (base_qindex, modes, MVs, frame type,
        reference frames) here, not at decode(): with two decodes before
        one get_frame both frames use the second frame's state, as in the
        JAX class."""
        frames, self._frames = self._frames, []
        for fb in frames:
            with trace.span("dec.get_frame", frame=getattr(fb, "frame",
                                                             None)):
                y, u, v = fb.visible()
                if USE_POSTPROC in self.flags and self._pp.flags:
                    y, u, v = PP.post_proc_frame(
                        y, u, v, self._dec.base_qindex, self._pp.flags,
                        self._pp.noise_level)
                    if "mfqe" in self._pp.flags:
                        # VP8D_MFQE (postproc.c:929-948): blend with the
                        # previous enhanced output on quality jumps
                        d = self._dec
                        cur = (np.asarray(y), np.asarray(u), np.asarray(v))
                        if (self._mfqe_prev is not None and
                                self._mfqe_qprev is not None and
                                d.base_qindex - self._mfqe_qprev >= 0):
                            y, u, v = PP.mfqe_frame(
                                cur, self._mfqe_prev, d.base_qindex,
                                self._mfqe_qprev, d.mode, d.mv,
                                keyframe=(d.frame_type == 0))
                        self._mfqe_prev = (np.asarray(y), np.asarray(u),
                                           np.asarray(v))
                        self._mfqe_qprev = d.base_qindex
                    y, u, v = PP.debug_overlay(
                        y, u, v, self._pp.flags,
                        mode=getattr(self._dec, "mode", None),
                        ref_frame=getattr(self._dec, "ref_frame", None),
                        mvs=getattr(self._dec, "mv", None))
                planes = np.asarray(y), np.asarray(u), np.asarray(v)
            yield planes

    # --- control calls ---
    def set_postproc(self, cfg: PostProcCfg):
        """VP8_SET_POSTPROC (vp8.h:43)."""
        self._pp = cfg

    def get_frame_corrupted(self):
        """VP8D_GET_FRAME_CORRUPTED (vp8dx.h:53, vp8_dx_iface.c:738)."""
        return self._corrupted

    def get_last_ref_updates(self):
        """VP8D_GET_LAST_REF_UPDATES: bitmask of refreshed buffers."""
        d = self._dec
        mask = 0
        if getattr(d, "refresh_last", 1):
            mask |= 1
        if getattr(d, "refresh_golden", 0):
            mask |= 2
        if getattr(d, "refresh_alt", 0):
            mask |= 4
        return mask

    def _join(self):
        """Join TorchDecoder's dispatch worker, which swaps the reference
        ring after decode() has returned. (The JAX class does not join
        TPUDecoder's worker here and can race its swap.)"""
        if isinstance(self._dec, TorchDecoder):
            self._dec._sync()

    def get_reference(self, which="last"):
        """vp8_get_reference (VP8_COPY_REFERENCE, onyxd_if.c:161)."""
        self._join()
        fb = {"last": self._dec.last, "golden": self._dec.golden,
              "altref": self._dec.altref}[which]
        return tuple(np.asarray(p) for p in fb.visible())

    def set_reference(self, which, planes):
        """vp8_set_reference (VP8_SET_REFERENCE, onyxd_if.c:192): the
        visible planes go into a bordered frame whose MB-aligned area and
        border come from extend_borders; on the card that frame is
        uploaded into the one slot, the other two stay where they are."""
        fb = refdec.FrameBuffer(self._dec.w, self._dec.h)
        vy, vu, vv = fb.visible()
        vy[:] = planes[0]
        vu[:] = planes[1]
        vv[:] = planes[2]
        fb.extend_borders()
        if isinstance(self._dec, TorchDecoder):
            load_reference(self._dec, which, (fb.y, fb.u, fb.v))
        else:
            setattr(self._dec, {"last": "last", "golden": "golden",
                                "altref": "altref"}[which], fb)


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
