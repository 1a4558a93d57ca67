"""The port's encoder at its default speed features (B_PRED and trellis on)
vs the JAX package: payload bytes equal (tolerance 0).

  * TorchEncoder(176, 144, qindex=24, device="cpu") with the default
    SpeedFeatures vs TPUEncoder on test_encoder.synth(176, 144, 3): payload
    bytes and reconstruction equal per frame, the closed loop exact against
    the port's RefDecoder, and frames 1-2 hold B_PRED MBs and inter MBs
    (which the trellis codes), so the content keeps covering both;
  * the port's CodecEncoder(EncoderConfig(176, 144), device="cpu") vs the
    JAX CodecEncoder(EncoderConfig(176, 144)) on the same frames, the rate
    controller picking each frame's qindex: packets equal; the port's PSNR
    packet is taken against the encoder's reconstruction;
  * one mid-stream inter frame through load_encoder_state;
  * the JAX CodecEncoder with USE_PSNR raises under TPUEncoder (the
    reason the port's PSNR packet reads the encoder's reconstruction).

The JAX default-speed encoder runs once per module (its B_PRED encode
wavefront is the slowest compile of the repository); the JAX CodecEncoder
reuses its compiled programs.
"""
import numpy as np
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu import api as japi
from libvpx_opencl_tpu.models.tpu_encoder import TPUEncoder
from libvpx_opencl_tpu_torch import api as tapi
from libvpx_opencl_tpu_torch.models import torch_encoder as TE
from libvpx_opencl_tpu_torch.models.encoder import SpeedFeatures
from libvpx_opencl_tpu_torch.models.refdec import INTRA_FRAME, RefDecoder
from libvpx_opencl_tpu_torch.ops.metrics import frame_psnr
from test_encoder import psnr, synth
from test_torch_encoder import _snapshot

torch.set_num_threads(1)
W, H, Q = 176, 144, 24


def _run(enc, frames, snapshot=None):
    out = []
    for y, u, v in frames:
        state = snapshot(enc) if snapshot else None
        payload = enc.encode_frame(y, u, v)
        out.append(dict(state=state, payload=payload,
                        recon=[np.array(p) for p in enc.ref_last.visible()],
                        mode=enc.mode[1:, 1:].copy(),
                        reff=enc.reff[1:, 1:].copy()))
    return out


@pytest.fixture(scope="module")
def frames():
    return synth(W, H, 3)


@pytest.fixture(scope="module")
def jax_run(frames):
    return _run(TPUEncoder(W, H, qindex=Q), frames, _snapshot)


@pytest.fixture(scope="module")
def torch_run(frames):
    enc = TE.TorchEncoder(W, H, qindex=Q, device="cpu")
    assert enc.sf == SpeedFeatures()            # bpred and trellis on
    return _run(enc, frames)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_payload_and_recon_match_jax(jax_run, torch_run, i):
    assert torch_run[i]["payload"] == jax_run[i]["payload"], \
        f"frame {i}: payload bytes differ"
    for g, w in zip(torch_run[i]["recon"], jax_run[i]["recon"]):
        np.testing.assert_array_equal(g, w)


def test_closed_loop_against_port_decoder(frames, torch_run):
    dec = type("D", (RefDecoder,), {"use_native": True})()
    for i, run in enumerate(torch_run):
        show, planes = dec.decode_frame(run["payload"])
        assert show == 1
        assert psnr(frames[i][0], planes[0]) > 33.0, i
        for g, w in zip(run["recon"], planes):
            assert np.array_equal(g, w), f"closed loop diverged, frame {i}"


def test_inter_frames_hold_bpred_and_trellis_macroblocks(jax_run, torch_run):
    """Keyframes never choose B_PRED; frames 1-2 must, and must hold inter
    MBs for the trellis, or the comparison above would not cover them."""
    assert not (torch_run[0]["mode"] == 4).any()
    for run, want in zip(torch_run[1:], jax_run[1:]):
        np.testing.assert_array_equal(run["mode"], want["mode"])
        assert (run["mode"] == 4).sum() >= 1
        assert (run["reff"] != INTRA_FRAME).sum() >= 1


def _codec_packets(mod, frames, **kw):
    enc = mod.CodecEncoder(mod.EncoderConfig(W, H), **kw)
    qs = []
    for f in frames:
        enc.encode(f)
        qs.append(enc._enc.qindex)
    return list(enc.get_cx_data()), qs


def test_codec_encoder_packets_match_jax(frames, jax_run):
    want, want_q = _codec_packets(japi, frames)
    got, got_q = _codec_packets(tapi, frames, flags=(tapi.USE_PSNR,),
                                device="cpu")
    assert got_q == want_q and len(set(got_q)) > 1, (got_q, want_q)
    frames_got = [p for p in got if p["kind"] == "frame"]
    assert frames_got == want
    # the PSNR packet follows its frame and is taken against the
    # reconstruction, which a decoder of the packets reproduces
    dec = type("D", (RefDecoder,), {"use_native": True})()
    for i, f in enumerate(frames):
        frame_pkt, psnr_pkt = got[2 * i], got[2 * i + 1]
        _, planes = dec.decode_frame(frame_pkt["data"])
        assert psnr_pkt == {"kind": "psnr",
                            "psnr": frame_psnr(f, planes)}, i


def test_mid_stream_frame_through_load_encoder_state(frames, jax_run):
    enc = TE.TorchEncoder(W, H, qindex=99, device="cpu")
    TE.load_encoder_state(enc, jax_run[2]["state"])
    assert enc.encode_frame(*frames[2]) == jax_run[2]["payload"]
    for g, w in zip(enc.ref_last.visible(), jax_run[2]["recon"]):
        np.testing.assert_array_equal(g, w)
    assert (enc.mode[1:, 1:] == 4).any()


def test_jax_codec_encoder_psnr_needs_the_host_decoder(frames, jax_run):
    """Why the port's PSNR packet reads the encoder's own reconstruction:
    the JAX class reads the host decoder's frame_to_show, which TPUEncoder
    never feeds, and raises on the first frame."""
    enc = japi.CodecEncoder(japi.EncoderConfig(W, H),
                            flags=(japi.USE_PSNR,))
    with pytest.raises(AttributeError, match="frame_to_show"):
        enc.encode(frames[0])
