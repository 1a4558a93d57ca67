"""Port encoder vs the JAX package: payload bytes equal (tolerance 0).

  * the copied host Encoder vs the original on two small frames;
  * the slice as a whole: TorchEncoder(176, 144, qindex=24, device="cpu")
    vs TPUEncoder under SLICE2_SF on test_encoder.synth(176, 144, 3):
    payload bytes and reconstruction equal per frame, closed loop against
    the port's RefDecoder; frame 2 searches a golden frame distinct from
    the last frame (multi_ref);
  * the ROI case of tests/test_tpu_encoder.py (per-segment quantizers and
    loop-filter deltas);
  * one mid-stream frame through load_encoder_state;
  * the recode contract (commit=False, then commit_frame), the step-2
    search without multi_ref (closed loop), the default device needs a
    card.

The default speed features (B_PRED and trellis on) are held against the
JAX class in tests/test_torch_encoder_default.py.

Each JAX reference runs once per module (the JAX encode wavefront is the
slowest compile of the repository), at one geometry.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.models import encoder as jenc
from libvpx_opencl_tpu.models.tpu_encoder import TPUEncoder
from libvpx_opencl_tpu_torch.models import encoder as tenc
from libvpx_opencl_tpu_torch.models import torch_encoder as TE
from libvpx_opencl_tpu_torch.models.refdec import GOLDEN_FRAME, RefDecoder
from test_encoder import psnr, synth

torch.set_num_threads(1)
W, H, Q = 176, 144, 24
JAX_SF = jenc.SpeedFeatures(**dataclasses.asdict(TE.SLICE2_SF))


def _snapshot(enc):
    """A TPUEncoder's state as plain numpy arrays and ints
    (load_encoder_state's input)."""
    frames = (enc.ref_last, enc.ref_gold, enc.ref_alt)
    return dict(
        refs=[tuple(np.asarray(p) for p in (f.y, f.u, f.v)) for f in frames],
        same=(enc.ref_gold is enc.ref_last, enc.ref_alt is enc.ref_last,
              enc.ref_alt is enc.ref_gold),
        prev_mv=np.array(enc.prev_mv), frame_count=enc.frame_count,
        qindex=enc.qindex, prob_intra=enc.prob_intra,
        prob_last=enc.prob_last, prob_gf=enc.prob_gf,
        prob_skip_false=enc.prob_skip_false,
        roi=None if enc.seg_map_enc is None else
        (np.array(enc.seg_map_enc), list(enc.seg_q_deltas),
         list(enc.seg_lf_deltas)))


def _run(enc, frames, snapshot=None):
    out = []
    for y, u, v in frames:
        state = snapshot(enc) if snapshot else None
        payload = enc.encode_frame(y, u, v)
        out.append(dict(state=state, payload=payload,
                        recon=[np.array(p) for p in enc.ref_last.visible()],
                        reff=enc.reff.copy()))
    return out


def _roi(enc):
    R, C = enc.R, enc.C
    seg = np.zeros((R, C), np.int32)
    seg[:R // 2] = 1
    seg[:, :C // 3] = 2
    enc.set_roimap(seg, q_deltas=[0, -20, 16, 0], lf_deltas=[0, 4, -6, 0])


@pytest.fixture(scope="module")
def frames():
    return synth(W, H, 3)


@pytest.fixture(scope="module")
def jax_run(frames):
    enc = TPUEncoder(W, H, qindex=Q)
    enc.sf = JAX_SF
    return _run(enc, frames, _snapshot)


@pytest.fixture(scope="module")
def torch_run(frames):
    enc = TE.TorchEncoder(W, H, qindex=Q, device="cpu")
    enc.sf = TE.SLICE2_SF
    return _run(enc, frames)


def test_host_encoder_copy_matches_original():
    small = synth(64, 48, 2, seed=4)
    a = jenc.Encoder(64, 48, qindex=30)
    b = tenc.Encoder(64, 48, qindex=30)
    for y, u, v in small:
        assert a.encode_frame(y, u, v) == b.encode_frame(y, u, v)


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


def test_multi_ref_frame_searches_a_distinct_golden(jax_run, torch_run):
    """Before frame 2 golden and altref still hold the keyframe while last
    holds frame 1: two references are searched, and both encoders pick
    the same ones."""
    assert jax_run[2]["state"]["same"] == (False, False, True)
    np.testing.assert_array_equal(torch_run[2]["reff"], jax_run[2]["reff"])
    assert (torch_run[1]["reff"] != GOLDEN_FRAME).all()


def test_roi_segmentation_matches_jax_and_closes_loop(frames):
    je = TPUEncoder(W, H, qindex=40)
    je.sf = JAX_SF
    te = TE.TorchEncoder(W, H, qindex=40, device="cpu")
    te.sf = TE.SLICE2_SF
    _roi(je)
    _roi(te)
    dec = type("D", (RefDecoder,), {"use_native": True})()
    for i, (y, u, v) in enumerate(frames):
        payload = te.encode_frame(y, u, v)
        assert payload == je.encode_frame(y, u, v), f"frame {i}"
        show, planes = dec.decode_frame(payload)
        for g, w in zip(te.ref_last.visible(), planes):
            assert np.array_equal(g, w), f"seg closed loop diverged, {i}"
    assert len(np.unique(dec.seg_map)) == 3


def test_mid_stream_frame_through_load_encoder_state(frames, jax_run):
    enc = TE.TorchEncoder(W, H, qindex=99, device="cpu")
    enc.sf = TE.SLICE2_SF
    TE.load_encoder_state(enc, jax_run[2]["state"])
    assert enc.ref_alt is enc.ref_gold and enc.ref_gold is not enc.ref_last
    assert enc.frame_count == 2 and enc.qindex == Q
    assert enc.encode_frame(*frames[2]) == jax_run[2]["payload"]
    for g, w in zip(enc.ref_last.visible(), jax_run[2]["recon"]):
        np.testing.assert_array_equal(g, w)


def test_load_encoder_state_rejects_wrong_geometry(jax_run):
    enc = TE.TorchEncoder(W + 16, H, qindex=Q, device="cpu")
    with pytest.raises(ValueError, match="reference plane"):
        TE.load_encoder_state(enc, jax_run[1]["state"])
    enc = TE.TorchEncoder(W, H, qindex=Q, device="cpu")
    state = dict(jax_run[1]["state"], prev_mv=np.zeros((5, 2), np.int32))
    with pytest.raises(ValueError, match="prev_mv"):
        TE.load_encoder_state(enc, state)
    state = dict(jax_run[1]["state"],
                 roi=(np.zeros((2, 2), np.int32), [0] * 4, [0] * 4))
    with pytest.raises(ValueError, match="ROI"):
        TE.load_encoder_state(enc, state)


def test_recode_discards_the_pending_frame(frames, torch_run):
    enc = TE.TorchEncoder(W, H, qindex=Q, device="cpu")
    enc.sf = TE.SLICE2_SF
    enc.encode_frame(*frames[0])
    enc.qindex = 60
    rejected = enc.encode_frame(*frames[1], commit=False)
    assert enc.frame_count == 1
    enc.qindex = Q
    payload = enc.encode_frame(*frames[1], commit=False)
    assert payload != rejected
    enc.commit_frame(payload)
    assert enc.frame_count == 2
    assert payload == torch_run[1]["payload"]
    for g, w in zip(enc.ref_last.visible(), torch_run[1]["recon"]):
        np.testing.assert_array_equal(g, w)


def test_step2_search_single_ref_closes_loop(frames, torch_run):
    enc = TE.TorchEncoder(W, H, qindex=Q, device="cpu")
    enc.sf = dataclasses.replace(TE.SLICE2_SF, exhaustive_me=False,
                                 multi_ref=False)
    dec = type("D", (RefDecoder,), {"use_native": True})()
    for i, (y, u, v) in enumerate(frames):
        payload = enc.encode_frame(y, u, v)
        show, planes = dec.decode_frame(payload)
        assert psnr(y, planes[0]) > 33.0, i
        for g, w in zip(enc.ref_last.visible(), planes):
            assert np.array_equal(g, w), f"closed loop diverged, frame {i}"
        assert (enc.reff != GOLDEN_FRAME).all()
    assert payload != torch_run[2]["payload"]


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.TorchEncoder(W, H, qindex=Q)
    with pytest.raises(ValueError, match="unsupported device"):
        TE.TorchEncoder(W, H, qindex=Q, device="meta")



def test_uv_inter_rd_matches_jax():
    """The chroma cost of one inter candidate (used by a row-sharded
    encoder's hooks): chroma MV derivation incl. negative components,
    MC, rate and distortion."""
    import jax.numpy as jnp
    from libvpx_opencl_tpu.models import tpu_encoder as JE
    from libvpx_opencl_tpu.models.encoder import _default_token_costs
    from libvpx_opencl_tpu.ops import predict as JP
    from libvpx_opencl_tpu.ops import rd_device as JRD
    from libvpx_opencl_tpu_torch.ops import rd_device as TRD
    rng = np.random.default_rng(3)
    R, C = 4, 6
    N = R * C
    ref = rng.integers(0, 256, (2, R * 8 + 32, C * 8 + 32)).astype(np.uint8)
    ub, vb = rng.integers(0, 256, (2, N, 8, 8)).astype(np.int32)
    mv8 = (rng.integers(-40, 41, (N, 2)) * 2).astype(np.int32)
    taps = np.asarray(JP.SIXTAP_TABLE, np.int32)
    dqu = rng.integers(4, 158, (N, 2)).astype(np.int32)
    qidx = rng.integers(0, 128, N).astype(np.int32)
    tc = _default_token_costs()
    want = JE._uv_inter_rd(R, C, *(jnp.asarray(a) for a in (
        ref[0], ref[1], ub, vb, mv8, taps, dqu, qidx)),
        JRD.banded_token_costs(tc, 2))
    got = TE._uv_inter_rd(R, C, *(torch.from_numpy(a) for a in (
        ref[0], ref[1], ub, vb, mv8, taps, dqu, qidx)),
        TRD.banded_token_costs(tc, 2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("qindex", [4, 24])
def test_uv_intra_rd_matches_jax(qindex):
    """The chroma intra-mode decision against the jitted JAX function, as
    the JAX encoder runs it: at qindex 4 rddiv is 100 and the RD costs of
    random blocks pass 2^24, where rdc's rounding decides near-ties."""
    import jax
    import jax.numpy as jnp
    from libvpx_opencl_tpu.models import rdopt
    from libvpx_opencl_tpu.models import tpu_encoder as JE
    from libvpx_opencl_tpu.models.encoder import _default_token_costs
    from libvpx_opencl_tpu.ops import rd_device as JRD
    from libvpx_opencl_tpu_torch.ops import rd_device as TRD
    rng = np.random.default_rng(qindex)
    R, C = 4, 6
    N = R * C
    pl = rng.integers(0, 256, (2, R * 8 + 32, C * 8 + 32)).astype(np.uint8)
    ub, vb = rng.integers(0, 256, (2, N, 8, 8)).astype(np.int32)
    dqu = rng.integers(4, 158, (N, 2)).astype(np.int32)
    qidx = np.full(N, qindex, np.int32)
    cost = rng.integers(0, 600, 4).astype(np.int32)
    rdm, rdd, _ = rdopt.rd_consts(qindex)
    tc = _default_token_costs()
    want = jax.jit(JE._uv_intra_rd, static_argnums=(0, 1))(
        R, C, *(jnp.asarray(a) for a in (pl[0], pl[1], ub, vb, dqu, qidx)),
        JRD.banded_token_costs(tc, 2), jnp.asarray(cost), jnp.float32(rdm),
        jnp.float32(rdd))
    got = TE._uv_intra_rd(
        R, C, *(torch.from_numpy(a) for a in (pl[0], pl[1], ub, vb, dqu,
                                              qidx)),
        TRD.banded_token_costs(tc, 2), torch.from_numpy(cost),
        torch.tensor(float(rdm)), torch.tensor(float(rdd)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
