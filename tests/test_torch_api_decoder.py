"""The port's decoder API (libvpx_opencl_tpu_torch/api.py: CodecDecoder,
PostProcCfg) vs the JAX package's CodecDecoder with use_tpu=False, on
every case of tests/test_api_examples.py and tests/test_error_concealment.py
that uses CodecDecoder. Each case runs the same calls through three
decoders: the JAX host class, the port on TorchDecoder (device="cpu",
the kernels' plain versions) and the port's host class
(use_device=False); every plane, flag and mask they return must be equal.
Also: golden MD5s, the reference controls join the dispatch worker, and
the default device needs a card.
"""
import time

import numpy as np
import pytest
import torch

from conftest import vector
from libvpx_opencl_tpu import api as japi
from libvpx_opencl_tpu_torch import api as tapi
from libvpx_opencl_tpu_torch.models import torch_decoder as TD
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
from libvpx_opencl_tpu_torch.utils.md5 import frame_md5, load_golden_md5s

KINDS = ("jax", "port", "port_host")


def _decoder(kind, flags=()):
    if kind == "jax":
        return japi.CodecDecoder(flags=flags, use_tpu=False)
    if kind == "port":
        return tapi.CodecDecoder(flags=flags, device="cpu")
    return tapi.CodecDecoder(flags=flags, use_device=False)


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype and
                np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b) and
                all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def _all_equal(drive, flags=()):
    """Run drive(decoder) on the three decoders; their records must be
    equal. Returns the port's record."""
    out = {k: drive(_decoder(k, flags)) for k in KINDS}
    for k in KINDS[1:]:
        assert _same(out[k], out["jax"]), f"{k} differs from the JAX class"
    return out["port"]


def _frames(name):
    return read_ivf(vector(name)).frames


@pytest.mark.parametrize("name", ["kf_qcif", "inter_qcif", "odd_65x49"])
def test_golden_md5s(name):
    def drive(dec):
        rec = []
        for payload, _ in _frames(f"{name}.ivf"):
            dec.decode(payload)
            rec += [tuple(f) for f in dec.get_frame()]
        return rec

    got = _all_equal(drive)
    assert [frame_md5(*f) for f in got] == \
        load_golden_md5s(vector(f"{name}.ivf.md5"))


def test_input_fragments():
    def drive(dec):
        rec = []
        for payload, _ in _frames("kf_qcif.ivf"):
            half = len(payload) // 2
            dec.decode(payload[:half])
            dec.decode(payload[half:])
            assert not list(dec.get_frame())   # group not closed yet
            dec.decode(None)
            rec += [tuple(f) for f in dec.get_frame()]
        return rec

    got = _all_equal(drive, flags=(tapi.USE_INPUT_FRAGMENTS,))
    assert [frame_md5(*f) for f in got] == \
        load_golden_md5s(vector("kf_qcif.ivf.md5"))


PP_FLAGS = [({"deblock"}, 0), ({"deblock", "addnoise"}, 2),
            ({"deblock", "mfqe"}, 0), ({"deblock", "addnoise", "mfqe"}, 3),
            ({"debug_clr_blk_modes"}, 0), ({"debug_clr_frm_ref_blks"}, 0),
            ({"debug_draw_mv"}, 0),
            ({"debug_clr_blk_modes", "debug_clr_frm_ref_blks"}, 0)]


@pytest.mark.parametrize("pp,noise", PP_FLAGS,
                         ids=["+".join(sorted(f)) for f, _ in PP_FLAGS])
def test_postproc_exact(pp, noise):
    def drive(dec):
        mod = japi if isinstance(dec, japi.CodecDecoder) else tapi
        dec.set_postproc(mod.PostProcCfg(flags=set(pp), noise_level=noise))
        rec = []
        for payload, _ in _frames("inter_qcif.ivf")[:5]:
            dec.decode(payload)
            rec += [tuple(f) for f in dec.get_frame()]
        return rec

    got = _all_equal(drive, flags=(tapi.USE_POSTPROC,))
    assert len(got) == 5 and got[0][0].shape == (144, 176)


def test_mfqe_two_decodes_before_one_get_frame():
    """Postproc and MFQE read the decoder's state at get_frame, not at
    decode: with two decodes before one get_frame, both frames are
    post-processed with the second frame's state (a reference quirk)."""
    def drive(dec):
        mod = japi if isinstance(dec, japi.CodecDecoder) else tapi
        dec.set_postproc(mod.PostProcCfg(flags={"deblock", "mfqe",
                                                "debug_clr_blk_modes"}))
        frames = _frames("inter_qcif.ivf")
        rec = []
        for i in range(0, 6, 2):
            dec.decode(frames[i][0])
            dec.decode(frames[i + 1][0])
            rec.append([tuple(f) for f in dec.get_frame()])
        return rec

    got = _all_equal(drive, flags=(tapi.USE_POSTPROC,))
    assert [len(r) for r in got] == [2, 2, 2]


@pytest.mark.parametrize("name", ["inter_qcif", "odd_65x49"])
def test_get_set_reference(name):
    """Snapshot LAST, decode two frames, roll LAST back and decode on: on
    an odd size the aligned area past the visible edge comes from
    extend_borders, and the next inter frames must decode the same."""
    def drive(dec):
        frames = _frames(f"{name}.ivf")
        rec = []
        dec.decode(frames[0][0])
        rec += [tuple(f) for f in dec.get_frame()]
        snap = dec.get_reference("last")
        for payload, _ in frames[1:3]:
            dec.decode(payload)
            rec += [tuple(f) for f in dec.get_frame()]
        after = dec.get_reference("last")
        dec.set_reference("last", snap)
        back = dec.get_reference("last")
        rec += [snap, after, back, dec.get_reference("golden"),
                dec.get_reference("altref")]
        dec.set_reference("golden", after)
        for payload, _ in frames[3:6]:
            dec.decode(payload)
            rec += [tuple(f) for f in dec.get_frame()]
            rec.append(dec.get_reference("golden"))
        return rec

    got = _all_equal(drive)
    snap, after, back = got[3:6]
    assert not np.array_equal(snap[0], after[0])
    assert all(np.array_equal(a, b) for a, b in zip(snap, back))


def test_get_last_ref_updates():
    def drive(dec):
        masks = []
        for payload, _ in _frames("inter_qcif.ivf"):
            dec.decode(payload)
            masks.append(dec.get_last_ref_updates())
        return masks

    masks = _all_equal(drive)
    assert masks[0] == 7 and all(1 <= m <= 7 for m in masks)


def test_output_partition_fragments():
    """Per-partition packets of the host encoder, fed as input fragments,
    decode like the whole frame."""
    rng = np.random.RandomState(3)
    frames = [(rng.randint(0, 255, (64, 96), np.uint8),
               np.full((32, 48), 128, np.uint8),
               np.full((32, 48), 128, np.uint8)) for _ in range(3)]
    cfg = tapi.EncoderConfig(width=96, height=64, token_partitions=2,
                             end_usage="cq")
    enc = tapi.CodecEncoder(cfg, flags=(tapi.USE_OUTPUT_PARTITION,),
                            use_device=False)
    packets = []
    for i, f in enumerate(frames):
        enc.encode(f, pts=i)
        packets.append([p["data"] for p in enc.get_cx_data()
                        if p["kind"] == "frame"])
    assert [len(p) for p in packets] == [5, 5, 5]

    def drive(dec):
        rec = []
        for pkts in packets:
            for p in pkts:
                dec.decode(p)
            dec.decode(None)
            rec += [tuple(f) for f in dec.get_frame()]
        return rec

    got = _all_equal(drive, flags=(tapi.USE_INPUT_FRAGMENTS,))
    plain = tapi.CodecDecoder(use_device=False)
    for pkts, f in zip(packets, got):
        plain.decode(b"".join(pkts))
        assert all(np.array_equal(a, b)
                   for a, b in zip(next(plain.get_frame()), f))


def _ec_record(dec):
    d = dec._dec
    cm = d.corrupt_mb
    return ([tuple(f) for f in dec.get_frame()], dec.get_frame_corrupted(),
            None if cm is None else cm.copy(),
            d.mvs_corrupt_from)


def test_ec_truncated_frame():
    def drive(dec):
        frames = _frames("inter_qcif.ivf")
        dec.decode(frames[0][0])
        rec = [_ec_record(dec)]
        dec.decode(frames[1][0][:4])          # severely truncated
        rec.append(_ec_record(dec))
        dec.decode(frames[2][0])
        rec.append(_ec_record(dec))
        return rec

    got = _all_equal(drive, flags=(tapi.USE_ERROR_CONCEALMENT,))
    assert [r[1] for r in got] == [False, True, False]
    assert [len(r[0]) for r in got] == [1, 1, 1]


def test_ec_truncated_token_partition():
    def drive(dec):
        frames = _frames("inter_qcif.ivf")
        rec = []
        for payload, _ in frames[:2]:
            dec.decode(payload)
            rec.append(_ec_record(dec))
        p = frames[2][0]
        dec.decode(p[:len(p) * 2 // 3])       # partition 0 intact
        rec.append(_ec_record(dec))
        dec.decode(frames[3][0])
        rec.append(_ec_record(dec))
        return rec

    got = _all_equal(drive, flags=(tapi.USE_ERROR_CONCEALMENT,))
    cm = got[2][2]
    assert got[2][1] and cm is not None and cm.any() and not cm.all()


def test_ec_corrupt_mode_partition():
    def drive(dec):
        frames = _frames("inter_qcif.ivf")
        rec = []
        for payload, _ in frames[:3]:
            dec.decode(payload)
            rec.append(_ec_record(dec))
        p = frames[3][0]
        part0_size = (p[0] | (p[1] << 8) | (p[2] << 16)) >> 5
        dec.decode(p[:3 + part0_size // 2])   # cut inside partition 0
        rec.append(_ec_record(dec))
        dec.decode(frames[4][0])
        rec.append(_ec_record(dec))
        return rec

    got = _all_equal(drive, flags=(tapi.USE_ERROR_CONCEALMENT,))
    assert got[3][1] and got[3][3] is not None


def test_corrupt_stream_raises_codec_error():
    for kind in KINDS:
        dec = _decoder(kind)
        err = japi.CodecError if kind == "jax" else tapi.CodecError
        with pytest.raises(err):
            dec.decode(_frames("inter_qcif.ivf")[1][0])   # no keyframe yet
        assert dec.get_frame_corrupted()


def test_reference_calls_join_the_dispatch_worker(monkeypatch):
    """The worker swaps the ring after decode() has returned: with a slow
    worker, get_reference right after decode must still see the new
    frame, and set_reference must not be overwritten by the swap."""
    orig = TD.TorchDecoder._worker_dispatch

    def slow(self, *a):
        time.sleep(0.2)
        return orig(self, *a)

    monkeypatch.setattr(TD.TorchDecoder, "_worker_dispatch", slow)
    frames = _frames("inter_qcif.ivf")
    host = tapi.CodecDecoder(use_device=False)
    dec = tapi.CodecDecoder(device="cpu")
    for payload, _ in frames[:3]:
        host.decode(payload)
        dec.decode(payload)
        want = host.get_reference("last")
        got = dec.get_reference("last")          # no get_frame first
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    snap = host.get_reference("golden")
    for d in (host, dec):
        d.decode(frames[3][0])
        d.set_reference("last", snap)            # right after decode
    for d in (host, dec):
        d.decode(frames[4][0])
    want, got = host.get_reference("last"), dec.get_reference("last")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.CodecDecoder()
