"""Faults the port's copies carried over from the reference, each fixed in
the port only and shown here on the CPU:

  * csrc/host/vp8_pack_modes.cpp:write_mv counted `delta >> 1` but wrote
    `abs(delta) >> 1`; it now refuses an odd delta (the Python golden,
    models/encoder.py:_write_mv, asserts an even one), and the native
    wrappers raise ValueError;
  * models/boolenc.py incremented the last byte on a carry past the first
    one, where csrc/host/vp8_pack.cpp drops it; both now drop it;
  * tools/bench_encode_torch.py warmed up on frames 1 and 2 whatever
    --frames said;
  * TorchDecoder._reconstruct replaced the pending dispatch future without
    reading it, so a failed dispatch in a decode_frame_core loop was lost
    unless it was the last. The worker now keeps its first failure and
    refuses the frames queued behind it; the failure is raised once (at
    the next _reconstruct or _sync, or when a frame's pixels are read),
    with the ring at the last committed frame; ShardedTorchDecoder keeps
    the same worker.

No payload changes: valid encodes never reach the first two states.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from conftest import vector

from libvpx_opencl_tpu_torch.models import torch_decoder as TD
from libvpx_opencl_tpu_torch.models.boolenc import BoolEncoder
from libvpx_opencl_tpu_torch.models.encoder import NEWMV, Encoder
from libvpx_opencl_tpu_torch.models.refdec import INTRA_FRAME
from libvpx_opencl_tpu_torch.parallel.mesh import make_row_mesh
from libvpx_opencl_tpu_torch.parallel.sharded_decode import \
    ShardedTorchDecoder
from libvpx_opencl_tpu_torch.utils import native
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
from libvpx_opencl_tpu_torch.utils.md5 import frame_md5

torch.set_num_threads(1)
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


@pytest.fixture(scope="module")
def inter_encoder():
    """A host Encoder after a keyframe and one inter frame at 32x32 (its
    mode grids, probabilities and MV contexts are those of a real frame),
    and the native runtime."""
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    u = rng.integers(0, 256, (16, 16)).astype(np.uint8)
    enc = Encoder(32, 32, qindex=24)
    enc.encode_frame(y, u, u)
    enc.encode_frame(np.roll(y, 3, 1), u, u)
    return enc, native.get_lib()


def _state(e):
    return bytes(e.buf), e.lowvalue, e.range, e.count


def _encoder_at(lowvalue, count, buf):
    e = BoolEncoder()
    e.lowvalue, e.count, e.buf = lowvalue, count, bytearray(buf)
    return e


def _pack_python(enc, e):
    for r in range(enc.R):
        for c in range(enc.C):
            enc._pack_mb_modes(e, r, c, False)


def test_boolenc_carry_past_first_byte_matches_cpp(inter_encoder):
    """Both twins continue a stream whose bytes are all 0xFF from states
    whose next output carries into them: the carry runs past the first
    byte and is dropped by both, byte for byte."""
    enc, lib = inter_encoder
    past_first = 0
    for count in range(-8, 0):
        for low in (0xFFFFFF00, 0xFFFFF000, 0xFFFF0000, 0xFF000000,
                    0xC0000000, 0x80000000):
            want = _encoder_at(low, count, b"\xff\xff")
            _pack_python(enc, want)
            got = _encoder_at(low, count, b"\xff\xff")
            assert native.pack_modes_native(lib, enc, got, False)
            assert _state(got) == _state(want), (hex(low), count)
            past_first += want.buf[:2] == b"\x00\x00"
    assert past_first > 0


def test_write_mv_refuses_an_odd_delta(inter_encoder):
    """An inter MB coded NEWMV with an odd MV component: the native count
    and pack raise ValueError, the Python golden asserts; with the MV made
    even again, native == Python."""
    enc, lib = inter_encoder
    inter = np.argwhere(enc.reff[1:, 1:] != INTRA_FRAME)
    assert len(inter)
    pr, pc = inter[0] + 1
    mode, mv = enc.mode.copy(), enc.mv.copy()
    try:
        enc.mode[pr, pc] = NEWMV
        enc.mv[pr, pc] = (2, 7)
        with pytest.raises(ValueError, match="odd"):
            native.count_modes_native(lib, enc)
        with pytest.raises(ValueError, match="odd"):
            native.pack_modes_native(lib, enc, BoolEncoder(), False)
        with pytest.raises(AssertionError):
            _pack_python(enc, BoolEncoder())
        enc.mv[pr, pc] = (2, 8)
        native.count_modes_native(lib, enc)
        got, want = BoolEncoder(), BoolEncoder()
        assert native.pack_modes_native(lib, enc, got, False)
        _pack_python(enc, want)
        assert _state(got) == _state(want)
    finally:
        enc.mode[...], enc.mv[...] = mode, mv


@pytest.mark.parametrize("frames", [1, 2])
def test_bench_encode_torch_short_clips(frames, capsys):
    spec = importlib.util.spec_from_file_location(
        "bench_encode_torch", os.path.join(TOOLS, "bench_encode_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out, payloads = tool.main(["--w", "32", "--h", "32", "--frames",
                               str(frames), "--device", "cpu", "--skip-ref"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert json.loads(lines[-1]) == out
    assert len(payloads) == frames and all(payloads)
    assert out["torch_speed0"]["bytes"] == sum(len(p) for p in payloads)


def _ring_md5s(dec):
    return [frame_md5(*f.visible()) for f in (dec.last, dec.golden,
                                              dec.altref)]


@pytest.mark.parametrize("sharded", [False, True])
def test_failed_dispatch_in_a_core_loop_is_reported(sharded, monkeypatch):
    """Frame 3's dispatch (an inter frame) fails inside a decode_frame_core
    loop that never reads pixels: the failure is raised once (at a later
    _reconstruct or at _sync), the frames queued behind it are refused,
    and the ring holds frames 0-2's result; the stream then goes on."""
    frames = [p for p, _ in read_ivf(vector("inter_qcif.ivf")).frames][:7]

    def decoder():
        return ShardedTorchDecoder(mesh=make_row_mesh(2, device="cpu")) \
            if sharded else TD.TorchDecoder(device="cpu")

    clean = decoder()
    for payload in frames[:3]:
        clean.decode_frame_core(payload)
    clean._sync()
    dec = decoder()
    real = type(dec)._frame_device
    calls = []

    def fail_fourth(self, np_args, meta):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("injected dispatch failure")
        return real(self, np_args, meta)

    monkeypatch.setattr(type(dec), "_frame_device", fail_fourth)
    raised = 0
    for payload in frames:
        try:
            dec.decode_frame_core(payload)
        except RuntimeError as e:
            assert "injected" in str(e)
            raised += 1
            break
    if not raised:
        with pytest.raises(RuntimeError, match="injected"):
            dec._sync()
        raised += 1
    dec._sync()                       # reported once: nothing more to raise
    assert raised == 1 and len(calls) == 4
    assert _ring_md5s(dec) == _ring_md5s(clean)
    # the stream goes on (the host's entropy state has moved past frame 3,
    # so its pixels are not the golden ones)
    monkeypatch.setattr(type(dec), "_frame_device", real)
    dec.decode_frame_core(frames[3])
    dec._sync()
    assert dec.frame_to_show.visible()[0].shape == (144, 176)
