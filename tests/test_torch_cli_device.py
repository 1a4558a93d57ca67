"""The port's encoder entry points on the device encoder (TorchEncoder on
device="cpu") vs the JAX package: bytes equal (tolerance 0).

  * tpuvpxenc (no --golden) vs the JAX tpuvpxenc with
    libvpx_opencl_tpu.models.encoder.Encoder patched to TPUEncoder (the
    JAX CLI imports Encoder inside main): one-pass vbr with the recode
    loop, two-pass, --auto-alt-ref with lag 4 and WebM output, all at
    --cpu-used 8 on one 96x64 clip (test_torch_cli._clip), so the JAX
    encoder compiles once for the file;
  * cq at the default --cpu-used 0 (B_PRED and trellis) vs the same flow
    driven directly on TorchEncoder(device="cpu") (TorchEncoder at the
    default features equals TPUEncoder in test_torch_encoder_default.py);
  * MultiResEncoder(use_device=True, device="cpu"): both layers equal
    directly driven TorchEncoders at 96x64 and 48x32; and
    examples/vp8_multi_resolution_encoder.py on it writes, layer for
    layer, what the JAX example writes on TPUEncoder layers at --cpu-used
    8 (its 96x64 layer reuses the JAX CLI cases' compiled programs);
  * the recode contract under the CLI's rate control: a rejected attempt
    leaves the reference ring, prev_mv and the frame count as they were,
    and a dropped frame commits nothing;
  * --tune ssim needs --golden; --psnr equals the PSNR of the port's host
    decode of the written IVF; without a card the default device raises.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.cli import tpuvpxenc as jcli
from libvpx_opencl_tpu.models import encoder as jencoder
from libvpx_opencl_tpu.models import multires as jmultires
from libvpx_opencl_tpu.models.tpu_encoder import TPUEncoder
from libvpx_opencl_tpu_torch.cli import tpuvpxenc as tcli
from libvpx_opencl_tpu_torch.models import multires
from libvpx_opencl_tpu_torch.models import ratecontrol as RC
from libvpx_opencl_tpu_torch.models import torch_encoder as TE
from libvpx_opencl_tpu_torch.models.refdec import RefDecoder
from libvpx_opencl_tpu_torch.ops.metrics import frame_psnr
from libvpx_opencl_tpu_torch.utils.ivf import IvfStream, read_ivf, write_ivf
from libvpx_opencl_tpu_torch.utils.webm import read_webm
from libvpx_opencl_tpu_torch.utils.y4m import Y4MReader
from test_torch_cli import _clip
from torch_example_helpers import moving_clip, port_example

torch.set_num_threads(1)
W, H = 96, 64


def _jax_cli(monkeypatch, argv):
    """The JAX tpuvpxenc with TPUEncoder in place of the host Encoder."""
    with monkeypatch.context() as m:
        m.setattr(jencoder, "Encoder", TPUEncoder)
        assert jcli.main(argv) == 0


def _host_decode(data):
    dec = type("D", (RefDecoder,), {"use_native": True})()
    return [dec.decode_frame(p) for p in data]


def _frames(n):
    """The frames of test_torch_cli._clip(n), in memory."""
    rng = np.random.RandomState(21)
    base = rng.randint(0, 255, (H + 24, W + 2 * n), np.uint8)
    return [(base[i:i + H, 2 * i:2 * i + W].copy(),
             np.full((H // 2, W // 2), 118 + i, np.uint8),
             np.full((H // 2, W // 2), 132, np.uint8)) for i in range(n)]


CASES = {
    "one_pass_vbr": (4, ["--target-bitrate", "200", "--cpu-used", "8"],
                     ".ivf"),
    "two_pass": (6, ["--passes", "2", "--target-bitrate", "200",
                     "--cpu-used", "8"], ".ivf"),
    # lag 4: a GF group every 4 frames, so frame 4 is preceded by an ARF
    "auto_alt_ref": (8, ["--auto-alt-ref", "1", "--lag-in-frames", "4",
                         "--end-usage", "cq", "--cpu-used", "8"], ".ivf"),
    "webm": (3, ["--end-usage", "cq", "--cq-level", "30", "--cpu-used",
                 "8"], ".webm"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax_on_tpu_encoder(monkeypatch, tmp_path, case):
    n, opts, ext = CASES[case]
    clip = _clip(tmp_path, n)
    outs = []
    attempts = []
    real = TE.TorchEncoder.encode_frame

    def counted(self, *a, **kw):
        attempts.append(kw.get("commit", True))
        return real(self, *a, **kw)

    for tag in ("j", "t"):
        out = str(tmp_path / f"{tag}{ext}")
        if tag == "j":
            _jax_cli(monkeypatch, [clip, "-o", out, *opts])
        else:
            with monkeypatch.context() as m:
                m.setattr(TE.TorchEncoder, "encode_frame", counted)
                assert tcli.main([clip, "-o", out, *opts],
                                 device="cpu") == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    if ext == ".webm":
        frames = [p for p, _ts, _key in read_webm(outs[1]).frames]
    else:
        frames = [p for p, _ in read_ivf(outs[1]).frames]
    assert len(frames) >= n
    if case == "one_pass_vbr":
        # the recode loop re-ran at least one frame before its commit
        assert attempts.count(False) > n
    if case == "auto_alt_ref":
        assert any(not (p[0] >> 4) & 1 for p in frames)
    decoded = _host_decode(frames)
    assert sum(show for show, _ in decoded) == n


def test_cli_default_features_matches_direct_encoder(monkeypatch,
                                                     tmp_path):
    """cq at --cpu-used 0 (B_PRED and trellis on) writes what the same
    flow driven directly on TorchEncoder writes."""
    clip = _clip(tmp_path, 3)
    out = str(tmp_path / "t.ivf")
    trellis = []
    real = TE._trellis_mbs

    def counted(*a):
        trellis.append(a[0].shape[0])
        return real(*a)

    with monkeypatch.context() as m:
        m.setattr(TE, "_trellis_mbs", counted)
        assert tcli.main([clip, "-o", out, "--end-usage", "cq",
                          "--cq-level", "24"], device="cpu") == 0
    rd = Y4MReader(clip)
    enc = TE.TorchEncoder(W, H, qindex=24, device="cpu")
    assert enc.sf.bpred and enc.sf.trellis
    stream = IvfStream(width=W, height=H, timebase_num=rd.fps[1],
                       timebase_den=rd.fps[0])
    for i, frame in enumerate(rd):
        stream.frames.append((enc.encode_frame(*frame, keyframe=i == 0), i))
    want = str(tmp_path / "want.ivf")
    write_ivf(want, stream)
    assert open(out, "rb").read() == open(want, "rb").read()
    assert trellis and min(trellis) > 0     # the inter frames' trellis ran


def test_multires_layers_match_direct_encoders():
    """MultiResEncoder(device="cpu") builds two TorchEncoders, and each
    layer writes what a directly driven TorchEncoder writes (the class
    against the JAX class on TPUEncoder layers is held in
    test_multi_resolution_example_on_device_matches_jax below); both
    layers decode to the encoder's reconstruction."""
    frames = _frames(3)
    enc = multires.MultiResEncoder(W, H, qindices=(36, 32), device="cpu",
                                   cpu_used=8)
    assert isinstance(enc.hi, TE.TorchEncoder)
    assert isinstance(enc.lo, TE.TorchEncoder)
    assert enc.lo.w == W // 2 and enc.lo.h == H // 2
    hi = TE.TorchEncoder(W, H, qindex=36, cpu_used=8, device="cpu")
    lo = TE.TorchEncoder(W // 2, H // 2, qindex=32, cpu_used=8,
                         device="cpu")
    out, recon = [], []
    for i, f in enumerate(frames):
        got = enc.encode_frame(*f, keyframe=i == 0)
        recon.append((enc.hi.frame_to_show.visible(),
                      enc.lo.frame_to_show.visible()))
        assert got == (
            hi.encode_frame(*f, keyframe=i == 0),
            lo.encode_frame(*(multires.downsample2(p) for p in f),
                            keyframe=i == 0))
        out.append(got)
    for layer in (0, 1):
        decoded = _host_decode([p[layer] for p in out])
        for (show, planes), rec in zip(decoded, recon):
            assert show
            assert all(np.array_equal(a, np.asarray(b))
                       for a, b in zip(planes, rec[layer]))


def test_multi_resolution_example_on_device_matches_jax(monkeypatch,
                                                        tmp_path):
    """vp8_multi_resolution_encoder with the port's MultiResEncoder on
    TorchEncoder layers (device="cpu") writes, layer for layer, what the
    JAX example writes with TPUEncoder layers. Both run at --cpu-used 8:
    the JAX encoder compiles once per layer geometry, and the default
    features are held in tests/test_torch_encoder_default.py."""
    clip = moving_clip(tmp_path, n=3)
    outs = {k: [str(tmp_path / f"{k}{i}.ivf") for i in range(2)]
            for k in ("jax", "port")}
    mod = importlib.import_module("vp8_multi_resolution_encoder")
    with monkeypatch.context() as m:
        m.setattr(jmultires, "Encoder",
                  functools.partial(TPUEncoder, cpu_used=8))
        want = mod.main(clip, *outs["jax"])
    mod = port_example(monkeypatch, "vp8_multi_resolution_encoder")
    monkeypatch.setattr(mod, "MultiResEncoder", functools.partial(
        multires.MultiResEncoder, device="cpu", cpu_used=8))
    assert mod.main(clip, *outs["port"]) == want == 3
    for a, b in zip(outs["jax"], outs["port"]):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_recode_and_drop_commit_nothing():
    """Under the CLI's RateController, a rejected attempt (commit=False)
    leaves the reference ring, prev_mv and the frame count as they were;
    a dropped frame (b"") commits nothing."""
    frames = _frames(3)
    enc = TE.TorchEncoder(W, H, qindex=30, cpu_used=8, device="cpu")
    rc = RC.RateController(60, 30.0, enc.R * enc.C)
    RC.encode_frame_with_rc(enc, rc, *frames[0], keyframe=True)
    ring = (enc.ref_last, enc.ref_gold, enc.ref_alt)
    pixels = [p.clone() for f in ring for p in (f.y, f.u, f.v)]
    prev_mv, count = enc.prev_mv.copy(), enc.frame_count
    enc.qindex = 90
    enc.encode_frame(*frames[1], keyframe=False, commit=False)
    assert (enc.ref_last, enc.ref_gold, enc.ref_alt) == ring
    assert all(torch.equal(a, b) for a, b in zip(
        pixels, [p for f in ring for p in (f.y, f.u, f.v)]))
    assert np.array_equal(enc.prev_mv, prev_mv)
    assert enc.frame_count == count
    rc.check_frame_drop = lambda keyframe: True
    assert RC.encode_frame_with_rc(enc, rc, *frames[2]) == b""
    assert (enc.ref_last, enc.ref_gold, enc.ref_alt) == ring
    assert np.array_equal(enc.prev_mv, prev_mv)
    assert enc.frame_count == count


def test_tune_ssim_needs_golden(tmp_path):
    clip = _clip(tmp_path, 2)
    out = str(tmp_path / "t.ivf")
    with pytest.raises(SystemExit):
        tcli.main([clip, "-o", out, "--tune", "ssim"], device="cpu")
    assert tcli.main([clip, "-o", out, "--tune", "ssim", "--golden",
                      "--cpu-used", "8", "--limit", "1"]) == 0
    assert len(read_ivf(out).frames) == 1


def test_psnr_equals_decode_of_output(tmp_path, capsys):
    clip = _clip(tmp_path, 3)
    out = str(tmp_path / "t.ivf")
    assert tcli.main([clip, "-o", out, "--end-usage", "cq", "--cpu-used",
                      "8", "--psnr"], device="cpu") == 0
    err = capsys.readouterr().err
    line = [ln for ln in err.splitlines() if "Overall PSNR" in ln]
    got = float(line[0].split(":")[1].split()[0])
    decoded = _host_decode([p for p, _ in read_ivf(out).frames])
    want = [frame_psnr(f, planes)["all"]
            for f, (_, planes) in zip(Y4MReader(clip), decoded)]
    assert got == float(f"{sum(want) / len(want):.2f}")


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the default device without a card")
def test_default_device_needs_a_card(tmp_path):
    clip = _clip(tmp_path, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([clip, "-o", str(tmp_path / "t.ivf")])
    with pytest.raises(RuntimeError, match="CUDA"):
        multires.MultiResEncoder(W, H)
