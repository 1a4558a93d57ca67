"""The example scripts (examples/) with the port's classes swapped in.

The examples bind the JAX package's names when they are imported and are
not edited. Each test replaces, in the example module, every name that
came from libvpx_opencl_tpu.X by the port's libvpx_opencl_tpu_torch.X,
with CodecDecoder / CodecEncoder as factories that map use_tpu to
use_device and pass device="cpu", then calls main(..., use_tpu=True), so
the port's TorchDecoder / TorchEncoder run. The asserts are those of
tests/test_api_examples.py. The decoder examples must also give the JAX
examples' results frame for frame; the encoder examples' IVF, decoded by
the port's host decoder, must equal the encoder's own reconstruction.
vp8_multi_resolution_encoder runs here on the port's MultiResEncoder on
host Encoders against the JAX example as it is; on TorchEncoder layers
(CPU) against the JAX example on TPUEncoder layers it runs in
tests/test_torch_cli_device.py, which compiles the same JAX encoder.
"""
import functools
import importlib

import numpy as np
import pytest

from conftest import vector
from libvpx_opencl_tpu import api as japi
from libvpx_opencl_tpu_torch.models import multires
from libvpx_opencl_tpu_torch.models.refdec import RefDecoder
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
from libvpx_opencl_tpu_torch.utils.md5 import load_golden_md5s
from libvpx_opencl_tpu_torch.utils.y4m import write_y4m
from torch_example_helpers import moving_clip, port_example, recording

def _jax_run(monkeypatch, name, *args, **kw):
    """The example as it is (JAX package, host decoder), recording its
    decoded frames."""
    mod = importlib.import_module(name)
    rec = []
    with monkeypatch.context() as m:
        m.setattr(mod, "CodecDecoder", recording(
            japi.CodecDecoder, rec, kw=lambda t: dict(use_tpu=t)))
        out = mod.main(*args, **kw)
    return out, rec


def _port_run(monkeypatch, name, *args, **kw):
    rec = []
    mod = port_example(monkeypatch, name, dec_record=rec)
    return mod.main(*args, use_tpu=True, **kw), rec


def _same_frames(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x, y) for fa, fb in zip(a, b) for x, y in zip(fa, fb))


def test_decode_to_md5(monkeypatch):
    want, jframes = _jax_run(monkeypatch, "decode_to_md5",
                             vector("kf_qcif.ivf"))
    got, frames = _port_run(monkeypatch, "decode_to_md5",
                            vector("kf_qcif.ivf"))
    assert got == load_golden_md5s(vector("kf_qcif.ivf.md5"))
    assert got == want and _same_frames(frames, jframes)


def test_simple_decoder(monkeypatch, tmp_path):
    m, jframes = _jax_run(monkeypatch, "simple_decoder",
                          vector("inter_qcif.ivf"), str(tmp_path / "j.i420"))
    n, frames = _port_run(monkeypatch, "simple_decoder",
                          vector("inter_qcif.ivf"), str(tmp_path / "t.i420"))
    assert n == 10
    assert m == n and _same_frames(frames, jframes)
    assert (tmp_path / "t.i420").read_bytes() == \
        (tmp_path / "j.i420").read_bytes()


def test_postproc(monkeypatch):
    m, jframes = _jax_run(monkeypatch, "postproc", vector("inter_qcif.ivf"))
    n, frames = _port_run(monkeypatch, "postproc", vector("inter_qcif.ivf"))
    assert n == 10
    assert m == n and _same_frames(frames, jframes)


def test_decode_with_drops(monkeypatch):
    want, jframes = _jax_run(monkeypatch, "decode_with_drops",
                             vector("inter_qcif.ivf"), (3, 5))
    got, frames = _port_run(monkeypatch, "decode_with_drops",
                            vector("inter_qcif.ivf"), (3, 5))
    assert got == (7, 3)
    assert got == want and _same_frames(frames, jframes)


def test_decode_with_partial_drops(monkeypatch):
    want, jframes = _jax_run(monkeypatch, "decode_with_partial_drops",
                             vector("part4_cif.ivf"), loss_percent=50)
    (shown, concealed), frames = _port_run(
        monkeypatch, "decode_with_partial_drops", vector("part4_cif.ivf"),
        loss_percent=50)
    assert shown == 6 and concealed >= 1
    assert (shown, concealed) == want and _same_frames(frames, jframes)


def test_vp8cx_set_ref(monkeypatch):
    want, _ = _jax_run(monkeypatch, "vp8cx_set_ref", vector("inter_qcif.ivf"))
    snap, _ = _port_run(monkeypatch, "vp8cx_set_ref",
                        vector("inter_qcif.ivf"))
    assert all(np.array_equal(a, b) for a, b in zip(snap, want))
    assert snap[0].shape == (144, 176)


def _closed_loop(path, recon):
    """Every frame of the IVF, decoded by the port's host decoder, equals
    the encoder's reconstruction."""
    d = type("D", (RefDecoder,), {"use_native": True})()
    shown = []
    for p, _ in read_ivf(path).frames:
        show, planes = d.decode_frame(p)
        if show:
            shown.append(planes)
    assert _same_frames(shown, recon)
    return len(shown)


def _encode_example(monkeypatch, name, *args, **kw):
    recon, rec = [], []
    mod = port_example(monkeypatch, name, dec_record=rec, recon=recon)
    return mod.main(*args, use_tpu=True, **kw), recon


def test_simple_encoder(monkeypatch, tmp_path):
    rng = np.random.RandomState(0)
    frames = [(rng.randint(0, 255, (64, 96), np.uint8).astype(np.uint8),
               np.full((32, 48), 128, np.uint8),
               np.full((32, 48), 128, np.uint8)) for _ in range(3)]
    y4m = str(tmp_path / "in.y4m")
    write_y4m(y4m, frames, 96, 64)
    out = str(tmp_path / "out.ivf")
    n, recon = _encode_example(monkeypatch, "simple_encoder", y4m, out)
    assert n == 3 and _closed_loop(out, recon) == 3


def test_force_keyframe(monkeypatch, tmp_path):
    out = str(tmp_path / "out.ivf")
    kfs, recon = _encode_example(monkeypatch, "force_keyframe",
                                 moving_clip(tmp_path, n=6), out,
                                 kf_interval=4)
    assert kfs == [0, 4] and _closed_loop(out, recon) == 6
    keys = [not (p[0] & 1) for p, _ in read_ivf(out).frames]
    assert [i for i, k in enumerate(keys) if k] == kfs


def test_error_resilient(monkeypatch, tmp_path):
    out = str(tmp_path / "out.ivf")
    decoded, recon = _encode_example(monkeypatch, "error_resilient",
                                     moving_clip(tmp_path, n=8), out,
                                     drop_percent=30)
    assert decoded >= 2  # keyframes always survive
    assert _closed_loop(out, recon) == 8


def test_vp8_set_maps(monkeypatch, tmp_path):
    out = str(tmp_path / "out.ivf")
    n, recon = _encode_example(monkeypatch, "vp8_set_maps",
                               moving_clip(tmp_path, n=14), out)
    assert n == 14 and _closed_loop(out, recon) == 14


@pytest.mark.parametrize("name", ["twopass_encoder",
                                  "vp8_multi_resolution_encoder",
                                  "vp8_scalable_patterns"])
def test_host_encoder_examples_match_jax(monkeypatch, tmp_path, name):
    """The examples that drive the host encoder directly (twopass, layers,
    multires) write the JAX examples' bytes through the port's modules."""
    clip = moving_clip(tmp_path, n=3)
    outs = {k: [str(tmp_path / f"{k}{i}.ivf") for i in range(2)]
            for k in ("jax", "port")}
    n_args = 2 if name == "vp8_multi_resolution_encoder" else 1
    mod = importlib.import_module(name)
    want = mod.main(clip, *outs["jax"][:n_args])
    mod = port_example(monkeypatch, name)
    if name == "vp8_multi_resolution_encoder":
        # the port's class encodes on TorchEncoders unless told otherwise
        monkeypatch.setattr(mod, "MultiResEncoder", functools.partial(
            multires.MultiResEncoder, use_device=False))
    assert mod.main(clip, *outs["port"][:n_args]) == want
    for a, b in zip(outs["jax"][:n_args], outs["port"][:n_args]):
        assert open(a, "rb").read() == open(b, "rb").read()
