"""Helpers of the tests that run the example scripts (examples/) with the
port's classes swapped in: tests/test_torch_examples.py and
tests/test_torch_cli_device.py. Importing this module puts examples/ on
sys.path, so that an example imports by its name."""
import importlib
import os
import sys
import types

import numpy as np

from libvpx_opencl_tpu_torch import api as tapi
from libvpx_opencl_tpu_torch.utils.y4m import write_y4m

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))


def recording(base, record, kw):
    """`base` decoder class whose get_frame also appends to `record`;
    `kw` maps the example's use_tpu keyword."""
    class Rec(base):
        def __init__(self, flags=(), threads=1, use_tpu=False):
            super().__init__(flags, threads, **kw(use_tpu))

        def get_frame(self):
            for f in super().get_frame():
                record.append(tuple(f))
                yield f
    return Rec


def port_encoder(recon):
    """The port's CodecEncoder on TorchEncoder (CPU), recording the
    reconstruction of every encoded frame."""
    class Enc(tapi.CodecEncoder):
        def __init__(self, cfg, flags=(), use_tpu=False):
            super().__init__(cfg, flags, device="cpu", use_device=use_tpu)

        def encode(self, frame, pts=None, flags=()):
            super().encode(frame, pts, flags)
            if frame is not None:
                recon.append(tuple(np.array(p) for p in
                                   self._ref_planes()))
    return Enc


def port_example(monkeypatch, name, dec_record=None, recon=None):
    """Import example `name` with the port's names in place of the JAX
    package's."""
    mod = importlib.import_module(name)
    for attr, val in list(vars(mod).items()):
        if isinstance(val, types.ModuleType):
            src = val.__name__
        else:
            src = getattr(val, "__module__", None) or ""
        if src.startswith("libvpx_opencl_tpu."):
            port = importlib.import_module(
                src.replace("libvpx_opencl_tpu.", "libvpx_opencl_tpu_torch.",
                            1))
            monkeypatch.setattr(mod, attr, port if isinstance(
                val, types.ModuleType) else getattr(port, attr))
    if hasattr(mod, "CodecDecoder"):
        monkeypatch.setattr(mod, "CodecDecoder", recording(
            tapi.CodecDecoder, dec_record,
            kw=lambda t: dict(device="cpu", use_device=t)))
    if hasattr(mod, "CodecEncoder"):
        monkeypatch.setattr(mod, "CodecEncoder", port_encoder(recon))
    return mod


def moving_clip(tmp_path, n=6, w=96, h=64, name="mv.y4m"):
    """A Y4M clip of `n` frames whose luma pans over one random picture."""
    rng = np.random.RandomState(11)
    base = rng.randint(0, 255, (h + 32, w + 32), np.uint8)
    frames = []
    for i in range(n):
        y = base[i:i + h, 2 * i:2 * i + w].copy()
        frames.append((y, np.full((h // 2, w // 2), 120, np.uint8),
                       np.full((h // 2, w // 2), 130, np.uint8)))
    y4m = str(tmp_path / name)
    write_y4m(y4m, frames, w, h)
    return y4m
