"""The port's encoder API (libvpx_opencl_tpu_torch/api.py) vs the JAX
package's: the host Encoder on request gives the JAX class's packets
(frame partitions, PSNR) under rate control, an active map goes through,
invalid sizes raise CodecError, and the default device needs a card. The
device encoder's packets are held in tests/test_torch_encoder_default.py.
"""
import numpy as np
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu import api as japi
from libvpx_opencl_tpu_torch import api as tapi
from test_encoder import synth

W, H = 64, 48


def _packets(mod, frames, flags, **kw):
    cfg = mod.EncoderConfig(W, H, token_partitions=1, target_bitrate=120)
    enc = mod.CodecEncoder(cfg, flags=flags, **kw)
    enc.set_active_map(np.arange(12).reshape(3, 4) % 3 != 0)
    for f in frames:
        enc.encode(f)
    return list(enc.get_cx_data())


def test_host_encoder_on_request_matches_jax():
    frames = synth(W, H, 2, seed=9)
    j, t = japi, tapi
    want = _packets(j, frames, (j.USE_PSNR, j.USE_OUTPUT_PARTITION),
                    use_tpu=False)
    got = _packets(t, frames, (t.USE_PSNR, t.USE_OUTPUT_PARTITION),
                   use_device=False)
    assert got == want
    assert [p["kind"] for p in got].count("psnr") == 2
    # per frame: the first partition and two token partitions, the last
    # of the three not a fragment
    assert sum(p.get("fragment", False) for p in got) == 4


def test_invalid_size_raises_codec_error():
    with pytest.raises(tapi.CodecError, match="invalid frame size"):
        tapi.CodecEncoder(tapi.EncoderConfig(0, 48), device="cpu")


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.CodecEncoder(tapi.EncoderConfig(W, H))
