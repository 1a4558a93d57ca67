"""encode_gops (parallel/gop.py) vs a sequential TorchEncoder with the
same keyframes: payload bytes equal (tolerance 0), on CPU tensors, one
thread per group; the concatenated payloads decode as one stream. The
twin of tests/test_gop_encode.py (cpu_used 7), plus SLICE2_SF (the
exhaustive search) over 2 shards of a mesh."""
import numpy as np
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu_torch.models import torch_encoder as TE
from libvpx_opencl_tpu_torch.models.refdec import RefDecoder
from libvpx_opencl_tpu_torch.parallel.gop import encode_gops
from test_encoder import synth

torch.set_num_threads(1)


@pytest.mark.parametrize("n_frames,gop,sf,n_devices", [
    (6, 3, None, None), (4, 2, TE.SLICE2_SF, 2)])
def test_gop_parallel_encode_bit_exact(n_frames, gop, sf, n_devices):
    w, h = 176, 144
    frames = synth(w, h, n_frames)
    kw = {"cpu_used": 7} if sf is None else {}
    enc = TE.TorchEncoder(w, h, qindex=40, device="cpu", **kw)
    if sf is not None:
        enc.sf = sf
    seq = [enc.encode_frame(y, u, v, keyframe=(i % gop == 0))
           for i, (y, u, v) in enumerate(frames)]
    par = encode_gops(frames, w, h, gop, n_devices=n_devices, qindex=40,
                      device="cpu", sf=sf, **kw)
    assert len(par) == len(seq)
    for i, (a, b) in enumerate(zip(seq, par)):
        assert a == b, f"frame {i}: GOP-parallel differs from sequential"
    dec = type("D", (RefDecoder,), {"use_native": True})()
    for p in par:
        assert dec.decode_frame(p)[0]
    np.testing.assert_array_equal(dec.frame_to_show.visible()[0],
                                  enc.frame_to_show.visible()[0])
