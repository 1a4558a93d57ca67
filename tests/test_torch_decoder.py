"""Port decoder (TorchDecoder) vs the JAX decoder, and its lifecycle.

* inter_qcif frame by frame equal to decode_ivf_tpu (JAX on the CPU), with
  one inter frame decoded from reference frames installed by
  load_reference_ring from the JAX decoder's own ring;
* a dispatch-worker failure surfaces exactly once and leaves the ring at
  the last committed frame (twin of tests/test_tpu_decoder.py);
* the default device is the card: without one, decode_ivf_torch raises;
* importing the port pulls in neither jax nor the JAX package.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import vector
from libvpx_opencl_tpu.models.tpu_decoder import TPUDecoder
from libvpx_opencl_tpu_torch.models import torch_decoder as TD
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
from libvpx_opencl_tpu_torch.utils.md5 import frame_md5, load_golden_md5s

torch.set_num_threads(1)

RING_FRAME = 4   # inter_qcif frame decoded from the installed ring


def _jax_ring(dec):
    dec._sync()
    return [tuple(np.asarray(p) for p in (f.y, f.u, f.v))
            for f in (dec.last, dec.golden, dec.altref)]


def test_inter_qcif_matches_jax_with_installed_ring():
    frames = read_ivf(vector("inter_qcif.ivf")).frames
    jdec = TPUDecoder()
    want, ring = [], None
    for i, (payload, _pts) in enumerate(frames):
        if i == RING_FRAME:
            ring = _jax_ring(jdec)
        want.append(jdec.decode_frame(payload)[1])

    tdec = TD.TorchDecoder(device="cpu")
    for i, (payload, _pts) in enumerate(frames):
        if i == RING_FRAME:
            TD.load_reference_ring(tdec, *ring)
            for f, planes in zip((tdec.last, tdec.golden, tdec.altref), ring):
                for t, a in zip((f.y, f.u, f.v), planes):
                    np.testing.assert_array_equal(t.numpy(), a)
        show, got = tdec.decode_frame(payload)
        assert show
        for g, w in zip(got, want[i]):
            np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")

    # the installed ring is what the frame is predicted from: a perturbed
    # ring changes the decoded frame
    other = TD.TorchDecoder(device="cpu")
    for payload, _pts in frames[:RING_FRAME]:
        other.decode_frame(payload)
    TD.load_reference_ring(other, *[tuple(p ^ 1 for p in planes)
                                    for planes in ring])
    got = other.decode_frame(frames[RING_FRAME][0])[1]
    assert not np.array_equal(got[0], want[RING_FRAME][0])


def test_load_reference_ring_rejects_wrong_geometry():
    dec = TD.TorchDecoder(device="cpu")
    dec.decode_frame(read_ivf(vector("kf_qcif.ivf")).frames[0][0])
    y = np.zeros((10, 10), np.uint8)
    with pytest.raises(ValueError, match="reference plane"):
        TD.load_reference_ring(dec, *[(y, y, y)] * 3)


def test_dispatch_worker_failure_path():
    """A dispatch-worker exception surfaces exactly once on the next pixel
    access, and the reference ring stays at the last committed frame so
    the stream keeps decoding."""
    frames = read_ivf(vector("inter_qcif.ivf")).frames
    golden = load_golden_md5s(vector("inter_qcif.ivf.md5"))
    dec = TD.TorchDecoder(device="cpu")
    dec.decode_frame_core(frames[0][0])
    assert frame_md5(*dec.frame_to_show.visible()) == golden[0]

    real = dec._worker_dispatch

    def boom(np_args, meta):
        raise RuntimeError("injected dispatch failure")

    dec._worker_dispatch = boom
    dec.decode_frame_core(frames[1][0])
    with pytest.raises(RuntimeError, match="injected"):
        dec.frame_to_show.visible()
    # the exception is not sticky...
    dec._worker_dispatch = real
    # ...and frame 1's device work never ran: the ring still holds frame 0,
    # so re-decoding frame 1 must be exact
    dec.decode_frame_core(frames[1][0])
    assert frame_md5(*dec.frame_to_show.visible()) == golden[1]


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.decode_ivf_torch(vector("kf_qcif.ivf"))
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.TorchDecoder()


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import libvpx_opencl_tpu_torch\n"
            "import libvpx_opencl_tpu_torch.api\n"
            "import libvpx_opencl_tpu_torch.models.torch_decoder\n"
            "import libvpx_opencl_tpu_torch.models.torch_encoder\n"
            "import libvpx_opencl_tpu_torch.models.encoder\n"
            "import libvpx_opencl_tpu_torch.models.wavefront\n"
            "import libvpx_opencl_tpu_torch.ops.me\n"
            "import libvpx_opencl_tpu_torch.ops.me_sad\n"
            "import libvpx_opencl_tpu_torch.ops.rd_device\n"
            "import libvpx_opencl_tpu_torch.ops.wavefront\n"
            "import libvpx_opencl_tpu_torch.ops._cuda\n"
            "import libvpx_opencl_tpu_torch.utils.native\n"
            "bad = [m for m in sys.modules if m == 'jax' or\n"
            "       m.startswith(('jax.', 'libvpx_opencl_tpu.'))\n"
            "       or m == 'libvpx_opencl_tpu']\n"
            "assert not bad, bad\n")
    root = vector("").rsplit("/tests/", 1)[0]
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   timeout=120)
