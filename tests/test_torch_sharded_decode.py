"""ShardedTorchDecoder (libvpx_opencl_tpu_torch/parallel/sharded_decode.py)
against the golden MD5s: the twins of tests/test_sharded_decode.py on
CPU tensors (the kernels' plain versions with `top_interior` and the
halo copies), at every shard count there and at one that does not divide
the MB rows. The CIF streams and the two-level gop mesh are in
tests/test_torch_sharded_decode_cif.py.

* kf_qcif (keyframes, B_PRED, normal LF) at 1, 2, 4 and 8 shards (QCIF
  has 9 MB rows: 8 shards of 1-2 rows);
* the four streams of the JAX test at 4 shards (inter MC + SPLITMV,
  segmentation LF deltas, bilinear + simple LF);
* odd_65x49 (4 MB rows, cropping) at 4 shards; inter_qcif at 5 shards
  (9 rows: 2, 2, 2, 2, 1);
* one inter frame decoded from a ring installed by load_reference_ring
  from the JAX package's RefDecoder (numpy planes), split over 3 shards.
"""
import numpy as np
import pytest
import torch

from conftest import vector
from libvpx_opencl_tpu.models.refdec import RefDecoder as JaxRefDecoder
from libvpx_opencl_tpu.utils.ivf import read_ivf as jax_read_ivf
from libvpx_opencl_tpu_torch.models import torch_decoder as TD
from libvpx_opencl_tpu_torch.parallel.mesh import make_row_mesh
from libvpx_opencl_tpu_torch.parallel.sharded_decode import \
    ShardedTorchDecoder
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
from libvpx_opencl_tpu_torch.utils.md5 import frame_md5, load_golden_md5s

torch.set_num_threads(1)

STREAMS = ["kf_qcif", "inter_qcif", "seg_roi_qcif", "profile1_qcif"]


def decode_sharded(name, n):
    dec = ShardedTorchDecoder(mesh=make_row_mesh(n, device="cpu"))
    out = []
    for payload, _pts in read_ivf(vector(f"{name}.ivf")).frames:
        show, planes = dec.decode_frame(payload)
        if show:
            out.append(frame_md5(*planes))
    return out


def check_golden(name, n):
    golden = load_golden_md5s(vector(f"{name}.ivf.md5"))
    got = decode_sharded(name, n)
    assert got == golden, f"{name} at {n} shards"


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_invariance_kf(n):
    check_golden("kf_qcif", n)


@pytest.mark.parametrize("name", STREAMS)
def test_sharded_bit_exact_4dev(name):
    check_golden(name, 4)


def test_sharded_bit_exact_odd_dims():
    check_golden("odd_65x49", 4)


def test_sharded_bit_exact_rows_not_divisible():
    dec = ShardedTorchDecoder(mesh=make_row_mesh(5, device="cpu"))
    dec.decode_frame(read_ivf(vector("inter_qcif.ivf")).frames[0][0])
    assert [r1 - r0 for r0, r1 in dec.rows] == [2, 2, 2, 2, 1]
    check_golden("inter_qcif", 5)


def test_installed_ring_from_jax_refdecoder():
    """Frames 0-3 of inter_qcif decoded by the JAX package's RefDecoder;
    its ring (whole bordered numpy planes) goes into a 3-shard decoder
    that decoded only frame 0, which then decodes frames 4-9 MD5-exact.
    A perturbed ring changes frame 4."""
    frames = jax_read_ivf(vector("inter_qcif.ivf")).frames
    golden = load_golden_md5s(vector("inter_qcif.ivf.md5"))
    jdec = type("D", (JaxRefDecoder,), {"use_native": True})()
    for payload, _pts in frames[:4]:
        jdec.decode_frame(payload)
    ring = [tuple(np.array(p) for p in (f.y, f.u, f.v))
            for f in (jdec.last, jdec.golden, jdec.altref)]

    def decoder_at_4(ring):
        dec = ShardedTorchDecoder(mesh=make_row_mesh(3, device="cpu"))
        for payload, _pts in frames[:4]:
            dec.decode_frame(payload)
        TD.load_reference_ring(dec, *ring)
        return dec

    dec = decoder_at_4(ring)
    got = [frame_md5(*dec.decode_frame(p)[1]) for p, _ in frames[4:]]
    assert got == golden[4:]
    other = decoder_at_4([tuple(p ^ 1 for p in f) for f in ring])
    assert frame_md5(*other.decode_frame(frames[4][0])[1]) != golden[4]


def test_load_reference_ring_rejects_wrong_geometry():
    dec = ShardedTorchDecoder(mesh=make_row_mesh(2, device="cpu"))
    dec.decode_frame(read_ivf(vector("kf_qcif.ivf")).frames[0][0])
    y = np.zeros((10, 10), np.uint8)
    with pytest.raises(ValueError, match="reference plane"):
        TD.load_reference_ring(dec, *[(y, y, y)] * 3)
