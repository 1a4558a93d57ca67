"""ShardedTorchDecoder at CIF size and the two-level ('gop', 'row') mesh,
against the golden MD5s (the rest of tests/test_sharded_decode.py's twins
are in tests/test_torch_sharded_decode.py; this file is split off to
spread the tier-1 run's workers).

* part4_cif (4 token partitions) and inter_cif at 8 shards of CIF's 18 MB
  rows;
* decode_streams: 2 gop groups x 4 row shards decode kf_qcif and
  inter_qcif on two threads, both MD5-exact.
"""
import pytest
import torch

from conftest import vector
from libvpx_opencl_tpu_torch.parallel.gop import decode_streams
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
from libvpx_opencl_tpu_torch.utils.md5 import frame_md5, load_golden_md5s
from test_torch_sharded_decode import check_golden

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["part4_cif", "inter_cif"])
def test_sharded_bit_exact_cif_8dev(name):
    check_golden(name, 8)


def test_gop_axis_two_level_mesh():
    names = ["kf_qcif", "inter_qcif"]
    streams = [[p for p, _ in read_ivf(vector(f"{n}.ivf")).frames]
               for n in names]
    results = decode_streams(streams, n_devices=8, gop=2, device="cpu")
    for name, frames in zip(names, results):
        golden = load_golden_md5s(vector(f"{name}.ivf.md5"))
        assert [frame_md5(*planes) for planes in frames] == golden, name
