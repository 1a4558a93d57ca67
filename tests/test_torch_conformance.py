"""The port's decoder is bit-exact: all 11 conformance streams MD5-exact
against the reference vpxdec --md5 goldens, through decode_ivf_torch on the
CPU (the CUDA kernels' plain versions). chip_smoke.py runs the same entry
point on the card."""
import pytest
import torch

from conftest import vector
from libvpx_opencl_tpu_torch.models.torch_decoder import decode_ivf_torch
from libvpx_opencl_tpu_torch.utils.md5 import frame_md5, load_golden_md5s

torch.set_num_threads(1)

STREAMS = ["kf_qcif", "inter_qcif", "odd_65x49", "lowrate_qcif",
           "profile1_qcif", "profile2_qcif", "profile3_qcif",
           "seg_roi_qcif", "kf_cif", "inter_cif", "part4_cif"]


@pytest.mark.parametrize("name", STREAMS)
def test_torch_decoder_bit_exact(name):
    golden = load_golden_md5s(vector(f"{name}.ivf.md5"))
    n = 0
    for i, planes in enumerate(decode_ivf_torch(vector(f"{name}.ivf"),
                                                device="cpu")):
        assert frame_md5(*planes) == golden[i], f"{name} frame {i}"
        n += 1
    assert n == len(golden)
