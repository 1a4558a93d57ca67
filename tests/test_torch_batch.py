"""BatchTranscoder (parallel/batch.py): the twins of tests/test_batch.py
(checkpoint/resume and job sharding, on the host path as the JAX test
runs it), and the device path on CPU tensors against a sequential
TorchDecoder + TorchEncoder transcode of the same jobs."""
import json
import os

import pytest
import torch

from conftest import vector
from libvpx_opencl_tpu_torch.models.torch_decoder import TorchDecoder
from libvpx_opencl_tpu_torch.models.torch_encoder import TorchEncoder
from libvpx_opencl_tpu_torch.parallel.batch import BatchTranscoder
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf

torch.set_num_threads(1)
JOBS = [vector("kf_qcif.ivf"), vector("lowrate_qcif.ivf")]


def test_batch_transcode_resume(tmp_path):
    out = str(tmp_path / "out")
    bt = BatchTranscoder(JOBS, out, qindex=40, use_device=False)
    state = bt.run()
    assert len(state["done"]) == 2
    assert all(s["frames"] > 0 for s in state["stats"].values())
    assert set(state["stats"]["kf_qcif.ivf"]) == {"frames", "seconds",
                                                  "out_bytes"}
    # resume: nothing left to do, checkpoint remembered
    bt2 = BatchTranscoder(JOBS, out, qindex=40, use_device=False)
    before = json.dumps(bt2.state, sort_keys=True)
    state2 = bt2.run()
    assert json.dumps(state2, sort_keys=True) == before


def test_batch_sharding(tmp_path):
    b0 = BatchTranscoder(JOBS, str(tmp_path / "s0"), shard_index=0,
                         shard_count=2)
    b1 = BatchTranscoder(JOBS, str(tmp_path / "s1"), shard_index=1,
                         shard_count=2)
    assert b0.jobs == [JOBS[0]]
    assert b1.jobs == [JOBS[1]]


def test_batch_device_path_matches_sequential_transcode(tmp_path):
    out = str(tmp_path / "dev")
    state = BatchTranscoder(JOBS, out, qindex=40, device="cpu").run()
    for job in JOBS:
        src = read_ivf(job)
        dec = TorchDecoder(device="cpu")
        enc = TorchEncoder(src.width, src.height, qindex=40, device="cpu")
        want = []
        for payload, pts in src.frames:
            if dec.decode_frame_core(payload):
                want.append((enc.encode_frame(
                    *dec.frame_to_show.visible()), pts))
        name = os.path.basename(job)
        got = read_ivf(os.path.join(out, name))
        assert got.frames == want, name
        assert state["stats"][name]["frames"] == len(want)


def test_batch_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        BatchTranscoder(JOBS[:1], str(tmp_path / "c")).run()
