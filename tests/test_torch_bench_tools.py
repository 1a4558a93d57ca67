"""The port's benchmark scripts on the CPU at small sizes: bench_torch.py
(the twin of bench.py), tools/bench_entropy_torch.py and
tools/bench_encode_torch.py. On the CPU they measure no device; these
tests hold their gates, their output lines and their results."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from conftest import vector

import bench_torch
from libvpx_opencl_tpu_torch.models.torch_encoder import TorchEncoder

torch.set_num_threads(1)
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def small_bench(monkeypatch):
    monkeypatch.setattr(bench_torch, "STREAM", vector("inter_qcif.ivf"))
    monkeypatch.setenv("BENCH_RUNS", "1")


def test_bench_torch_line_on_cpu(small_bench, capsys):
    assert bench_torch.main(device="cpu") == 0
    line = _last_json(capsys.readouterr().out)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "1080p_decode_fps_bit_exact_torch"
    assert line["unit"] == "frames/s/cpu"
    assert line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] /
                                        bench_torch.BASELINE_FPS, 3)


def test_bench_torch_fails_when_not_bit_exact(small_bench, monkeypatch,
                                              capsys):
    golden = bench_torch.load_golden_md5s(vector("inter_qcif.ivf.md5"))
    golden[3] = "0" * 32
    monkeypatch.setattr(bench_torch, "load_golden_md5s", lambda _p: golden)
    assert bench_torch.main(device="cpu") == 1
    line = _last_json(capsys.readouterr().out)
    assert line["value"] == 0 and line["vs_baseline"] == 0


def test_bench_entropy_torch_on_cpu(capsys):
    tool = _tool("bench_entropy_torch")
    summary = tool.main([vector("part4_cif.ivf"), "--cpu", "--frames", "2"])
    line = _last_json(capsys.readouterr().out)
    assert line == json.loads(json.dumps(summary))
    assert line["frames"] == 2 and line["partitions"] == 4
    assert line["mbs"] == [18, 22] and line["device"] == "cpu"
    assert line["k4_ms_key"] is None and line["k4_ms_inter"] is None
    assert line["coef_upload_bytes"] == 18 * 22 * 25 * 16 * 2
    rows = line["rows"]
    assert [r["frame"] for r in rows] == [0, 1] and rows[0]["key"]
    assert all(len(r["partition_bytes"]) == 4 for r in rows)


def test_bench_encode_torch_on_cpu(capsys):
    tool = _tool("bench_encode_torch")
    out, payloads = tool.main(["--w", "64", "--h", "64", "--frames", "3",
                               "--device", "cpu", "--skip-ref"])
    line = _last_json(capsys.readouterr().out)
    assert line == out
    assert set(line) == {"torch_speed0"}
    assert set(line["torch_speed0"]) == {"fps", "bytes", "psnr_y"}
    assert line["torch_speed0"]["bytes"] == sum(len(p) for p in payloads)
    assert line["torch_speed0"]["psnr_y"] > 30
    enc = TorchEncoder(64, 64, qindex=24, cpu_used=0, device="cpu")
    frames = tool.synth_clip(64, 64, 3, seed=42)
    want = [enc.encode_frame(*f, keyframe=(i == 0))
            for i, f in enumerate(frames)]
    assert payloads == want
    assert all(isinstance(p, bytes) and p for p in payloads)
    assert np.isfinite(line["torch_speed0"]["fps"])
