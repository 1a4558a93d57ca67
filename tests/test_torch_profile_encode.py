"""tools/profile_torch_encode.py on the CPU (--device cpu): a synthetic
64x64 clip through the plain path under both feature sets. It measures no
device here; the test holds the tool's stages and its JSON line."""
import importlib.util
import json
import os

import torch

torch.set_num_threads(1)
TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "profile_torch_encode.py")


def test_profile_torch_encode_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location("profile_torch_encode",
                                                  TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tool.main(["--device", "cpu", "--w", "64", "--h", "64",
                     "--frames", "2"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0] == "cpu (no device measurement)"
    assert json.loads(printed[-1]) == json.loads(json.dumps(out))
    assert out["device"] == "cpu" and out["frames"] == 2
    for name in ("default", "slice2"):
        rows = [out[name]["keyframe_s"]] + out[name]["inter_frames_s"]
        assert len(rows) == 2 and "profiled_inter_frame" not in out[name]
        for row in rows:
            # the plain path: no K5; the wavefront holds its level steps
            assert "k5" not in row
            assert 0 < row["level_steps"] <= row["encode_wavefront"] \
                <= row["encode"] <= row["total"]
            assert row["intra_mbs"] > 0 and row["levels"] >= 1
            # CPU tensors: the trellis's plain version, no K6 launch
            assert row["k6_launches"] == 0
    assert out["default"]["inter_frames_s"][0]["bpred_mbs"] > 0
    assert out["default"]["inter_frames_s"][0]["bpred_lanes"] > 0
    assert out["default"]["inter_frames_s"][0]["trellis"] > 0
    assert "trellis" not in out["slice2"]["inter_frames_s"][0]
    assert "bpred_lanes" not in out["slice2"]["keyframe_s"]
