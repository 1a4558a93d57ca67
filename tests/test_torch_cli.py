"""The port's CLIs (libvpx_opencl_tpu_torch/cli/) vs the golden MD5 files
and the JAX package's CLIs: tpuvpxdec on TorchDecoder (device="cpu")
prints the golden MD5s and writes what the JAX tpuvpxdec writes (output
patterns, --yv12, WebM input); tpuvpxenc with --golden (the host
Encoder) writes the JAX tpuvpxenc's bytes (1-pass, two-pass, ARNR
altref). The device encoder's CLI paths are in test_torch_cli_device.py.
"""
import numpy as np
import pytest

from conftest import vector
from libvpx_opencl_tpu.cli import tpuvpxdec as jdec
from libvpx_opencl_tpu.cli import tpuvpxenc as jenc
from libvpx_opencl_tpu_torch.cli import tpuvpxdec as tdec
from libvpx_opencl_tpu_torch.cli import tpuvpxenc as tenc
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
from libvpx_opencl_tpu_torch.utils.webm import WebMStream, write_webm
from libvpx_opencl_tpu_torch.utils.y4m import write_y4m


def _port(capsys, argv):
    assert tdec.main(argv, device="cpu") == 0
    return capsys.readouterr()


def _golden(name):
    return [ln.split()[0] for ln in open(vector(f"{name}.ivf.md5"))]


@pytest.mark.parametrize("name", ["kf_qcif", "odd_65x49", "part4_cif"])
def test_md5_matches_golden(capsys, name):
    out = _port(capsys, [vector(f"{name}.ivf"), "--md5"]).out
    lines = out.splitlines()
    assert [ln.split()[0] for ln in lines] == _golden(name)
    assert [ln.split()[1] for ln in lines] == \
        [f"frame-{i + 1}" for i in range(len(lines))]


def test_golden_flag_and_summary(capsys):
    got = _port(capsys, [vector("kf_qcif.ivf"), "--md5", "--golden",
                         "--summary"])
    assert [ln.split()[0] for ln in got.out.splitlines()] == \
        _golden("kf_qcif")
    assert "3 decoded frames/3 showed frames" in got.err


def test_output_patterns_and_yv12(capsys, tmp_path):
    """-o with %w/%h/%<n> (one file per frame), a single -o file with
    --yv12 and --limit, and --md5 with a pattern: the JAX CLI's files and
    lines (the JAX CLI on its host decoder, --golden)."""
    for tag, mod in (("t", None), ("j", jdec)):
        d = tmp_path / tag
        d.mkdir()
        runs = [["-o", str(d / "f-%wx%h-%3.yuv")],
                ["-o", str(d / "all.yv12"), "--yv12", "--limit", "3"],
                ["--md5", "-o", "out-%w-%h-%2"]]
        for extra in runs:
            argv = [vector("inter_qcif.ivf"), *extra]
            if mod is None:
                out = _port(capsys, argv).out
            else:
                assert mod.main([*argv, "--golden"]) == 0
                out = capsys.readouterr().out
            (d / f"stdout{runs.index(extra)}").write_text(out)
    t, j = tmp_path / "t", tmp_path / "j"
    names = sorted(p.name for p in t.iterdir())
    assert names == sorted(p.name for p in j.iterdir())
    assert "f-176x144-001.yuv" in names and "f-176x144-010.yuv" in names
    for n in names:
        assert (t / n).read_bytes() == (j / n).read_bytes(), n
    assert (t / "stdout2").read_text().splitlines()[0].endswith(
        "out-176-144-01")
    frame = (t / "f-176x144-002.yuv").read_bytes()
    yv12 = (t / "all.yv12").read_bytes()
    ny, nc = 176 * 144, 88 * 72
    assert len(yv12) == 3 * (ny + 2 * nc)
    # YV12 = Y, V, U: frame 2's planes with U and V swapped
    second = yv12[ny + 2 * nc:2 * (ny + 2 * nc)]
    assert second == frame[:ny] + frame[ny + nc:] + frame[ny:ny + nc]


def test_webm_input(capsys, tmp_path):
    """WebM input (EBML magic), muxed as tests/test_webm.py:_mux does."""
    ivf = read_ivf(vector("inter_qcif.ivf"))
    ws = WebMStream(width=ivf.width, height=ivf.height)
    for i, (payload, _pts) in enumerate(ivf.frames):
        ws.frames.append((payload, i * 33, not (payload[0] & 1)))
    path = str(tmp_path / "inter_qcif.webm")
    write_webm(path, ws)
    out = _port(capsys, [path, "--md5"]).out
    assert [ln.split()[0] for ln in out.splitlines()] == \
        _golden("inter_qcif")


def _clip(tmp_path, n, w=96, h=64):
    rng = np.random.RandomState(21)
    base = rng.randint(0, 255, (h + 24, w + 2 * n), np.uint8)
    frames = [(base[i:i + h, 2 * i:2 * i + w].copy(),
               np.full((h // 2, w // 2), 118 + i, np.uint8),
               np.full((h // 2, w // 2), 132, np.uint8)) for i in range(n)]
    path = str(tmp_path / "clip.y4m")
    write_y4m(path, frames, w, h)
    return path


@pytest.mark.parametrize("n,opts", [
    (4, ["--target-bitrate", "200"]),
    (6, ["--passes", "2", "--target-bitrate", "200", "--cpu-used", "8"]),
    # lag 4: a GF group every 4 frames, so frame 4 is preceded by an ARF
    (8, ["--auto-alt-ref", "1", "--lag-in-frames", "4", "--end-usage", "cq",
         "--cpu-used", "8"]),
], ids=["one_pass", "two_pass", "auto_alt_ref"])
def test_tpuvpxenc_bytes_match_jax(tmp_path, n, opts):
    clip = _clip(tmp_path, n)
    outs = []
    # the port's CLI on its host encoder (--golden), as the JAX CLI runs
    for mod, tag, extra in ((jenc, "j", []), (tenc, "t", ["--golden"])):
        out = str(tmp_path / f"{tag}.ivf")
        assert mod.main([clip, "-o", out, *opts, *extra]) == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    frames = read_ivf(outs[1]).frames
    assert len(frames) >= n
    if "--auto-alt-ref" in opts:
        # an invisible ALTREF update (show_frame 0) was written
        assert any(not (p[0] >> 4) & 1 for p, _ in frames)
