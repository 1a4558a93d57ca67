"""The port's copies of the JAX package's NumPy-only encoder tools
(models/{twopass,layers,multires,lookahead}.py, ops/scale.py,
utils/{y4m,webm}.py) give the JAX modules' outputs, exactly, on small
seeded clips.
"""
import dataclasses

import numpy as np
import pytest

from libvpx_opencl_tpu.models import layers as jlayers
from libvpx_opencl_tpu.models import multires as jmultires
from libvpx_opencl_tpu.models import twopass as jtwopass
from libvpx_opencl_tpu.models.encoder import Encoder as JEncoder
from libvpx_opencl_tpu.ops import scale as jscale
from libvpx_opencl_tpu.utils import webm as jwebm
from libvpx_opencl_tpu.utils import y4m as jy4m
from libvpx_opencl_tpu_torch.models import (layers, lookahead, multires,
                                            twopass)
from libvpx_opencl_tpu_torch.models.encoder import Encoder
from libvpx_opencl_tpu_torch.ops import scale
from libvpx_opencl_tpu_torch.utils import webm, y4m
from test_encoder import synth
from test_twopass import two_scene_clip


def test_first_pass_stats_and_controller(tmp_path):
    frames = two_scene_clip(64, 48, 10, 6)
    got = twopass.first_pass(frames)
    want = jtwopass.first_pass(frames)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    twopass.save_stats(str(tmp_path / "fpf.json"), got)
    assert twopass.load_stats(str(tmp_path / "fpf.json")) == got
    rc = twopass.TwoPassController(got, 300, 30.0, 12)
    jrc = jtwopass.TwoPassController(want, 300, 30.0, 12)
    assert rc.kf_positions == jrc.kf_positions and 6 in rc.kf_positions
    assert rc.arf_center_of == jrc.arf_center_of
    qs, jqs = [], []
    for _ in frames:
        for c, out in ((rc, qs), (jrc, jqs)):
            kf = c.want_keyframe()
            q = c.frame_q(kf)
            c.update(q, 4000 + 37 * q, kf)
            out.append((kf, q))
    assert qs == jqs


def test_temporal_layers():
    frames = synth(64, 48, 4)
    out = []
    for L, E in ((layers, Encoder), (jlayers, JEncoder)):
        tl = L.TemporalLayerEncoder(E(64, 48, qindex=30), pattern="L1T2",
                                    layer_bitrates_kbps=(100, 200), fps=30.0)
        out.append([tl.encode_frame(*f) for f in frames])
    assert out[0] == out[1]
    assert [layer for _, layer in out[0]] == [0, 1, 0, 1]


def test_multires():
    frames = synth(64, 48, 2)
    out = []
    for M, kw in ((multires, dict(use_device=False)), (jmultires, {})):
        enc = M.MultiResEncoder(64, 48, qindices=(36, 32), **kw)
        out.append([enc.encode_frame(*f) for f in frames])
    assert out[0] == out[1]
    np.testing.assert_array_equal(
        multires.downsample2(frames[0][0]),
        jmultires.downsample2(frames[0][0]))


@pytest.mark.parametrize("out_h,out_w", [(288, 352), (60, 80), (37, 53)])
def test_scale(out_h, out_w):
    rng = np.random.RandomState(out_h)
    y = rng.randint(0, 255, (144, 176), np.uint8)
    u = rng.randint(0, 255, (72, 88), np.uint8)
    np.testing.assert_array_equal(scale.bicubic_scale_plane(y, out_h, out_w),
                                  jscale.bicubic_scale_plane(y, out_h, out_w))
    for g, w in zip(scale.scale_frame(y, u, u, out_w, out_h),
                    jscale.scale_frame(y, u, u, out_w, out_h)):
        np.testing.assert_array_equal(g, w)


def test_y4m_webm_lookahead(tmp_path):
    frames = synth(48, 32, 3)
    y4m.write_y4m(str(tmp_path / "t.y4m"), frames, 48, 32, fps=(25, 1))
    jy4m.write_y4m(str(tmp_path / "j.y4m"), frames, 48, 32, fps=(25, 1))
    assert (tmp_path / "t.y4m").read_bytes() == \
        (tmp_path / "j.y4m").read_bytes()
    rd = y4m.Y4MReader(str(tmp_path / "j.y4m"))
    assert (rd.w, rd.h, rd.fps) == (48, 32, (25, 1))
    back = list(rd)
    assert all(np.array_equal(a, b) for f, g in zip(back, frames)
               for a, b in zip(f, g))

    pk = [(bytes([i, 1, 2, 3]) * (i + 1), 33 * i, i == 0) for i in range(4)]
    for mod, tag in ((webm, "t"), (jwebm, "j")):
        ws = mod.WebMStream(width=48, height=32)
        ws.frames.extend(pk)
        mod.write_webm(str(tmp_path / f"{tag}.webm"), ws)
    assert (tmp_path / "t.webm").read_bytes() == \
        (tmp_path / "j.webm").read_bytes()
    ws = webm.read_webm(str(tmp_path / "j.webm"))
    assert (ws.width, ws.height) == (48, 32)
    assert ws.frames == jwebm.read_webm(str(tmp_path / "j.webm")).frames
    assert [f[0] for f in ws.frames] == [p[0] for p in pk]

    la = lookahead.Lookahead(max_lag=2)
    la.push(*frames[0])
    la.push(*frames[1], pts=1)
    assert la.full() and la.depth() == 2
    with pytest.raises(IndexError):
        la.push(*frames[2])
    assert la.peek(1)[3] == 1 and la.peek(2) is None
    assert np.array_equal(la.pop()[0], frames[0][0]) and la.depth() == 1
