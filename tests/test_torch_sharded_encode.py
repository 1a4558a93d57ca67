"""ShardedTorchEncoder (libvpx_opencl_tpu_torch/parallel/sharded_encode.py)
vs TorchEncoder: payload bytes equal (tolerance 0) under the same
SpeedFeatures with B_PRED off, on CPU tensors; the twins of
tests/test_sharded_encode.py. The case held directly against the JAX
ShardedTPUEncoder is tests/test_torch_sharded_encode_jax.py.

* 4 and 8 shards of 176x128 (8 MB rows), cpu_used 7, 3 frames;
* the trellis + multi-reference ladder (cpu_used 2) with a golden refresh
  at 4 shards, 4 frames;
* SLICE2_SF (the exhaustive step-1 search, the K3 route) at 176x144: 4
  shards of 9 MB rows (3, 2, 2, 2), 3 frames;
* B_PRED is forced off at construction, as in the JAX class;
* `FrameInputs.rows`, the one place a shard's inputs are cut, over 2-4
  shards: every per-MB field (the tables' too) and nothing else.
"""
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu_torch.models import torch_encoder as TE
from libvpx_opencl_tpu_torch.parallel import sharded_wavefront as SW
from libvpx_opencl_tpu_torch.parallel.mesh import make_row_mesh
from libvpx_opencl_tpu_torch.parallel.sharded_encode import \
    ShardedTorchEncoder
from test_encoder import synth

torch.set_num_threads(1)


def frames_176x128(n):
    """tests/test_sharded_encode.py's frames."""
    rng = np.random.RandomState(9)
    w, h = 176, 128
    base = rng.randint(0, 255, size=(h, w)).astype(np.uint8)
    base[: h // 2, : w // 2] = 128
    out = []
    for t in range(n):
        y = np.roll(base, 2 * t, axis=1).copy()
        y[h - 16:, :16] = rng.randint(0, 255, size=(16, 16))
        u = rng.randint(90, 170, size=(h // 2, w // 2)).astype(np.uint8)
        v = np.full((h // 2, w // 2), 120, np.uint8)
        out.append((y, u, v))
    return out


def encode_all(enc, frames):
    return [enc.encode_frame(y, u, v, keyframe=(i == 0))
            for i, (y, u, v) in enumerate(frames)]


def sharded(n, *args, **kwargs):
    return ShardedTorchEncoder(*args, mesh=make_row_mesh(n, device="cpu"),
                               **kwargs)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_sharded_encode_bit_exact(n_shards):
    frames = frames_176x128(3)
    ref = TE.TorchEncoder(176, 128, qindex=40, cpu_used=7, device="cpu")
    ref.sf = replace(ref.sf, bpred=False)
    want = encode_all(ref, frames)
    got = encode_all(sharded(n_shards, 176, 128, qindex=40, cpu_used=7),
                     frames)
    assert [len(p) for p in got] == [len(p) for p in want]
    assert got == want


def test_sharded_encode_bit_exact_trellis_multiref():
    frames = frames_176x128(4)
    ref = TE.TorchEncoder(176, 128, qindex=36, cpu_used=2, device="cpu")
    ref.sf = replace(ref.sf, bpred=False, exhaustive_me=False)
    enc = sharded(4, 176, 128, qindex=36, cpu_used=2)
    assert enc.sf.trellis and not enc.sf.bpred
    out = []
    for e in (ref, enc):
        out.append([e.encode_frame(*frames[0], keyframe=True),
                    e.encode_frame(*frames[1]),
                    e.encode_frame(*frames[2], refresh_golden=True),
                    e.encode_frame(*frames[3])])
    assert out[1] == out[0]


def test_sharded_encode_slice2_rows_not_divisible():
    frames = synth(176, 144, 3)
    ref = TE.TorchEncoder(176, 144, qindex=24, device="cpu")
    ref.sf = TE.SLICE2_SF
    enc = sharded(4, 176, 144, qindex=24)
    enc.sf = TE.SLICE2_SF
    assert [r1 - r0 for r0, r1 in enc.rows] == [3, 2, 2, 2]
    assert encode_all(enc, frames) == encode_all(ref, frames)
    for a, b in zip(enc.ref_last.visible(), ref.ref_last.visible()):
        np.testing.assert_array_equal(a, b)


def test_bpred_forced_off():
    enc = sharded(2, 64, 64, qindex=40)
    assert not enc.sf.bpred
    assert TE.TorchEncoder(64, 64, device="cpu").sf.bpred


@pytest.fixture(scope="module")
def frame_inputs():
    """The FrameInputs an inter frame's encode hook gets (80x64: N = 20
    MBs, a length no replicated field has)."""
    enc = TE.TorchEncoder(80, 64, qindex=40, cpu_used=7, device="cpu")
    seen = []

    def keep(fi, has_bpred):
        seen.append(fi)
        return TE._encode_device(fi, has_bpred)
    enc._encode_fn = keep
    encode_all(enc, [(y[:64, :80], u[:32, :40], v[:32, :40])
                     for y, u, v in frames_176x128(2)])
    return seen[-1]


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_frame_inputs_rows_cut_every_per_mb_field(frame_inputs, n_shards):
    fi = frame_inputs
    N = fi.R * fi.C
    rows = SW.split_rows(fi.R, n_shards)
    views = [fi.rows(r0, r1, torch.device("cpu")) for r0, r1 in rows]
    assert [v.R for v in views] == [r1 - r0 for r0, r1 in rows]
    for whole, parts in ((fi, views), (fi.tables, [v.tables for v in views])):
        for f in fields(whole):
            want = getattr(whole, f.name)
            got = [getattr(p, f.name) for p in parts]
            if f.metadata.get("per_mb"):
                # per-MB: the shards' parts are the whole frame's MBs
                assert want.shape[0] == N, f.name
                cat = np.concatenate if isinstance(want, np.ndarray) \
                    else torch.cat
                assert (cat(got) == want).all(), f.name
                assert [len(g) for g in got] == [(r1 - r0) * fi.C
                                                 for r0, r1 in rows]
            elif isinstance(want, torch.Tensor):
                # replicated: whole on every shard (first dim is not N)
                assert want.dim() == 0 or want.shape[0] != N, f.name
                assert all(torch.equal(g, want) for g in got), f.name
