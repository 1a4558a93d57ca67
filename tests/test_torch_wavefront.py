"""Port wavefronts vs the JAX wavefronts, exact equality: K2 here, K1 in
tests/test_torch_intra.py (split to keep each file's run short).

The same numpy inputs (made from a seed) go through
libvpx_opencl_tpu.models.wavefront.loop_filter_blocks (the golden XLA
wavefront, itself MD5-verified) and through the port's loop_filter_plain,
at the four geometries of tests/test_pallas_decode.py, normal and simple
filter. Every stage is integer math: tolerance 0. On CPU tensors the
public wrapper loop_filter runs the plain version and must agree too; the
kernel paths (CUDA only) are held against the plain versions by the
card-marked test below and by chip_smoke.py.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.models import wavefront as wf
from libvpx_opencl_tpu_torch.ops import wavefront as W

torch.set_num_threads(1)

GEOMS = [(4, 6), (3, 3), (1, 5), (5, 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run by chip_smoke.py)")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _intra_case(rng, R, C):
    N = R * C
    inter_y = rng.integers(0, 256, (N, 16, 16)).astype(np.int32)
    inter_u = rng.integers(0, 256, (N, 8, 8)).astype(np.int32)
    inter_v = rng.integers(0, 256, (N, 8, 8)).astype(np.int32)
    ry = rng.integers(-80, 80, (N, 16, 16)).astype(np.int32)
    ru = rng.integers(-80, 80, (N, 8, 8)).astype(np.int32)
    rv = rng.integers(-80, 80, (N, 8, 8)).astype(np.int32)
    # mode 4 = B_PRED; every 16x16 / chroma / B sub-mode appears
    mode = rng.integers(0, 5, N).astype(np.int32)
    uv_mode = rng.integers(0, 4, N).astype(np.int32)
    intra = rng.random(N) < 0.6
    bmodes = rng.integers(0, 10, (N, 16)).astype(np.int32)
    return (inter_y, inter_u, inter_v, ry, ru, rv, mode, uv_mode, intra,
            bmodes)


def _lf_case(rng, R, C):
    N = R * C
    yb = rng.integers(0, 256, (N, 16, 16)).astype(np.int32)
    ub = rng.integers(0, 256, (N, 8, 8)).astype(np.int32)
    vb = rng.integers(0, 256, (N, 8, 8)).astype(np.int32)
    flevel = rng.integers(0, 64, N).astype(np.int32)
    flevel[rng.random(N) < 0.2] = 0
    noskip = (rng.random(N) < 0.7).astype(np.int32)
    mblim = (2 * (flevel + 2) + 1).astype(np.int32)
    blim = (2 * flevel + 1).astype(np.int32)
    lim = np.maximum(flevel // 2, 1).astype(np.int32)
    hev = np.clip(flevel // 16 + 1, 0, 3).astype(np.int32)
    return yb, ub, vb, flevel, mblim, blim, lim, hev, noskip


@pytest.mark.parametrize("R,C", GEOMS)
@pytest.mark.parametrize("simple", [False, True])
def test_loop_filter_plain_matches_jax(R, C, simple):
    case = _lf_case(np.random.default_rng(R * 100 + C + int(simple)), R, C)
    want = jax.jit(functools.partial(wf.loop_filter_blocks, R, C,
                                     wf.schedule(R, C), simple))(
        *[jnp.asarray(a) for a in case])
    got = W.loop_filter_plain(R, C, simple, *[_t(a) for a in case])
    wrapped = W.loop_filter(R, C, simple, *[_t(a) for a in case])
    for w, g, g2 in zip(want, got, wrapped):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g2.numpy(), np.asarray(w))


def test_plane_wrappers_count_no_cpu_launches():
    """On CPU tensors the plane-level wrappers run the plain versions and
    launch nothing, so the launch counters stay put."""
    R, C = 2, 3
    case = _intra_case(np.random.default_rng(7), R, C)
    before = dict(W.launches)
    out = W.intra_recon(R, C, *[_t(a) for a in case])
    W.loop_filter(R, C, False, *out, *[_t(a) for a in
                                       _lf_case(np.random.default_rng(8),
                                                R, C)[3:]])
    assert W.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("R,C", [(4, 6), (1, 1), (5, 1)])
def test_kernels_match_plain_on_card(cuda_device, R, C):
    """K1 and K2 on the card equal their plain versions, one launch each
    per call (runs where a CUDA card and nvcc exist; chip_smoke.py covers
    the full geometries)."""
    dev = cuda_device
    before = dict(W.launches)
    case = _intra_case(np.random.default_rng(3), R, C)
    args = [_t(a).to(dev) for a in case]
    for g, w in zip(W.intra_recon(R, C, *args),
                    W.intra_recon_plain(R, C, *args)):
        assert torch.equal(g, w)
    lcase = [_t(a).to(dev) for a in _lf_case(np.random.default_rng(4), R, C)]
    for simple in (False, True):
        for g, w in zip(W.loop_filter(R, C, simple, *lcase),
                        W.loop_filter_plain(R, C, simple, *lcase)):
            assert torch.equal(g, w)
    assert W.launches["intra_wavefront"] == before["intra_wavefront"] + 1
    assert W.launches["lf_wavefront"] == before["lf_wavefront"] + 2
