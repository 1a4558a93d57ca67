"""The port's analysis ops (libvpx_opencl_tpu_torch/ops/analysis_device.py)
and ARNR synthesis (models/arnr.py) vs the JAX package's jitted
ops/analysis_device.py and its host twins (models/me_host.py,
models/arnr.py, ops/metrics.py): twins of the five tests of
tests/test_analysis_device.py, on the same numpy-seeded planes, run on
CPU tensors. Exact equality everywhere but the SSIM (|diff| < 1e-5, the
JAX test's own tolerance).
"""
import numpy as np
import pytest
import torch

from libvpx_opencl_tpu.models import arnr as jarnr
from libvpx_opencl_tpu.models import me_host as jme_host
from libvpx_opencl_tpu.ops import analysis_device as JAD
from libvpx_opencl_tpu.ops import metrics as jmetrics
from libvpx_opencl_tpu_torch.models import arnr, me_host
from libvpx_opencl_tpu_torch.ops import analysis_device as AD
from libvpx_opencl_tpu_torch.ops import metrics


@pytest.fixture(scope="module")
def planes():
    rng = np.random.RandomState(11)
    h, w = 96, 128
    a = rng.randint(0, 255, size=(h, w)).astype(np.uint8)
    b = np.roll(a, (2, -3), (0, 1)).copy()
    b[40:56, 40:56] = rng.randint(0, 255, size=(16, 16))
    return a, b


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mc_range,step", [(7, 2), (4, 2), (3, 1)])
def test_fullpel_match_device_exact(planes, mc_range, step):
    a, b = planes
    got = [x.numpy() for x in AD.fullpel_match_device(*_t(a, b), mc_range,
                                                      step)]
    jax_out = JAD.fullpel_match_device(a, b, mc_range, step)
    for g, j, h, ph in zip(got, jax_out,
                           jme_host.fullpel_match(a, b, mc_range, step),
                           me_host.fullpel_match(a, b, mc_range, step)):
        _eq(g, j)
        _eq(g, h.astype(np.int32))
        _eq(ph, h)


def test_fullpel_match_ties_keep_the_first_offset():
    """A constant plane gives every offset the same SAD: strict-less keeps
    the first grid offset, (-mc_range, -mc_range), as the JAX function."""
    a = np.full((32, 48), 77, np.uint8)
    got = [x.numpy() for x in AD.fullpel_match_device(*_t(a, a), 5)]
    for g, j in zip(got, JAD.fullpel_match_device(a, a, 5)):
        _eq(g, j)
    assert (got[0] == -5).all() and (got[1] == -5).all()


def test_temporal_filter_apply_device_exact(planes):
    a, b = planes
    accum = np.zeros(a.shape, np.int32)
    count = np.zeros(a.shape, np.int32)
    w = np.full(a.shape, 2, np.int32)
    w[::3] = 1
    arnr._weighted_accumulate(a, b, 6, w, accum, count)
    z = np.zeros(a.shape, np.int32)
    da, dc = AD.temporal_filter_apply_device(*_t(a, b), 6, *_t(w, z, z))
    ja, jc = JAD.temporal_filter_apply_device(a, b, 6, w, z, z)
    for g, j, h in ((da, ja, accum), (dc, jc, count)):
        _eq(g.numpy(), j)
        _eq(g.numpy(), h)
    out = AD.temporal_filter_normalize_device(da, dc, _t(a)[0])
    _eq(out.numpy(), JAD.temporal_filter_normalize_device(ja, jc, a))
    # zero-count pixels keep the anchor value
    dc[:8] = 0
    out = AD.temporal_filter_normalize_device(da, dc, _t(a)[0]).numpy()
    _eq(out, JAD.temporal_filter_normalize_device(ja, dc.numpy(), a))
    _eq(out[:8], a[:8])


def test_variance_blocks_device(planes):
    a, b = planes
    sse_d, var_d = [x.numpy() for x in AD.variance_blocks_device(*_t(a, b))]
    sse_j, var_j = JAD.variance_blocks_device(a, b)
    _eq(sse_d, sse_j)
    _eq(var_d, var_j)
    # the extreme sum, 256 * 255 (JAX's hi/lo split; int64 here)
    z, f = np.zeros((16, 32), np.uint8), np.full((16, 32), 255, np.uint8)
    for x, y in ((f, z), (z, f)):
        got = [g.numpy() for g in AD.variance_blocks_device(*_t(x, y))]
        for g, j in zip(got, JAD.variance_blocks_device(x, y)):
            _eq(g, j)
        assert (got[0] == 256 * 255 * 255).all() and (got[1] == 0).all()


@pytest.mark.parametrize("shape", [(96, 128), (50, 70)])
def test_ssim_plane_device(planes, shape):
    a, b = (p[:shape[0], :shape[1]] for p in planes)
    dev = float(AD.ssim_plane_device(*_t(a, b)))
    assert abs(metrics.ssim_plane(a, b) - dev) < 1e-5
    assert abs(jmetrics.ssim_plane(a, b) - dev) < 1e-5
    assert abs(float(JAD.ssim_plane_device(a, b)) - dev) < 1e-5
    assert float(AD.ssim_plane_device(*_t(a, a))) == pytest.approx(1.0,
                                                                   abs=1e-6)


def _clip(h, w, seed):
    rng = np.random.RandomState(seed)
    frames = []
    base = rng.randint(0, 255, size=(h, w)).astype(np.uint8)
    for t in range(5):
        y = np.roll(base, t, axis=1)
        u = rng.randint(90, 170, size=((h + 1) // 2, (w + 1) // 2)) \
            .astype(np.uint8)
        v = np.full(((h + 1) // 2, (w + 1) // 2), 120, np.uint8)
        frames.append((y, u, v))
    return frames


@pytest.mark.parametrize("h,w,seed", [(48, 64, 5), (49, 65, 6)])
def test_synthesize_altref_device_matches_host(h, w, seed):
    frames = _clip(h, w, seed)
    host = arnr.synthesize_altref(frames, 2)
    dev = arnr.synthesize_altref(frames, 2, device="cpu")
    jax_dev = jarnr.synthesize_altref(frames, 2, device=True)
    jax_host = jarnr.synthesize_altref(frames, 2)
    for hp, dp, jd, jh in zip(host, dev, jax_dev, jax_host):
        assert isinstance(dp, np.ndarray)
        _eq(dp, hp)
        _eq(dp, jd)
        _eq(hp, jh)


def test_synthesize_altref_true_means_cuda(monkeypatch):
    """device=True asks for "cuda" (which raises without a card); a
    device name or torch.device runs the match and the accumulation on
    that device; False and None run the NumPy path."""
    assert arnr._torch_device(True) == torch.device("cuda")
    assert arnr._torch_device("cpu") == torch.device("cpu")
    assert arnr._torch_device(torch.device("cpu")) == torch.device("cpu")
    assert arnr._torch_device(False) is None
    assert arnr._torch_device(None) is None
    seen = []
    real = AD.temporal_filter_apply_device

    def spy(base, pred, *rest):
        seen.append((base.device, pred.device))
        return real(base, pred, *rest)

    monkeypatch.setattr(AD, "temporal_filter_apply_device", spy)
    frames = _clip(32, 32, 1)
    arnr.synthesize_altref(frames, 2)
    assert seen == []
    arnr.synthesize_altref(frames, 2, device=torch.device("cpu"))
    assert seen == [(torch.device("cpu"),) * 2] * 15
