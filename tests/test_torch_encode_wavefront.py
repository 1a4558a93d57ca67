"""Port encode wavefront vs the JAX package, exact equality (integer math,
tolerance 0).

models/wavefront.py:encode_recon_blocks of both packages (the JAX one
without its B_PRED lanes and external coefficients: tcb3=None, no q_ext)
on the same seeded numpy inputs: random sources and inter predictions,
random intra flags and DC/V/H/TM modes, per-MB quantizers, at (4,6) and at
the degenerate grids (1,5) and (5,1), plus an all-intra and an all-inter
(4,6) frame. Each JAX geometry compiles once (module-scoped).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.models import wavefront as jwf
from libvpx_opencl_tpu_torch.models import wavefront as twf

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_encode(R, C):
    sch = jwf.schedule(R, C)
    return jax.jit(lambda *a: jwf.encode_recon_blocks(R, C, sch, *a))


def _case(R, C, seed, intra_share):
    rng = np.random.default_rng(seed)
    N = R * C
    src = [rng.integers(0, 256, (N, n, n)).astype(np.int32)
           for n in (16, 8, 8)]
    # predictions near the source (small residuals, many zero blocks) for
    # half of the MBs, far from it for the rest
    near = rng.random(N) < 0.5
    inter = []
    for s in src:
        noise = rng.integers(-6, 7, s.shape)
        far = rng.integers(0, 256, s.shape)
        inter.append(np.where(near[:, None, None],
                              np.clip(s + noise, 0, 255), far)
                     .astype(np.int32))
    mode = rng.integers(0, 4, N).astype(np.int32)
    uv_mode = rng.integers(0, 4, N).astype(np.int32)
    intra = rng.random(N) < intra_share
    dq = [rng.integers(4, 158, (N, 2)).astype(np.int32) for _ in range(3)]
    qidx = rng.integers(0, 128, N).astype(np.int32)
    return src + inter + [mode, uv_mode, intra] + dq + [qidx]


@pytest.mark.parametrize("R,C,intra_share", [
    (4, 6, 0.5), (4, 6, 1.0), (4, 6, 0.0), (1, 5, 0.6), (5, 1, 0.6)])
def test_encode_recon_blocks_matches_jax(R, C, intra_share):
    args = _case(R, C, 100 * R + C, intra_share)
    want = _jax_encode(R, C)(*(jnp.asarray(a) for a in args))
    got = twf.encode_recon_blocks(
        R, C, *(torch.from_numpy(a) for a in args))
    names = ("qcoeff", "eobs", "recon_y", "recon_u", "recon_v", "bmodes")
    assert len(got) == len(want) == 6
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    qcoeff, eobs = got[0].numpy(), got[1].numpy()
    assert (eobs[:, :16] >= 1).all()           # Y blocks: DC goes in Y2
    assert (qcoeff != 0).any() and (eobs[:, 24] > 1).any()
    assert not got[5].any()


def test_transform_quant_recon_dc_only_y2():
    """A flat residual quantizes to a Y2 block with only its DC: the
    e2 <= 1 branch of the reconstruction (dc-only inverse WHT)."""
    M = 3
    src = [torch.full((M, n, n), 100, dtype=torch.int32) for n in (16, 8, 8)]
    pred = [torch.full((M, n, n), 90, dtype=torch.int32) for n in (16, 8, 8)]
    dq = torch.tensor([[8, 10]] * M, dtype=torch.int32)
    qidx = torch.full((M,), 24, dtype=torch.int32)
    q, e, ry, ru, rv = twf.transform_quant_recon(*src, *pred, dq, dq, dq,
                                                 qidx)
    assert (e[:, 24] == 1).all() and (q[:, 24, 0] != 0).all()
    assert (e[:, :16] == 1).all() and not q[:, :16].any()
    assert (ry == ry[:, :1, :1]).all() and (ry - 100).abs().max() <= 1


def test_intra_levels_respect_the_prediction_dependencies():
    """All-intra: level r + c. In general: an intra MB lies above its
    left, above and above-left intra neighbours' levels, inter MBs carry
    -1, and every level from 0 to the highest is in use."""
    R, C = 5, 7
    lv = twf.intra_levels(R, C, np.ones(R * C, bool)).reshape(R, C)
    np.testing.assert_array_equal(lv, np.add.outer(np.arange(R),
                                                   np.arange(C)))
    rng = np.random.default_rng(5)
    intra = rng.random((R, C)) < 0.45
    lv = twf.intra_levels(R, C, intra.reshape(-1)).reshape(R, C)
    assert (lv[~intra] == -1).all() and (lv[intra] >= 0).all()
    for r in range(R):
        for c in range(C):
            if not intra[r, c]:
                continue
            deps = [lv[rr, cc] for rr, cc in ((r, c - 1), (r - 1, c),
                                              (r - 1, c - 1))
                    if rr >= 0 and cc >= 0]
            assert lv[r, c] == 1 + max(deps, default=-1)
    assert set(lv[intra]) == set(range(lv.max() + 1))
    assert lv.max() < R + C - 2        # sparse intra MBs: a shorter walk
