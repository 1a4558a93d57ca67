"""Port trellis (optimize_b) vs the JAX package, exact equality (tolerance 0).

ops/rd_device.py:trellis_batch of both packages on the same seeded blocks,
the JAX one under jax.jit as the JAX encoder runs it: for each of the three
plane setups the encoder uses (Y with Y2: i0 1, x4.0; Y2: i0 0, x16.0; UV:
i0 0, x2.0), at qindex 0, 4, 10, 19, 24, 40, 80 and 127 (rdmult/rddiv as
the encoder derives them), with entropy contexts 0-2. The blocks are "real"
(coefficients from fdct4x4_batch of random residuals, large and small) and
"random" (sparse random coefficient values), their levels from
regular_quant_batch. Levels and eobs must be equal; at qindex 24 the
trellis must change levels on every plane, or the comparison would prove
nothing.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.models.encoder import _default_token_costs
from libvpx_opencl_tpu.ops import rd_device as JRD
from libvpx_opencl_tpu_torch.models import rdopt
from libvpx_opencl_tpu_torch.models.refdec import dequant_factors
from libvpx_opencl_tpu_torch.ops import rd_device as TRD
from libvpx_opencl_tpu_torch.ops import transforms as TTF

torch.set_num_threads(1)
QS = [0, 4, 10, 19, 24, 40, 80, 127]
# plane: (dequant factor index, token-cost type, i0, plane_rd_mult, first0)
PLANES = {"Y": (0, 0, 1, 4.0, True), "Y2": (1, 1, 0, 16.0, False),
          "UV": (2, 2, 0, 2.0, False)}
NB = 96                       # MBs of residual per case


@functools.lru_cache(maxsize=None)
def _jax_trellis():
    return jax.jit(JRD.trellis_batch, static_argnums=(4, 5))


@functools.lru_cache(maxsize=None)
def _token_costs():
    return _default_token_costs()


def _case(qindex, plane):
    """(coefs, levels, dq, ctx) int32 numpy for one plane setup."""
    k, _, _, _, first0 = PLANES[plane]
    rng = np.random.default_rng(1000 * qindex + k)
    amp = np.where(rng.random((NB, 1, 1, 1)) < 0.5, 255, 24)
    res = (rng.integers(-255, 256, (NB, 16, 4, 4)) * amp // 255)
    coefs = TTF.fdct4x4_batch(torch.from_numpy(res.reshape(-1, 4, 4))
                              .to(torch.int32)).reshape(NB, 16, 16)
    if plane == "Y2":
        coefs = TTF.walsh4x4_batch(coefs[:, :, 0])            # [NB, 16]
    coefs = coefs.reshape(-1, 16)
    m = coefs.shape[0]
    # random: sparse coefficients of every magnitude
    rnd = rng.integers(-2000, 2001, (m // 2, 16)) * \
        (rng.random((m // 2, 16)) < 0.3) // rng.integers(1, 40, (m // 2, 1))
    coefs = torch.cat([coefs, torch.from_numpy(rnd).to(torch.int32)])
    m = coefs.shape[0]
    dq = torch.tensor(dequant_factors(qindex, 0, 0, 0, 0, 0)[k],
                      dtype=torch.int32).expand(m, 2).contiguous()
    levels, _ = TTF.regular_quant_batch(
        coefs, dq, torch.full((m,), qindex, dtype=torch.int32), first0)
    ctx = rng.integers(0, 3, m).astype(np.int32)
    return coefs.numpy(), levels.numpy(), dq.numpy(), ctx


def _both(qindex, plane):
    coefs, levels, dq, ctx = _case(qindex, plane)
    _, btype, i0, prm, _ = PLANES[plane]
    rdm, rdd, _ = rdopt.rd_consts(qindex)
    tc = _token_costs()
    want = _jax_trellis()(
        jnp.asarray(coefs), jnp.asarray(levels), jnp.asarray(dq),
        JRD.banded_token_costs(tc, btype), i0, prm, jnp.asarray(ctx),
        jnp.float32(rdm), jnp.float32(rdd))
    got = TRD.trellis_batch(
        *(torch.from_numpy(a) for a in (coefs, levels, dq)),
        TRD.banded_token_costs(tc, btype), i0, prm, torch.from_numpy(ctx),
        torch.tensor(float(rdm)), torch.tensor(float(rdd)))
    return levels, got, [np.asarray(w) for w in want]


@pytest.mark.parametrize("plane", list(PLANES))
@pytest.mark.parametrize("qindex", QS)
def test_trellis_matches_jax(qindex, plane):
    _, (gl, ge), (wl, we) = _both(qindex, plane)
    assert gl.dtype == ge.dtype == torch.int32
    np.testing.assert_array_equal(gl.numpy(), wl, err_msg="levels")
    np.testing.assert_array_equal(ge.numpy(), we, err_msg="eobs")


@pytest.mark.parametrize("plane", list(PLANES))
def test_trellis_changes_levels(plane):
    """At qindex 24 the trellis lowers levels on every plane (towards
    zero, never away from it) and still equals the JAX function."""
    levels, (gl, ge), (wl, we) = _both(24, plane)
    gl = gl.numpy()
    changed = (gl != levels).any(-1)
    assert changed.sum() >= 10, changed.sum()
    assert (np.abs(gl) <= np.abs(levels)).all()
    assert ((gl == 0) | (np.sign(gl) == np.sign(levels))).all()
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(ge.numpy(), we)
