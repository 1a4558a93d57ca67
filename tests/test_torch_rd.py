"""Port forward transforms, quantizers and RD costing vs the JAX package,
tolerance 0.

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart in libvpx_opencl_tpu_torch:
  * ops/transforms.py: fdct4x4_batch, walsh4x4_batch, idct4x4_batch,
    inv_walsh_batch, fast_quant_batch, regular_quant_batch (integers
    equal, up to magnitude 32767 where int32 products wrap), mbs_to_plane;
  * ops/rd_device.py: banded_token_costs, block_rate, rd_y16, rd_uv
    (integers equal; float32 distortions equal bit for bit: residuals
    within +-64 keep every error sum below 2^24, where a float32 sum of
    integers is exact in any order) and rdc (float32, equal bit for bit
    to the jitted JAX function, as the JAX encoder runs it).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.models.encoder import _default_token_costs
from libvpx_opencl_tpu.ops import rd_device as JRD
from libvpx_opencl_tpu.ops import transforms as jtf
from libvpx_opencl_tpu_torch.ops import rd_device as TRD
from libvpx_opencl_tpu_torch.ops import transforms as ttf

torch.set_num_threads(1)
MAGS = [64, 2048, 32767]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, dtype=torch.int32):
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("name", ["fdct4x4_batch", "idct4x4_batch",
                                  "inv_walsh_batch", "walsh4x4_batch"])
def test_transform_matches_jax(name, mag):
    rng = np.random.default_rng(mag)
    x = rng.integers(-mag, mag + 1, (5, 37, 4, 4)).astype(np.int32)
    if name == "walsh4x4_batch":
        x = x.reshape(5, 37, 16)
    _eq(getattr(ttf, name)(_t(x)), getattr(jtf, name)(jnp.asarray(x)))


def _quant_case(mag):
    rng = np.random.default_rng(mag + 1)
    coefs = rng.integers(-mag, mag + 1, (3, 37, 16)).astype(np.int32)
    # long zero runs and small values, so that the dead zone, its zero-run
    # boost and the eob all vary
    small = rng.random(coefs.shape) < 0.6
    coefs[small] //= max(1, mag // 16)
    dq = rng.integers(4, 158, (37, 2)).astype(np.int32)
    qidx = rng.integers(0, 128, 37).astype(np.int32)
    return coefs, dq, qidx, rng.random(37) < 0.5


@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("first0", ["per_block", True, False])
def test_quantizers_match_jax(mag, first0):
    coefs, dq, qidx, f0 = _quant_case(mag)
    f0 = f0 if first0 == "per_block" else np.full((), first0)
    j = jnp.asarray
    for got, want in (
            (ttf.regular_quant_batch(_t(coefs), _t(dq), _t(qidx), _t(f0)),
             jtf.regular_quant_batch(j(coefs), j(dq), j(qidx), j(f0))),
            (ttf.fast_quant_batch(_t(coefs), _t(dq), _t(f0)),
             jtf.fast_quant_batch(j(coefs), j(dq), j(f0)))):
        _eq(got[0], want[0])
        _eq(got[1], want[1])
        assert int(got[1].max()) > 0


def test_regular_quant_broadcasts_like_jax():
    """rd_y16's call: dq and qidx carry a block axis of 1."""
    rng = np.random.default_rng(7)
    coefs = rng.integers(-900, 901, (3, 20, 16, 16)).astype(np.int32)
    dq = rng.integers(4, 158, (3, 20, 1, 2)).astype(np.int32)
    qidx = rng.integers(0, 128, (3, 20, 1)).astype(np.int32)
    got = ttf.regular_quant_batch(_t(coefs), _t(dq), _t(qidx), True)
    want = jtf.regular_quant_batch(jnp.asarray(coefs), jnp.asarray(dq),
                                   jnp.asarray(qidx), jnp.ones((), bool))
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_mbs_to_plane_matches_jax():
    x = np.arange(4 * 6 * 64, dtype=np.int32).reshape(24, 8, 8)
    _eq(ttf.mbs_to_plane(_t(x), 4, 6, 8),
        jtf.mbs_to_plane(jnp.asarray(x), 4, 6, 8))


@pytest.fixture(scope="module")
def tcb():
    tc = _default_token_costs()
    jax_t = [JRD.banded_token_costs(tc, b) for b in range(4)]
    torch_t = [TRD.banded_token_costs(tc, b) for b in range(4)]
    return jax_t, torch_t


def test_banded_token_costs_match_jax(tcb):
    for j, t in zip(*tcb):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("btype", [0, 1, 2, 3])
def test_block_rate_matches_jax(tcb, start, btype):
    rng = np.random.default_rng(10 * btype + start)
    q = rng.integers(-2047, 2048, (3, 50, 16)).astype(np.int32)
    q[rng.random(q.shape) < 0.5] //= 300       # literal tokens and cat1-3
    q[rng.random(q.shape) < 0.5] = 0
    q[0, 0] = 0                                # an empty block
    q[0, 1] = 2047                             # a full block of cat6
    ctx = rng.integers(0, 3, (3, 50)).astype(np.int32)
    got = TRD.block_rate(_t(q), tcb[1][btype], start, _t(ctx))
    want = JRD.block_rate(jnp.asarray(q), tcb[0][btype], start,
                          jnp.asarray(ctx))
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def _rd_case(seed, K=5, N=24):
    rng = np.random.default_rng(seed)
    dq = rng.integers(4, 158, (3, N, 2)).astype(np.int32)
    qidx = rng.integers(0, 128, N).astype(np.int32)

    def ex(a):
        return np.ascontiguousarray(np.broadcast_to(a[None], (K,) + a.shape))

    return rng, ex(dq[0]), ex(dq[1]), ex(dq[2]), ex(qidx)


def test_rd_y16_matches_jax(tcb):
    rng, dq1, dq2, _dqu, qidx = _rd_case(20)
    resid = rng.integers(-64, 65, (5, 24, 16, 16)).astype(np.int32)
    resid[0] //= 16                            # near-empty MBs
    j = jnp.asarray
    got = TRD.rd_y16(_t(resid), _t(dq1), _t(dq2), _t(qidx), tcb[1][0],
                     tcb[1][1])
    want = jax.jit(JRD.rd_y16)(j(resid), j(dq1), j(dq2), j(qidx), tcb[0][0],
                               tcb[0][1])
    _eq(got[0], want[0])
    _eq(got[1], want[1], torch.float32)
    _eq(got[2], want[2])
    assert float(got[1].max()) < 2 ** 24


def test_rd_uv_matches_jax(tcb):
    rng, _dq1, _dq2, dqu, qidx = _rd_case(21)
    ru = rng.integers(-64, 65, (5, 24, 8, 8)).astype(np.int32)
    rv = rng.integers(-64, 65, (5, 24, 8, 8)).astype(np.int32)
    j = jnp.asarray
    got = TRD.rd_uv(_t(ru), _t(rv), _t(dqu), _t(qidx), tcb[1][2])
    want = jax.jit(JRD.rd_uv)(j(ru), j(rv), j(dqu), j(qidx), tcb[0][2])
    _eq(got[0], want[0])
    _eq(got[1], want[1], torch.float32)


@pytest.mark.parametrize("qindex", [0, 4, 10, 19, 24, 40, 127])
def test_rdc_matches_jax(qindex):
    """rdmult/rddiv as the encoders derive them from qindex, against the
    jitted JAX function the encoder runs. Rates and distortions are those
    of real candidates: integers, the distortion a multiple of 1/4. Below
    qindex 20 rddiv is 100 and rddiv * dist passes 2^24, where one fused
    multiply-add and two float32 operations differ."""
    from libvpx_opencl_tpu.models import rdopt
    rdm, rdd, _ = rdopt.rd_consts(qindex)
    rng = np.random.default_rng(qindex)
    rate = rng.integers(0, 40000, (9, 500)).astype(np.int32)
    dist = rng.integers(0, 4_000_000, (9, 500)).astype(np.float32) / 4.0
    got = TRD.rdc(_t(rate), _t(dist), torch.tensor(float(rdm)),
                  torch.tensor(float(rdd)))
    args = (jnp.asarray(rate), jnp.asarray(dist), jnp.float32(rdm),
            jnp.float32(rdd))
    _eq(got, jax.jit(JRD.rdc)(*args), torch.float32)
