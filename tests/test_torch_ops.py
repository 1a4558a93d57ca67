"""Port ops vs the JAX package, exact equality (integer math, tolerance 0).

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart in libvpx_opencl_tpu_torch:
  * residuals: ops/transforms.py compute_residual_blocks;
  * MC: ops/predict.py mc_predict_blocks (16x16, 8x8) and mc_predict_tiles,
    with sixtap and bilinear taps, windows at and beyond the plane edges;
  * intra block math: pred_nxn and bpred_4x4(_all);
  * loop-filter math: filter_edge (normal, MB and inner edges) and
    simple_filter_edge.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.ops import loopfilter as jlf
from libvpx_opencl_tpu.ops import predict as JP
from libvpx_opencl_tpu.ops import transforms as jtf
from libvpx_opencl_tpu_torch.ops import loopfilter as tlf
from libvpx_opencl_tpu_torch.ops import predict as TP
from libvpx_opencl_tpu_torch.ops import transforms as ttf

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mag", [8, 2048, 32767])
def test_compute_residual_blocks_matches_jax(mag):
    rng = np.random.default_rng(mag)
    N = 37
    qcoeff = rng.integers(-mag, mag + 1, (N, 25, 16)).astype(np.int16)
    qcoeff[rng.random((N, 25)) < 0.5] = 0
    y2_big = rng.random(N) < 0.5
    has_y2 = rng.random(N) < 0.7
    dq = rng.integers(4, 160, (3, N, 2)).astype(np.int16)
    want = jax.jit(jtf.compute_residual_blocks)(
        jnp.asarray(qcoeff), jnp.asarray(y2_big), jnp.asarray(dq[0]),
        jnp.asarray(dq[1]), jnp.asarray(dq[2]), jnp.asarray(has_y2))
    got = ttf.compute_residual_blocks(_t(qcoeff), _t(y2_big), _t(dq[0]),
                                      _t(dq[1]), _t(dq[2]), _t(has_y2))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _mc_case(rng, nb, H, W):
    planes = rng.integers(0, 256, (3, H, W)).astype(np.uint8)
    ref_idx = rng.integers(0, 3, nb).astype(np.int32)
    # starts cover the interior and both edges, including windows that
    # hang off the plane (placed by dynamic_slice's start rule)
    starts = np.stack([rng.integers(-6, H + 6, nb),
                       rng.integers(-6, W + 6, nb)], 1).astype(np.int32)
    starts[:4] = [[0, 0], [H - 1, W - 1], [2, W - 3], [-30, W + 30]]
    xph = rng.integers(0, 8, nb).astype(np.int32)
    yph = rng.integers(0, 8, nb).astype(np.int32)
    return planes, ref_idx, starts, xph, yph


@pytest.mark.parametrize("taps", ["sixtap", "bilinear"])
@pytest.mark.parametrize("bw", [16, 8, 4])
def test_mc_predict_matches_jax(taps, bw):
    rng = np.random.default_rng(bw * 10 + len(taps))
    table = JP.SIXTAP_TABLE if taps == "sixtap" else JP.BILINEAR_AS_SIXTAP
    np.testing.assert_array_equal(
        table, TP.SIXTAP_TABLE if taps == "sixtap" else TP.BILINEAR_AS_SIXTAP)
    planes, ref_idx, starts, xph, yph = _mc_case(rng, 64, 40, 56)
    j = jnp.asarray
    if bw == 4:
        want = jax.jit(JP.mc_predict_tiles)(j(planes), j(ref_idx),
                                            j(starts), j(xph), j(yph),
                                            j(table))
        got = TP.mc_predict_tiles(_t(planes), _t(ref_idx), _t(starts),
                                  _t(xph), _t(yph), _t(table))
    else:
        want = jax.jit(JP.mc_predict_blocks, static_argnums=6)(
            j(planes), j(ref_idx), j(starts), j(xph), j(yph), j(table), bw)
        got = TP.mc_predict_blocks(_t(planes), _t(ref_idx), _t(starts),
                                   _t(xph), _t(yph), _t(table), bw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [16, 8])
def test_pred_nxn_matches_jax(n):
    rng = np.random.default_rng(n)
    M = 48
    mode = np.tile(np.arange(4, dtype=np.int32), M // 4)
    above = rng.integers(0, 256, (M, n)).astype(np.int32)
    left = rng.integers(0, 256, (M, n)).astype(np.int32)
    tl = rng.integers(0, 256, M).astype(np.int32)
    up = (np.arange(M) // 4) % 2 == 0
    lf = (np.arange(M) // 8) % 2 == 0
    got = TP.pred_nxn(_t(mode), _t(above), _t(left), _t(tl), _t(up), _t(lf),
                      n).numpy()
    want = jax.jit(jax.vmap(lambda *a: JP.pred_nxn(*a, n)))(
        jnp.asarray(mode), jnp.asarray(above), jnp.asarray(left),
        jnp.asarray(tl), jnp.asarray(up), jnp.asarray(lf))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_bpred_4x4_matches_jax():
    rng = np.random.default_rng(5)
    M = 60
    above8 = rng.integers(0, 256, (M, 8)).astype(np.int32)
    left4 = rng.integers(0, 256, (M, 4)).astype(np.int32)
    tl = rng.integers(0, 256, M).astype(np.int32)
    mode = np.arange(M, dtype=np.int32) % 10
    want_all = jax.jit(jax.vmap(
        lambda a, l, t: jnp.stack(JP.bpred_4x4_all(a, l, t))))(
        jnp.asarray(above8), jnp.asarray(left4), jnp.asarray(tl))
    got_all = TP.bpred_4x4_all(_t(above8), _t(left4), _t(tl))
    np.testing.assert_array_equal(got_all.permute(1, 0, 2, 3).numpy(),
                                  np.asarray(want_all))
    got = TP.bpred_4x4(_t(mode), _t(above8), _t(left4), _t(tl)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want_all)[np.arange(M),
                                                            mode])


@pytest.mark.parametrize("mb_edge", [True, False])
def test_filter_edge_matches_jax(mb_edge):
    rng = np.random.default_rng(int(mb_edge))
    shape = (64, 16)
    # smooth-ish edges so that both the mask and hev branches are taken
    base = rng.integers(0, 256, shape + (1,))
    pix8 = np.clip(base + rng.integers(-12, 13, shape + (8,)), 0, 255) \
        .astype(np.int32)
    blim = rng.integers(1, 130, (64, 1)).astype(np.int32)
    lim = rng.integers(1, 20, (64, 1)).astype(np.int32)
    hev = rng.integers(0, 4, (64, 1)).astype(np.int32)
    apply = rng.random((64, 1)) < 0.8
    want = jax.jit(jlf.filter_edge, static_argnums=4)(
        jnp.asarray(pix8), jnp.asarray(blim), jnp.asarray(lim),
        jnp.asarray(hev), mb_edge, jnp.asarray(apply))
    got = tlf.filter_edge(_t(pix8), _t(blim), _t(lim), _t(hev), mb_edge,
                          _t(apply))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), pix8)
    want_s = jax.jit(jlf.simple_filter_edge)(
        jnp.asarray(pix8), jnp.asarray(blim), jnp.asarray(apply))
    got_s = tlf.simple_filter_edge(_t(pix8), _t(blim), _t(apply))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
