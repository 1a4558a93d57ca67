"""Port B_PRED vs the JAX package, exact equality (tolerance 0).

  * the decision's B_PRED candidate, `_bpred_rd` of both packages (the JAX
    one under jax.jit), on random bordered source planes at (R,C) = (3,4)
    and (1,5), at qindex 4, 24 and 127: rate and distortion equal;
  * the encode wavefront's B_PRED lanes: models/wavefront.py:
    encode_recon_blocks of both packages with the lanes on (JAX: tcb3,
    bmode_cost, rdmult, rddiv) and trellis-style external levels for the
    inter MBs, on random sources, predictions and modes, about a third of
    them B_PRED, in row 0 and in the last column too, at (4,5) and (1,6),
    at the RD constants of qindex 4 and 24: qcoeff, eobs, reconstruction
    and sub-modes equal;
  * the schedule: a B_PRED MB also reads its above-right neighbour, so
    `intra_levels` puts it after that MB when it is intra. Any level
    assignment that keeps every dependency gives the same frame; one that
    drops the above-right dependency does not.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.models import tpu_encoder as JE
from libvpx_opencl_tpu.models import wavefront as jwf
from libvpx_opencl_tpu.models.encoder import _default_token_costs
from libvpx_opencl_tpu.ops import rd_device as JRD
from libvpx_opencl_tpu_torch.models import rdopt
from libvpx_opencl_tpu_torch.models import torch_encoder as TE
from libvpx_opencl_tpu_torch.models import wavefront as twf
from libvpx_opencl_tpu_torch.models.refdec import dequant_factors
from libvpx_opencl_tpu_torch.ops import rd_device as TRD

torch.set_num_threads(1)
BMODE_COST = np.asarray(rdopt.BMODE_COST, np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _tc():
    return _default_token_costs()


def _source_plane(rng, R, C):
    """A bordered source luma plane: random texture over a smooth ramp,
    the border edge-extended as the encoder pads it."""
    yy, xx = np.mgrid[0:R * 16, 0:C * 16]
    vis = np.clip((xx * 3 + yy * 2) % 256 +
                  rng.integers(-40, 41, (R * 16, C * 16)) *
                  (rng.random((R * 16, C * 16)) < 0.5), 0, 255)
    return np.pad(vis.astype(np.uint8), 32, mode="edge")


@pytest.mark.parametrize("qindex", [4, 24, 127])
@pytest.mark.parametrize("R,C", [(3, 4), (1, 5)])
def test_bpred_rd_matches_jax(R, C, qindex):
    rng = np.random.default_rng(100 * R + C + qindex)
    N = R * C
    pl = _source_plane(rng, R, C)
    yb = pl[32:32 + 16 * R, 32:32 + 16 * C].reshape(R, 16, C, 16) \
        .transpose(0, 2, 1, 3).reshape(N, 16, 16).astype(np.int32)
    dq1 = np.tile(np.asarray(dequant_factors(qindex, 0, 0, 0, 0, 0)[0],
                             np.int32), (N, 1))
    qidx = np.full(N, qindex, np.int32)
    rdm, rdd, _ = rdopt.rd_consts(qindex)
    want = jax.jit(JE._bpred_rd, static_argnums=(0, 1))(
        R, C, *(jnp.asarray(a) for a in (pl, yb, dq1, qidx)),
        JRD.banded_token_costs(_tc(), 3), jnp.asarray(BMODE_COST),
        jnp.float32(rdm), jnp.float32(rdd))
    got = TE._bpred_rd(R, C, *(_t(a) for a in (pl, yb, dq1, qidx)),
                       TRD.banded_token_costs(_tc(), 3), _t(BMODE_COST),
                       torch.tensor(float(rdm)), torch.tensor(float(rdd)))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] > 0).all() and (got[1] > 0).all()


@functools.lru_cache(maxsize=None)
def _jax_encode(R, C):
    sch = jwf.schedule(R, C)
    return jax.jit(lambda *a: jwf.encode_recon_blocks(R, C, sch, *a))


def _wavefront_case(R, C, seed):
    """Random sources (flat on about a third of the MBs) and predictions,
    about a third of the MBs B_PRED (always (0, C-1) and, with two rows
    or more, (1, C-1) and (R-1, 0)), a third other intra modes, the rest
    inter."""
    rng = np.random.default_rng(seed)
    N = R * C
    flat = rng.random(N) < 0.35
    src = [np.where(flat[:, None, None], 100,
                    rng.integers(0, 256, (N, n, n))).astype(np.int32)
           for n in (16, 8, 8)]
    inter = [np.clip(s + rng.integers(-12, 13, s.shape), 0, 255)
             .astype(np.int32) for s in src]
    kind = rng.integers(0, 3, N)            # 0 inter, 1 intra, 2 B_PRED
    forced = [C - 1] + ([C + C - 1, (R - 1) * C] if R > 1 else [])
    kind[forced] = 2
    intra = kind > 0
    mode = np.where(kind == 2, 4, rng.integers(0, 4, N)).astype(np.int32)
    uv_mode = rng.integers(0, 4, N).astype(np.int32)
    dq = [rng.integers(4, 158, (N, 2)).astype(np.int32) for _ in range(3)]
    qidx = rng.integers(0, 128, N).astype(np.int32)
    return src, inter, mode, uv_mode, intra, dq, qidx


@pytest.mark.parametrize("qindex", [4, 24])
@pytest.mark.parametrize("R,C", [(4, 5), (1, 6)])
def test_bpred_encode_wavefront_matches_jax(R, C, qindex):
    src, inter, mode, uv_mode, intra, dq, qidx = _wavefront_case(
        R, C, 10 * R + C)
    N = R * C
    rdm, rdd, _ = rdopt.rd_consts(qindex)
    # levels to code for the inter MBs, as the encoder's trellis gives them
    ts = [_t(a) for a in (*src, *inter)]
    idx = torch.from_numpy(np.flatnonzero(~intra))
    tdq = [_t(d) for d in dq]
    coefs, q0, e0 = twf.transform_quant(
        *(t[idx] for t in ts), *(d[idx] for d in tdq), _t(qidx)[idx])
    tcb = TE._tcb_tables("cpu")
    q_ext, e_ext = TE._trellis_mbs(
        coefs, q0, e0, *(d[idx] for d in tdq), *tcb[:3],
        torch.tensor(float(rdm)), torch.tensor(float(rdd)))
    full_q = np.zeros((N, 25, 16), np.int32)
    full_e = np.zeros((N, 25), np.int32)
    full_q[~intra], full_e[~intra] = q_ext.numpy(), e_ext.numpy()
    want = _jax_encode(R, C)(
        *(jnp.asarray(a) for a in (*src, *inter, mode, uv_mode, intra, *dq,
                                   qidx, full_q, full_e, ~intra)),
        JRD.banded_token_costs(_tc(), 3), jnp.asarray(BMODE_COST),
        jnp.float32(rdm), jnp.float32(rdd))
    got = twf.encode_recon_blocks(
        R, C, *ts, _t(mode), _t(uv_mode), _t(intra), *tdq, _t(qidx),
        (q_ext, e_ext), _t(BMODE_COST), torch.tensor(float(rdm)),
        torch.tensor(float(rdd)))
    names = ("qcoeff", "eobs", "recon_y", "recon_u", "recon_v", "bmodes")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    bp = mode == 4
    bmodes, eobs = got[5].numpy(), got[1].numpy()
    assert len(np.unique(bmodes[bp])) >= 5 and not bmodes[~bp].any()
    assert not eobs[bp, 24].any() and (eobs[bp, :16] == 0).any()
    if qindex == 24:                    # (at qindex 4 it keeps them all)
        assert (q_ext.numpy() != q0.numpy()).any()  # the trellis acted


def _levels_case():
    """A 4x5 frame whose B_PRED MB (1, 1) has intra left, above-left and
    above neighbours of level 0-1 and an intra above-right neighbour (0,
    2) of level 2: without the above-right dependency it would share that
    MB's level."""
    R, C = 4, 5
    src, inter, mode, uv_mode, intra, dq, qidx = _wavefront_case(R, C, 45)
    grid = np.array([[1, 1, 1, 0, 1],
                     [1, 2, 0, 2, 2],
                     [0, 2, 1, 2, 0],
                     [2, 1, 2, 0, 2]]).reshape(-1)
    intra = grid > 0
    mode = np.where(grid == 2, 4, mode % 4).astype(np.int32)
    args = [_t(a) for a in (*src, *inter, mode, uv_mode, intra, *dq, qidx)]
    rdm, rdd, _ = rdopt.rd_consts(24)
    return R, C, intra, mode == 4, args, (
        None, _t(BMODE_COST), torch.tensor(float(rdm)),
        torch.tensor(float(rdd)))


def test_intra_levels_wait_for_the_above_right_of_bpred():
    R, C, intra, bpred, _, _ = _levels_case()
    with_ar = twf.intra_levels(R, C, intra, bpred).reshape(R, C)
    without = twf.intra_levels(R, C, intra).reshape(R, C)
    assert with_ar[1, 1] == with_ar[0, 2] + 1 == 3
    assert without[1, 1] == without[0, 2] == 2
    for r in range(R):
        for c in range(C):
            if not intra[r * C + c]:
                assert with_ar[r, c] == -1
                continue
            deps = [(r, c - 1), (r - 1, c), (r - 1, c - 1)]
            if bpred[r * C + c] and c + 1 < C:
                deps.append((r - 1, c + 1))
            lv = [with_ar[a, b] for a, b in deps if a >= 0 and b >= 0]
            assert with_ar[r, c] == 1 + max(lv, default=-1)


def _encode_with_levels(monkeypatch, levels_fn, R, C, args, extra):
    monkeypatch.setattr(twf, "intra_levels", levels_fn)
    return twf.encode_recon_blocks(R, C, *args, *extra)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_any_order_that_keeps_the_dependencies_gives_the_same_frame(
        monkeypatch, seed):
    """Levels with random extra delays (raster order is a topological
    order of the dependencies, so each MB still comes after all of its
    intra neighbours) give the frame of the minimal levels."""
    R, C, intra, bpred, args, extra = _levels_case()
    want = twf.encode_recon_blocks(R, C, *args, *extra)
    rng = np.random.default_rng(seed)

    def delayed(R_, C_, intra_, bpred_=None):
        lvl = np.full((R_ + 1, C_ + 2), -1, np.int64)
        g = np.asarray(intra_).reshape(R_, C_)
        b = np.asarray(bpred_).reshape(R_, C_)
        for r in range(R_):
            for c in range(C_):
                if g[r, c]:
                    dep = max(lvl[r + 1, c], lvl[r, c + 1], lvl[r, c],
                              lvl[r, c + 2] if b[r, c] else -1)
                    lvl[r + 1, c + 1] = dep + 1 + rng.integers(0, 3)
        lv = lvl[1:, 1:C_ + 1].reshape(-1)
        # close the gaps: the wavefront walks levels 0..max
        used = np.unique(lv[lv >= 0])
        return np.where(lv >= 0, np.searchsorted(used, lv), -1)

    got = _encode_with_levels(monkeypatch, delayed, R, C, args, extra)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dropping_the_above_right_dependency_changes_the_frame(monkeypatch):
    R, C, intra, bpred, args, extra = _levels_case()
    want = twf.encode_recon_blocks(R, C, *args, *extra)
    levels = twf.intra_levels
    got = _encode_with_levels(
        monkeypatch, lambda R_, C_, intra_, bpred_=None: levels(R_, C_,
                                                                intra_),
        R, C, args, extra)
    # MB (1, 1) read (0, 2)'s bottom row before it was reconstructed
    assert not torch.equal(got[2][6], want[2][6])
