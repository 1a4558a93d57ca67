"""The row-lag schedule of the K1 and K2 kernels, held with the plain
arithmetic (the CUDA kernels cannot run here).

csrc/intra_wavefront.cu and csrc/lf_wavefront.cu give MB rows to thread
blocks in start order; a block walks its row left to right, and MB (r,c)
starts once row r-1 has finished min(c+2, C) MBs. Here random orders that
keep that rule apply the plain per-MB step (ops/wavefront.py: _intra_step,
_lf_step) one MB at a time, and must give exactly the result of the plain
diagonal loop (the specification). The control: an order that keeps
only a lag of 1 gives a different result for each kernel, so the test
would see a kernel that waited too little.
"""
import numpy as np
import pytest
import torch

from libvpx_opencl_tpu_torch.ops import wavefront as W

torch.set_num_threads(1)

GEOMS = [(4, 6), (3, 3), (1, 5), (5, 1), (2, 2)]
N_ORDERS = 3


def _order(rng, R, C, lag, greedy=False):
    """An order of all MBs in which row r takes column c only once row r-1
    has finished min(c+lag, C) MBs, in order within a row: random, or
    always the last row that may go (greedy, the most eager order)."""
    done = [0] * R
    order = []
    while len(order) < R * C:
        ok = [r for r in range(R) if done[r] < C and
              (r == 0 or done[r - 1] >= min(done[r] + lag, C))]
        r = ok[-1] if greedy else ok[rng.integers(len(ok))]
        order.append((r, done[r]))
        done[r] += 1
    return order


def _intra_case(seed, R, C):
    """Bordered planes holding random inter reconstructions, residuals and
    K1 params: 80% intra, half of them B_PRED (every MB of the last column
    below row 0 is an intra B_PRED MB, for the above-right rule there)."""
    rng = np.random.default_rng(seed)
    N = R * C
    t = torch.from_numpy
    y, u, v = W.blocks_to_planes(
        R, C, t(rng.integers(0, 256, (N, 16, 16))),
        t(rng.integers(0, 256, (N, 8, 8))), t(rng.integers(0, 256, (N, 8, 8))))
    res = [t(rng.integers(-60, 60, s).astype(np.int32))
           for s in ((N, 16, 16), (N, 8, 8), (N, 8, 8))]
    mode = np.where(rng.random(N) < 0.5, W.B_PRED_M, rng.integers(0, 4, N))
    intra = rng.random(N) < 0.8
    last = (np.arange(N) % C == C - 1) & (np.arange(N) >= C)
    mode[last], intra[last] = W.B_PRED_M, True
    params = W.pack_intra_params(t(mode), t(rng.integers(0, 4, N)),
                                 t(intra), t(rng.integers(0, 10, (N, 16))))
    return [y, u, v], res, params


def _lf_case(seed, R, C):
    """Bordered planes of smooth random content (so that most edges pass
    the filter masks) and K2 params at high filter levels."""
    rng = np.random.default_rng(seed)
    N = R * C
    t = torch.from_numpy
    planes = W.blocks_to_planes(
        R, C, *(t(128 + rng.integers(-14, 15, s))
                for s in ((N, 16, 16), (N, 8, 8), (N, 8, 8))))
    flevel = rng.integers(24, 64, N)
    flevel[rng.random(N) < 0.15] = 0
    params = W.pack_lf_params(
        t(flevel), t(2 * (flevel + 2) + 1), t(2 * flevel + 1),
        t(np.maximum(flevel // 2, 1)), t(np.clip(flevel // 16 + 1, 0, 3)),
        t(rng.random(N) < 0.7))
    return list(planes), params


def _run(step, planes, order):
    out = [p.clone() for p in planes]
    for r, c in order:
        step(out, torch.tensor([r]), torch.tensor([c]))
    return out


def _intra(R, C, seed):
    planes, res, params = _intra_case(seed, R, C)
    want = [p.clone() for p in planes]
    W._intra_planes_plain(R, C, *want, *res, params)

    def step(pl, r, c):
        W._intra_step(C, *pl, *res, params, r, c)
    return planes, want, step


def _lf(R, C, simple, seed):
    planes, params = _lf_case(seed, R, C)
    want = [p.clone() for p in planes]
    W._lf_planes_plain(R, C, simple, *want, params)

    def step(pl, r, c):
        W._lf_step(C, simple, *pl, params, r, c)
    return planes, want, step


def _assert_orders_match(R, C, planes, want, step, seed):
    rng = np.random.default_rng(seed)
    for _ in range(N_ORDERS):
        got = _run(step, planes, _order(rng, R, C, lag=2))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("R,C", GEOMS)
def test_intra_lag2_orders_match_diagonal(R, C):
    _assert_orders_match(R, C, *_intra(R, C, 10 * R + C), seed=R * C)


@pytest.mark.parametrize("R,C", GEOMS)
@pytest.mark.parametrize("simple", [False, True])
def test_lf_lag2_orders_match_diagonal(R, C, simple):
    _assert_orders_match(R, C, *_lf(R, C, simple, 10 * R + C), seed=R * C)


@pytest.mark.parametrize("kernel", ["intra", "lf_normal", "lf_simple"])
def test_lag1_order_differs(kernel):
    R, C = 4, 6
    if kernel == "intra":
        planes, want, step = _intra(R, C, 1)
    else:
        planes, want, step = _lf(R, C, kernel == "lf_simple", 1)
    got = _run(step, planes, _order(None, R, C, lag=1, greedy=True))
    assert any(not torch.equal(g, w) for g, w in zip(got, want))
