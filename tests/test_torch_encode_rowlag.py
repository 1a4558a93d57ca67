"""The schedule and the arithmetic of K5, the encode wavefront kernel, held
with the plain version (the CUDA kernel cannot run here).

csrc/encode_wavefront.cu gives MB rows to thread blocks in start order; a
block walks its row's intra MBs left to right. A 16x16 MB (r,c) starts
once row r-1 has finished min(c+1, C) MBs, a B_PRED MB once it has
finished min(c+2, C) (the above-right MB too: a B_PRED MB reads its bottom
row); inter MBs are done before the launch. Here random orders that keep
that rule (and, as a stricter one, a lag of 2 for every MB) apply the
plain per-MB step (models/wavefront.py:_encode_mb_step) one intra MB at a
time, after the frame's inter batch, and must give exactly the six outputs
of the plain level-batch version (the specification, which
tests/test_torch_encode_wavefront.py and tests/test_torch_bpred.py hold
against the JAX function). The control: a lag-1 order for every MB gives a
different frame once a B_PRED MB's above-right neighbour is intra.

K5 runs a run of consecutive B_PRED MBs of a row as one sub-block
wavefront: sub-block (ir, j), j = 4c + ic, at step j + 2 ir. A helper here
does the same, one sub-block at a time with its edges read from the plane
at that moment (_bpred_lanes' arithmetic), and must equal the plain
version; an order that runs sub-block (ir, 0) of an MB before (ir, 3) of
the MB on its left does not. The diagonal order of one MB's sixteen
sub-blocks (BPRED_DIAG_ORDER, the order a lone B_PRED MB takes) gives the
raster order's result, and one that runs sub-block (1,1) before its
above-right neighbour (0,2) does not. chip_smoke.k5_chain counts the
kernel's dependent steps under that schedule.

Two recipes are written here as numpy in the kernel's operation order and
held against the plain functions: the sub-mode pick's rdc (float32
product, sum and quotient each rounded, the floor, then one float64 sum
rounded to float32 once) over SSEs from 0 to 16 * 255^2 at the encoder's
rdmult/rddiv of every qindex; and the regular quantizer as K5 runs it: its
constants made once per MB from the factors and the qindex alone (zbin,
rnd, the reciprocal and its shift, the 16 boost thresholds), then one
coefficient per lane (the reciprocal product as an unsigned 32-bit
product, the zero-run carry as a chain over per-position thresholds), over
coefficients near the dead zone, large ones and ones whose product wraps,
at every qindex's Y1, Y2 and UV quantizers.

On CPU tensors the wrapper runs the plain version and launches nothing; on
a card (tests marked `cuda`, skipped without one) K5 equals the plain
version.
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from libvpx_opencl_tpu_torch.models import rdopt
from libvpx_opencl_tpu_torch.models import wavefront as twf
from libvpx_opencl_tpu_torch.models.refdec import dequant_factors
from libvpx_opencl_tpu_torch.ops import predict as P
from libvpx_opencl_tpu_torch.ops import rd_device as RD
from libvpx_opencl_tpu_torch.ops import tables as T
from libvpx_opencl_tpu_torch.ops import transforms as tf
from libvpx_opencl_tpu_torch.ops import wavefront as W

torch.set_num_threads(1)

GEOMS = [(4, 6), (3, 3), (1, 5), (5, 1), (2, 2)]
QINDEX = [4, 24, 47, 48, 127]
# (intra share, B_PRED share of the modes)
SHARES = [(1.0, 1.0), (0.7, 0.5), (1.0, 0.3), (0.5, 0.0), (0.9, 0.8)]
NAMES = ("qcoeff", "eobs", "y", "u", "v", "bmodes")
BMODE_COST = np.asarray(rdopt.BMODE_COST, np.int32)
ZZ = np.asarray(T.ZIGZAG, np.int64)
INV_ZZ = np.argsort(ZZ)
ZBIN_BOOST = np.asarray([0, 0, 8, 10, 12, 14, 16, 20, 24, 28, 32, 36, 40,
                         44, 44, 44], np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, R, C, qindex, intra_share, bpred_share, with_top):
    """Random sources (flat or textured), inter predictions near them or
    not, modes with a share of B_PRED, the quantizer and RD constants of
    `qindex`, and optionally a random `top` row set."""
    rng = np.random.default_rng(seed)
    N = R * C
    flat = rng.random(N) < 0.4
    src = []
    for n in (16, 8, 8):
        base = rng.integers(20, 236, (N, 1, 1)) + rng.integers(-3, 4,
                                                               (N, n, n))
        src.append(np.where(flat[:, None, None], base,
                            rng.integers(0, 256, (N, n, n))).astype(np.int32))
    near = rng.random(N) < 0.5
    inter = [np.where(near[:, None, None],
                      np.clip(s + rng.integers(-6, 7, s.shape), 0, 255),
                      rng.integers(0, 256, s.shape)).astype(np.int32)
             for s in src]
    mode = np.where(rng.random(N) < bpred_share, W.B_PRED_M,
                    rng.integers(0, 4, N)).astype(np.int32)
    uv_mode = rng.integers(0, 4, N).astype(np.int32)
    intra = rng.random(N) < intra_share
    dqs = [np.tile(np.asarray(d, np.int32), (N, 1))
           for d in dequant_factors(qindex, 0, 0, 0, 0, 0)]
    args = [_t(a) for a in src + inter + [mode, uv_mode, intra] + dqs +
            [np.full(N, qindex, np.int32)]]
    rdm, rdd, _ = rdopt.rd_consts(qindex)
    kw = {"bmode_cost": _t(BMODE_COST),
          "rdmult": torch.tensor(float(rdm), dtype=torch.float32),
          "rddiv": torch.tensor(float(rdd), dtype=torch.float32)}
    if with_top:
        kw["top"] = [_t(rng.integers(0, 256, shape[1]).astype(np.uint8))
                     for shape in W.plane_shapes(R, C)]
    return args, kw


def _order(rng, R, C, lag, greedy=False):
    """An order of all MBs in which row r takes column c only once row r-1
    has finished min(c + lag(r, c), C) MBs (`lag` a number or a function
    of (r, c); None: no wait), in order within a row: random, or always
    the last row that may go (greedy, the most eager order)."""
    lag_of = lag if callable(lag) else (lambda r, c: lag)
    done = [0] * R
    order = []

    def may_go(r):
        if done[r] >= C:
            return False
        k = lag_of(r, done[r])
        return r == 0 or k is None or done[r - 1] >= min(done[r] + k, C)

    while len(order) < R * C:
        ok = [r for r in range(R) if may_go(r)]
        r = ok[-1] if greedy else ok[rng.integers(len(ok))]
        order.append((r, done[r]))
        done[r] += 1
    return order


def _run_order(R, C, args, kw, order):
    """The frame's inter batch, then the plain per-MB step on each intra MB
    in `order`, one at a time."""
    srcs, inters = args[0:3], args[3:6]
    mode, uv_mode, intra = args[6:9]
    dqs = args[9:13]
    top = kw.get("top")
    planes, out, intra_np, bpred_np = twf._frame_setup(
        R, C, srcs, inters, mode, intra, dqs, None, kw["bmode_cost"], top)
    for r, c in order:
        n = r * C + c
        if intra_np[n]:
            twf._encode_mb_step(C, planes, out, srcs, dqs, mode, uv_mode,
                                torch.tensor([n]), int(bpred_np[n]),
                                kw["bmode_cost"], kw["rdmult"], kw["rddiv"],
                                top is not None)
    return out[:2] + planes + out[2:]


def _assert_same(got, want):
    assert len(got) == len(want) == 6
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


@functools.lru_cache(maxsize=None)
def _level_case(R, C, qindex):
    """The inputs of geometry (R, C) at `qindex` and the plain version's
    outputs on them (the row-order tests share them)."""
    i, j = GEOMS.index((R, C)), QINDEX.index(qindex)
    intra_share, bpred_share = SHARES[(i + j) % len(SHARES)]
    seed = 1000 * R + 10 * C + qindex
    args, kw = _case(seed, R, C, qindex, intra_share, bpred_share,
                     with_top=(i + j) % 2 == 0)
    return seed, args, kw, twf._encode_planes_plain(R, C, *args, **kw)


@pytest.mark.parametrize("qindex", QINDEX)
@pytest.mark.parametrize("R,C", GEOMS)
def test_lag2_orders_match_levels(R, C, qindex):
    seed, args, kw, want = _level_case(R, C, qindex)
    got = _run_order(R, C, args, kw,
                     _order(np.random.default_rng(seed), R, C, lag=2))
    _assert_same(got, want)
    assert int((want[0] != 0).sum()) > 0


def _kernel_lag(args, C):
    """K5's lag per MB: 2 for a B_PRED MB, 1 for another intra MB, no
    wait for an inter MB (done before the launch)."""
    mode, intra = args[6].numpy(), args[8].numpy().astype(bool)

    def lag(r, c):
        n = r * C + c
        return None if not intra[n] else (2 if mode[n] == W.B_PRED_M else 1)
    return lag


@pytest.mark.parametrize("qindex", QINDEX)
@pytest.mark.parametrize("R,C", GEOMS)
def test_per_mb_lag_orders_match_levels(R, C, qindex):
    """Random and most eager orders under K5's per-MB lag, on the lag-2
    test's inputs."""
    seed, args, kw, want = _level_case(R, C, qindex)
    lag = _kernel_lag(args, C)
    for order in (_order(np.random.default_rng(seed + 1), R, C, lag),
                  _order(None, R, C, lag, greedy=True)):
        _assert_same(_run_order(R, C, args, kw, order), want)


def test_lag1_order_differs():
    """Every MB intra and B_PRED: a lag-1 order runs (r,c) before (r-1,c+1)
    has its pixels, and the above-right sub-blocks see zeros."""
    R, C = 4, 6
    args, kw = _case(7, R, C, 24, 1.0, 1.0, with_top=False)
    want = twf._encode_planes_plain(R, C, *args, **kw)
    got = _run_order(R, C, args, kw, _order(None, R, C, lag=1, greedy=True))
    assert any(not torch.equal(g, w) for g, w in zip(got, want))


def _subblock(plane, C, r, c, ir, ic, src, dq, qidx, kw, top_interior):
    """Encode sub-block (ir, ic) of B_PRED MB (r, c) in place, its edge read
    from the plane now (the MB's above row, above-right and frame-edge
    values as _bpred_lanes' workspace has them), with _bpred_lanes'
    arithmetic. Returns (levels [16], eob, sub-mode)."""
    b = W.BORDER
    rr, cc = torch.tensor([r]), torch.tensor([c])
    y0, x0, above, left, tl = W._edges(plane, b, 16, rr, cc, top_interior)
    ar = W.above_right(plane, C, rr, cc, y0, x0, above, top_interior)
    row0 = torch.cat([tl[:, None], above, ar], 1)[0]      # pixels -1..19
    py, px = b + 16 * r + 4 * ir, b + 16 * c + 4 * ic

    def pix(y, x):
        return plane[y, x].to(torch.int32)
    if ir == 0:
        above8 = row0[1 + 4 * ic:9 + 4 * ic]
    else:
        above8 = pix(py - 1, slice(px, px + 8)).clone()
        if ic == 3:
            above8[4:] = ar[0]
    left4 = left[0, 4 * ir:4 * ir + 4] if ic == 0 and c == 0 else \
        pix(slice(py, py + 4), px - 1)
    corner = row0[4 * ic] if ir == 0 else (
        left[0, 4 * ir - 1] if ic == 0 and c == 0 else pix(py - 1, px - 1))
    preds = P.bpred_4x4_all(above8[None], left4[None], corner.reshape(1))
    resid = src[None, None, 4 * ir:4 * ir + 4, 4 * ic:4 * ic + 4] - preds
    sse = (resid * resid).sum((-1, -2))
    best = torch.argmin(RD.rdc(kw["bmode_cost"][:, None], sse, kw["rdmult"],
                               kw["rddiv"]), 0)
    q, e = tf.regular_quant_batch(
        tf.fdct4x4_batch(resid[best, 0]).reshape(1, 16), dq[None],
        qidx.reshape(1), False)
    dqv = RD._dq_vec(dq[None]).to(torch.int32)
    rec = preds[best, 0] + tf.idct4x4_batch(tf._s16(q * dqv).reshape(1, 4, 4))
    plane[py:py + 4, px:px + 4] = rec[0].clamp(0, 255).to(torch.uint8)
    return q[0], e[0], best[0]


def _run_pipelined(R, C, args, kw, left_first=False):
    """The frame's inter batch, then each row left to right: a 16x16 MB
    through _encode_mb_step, a run of B_PRED MBs as K5 runs it (sub-block
    (ir, j) at step j + 2 ir); with left_first, sub-block (ir, 0) of each
    MB after the run's first goes two steps early, before (ir, 3) of the
    MB on its left. A B_PRED MB's chroma comes from _encode_mb_step as a
    16x16 MB at the start of the run, whose luma the sub-blocks then
    overwrite before anything reads it."""
    srcs, inters = args[0:3], args[3:6]
    mode, uv_mode, intra = args[6:9]
    dqs = args[9:13]
    top = kw.get("top")
    planes, out, intra_np, bpred_np = twf._frame_setup(
        R, C, srcs, inters, mode, intra, dqs, None, kw["bmode_cost"], top)
    for r in range(R):
        c = 0
        while c < C:
            n = r * C + c
            if not intra_np[n]:
                c += 1
                continue
            e = c + 1
            if bpred_np[n]:
                while e < C and bpred_np[r * C + e]:
                    e += 1
            for m in range(c, e):
                twf._encode_mb_step(C, planes, out, srcs, dqs, mode, uv_mode,
                                    torch.tensor([r * C + m]), 0,
                                    top_interior=top is not None)
            if not bpred_np[n]:
                c = e
                continue
            subs = []
            for j in range(4 * (e - c)):
                for ir in range(4):
                    early = left_first and j % 4 == 0 and j > 0
                    subs.append((j + 2 * ir - 2 * early, ir, j))
            for _, ir, j in sorted(subs):
                m, ic = c + j // 4, j % 4
                nm = r * C + m
                q, eob, best = _subblock(
                    planes[0], C, r, m, ir, ic, srcs[0][nm], dqs[0][nm],
                    dqs[3][nm], kw, top is not None)
                k = 4 * ir + ic
                out[0][nm, k], out[1][nm, k], out[2][nm, k] = q, eob, best
            nb = slice(r * C + c, r * C + e)
            out[0][nb, 24] = 0
            out[1][nb, 24] = 0
            c = e
    return out[:2] + planes + out[2:]


# (R, C, qindex, intra share, B_PRED share, top row)
PIPELINE_CASES = [(2, 6, 24, 1.0, 1.0, False), (3, 5, 4, 0.9, 0.7, True),
                  (2, 7, 127, 0.8, 0.8, True), (1, 4, 48, 1.0, 0.6, False)]


@pytest.mark.parametrize("R,C,qindex,ish,bsh,with_top", PIPELINE_CASES)
def test_bpred_runs_in_subblock_steps_match_plain(R, C, qindex, ish, bsh,
                                                  with_top):
    args, kw = _case(3000 + 100 * R + C + qindex, R, C, qindex, ish, bsh,
                     with_top)
    want = twf._encode_planes_plain(R, C, *args, **kw)
    _assert_same(_run_pipelined(R, C, args, kw), want)


def test_subblock_before_its_left_neighbour_differs():
    """Every MB intra and B_PRED: sub-block (ir, 0) of MB c+1 before
    (ir, 3) of MB c reads a left edge that is not final yet."""
    args, kw = _case(8, 2, 5, 24, 1.0, 1.0, with_top=False)
    want = twf._encode_planes_plain(2, 5, *args, **kw)
    got = _run_pipelined(2, 5, args, kw, left_first=True)
    assert any(not torch.equal(g, w) for g, w in zip(got, want))


def test_k5_chain_counts_the_schedule():
    """chip_smoke.k5_chain on small grids: 16x16 MBs one step each after
    min(c+1, C) MBs of the row above, a run of k B_PRED MBs 4k + 6 steps
    whose MB m enters at step 4m after min(c+2, C) MBs above."""
    def chain(R, C, intra, bpred=None):
        return chip_smoke.k5_chain(np, R, C, np.asarray(intra, bool),
                                   None if bpred is None
                                   else np.asarray(bpred, bool))
    ones = np.ones
    assert chain(68, 120, ones(68 * 120)) == 187
    assert chain(5, 7, ones(35)) == 4 + 7
    assert chain(3, 4, np.zeros(12)) == 0
    assert chain(1, 5, ones(5), ones(5)) == 4 * 5 + 6
    assert chain(3, 1, ones(3), ones(3)) == 3 * 10
    # row r starts once row r-1's MB 1 is done, 14 steps into its run
    assert chain(2, 2, ones(4), ones(4)) == 14 + 4 * 2 + 6
    assert chain(3, 6, ones(18), ones(18)) == 2 * 14 + 4 * 6 + 6
    # a 16x16 MB between two runs: 10 + 1 + 10
    assert chain(1, 3, ones(3), [1, 0, 1]) == 21
    # 16x16 MBs below a run wait for min(c+1, C) MBs of it
    assert chain(2, 2, ones(4), [1, 1, 0, 0]) == 15
    # an inter MB breaks a run and waits for nothing
    assert chain(1, 3, [1, 0, 1], [1, 0, 1]) == 20


def _bpred_inputs(seed, M=8, C=3):
    """A random bordered luma plane and M B_PRED MBs on a 3 x C grid."""
    rng = np.random.default_rng(seed)
    plane = _t(rng.integers(0, 256, W.plane_shapes(3, C)[0])
               .astype(np.uint8))
    n = rng.integers(0, 3 * C, M)
    src = _t(np.clip(rng.integers(60, 200, (M, 1, 1))
                     + rng.integers(-50, 51, (M, 16, 16)), 0, 255)
             .astype(np.int32))
    dq = _t(np.tile(np.asarray(dequant_factors(24, 0, 0, 0, 0, 0)[0],
                               np.int32), (M, 1)))
    rdm, rdd, _ = rdopt.rd_consts(24)
    return (plane, C, _t(n // C), _t(n % C), src, dq,
            _t(np.full(M, 24, np.int32)), _t(BMODE_COST),
            torch.tensor(float(rdm)), torch.tensor(float(rdd)))


def test_bpred_diagonal_order_matches_raster():
    order = twf.BPRED_DIAG_ORDER
    assert sorted(order) == list(range(16))
    pos = {k: i for i, k in enumerate(order)}
    for k in range(16):
        ir, ic = k >> 2, k & 3
        deps = [k - 1] if ic else []
        if ir:
            deps += [k - 4] + ([k - 3] if ic < 3 else [])
        assert all(pos[d] < pos[k] for d in deps), k
    inputs = _bpred_inputs(3)
    want = twf._bpred_lanes(*inputs)
    got = twf._bpred_lanes(*inputs, order=order)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bpred_order_without_the_above_right_differs():
    """Sub-block (1,1) before its above-right neighbour (0,2)."""
    order = (0, 1, 4, 5, 2, 3) + tuple(range(6, 16))
    inputs = _bpred_inputs(4)
    want = twf._bpred_lanes(*inputs)
    got = twf._bpred_lanes(*inputs, order=order)
    assert any(not torch.equal(g, w) for g, w in zip(got, want))


def test_k5_rdc_recipe():
    """float32 floor term, then one float64 sum rounded once: == RD.rdc."""
    rng = np.random.default_rng(11)
    top = 16 * 255 * 255
    sse = np.concatenate([[0, 1, top - 1, top],
                          rng.integers(0, top + 1, 4000)]).astype(np.int32)
    cost = BMODE_COST.astype(np.float32)
    for q in range(128):
        rdm, rdd, _ = rdopt.rd_consts(q)
        rdm32, rdd32 = np.float32(rdm), np.float32(rdd)
        fl = np.floor((np.float32(128.0) + cost * rdm32) / np.float32(256.0))
        assert fl.dtype == np.float32
        got = (fl.astype(np.float64)[:, None]
               + np.float64(rdd32) * sse.astype(np.float64)[None]) \
            .astype(np.float32)
        want = RD.rdc(_t(BMODE_COST)[:, None], _t(sse),
                      torch.tensor(rdm32), torch.tensor(rdd32))
        np.testing.assert_array_equal(got, want.numpy(), err_msg=f"q{q}")


def _k5_qconst(dq_dc, dq_ac, qidx):
    """K5's quantizer constants of one block type, made once per MB from
    its factors and qindex alone: [M, 24] int32 rows of zbin, rnd, quant,
    shift (each for the DC, then the AC factor) and the 16 boost
    thresholds (QConst in csrc/encode_wavefront.cu)."""
    dq = np.stack([dq_dc, dq_ac], 1).astype(np.int32)            # [M, 2]
    zf = np.where(qidx < 48, 84, 80).astype(np.int32)[:, None]
    zbin = (zf * dq + 64) >> 7
    rnd = (48 * dq) >> 7
    shift = sum((dq >= (1 << k)).astype(np.int32) for k in range(1, 10))
    quant = (1 + (np.int32(1 << 16) << shift) // dq - (1 << 16)) \
        .astype(np.int32)
    boost = (dq_ac[:, None] * ZBIN_BOOST[None, :]) >> 7
    return np.concatenate([zbin, rnd, quant, shift, boost], 1) \
        .astype(np.int32)


def _k5_quantize(coef, qc, first0):
    """K5's quantize(): coef [M,16] int32 raster (a lane per position); qc
    [M, 24] the block type's constants (_k5_qconst); first0 [M] bool."""
    d = (np.arange(16) > 0).astype(np.int64)            # DC lane 0, AC else
    zbin, rnd = qc[:, 0 + d], qc[:, 2 + d]
    quant, shift = qc[:, 4 + d], qc[:, 6 + d]
    x = np.abs(coef)
    xq = x + rnd
    prod = (xq.astype(np.uint32) * quant.astype(np.uint32)).astype(np.int32)
    cand = np.minimum(((prod >> 16) + xq) >> shift, 2047)
    slack = x - zbin
    boost = qc[:, 8:]                                             # [M, z]
    cnt = (slack[:, :, None] >= boost[:, None, :]).sum(-1)        # [M, pos]
    skip = first0[:, None] & (INV_ZZ == 0)[None, :]
    thr = np.where((cand > 0) & ~skip, cnt, 0)
    zrun = np.zeros(len(coef), np.int32)
    eob = np.zeros(len(coef), np.int32)
    mine = np.zeros_like(coef)
    for i in range(16):
        z = np.minimum(zrun, 15)
        mine[:, ZZ[i]] = z
        nz = z < thr[:, ZZ[i]]
        eob = np.where(nz, i + 1, eob)
        zrun = np.where(nz, 0, zrun + 1)
    y = np.where((mine < cnt) & ~skip, cand, 0)
    return np.where(coef < 0, -y, y).astype(np.int32), eob


def test_k5_quantizer_recipe():
    """K5's lane-parallel quantizer over its per-MB constants ==
    regular_quant_batch at every qindex, on Y1 (with and without Y2), Y2
    and UV quantizers."""
    rng = np.random.default_rng(12)
    per = 48
    dcs, acs, qs, f0 = [], [], [], []
    for q in range(128):
        y1, y2, uv = dequant_factors(q, 0, 0, 0, 0, 0)
        for (dc, ac), first0 in ((y1, True), (y1, False), (y2, False),
                                 (uv, False)):
            dcs += [dc] * per
            acs += [ac] * per
            qs += [q] * per
            f0 += [first0] * per
    dq_dc, dq_ac, qidx = (np.asarray(a, np.int32) for a in (dcs, acs, qs))
    first0 = np.asarray(f0)
    M = len(qs)
    # magnitudes near the dead zone and its boosts, larger ones, and a few
    # whose reciprocal product wraps in int32
    scale = np.where(np.arange(16) == 0, dq_dc[:, None], dq_ac[:, None])
    mag = (rng.random((M, 16)) * 2.5 * scale).astype(np.int32)
    big = rng.random((M, 16)) < 0.1
    mag = np.where(big, rng.integers(0, 20000, (M, 16)), mag)
    huge = rng.random((M, 16)) < 0.01
    mag = np.where(huge, rng.integers(100000, 1 << 20, (M, 16)), mag)
    mag = np.where(rng.random((M, 16)) < 0.3, 0, mag)
    coef = np.where(rng.random((M, 16)) < 0.5, -mag, mag).astype(np.int32)
    qc = _k5_qconst(dq_dc, dq_ac, qidx)
    # the constants depend on the factors and the qindex only: one row per
    # (qindex, block type) serves every block of an MB
    key = np.stack([dq_dc, dq_ac, qidx], 1)
    _, first, inverse = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    np.testing.assert_array_equal(qc, qc[first][inverse.reshape(-1)])
    got_q, got_e = _k5_quantize(coef, qc, first0)
    want_q, want_e = tf.regular_quant_batch(
        _t(coef), _t(np.stack([dq_dc, dq_ac], 1)), _t(qidx), _t(first0))
    np.testing.assert_array_equal(got_q, want_q.numpy())
    np.testing.assert_array_equal(got_e, want_e.numpy())
    assert (got_e > 0).mean() > 0.5 and (got_q != 0).any(1).mean() > 0.5


def test_cpu_wrapper_runs_plain_and_launches_nothing():
    """On CPU tensors encode_recon_planes is the plain version and the K5
    launch count stays put."""
    args, kw = _case(21, 3, 4, 24, 0.8, 0.5, with_top=True)
    before = dict(W.launches)
    got = twf.encode_recon_planes(3, 4, *args, **kw)
    assert W.launches == before
    _assert_same(got, twf._encode_planes_plain(3, 4, *args, **kw))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run by chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,qindex,shares,with_top", [
    (4, 6, 24, (0.7, 0.5), True), (5, 1, 127, (1.0, 1.0), False),
    (1, 1, 4, (1.0, 0.0), True)])
def test_k5_matches_plain_on_card(cuda_device, R, C, qindex, shares,
                                  with_top):
    """K5 on the card equals the plain version on the same tensors, one
    launch per call (chip_smoke.py covers more geometries and 1080p)."""
    args, kw = _case(5, R, C, qindex, *shares, with_top)
    args = [a.to(cuda_device) for a in args]
    kw = {k: ([x.to(cuda_device) for x in v] if k == "top"
              else v.to(cuda_device)) for k, v in kw.items()}
    before = W.launches["encode_wavefront"]
    got = twf.encode_recon_planes(R, C, *args, **kw)
    assert W.launches["encode_wavefront"] == before + 1
    _assert_same(got, twf._encode_planes_plain(R, C, *args, **kw))
