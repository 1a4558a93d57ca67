"""K6, the trellis kernel (csrc/trellis.cu), held with its plain version
(the CUDA kernel cannot run here).

* `trellis_mbs_plain` (ops/rd_device.py) equals the JAX block it replaces:
  `trellis_batch` for Y with Y2, Y2 and UV with the entropy contexts the
  JAX encoder derives from the regular quantizer's levels
  (libvpx_opencl_tpu/models/tpu_encoder.py, `_encode_device`), under
  `jax.jit`, on random MBs at qindex 0, 24 and 127 with levels up to cat6,
  all-zero blocks and blocks of eob 16: exact.
* One K6 thread's loop, written here in numpy in the kernel's order (the
  thread-to-block map, Y first; contexts from e0; static positions with
  predicated selects; int32 rates and int64 errors; rdc with each float32
  rounding and the one float64 sum written out), equals the plain version
  on some thousands of blocks at five qindex. Change it together with the
  kernel, as tests/test_torch_sad_plan.py does for K3.
* rdcost.cuh's recipe equals `rdc` over the rates and errors a trellis
  reaches, and the rate bound K6's comment states (a step adds less than
  2^16 to a rate, so 16 steps stay far below 2^24) holds for the
  encoder's tables.
* On CPU tensors `_trellis_mbs` runs the plain version and launches
  nothing; on a card (the test marked `cuda`, skipped without one) K6
  equals the plain version in one launch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from chip_smoke import trellis_case
from libvpx_opencl_tpu.models.encoder import _default_token_costs
from libvpx_opencl_tpu.ops import rd_device as JRD
from libvpx_opencl_tpu_torch.models import torch_encoder as TE
from libvpx_opencl_tpu_torch.ops import _cuda
from libvpx_opencl_tpu_torch.ops import rd_device as RD
from libvpx_opencl_tpu_torch.ops import tables as T

torch.set_num_threads(1)
ZZ = np.asarray(T.ZIGZAG, np.int64)
EOB = 11


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _tcb():
    return TE._tcb_tables("cpu")[:3]


def _plain(case):
    return RD.trellis_mbs_plain(*(_t(a) for a in case[:6]), *_tcb(),
                                torch.tensor(float(case[6])),
                                torch.tensor(float(case[7])))


def _jax_block(coefs, q0, dq_y1, dq_y2, dq_uv, tcb0, tcb1, tcb2, rdmult,
               rddiv):
    """The trellis section of the JAX encoder's _encode_device, from its
    regular-quantizer levels on: contexts from their eobs, the three
    trellis_batch calls, Y eobs at least 1, the [16 Y, 4 U, 4 V, Y2]
    order."""
    N = coefs.shape[0]
    qy0, qy20, quv0 = q0[:, :16], q0[:, 24], q0[:, 16:24]
    scan16 = jnp.arange(16)
    ZZi = jnp.asarray(ZZ)
    eob_y = jnp.max(jnp.where(qy0[..., ZZi] != 0, scan16 + 1, 0), -1)
    nzy = (jnp.maximum(eob_y, 1) > 1).astype(jnp.int32).reshape(N, 4, 4)
    ctx_y = (jnp.concatenate([jnp.zeros_like(nzy[:, :1]), nzy[:, :-1]], 1) +
             jnp.concatenate([jnp.zeros_like(nzy[:, :, :1]), nzy[:, :, :-1]],
                             2)).reshape(N, 16)
    qy_t, ey_t = JRD.trellis_batch(coefs[:, :16], qy0, dq_y1[:, None, :],
                                   tcb0, 1, 4.0, ctx_y, rdmult, rddiv)
    ey_t = jnp.maximum(ey_t, 1)
    qy2_t, ey2_t = JRD.trellis_batch(coefs[:, 24], qy20, dq_y2, tcb1, 0,
                                     16.0, jnp.zeros(N, jnp.int32), rdmult,
                                     rddiv)
    eob_uv = jnp.max(jnp.where(quv0[..., ZZi] != 0, scan16 + 1, 0), -1)
    nzuv = (eob_uv > 0).astype(jnp.int32).reshape(N, 2, 2, 2)
    ctx_uv = (jnp.concatenate([jnp.zeros_like(nzuv[:, :, :1]),
                               nzuv[:, :, :-1]], 2) +
              jnp.concatenate([jnp.zeros_like(nzuv[:, :, :, :1]),
                               nzuv[:, :, :, :-1]], 3)).reshape(N, 8)
    quv_t, euv_t = JRD.trellis_batch(coefs[:, 16:24], quv0,
                                     dq_uv[:, None, :], tcb2, 0, 2.0, ctx_uv,
                                     rdmult, rddiv)
    return (jnp.concatenate([qy_t, quv_t, qy2_t[:, None]], 1),
            jnp.concatenate([ey_t, euv_t, ey2_t[:, None]], 1))


@pytest.mark.parametrize("qindex", [0, 24, 127])
def test_plain_matches_jax_block(qindex):
    case = trellis_case(np, np.random.default_rng(100 + qindex), 48, qindex)
    coefs, q0, e0, d1, d2, duv, rdm, rdd = case
    # cat6 levels, all-zero blocks and blocks of eob 16 are all there
    assert (np.abs(q0) > 1500).any()
    assert (e0[:, 16:] == 0).any() and (e0 == 16).any()
    tc = _default_token_costs()
    want = jax.jit(_jax_block)(
        *(jnp.asarray(a) for a in (coefs, q0, d1, d2, duv)),
        *(JRD.banded_token_costs(tc, t) for t in range(3)),
        jnp.float32(rdm), jnp.float32(rdd))
    got = _plain(case)
    assert got[0].dtype == got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the trellis did something: it lowered levels in some blocks
    assert ((got[0].numpy() != q0).any(-1)).sum() >= 10


# ---------------------------------------------------------------------------
# one K6 thread's loop, in numpy

def _to_scan(a):
    return a[..., ZZ]


K6_WARPS = 4            # warps per thread block (kWarps in trellis.cu)


def _k6_tiles(ni):
    """(Y tiles, all tiles): 32 blocks a warp tile, the Y blocks' tiles
    first (i0 = 1), then UV and Y2 (i0 = 0)."""
    y_tiles = (ni * 16 + 31) // 32
    return y_tiles, y_tiles + (ni * 9 + 31) // 32


def _k6_tile_blocks(ni, t):
    """The (MB, block) of lanes 0-31 of warp tile t, and which lanes hold
    one (the tail of the last tile of a set holds fewer)."""
    y_tiles, _ = _k6_tiles(ni)
    luma = t < y_tiles
    g = (t if luma else t - y_tiles) * 32 + np.arange(32)
    if luma:
        m, b = g >> 4, g & 15
    else:
        m, b = g // 9, 16 + g % 9
    return m, b, g < ni * (16 if luma else 9)


def _k6_grid(ni, resident):
    """The launch's grid: as many blocks as the tiles need, at most the
    blocks the card holds at once (the C entry point)."""
    need = (_k6_tiles(ni)[1] + K6_WARPS - 1) // K6_WARPS
    return min(need, resident)


def _k6_warp_tiles(ni, grid):
    """Tiles of each warp of a grid of `grid` blocks: warp w takes
    w, w + warps, ... (the kernel's grid-stride loop)."""
    tiles = _k6_tiles(ni)[1]
    warps = grid * K6_WARPS
    return [list(range(w, tiles, warps)) for w in range(warps)]


def _k6_threads(ni, grid=None):
    """(MB, block) of each thread's block, in the order the warps take
    their tiles, split into the Y tiles' threads and the others'."""
    grid = grid or _k6_grid(ni, 1 << 30)
    y_tiles = _k6_tiles(ni)[0]
    out = {True: ([], []), False: ([], [])}
    for tiles in _k6_warp_tiles(ni, grid):
        for t in tiles:
            m, b, live = _k6_tile_blocks(ni, t)
            out[t < y_tiles][0].append(m[live])
            out[t < y_tiles][1].append(b[live])
    return tuple((np.concatenate(out[k][0]), np.concatenate(out[k][1]))
                 for k in (True, False))


@pytest.mark.parametrize("ni", [1, 31, 32, 33, 2250])
def test_k6_tile_map_covers_every_block_once(ni):
    """The persistent grid-stride map: at several resident block counts
    (one block, a few per SM of 132 SMs, more than the tiles need), every
    (MB, block) of the ni MBs is some lane's exactly once, the Y blocks in
    Y tiles only; a tile's lanes read its 64-byte blocks in memory order,
    from at most five MBs (two for Y)."""
    for resident in (1, 132, 4 * 132, 1 << 20):
        grid = _k6_grid(ni, resident)
        assert 1 <= grid <= resident
        seen = np.zeros((ni, 25), np.int64)
        for i0, (m, b) in zip((1, 0), _k6_threads(ni, grid)):
            assert ((b < 16) == (i0 == 1)).all()
            np.add.at(seen, (m, b), 1)
        assert (seen == 1).all()
    for t in range(_k6_tiles(ni)[1]):
        m, b, live = _k6_tile_blocks(ni, t)
        off = (m * 25 + b)[live]
        assert len(np.unique(m[live])) <= 5
        assert (np.diff(off) >= 1).all()


def _k6_contexts(e0, m, b):
    """A thread's entropy context from e0 inside its MB."""
    em = e0[m]
    nb = lambda k: em[np.arange(len(m)), np.clip(k, 0, 24)]  # noqa: E731
    k = (b - 16) & 3
    y = np.where(b >= 4, nb(b - 4) > 1, 0) + \
        np.where((b & 3) != 0, nb(b - 1) > 1, 0)
    uv = np.where(k >= 2, nb(b - 2) > 0, 0) + \
        np.where((k & 1) != 0, nb(b - 1) > 0, 0)
    return np.where(b < 16, y, np.where(b < 24, uv, 0)).astype(np.int64)


def _rdfloor(rate, rm):
    """rdcost.cuh's rdfloor: float32 product and sum, then the product by
    2^-8, each rounded, then the floor."""
    x = np.float32(128.0) + rate.astype(np.float32) * rm
    return np.floor(x * np.float32(0.00390625))


def _rdcost(rate, err, rm, rddiv):
    """rdcost.cuh: rdfloor, then one float64 sum rounded to float32."""
    return (_rdfloor(rate, rm).astype(np.float64) + np.float64(rddiv) *
            err.astype(np.float64)).astype(np.float32)


def _k6_block(i0, cb, qb, dq_dc, dq_ac, ctx, tcb, rm, rddiv, tok, val):
    """trellis_block<i0> over a batch of threads (axis 0): cb, qb raster
    [n,16]; tcb [n,16,3,12] int16; rm [n] float32; tok int8 and val int16.
    A thread skips positions at or past its eob, takes only the ZERO fold
    at a zero inside it, and keeps three bit masks (bb0, bb1, sc); the
    forward walk visits every non-zero position. Returns (levels raster,
    eob)."""
    n = qb.shape[0]
    ar = np.arange(n)
    qz, cz = _to_scan(qb).astype(np.int64), _to_scan(cb).astype(np.int64)
    tcb = tcb.astype(np.int32)
    eob = np.zeros(n, np.int64)
    for i in range(16):
        eob = np.where(qz[:, i] != 0, i + 1, eob)

    def vidx(a):
        return np.where(a < 67, a, 67 + ((a - 67) & 2047))

    def cost(r, e):
        return _rdcost(r, e, rm, rddiv)

    rate0 = np.zeros(n, np.int32)
    rate1 = np.zeros(n, np.int32)
    err0 = np.zeros(n, np.int64)
    err1 = np.zeros(n, np.int64)
    tok0 = np.full(n, EOB)
    tok1 = np.full(n, EOB)
    nxt = eob.copy()
    bb0 = np.zeros(n, np.int64)
    bb1 = np.zeros(n, np.int64)
    sc = np.zeros(n, np.int64)
    for i in range(15, i0 - 1, -1):
        tn = tcb[ar, min(i + 1, 15)]                      # [n,3,12]
        x = qz[:, i]
        live = i < eob
        zero = live & (x == 0)
        f0, f1 = zero & (tok0 != EOB), zero & (tok1 != EOB)
        rate0 = rate0 + np.where(f0, tn[ar, 0, tok0], 0).astype(np.int32)
        rate1 = rate1 + np.where(f1, tn[ar, 0, tok1], 0).astype(np.int32)
        tok0 = np.where(f0, 0, tok0)
        tok1 = np.where(f1, 0, tok1)
        nz = live & (x != 0)
        drc = dq_dc if i == 0 else dq_ac
        ax = np.abs(x)
        g0 = nxt < 16
        pt0 = np.minimum(ax, 2)
        r00 = rate0 + np.where(g0, tn[ar, pt0, tok0], 0).astype(np.int32)
        r01 = rate1 + np.where(g0, tn[ar, pt0, tok1], 0).astype(np.int32)
        best0 = cost(r01, err1) < cost(r00, err0)
        dx = x * drc - cz[:, i]
        vi0 = vidx(ax)
        nrate0 = val[vi0] + np.where(best0, r01, r00)
        nerr0 = dx * dx + np.where(best0, err1, err0)
        adrc, acz = ax * drc, np.abs(cz[:, i])
        shortcut = (adrc > acz) & (adrc < acz + drc)
        sgn = np.sign(x)
        x1 = np.where(shortcut, x - sgn, x)
        a1 = np.abs(x1)
        vi1 = vidx(a1)
        t1n = tok[vi1]
        tb0 = np.where(a1 == 0, np.where(tok0 == EOB, EOB, 0), t1n)
        tb1 = np.where(a1 == 0, np.where(tok1 == EOB, EOB, 0), t1n)
        pt1 = np.minimum(a1, 2)
        r10 = rate0 + np.where(g0 & (tb0 != EOB), tn[ar, pt1, tok0],
                               0).astype(np.int32)
        r11 = rate1 + np.where(g0 & (tb1 != EOB), tn[ar, pt1, tok1],
                               0).astype(np.int32)
        best1 = cost(r11, err1) < cost(r10, err0)
        dx1 = np.where(shortcut, dx - sgn * drc, dx)
        nrate1 = val[vi1] + np.where(best1, r11, r10)
        nerr1 = dx1 * dx1 + np.where(best1, err1, err0)
        ntok1 = np.where(best1, tb1, tb0)
        rate0 = np.where(nz, nrate0, rate0).astype(np.int32)
        rate1 = np.where(nz, nrate1, rate1).astype(np.int32)
        err0 = np.where(nz, nerr0, err0)
        err1 = np.where(nz, nerr1, err1)
        tok0 = np.where(nz, tok[vi0], tok0)
        tok1 = np.where(nz, ntok1, tok1)
        nxt = np.where(nz, i, nxt)
        bb0 |= (nz & best0).astype(np.int64) << i
        bb1 |= (nz & best1).astype(np.int64) << i
        sc |= (nz & shortcut).astype(np.int64) << i
    tb = tcb[ar, i0, ctx]                                  # [n,12]
    br = cost(rate1 + tb[ar, tok1], err1) < cost(rate0 + tb[ar, tok0], err0)
    out = np.zeros((n, 16), np.int64)
    out[:, :i0] = qz[:, :i0]
    for i in range(i0, 16):
        x = qz[:, i]
        step = br & (((sc >> i) & 1) != 0)
        out[:, i] = np.where(step, x - np.sign(x), x)
        br = np.where(x != 0, ((np.where(br, bb1, bb0) >> i) & 1) != 0, br)
    eob_out = np.zeros(n, np.int64)
    for i in range(16):
        eob_out = np.where(out[:, i] != 0, i + 1, eob_out)
    raster = np.zeros_like(out)
    raster[:, ZZ] = out
    return raster, eob_out


def _k6_emulate(coefs, q0, e0, d1, d2, duv, rdmult, rddiv, grid=None):
    ni = coefs.shape[0]
    tcbs = np.stack([t.numpy() for t in _tcb()]).astype(np.int16)
    tok, val = (t.numpy() for t in RD._k6_value_tables("cpu"))
    assert tok.dtype == np.int8 and val.dtype == np.int16
    tok, val = tok.astype(np.int64), val.astype(np.int64)
    qcoeff = np.full((ni, 25, 16), -99999, np.int64)
    eobs = np.full((ni, 25), -1, np.int64)
    rdm = np.float32(rdmult)
    for i0, (m, b) in zip((1, 0), _k6_threads(ni, grid)):
        plane = np.where(b < 16, 0, np.where(b < 24, 2, 1))  # tcb0/tcb2/tcb1
        dq = np.stack([d1, duv, d2])[np.where(b < 16, 0, np.where(
            b < 24, 1, 2)), m]
        pm = np.asarray([4.0, 16.0, 2.0], np.float32)[plane]
        q, e = _k6_block(i0, coefs[m, b], q0[m, b], dq[:, 0].astype(np.int64),
                         dq[:, 1].astype(np.int64), _k6_contexts(e0, m, b),
                         tcbs[plane], rdm * pm, rddiv, tok, val)
        qcoeff[m, b] = q
        eobs[m, b] = np.where(b < 16, np.maximum(e, 1), e)
    return qcoeff, eobs


@pytest.mark.parametrize("qindex", [0, 4, 24, 63, 127])
def test_k6_emulation_matches_plain(qindex):
    case = trellis_case(np, np.random.default_rng(200 + qindex), 128,
                        qindex)
    got = _k6_emulate(*case, grid=5)   # 5 blocks: warps take 2-3 tiles
    want = _plain(case)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("qindex", [0, 4, 24, 63, 127])
def test_rdcost_recipe_matches_rdc(qindex):
    """rdcost.cuh's recipe (here `_rdcost`) equals ops/rd_device.py:rdc
    at each plane's rdmult (and K5's, factor 1) over the rates and errors a
    trellis or K5 can reach: rates below 2^20, errors up to 2^32. Its floor
    term, a product by 2^-8, equals the IEEE quotient by 256 it replaced on
    every rate below 2^20, bit for bit."""
    from libvpx_opencl_tpu_torch.models import rdopt
    rdm, rdd, _ = rdopt.rd_consts(qindex)
    rng = np.random.default_rng(qindex)
    rate = np.concatenate([rng.integers(0, 2 ** 20, 4000),
                           np.arange(4096)]).astype(np.int32)
    err = np.concatenate([rng.integers(0, 2 ** 32, 4000),
                          rng.integers(0, 4096, 4096)])
    every = np.arange(2 ** 20, dtype=np.int32)
    for pm in (4.0, 16.0, 2.0, 1.0):
        rm = np.float32(rdm) * np.float32(pm)
        x = np.float32(128.0) + every.astype(np.float32) * rm
        assert x.dtype == np.float32 and (x >= 128).all()
        quot = np.floor(x / np.float32(256.0))
        np.testing.assert_array_equal(_rdfloor(every, rm).view(np.int32),
                                      quot.view(np.int32))
        want = RD.rdc(torch.from_numpy(rate), torch.from_numpy(err),
                      torch.tensor(float(rdm)) * pm, torch.tensor(float(rdd)))
        got = _rdcost(rate, err, np.full(rate.shape, rm, np.float32),
                      np.float32(rdd))
        np.testing.assert_array_equal(got, want.numpy())


def test_rate_bound():
    """K6 keeps rates in int32 and converts them to float32 inside rdc:
    a backward step adds one value cost and one token cost to a rate
    (a zero position one token cost), each below 2^15 in the encoder's
    tables, so 16 steps stay below 2^20 < 2^24; and K6 stages both kinds
    of cost as int16. A token cost is at most 11 tree bits of at most
    2048 each under any probability in [1, 255], so below 2^15 whatever
    the frame's probabilities."""
    from libvpx_opencl_tpu_torch.models import rdopt
    tok, val = RD._value_tables("cpu")
    assert 0 <= int(val.min()) and int(val.max()) < 2 ** 15
    assert 0 <= int(tok.min()) and int(tok.max()) <= EOB
    for t in TE._tcb_tables("cpu"):
        assert 0 <= int(t.min()) and int(t.max()) < 2 ** 15
    bit = max(max(rdopt.cost0(p), rdopt.cost1(p)) for p in range(1, 256))
    assert 11 * bit < 2 ** 15


def test_k6_value_tables_are_narrow_and_made_once():
    """K6's value tables: the token ids as int8 and the costs as int16,
    equal to the plain version's int32 tables, made once per device."""
    tok, val = RD._value_tables("cpu")
    ntok, nval = RD._k6_value_tables("cpu")
    assert ntok.dtype == torch.int8 and nval.dtype == torch.int16
    assert torch.equal(ntok.to(torch.int32), tok)
    assert torch.equal(nval.to(torch.int32), val)
    again = RD._k6_value_tables("cpu")
    assert again[0] is ntok and again[1] is nval


def test_cpu_trellis_runs_plain_and_launches_nothing():
    case = trellis_case(np, np.random.default_rng(7), 9, 24)
    before = dict(_cuda.launches)
    got = TE._trellis_mbs(*(_t(a) for a in case[:6]), *_tcb(),
                          torch.tensor(float(case[6])),
                          torch.tensor(float(case[7])))
    assert _cuda.launches == before
    want = _plain(case)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run by chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ni,qindex", [(1, 4), (31, 24), (200, 127)])
def test_k6_matches_plain_on_card(cuda_device, ni, qindex):
    """K6 on the card equals the plain version on the same tensors, in one
    launch (chip_smoke.py covers more sizes and the 1080p encode's
    inputs)."""
    case = trellis_case(np, np.random.default_rng(300 + ni), ni, qindex)
    args = [_t(a).to(cuda_device) for a in case[:6]] + \
        [t.to(cuda_device) for t in _tcb()] + \
        [torch.tensor(float(x), device=cuda_device) for x in case[6:]]
    before = _cuda.launches["trellis"]
    got = RD.trellis_mbs(*args)
    assert _cuda.launches["trellis"] == before + 1
    want = RD.trellis_mbs_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
