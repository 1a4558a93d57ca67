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


def _k6_threads(ni):
    """(MB, block) of each thread in launch order: the Y blocks' thread
    blocks first (i0 = 1), then UV and Y2 (i0 = 0)."""
    gy = np.arange(ni * 16)
    go = np.arange(ni * 9)
    return ((gy >> 4, gy & 15), (go // 9, 16 + go % 9))


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


def _rdcost(rate, err, rm, rddiv):
    """rdcost.cuh: rdfloor's float32 product, sum and quotient each
    rounded, the floor, then one float64 sum rounded to float32."""
    fl = np.floor((np.float32(128.0) + rate.astype(np.float32) * rm)
                  / np.float32(256.0))
    return (fl.astype(np.float64) + np.float64(rddiv) *
            err.astype(np.float64)).astype(np.float32)


def _k6_block(i0, cb, qb, dq_dc, dq_ac, ctx, tcb, rm, rddiv, tok, val):
    """trellis_block<i0> over a batch of threads (axis 0): cb, qb raster
    [n,16]; tcb [n,16,3,12]; rm [n] float32. Returns (levels raster, eob)."""
    n = qb.shape[0]
    ar = np.arange(n)
    qz, cz = _to_scan(qb).astype(np.int64), _to_scan(cb).astype(np.int64)
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
    qc1 = np.zeros((n, 16), np.int64)
    nxtp = np.zeros((n, 16), np.int64)
    bb0 = np.zeros(n, np.int64)
    bb1 = np.zeros(n, np.int64)
    for i in range(15, i0 - 1, -1):
        tn = tcb[ar, min(i + 1, 15)]                      # [n,3,12]
        x = qz[:, i]
        drc = dq_dc if i == 0 else dq_ac
        active = i < eob
        is_nz, is_z = active & (x != 0), active & (x == 0)
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
        qc1[:, i] = np.where(is_nz, x1, 0)
        bb0 |= best0.astype(np.int64) << i
        bb1 |= best1.astype(np.int64) << i
        nxtp[:, i] = nxt
        rate0 = np.where(is_nz, nrate0, rate0).astype(np.int32)
        rate1 = np.where(is_nz, nrate1, rate1).astype(np.int32)
        err0 = np.where(is_nz, nerr0, err0)
        err1 = np.where(is_nz, nerr1, err1)
        tok0 = np.where(is_nz, tok[vi0], tok0)
        tok1 = np.where(is_nz, ntok1, tok1)
        nxt = np.where(is_nz, i, nxt)
        f0, f1 = is_z & (tok0 != EOB), is_z & (tok1 != EOB)
        rate0 = rate0 + np.where(f0, tn[ar, 0, tok0], 0).astype(np.int32)
        rate1 = rate1 + np.where(f1, tn[ar, 0, tok1], 0).astype(np.int32)
        tok0 = np.where(f0, 0, tok0)
        tok1 = np.where(f1, 0, tok1)
    tb = tcb[ar, i0, ctx]                                  # [n,12]
    br = cost(rate1 + tb[ar, tok1], err1) < cost(rate0 + tb[ar, tok0], err0)
    out = np.zeros((n, 16), np.int64)
    out[:, :i0] = qz[:, :i0]
    cur = nxt
    for i in range(i0, 16):
        hit = (cur == i) & (i < eob)
        out[:, i] = np.where(hit, np.where(br, qc1[:, i], qz[:, i]), 0)
        br = np.where(hit, ((np.where(br, bb1, bb0) >> i) & 1) != 0, br)
        cur = np.where(hit, nxtp[:, i], cur)
    eob_out = np.zeros(n, np.int64)
    for i in range(16):
        eob_out = np.where(out[:, i] != 0, i + 1, eob_out)
    raster = np.zeros_like(out)
    raster[:, ZZ] = out
    return raster, eob_out


def _k6_emulate(coefs, q0, e0, d1, d2, duv, rdmult, rddiv):
    ni = coefs.shape[0]
    tcbs = np.stack([t.numpy() for t in _tcb()]).astype(np.int64)
    tok, val = (t.numpy().astype(np.int64) for t in RD._value_tables("cpu"))
    qcoeff = np.zeros((ni, 25, 16), np.int64)
    eobs = np.zeros((ni, 25), np.int64)
    rdm = np.float32(rdmult)
    for i0, (m, b) in zip((1, 0), _k6_threads(ni)):
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
    got = _k6_emulate(*case)
    want = _plain(case)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("qindex", [0, 4, 24, 63, 127])
def test_rdcost_recipe_matches_rdc(qindex):
    """rdcost.cuh's recipe (here `_rdcost`) equals ops/rd_device.py:rdc
    at each plane's rdmult over the rates and errors a trellis can reach:
    rates below 2^20, errors up to 2^32."""
    from libvpx_opencl_tpu_torch.models import rdopt
    rdm, rdd, _ = rdopt.rd_consts(qindex)
    rng = np.random.default_rng(qindex)
    rate = np.concatenate([rng.integers(0, 2 ** 20, 4000),
                           np.arange(4096)]).astype(np.int32)
    err = np.concatenate([rng.integers(0, 2 ** 32, 4000),
                          rng.integers(0, 4096, 4096)])
    for pm in (4.0, 16.0, 2.0):
        rm = np.float32(rdm) * np.float32(pm)
        want = RD.rdc(torch.from_numpy(rate), torch.from_numpy(err),
                      torch.tensor(float(rdm)) * pm, torch.tensor(float(rdd)))
        got = _rdcost(rate, err, np.full(rate.shape, rm, np.float32),
                      np.float32(rdd))
        np.testing.assert_array_equal(got, want.numpy())


def test_rate_bound():
    """K6 keeps rates in int32 and converts them to float32 inside rdc:
    a backward step adds one value cost and one token cost to a rate
    (a zero position one token cost), each below 2^15 in the encoder's
    tables, so 16 steps stay below 2^20 < 2^24."""
    tok, val = RD._value_tables("cpu")
    assert int(val.max()) < 2 ** 15 and int(tok.max()) <= EOB
    for t in TE._tcb_tables("cpu"):
        assert 0 <= int(t.min()) and int(t.max()) < 2 ** 15


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
