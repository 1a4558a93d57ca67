"""Device rate-distortion costing (PyTorch): batched token rates and
transform-domain distortions of quantized blocks under the frame's
entropy model.

Port of libvpx_opencl_tpu/ops/rd_device.py (the reference's per-block
costing: cost_coeffs rdopt.c:503-534, vp8_block_error /
vp8_mbblock_error; and optimize_b, encodemb.c:224-466, as
`trellis_batch`): every candidate mode of every macroblock is costed at
once as whole-frame tensor ops, and the trellis runs over a batch of
blocks, a step per scan position.

What differs from the JAX file, and why the numbers do not:
  * the JAX file turns small-table lookups into one-hot contractions over
    float32 cost tables, because a TPU's matrix unit likes them; every
    value is an integer below 2^24, so the integer gathers used here give
    the same rates;
  * token ids and extra-bit costs come from lookup tables built on the
    host with the JAX file's arithmetic (one gather instead of some
    hundred elementwise passes);
  * squared-error sums are taken exactly in int64 and rounded to float32
    once, so the result does not depend on a device's reduction order.
    The JAX file sums float32 squares, which is exact (and then equal)
    while the sum stays below 2^24;
  * the trellis keeps its rates and errors in int64 (the JAX file's
    float32 values are integers below 2^24, so exact too) and replaces
    its one-hot `price` contraction, which has one non-zero term, by a
    gather.

`rdc` keeps the JAX file's float32 type and rounds as the jitted JAX
function does (see its docstring).

`trellis_mbs` runs the trellis of a frame's inter MBs (Y with Y2, Y2, U
and V) as one launch of csrc/trellis.cu (K6) on CUDA tensors, and its plain
version `trellis_mbs_plain` (three `trellis_batch` calls) on CPU tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..models import rdopt
from . import _cuda
from . import tables as T
from . import transforms as tf

ZZ = tuple(int(v) for v in T.ZIGZAG)           # scan -> raster
BANDS = tuple(int(v) for v in T.COEF_BANDS)    # scan -> band
CAT_MIN = (5, 7, 11, 19, 35, 67)
EOB = 11

# per-category extra-bit costs (fixed probs, tokenize.c:36-94)
_CAT_BIT_COSTS = tuple(
    tuple((rdopt.cost0(p), rdopt.cost1(p)) for p in probs)
    for probs in rdopt.CAT_PROBS)
_CAT6_SPAN = 1 << len(_CAT_BIT_COSTS[5])        # extra-bit values of cat6
_N_VALUES = CAT_MIN[5] + _CAT6_SPAN


def _token_of(a):
    """DCT token id from |value| (fill_value_tokens thresholds), numpy."""
    t = np.minimum(a, 4)
    for k, lo in enumerate(CAT_MIN):
        t = np.where(a >= lo, 5 + k, t)
    return t


def _value_cost(a, tok):
    """Extra-bit + sign cost of a coefficient value (DCT_VALUE_COST dual:
    zero for literal tokens 0-4, category bits + half-prob sign above),
    numpy."""
    cost = np.zeros_like(a)
    for k in range(6):
        extra = a - CAT_MIN[k]
        bits = _CAT_BIT_COSTS[k]
        nb = len(bits)
        ck = np.zeros_like(a)
        for j, (c0, c1) in enumerate(bits):
            bit = (extra >> (nb - 1 - j)) & 1
            ck = ck + np.where(bit == 1, c1, c0)
        cost = np.where(tok == 5 + k, ck + 256, cost)
    return cost


@functools.lru_cache(maxsize=None)
def _value_tables(device):
    """(token id, value cost) int32 lookup tables over the value index of
    `_value_index`, on `device`."""
    a = np.arange(_N_VALUES, dtype=np.int64)
    tok = _token_of(a)
    return (torch.tensor(tok, dtype=torch.int32, device=device),
            torch.tensor(_value_cost(a, tok), dtype=torch.int32,
                         device=device))


@functools.lru_cache(maxsize=None)
def _k6_value_tables(device):
    """`_value_tables` narrowed for K6's shared memory: token ids as int8
    and value costs as int16 (each below 2^15), on `device`; made once per
    device."""
    tok, val = _value_tables(device)
    return tok.to(torch.int8), val.to(torch.int16)


def _value_index(a):
    """Index of |value| `a` into the value tables: the value itself below
    cat6, and cat6's low extra bits above (its cost reads no others)."""
    return torch.where(a < CAT_MIN[5], a,
                       CAT_MIN[5] + ((a - CAT_MIN[5]) & (_CAT6_SPAN - 1)))


def banded_token_costs(tc, btype):
    """Host helper: [8,3,12] token-cost table for one block type, expanded
    to scan position -> [16,3,12] int32 (cost_coeffs indexes by
    COEF_BANDS[c])."""
    t = np.asarray(tc[btype], np.int64)[list(BANDS)]   # [16,3,12]
    return torch.from_numpy(t.astype(np.int32))


def block_rate(q, tcb, start, ctx0):
    """Token rate of quantized blocks (cost_coeffs rdopt.c:503-534).

    q [..., 16] raster levels; tcb [16,3,12] int32 banded costs on q's
    device; start: 0, or 1 for Y-with-Y2; ctx0 entropy context 0..2, an int
    or a [...] tensor.
    Returns (rate [...] int32, nz [...] int32)."""
    dev = q.device
    qz = q[..., ZZ].to(torch.int32)
    a = qz.abs()
    toktab, valtab = _value_tables(dev)
    vi = _value_index(a).long()
    tok = toktab[vi].long()
    scan = torch.arange(16, device=dev)
    eob = torch.where(qz != 0, scan + 1, 0).amax(-1).clamp(min=start)
    # previous-token class per scan position (PREV_TOKEN_CLASS == min(a,2))
    pt = torch.cat([torch.zeros_like(a[..., :1]),
                    a[..., :-1].clamp(max=2)], -1).long()
    pt[..., start] = ctx0 if isinstance(ctx0, int) else ctx0.long()
    base = tcb[scan, pt, tok]
    inside = (scan >= start) & (scan < eob[..., None])
    rate = torch.where(inside, base + valtab[vi], 0).sum(-1)
    # EOB token cost at scan position == eob (when eob < 16)
    at_eob = scan == eob[..., None]
    rate = rate + torch.where(at_eob, tcb[scan, pt, EOB], 0).sum(-1)
    return rate.to(torch.int32), (eob > start).to(torch.int32)


def _mb_blocks(resid):
    """[..., 16, 16] pixel residual -> [..., 16, 4, 4]: the MB's sixteen
    4x4 blocks in raster order."""
    s = resid.shape[:-2]
    x = resid.reshape(*s, 4, 4, 4, 4)          # (by, py, bx, px)
    return x.transpose(-3, -2).reshape(*s, 16, 4, 4)


def _dq_vec(dq):
    """[..., 2] (dc, ac) -> [..., 16] int64 per-coefficient factors."""
    return torch.cat([dq[..., 0:1], dq[..., 1:2].expand(*dq.shape[:-1], 15)],
                     -1).long()


def _sq_err(coefs, q, dqv):
    """Exact sum over the last axis of (coefs - q*dqv)^2, int64."""
    e = coefs.long() - q.long() * dqv
    return (e * e).sum(-1)


def _ctx_grid(nz, g):
    """Entropy contexts chained inside the MB: above + left non-zero flags
    over a g x g block grid (external context 0). nz [..., g*g]."""
    nzg = nz.reshape(*nz.shape[:-1], g, g)
    above = torch.cat([torch.zeros_like(nzg[..., :1, :]),
                       nzg[..., :-1, :]], -2)
    left = torch.cat([torch.zeros_like(nzg[..., :, :1]),
                      nzg[..., :, :-1]], -1)
    return (above + left).reshape(nz.shape)


def rd_y16(resid, dq1, dq2, qidx, tcb0, tcb1):
    """Whole-MB Y rate/distortion under the has_y2 layout
    (_quant_y16 + _cost_y dual, regular zbin quant: the quantizer the
    encode wavefront applies).

    resid [..., 16, 16] int32; dq1/dq2 [..., 2]; qidx [...].
    Returns (rate [...] int32, dist [...] float32 transform-domain error
    before the >>2, nz16 [..., 16] per-block non-zero flags)."""
    blocks = _mb_blocks(resid)
    coefs = tf.fdct4x4_batch(blocks).reshape(*blocks.shape[:-2], 16)
    y2 = tf.walsh4x4_batch(coefs[..., :, 0])
    q, eobs = tf.regular_quant_batch(coefs, dq1[..., None, :],
                                     qidx[..., None], True)
    qy2, _ = tf.regular_quant_batch(y2, dq2, qidx, False)
    # distortion: AC error for the 16 Y blocks + full Y2 error
    ac = dq1[..., None, 1:2].long()
    dist = _sq_err(coefs[..., 1:], q[..., 1:], ac).sum(-1) + \
        _sq_err(y2, qy2, _dq_vec(dq2))
    nz = (eobs.clamp(min=1) > 1).to(torch.int32)        # start=1 blocks
    ry, _ = block_rate(q, tcb0, 1, _ctx_grid(nz, 4))
    r2, _ = block_rate(qy2, tcb1, 0, 0)
    return ry.sum(-1).to(torch.int32) + r2, dist.to(torch.float32), nz


def rd_uv(resid_u, resid_v, dq_uv, qidx, tcb2):
    """Chroma rate/distortion (_quant_uv + _cost_uv dual).

    resid_u/resid_v [..., 8, 8] int32; dq_uv [..., 2]; qidx [...].
    Returns (rate [...] int32, dist [...] float32)."""
    rate = dist = None
    dqv = _dq_vec(dq_uv)[..., None, :]
    for resid in (resid_u, resid_v):
        s = resid.shape[:-2]
        x = resid.reshape(*s, 2, 4, 2, 4).transpose(-3, -2) \
            .reshape(*s, 4, 4, 4)
        coefs = tf.fdct4x4_batch(x).reshape(*s, 4, 16)
        q, eobs = tf.regular_quant_batch(coefs, dq_uv[..., None, :],
                                         qidx[..., None], False)
        d = _sq_err(coefs, q, dqv).sum(-1).to(torch.float32)
        nz = (eobs > 0).to(torch.int32)
        r, _ = block_rate(q, tcb2, 0, _ctx_grid(nz, 2))
        r = r.sum(-1).to(torch.int32)
        rate = r if rate is None else rate + r
        dist = d if dist is None else dist + d
    return rate, dist


def rdc(rate, dist, rdmult, rddiv):
    """RDCOST (rdopt.h): ((128 + rate*rdmult) >> 8) + rddiv*dist, as the
    JAX encoder computes it under `jax.jit` (decision only: the pack layer
    recomputes exact rates). rdmult, rddiv: float32 scalars (0-dim tensors
    or Python numbers).

    The floor term is float32, as in the JAX file. XLA fuses the final
    `floor(..) + rddiv * dist` into one multiply-add, so the sum is taken
    in float64 and rounded to float32 once. For the values the encoder
    passes (integer floor terms below 2^24, rddiv <= 100, distortions that
    are multiples of 1/4 below 2^32) the float64 product and sum are exact,
    so this equals the fused result bit for bit at every qindex."""
    r = torch.as_tensor(rate).to(torch.float32)
    fl = torch.floor((128.0 + r * rdmult) / 256.0)
    d = torch.as_tensor(dist, device=fl.device).to(torch.float64)
    return (fl.to(torch.float64)
            + torch.as_tensor(rddiv).to(torch.float64) * d).to(torch.float32)


INV_ZZ = tuple(int(v) for v in np.argsort(np.asarray(ZZ)))  # raster -> scan


def trellis_batch(coefs, q, dq, tcb, i0, plane_rd_mult, ctx, rdmult, rddiv):
    """optimize_b (encodemb.c:224-466) over a batch of 4x4 blocks: a
    backward Viterbi over scan positions 15..i0 with two candidates per
    non-zero level (the level, and one step toward zero where the
    requantized value still brackets the coefficient), costing token
    transitions under the frame's entropy model, then a forward walk down
    the chosen chain.

    coefs/q [..., 16] raster; dq [..., 2] (dc, ac); tcb [16,3,12] int32
    banded costs on q's device; i0: 0, or 1 for Y-with-Y2; plane_rd_mult a
    power of two (4.0 Y, 16.0 Y2, 2.0 UV); ctx [...] entropy context 0..2;
    rdmult/rddiv float32 scalars (0-dim tensors or Python numbers).
    Returns (levels [..., 16] raster int32, eob [...] int32).

    Rates and errors are exact int64 (the JAX function's float32 values are
    integers below 2^24, so exact too). Candidates are compared by `rdc`
    with rdmult * plane_rd_mult, strictly (`<`), so ties keep candidate 0.
    The JAX function computes its own `floor((128 + r*rm)/256) + rddiv*e`
    in float32 inside a scan; `rdc`'s rounding (module docstring) gives the
    same decisions: on the encoder's values 128 + r*rm rounds the same
    fused or not (128 is a multiple of the float32 spacing there), and
    rddiv*e + floor stays below 2^24. tests/test_torch_trellis.py holds
    the two against `jax.jit` at qindex 0-127 on all three planes."""
    shape = q.shape[:-1]
    dev = q.device
    qz = q.reshape(-1, 16)[:, ZZ].long()
    cz = coefs.reshape(-1, 16)[:, ZZ].long()
    dq = dq.expand(*shape, 2).reshape(-1, 2).long()
    ctx = torch.as_tensor(ctx, device=dev).expand(shape).reshape(-1).long()
    tcb = tcb.long()
    toktab, valtab = _value_tables(dev)
    toktab, valtab = toktab.long(), valtab.long()
    m = qz.shape[0]
    scan = torch.arange(16, device=dev)
    eob = torch.where(qz != 0, scan + 1, 0).amax(-1)
    rm = torch.as_tensor(rdmult, dtype=torch.float32, device=dev) \
        * plane_rd_mult

    def cost(r, e):
        return rdc(r, e, rm, rddiv)

    def token(a):
        return toktab[_value_index(a)]

    def value_cost(a):
        return valtab[_value_index(a)]

    zero = torch.zeros(m, dtype=torch.long, device=dev)
    rate = [zero, zero]
    err = [zero, zero]
    tok = [torch.full_like(zero, EOB), torch.full_like(zero, EOB)]
    next_pos = eob
    # per-position chain outputs: the two candidate levels, each
    # candidate's predecessor choice, the next non-zero position
    qc = [torch.zeros(m, 16, dtype=torch.long, device=dev) for _ in range(2)]
    bb = [torch.zeros(m, 16, dtype=torch.bool, device=dev) for _ in range(2)]
    nxtp = torch.zeros(m, 16, dtype=torch.long, device=dev)
    for i in range(15, i0 - 1, -1):
        active = i < eob
        x = qz[:, i]
        czi = cz[:, i]
        drc = dq[:, 0] if i == 0 else dq[:, 1]
        is_nz = active & (x != 0)
        is_z = active & (x == 0)
        tn = tcb[min(i + 1, 15)]                          # [3, 12]
        ax = x.abs()
        # candidate 0: keep the level
        g0 = next_pos < 16
        pt0 = ax.clamp(max=2)
        r0 = [rate[c] + torch.where(g0, tn[pt0, tok[c]], 0) for c in (0, 1)]
        best0 = cost(r0[1], err[1]) < cost(r0[0], err[0])
        dx = x * drc - czi
        nrate0 = value_cost(ax) + torch.where(best0, r0[1], r0[0])
        nerr0 = dx * dx + torch.where(best0, err[1], err[0])
        # candidate 1: one step toward zero
        shortcut = (ax * drc > czi.abs()) & (ax * drc < czi.abs() + drc)
        x1 = torch.where(shortcut, x - x.sign(), x)
        a1 = x1.abs()
        t1n = token(a1)
        tb = [torch.where(a1 == 0, torch.where(tok[c] == EOB, EOB, 0), t1n)
              for c in (0, 1)]
        pt1 = a1.clamp(max=2)
        r1 = [rate[c] + torch.where(g0 & (tb[c] != EOB), tn[pt1, tok[c]], 0)
              for c in (0, 1)]
        best1 = cost(r1[1], err[1]) < cost(r1[0], err[0])
        dx1 = torch.where(shortcut, dx - x.sign() * drc, dx)
        nrate1 = value_cost(a1) + torch.where(best1, r1[1], r1[0])
        nerr1 = dx1 * dx1 + torch.where(best1, err[1], err[0])
        ntok1 = torch.where(best1, tb[1], tb[0])
        qc[0][:, i] = torch.where(is_nz, x, 0)
        qc[1][:, i] = torch.where(is_nz, x1, 0)
        bb[0][:, i] = best0
        bb[1][:, i] = best1
        nxtp[:, i] = next_pos
        rate = [torch.where(is_nz, nrate0, rate[0]),
                torch.where(is_nz, nrate1, rate[1])]
        err = [torch.where(is_nz, nerr0, err[0]),
               torch.where(is_nz, nerr1, err[1])]
        tok = [torch.where(is_nz, token(ax), tok[0]),
               torch.where(is_nz, ntok1, tok[1])]
        next_pos = torch.where(is_nz, i, next_pos)
        # zero positions inside the eob: fold the ZERO token
        for c in (0, 1):
            pz = is_z & (tok[c] != EOB)
            rate[c] = rate[c] + torch.where(pz, tn[0, tok[c]], 0)
            tok[c] = torch.where(pz, 0, tok[c])

    # base transition at i0 under the true entropy context
    tb0 = tcb[i0]
    rf = [rate[c] + tb0[ctx, tok[c]] for c in (0, 1)]
    br = cost(rf[1], err[1]) < cost(rf[0], err[0])

    # forward walk down the chosen chain
    out = torch.zeros(m, 16, dtype=torch.long, device=dev)
    out[:, :i0] = qz[:, :i0]
    cur = next_pos
    for i in range(i0, 16):
        hit = (cur == i) & (i < eob)
        out[:, i] = torch.where(hit, torch.where(br, qc[1][:, i],
                                                 qc[0][:, i]), out[:, i])
        br = torch.where(hit, torch.where(br, bb[1][:, i], bb[0][:, i]), br)
        cur = torch.where(hit, nxtp[:, i], cur)
    eob_out = torch.where(out != 0, scan + 1, 0).amax(-1)
    return (out[:, INV_ZZ].to(torch.int32).reshape(*shape, 16),
            eob_out.to(torch.int32).reshape(shape))


def trellis_mbs_plain(coefs, q0, e0, dq_y1, dq_y2, dq_uv, tcb0, tcb1, tcb2,
                      rdmult, rddiv):
    """optimize_b on M macroblocks' levels (the vp8_optimize_mby/mbuv
    role), the plain version of `trellis_mbs`: coefs, q0 [M,25,16] and e0
    [M,25] as `models/wavefront.py:transform_quant` returns them. The
    entropy contexts chain inside the MB from the regular quantizer's eobs.
    Returns (qcoeff [M,25,16], eobs [M,25]), Y eobs at least 1."""
    m = coefs.shape[0]
    ctx_y = _ctx_grid((e0[:, :16] > 1).to(torch.int32), 4)
    qy, ey = trellis_batch(coefs[:, :16], q0[:, :16], dq_y1[:, None], tcb0,
                           1, 4.0, ctx_y, rdmult, rddiv)
    qy2, ey2 = trellis_batch(coefs[:, 24], q0[:, 24], dq_y2, tcb1, 0, 16.0,
                             0, rdmult, rddiv)
    nzuv = (e0[:, 16:24] > 0).to(torch.int32).reshape(m, 2, 4)
    quv, euv = trellis_batch(coefs[:, 16:24], q0[:, 16:24], dq_uv[:, None],
                             tcb2, 0, 2.0, _ctx_grid(nzuv, 2).reshape(m, 8),
                             rdmult, rddiv)
    return (torch.cat([qy, quv, qy2[:, None]], 1),
            torch.cat([ey.clamp(min=1), euv, ey2[:, None]], 1))


def trellis_mbs(coefs, q0, e0, dq_y1, dq_y2, dq_uv, tcb0, tcb1, tcb2,
                rdmult, rddiv):
    """The trellis of M inter MBs, arguments and result as
    `trellis_mbs_plain`.

    CUDA tensors: one launch of csrc/trellis.cu (K6) when M > 0, counted in
    launches["trellis"]; every tensor int32 on one card, rdmult/rddiv
    float32 scalars (0-dim tensors on the card, as TorchEncoder holds them,
    or Python numbers). CPU tensors: the plain version."""
    args = (coefs, q0, e0, dq_y1, dq_y2, dq_uv, tcb0, tcb1, tcb2)
    if all(t.device.type == "cpu" for t in args):
        return trellis_mbs_plain(*args, rdmult, rddiv)
    ins = k6_inputs(*args, rdmult, rddiv)
    out = (torch.empty_like(ins[0]), torch.empty_like(ins[2]))
    if coefs.shape[0]:
        k6_launch(ins, out)
    return out


def k6_inputs(coefs, q0, e0, dq_y1, dq_y2, dq_uv, tcb0, tcb1, tcb2, rdmult,
              rddiv):
    """K6's checked inputs on the card, in its C entry point's order:
    (coefs, q0, e0, dq_y1, dq_y2, dq_uv, tcb0, tcb1, tcb2, token table
    int8, value-cost table int16, rdmult, rddiv). The value tables are made
    once per card (`_k6_value_tables`). Raises ValueError on what the
    kernel does not take."""
    dev = coefs.device
    m = coefs.shape[0]
    shapes = [(m, 25, 16), (m, 25, 16), (m, 25), (m, 2), (m, 2), (m, 2)] + \
        [(16, 3, 12)] * 3
    ins = [coefs, q0, e0, dq_y1, dq_y2, dq_uv, tcb0, tcb1, tcb2]
    for t, shape in zip(ins, shapes):
        if t.device != dev or dev.type != "cuda":
            raise ValueError("trellis_mbs: every tensor must lie on one "
                             f"CUDA device, got {t.device} beside {dev}")
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"trellis_mbs: expected int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    ins = [t.contiguous() for t in ins]
    if any(t.data_ptr() % 16 for t in ins[:2]):
        raise ValueError("trellis_mbs: coefs and q0 must be 16-byte aligned")
    ins += list(_k6_value_tables(dev))
    ins += [torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())
            for x in (rdmult, rddiv)]
    return tuple(ins)


def k6_launch(ins, out):
    """One K6 launch on the current stream of the inputs' card: `ins` from
    `k6_inputs`, `out` (qcoeff [M,25,16], eobs [M,25]) int32, M > 0."""
    fn = _cuda.load()["trellis"]
    dev = ins[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in ins[:13]), ins[0].shape[0],
                out[0].data_ptr(), out[1].data_ptr(), stream)
    _cuda.check(rc, "trellis")
    _cuda.count_launch("trellis")
