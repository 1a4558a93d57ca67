"""Rate-distortion machinery for the encoder: token costs, trellis
coefficient optimization, and mode/MV signaling costs.

Behavioral ports (reference = the libvpx v1.0.0 sources):
  probability bit costs ....... vp8/encoder/treewriter.h (vp8_cost_zero/one)
  token cost tables ........... vp8/encoder/rdopt.c:129-146 fill_token_costs
  per-value token/extra costs . vp8/encoder/tokenize.c:36-94 fill_value_tokens
  trellis (optimize_b) ........ vp8/encoder/encodemb.c:199-466
  coefficient rate ............ vp8/encoder/rdopt.c:503-534 cost_coeffs
  RD constants ................ vp8/encoder/rdopt.c:197-246
                                 vp8_initialize_rd_consts (RDMULT = 2.70*Q^2)
  MV bit cost ................. vp8/encoder/mcomp.c:26-48 vp8_mv_bit_cost
"""
from __future__ import annotations

import math

import numpy as np

from ..ops import tables as T

ZIGZAG = T.ZIGZAG.tolist()
COEF_BANDS = T.COEF_BANDS.tolist()
PREV_TOKEN_CLASS = T.PREV_TOKEN_CLASS.tolist()
CAT_MIN = [5, 7, 11, 19, 35, 67]
CAT_PROBS = [T.PCAT1.tolist(), T.PCAT2.tolist(), T.PCAT3.tolist(),
             T.PCAT4.tolist(), T.PCAT5.tolist(), T.PCAT6.tolist()]
EOB_TOKEN = 11
DCT_MAX = 2048

# cost in 1/256-bit units of coding bit=0 / bit=1 at probability p
_C0 = np.zeros(256, np.int64)
_C1 = np.zeros(256, np.int64)
for _p in range(1, 256):
    _C0[_p] = int(round(-math.log2(_p / 256.0) * 256))
    _C1[_p] = int(round(-math.log2((256 - _p) / 256.0) * 256))
_C0[0] = _C1[0] = 1 << 20


def cost0(p):
    return int(_C0[p])


def cost1(p):
    return int(_C1[p])


def tree_cost(tree, probs, leaf):
    """Bit cost of coding `leaf` with a vp8 tree (treewriter semantics)."""
    # find the path by walking every node (trees are tiny)
    def walk(node, bits):
        for b in (0, 1):
            nxt = tree[node + b]
            pb = cost0(probs[node >> 1]) if b == 0 else cost1(probs[node >> 1])
            if nxt <= 0:
                if -nxt == leaf:
                    return bits + pb
            else:
                r = walk(nxt, bits + pb)
                if r is not None:
                    return r
        return None

    return walk(0, 0)


def build_token_costs(coef_probs):
    """[4,8,3,12] costs of each DCT token under the frame's coefficient
    probabilities (fill_token_costs / vp8_cost_tokens over vp8_coef_tree;
    full-path costs including the root EOB branch)."""
    cp = np.asarray(coef_probs, np.int64)
    c = np.zeros((4, 8, 3, 12), np.int64)
    p = [cp[..., i] for i in range(11)]
    z0 = _C0[p[0]]
    z1 = _C1[p[0]]
    c[..., 11] = z0                                   # EOB
    c[..., 0] = z1 + _C0[p[1]]                        # ZERO
    nz = z1 + _C1[p[1]]
    c[..., 1] = nz + _C0[p[2]]                        # ONE
    gt1 = nz + _C1[p[2]]
    lo = gt1 + _C0[p[3]]
    c[..., 2] = lo + _C0[p[4]]                        # TWO
    c[..., 3] = lo + _C1[p[4]] + _C0[p[5]]            # THREE
    c[..., 4] = lo + _C1[p[4]] + _C1[p[5]]            # FOUR
    hi = gt1 + _C1[p[3]]
    c[..., 5] = hi + _C0[p[6]] + _C0[p[7]]            # CAT1
    c[..., 6] = hi + _C0[p[6]] + _C1[p[7]]            # CAT2
    c3 = hi + _C1[p[6]]
    c[..., 7] = c3 + _C0[p[8]] + _C0[p[9]]            # CAT3
    c[..., 8] = c3 + _C0[p[8]] + _C1[p[9]]            # CAT4
    c[..., 9] = c3 + _C1[p[8]] + _C0[p[10]]           # CAT5
    c[..., 10] = c3 + _C1[p[8]] + _C1[p[10]]          # CAT6
    return c


def _build_value_tables():
    """Token id + extra-bit/sign cost per coefficient value (tokenize.c:36:
    cat extra bits at their fixed probabilities plus a half-prob sign; zero
    for literal tokens 0..4, mirroring fill_value_tokens)."""
    tok = np.zeros(2 * DCT_MAX, np.int32)
    cost = np.zeros(2 * DCT_MAX, np.int64)
    for v in range(-DCT_MAX, DCT_MAX):
        a = abs(v)
        if a <= 4:
            t = a
        elif a < 7:
            t = 5
        elif a < 11:
            t = 6
        elif a < 19:
            t = 7
        elif a < 35:
            t = 8
        elif a < 67:
            t = 9
        else:
            t = 10
        tok[v + DCT_MAX] = t
        if t >= 5:
            extra = a - CAT_MIN[t - 5]
            cbits = 0
            probs = CAT_PROBS[t - 5]
            nb = len(probs)
            for i, p in enumerate(probs):
                bit = (extra >> (nb - 1 - i)) & 1
                cbits += cost1(p) if bit else cost0(p)
            cbits += 256  # sign at vp8_prob_half
            cost[v + DCT_MAX] = cbits
    return tok, cost


DCT_VALUE_TOKEN, DCT_VALUE_COST = _build_value_tables()


def rd_consts(qindex):
    """(rdmult, rddiv, errorperbit) — vp8_initialize_rd_consts behavior."""
    capped_q = min(qindex, 160)
    rdmult = int(2.70 * capped_q * capped_q)
    errorperbit = max(1, rdmult // 110)
    if rdmult > 1000:
        return rdmult // 100, 1, errorperbit
    return rdmult, 100, errorperbit


def _rdcost(rm, dm, r, d):
    return ((128 + r * rm) >> 8) + dm * d


def _rdtrunc(rm, r):
    return (128 + r * rm) & 0xFF


def trellis_block(coeff, qcoeff, eob, dq, type_, ctx, token_costs,
                  rdmult, rddiv, intra):
    """optimize_b (encodemb.c:224-466): Viterbi over the two candidate
    roundings (level, level-1) of every nonzero coefficient, costing token
    transitions under the frame's entropy model.

    coeff/qcoeff: [16] raster; dq: (dc, ac); type_: plane type 0..3;
    ctx: combined entropy context 0..2. Returns (qcoeff', eob', next_ctx).
    """
    plane_rd_mult = (4, 16, 2, 4)[type_]
    rdmult = rdmult * plane_rd_mult
    if intra:
        rdmult = (rdmult * 9) >> 4
    i0 = 1 if type_ == 0 else 0
    tc = token_costs[type_]
    dqv = (int(dq[0]), int(dq[1]))

    # tokens[i][cand] = (rate, error, next, token, qc)
    rate = np.zeros((17, 2), np.int64)
    error = np.zeros((17, 2), np.int64)
    nxt = np.zeros((17, 2), np.int32)
    tokv = np.zeros((17, 2), np.int32)
    qcv = np.zeros((17, 2), np.int32)
    best_mask = [0, 0]

    rate[eob] = 0
    error[eob] = 0
    nxt[eob] = 16
    tokv[eob] = EOB_TOKEN
    qcv[eob] = 0
    next_ = eob
    q = qcoeff.copy()
    dqc = np.zeros(16, np.int64)
    for j in range(16):
        rc = ZIGZAG[j]
        dqc[rc] = int(q[rc]) * (dqv[0] if rc == 0 else dqv[1])

    i = eob
    while i > i0:
        i -= 1
        rc = ZIGZAG[i]
        x = int(q[rc])
        drc = dqv[0] if rc == 0 else dqv[1]
        if x:
            err0, err1 = int(error[next_][0]), int(error[next_][1])
            rate0, rate1 = int(rate[next_][0]), int(rate[next_][1])
            t0 = int(DCT_VALUE_TOKEN[x + DCT_MAX])
            if next_ < 16:
                band = COEF_BANDS[i + 1]
                pt = PREV_TOKEN_CLASS[t0]
                rate0 += int(tc[band][pt][tokv[next_][0]])
                rate1 += int(tc[band][pt][tokv[next_][1]])
            rd0 = _rdcost(rdmult, rddiv, rate0, err0)
            rd1 = _rdcost(rdmult, rddiv, rate1, err1)
            if rd0 == rd1:
                rd0 = _rdtrunc(rdmult, rate0)
                rd1 = _rdtrunc(rdmult, rate1)
            best = 1 if rd1 < rd0 else 0
            base_bits = int(DCT_VALUE_COST[x + DCT_MAX])
            dx = int(dqc[rc]) - int(coeff[rc])
            d2 = dx * dx
            rate[i][0] = base_bits + (rate1 if best else rate0)
            error[i][0] = d2 + (err1 if best else err0)
            nxt[i][0] = next_
            tokv[i][0] = t0
            qcv[i][0] = x
            best_mask[0] |= best << i

            # second candidate: one step toward zero (when requantization
            # still brackets the true coefficient)
            rate0, rate1 = int(rate[next_][0]), int(rate[next_][1])
            shortcut = (abs(x) * drc > abs(int(coeff[rc])) and
                        abs(x) * drc < abs(int(coeff[rc])) + drc)
            x1 = x
            if shortcut:
                sz = -1 if x < 0 else 0
                x1 = x - (2 * sz + 1)
            if x1 == 0:
                t0b = EOB_TOKEN if tokv[next_][0] == EOB_TOKEN else 0
                t1b = EOB_TOKEN if tokv[next_][1] == EOB_TOKEN else 0
            else:
                t0b = t1b = int(DCT_VALUE_TOKEN[x1 + DCT_MAX])
            if next_ < 16:
                band = COEF_BANDS[i + 1]
                if t0b != EOB_TOKEN:
                    rate0 += int(tc[band][PREV_TOKEN_CLASS[t0b]]
                                 [tokv[next_][0]])
                if t1b != EOB_TOKEN:
                    rate1 += int(tc[band][PREV_TOKEN_CLASS[t1b]]
                                 [tokv[next_][1]])
            rd0 = _rdcost(rdmult, rddiv, rate0, err0)
            rd1 = _rdcost(rdmult, rddiv, rate1, err1)
            if rd0 == rd1:
                rd0 = _rdtrunc(rdmult, rate0)
                rd1 = _rdtrunc(rdmult, rate1)
            best = 1 if rd1 < rd0 else 0
            base_bits = int(DCT_VALUE_COST[x1 + DCT_MAX])
            if shortcut:
                sz = -1 if x < 0 else 0
                dx -= (drc + sz) ^ sz
                d2 = dx * dx
            rate[i][1] = base_bits + (rate1 if best else rate0)
            error[i][1] = d2 + (err1 if best else err0)
            nxt[i][1] = next_
            tokv[i][1] = t1b if best else t0b
            qcv[i][1] = x1
            best_mask[1] |= best << i
            next_ = i
        else:
            band = COEF_BANDS[i + 1]
            t0 = int(tokv[next_][0])
            t1 = int(tokv[next_][1])
            if t0 != EOB_TOKEN:
                rate[next_][0] += int(tc[band][0][t0])
                tokv[next_][0] = 0
            if t1 != EOB_TOKEN:
                rate[next_][1] += int(tc[band][0][t1])
                tokv[next_][1] = 0

    band = COEF_BANDS[i0]
    rate0 = int(rate[next_][0]) + int(tc[band][ctx][tokv[next_][0]])
    rate1 = int(rate[next_][1]) + int(tc[band][ctx][tokv[next_][1]])
    rd0 = _rdcost(rdmult, rddiv, rate0, int(error[next_][0]))
    rd1 = _rdcost(rdmult, rddiv, rate1, int(error[next_][1]))
    if rd0 == rd1:
        rd0 = _rdtrunc(rdmult, rate0)
        rd1 = _rdtrunc(rdmult, rate1)
    best = 1 if rd1 < rd0 else 0
    final_eob = i0 - 1
    out = qcoeff.copy()
    i = next_
    while i < eob:
        x = int(qcv[i][best])
        if x:
            final_eob = i
        rc = ZIGZAG[i]
        out[rc] = x
        nx = int(nxt[i][best])
        best = (best_mask[best] >> i) & 1
        i = nx
    final_eob += 1
    return out, final_eob


def cost_block(q, eob, start, ctx, tc_type):
    """cost_coeffs (rdopt.c:503-534): token rate of one quantized block.
    Returns (cost, nonzero_ctx)."""
    cost = 0
    pt = ctx
    c = start
    while c < eob:
        v = int(q[ZIGZAG[c]])
        t = int(DCT_VALUE_TOKEN[v + DCT_MAX])
        cost += int(tc_type[COEF_BANDS[c]][pt][t]) \
            + int(DCT_VALUE_COST[v + DCT_MAX])
        pt = PREV_TOKEN_CLASS[t]
        c += 1
    if c < 16:
        cost += int(tc_type[COEF_BANDS[c]][pt][EOB_TOKEN])
    return cost, int(eob != start)


def _build_mv_cost_tables():
    """Per-component cost of an MV delta (in 1/8 units, even), from the
    default MV context (read_mvcomponent dual; entropymv.c probs)."""
    tables = []
    for comp in range(2):
        p = [int(v) for v in T.DEFAULT_MV_CONTEXT[comp]]
        tbl = np.zeros(1024, np.int64)  # indexed by x = |delta|>>1
        MVPsign, MVPshort, MVPbits = 1, 2, 9
        small_tree = T.SMALL_MV_TREE.tolist()
        for x in range(1024):
            cost = 0
            if x < 8:
                cost += cost0(p[0])
                cost += tree_cost(small_tree, p[MVPshort:], x)
            else:
                cost += cost1(p[0])
                for i in range(3):
                    cost += cost1(p[MVPbits + i]) if (x >> i) & 1 \
                        else cost0(p[MVPbits + i])
                for i in range(9, 3, -1):
                    cost += cost1(p[MVPbits + i]) if (x >> i) & 1 \
                        else cost0(p[MVPbits + i])
                if x & 0xFFF0:
                    cost += cost1(p[MVPbits + 3]) if (x >> 3) & 1 \
                        else cost0(p[MVPbits + 3])
            if x:
                cost += 256  # sign
            tbl[x] = cost
        tables.append(tbl)
    return tables


MV_COST = _build_mv_cost_tables()


def mv_cost(d_row, d_col, weight=96):
    """vp8_mv_bit_cost (mcomp.c:26-48): weighted component costs >> 7."""
    c = int(MV_COST[0][min(abs(d_row) >> 1, 1023)]) + \
        int(MV_COST[1][min(abs(d_col) >> 1, 1023)])
    return (c * weight) >> 7


# mode signaling cost tables (trees + default probs; the encoder does not
# update mode probabilities, matching its pack layer)
YMODE_COST = [tree_cost(T.YMODE_TREE.tolist(), T.YMODE_PROB.tolist(), m)
              for m in range(5)]
KF_YMODE_COST = [tree_cost(T.KF_YMODE_TREE.tolist(),
                           T.KF_YMODE_PROB.tolist(), m) for m in range(5)]
UV_MODE_COST = [tree_cost(T.UV_MODE_TREE.tolist(), T.UV_MODE_PROB.tolist(),
                          m) for m in range(4)]
KF_UV_MODE_COST = [tree_cost(T.UV_MODE_TREE.tolist(),
                             T.KF_UV_MODE_PROB.tolist(), m)
                   for m in range(4)]
BMODE_COST = [tree_cost(T.BMODE_TREE.tolist(), T.BMODE_PROB.tolist(), m)
              for m in range(10)]
KF_BMODE_COST = [[[tree_cost(T.BMODE_TREE.tolist(),
                             T.KF_BMODE_PROB[a][l].tolist(), m)
                   for m in range(10)] for l in range(10)]
                 for a in range(10)]


def mv_ref_cost(mode, probs):
    """Cost of the mv_ref decision (pack_mb_modes dual paths)."""
    from .refdec import NEARESTMV, NEARMV, ZEROMV, NEWMV, SPLITMV
    p = [int(v) for v in probs]
    if mode == ZEROMV:
        return cost0(p[0])
    if mode == NEARESTMV:
        return cost1(p[0]) + cost0(p[1])
    if mode == NEARMV:
        return cost1(p[0]) + cost1(p[1]) + cost0(p[2])
    if mode == NEWMV:
        return cost1(p[0]) + cost1(p[1]) + cost1(p[2]) + cost0(p[3])
    return cost1(p[0]) + cost1(p[1]) + cost1(p[2]) + cost1(p[3])  # SPLITMV
