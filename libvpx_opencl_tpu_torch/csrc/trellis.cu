// K6: the encoder's trellis (optimize_b) over every inter MB of a frame, one
// launch per encoded frame (per shard in the sharded encode); sm_90a.
//
// Replaces the JAX package's libvpx_opencl_tpu/ops/rd_device.py:trellis_batch
// (an XLA lax.scan over scan positions, no pallas_call) as the JAX encoder
// composes it for Y with Y2, Y2 and UV in
// libvpx_opencl_tpu/models/tpu_encoder.py (_encode_device). The port's plain
// version is ops/rd_device.py:trellis_mbs_plain over trellis_batch; this
// kernel follows trellis_batch step for step.
//
// What it computes. For each 4x4 block of Ni MBs ([Ni,25,16] int32 coefs
// and regular-quantizer levels in the order 16 Y, 4 U, 4 V, Y2; eobs e0
// [Ni,25]): a backward Viterbi over scan positions 15..i0 (i0 = 1 for Y,
// whose DC travels in Y2; 0 for UV and Y2) with two candidates per non-zero
// level (keep it, or one step toward zero where the requantized value still
// brackets the coefficient), each carrying its rate, error and token, costed
// under the banded token costs and compared by rdc (rdcost.cuh) with rdmult
// times the plane's factor (4 Y, 16 Y2, 2 UV), strictly, so ties keep
// candidate 0; then the base transition under the block's entropy context
// and a forward walk down the chosen chain. Contexts come from e0 inside the
// MB: above + left of (e0 > 1) on the 4x4 Y grid, of (e0 > 0) on each 2x2
// chroma plane, 0 for Y2. Output: levels [Ni,25,16] and eobs [Ni,25] (Y
// eobs at least 1), as ops/rd_device.py:trellis_mbs_plain returns them.
//
// Design. A thread per 4x4 block: blocks never read each other's result, so
// the only parallelism needed is across blocks, and 25 * Ni threads (56 k on
// a 1080p inter frame with 2.25 k inter MBs) fill the card. Thread blocks
// [0, yb) take the Y blocks (the i0 = 1 instantiation), the rest UV and Y2
// (i0 = 0), so no warp runs both. The per-position chain (the candidate-1
// level, both predecessor choices as 16-bit masks, the next non-zero
// position) stays in registers: every loop runs over compile-time positions,
// so no array is indexed at run time. The token-cost tables of the block's
// planes and the value tables (token id and extra-bit cost of |level|, cat6
// by its low 11 bits as ops/rd_device.py:_value_index) are staged once per
// thread block into shared memory (21.5 KB).
//
// Arithmetic. Rates are int32: a step adds at most a value cost and a token
// cost (each < 2^15 in the encoder's tables) to a rate, so 16 steps stay
// below 2^20, under 2^24 where the float conversion inside rdc is exact. Errors are
// int64, as in the plain version: (level*dq - coef)^2 passes 2^31 for
// large levels. rdc follows rdcost.cuh, which keeps nvcc from contracting
// a*b+c into an FMA.
//
// What bounds it on the card. Per MB it reads 3.3 KB (coefficients,
// levels, eobs, dequantizers) and writes 1.7 KB: ~11 MB on a 1080p inter
// frame with 2.25 k inter MBs, ~3.4 us at 3.35 TB/s; its ~16 steps x ~60
// operations per block are ~1 us at 67e12/s. Each thread's 16 steps are a dependent chain of
// shared-table reads and float/double compares, so the kernel is latency
// bound at this occupancy; tests/test_torch_trellis_k6.py emulates one
// thread's loop in numpy against the plain version.
#include <cstdint>
#include <cuda_runtime.h>

#include "rdcost.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kEob = 11;              // EOB_TOKEN
constexpr int kCat6Min = 67;          // first value of DCT_VAL_CATEGORY6
constexpr int kCat6Span = 2048;       // cat6 extra-bit values
constexpr int kValues = kCat6Min + kCat6Span;
constexpr int kTcb = 16 * 3 * 12;     // banded costs [scan pos][ctx][token]

// raster -> scan order (ops/tables.py:ZIGZAG), written out so that every
// index is a compile-time constant and the arrays stay in registers
__device__ __forceinline__ void to_scan(const int (&r)[16], int (&z)[16]) {
  z[0] = r[0];   z[1] = r[1];   z[2] = r[4];   z[3] = r[8];
  z[4] = r[5];   z[5] = r[2];   z[6] = r[3];   z[7] = r[6];
  z[8] = r[9];   z[9] = r[12];  z[10] = r[13]; z[11] = r[10];
  z[12] = r[7];  z[13] = r[11]; z[14] = r[14]; z[15] = r[15];
}

__device__ __forceinline__ void to_raster(const int (&z)[16], int (&r)[16]) {
  r[0] = z[0];   r[1] = z[1];   r[4] = z[2];   r[8] = z[3];
  r[5] = z[4];   r[2] = z[5];   r[3] = z[6];   r[6] = z[7];
  r[9] = z[8];   r[12] = z[9];  r[13] = z[10]; r[10] = z[11];
  r[7] = z[12];  r[11] = z[13]; r[14] = z[14]; r[15] = z[15];
}

__device__ __forceinline__ void load16(const int32_t* p, int (&v)[16]) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 w = __ldg(q + k);
    v[4 * k] = w.x;
    v[4 * k + 1] = w.y;
    v[4 * k + 2] = w.z;
    v[4 * k + 3] = w.w;
  }
}

__device__ __forceinline__ void store16(int32_t* p, const int (&v)[16]) {
  int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// index of |level| a into the value tables (ops/rd_device.py:_value_index)
__device__ __forceinline__ int value_index(unsigned a) {
  return a < kCat6Min ? (int)a
                      : kCat6Min + (int)((a - kCat6Min) & (kCat6Span - 1));
}

struct Tables {
  const int* tcb;   // this block's plane, [16][3][12]
  const int* tok;   // token id of a value index
  const int* val;   // extra-bit + sign cost of a value index
  float rm;         // rdmult * plane factor
  double rddiv;
};

__device__ __forceinline__ float cost(const Tables& t, int rate,
                                      long long err) {
  return rdcost(rdfloor((float)rate, t.rm), t.rddiv, (double)err);
}

// One block: coefficients cb and levels qb (raster), dequantizers, entropy
// context; writes the chosen levels (raster) and returns their eob.
template <int I0>
__device__ __forceinline__ int trellis_block(const int32_t* cb,
                                             const int32_t* qb, int dq_dc,
                                             int dq_ac, int ctx,
                                             const Tables& t, int32_t* ob) {
  int qz[16], cz[16];
  {
    int r[16];
    load16(qb, r);
    to_scan(r, qz);
    load16(cb, r);
    to_scan(r, cz);
  }
  int eob = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) eob = qz[i] != 0 ? i + 1 : eob;

  // backward Viterbi: candidate c = 0 keeps the level, c = 1 steps it
  // toward zero where `shortcut` holds
  int rate0 = 0, rate1 = 0, tok0 = kEob, tok1 = kEob, next = eob;
  long long err0 = 0, err1 = 0;
  int qc1[16], nxtp[16];
  unsigned bb0 = 0, bb1 = 0;
#pragma unroll
  for (int i = 15; i >= I0; --i) {
    const int* tn = t.tcb + (i < 15 ? i + 1 : 15) * 36;
    const int x = qz[i];
    const int drc = i == 0 ? dq_dc : dq_ac;
    const bool active = i < eob;
    const bool is_nz = active && x != 0, is_z = active && x == 0;
    const int ax = abs(x);
    const bool g0 = next < 16;
    // candidate 0: keep the level
    const int pt0 = ax < 2 ? ax : 2;
    const int r00 = rate0 + (g0 ? tn[pt0 * 12 + tok0] : 0);
    const int r01 = rate1 + (g0 ? tn[pt0 * 12 + tok1] : 0);
    const bool best0 = cost(t, r01, err1) < cost(t, r00, err0);
    const long long dx = (long long)x * drc - cz[i];
    const int vi0 = value_index((unsigned)ax);
    const int nrate0 = t.val[vi0] + (best0 ? r01 : r00);
    const long long nerr0 = dx * dx + (best0 ? err1 : err0);
    // candidate 1: one step toward zero
    const long long adrc = (long long)ax * drc;
    const long long acz = cz[i] < 0 ? -(long long)cz[i] : (long long)cz[i];
    const bool shortcut = adrc > acz && adrc < acz + drc;
    const int sgn = (x > 0) - (x < 0);
    const int x1 = shortcut ? x - sgn : x;
    const int a1 = abs(x1);
    const int vi1 = value_index((unsigned)a1);
    const int t1n = t.tok[vi1];
    const int tb0 = a1 == 0 ? (tok0 == kEob ? kEob : 0) : t1n;
    const int tb1 = a1 == 0 ? (tok1 == kEob ? kEob : 0) : t1n;
    const int pt1 = a1 < 2 ? a1 : 2;
    const int r10 = rate0 + (g0 && tb0 != kEob ? tn[pt1 * 12 + tok0] : 0);
    const int r11 = rate1 + (g0 && tb1 != kEob ? tn[pt1 * 12 + tok1] : 0);
    const bool best1 = cost(t, r11, err1) < cost(t, r10, err0);
    const long long dx1 = shortcut ? dx - (long long)sgn * drc : dx;
    const int nrate1 = t.val[vi1] + (best1 ? r11 : r10);
    const long long nerr1 = dx1 * dx1 + (best1 ? err1 : err0);
    const int ntok1 = best1 ? tb1 : tb0;
    // the chain: candidate 1's level (candidate 0's is qz[i]), both
    // predecessor choices, the next non-zero position
    qc1[i] = is_nz ? x1 : 0;
    bb0 |= (unsigned)best0 << i;
    bb1 |= (unsigned)best1 << i;
    nxtp[i] = next;
    if (is_nz) {
      rate0 = nrate0;
      rate1 = nrate1;
      err0 = nerr0;
      err1 = nerr1;
      tok0 = t.tok[vi0];
      tok1 = ntok1;
      next = i;
    }
    // zero positions inside the eob: fold the ZERO token
    if (is_z && tok0 != kEob) {
      rate0 += tn[tok0];
      tok0 = 0;
    }
    if (is_z && tok1 != kEob) {
      rate1 += tn[tok1];
      tok1 = 0;
    }
  }

  // base transition at i0 under the true entropy context
  const int* tb = t.tcb + I0 * 36 + ctx * 12;
  bool br = cost(t, rate1 + tb[tok1], err1) < cost(t, rate0 + tb[tok0], err0);

  // forward walk down the chosen chain. A hit is a non-zero position (the
  // chain links only those), where candidate 0's level is qz[i].
  int out[16];
#pragma unroll
  for (int i = 0; i < I0; ++i) out[i] = qz[i];
  int cur = next;
#pragma unroll
  for (int i = I0; i < 16; ++i) {
    const bool hit = cur == i && i < eob;
    out[i] = hit ? (br ? qc1[i] : qz[i]) : 0;
    br = hit ? (((br ? bb1 : bb0) >> i) & 1u) != 0 : br;
    cur = hit ? nxtp[i] : cur;
  }
  int eob_out = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) eob_out = out[i] != 0 ? i + 1 : eob_out;
  int r[16];
  to_raster(out, r);
  store16(ob, r);
  return eob_out;
}

__global__ void __launch_bounds__(kThreads)
    trellis_kernel(const int32_t* __restrict__ coefs,
                   const int32_t* __restrict__ q0,
                   const int32_t* __restrict__ e0,
                   const int32_t* __restrict__ dq_y1,
                   const int32_t* __restrict__ dq_y2,
                   const int32_t* __restrict__ dq_uv,
                   const int32_t* __restrict__ tcb0,
                   const int32_t* __restrict__ tcb1,
                   const int32_t* __restrict__ tcb2,
                   const int32_t* __restrict__ tok,
                   const int32_t* __restrict__ val,
                   const float* __restrict__ rdmult,
                   const float* __restrict__ rddiv, int ni, int y_blocks,
                   int32_t* __restrict__ qcoeff, int32_t* __restrict__ eobs) {
  __shared__ int s_tcb[2][kTcb];   // Y: tcb0; else UV (tcb2), Y2 (tcb1)
  __shared__ int s_tok[kValues];
  __shared__ int s_val[kValues];
  const bool luma = (int)blockIdx.x < y_blocks;   // uniform in the block
  for (int k = threadIdx.x; k < kTcb; k += kThreads) {
    s_tcb[0][k] = luma ? tcb0[k] : tcb2[k];
    if (!luma) s_tcb[1][k] = tcb1[k];
  }
  for (int k = threadIdx.x; k < kValues; k += kThreads) {
    s_tok[k] = tok[k];
    s_val[k] = val[k];
  }
  __syncthreads();
  const float rdm = *rdmult;
  Tables t{s_tcb[0], s_tok, s_val, 0.0f, (double)*rddiv};
  if (luma) {
    const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (g >= (int64_t)ni * 16) return;
    const int64_t m = g >> 4;
    const int b = (int)(g & 15);
    const int32_t* em = e0 + m * 25;
    const int ctx =
        (b >= 4 ? em[b - 4] > 1 : 0) + ((b & 3) ? em[b - 1] > 1 : 0);
    t.rm = __fmul_rn(rdm, 4.0f);
    const int64_t o = m * 25 + b;
    const int e = trellis_block<1>(coefs + o * 16, q0 + o * 16, dq_y1[2 * m],
                                   dq_y1[2 * m + 1], ctx, t, qcoeff + o * 16);
    eobs[o] = e > 1 ? e : 1;
  } else {
    const int64_t g =
        (int64_t)((int)blockIdx.x - y_blocks) * kThreads + threadIdx.x;
    if (g >= (int64_t)ni * 9) return;
    const int64_t m = g / 9;
    const int b = 16 + (int)(g - m * 9);
    const int32_t* em = e0 + m * 25;
    const int32_t* dq;
    int ctx = 0;
    if (b < 24) {   // U or V: a 2x2 grid per plane
      const int k = (b - 16) & 3;
      ctx = (k >= 2 ? em[b - 2] > 0 : 0) + ((k & 1) ? em[b - 1] > 0 : 0);
      dq = dq_uv + 2 * m;
      t.rm = __fmul_rn(rdm, 2.0f);
    } else {        // Y2
      t.tcb = s_tcb[1];
      dq = dq_y2 + 2 * m;
      t.rm = __fmul_rn(rdm, 16.0f);
    }
    const int64_t o = m * 25 + b;
    eobs[o] = trellis_block<0>(coefs + o * 16, q0 + o * 16, dq[0], dq[1], ctx,
                               t, qcoeff + o * 16);
  }
}

}  // namespace

// coefs, q0 [ni,25,16] and e0 [ni,25] int32 as models/wavefront.py:
// transform_quant returns them; dq_y1, dq_y2, dq_uv [ni,2] int32 (dc, ac);
// tcb0/1/2 the banded token costs of block types 0 (Y with Y2), 1 (Y2), 2
// (UV), [16,3,12] int32; tok, val the value tables (ops/rd_device.py:
// _value_tables), [2115] int32; rdmult, rddiv float32 scalars on the card;
// every pointer 16-byte aligned. Writes qcoeff [ni,25,16] and eobs [ni,25]
// int32. ni > 0. One launch on `stream`; returns cudaGetLastError().
extern "C" int trellis(const void* coefs, const void* q0, const void* e0,
                       const void* dq_y1, const void* dq_y2,
                       const void* dq_uv, const void* tcb0, const void* tcb1,
                       const void* tcb2, const void* tok, const void* val,
                       const void* rdmult, const void* rddiv, int ni,
                       void* qcoeff, void* eobs, void* stream) {
  const int y_blocks = (ni * 16 + kThreads - 1) / kThreads;
  const int o_blocks = (ni * 9 + kThreads - 1) / kThreads;
  trellis_kernel<<<y_blocks + o_blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coefs), static_cast<const int32_t*>(q0),
      static_cast<const int32_t*>(e0), static_cast<const int32_t*>(dq_y1),
      static_cast<const int32_t*>(dq_y2), static_cast<const int32_t*>(dq_uv),
      static_cast<const int32_t*>(tcb0), static_cast<const int32_t*>(tcb1),
      static_cast<const int32_t*>(tcb2), static_cast<const int32_t*>(tok),
      static_cast<const int32_t*>(val), static_cast<const float*>(rdmult),
      static_cast<const float*>(rddiv), ni, y_blocks,
      static_cast<int32_t*>(qcoeff), static_cast<int32_t*>(eobs));
  return static_cast<int>(cudaGetLastError());
}
