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
// Design. A thread per 4x4 block, 32 blocks per warp tile: the Y blocks
// make tiles [0, yt) (blocks g = 32t + lane, MB g >> 4, block g & 15, the
// i0 = 1 instantiation), UV and Y2 the rest (g = 32(t - yt) + lane, MB
// g / 9, block 16 + g % 9, i0 = 0), so no warp runs both. The grid is
// persistent: at most as many 128-thread blocks as the card holds at once,
// each warp taking tiles t = warp, warp + warps, ... So the tables (the
// three token-cost tables as int16, the value tables as int8 token ids and
// int16 extra-bit costs, cat6 by its low 11 bits as
// ops/rd_device.py:_value_index; 9.8 KB) are staged once per resident
// block. A warp loads its tile's coefficients and levels cooperatively, a
// lane per 16 bytes (the blocks of two to five MBs, in memory order), into a
// shared-memory tile of 80-byte rows (conflict-free 16-byte reads of a
// lane's own row); each lane then reads its own block from there, and its
// levels go back through the same rows. The per-position chain stays in
// registers over compile-time positions: the rates, errors and tokens of
// the two candidates, and three 16-bit masks (each candidate's predecessor
// choice, and where candidate 1 steps toward zero). Positions at or past
// the eob change nothing and are skipped. The forward walk visits every
// non-zero position (the chain links exactly those, in order), so it needs
// no stored links.
//
// Arithmetic. Rates are int32: a step adds at most a value cost and a token
// cost (each < 2^15 in the encoder's tables, so int16 holds them) to a
// rate, so 16 steps stay below 2^20, under 2^24 where the float conversion
// inside rdc is exact. Errors are int64, as in the plain version:
// (level*dq - coef)^2 passes 2^31 for large levels. rdc follows
// rdcost.cuh, which keeps nvcc from contracting a*b+c into an FMA.
//
// What bounds it on the card. Per MB it reads 3.3 KB (coefficients,
// levels, eobs, dequantizers) and writes 1.7 KB: ~11 MB on a 1080p inter
// frame with 2.25 k inter MBs, ~3.4 us at 3.35 TB/s; its ~16 steps x ~60
// operations per block are ~1 us at 67e12/s. On an H100 80GB HBM3 at
// 700 W the kernel takes 15-22 us on default 1080p inter frames
// (tools/profile_k4_k6.py, queued behind other work): clock64 stamps in a
// scratch build put ~60% of a warp's time in its backward chain, and the
// SASS shows ~190 instructions per position with ~3 warps to a scheduler,
// so it is bound by issuing them. Launched from an idle card, the host's
// launch path adds ~16-20 us. tests/test_torch_trellis_k6.py emulates the
// tile map and one thread's loop in numpy against the plain version.
#include <cstdint>
#include <cuda_runtime.h>

#include "rdcost.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRow = 20;              // ints per block row of a tile
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

__device__ __forceinline__ void load_row(const int* p, int (&v)[16]) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 w = q[k];
    v[4 * k] = w.x;
    v[4 * k + 1] = w.y;
    v[4 * k + 2] = w.z;
    v[4 * k + 3] = w.w;
  }
}

__device__ __forceinline__ void store_row(int* p, const int (&v)[16]) {
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
  const int16_t* tcb;  // this block's plane, [16][3][12]
  const int8_t* tok;   // token id of a value index
  const int16_t* val;  // extra-bit + sign cost of a value index
  float rm;            // rdmult * plane factor
  double rddiv;
};

__device__ __forceinline__ float cost(const Tables& t, int rate,
                                      long long err) {
  return rdcost(rdfloor((float)rate, t.rm), t.rddiv, (double)err);
}

// One block: coefficients cr and levels qr (raster), dequantizers, entropy
// context; replaces qr with the chosen levels (raster) and returns their
// eob.
template <int I0>
__device__ __forceinline__ int trellis_block(const int (&cr)[16],
                                             int (&qr)[16], int dq_dc,
                                             int dq_ac, int ctx,
                                             const Tables& t) {
  int qz[16], cz[16];
  to_scan(qr, qz);
  to_scan(cr, cz);
  int eob = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) eob = qz[i] != 0 ? i + 1 : eob;

  // backward Viterbi: candidate c = 0 keeps the level, c = 1 steps it
  // toward zero where `shortcut` holds (bit i of sc)
  int rate0 = 0, rate1 = 0, tok0 = kEob, tok1 = kEob, next = eob;
  long long err0 = 0, err1 = 0;
  unsigned bb0 = 0, bb1 = 0, sc = 0;
#pragma unroll
  for (int i = 15; i >= I0; --i) {
    if (i >= eob) continue;   // changes nothing
    const int16_t* tn = t.tcb + (i < 15 ? i + 1 : 15) * 36;
    const int x = qz[i];
    if (x == 0) {
      // a zero inside the eob: fold the ZERO token
      if (tok0 != kEob) {
        rate0 += tn[tok0];
        tok0 = 0;
      }
      if (tok1 != kEob) {
        rate1 += tn[tok1];
        tok1 = 0;
      }
      continue;
    }
    const int drc = i == 0 ? dq_dc : dq_ac;
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
    rate1 = t.val[vi1] + (best1 ? r11 : r10);
    err1 = dx1 * dx1 + (best1 ? err1 : err0);
    tok1 = best1 ? tb1 : tb0;
    rate0 = nrate0;
    err0 = nerr0;
    tok0 = t.tok[vi0];
    next = i;
    bb0 |= (unsigned)best0 << i;
    bb1 |= (unsigned)best1 << i;
    sc |= (unsigned)shortcut << i;
  }

  // base transition at i0 under the true entropy context
  const int16_t* tb = t.tcb + I0 * 36 + ctx * 12;
  bool br = cost(t, rate1 + tb[tok1], err1) < cost(t, rate0 + tb[tok0], err0);

  // forward walk down the chosen chain: it visits every non-zero position
  // from i0 on, taking candidate 1's level where the chain is on it
  int out[16];
#pragma unroll
  for (int i = 0; i < I0; ++i) out[i] = qz[i];
#pragma unroll
  for (int i = I0; i < 16; ++i) {
    const int x = qz[i];
    const bool hit = x != 0;
    const bool step = br && ((sc >> i) & 1u);
    out[i] = step ? x - ((x > 0) - (x < 0)) : x;
    br = hit ? (((br ? bb1 : bb0) >> i) & 1u) != 0 : br;
  }
  int eob_out = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) eob_out = out[i] != 0 ? i + 1 : eob_out;
  to_raster(out, qr);
  return eob_out;
}

// The tile's blocks: tile-local block j (0..31) is block g = g0 + j of its
// set, which lies at MB m, block b.
__device__ __forceinline__ void block_of(bool luma, int64_t g, int64_t& m,
                                         int& b) {
  if (luma) {
    m = g >> 4;
    b = (int)(g & 15);
  } else {
    m = g / 9;
    b = 16 + (int)(g - m * 9);
  }
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
                   const int8_t* __restrict__ tok,
                   const int16_t* __restrict__ val,
                   const float* __restrict__ rdmult,
                   const float* __restrict__ rddiv, int ni, int y_tiles,
                   int tiles, int32_t* __restrict__ qcoeff,
                   int32_t* __restrict__ eobs) {
  __shared__ int16_t s_tcb[3][kTcb];   // tcb0 (Y), tcb1 (Y2), tcb2 (UV)
  __shared__ int8_t s_tok[kValues];
  __shared__ int16_t s_val[kValues];
  __shared__ __align__(16) int s_tile[kWarps][2][32 * kRow];
  for (int k = threadIdx.x; k < kTcb; k += kThreads) {
    s_tcb[0][k] = (int16_t)tcb0[k];
    s_tcb[1][k] = (int16_t)tcb1[k];
    s_tcb[2][k] = (int16_t)tcb2[k];
  }
  for (int k = threadIdx.x; k < kValues; k += kThreads) {
    s_tok[k] = tok[k];
    s_val[k] = val[k];
  }
  __syncthreads();
  const float rdm = *rdmult;
  const double rdd = (double)*rddiv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* tc = s_tile[warp][0];
  int* tq = s_tile[warp][1];
  const int stride = gridDim.x * kWarps;
  for (int t = blockIdx.x * kWarps + warp; t < tiles; t += stride) {
    const bool luma = t < y_tiles;   // uniform in the warp
    const int64_t g0 = (int64_t)(luma ? t : t - y_tiles) * 32;
    const int64_t nblk = (int64_t)ni * (luma ? 16 : 9);
    // the tile in: 32 blocks x 4 x 16 bytes per array, lane-consecutive
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = 32 * k + lane, j = idx >> 2, part = idx & 3;
      int64_t m;
      int b;
      block_of(luma, g0 + j, m, b);
      if (g0 + j < nblk) {
        const int64_t o = (m * 25 + b) * 16 + part * 4;
        *reinterpret_cast<int4*>(tc + j * kRow + part * 4) =
            __ldg(reinterpret_cast<const int4*>(coefs + o));
        *reinterpret_cast<int4*>(tq + j * kRow + part * 4) =
            __ldg(reinterpret_cast<const int4*>(q0 + o));
      }
    }
    __syncwarp();
    const int64_t g = g0 + lane;
    if (g < nblk) {
      int64_t m;
      int b;
      block_of(luma, g, m, b);
      const int32_t* em = e0 + m * 25;
      int cr[16], qr[16];
      load_row(tc + lane * kRow, cr);
      load_row(tq + lane * kRow, qr);
      Tables tb{s_tcb[0], s_tok, s_val, 0.0f, rdd};
      int e;
      if (luma) {
        const int ctx =
            (b >= 4 ? __ldg(em + b - 4) > 1 : 0) +
            ((b & 3) ? __ldg(em + b - 1) > 1 : 0);
        tb.rm = __fmul_rn(rdm, 4.0f);
        e = trellis_block<1>(cr, qr, __ldg(dq_y1 + 2 * m),
                             __ldg(dq_y1 + 2 * m + 1), ctx, tb);
        e = e > 1 ? e : 1;
      } else {
        const int32_t* dq;
        int ctx = 0;
        if (b < 24) {   // U or V: a 2x2 grid per plane
          const int k = (b - 16) & 3;
          ctx = (k >= 2 ? __ldg(em + b - 2) > 0 : 0) +
                ((k & 1) ? __ldg(em + b - 1) > 0 : 0);
          dq = dq_uv + 2 * m;
          tb.tcb = s_tcb[2];
          tb.rm = __fmul_rn(rdm, 2.0f);
        } else {        // Y2
          dq = dq_y2 + 2 * m;
          tb.tcb = s_tcb[1];
          tb.rm = __fmul_rn(rdm, 16.0f);
        }
        e = trellis_block<0>(cr, qr, __ldg(dq), __ldg(dq + 1), ctx, tb);
      }
      store_row(tq + lane * kRow, qr);
      eobs[m * 25 + b] = e;
    }
    // the tile out, as it came in
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = 32 * k + lane, j = idx >> 2, part = idx & 3;
      int64_t m;
      int b;
      block_of(luma, g0 + j, m, b);
      if (g0 + j < nblk)
        *reinterpret_cast<int4*>(qcoeff + (m * 25 + b) * 16 + part * 4) =
            *reinterpret_cast<const int4*>(tq + j * kRow + part * 4);
    }
  }
}

}  // namespace

// coefs, q0 [ni,25,16] and e0 [ni,25] int32 as models/wavefront.py:
// transform_quant returns them; dq_y1, dq_y2, dq_uv [ni,2] int32 (dc, ac);
// tcb0/1/2 the banded token costs of block types 0 (Y with Y2), 1 (Y2), 2
// (UV), [16,3,12] int32 (each below 2^15); tok [2115] int8 and val [2115]
// int16 the value tables (ops/rd_device.py:_k6_value_tables); rdmult,
// rddiv float32 scalars on the card; coefs, q0 and qcoeff 16-byte
// aligned. Writes qcoeff [ni,25,16] and eobs [ni,25] int32. ni > 0. One
// launch on `stream` on the current device; returns cudaGetLastError()
// (or the error of the device queries that size the grid).
extern "C" int trellis(const void* coefs, const void* q0, const void* e0,
                       const void* dq_y1, const void* dq_y2,
                       const void* dq_uv, const void* tcb0, const void* tcb1,
                       const void* tcb2, const void* tok, const void* val,
                       const void* rdmult, const void* rddiv, int ni,
                       void* qcoeff, void* eobs, void* stream) {
  // blocks the card holds at once, per device (the first call's queries)
  static int resident[64];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, trellis_kernel, kThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int y_tiles = (ni * 16 + 31) / 32;
  const int tiles = y_tiles + (ni * 9 + 31) / 32;
  const int need = (tiles + kWarps - 1) / kWarps;
  const int grid = need < resident[dev] ? need : resident[dev];
  trellis_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coefs), static_cast<const int32_t*>(q0),
      static_cast<const int32_t*>(e0), static_cast<const int32_t*>(dq_y1),
      static_cast<const int32_t*>(dq_y2), static_cast<const int32_t*>(dq_uv),
      static_cast<const int32_t*>(tcb0), static_cast<const int32_t*>(tcb1),
      static_cast<const int32_t*>(tcb2), static_cast<const int8_t*>(tok),
      static_cast<const int16_t*>(val), static_cast<const float*>(rdmult),
      static_cast<const float*>(rddiv), ni, y_tiles, tiles,
      static_cast<int32_t*>(qcoeff), static_cast<int32_t*>(eobs));
  return static_cast<int>(cudaGetLastError());
}
