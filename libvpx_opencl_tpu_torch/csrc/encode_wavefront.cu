// K5: the VP8 encode wavefront as one persistent row-lagged kernel (sm_90a).
//
// Replaces the JAX package's encode wavefront,
// libvpx_opencl_tpu/models/wavefront.py:encode_recon_blocks (an XLA
// lax.scan over the offset-2 diagonals with a lax.fori_loop of 16 B_PRED
// sub-block steps, one compiled device program per frame; no pallas_call).
// The port's plain version is models/wavefront.py:_encode_planes_plain.
//
// What it computes. The kernel works in place on the bordered raster uint8
// planes and on the frame's qcoeff [N,25,16], eobs [N,25] and bmodes [N,16]
// int32: the caller has already written every inter MB (its levels and its
// reconstruction) there, and the kernel encodes the intra MBs, reading true
// reconstructed neighbours:
//   * 16x16 luma and 8x8 chroma DC/V/H/TM prediction with K1's frame-edge
//     rules (intra_pred.cuh; `top_interior` as in intra_wavefront.cu);
//   * fdct4x4 of the 16 Y and 8 chroma blocks, walsh4x4 of the Y DCs, the
//     regular quantizer (quantize.c: zbin dead zone with the zero-run
//     boost, the improved reciprocal with its int32 wrap-around, levels
//     clamped at 2047; Y blocks from zig-zag position 1), Y eobs at least 1;
//   * the decoder's reconstruction: the inverse WHT (or the DC-only path
//     when the Y2 eob is at most 1), every dequantized product wrapped to
//     int16, idct4x4, add, clip;
//   * B_PRED MBs: per 4x4 sub-block the ten sub-modes from its edge, the
//     one of least rdc(mode cost, SSE) (first on ties), fdct, quantization
//     from position 0, dequantization, idct, clip; no Y2 block.
//
// Dependencies and schedule. Blocks take MB rows in start order from a
// ticket counter (rowlag.cuh), mark the row's intra and B_PRED MBs in
// shared bitmasks, visit the intra MBs left to right and publish runs of
// inter MBs at once. A 16x16 MB (r,c) reads row r-1's columns c-1..c, so it
// waits until row r-1 has finished min(c+1, C) MBs; a B_PRED MB also reads
// the above-right MB's bottom row, so it waits for min(c+2, C). A run of k
// consecutive B_PRED MBs of a row is one 4-row sub-block wavefront:
// sub-block (ir, j), j = 4(c - c0) + ic, needs (ir, j-1), (ir-1, j) and,
// when ic < 3, (ir-1, j+1) (for ic = 3 the above-right pixels are row r-1's,
// VP8's rule), so it runs at step j + 2 ir: 4k + 6 steps where one MB after
// the other takes 10k. The row's progress counter counts whole finished
// MBs, so the row below sees no change in meaning. A broken schedule traps
// after 10 s. tests/test_torch_encode_rowlag.py checks the per-MB lag rule
// and the sub-block order with the plain per-MB step.
//
// Design. 512 worker threads and a publisher warp per block. A 4x4 block
// lives in 16 lanes, one coefficient per lane in raster order; the
// transforms exchange rows and columns by warp shuffles, and the quantizer
// runs its sequential zero-run carry as a 16-step scalar chain in every
// lane over one threshold per position (the count of zero-run lengths at
// which the coefficient passes the dead zone: the boost grows with the
// run, so those lengths are a prefix). Its constants (zbin, rnd, the
// reciprocal and its shift, the 16 boost thresholds of the Y1, Y2 and UV
// factors) are made once per MB by 72 threads before the MB's wait, from
// parameters loaded while the MB before runs, and kept in shared memory
// with the MB's source pixels in one of four slots. A 16x16 MB: warps 0-7
// hold the 16 Y blocks, warps 8-11 the 8 chroma blocks, the first half of
// warp 12 the Y2 block, warps 13-15 (the edge warps) load the neighbours'
// pixels and the DC sums after the wait. A B_PRED run: warp ir runs the
// sub-blocks of row ir, its two halves predicting five sub-modes each for
// the same 16 pixels; the run's reconstructed luma lives in a 64-column
// ring workspace in shared memory whose row 0 holds row r-1's pixels; warps
// 8-11 encode each MB's chroma in its first step, and one step ahead the
// edge warps wait for the next MB's row r-1 pixels and load them.
//
// Arithmetic that must match the plain version exactly:
//   * rdc = float(double(floor((128 + r*rdmult)/256)) + double(rddiv)*sse):
//     rdcost.cuh's rdfloor and rdcost (explicit round-to-nearest
//     intrinsics, no FMA contraction; the double sum rounded to float
//     once);
//   * the reciprocal product xq*quant wraps in int32 in the plain version:
//     it is taken as an unsigned 32-bit product and cast back before the
//     arithmetic shift;
//   * ties in the sub-mode pick keep the first mode (strict <).
//
// What bounds it on the card. A 1080p frame moves ~33 MB (int32 sources
// 12.5 MB in, qcoeff 13.1 MB out, planes, eobs, bmodes): ~10 us at 3.35
// TB/s. The real bound is the chain of dependent steps: (R-1)+C = 187 MB
// steps on an all-16x16 1080p keyframe, each a wait, the neighbours' loads,
// a transform, a quantizer chain and an inverse transform long; a B_PRED
// run adds 4 sub-block steps per MB.
#include <cstdint>
#include <cuda_runtime.h>

#include "intra_pred.cuh"
#include "rdcost.cuh"
#include "rowlag.cuh"

namespace {

constexpr int kMaxBlocks = 1024;
constexpr int kMaxCols = 1024;
constexpr int kWorkers = 512;
constexpr int kThreads = kWorkers + 32;
// params row: mode, uv_mode, intra, qidx, dq_y1 (dc, ac), dq_y2, dq_uv
constexpr int kCols = 10;
// thread roles
constexpr int kChroma0 = 256;  // 128 chroma threads (U blocks, then V)
constexpr int kY2 = 384;       // 16 Y2 threads
constexpr int kEdge0 = 416;    // the 3 edge warps
constexpr int kQc0 = 440;      // 72 threads (edge warps): quantizer constants
constexpr int kLuma = 128;     // a B_PRED run's 4 luma warps
// shared memory
constexpr int kSlots = 4;  // MBs in flight (a B_PRED run overlaps 3)
constexpr int kRing = 64;  // pixel columns of the B_PRED run workspace
constexpr int kEdgeBar = 4;  // named barrier of the edge warps

__constant__ int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                9, 12, 13, 10, 7, 11, 14, 15};
__constant__ int kInvZigzag[16] = {0, 1, 5, 6, 2, 4, 7, 12,
                                   3, 8, 11, 13, 9, 10, 14, 15};
__constant__ int kZbinBoost[16] = {0, 0, 8, 10, 12, 14, 16, 20,
                                   24, 28, 32, 36, 40, 44, 44, 44};

// Wrap to int16 (a C short store).
__device__ __forceinline__ int s16(int v) {
  return (int)(((unsigned)v + 32768u) & 0xFFFFu) - 32768;
}

// Value of lane k of this thread's 16-lane group.
__device__ __forceinline__ int from_lane(unsigned mask, int v, int k) {
  return __shfl_sync(mask, v, (threadIdx.x & 16) | k);
}

// vp8_short_fdct4x4_c over a block held one raster element per lane
// (lane l: element (l >> 2, l & 3)); returns coefficient l.
__device__ __forceinline__ int fdct_lane(unsigned mask, int x, int l) {
  const int i = l >> 2, j = l & 3;
  int a1, b1, c1, d1;
  {  // row pass: lane (i, j) makes tmp[i][j]
    const int x0 = from_lane(mask, x, 4 * i);
    const int x1 = from_lane(mask, x, 4 * i + 1);
    const int x2 = from_lane(mask, x, 4 * i + 2);
    const int x3 = from_lane(mask, x, 4 * i + 3);
    a1 = (x0 + x3) * 8;
    b1 = (x1 + x2) * 8;
    c1 = (x1 - x2) * 8;
    d1 = (x0 - x3) * 8;
  }
  const int tmp = j == 0 ? a1 + b1
                : j == 1 ? (c1 * 2217 + d1 * 5352 + 14500) >> 12
                : j == 2 ? a1 - b1
                         : (d1 * 2217 - c1 * 5352 + 7500) >> 12;
  // column pass: lane (k, j) makes out[k][j] from tmp[0..3][j]
  const int t0 = from_lane(mask, tmp, j), t1 = from_lane(mask, tmp, 4 + j);
  const int t2 = from_lane(mask, tmp, 8 + j), t3 = from_lane(mask, tmp, 12 + j);
  a1 = t0 + t3;
  b1 = t1 + t2;
  c1 = t1 - t2;
  d1 = t0 - t3;
  return i == 0 ? (a1 + b1 + 7) >> 4
       : i == 1 ? ((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0)
       : i == 2 ? (a1 - b1 + 7) >> 4
                : (d1 * 2217 - c1 * 5352 + 51000) >> 16;
}

// vp8_short_walsh4x4_c over the 16 Y DCs, one per lane in block raster
// order; returns Y2 coefficient l.
__device__ __forceinline__ int walsh_lane(unsigned mask, int x, int l) {
  const int i = l >> 2, j = l & 3;
  int a1, b1, c1, d1;
  {
    const int x0 = from_lane(mask, x, 4 * i);
    const int x1 = from_lane(mask, x, 4 * i + 1);
    const int x2 = from_lane(mask, x, 4 * i + 2);
    const int x3 = from_lane(mask, x, 4 * i + 3);
    a1 = (x0 + x2) * 4;
    d1 = (x1 + x3) * 4;
    c1 = (x1 - x3) * 4;
    b1 = (x0 - x2) * 4;
  }
  const int tmp = j == 0 ? a1 + d1 + (a1 != 0)
                : j == 1 ? b1 + c1
                : j == 2 ? b1 - c1
                         : a1 - d1;
  const int t0 = from_lane(mask, tmp, j), t1 = from_lane(mask, tmp, 4 + j);
  const int t2 = from_lane(mask, tmp, 8 + j), t3 = from_lane(mask, tmp, 12 + j);
  a1 = t0 + t2;
  d1 = t1 + t3;
  c1 = t1 - t3;
  b1 = t0 - t2;
  const int o = i == 0 ? a1 + d1
              : i == 1 ? b1 + c1
              : i == 2 ? b1 - c1
                       : a1 - d1;
  return (o + (o < 0) + 3) >> 3;
}

// The butterfly of vp8_short_idct4x4llm_c.
__device__ __forceinline__ void idct_butterfly(int i0, int i1, int i2, int i3,
                                               int& a1, int& b1, int& c1,
                                               int& d1) {
  a1 = i0 + i2;
  b1 = i0 - i2;
  c1 = ((i1 * 35468) >> 16) - (i3 + ((i3 * 20091) >> 16));
  d1 = (i1 + ((i1 * 20091) >> 16)) + ((i3 * 35468) >> 16);
}

// vp8_short_idct4x4llm_c over dequantized coefficients, one per lane;
// returns residual pixel l.
__device__ __forceinline__ int idct_lane(unsigned mask, int x, int l) {
  const int k = l >> 2, m = l & 3;
  int a1, b1, c1, d1;
  // vertical pass: lane (k, m) makes tmp[k][m] from column m
  idct_butterfly(from_lane(mask, x, m), from_lane(mask, x, 4 + m),
                 from_lane(mask, x, 8 + m), from_lane(mask, x, 12 + m), a1,
                 b1, c1, d1);
  const int tmp = s16(k == 0 ? a1 + d1 : k == 1 ? b1 + c1
                      : k == 2 ? b1 - c1 : a1 - d1);
  // horizontal pass: lane (k, m) makes out[k][m] from row k of tmp
  idct_butterfly(from_lane(mask, tmp, 4 * k), from_lane(mask, tmp, 4 * k + 1),
                 from_lane(mask, tmp, 4 * k + 2),
                 from_lane(mask, tmp, 4 * k + 3), a1, b1, c1, d1);
  return s16(((m == 0 ? a1 + d1 : m == 1 ? b1 + c1 : m == 2 ? b1 - c1
               : a1 - d1) + 4) >> 3);
}

// vp8_short_inv_walsh4x4_c over the dequantized Y2 block, one per lane;
// returns the DC of Y block l.
__device__ __forceinline__ int iwalsh_lane(unsigned mask, int x, int l) {
  const int k = l >> 2, m = l & 3;
  int i0 = from_lane(mask, x, m), i1 = from_lane(mask, x, 4 + m);
  int i2 = from_lane(mask, x, 8 + m), i3 = from_lane(mask, x, 12 + m);
  int a1 = i0 + i3, b1 = i1 + i2, c1 = i1 - i2, d1 = i0 - i3;
  const int tmp = s16(k == 0 ? a1 + b1 : k == 1 ? c1 + d1
                      : k == 2 ? a1 - b1 : d1 - c1);
  i0 = from_lane(mask, tmp, 4 * k);
  i1 = from_lane(mask, tmp, 4 * k + 1);
  i2 = from_lane(mask, tmp, 4 * k + 2);
  i3 = from_lane(mask, tmp, 4 * k + 3);
  a1 = i0 + i3;
  b1 = i1 + i2;
  c1 = i1 - i2;
  d1 = i0 - i3;
  return s16(((m == 0 ? a1 + b1 : m == 1 ? c1 + d1 : m == 2 ? a1 - b1
               : d1 - c1) + 3) >> 3);
}

// The regular quantizer's constants for one block type (Y1, Y2 or UV):
// zbin, rnd, the reciprocal `quant` and its `shift` of its DC (index 0)
// and AC (1) factors, and the zero-run boost thresholds
// (dq_ac * kZbinBoost[z]) >> 7. 24 ints, made by `qconst`.
struct QConst {
  int zbin[2], rnd[2], quant[2], shift[2], boost[16];
};
constexpr int kQcInts = 24;

// Int k of a QConst from the factor it derives from (the DC factor for
// k = 0, 2, 4, 6, the AC factor otherwise) and the MB's qindex.
__device__ __forceinline__ int qconst(int k, int dq, int qidx) {
  if (k < 2) return ((qidx < 48 ? 84 : 80) * dq + 64) >> 7;
  if (k < 4) return (48 * dq) >> 7;
  if (k >= 8) return (dq * kZbinBoost[k - 8]) >> 7;
  int shift = 0;
#pragma unroll
  for (int b = 1; b < 10; ++b) shift += dq >= (1 << b);
  return k < 6 ? 1 + ((1 << 16) << shift) / dq - (1 << 16) : shift;
}

struct Quant {
  int level;  // this lane's level
  int eob;    // the block's eob (the same in every lane of the group)
};

// vp8_regular_quantize_b_c over a block held one raster coefficient per
// lane (lane l, zig-zag position `scan`), with the block type's constants
// q; first0: skip zig-zag position 0 (a Y block with a Y2 block).
__device__ __forceinline__ Quant quantize(unsigned mask, int coef, int l,
                                          int scan, const QConst& q,
                                          bool first0) {
  const int d = l == 0 ? 0 : 1;
  const int x = coef < 0 ? -coef : coef;
  const int xq = x + q.rnd[d];
  // the int32 product wraps as in the plain version
  const int prod = (int)((unsigned)xq * (unsigned)q.quant[d]);
  int cand = ((prod >> 16) + xq) >> q.shift[d];
  cand = cand > 2047 ? 2047 : cand;
  // zero-run lengths 0..15 at which the coefficient passes the dead zone:
  // the boost grows with the run, so they are 0..cnt-1
  const int slack = x - q.zbin[d];
  int cnt = 0;
#pragma unroll
  for (int z = 0; z < 16; ++z) cnt += slack >= q.boost[z];
  const bool skip = first0 && scan == 0;
  // position i keeps a non-zero level iff its run is below thr
  const int thr = cand > 0 && !skip ? cnt : 0;
  int zrun = 0, eob = 0, mine = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int ti = from_lane(mask, thr, kZigzag[i]);
    const int z = zrun < 15 ? zrun : 15;
    if (i == scan) mine = z;
    const bool nz = z < ti;
    eob = nz ? i + 1 : eob;
    zrun = nz ? 0 : zrun + 1;
  }
  const int y = mine < cnt && !skip ? cand : 0;
  return {coef < 0 ? -y : y, eob};
}

// What a block loads for one MB before it may run it; nothing here depends
// on another row, so the block loads it for the next intra MB while it
// runs the current one.
struct MbInputs {
  int param;  // params column t (threads 0-9)
  int src;    // the source pixel of this thread's lane (threads 0-383)
  int dq;     // threads kQc0..: the factor of this thread's constant
  int qidx;   // and the MB's qindex
};

// Pixel (py, px) of lane l of Y block b, and of chroma block blk.
__device__ __forceinline__ int y_row(int b, int l) {
  return 4 * (b >> 2) + (l >> 2);
}
__device__ __forceinline__ int y_col(int b, int l) {
  return 4 * (b & 3) + (l & 3);
}
__device__ __forceinline__ int c_row(int blk, int l) {
  return 4 * (blk >> 1) + (l >> 2);
}
__device__ __forceinline__ int c_col(int blk, int l) {
  return 4 * (blk & 1) + (l & 3);
}

__device__ __forceinline__ MbInputs load_inputs(
    const int32_t* __restrict__ sy, const int32_t* __restrict__ su,
    const int32_t* __restrict__ sv, const int32_t* __restrict__ params,
    int n) {
  const int t = threadIdx.x, l = t & 15;
  const int32_t* p = params + (int64_t)n * kCols;
  MbInputs in;
  in.param = t < kCols ? p[t] : 0;
  in.src = 0;
  in.dq = in.qidx = 0;
  if (t < kChroma0) {
    const int b = t >> 4;
    in.src = sy[(int64_t)n * 256 + y_row(b, l) * 16 + y_col(b, l)];
  } else if (t < kY2) {
    const int c = t - kChroma0, blk = (c >> 4) & 3;
    in.src = ((c >> 6) ? sv : su)[(int64_t)n * 64 + c_row(blk, l) * 8 +
                                  c_col(blk, l)];
  } else if (t >= kQc0 && t < kWorkers) {
    // type (Y1, Y2, UV) and int k of the QConst this thread makes
    const int type = (t - kQc0) / kQcInts, k = (t - kQc0) % kQcInts;
    in.dq = p[4 + 2 * type + (k < 8 && (k & 1) == 0 ? 0 : 1)];
    in.qidx = p[3];
  }
  return in;
}

// One intra MB in flight: its parameters, source luma (B_PRED reads it by
// sub-block), quantizer constants and neighbour pixels.
struct Slot {
  int p[kCols];
  int src_y[256];
  QConst q[3];  // Y1, Y2, UV
  int above[16], left[16], tl, ydc;  // a 16x16 MB's luma neighbours
  int c_above[2][8], c_left[2][8], c_tl[2], c_dc[2];
};

struct Smem {
  Slot slot[kSlots];
  int y_dc[16];     // the Y blocks' DC coefficients (the Y2 input)
  int y_dcrec[16];  // their reconstruction from the Y2 block
  // a B_PRED run's luma: row 0 row r-1's pixels, row 1 + y pixel row y;
  // pixel column x of the MB row in column (x + 1) % kRing
  int W[17][kRing];
  int edge[4][16];  // E[0..12] of the sub-block of each luma warp
  unsigned char bcode[8][16];  // intra_pred.cuh's kBCode
};

// Stage MB `in` into a slot: every worker writes what it prefetched, the
// 72 quantizer threads make the constants.
__device__ __forceinline__ void stage(Slot& sl, const MbInputs& in) {
  const int t = threadIdx.x, l = t & 15;
  if (t < kCols) sl.p[t] = in.param;
  if (t < kChroma0)
    sl.src_y[y_row(t >> 4, l) * 16 + y_col(t >> 4, l)] = in.src;
  if (t >= kQc0 && t < kWorkers) {
    const int k = (t - kQc0) % kQcInts;
    reinterpret_cast<int*>(sl.q)[t - kQc0] = qconst(k, in.dq, in.qidx);
  }
}

// The edge warps, once MB (r,c)'s neighbours are final: a 16x16 MB's luma
// above, left, top-left and DC into its slot; for a B_PRED MB its
// top-left, above and above-right pixels into the run workspace's row 0
// and, at a run's first MB, its left column; chroma as for a 16x16 MB.
__device__ __forceinline__ void load_edges(Smem& s, Slot& sl, const uint8_t* Y,
                                           int ys, const uint8_t* u,
                                           const uint8_t* v, int cs, int r,
                                           int c, int C, bool up, bool bpred,
                                           bool run_start) {
  const int t = threadIdx.x;
  const bool lf = c > 0;
  const int w = (t - kEdge0) >> 5, k = t & 31;
  if (w == 0) {
    if (!bpred) {  // luma above (lanes 0-15), left (16-31), DC
      const int val = k < 16 ? (up ? Y[-ys + k] : 127)
                             : (lf ? Y[(k - 16) * ys - 1] : 129);
      (k < 16 ? sl.above[k] : sl.left[k - 16]) = val;
      int sum = val;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const int sl_sum = __shfl_sync(0xffffffffu, sum, 16);
      if (k == 0) sl.ydc = dc_value(sum, sl_sum, up, lf, 4);
    } else if (k < 21 && (run_start || k >= 5)) {
      // pixel x = 16c - 1 + k of row r-1; inside a run, k <= 4 is there
      // already: the MB before's above-right
      const int val = !up ? 127
                    : k == 0 ? (lf ? Y[-ys - 1] : 129)
                    : k <= 16 || c < C - 1 ? Y[-ys + k - 1]
                              : Y[-ys + 15];  // last column: pixel 15
      s.W[0][(16 * c + k) & (kRing - 1)] = val;
    }
  } else if (w == 1) {  // chroma: U above, U left, V above, V left
    const int pl = k >> 4, e = k & 7;
    const bool is_left = k & 8;
    const uint8_t* P = (pl ? v : u) + (int64_t)(r * 8) * cs + c * 8;
    const int val = !is_left ? (up ? P[-cs + e] : 127)
                             : (lf ? P[e * cs - 1] : 129);
    (is_left ? sl.c_left[pl][e] : sl.c_above[pl][e]) = val;
    int sum = val;
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int sl_sum = __shfl_sync(0xffffffffu, sum, (k & 16) | 8);
    if ((k & 15) == 0) sl.c_dc[pl] = dc_value(sum, sl_sum, up, lf, 3);
  } else {  // corners; a run's left column
    if (k == 0) {
      if (!bpred) sl.tl = !up ? 127 : (!lf ? 129 : Y[-ys - 1]);
    } else if (k == 5 || k == 6) {
      const uint8_t* P = (k == 6 ? v : u) + (int64_t)(r * 8) * cs + c * 8;
      sl.c_tl[k - 5] = !up ? 127 : (!lf ? 129 : P[-cs - 1]);
    } else if (k >= 16 && bpred && run_start) {
      s.W[1 + k - 16][(16 * c) & (kRing - 1)] =
          lf ? Y[(k - 16) * ys - 1] : 129;
    }
  }
}

// The 8 chroma blocks of MB n (threads kChroma0..kY2-1): prediction,
// transform, quantizer, reconstruction into the planes.
__device__ __forceinline__ void chroma_mb(const Slot& sl, const MbInputs& in,
                                          uint8_t* u, uint8_t* v, int cs,
                                          int r, int c, int32_t* q_mb,
                                          int32_t* e_mb, int scan) {
  const int t = threadIdx.x, l = t & 15;
  const int ch = t - kChroma0, pl = ch >> 6, blk = (ch >> 4) & 3;
  const int py = c_row(blk, l), px = c_col(blk, l);
  const int pred = pred_mb_pixel(sl.p[1], sl.c_above[pl], sl.c_left[pl],
                                 sl.c_tl[pl], sl.c_dc[pl], py, px);
  const int coef = fdct_lane(0xffffffffu, in.src - pred, l);
  const Quant qt = quantize(0xffffffffu, coef, l, scan, sl.q[2], false);
  const int b = 16 + (ch >> 4);
  q_mb[b * 16 + l] = qt.level;
  if (l == 0) e_mb[b] = qt.eob;
  const int res = idct_lane(
      0xffffffffu, s16(qt.level * (l == 0 ? sl.p[8] : sl.p[9])), l);
  uint8_t* P = (pl ? v : u) + (int64_t)(r * 8) * cs + c * 8;
  P[py * cs + px] = (uint8_t)clamp255(pred + res);
}

// Frame pointers and sizes every MB reads.
struct Frame {
  uint8_t *y, *u, *v;
  int ys, cs, C;
  bool top;
  int32_t *qcoeff, *eobs, *bmodes;
  const float* fl;       // floor((128 + cost*rdmult)/256) per sub-mode
  const double* rddiv;   // in shared memory, like fl
  const int* sync;
};

// A 16x16 intra MB (r,c), staged in `sl`; every worker calls it.
__device__ __forceinline__ void encode_mb16(Smem& s, Slot& sl, const Frame& f,
                                            const MbInputs& in, int r, int c,
                                            int& seen, int scan) {
  const int t = threadIdx.x, l = t & 15;
  const int n = r * f.C + c;
  // the left column is this block's own earlier work; the rest is row
  // r-1's (or the top border's): loaded after the wait
  if (r > 0)
    rowlag::wait_above(f.sync, r, c + 1 < f.C ? c + 1 : f.C, seen, kWorkers);
  else
    rowlag::bar_sync(1, kWorkers);
  const bool up = r > 0 || f.top;
  uint8_t* Y = f.y + (int64_t)(r * 16) * f.ys + c * 16;
  if (t >= kEdge0)
    load_edges(s, sl, Y, f.ys, f.u, f.v, f.cs, r, c, f.C, up, false, false);
  rowlag::bar_sync(1, kWorkers);

  int32_t* q_mb = f.qcoeff + (int64_t)n * 400;
  int32_t* e_mb = f.eobs + (int64_t)n * 25;
  int ypred = 0, ylevel = 0;
  if (t < kChroma0) {  // Y block t >> 4
    const int b = t >> 4, py = y_row(b, l), px = y_col(b, l);
    ypred = pred_mb_pixel(sl.p[0], sl.above, sl.left, sl.tl, sl.ydc, py, px);
    const int coef = fdct_lane(0xffffffffu, in.src - ypred, l);
    if (l == 0) s.y_dc[b] = coef;
    const Quant qt = quantize(0xffffffffu, coef, l, scan, sl.q[0], true);
    ylevel = qt.level;
    q_mb[b * 16 + l] = qt.level;
    if (l == 0) e_mb[b] = qt.eob > 1 ? qt.eob : 1;
  } else if (t < kY2) {
    chroma_mb(sl, in, f.u, f.v, f.cs, r, c, q_mb, e_mb, scan);
  }
  rowlag::bar_sync(1, kWorkers);  // the Y DCs are in s.y_dc
  if (t >= kY2 && t < kY2 + 16) {
    const int dq_dc = sl.p[6], dq_ac = sl.p[7];
    const int coef = walsh_lane(0xffffu, s.y_dc[l], l);
    const Quant qt = quantize(0xffffu, coef, l, scan, sl.q[1], false);
    q_mb[24 * 16 + l] = qt.level;
    if (l == 0) e_mb[24] = qt.eob;
    const int full = iwalsh_lane(
        0xffffu, s16(qt.level * (l == 0 ? dq_dc : dq_ac)), l);
    const int q0 = __shfl_sync(0xffffu, qt.level, 0);
    s.y_dcrec[l] = qt.eob > 1 ? full : s16((s16(q0 * dq_dc) + 3) >> 3);
  }
  rowlag::bar_sync(1, kWorkers);  // the DCs' reconstruction is in s.y_dcrec
  if (t < kChroma0) {
    const int b = t >> 4;
    const int dq = l == 0 ? s.y_dcrec[b] : s16(ylevel * sl.p[5]);
    const int res = idct_lane(0xffffffffu, dq, l);
    Y[y_row(b, l) * f.ys + y_col(b, l)] = (uint8_t)clamp255(ypred + res);
  }
}

// Sub-block (ir, j) of a B_PRED run that starts at MB column c0, on warp
// ir: both halves predict the same 16 pixels, half h under sub-modes
// 5h..5h+4; the pick meets across the halves; the transform chain runs in
// both halves and half 0 stores.
__device__ __forceinline__ void bpred_subblock(Smem& s, const Slot& sl,
                                               const Frame& f, int r, int c0,
                                               int ir, int j, int scan) {
  const int t = threadIdx.x, lane = t & 31, l = t & 15, h = lane >> 4;
  const int i = l >> 2, jj = l & 3;
  const int ic = j & 3, c = c0 + (j >> 2);
  const int n = r * f.C + c;
  // E = L3 L2 L1 L0 tl A0..A7 (intra_pred.cuh); for ic = 3 the
  // above-right pixels A4..A7 are row r-1's (row 0), also below row 0
  const int x = 4 * (4 * c0 + j);  // the sub-block's first pixel column
  if (lane < 13) {
    const int row = lane < 4 ? 4 * ir + 4 - lane
                  : ic == 3 && lane >= 9 ? 0 : 4 * ir;
    const int col = lane < 4 ? x : x + lane - 4;
    s.edge[ir][lane] = s.W[row][col & (kRing - 1)];
  }
  __syncwarp();
  const int* edge = s.edge[ir];
  auto E = [&](int k) { return edge[k < 0 ? 0 : (k > 12 ? 12 : k)]; };
  const int src = sl.src_y[(4 * ir + i) * 16 + 4 * ic + jj];
  int sse[5];
#pragma unroll
  for (int mm = 0; mm < 5; ++mm) {
    const int m = 5 * h + mm;
    const int e =
        src - bpred_from_edge(m, m >= 2 ? s.bcode[m - 2][l] : 0, E, i, jj);
    sse[mm] = e * e;
  }
  // each half's sums, by one full-warp reduction per half and mode
#pragma unroll
  for (int mm = 0; mm < 5; ++mm) {
    const unsigned e = (unsigned)sse[mm];
    const unsigned s0 = __reduce_add_sync(0xffffffffu, h ? 0u : e);
    const unsigned s1 = __reduce_add_sync(0xffffffffu, h ? e : 0u);
    sse[mm] = (int)(h ? s1 : s0);
  }
  int best = 5 * h;
  float best_cost = rdcost(f.fl[5 * h], *f.rddiv, sse[0]);
#pragma unroll
  for (int mm = 1; mm < 5; ++mm) {
    const float cost = rdcost(f.fl[5 * h + mm], *f.rddiv, sse[mm]);
    if (cost < best_cost) {
      best_cost = cost;
      best = 5 * h + mm;
    }
  }
  // half 0 holds sub-modes 0-4: it wins ties (the first mode)
  const float other_cost = __shfl_xor_sync(0xffffffffu, best_cost, 16);
  const int other = __shfl_xor_sync(0xffffffffu, best, 16);
  const bool second = h ? best_cost < other_cost : other_cost < best_cost;
  best = second == (h == 1) ? best : other;
  const int p =
      bpred_from_edge(best, best >= 2 ? s.bcode[best - 2][l] : 0, E, i, jj);
  const int coef = fdct_lane(0xffffffffu, src - p, l);
  const Quant qt = quantize(0xffffffffu, coef, l, scan, sl.q[0], false);
  const int res = idct_lane(
      0xffffffffu, s16(qt.level * (l == 0 ? sl.p[4] : sl.p[5])), l);
  if (h == 0) {
    const int k = 4 * ir + ic, rec = clamp255(p + res);
    s.W[1 + 4 * ir + i][(x + jj + 1) & (kRing - 1)] = rec;
    f.y[(int64_t)(r * 16 + 4 * ir + i) * f.ys + x + jj] = (uint8_t)rec;
    f.qcoeff[(int64_t)n * 400 + k * 16 + l] = qt.level;
    if (l == 0) {
      f.eobs[(int64_t)n * 25 + k] = qt.eob;
      f.bmodes[(int64_t)n * 16 + k] = best;
    }
  }
}

// The first intra MB of the row at or after column c (C if none), from the
// row's bitmask in shared memory; the same value in every thread.
__device__ __forceinline__ int next_intra(const unsigned* mask, int c,
                                          int C) {
  for (; c < C; c = (c | 31) + 1) {
    const unsigned w = mask[c >> 5] >> (c & 31);
    if (w) return c + __ffs(w) - 1;
  }
  return C;
}

// A run of B_PRED MBs c0..e-1 of row r (every worker calls it). MB c0 is
// staged in slot `seq`, `next` holds the inputs of the next intra MB;
// the run's MB m is in slot seq + m. Sub-block (ir, j) runs at step
// j + 2 ir on warp ir; MB m's chroma runs at step 4m; at step 4m + 3 the
// workers stage MB m+1 and the edge warps wait for its row r-1 pixels
// and load them. MB m is done after step 4m + 9, and handed over then;
// the last one hands over `after` (the next intra MB's column, or C).
// Returns the slot index after the run.
__device__ __forceinline__ int encode_run(
    Smem& s, const Frame& f, const int32_t* __restrict__ sy,
    const int32_t* __restrict__ su, const int32_t* __restrict__ sv,
    const int32_t* __restrict__ params, const unsigned* mask, MbInputs& cur,
    MbInputs& next, int r, int c0, int e, int after, int seq, int& seen,
    int* pub, bool& pending, int scan) {
  const int t = threadIdx.x, l = t & 15;
  const int C = f.C, k = e - c0;
  const bool up = r > 0 || f.top;
  uint8_t* Yrow = f.y + (int64_t)(r * 16) * f.ys;
  if (r > 0)
    rowlag::wait_above(f.sync, r, c0 + 2 < C ? c0 + 2 : C, seen, kWorkers);
  else
    rowlag::bar_sync(1, kWorkers);
  if (t >= kEdge0)
    load_edges(s, s.slot[seq & (kSlots - 1)], Yrow + c0 * 16, f.ys, f.u, f.v,
               f.cs, r, c0, C, up, true, true);
  rowlag::bar_sync(1, kWorkers);
  for (int step = 0; step < 4 * k + 6; ++step) {
    const int m = step >> 2;  // the MB entering at this step
    if ((step & 3) == 3 && m + 1 < k) {  // stage MB m+1; prefetch the next
      cur = next;
      stage(s.slot[(seq + m + 1) & (kSlots - 1)], cur);
      const int nc = next_intra(mask, c0 + m + 2, C);
      if (nc < C) next = load_inputs(sy, su, sv, params, r * C + nc);
    }
    if (t < kLuma) {
      const int ir = t >> 5, j = step - 2 * ir;
      if (j >= 0 && j < 4 * k)
        bpred_subblock(s, s.slot[(seq + (j >> 2)) & (kSlots - 1)], f, r, c0,
                       ir, j, scan);
    } else if (t >= kChroma0 && t < kY2 + 16) {
      if ((step & 3) == 0 && m < k) {  // MB m's chroma; no Y2 block
        const int n = r * C + c0 + m;
        int32_t* q_mb = f.qcoeff + (int64_t)n * 400;
        int32_t* e_mb = f.eobs + (int64_t)n * 25;
        if (t < kY2) {
          chroma_mb(s.slot[(seq + m) & (kSlots - 1)], cur, f.u, f.v, f.cs,
                    r, c0 + m, q_mb, e_mb, scan);
        } else {
          q_mb[24 * 16 + l] = 0;
          if (l == 0) e_mb[24] = 0;
        }
      }
    } else if (t >= kEdge0 && (step & 3) == 3 && m + 1 < k) {
      // MB m+1's neighbours, for its first sub-block at the next step
      const int c = c0 + m + 1;
      if (r > 0 && t == kEdge0)
        rowlag::poll_above(f.sync, r, c + 2 < C ? c + 2 : C, seen);
      rowlag::bar_sync(kEdgeBar, kWorkers - kEdge0);
      load_edges(s, s.slot[(seq + m + 1) & (kSlots - 1)], Yrow + c * 16,
                 f.ys, f.u, f.v, f.cs, r, c, C, up, true, false);
    }
    // MB (step - 9) / 4 is done after this step
    const int done = (step - 9) >> 2;
    if (step >= 9 && ((step - 9) & 3) == 0)
      rowlag::hand_over(pub, done + 1 < k ? c0 + done + 1 : after, pending,
                        kWorkers);
    else
      rowlag::bar_sync(1, kWorkers);
  }
  return seq + k;
}

__global__ void __launch_bounds__(kThreads)
    encode_rowlag_kernel(uint8_t* y, int ys, uint8_t* u, uint8_t* v, int cs,
                         const int32_t* __restrict__ sy,
                         const int32_t* __restrict__ su,
                         const int32_t* __restrict__ sv,
                         const int32_t* __restrict__ params,
                         const int32_t* __restrict__ bmode_cost,
                         const float* __restrict__ rdmult,
                         const float* __restrict__ rddiv, int R, int C,
                         int top, int32_t* __restrict__ qcoeff,
                         int32_t* __restrict__ eobs,
                         int32_t* __restrict__ bmodes, int* sync) {
  __shared__ Smem s;
  __shared__ unsigned mask[kMaxCols / 32];   // intra MBs of the row
  __shared__ unsigned bmask[kMaxCols / 32];  // its B_PRED MBs
  __shared__ int slot;     // progress handed to the publisher warp
  __shared__ float fl[10];  // floor((128 + cost*rdmult)/256) per sub-mode
  __shared__ double rddiv_s;
  const int t = threadIdx.x;
  if (bmode_cost != nullptr) {  // read by the first take_row's barrier
    if (t < 10) fl[t] = rdfloor((float)bmode_cost[t], *rdmult);
    if (t == 10) rddiv_s = (double)*rddiv;
  }
  if (t < 128) s.bcode[t >> 4][t & 15] = kBCode[t >> 4][t & 15];
  const Frame f{y, u, v, ys, cs, C, top != 0, qcoeff, eobs, bmodes, fl,
                &rddiv_s, sync};
  const int scan = kInvZigzag[t & 15];  // zig-zag position of this lane
  for (;;) {
    const int r = rowlag::take_row(sync);
    if (r >= R) break;
    if (t >= kWorkers) {
      rowlag::publisher(sync, r, &slot, C, kWorkers);
      continue;
    }
    // which MBs of the row are intra, and B_PRED; inter MBs are final
    for (int k = t; k < kMaxCols / 32; k += kWorkers) mask[k] = bmask[k] = 0;
    rowlag::bar_sync(1, kWorkers);
    for (int c = t; c < C; c += kWorkers) {
      const int32_t* p = params + (int64_t)(r * C + c) * kCols;
      if (p[2] != 0) {
        atomicOr(&mask[c >> 5], 1u << (c & 31));
        if (p[0] == kBPred) atomicOr(&bmask[c >> 5], 1u << (c & 31));
      }
    }
    rowlag::bar_sync(1, kWorkers);
    int c = next_intra(mask, 0, C);
    bool pending = false;
    if (c > 0) rowlag::hand_over(&slot, c, pending, kWorkers);
    int seen = 0;  // the polling thread's last view of row r-1's progress
    int seq = 0;   // intra MBs staged in this row
    MbInputs cur, next;
    if (c < C) next = load_inputs(sy, su, sv, params, r * C + c);
    while (c < C) {
      cur = next;
      stage(s.slot[seq & (kSlots - 1)], cur);
      if (bmask[c >> 5] >> (c & 31) & 1) {
        // the run of consecutive B_PRED MBs from c
        int e = c + 1;
        while (e < C && (bmask[e >> 5] >> (e & 31) & 1)) ++e;
        const int nc = next_intra(mask, c + 1, C);
        if (nc < C) next = load_inputs(sy, su, sv, params, r * C + nc);
        const int after = next_intra(mask, e, C);
        seq = encode_run(s, f, sy, su, sv, params, mask, cur, next, r, c, e,
                         after, seq, seen, &slot, pending, scan);
        c = after;
      } else {
        const int nc = next_intra(mask, c + 1, C);
        if (nc < C) next = load_inputs(sy, su, sv, params, r * C + nc);
        encode_mb16(s, s.slot[seq & (kSlots - 1)], f, cur, r, c, seen, scan);
        // MB c is done, and the inter MBs up to nc
        rowlag::hand_over(&slot, nc, pending, kWorkers);
        c = nc;
        ++seq;
      }
    }
    rowlag::drain(pending, kWorkers);
  }
}

}  // namespace

// y/u/v point at pixel (0,0) of the MB grid inside bordered planes (row
// strides ys / cs bytes) that hold every inter MB's reconstruction (and,
// with top_interior, the row above in the top border); sy/su/sv are the
// [R*C,16,16] / [R*C,8,8] int32 source blocks; params is [R*C,10] int32
// (mode, uv_mode, intra, qidx, dq_y1, dq_y2, dq_uv); bmode_cost [10] int32
// and the float32 scalars rdmult, rddiv are read by B_PRED MBs only (NULL
// when the frame has none); qcoeff [R*C,25,16], eobs [R*C,25] and bmodes
// [R*C,16] int32 hold the inter MBs' levels and get the intra MBs'; sync
// is R+1 int32 zeros. One launch on `stream`; returns cudaGetLastError().
extern "C" int encode_wavefront(void* y, int ys, void* u, void* v, int cs,
                                const void* sy, const void* su,
                                const void* sv, const void* params,
                                const void* bmode_cost, const void* rdmult,
                                const void* rddiv, int R, int C,
                                int top_interior, void* qcoeff, void* eobs,
                                void* bmodes, void* sync, void* stream) {
  const int grid = R < kMaxBlocks ? R : kMaxBlocks;
  encode_rowlag_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(y), ys, static_cast<uint8_t*>(u),
      static_cast<uint8_t*>(v), cs, static_cast<const int32_t*>(sy),
      static_cast<const int32_t*>(su), static_cast<const int32_t*>(sv),
      static_cast<const int32_t*>(params),
      static_cast<const int32_t*>(bmode_cost),
      static_cast<const float*>(rdmult), static_cast<const float*>(rddiv), R,
      C, top_interior, static_cast<int32_t*>(qcoeff),
      static_cast<int32_t*>(eobs), static_cast<int32_t*>(bmodes),
      static_cast<int*>(sync));
  return static_cast<int>(cudaGetLastError());
}

