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
//   * B_PRED MBs: per 4x4 sub-block the ten sub-modes from the workspace
//     edge, the one of least rdc(mode cost, SSE) (first on ties), fdct,
//     quantization from position 0, dequantization, idct, clip; no Y2
//     block. The sub-blocks run in 10 diagonal steps (2*ir + ic): a pick
//     reads only the left, above and above-right sub-blocks.
//
// Dependencies and schedule: K1's (intra_wavefront.cu, rowlag.cuh). MB
// (r,c) reads rows r-1 (columns c-1..c+1) and its left neighbour, so it
// runs once row r-1 has finished min(c+2, C) MBs; blocks take MB rows in
// start order from a ticket counter, mark the row's intra MBs in a shared
// bitmask, visit only those and publish runs of inter MBs at once. A
// broken schedule traps after 10 s. tests/test_torch_encode_rowlag.py
// checks the lag-2 rule with the plain per-MB step.
//
// Design. 512 worker threads and a publisher warp per block. A 4x4 block
// lives in 16 lanes, one coefficient per lane in raster order; the
// transforms exchange rows and columns by warp shuffles, and the quantizer
// runs its sequential zero-run carry as a 16-step scalar chain in every
// lane over one threshold per position (the count of zero-run lengths at
// which the coefficient passes the dead zone: the boost grows with the
// run, so those lengths are a prefix). Warps 0-7 hold the 16 Y blocks,
// warps 8-11 the 8 chroma blocks, the first half of warp 12 the Y2 block,
// warps 13-15 load the neighbours' pixels and the DC sums after the wait.
// A B_PRED MB runs its sub-blocks on warp 0, two per diagonal step (one
// per half-warp), while warps 8-11 do its chroma. The next intra MB's
// source pixels and parameters are loaded while the current one runs.
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
// TB/s. The real bound is the chain of 2(R-1)+C = 254 dependent MB steps on
// a keyframe (on an inter frame, the longest chain of dependent intra MBs),
// each a transform, a quantizer chain and an inverse transform long, and a
// B_PRED MB ten sub-block steps long.
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
constexpr int kEdge0 = 416;    // 3 warps of neighbour loads

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

struct Quant {
  int level;  // this lane's level
  int eob;    // the block's eob (the same in every lane of the group)
};

// vp8_regular_quantize_b_c over a block held one raster coefficient per
// lane (lane l, zig-zag position `scan`). dq_dc/dq_ac: the block's
// quantizer; zf: the zbin factor (84 below qindex 48, else 80); first0:
// skip zig-zag position 0 (a Y block with a Y2 block).
__device__ __forceinline__ Quant quantize(unsigned mask, int coef, int l,
                                          int scan, int dq_dc, int dq_ac,
                                          int zf, bool first0) {
  const int dq = l == 0 ? dq_dc : dq_ac;
  const int zbin = (zf * dq + 64) >> 7;
  const int rnd = (48 * dq) >> 7;
  int shift = 0;
#pragma unroll
  for (int k = 1; k < 10; ++k) shift += dq >= (1 << k);
  const int quant = 1 + ((1 << 16) << shift) / dq - (1 << 16);
  const int x = coef < 0 ? -coef : coef;
  const int xq = x + rnd;
  // the int32 product wraps as in the plain version
  const int prod = (int)((unsigned)xq * (unsigned)quant);
  int cand = ((prod >> 16) + xq) >> shift;
  cand = cand > 2047 ? 2047 : cand;
  // zero-run lengths 0..15 at which the coefficient passes the dead zone:
  // the boost grows with the run, so they are 0..cnt-1
  const int slack = x - zbin;
  int cnt = 0;
#pragma unroll
  for (int z = 0; z < 16; ++z) cnt += slack >= ((dq_ac * kZbinBoost[z]) >> 7);
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
  MbInputs in;
  in.param = t < kCols ? params[(int64_t)n * kCols + t] : 0;
  if (t < kChroma0) {
    const int b = t >> 4;
    in.src = sy[(int64_t)n * 256 + y_row(b, l) * 16 + y_col(b, l)];
  } else if (t < kY2) {
    const int c = t - kChroma0, blk = (c >> 4) & 3;
    in.src = ((c >> 6) ? sv : su)[(int64_t)n * 64 + c_row(blk, l) * 8 +
                                  c_col(blk, l)];
  } else {
    in.src = 0;
  }
  return in;
}

struct Smem {
  int p[kCols];
  int above[16], left[16], ar[4], tl, ydc;
  int c_above[2][8], c_left[2][8], c_tl[2], c_dc[2];
  int src_y[256];   // source luma, MB raster (B_PRED reads it by sub-block)
  int y_dc[16];     // the Y blocks' DC coefficients (the Y2 input)
  int y_dcrec[16];  // their reconstruction from the Y2 block
  int edge[2][16];  // E[0..12] of the sub-block of each half of warp 0
  Ws ws;
};

// B_PRED luma of one MB on warp 0: 16 sub-blocks in 10 diagonal steps, two
// sub-blocks per step (one per half-warp), then the workspace into the
// plane.
__device__ __forceinline__ void bpred_mb(Smem& s, uint8_t* Y, int ys,
                                         int32_t* q_mb, int32_t* e_mb,
                                         int32_t* bm_mb, int dq_dc, int dq_ac,
                                         int zf, const float* fl,
                                         double rddiv, int scan) {
  const int t = threadIdx.x, l = t & 15, half = t >> 4;
  const int i = l >> 2, j = l & 3;
  if (t < 17) s.ws[0][t] = t == 0 ? s.tl : s.above[t - 1];
  if (t < 16) {
    s.ws[1 + t][0] = s.left[t];
    s.ws[(t >> 2) * 4][17 + (t & 3)] = s.ar[t & 3];
  }
  int code[8];  // this lane's pixel under sub-modes 2-9 (intra_pred.cuh)
#pragma unroll
  for (int m = 0; m < 8; ++m) code[m] = kBCode[m][l];
  __syncwarp();
  for (int d = 0; d < 10; ++d) {
    int ir = (d < 3 ? 0 : (d - 2) >> 1) + half;
    const bool act = ir <= 3 && 2 * ir <= d;
    if (!act) ir = 0;
    const int ic = act ? d - 2 * ir : 0;
    if (l < 13) s.edge[half][l] = edge_px(s.ws, ir, ic, l);
    __syncwarp();
    const int* edge = s.edge[half];
    auto E = [&](int k) { return edge[k < 0 ? 0 : (k > 12 ? 12 : k)]; };
    const int src = s.src_y[(4 * ir + i) * 16 + 4 * ic + j];
    int pred[10], sse[10];
#pragma unroll
    for (int m = 0; m < 10; ++m) {
      pred[m] = bpred_from_edge(m, m >= 2 ? code[m - 2] : 0, E, i, j);
      const int e = src - pred[m];
      sse[m] = e * e;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int m = 0; m < 10; ++m)
        sse[m] += __shfl_xor_sync(0xffffffffu, sse[m], off);
    int best = 0;
    float best_cost = rdcost(fl[0], rddiv, sse[0]);
#pragma unroll
    for (int m = 1; m < 10; ++m) {
      const float cost = rdcost(fl[m], rddiv, sse[m]);
      if (cost < best_cost) {
        best_cost = cost;
        best = m;
      }
    }
    int p = pred[0];
#pragma unroll
    for (int m = 1; m < 10; ++m) p = best == m ? pred[m] : p;
    const int coef = fdct_lane(0xffffffffu, src - p, l);
    const Quant qt = quantize(0xffffffffu, coef, l, scan, dq_dc, dq_ac, zf,
                              false);
    const int res = idct_lane(
        0xffffffffu, s16(qt.level * (l == 0 ? dq_dc : dq_ac)), l);
    if (act) {
      const int k = 4 * ir + ic;
      q_mb[k * 16 + l] = qt.level;
      if (l == 0) {
        e_mb[k] = qt.eob;
        bm_mb[k] = best;
      }
      s.ws[1 + 4 * ir + i][1 + 4 * ic + j] = clamp255(p + res);
    }
    __syncwarp();
  }
  for (int k = t; k < 256; k += 32)
    Y[(k >> 4) * ys + (k & 15)] = (uint8_t)s.ws[1 + (k >> 4)][1 + (k & 15)];
}

// One intra MB (r,c) of a row that this block owns; every worker calls it.
__device__ __forceinline__ void encode_mb(
    Smem& s, uint8_t* y, int ys, uint8_t* u, uint8_t* v, int cs,
    const MbInputs& in, int C, int r, int c, bool top, const int* sync,
    int& seen, int32_t* qcoeff, int32_t* eobs, int32_t* bmodes,
    const float* fl, double rddiv, int scan) {
  const int t = threadIdx.x, l = t & 15;
  const int n = r * C + c;
  if (t < kCols) s.p[t] = in.param;
  if (t < kChroma0) s.src_y[y_row(t >> 4, l) * 16 + y_col(t >> 4, l)] = in.src;
  // the left column is this block's own earlier work; the rest is row
  // r-1's (or the top border's): loaded after the wait
  if (r > 0)
    rowlag::wait_above(sync, r, c + 2 < C ? c + 2 : C, seen, kWorkers);
  else
    rowlag::bar_sync(1, kWorkers);
  const bool up = r > 0 || top, lf = c > 0;
  uint8_t* Y = y + (int64_t)(r * 16) * ys + c * 16;
  if (t >= kEdge0) {
    const int w = (t - kEdge0) >> 5, k = t & 31;
    if (w == 0) {  // luma above (lanes 0-15), left (16-31), DC
      const int val = k < 16 ? (up ? Y[-ys + k] : 127)
                             : (lf ? Y[(k - 16) * ys - 1] : 129);
      (k < 16 ? s.above[k] : s.left[k - 16]) = val;
      int sum = val;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const int sl = __shfl_sync(0xffffffffu, sum, 16);
      if (k == 0) s.ydc = dc_value(sum, sl, up, lf, 4);
    } else if (w == 1) {  // chroma: U above, U left, V above, V left
      const int pl = k >> 4, e = k & 7;
      const bool is_left = k & 8;
      const uint8_t* P = (pl ? v : u) + (int64_t)(r * 8) * cs + c * 8;
      const int val = !is_left ? (up ? P[-cs + e] : 127)
                               : (lf ? P[e * cs - 1] : 129);
      (is_left ? s.c_left[pl][e] : s.c_above[pl][e]) = val;
      int sum = val;
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const int sl = __shfl_sync(0xffffffffu, sum, (k & 16) | 8);
      if ((k & 15) == 0) s.c_dc[pl] = dc_value(sum, sl, up, lf, 3);
    } else {  // corners and the above-right pixels
      if (k == 0) {
        s.tl = !up ? 127 : (!lf ? 129 : Y[-ys - 1]);
      } else if (k < 5) {
        s.ar[k - 1] = !up ? 127 : (c == C - 1 ? Y[-ys + 15] : Y[-ys + 15 + k]);
      } else if (k < 7) {
        const uint8_t* P = (k == 6 ? v : u) + (int64_t)(r * 8) * cs + c * 8;
        s.c_tl[k - 5] = !up ? 127 : (!lf ? 129 : P[-cs - 1]);
      }
    }
  }
  rowlag::bar_sync(1, kWorkers);

  const int mode = s.p[0], uv_mode = s.p[1], qidx = s.p[3];
  const int zf = qidx < 48 ? 84 : 80;
  const bool bpred = mode == kBPred;
  int32_t* q_mb = qcoeff + (int64_t)n * 400;
  int32_t* e_mb = eobs + (int64_t)n * 25;
  int ypred = 0, ylevel = 0;
  if (t < kChroma0) {
    if (!bpred) {  // 16x16 luma: Y block t >> 4
      const int b = t >> 4, py = y_row(b, l), px = y_col(b, l);
      ypred = pred_mb_pixel(mode, s.above, s.left, s.tl, s.ydc, py, px);
      const int coef = fdct_lane(0xffffffffu, in.src - ypred, l);
      if (l == 0) s.y_dc[b] = coef;
      const Quant qt = quantize(0xffffffffu, coef, l, scan, s.p[4], s.p[5],
                                zf, true);
      ylevel = qt.level;
      q_mb[b * 16 + l] = qt.level;
      if (l == 0) e_mb[b] = qt.eob > 1 ? qt.eob : 1;
    } else if (t < 32) {
      bpred_mb(s, Y, ys, q_mb, e_mb, bmodes + (int64_t)n * 16, s.p[4],
               s.p[5], zf, fl, rddiv, scan);
    }
  } else if (t < kY2) {  // chroma block 16 + (t - 256) / 16
    const int ch = t - kChroma0, pl = ch >> 6, blk = (ch >> 4) & 3;
    const int py = c_row(blk, l), px = c_col(blk, l);
    const int pred = pred_mb_pixel(uv_mode, s.c_above[pl], s.c_left[pl],
                                   s.c_tl[pl], s.c_dc[pl], py, px);
    const int coef = fdct_lane(0xffffffffu, in.src - pred, l);
    const int dq_dc = s.p[8], dq_ac = s.p[9];
    const Quant qt = quantize(0xffffffffu, coef, l, scan, dq_dc, dq_ac, zf,
                              false);
    const int b = 16 + (ch >> 4);
    q_mb[b * 16 + l] = qt.level;
    if (l == 0) e_mb[b] = qt.eob;
    const int res = idct_lane(
        0xffffffffu, s16(qt.level * (l == 0 ? dq_dc : dq_ac)), l);
    uint8_t* P = (pl ? v : u) + (int64_t)(r * 8) * cs + c * 8;
    P[py * cs + px] = (uint8_t)clamp255(pred + res);
  } else if (t < kY2 + 16 && bpred) {  // a B_PRED MB has no Y2 block
    q_mb[24 * 16 + l] = 0;
    if (l == 0) e_mb[24] = 0;
  }
  if (bpred) return;

  rowlag::bar_sync(1, kWorkers);  // the Y DCs are in s.y_dc
  if (t >= kY2 && t < kY2 + 16) {
    const int dq_dc = s.p[6], dq_ac = s.p[7];
    const int coef = walsh_lane(0xffffu, s.y_dc[l], l);
    const Quant qt = quantize(0xffffu, coef, l, scan, dq_dc, dq_ac, zf, false);
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
    const int dq = l == 0 ? s.y_dcrec[b] : s16(ylevel * s.p[5]);
    const int res = idct_lane(0xffffffffu, dq, l);
    Y[y_row(b, l) * ys + y_col(b, l)] = (uint8_t)clamp255(ypred + res);
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
  __shared__ unsigned mask[kMaxCols / 32];
  __shared__ int slot;     // progress handed to the publisher warp
  __shared__ float fl[10];  // floor((128 + cost*rdmult)/256) per sub-mode
  __shared__ double rddiv_s;
  const int t = threadIdx.x;
  if (bmode_cost != nullptr) {  // read by the first take_row's barrier
    if (t < 10)
      fl[t] = rdfloor((float)bmode_cost[t], *rdmult);
    if (t == 10) rddiv_s = (double)*rddiv;
  }
  const int scan = kInvZigzag[t & 15];  // zig-zag position of this lane
  for (;;) {
    const int r = rowlag::take_row(sync);
    if (r >= R) return;
    if (t >= kWorkers) {
      rowlag::publisher(sync, r, &slot, C, kWorkers);
      continue;
    }
    // which MBs of the row are intra; inter MBs are final already
    for (int k = t; k < kMaxCols / 32; k += kWorkers) mask[k] = 0;
    rowlag::bar_sync(1, kWorkers);
    for (int c = t; c < C; c += kWorkers)
      if (params[(int64_t)(r * C + c) * kCols + 2] != 0)
        atomicOr(&mask[c >> 5], 1u << (c & 31));
    rowlag::bar_sync(1, kWorkers);
    int c = next_intra(mask, 0, C);
    bool pending = false;
    if (c > 0) rowlag::hand_over(&slot, c, pending, kWorkers);
    int seen = 0;  // thread 0's last view of row r-1's progress
    MbInputs next;
    if (c < C) next = load_inputs(sy, su, sv, params, r * C + c);
    while (c < C) {
      const MbInputs cur = next;
      const int nc = next_intra(mask, c + 1, C);
      if (nc < C) next = load_inputs(sy, su, sv, params, r * C + nc);
      encode_mb(s, y, ys, u, v, cs, cur, C, r, c, top != 0, sync, seen,
                qcoeff, eobs, bmodes, fl, rddiv_s, scan);
      // MB c is done, and the inter MBs up to nc
      rowlag::hand_over(&slot, nc, pending, kWorkers);
      c = nc;
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
