// K1: VP8 intra reconstruction as one persistent row-lagged kernel (sm_90a).
//
// Replaces the TPU kernel libvpx_opencl_tpu/ops/pallas_wavefront.py:
// _intra_kernel (launched by intra_recon_pallas).
//
// What it computes. The kernel works in place on the bordered raster uint8
// planes: the caller has already written every inter MB's reconstruction
// (MC + residual, clipped) there, and the kernel reconstructs the intra MBs:
//   * 16x16 luma and 8x8 chroma DC/V/H/TM prediction (reconintra.c) plus
//     residual, clipped to [0,255];
//   * B_PRED: sixteen 4x4 sub-blocks over ten sub-modes (reconintra4x4.c),
//     in 10 diagonal steps on one warp (a sub-block needs its left, above
//     and above-right neighbours);
//   * frame-edge rules: above = 127, left = 129, top-left 127 on MB row 0
//     and 129 on MB column 0; above-right 127 on MB row 0 and the above
//     row's pixel 15 in the last MB column; sub-block rows 1-3 of the right
//     sub-block column reuse the row-0 above-right pixels.
//   * `top_interior`: MB row 0 is an interior row of a taller frame (a row
//     shard below the first). It then reads its above row, above-right and
//     top-left pixels from the plane's top border, which the caller has
//     filled with the last unfiltered pixel row of the rows above, and
//     takes no frame-edge value there.
//
// Dependencies. MB (r,c) reads the row above (MB (r-1,c)), the column to the
// left ((r,c-1)), the top-left pixel ((r-1,c-1)) and, for B_PRED, four
// above-right pixels ((r-1,c+1)). It writes its own pixels only. So (r,c)
// may run once row r-1 has finished min(c+2, C) MBs and (r,c-1) is done:
// the reference decoder's row-lag sync (threading.c, nsync-lagged rows)
// with a lag of 2. Any order that keeps it gives the diagonal order's result
// (tests/test_torch_rowlag.py checks this on the plain version; a lag of 1
// does not).
//
// Design. One launch per call. Each block (256 worker threads and a
// publisher warp that issues the releases) takes MB rows in start order
// from a ticket counter (rowlag.cuh). It marks the row's intra MBs
// in a shared bitmask and visits only those, left to right: inter MBs are
// in place already, so a run of them is published at once with the intra
// MB before it, and they cost no step. Invariant: before row r publishes
// progress k, every pixel its MBs 0..k-1 wrote is in global memory. The
// planes are written by other blocks during the kernel, so they are not
// __restrict__ and never read through the read-only path. A block loads the
// next intra MB's params and residuals into registers while it runs the
// current one (nothing there depends on another row); the plane pixels an
// MB reads (above row, above-right, top-left, and the left column) come in
// one batch after the wait. B_PRED runs its 16 sub-blocks in 10 diagonal
// steps on one warp, each pixel from a table over the 13 edge pixels, while
// four other warps reconstruct the chroma.
//
// What bounds it on the card. A 1080p frame moves about 16 MB (int32
// residual blocks in, uint8 planes in and out): ~5 us at 3.35 TB/s. The
// real bound is the chain of 2(R-1)+C = 254 dependent MB steps (plus R-1
// hand-offs between rows) on a keyframe, each a global-memory round trip
// and the prediction long; on inter frames only intra MBs are steps.
#include <cstdint>
#include <cuda_runtime.h>

#include "intra_pred.cuh"
#include "rowlag.cuh"

namespace {

// blocks per launch: one per MB row, up to this many (more rows are
// taken by the same blocks in turn)
constexpr int kMaxBlocks = 1024;
// MB columns a row may have: VP8's 14-bit frame width gives at most 1024
constexpr int kMaxCols = 1024;
// 256 workers (one luma pixel each) and the publisher warp (rowlag.cuh)
constexpr int kWorkers = 256;
constexpr int kThreads = kWorkers + 32;

// What a block loads for one MB before it may run it; nothing here depends
// on another row, so the block loads it for MB c+1 while it runs MB c.
struct MbInputs {
  int param;  // params column t (threads 0-19)
  int res_y;  // luma residual pixel t
  int res_c;  // chroma residual pixel (threads 128-255: U, then V)
};

__device__ __forceinline__ MbInputs load_inputs(
    const int32_t* __restrict__ ry, const int32_t* __restrict__ ru,
    const int32_t* __restrict__ rv, const int32_t* __restrict__ params,
    int pstride, int n) {
  const int t = threadIdx.x;
  MbInputs in;
  in.param = t < 20 ? params[(int64_t)n * pstride + t] : 0;
  in.res_y = ry[(int64_t)n * 256 + t];
  in.res_c = t >= 128 ? (t < 192 ? ru : rv)[(int64_t)n * 64 + (t & 63)] : 0;
  return in;
}

// One intra MB (r,c) of a row that this block owns; every thread calls it.
__device__ __forceinline__ void intra_mb(uint8_t* y, int ys, uint8_t* u,
                                         uint8_t* v, int cs,
                                         const MbInputs& in, int C, int r,
                                         int c, bool top, const int* sync,
                                         int& seen) {
  const int t = threadIdx.x;
  __shared__ int p[20];
  __shared__ int above[16], left[16], ar[4], tl;
  __shared__ int c_above[2][8], c_left[2][8], c_tl[2];
  __shared__ Ws ws;

  if (t < 20) p[t] = in.param;
  rowlag::bar_sync(1, kWorkers);
  const int mode = p[0];
  const int uv_mode = p[1];
  const bool up = r > 0 || top, lf = c > 0;
  uint8_t* Y = y + (int64_t)(r * 16) * ys + c * 16;

  // the left column is this block's own earlier work; the rest is row
  // r-1's (or the top border's), so all of it is loaded in one batch
  // after the wait
  if (r > 0)
    rowlag::wait_above(sync, r, c + 2 < C ? c + 2 : C, seen, kWorkers);
  if (t < 16) {
    above[t] = up ? Y[-ys + t] : 127;
  } else if (t < 32) {
    left[t - 16] = lf ? Y[(t - 16) * ys - 1] : 129;
  } else if (t == 32) {
    tl = !up ? 127 : (!lf ? 129 : Y[-ys - 1]);
  } else if (t < 37) {
    const int k = t - 33;
    ar[k] = !up ? 127 : (c == C - 1 ? Y[-ys + 15] : Y[-ys + 16 + k]);
  } else if (t >= 64 && t < 64 + 2 * 17) {
    const int pl = (t - 64) / 17, k = (t - 64) % 17;
    uint8_t* P = (pl == 0 ? u : v) + (int64_t)(r * 8) * cs + c * 8;
    if (k < 8)
      c_above[pl][k] = up ? P[-cs + k] : 127;
    else if (k < 16)
      c_left[pl][k - 8] = lf ? P[(k - 8) * cs - 1] : 129;
    else
      c_tl[pl] = !up ? 127 : (!lf ? 129 : P[-cs - 1]);
  }
  rowlag::bar_sync(1, kWorkers);

  if (mode != kBPred) {
    const int py = t >> 4, px = t & 15;
    const int pred = pred_pixel(mode, above, left, tl, up, lf, 16, 4, py, px);
    Y[py * ys + px] = (uint8_t)clamp255(pred + in.res_y);
  } else {
    if (t < 17) ws[0][t] = t == 0 ? tl : above[t - 1];
    if (t < 16) ws[1 + t][0] = left[t];
    if (t < 16) ws[(t >> 2) * 4][17 + (t & 3)] = ar[t & 3];
    // each pixel's residual waits in its workspace cell
    ws[1 + (t >> 4)][1 + (t & 15)] = in.res_y;
    rowlag::bar_sync(1, kWorkers);
    // warp 0: sub-block (ir, ic) needs (ir, ic-1), (ir-1, ic) and
    // (ir-1, ic+1), so the sub-blocks of one diagonal 2*ir+ic run at once,
    // 16 threads each; warps 4-7 do the chroma meanwhile
    if (t < 32) {
      for (int d = 0; d < 10; ++d) {
        const int ir = (d < 3 ? 0 : (d - 2) >> 1) + (t >> 4);
        if (ir <= 3 && 2 * ir <= d) {
          const int ic = d - 2 * ir, i = (t >> 2) & 3, j = t & 3;
          int bm = p[4 + 4 * ir + ic];
          bm = bm < 0 ? 0 : (bm > 9 ? 9 : bm);
          const int pred = bpred_pixel(bm, ws, ir, ic, i, j);
          const int py = 4 * ir + i, px = 4 * ic + j;
          ws[1 + py][1 + px] = clamp255(pred + ws[1 + py][1 + px]);
        }
        __syncwarp();
      }
      for (int k = t; k < 256; k += 32)
        Y[(k >> 4) * ys + (k & 15)] = (uint8_t)ws[1 + (k >> 4)][1 + (k & 15)];
    }
  }

  if (t >= 128) {
    const int pl = (t - 128) >> 6, k = t & 63, py = k >> 3, px = k & 7;
    uint8_t* P = (pl == 0 ? u : v) + (int64_t)(r * 8) * cs + c * 8;
    const int pred = pred_pixel(uv_mode, c_above[pl], c_left[pl], c_tl[pl],
                                up, lf, 8, 3, py, px);
    P[py * cs + px] = (uint8_t)clamp255(pred + in.res_c);
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
    intra_rowlag_kernel(uint8_t* y, int ys, uint8_t* u, uint8_t* v, int cs,
                        const int32_t* __restrict__ ry,
                        const int32_t* __restrict__ ru,
                        const int32_t* __restrict__ rv,
                        const int32_t* __restrict__ params, int pstride,
                        int R, int C, int top, int* sync) {
  __shared__ unsigned mask[kMaxCols / 32];
  __shared__ int slot;  // progress handed to the publisher warp
  const int t = threadIdx.x;
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
      if (params[(int64_t)(r * C + c) * pstride + 2] != 0)
        atomicOr(&mask[c >> 5], 1u << (c & 31));
    rowlag::bar_sync(1, kWorkers);
    int c = next_intra(mask, 0, C);
    bool pending = false;
    if (c > 0) rowlag::hand_over(&slot, c, pending, kWorkers);
    int seen = 0;  // thread 0's last view of row r-1's progress
    MbInputs next;
    if (c < C) next = load_inputs(ry, ru, rv, params, pstride, r * C + c);
    while (c < C) {
      const MbInputs cur = next;
      const int nc = next_intra(mask, c + 1, C);
      if (nc < C) next = load_inputs(ry, ru, rv, params, pstride, r * C + nc);
      intra_mb(y, ys, u, v, cs, cur, C, r, c, top != 0, sync, seen);
      // MB c is done, and the inter MBs up to nc
      rowlag::hand_over(&slot, nc, pending, kWorkers);
      c = nc;
    }
    rowlag::drain(pending, kWorkers);
  }
}

}  // namespace

// y/u/v point at pixel (0,0) of the MB grid inside bordered planes (row
// strides ys / cs bytes); residuals are [R*C,16,16] / [R*C,8,8] int32;
// params is [R*C, >=20] int32 with row stride pstride; top_interior != 0
// takes row 0's above pixels from the top border (see above); sync is R+1
// int32 zeros. One launch on `stream`; returns cudaGetLastError().
extern "C" int intra_wavefront(void* y, int ys, void* u, void* v, int cs,
                               const void* ry, const void* ru, const void* rv,
                               const void* params, int pstride, int R, int C,
                               int top_interior, void* sync, void* stream) {
  const int grid = R < kMaxBlocks ? R : kMaxBlocks;
  intra_rowlag_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(y), ys, static_cast<uint8_t*>(u),
      static_cast<uint8_t*>(v), cs, static_cast<const int32_t*>(ry),
      static_cast<const int32_t*>(ru), static_cast<const int32_t*>(rv),
      static_cast<const int32_t*>(params), pstride, R, C, top_interior,
      static_cast<int*>(sync));
  return static_cast<int>(cudaGetLastError());
}
