// K2: VP8 loop filter as one persistent row-lagged kernel, in place (sm_90a).
//
// Replaces the TPU kernel libvpx_opencl_tpu/ops/pallas_wavefront.py:
// _lf_kernel with _edge_filter (launched by loop_filter_pallas, composed by
// lf_compose).
//
// What it computes. The VP8 normal loop filter (loopfilter.c,
// loopfilter_filters.c) for each MB with a non-zero filter level, in this
// order: mbfilter on the left MB edge where a left neighbour exists,
// filter4 on the inner vertical edges 4/8/12 where `noskip` is set, then
// mbfilter on the top MB edge where an above neighbour exists and filter4
// on the inner horizontal edges. Luma MBs are 16 px, chroma 8 px (inner
// edge 4 only). The simple filter does luma only, p0/q0 only. The result
// equals raster-order filtering, so the TPU kernel's deferred edit strips
// and compose step have no counterpart here. With `top_interior` MB row 0
// is an interior row of a taller frame (a row shard below the first): its
// top MB edge is filtered too, against the 4 pixel rows of the plane's top
// border, which the caller has filled with the filtered last rows above and
// into which the filter writes (at most 3 rows change).
//
// Dependencies. MB (r,c) reads and writes rows y0-4..y0+15 and columns
// x0-4..x0+15 of its plane (x0, y0: its top-left pixel). The edits it must
// see come from (r,c-1), (r-1,c) and (r-1,c+1), whose left-edge filter
// changes (r-1,c)'s right columns; and (r,c)'s top-edge filter changes rows
// that (r-1,c+1) reads. Row r-1's MBs from c+2 on touch columns x0+28..
// only, and no MB of row r-1 touches rows y0.. . So (r,c) may run once row
// r-1 has finished min(c+2, C) MBs and (r,c-1) is done, the reference
// decoder's row-lag sync with a lag of 2; tests/test_torch_rowlag.py holds
// this against the diagonal order on the plain version (a lag of 1 fails).
//
// Design. One launch per call. Each block (64 worker threads and a
// publisher warp that issues the releases) takes MB rows in start order
// from a ticket counter (rowlag.cuh) and walks each row left to right,
// publishing its progress after each MB; MBs with filter level 0
// neither wait nor touch the planes. An MB stages its 20x20 luma and two
// 12x12 chroma patches in shared memory: its own 16x16 / 8x8 pixels, which
// nothing changes before it runs, are loaded into registers while the
// block runs the MB before; the 4 rows above and 4 columns to the left
// come in one batch after the wait. Which pixels a thread moves, and where,
// is fixed for the launch and computed once. A thread takes one line
// (warp 0: 16 luma lines; warp 1: 8 U and 8 V lines, at the same time) into
// registers and runs it across the vertical edges in order, then a column
// across the horizontal ones; then the block writes back every pixel an
// edge can change. Invariant: before row r publishes progress k, every
// pixel its MBs 0..k-1 wrote (their left and above neighbours' pixels
// included) is in global memory. The planes are written by other blocks
// during the kernel, so they are not __restrict__ and never read through
// the read-only path.
//
// What bounds it on the card. A 1080p frame moves ~6 MB (uint8 planes in
// and out): ~2 us at 3.35 TB/s. The bound that matters is the chain of
// 2(R-1)+C = 254 dependent MB steps (plus R-1 hand-offs between rows), each
// a global-memory round trip, 8 dependent edge filters and a write-back
// long.
#include <cstdint>
#include <cuda_runtime.h>

#include "rowlag.cuh"

namespace {

__device__ __forceinline__ int sclamp(int v) {
  return v < -128 ? -128 : (v > 127 ? 127 : v);
}
__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// One edge of one line held in registers: q[0] is q0, q[-1] p0. The
// normal filter (vp8_loop_filter / vp8_mbloop_filter: mbfilter on MB
// edges, filter4 inside) or the simple filter (p0/q0 only).
__device__ __forceinline__ void filter_edge(int* q, bool mb_edge, int blimit,
                                            int limit, int thresh,
                                            bool simple) {
  const int p3 = q[-4], p2 = q[-3], p1 = q[-2], p0 = q[-1];
  const int q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  const int ps2 = p2 - 128, ps1 = p1 - 128, ps0 = p0 - 128;
  const int qs0 = q0 - 128, qs1 = q1 - 128, qs2 = q2 - 128;
  if (simple) {  // vp8_simple_filter
    if (iabs(p0 - q0) * 2 + iabs(p1 - q1) / 2 > blimit) return;
    int f = sclamp(ps1 - qs1);
    f = sclamp(f + 3 * (qs0 - ps0));
    q[0] = sclamp(qs0 - (sclamp(f + 4) >> 3)) + 128;
    q[-1] = sclamp(ps0 + (sclamp(f + 3) >> 3)) + 128;
    return;
  }
  const bool mask =
      iabs(p3 - p2) <= limit && iabs(p2 - p1) <= limit &&
      iabs(p1 - p0) <= limit && iabs(q1 - q0) <= limit &&
      iabs(q2 - q1) <= limit && iabs(q3 - q2) <= limit &&
      iabs(p0 - q0) * 2 + iabs(p1 - q1) / 2 <= blimit;
  if (!mask) return;  // every output equals its input
  const bool hev = iabs(p1 - p0) > thresh || iabs(q1 - q0) > thresh;
  if (mb_edge) {  // vp8_mbfilter
    int f = sclamp(ps1 - qs1);
    f = sclamp(f + 3 * (qs0 - ps0));
    const int fh = hev ? f : 0;
    const int nq0 = sclamp(qs0 - (sclamp(fh + 4) >> 3));
    const int np0 = sclamp(ps0 + (sclamp(fh + 3) >> 3));
    const int fw = hev ? 0 : f;
    int w = sclamp((63 + fw * 27) >> 7);
    q[0] = sclamp(nq0 - w) + 128;
    q[-1] = sclamp(np0 + w) + 128;
    w = sclamp((63 + fw * 18) >> 7);
    q[1] = sclamp(qs1 - w) + 128;
    q[-2] = sclamp(ps1 + w) + 128;
    w = sclamp((63 + fw * 9) >> 7);
    q[2] = sclamp(qs2 - w) + 128;
    q[-3] = sclamp(ps2 + w) + 128;
  } else {  // vp8_filter
    int f = hev ? sclamp(ps1 - qs1) : 0;
    f = sclamp(f + 3 * (qs0 - ps0));
    const int f1 = sclamp(f + 4) >> 3;
    const int f2 = sclamp(f + 3) >> 3;
    q[0] = sclamp(qs0 - f1) + 128;
    q[-1] = sclamp(ps0 + f2) + 128;
    const int a = hev ? 0 : (f1 + 1) >> 1;
    q[1] = sclamp(qs1 - a) + 128;
    q[-2] = sclamp(ps1 + a) + 128;
  }
}

// The edges across one line of N pixels of the shared patch (a row for
// the vertical edges, a column for the horizontal ones; step between
// pixels): the MB edge at 4 where `mb_apply`, the inner edges at 8, 12, ..
// where `noskip`, in order, in registers.
template <int N>
__device__ __forceinline__ void filter_line(uint8_t* line, int step,
                                            bool mb_apply, bool noskip,
                                            bool simple, int mblim, int blim,
                                            int lim, int hev) {
  int px[N];
#pragma unroll
  for (int i = 0; i < N; ++i) px[i] = line[i * step];
#pragma unroll
  for (int e = 4; e < N; e += 4)
    if (e == 4 ? mb_apply : noskip)
      filter_edge(px + e, e == 4, e == 4 ? mblim : blim, lim, hev, simple);
#pragma unroll
  for (int i = 1; i < N; ++i) line[i * step] = (uint8_t)px[i];
}

// 64 workers and the publisher warp (rowlag.cuh)
constexpr int kWorkers = 64;
constexpr int kThreads = kWorkers + 32;
constexpr int kMaxBlocks = 1024;  // more MB rows are taken in turn
constexpr int kLY = 20, kLC = 12;  // patch sides: MB + 4 above / left
constexpr int kPatch = kLY * kLY + 2 * kLC * kLC;
// an MB's own pixels (16x16 luma, 2 x 8x8 chroma), and the rest of its
// patch (4 rows above, 4 columns left)
constexpr int kOwn = 256 + 2 * 64;
constexpr int kHalo = kPatch - kOwn;
constexpr int kOwnPer = (kOwn + kWorkers - 1) / kWorkers;
constexpr int kHaloPer = (kHalo + kWorkers - 1) / kWorkers;

// Patch cell of own pixel i (luma first, then U, then V): the offset into
// the patch, its plane (0 Y, 1 U, 2 V), row and column.
__device__ __forceinline__ int own_cell(int i, int& pl, int& row, int& col) {
  if (i < 256) {
    pl = 0;
    row = 4 + (i >> 4);
    col = 4 + (i & 15);
    return row * kLY + col;
  }
  i -= 256;
  pl = 1 + (i >> 6);
  row = 4 + ((i & 63) >> 3);
  col = 4 + (i & 7);
  return kLY * kLY + (pl - 1) * kLC * kLC + row * kLC + col;
}

// The same for halo pixel i: per plane, the 4 rows above (full width),
// then the 4 left columns of the rows below.
__device__ __forceinline__ int halo_cell(int i, int& pl, int& row, int& col) {
  int side = kLY;
  pl = 0;
  if (i >= 4 * kLY + 16 * 4) {
    i -= 4 * kLY + 16 * 4;
    side = kLC;
    pl = 1 + i / (4 * kLC + 8 * 4);
    i %= 4 * kLC + 8 * 4;
  }
  if (i < 4 * side) {
    row = i / side;
    col = i % side;
  } else {
    i -= 4 * side;
    row = 4 + (i >> 2);
    col = i & 3;
  }
  return (pl == 0 ? 0 : kLY * kLY + (pl - 1) * kLC * kLC) + row * side + col;
}

// One pixel a thread moves between a plane and the patch, fixed for the
// whole launch: its patch cell, its plane (-1: none) and its offset from the
// patch's top-left pixel in that plane. `wb`: an edge can change it.
struct Slot {
  int cell, pl, off;
  bool wb;
};

template <bool kOwnPx>
__device__ __forceinline__ Slot make_slot(int i, int n, int ys, int cs) {
  int pl, row, col;
  Slot s;
  s.cell = kOwnPx ? own_cell(i, pl, row, col) : halo_cell(i, pl, row, col);
  s.pl = i < n ? pl : -1;
  s.off = row * (pl == 0 ? ys : cs) + col;
  s.wb = row >= 4 || col >= 4;  // the top-left 4x4 corner stays
  return s;
}

// The patch's top-left pixel of MB (r,c) in each plane.
struct Bases {
  uint8_t *y, *u, *v;
  __device__ __forceinline__ uint8_t* at(const Slot& s) const {
    return (s.pl == 0 ? y : (s.pl == 1 ? u : v)) + s.off;
  }
};

// What a block loads for one MB before it may run it: its params and its
// own pixels, which no MB changes before this one runs (MB c-1's edges
// reach column x0-3 at most; row r-1's never reach row y0). So the block
// loads them for MB c+1 while it runs MB c.
struct MbInputs {
  int p[6];  // flevel, mblim, blim, lim, hev, noskip
  uint8_t own[kOwnPer];
};

__device__ __forceinline__ void load_inputs(
    const Bases& b, const Slot* own, const int32_t* __restrict__ params,
    MbInputs& in) {
#pragma unroll
  for (int k = 0; k < 6; ++k) in.p[k] = params[k];
#pragma unroll
  for (int j = 0; j < kOwnPer; ++j)
    in.own[j] = own[j].pl >= 0 ? *b.at(own[j]) : 0;
}

// One MB (r,c) of a row that this block owns; every thread calls it.
template <bool kSimple>
__device__ __forceinline__ void lf_mb(const Bases& b, const Slot* own,
                                      const Slot* halo, const MbInputs& in,
                                      int C, int r, int c, bool top,
                                      const int* sync, int& seen) {
  __shared__ uint8_t patch[kPatch];
  if (in.p[0] == 0) return;  // filter level 0: the same in every thread
  const int mblim = in.p[1], blim = in.p[2], lim = in.p[3], hev = in.p[4];
  const bool noskip = in.p[5] != 0;
  const int t = threadIdx.x;

#pragma unroll
  for (int j = 0; j < kOwnPer; ++j)
    if (own[j].pl >= 0) patch[own[j].cell] = in.own[j];
  // the halo: row r-1's pixels, and the left columns this block wrote
  if (r > 0)
    rowlag::wait_above(sync, r, c + 2 < C ? c + 2 : C, seen, kWorkers);
  uint8_t hv[kHaloPer];
#pragma unroll
  for (int j = 0; j < kHaloPer; ++j)  // all loads first, then the stores
    hv[j] = halo[j].pl >= 0 ? *b.at(halo[j]) : 0;
#pragma unroll
  for (int j = 0; j < kHaloPer; ++j)
    if (halo[j].pl >= 0) patch[halo[j].cell] = hv[j];
  rowlag::bar_sync(1, kWorkers);

  // warp 0 filters the 16 luma lines (threads 0-15), warp 1 the 8 U and
  // 8 V lines (threads 32-47), so that neither waits on the other: first
  // every row across the vertical edges, then every column across the
  // horizontal ones
  const int lane = t & 31;
  if (t < 16) {
    filter_line<kLY>(patch + (4 + lane) * kLY, 1, c > 0, noskip, kSimple,
                     mblim, blim, lim, hev);
    __syncwarp(0xffff);
    filter_line<kLY>(patch + 4 + lane, kLY, r > 0 || top, noskip, kSimple,
                     mblim, blim, lim, hev);
  } else if (t >= 32 && t < 48 && !kSimple) {
    uint8_t* P = patch + kLY * kLY + (lane >> 3) * kLC * kLC;
    const int k = lane & 7;
    filter_line<kLC>(P + (4 + k) * kLC, 1, c > 0, noskip, false, mblim,
                     blim, lim, hev);
    __syncwarp(0xffff);
    filter_line<kLC>(P + 4 + k, kLC, r > 0 || top, noskip, false, mblim,
                     blim, lim, hev);
  }
  rowlag::bar_sync(1, kWorkers);

  // write back every pixel an edge can change
#pragma unroll
  for (int j = 0; j < kOwnPer; ++j)
    if (own[j].pl >= 0) *b.at(own[j]) = patch[own[j].cell];
#pragma unroll
  for (int j = 0; j < kHaloPer; ++j)
    if (halo[j].pl >= 0 && halo[j].wb) *b.at(halo[j]) = patch[halo[j].cell];
}

template <bool kSimple>
__global__ void __launch_bounds__(kThreads)
    lf_rowlag_kernel(uint8_t* y, int ys, uint8_t* u, uint8_t* v, int cs,
                     const int32_t* __restrict__ params, int pstride, int R,
                     int C, int top, int* sync) {
  __shared__ int slot;  // progress handed to the publisher warp
  Slot own[kOwnPer], halo[kHaloPer];
#pragma unroll
  for (int j = 0; j < kOwnPer; ++j)
    own[j] = make_slot<true>(threadIdx.x + j * kWorkers,
                             kSimple ? 256 : kOwn, ys, cs);
#pragma unroll
  for (int j = 0; j < kHaloPer; ++j)
    halo[j] = make_slot<false>(threadIdx.x + j * kWorkers,
                               kSimple ? 4 * kLY + 16 * 4 : kHalo, ys, cs);
  auto bases = [&](int r, int c) {
    return Bases{y + (int64_t)(r * 16 - 4) * ys + c * 16 - 4,
                 u + (int64_t)(r * 8 - 4) * cs + c * 8 - 4,
                 v + (int64_t)(r * 8 - 4) * cs + c * 8 - 4};
  };
  for (;;) {
    const int r = rowlag::take_row(sync);
    if (r >= R) return;
    if (threadIdx.x >= kWorkers) {
      rowlag::publisher(sync, r, &slot, C, kWorkers);
      continue;
    }
    int seen = 0;  // thread 0's last view of row r-1's progress
    bool pending = false;
    const int32_t* prow = params + (int64_t)r * C * pstride;
    MbInputs next;
    load_inputs(bases(r, 0), own, prow, next);
    for (int c = 0; c < C; ++c) {
      const MbInputs cur = next;
      if (c + 1 < C)
        load_inputs(bases(r, c + 1), own, prow + (int64_t)(c + 1) * pstride,
                    next);
      lf_mb<kSimple>(bases(r, c), own, halo, cur, C, r, c, top != 0, sync,
                     seen);
      rowlag::hand_over(&slot, c + 1, pending, kWorkers);
    }
    rowlag::drain(pending, kWorkers);
  }
}

}  // namespace

// y/u/v point at pixel (0,0) of the MB grid inside bordered planes (row
// strides ys / cs bytes, border >= 4); params is [R*C, >=6] int32 with row
// stride pstride; top_interior != 0 filters row 0's top MB edge against
// the top border (see above); sync is R+1 int32 zeros. One launch on
// `stream`; returns cudaGetLastError().
extern "C" int lf_wavefront(void* y, int ys, void* u, void* v, int cs,
                            const void* params, int pstride, int R, int C,
                            int simple, int top_interior, void* sync,
                            void* stream) {
  const int grid = R < kMaxBlocks ? R : kMaxBlocks;
  auto kernel = simple ? lf_rowlag_kernel<true> : lf_rowlag_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(y), ys, static_cast<uint8_t*>(u),
      static_cast<uint8_t*>(v), cs, static_cast<const int32_t*>(params),
      pstride, R, C, top_interior, static_cast<int*>(sync));
  return static_cast<int>(cudaGetLastError());
}
