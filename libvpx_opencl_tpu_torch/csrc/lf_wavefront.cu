// K2: VP8 loop filter as an offset-2 diagonal wavefront, in place (sm_90a).
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
// edge 4 only). The simple filter does luma only, p0/q0 only.
//
// Why one launch per diagonal equals raster order. MB (r,c), on diagonal
// 2r+c, reads and writes rows y0-4..y0+15 and columns x0-4..x0+15. Every
// edit it must see comes from MBs on earlier diagonals ((r,c-1): d-1,
// (r-1,c): d-2, (r-1,c+1): d-1), and the only earlier-in-raster MB on its
// own diagonal, (r-1,c+2), touches columns x0+28.. only. So filtering the
// planes in place diagonal by diagonal (the reference OpenCL fork's own
// schedule) gives the raster-order result, and the TPU kernel's deferred
// edit strips and compose step have no counterpart here.
//
// What bounds it on the card. A 1080p frame moves ~6 MB (uint8 planes in
// and out): ~2 us at 3.35 TB/s. The bound that matters is the chain of 254
// dependent diagonals. One 32-thread block per MB: threads 0-15 filter the
// 16 luma rows/columns of an edge, threads 16-31 the 8 U and 8 V ones;
// __syncthreads orders the edges. One launch per diagonal, all from one
// host call (lf_wavefront below). A persistent row-lagged kernel or a CUDA
// graph is the next step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int sclamp(int v) {
  return v < -128 ? -128 : (v > 127 ? 127 : v);
}
__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// Normal filter across one edge: q0 at px[0], p0 at px[-step].
__device__ void filter_normal(uint8_t* px, int step, bool mb_edge, int blimit,
                              int limit, int thresh) {
  const int p3 = px[-4 * step], p2 = px[-3 * step], p1 = px[-2 * step],
            p0 = px[-step];
  const int q0 = px[0], q1 = px[step], q2 = px[2 * step], q3 = px[3 * step];
  const bool mask =
      iabs(p3 - p2) <= limit && iabs(p2 - p1) <= limit &&
      iabs(p1 - p0) <= limit && iabs(q1 - q0) <= limit &&
      iabs(q2 - q1) <= limit && iabs(q3 - q2) <= limit &&
      iabs(p0 - q0) * 2 + iabs(p1 - q1) / 2 <= blimit;
  if (!mask) return;  // every output equals its input
  const bool hev = iabs(p1 - p0) > thresh || iabs(q1 - q0) > thresh;
  const int ps2 = p2 - 128, ps1 = p1 - 128, ps0 = p0 - 128;
  const int qs0 = q0 - 128, qs1 = q1 - 128, qs2 = q2 - 128;
  if (mb_edge) {  // vp8_mbfilter
    int f = sclamp(ps1 - qs1);
    f = sclamp(f + 3 * (qs0 - ps0));
    const int fh = hev ? f : 0;
    const int f1 = sclamp(fh + 4) >> 3;
    const int f2 = sclamp(fh + 3) >> 3;
    const int nq0 = sclamp(qs0 - f1);
    const int np0 = sclamp(ps0 + f2);
    const int fw = hev ? 0 : f;
    int w = sclamp((63 + fw * 27) >> 7);
    px[0] = (uint8_t)(sclamp(nq0 - w) + 128);
    px[-step] = (uint8_t)(sclamp(np0 + w) + 128);
    w = sclamp((63 + fw * 18) >> 7);
    px[step] = (uint8_t)(sclamp(qs1 - w) + 128);
    px[-2 * step] = (uint8_t)(sclamp(ps1 + w) + 128);
    w = sclamp((63 + fw * 9) >> 7);
    px[2 * step] = (uint8_t)(sclamp(qs2 - w) + 128);
    px[-3 * step] = (uint8_t)(sclamp(ps2 + w) + 128);
  } else {  // vp8_filter
    int f = hev ? sclamp(ps1 - qs1) : 0;
    f = sclamp(f + 3 * (qs0 - ps0));
    const int f1 = sclamp(f + 4) >> 3;
    const int f2 = sclamp(f + 3) >> 3;
    px[0] = (uint8_t)(sclamp(qs0 - f1) + 128);
    px[-step] = (uint8_t)(sclamp(ps0 + f2) + 128);
    const int a = hev ? 0 : (f1 + 1) >> 1;
    px[step] = (uint8_t)(sclamp(qs1 - a) + 128);
    px[-2 * step] = (uint8_t)(sclamp(ps1 + a) + 128);
  }
}

// vp8_simple_filter across one edge (luma only).
__device__ void filter_simple(uint8_t* px, int step, int blimit) {
  const int p1 = px[-2 * step], p0 = px[-step], q0 = px[0], q1 = px[step];
  if (iabs(p0 - q0) * 2 + iabs(p1 - q1) / 2 > blimit) return;
  const int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
  int f = sclamp(ps1 - qs1);
  f = sclamp(f + 3 * (qs0 - ps0));
  const int f1 = sclamp(f + 4) >> 3;
  const int f2 = sclamp(f + 3) >> 3;
  px[0] = (uint8_t)(sclamp(qs0 - f1) + 128);
  px[-step] = (uint8_t)(sclamp(ps0 + f2) + 128);
}

__global__ void lf_diag_kernel(uint8_t* __restrict__ y, int ys,
                               uint8_t* __restrict__ u,
                               uint8_t* __restrict__ v, int cs,
                               const int32_t* __restrict__ params,
                               int pstride, int C, int d, int r_lo,
                               int simple) {
  const int r = r_lo + blockIdx.x;
  const int c = d - 2 * r;
  const int32_t* p = params + (int64_t)(r * C + c) * pstride;
  const int flevel = p[0];
  if (flevel == 0) return;
  const int mblim = p[1], blim = p[2], lim = p[3], hev = p[4];
  const bool noskip = p[5] != 0;
  const int t = threadIdx.x;

  // per-thread edge segment: luma (t < 16) or chroma (t >= 16)
  const bool luma = t < 16;
  const int k = luma ? t : (t - 16) & 7;
  uint8_t* P;
  int stride;
  if (luma) {
    P = y + (int64_t)(r * 16) * ys + c * 16;
    stride = ys;
  } else {
    P = ((t - 16) < 8 ? u : v) + (int64_t)(r * 8) * cs + c * 8;
    stride = cs;
  }
  const bool active = luma || !simple;
  // steps: left MB edge, inner vertical edges, top MB edge, inner
  // horizontal edges; chroma has one inner edge each way
  const int inner = luma ? 3 : 1;
  const int nsteps = 2 * (1 + inner);
  for (int s = 0; s < 8; ++s) {
    if (active && s < nsteps) {
      const bool vert = s <= inner;
      const int e = vert ? s : s - inner - 1;  // 0 = MB edge
      const bool mb_edge = e == 0;
      const bool apply = mb_edge ? (vert ? c > 0 : r > 0) : noskip;
      if (apply) {
        uint8_t* px = vert ? P + k * stride + 4 * e : P + (4 * e) * stride + k;
        const int step = vert ? 1 : stride;
        if (simple)
          filter_simple(px, step, mb_edge ? mblim : blim);
        else
          filter_normal(px, step, mb_edge, mb_edge ? mblim : blim, lim, hev);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// y/u/v point at pixel (0,0) of the MB grid inside bordered planes (row
// strides ys / cs bytes, border >= 4); params is [R*C, >=6] int32 with row
// stride pstride. Launches one kernel per non-empty diagonal (2(R-1)+C of
// them when C > 1) on `stream`.
extern "C" int lf_wavefront(void* y, int ys, void* u, void* v, int cs,
                            const void* params, int pstride, int R, int C,
                            int simple, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = 2 * (R - 1) + C;
  for (int d = 0; d < D; ++d) {
    int r_lo = (d - C + 2) / 2;
    if (r_lo < 0) r_lo = 0;
    int r_hi = d / 2;
    if (r_hi > R - 1) r_hi = R - 1;
    if (r_hi < r_lo) continue;  // empty diagonal (odd d when C == 1)
    lf_diag_kernel<<<r_hi - r_lo + 1, 32, 0, s>>>(
        static_cast<uint8_t*>(y), ys, static_cast<uint8_t*>(u),
        static_cast<uint8_t*>(v), cs, static_cast<const int32_t*>(params),
        pstride, C, d, r_lo, simple);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
