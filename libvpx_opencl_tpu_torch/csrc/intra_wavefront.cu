// K1: VP8 intra reconstruction as an offset-2 diagonal wavefront (sm_90a).
//
// Replaces the TPU kernel libvpx_opencl_tpu/ops/pallas_wavefront.py:
// _intra_kernel (launched by intra_recon_pallas).
//
// What it computes. MB (r,c) lies on diagonal d = 2r+c. Its intra
// prediction reads the row above (MB (r-1,c), diagonal d-2), the column to
// the left (MB (r,c-1), d-1), the top-left pixel (MB (r-1,c-1), d-3) and,
// for B_PRED, four above-right pixels (MB (r-1,c+1), d-1). So every MB of
// one diagonal can be reconstructed at once once the earlier diagonals are
// done. The kernel works in place on the bordered raster uint8 planes:
// the caller has already written every inter MB's reconstruction
// (MC + residual, clipped) there, and each launch reconstructs the intra
// MBs of one diagonal:
//   * 16x16 luma and 8x8 chroma DC/V/H/TM prediction (reconintra.c) plus
//     residual, clipped to [0,255];
//   * B_PRED: sixteen 4x4 sub-blocks in raster order over ten sub-modes
//     (reconintra4x4.c), a __syncthreads between sub-blocks;
//   * frame-edge rules: above = 127, left = 129, top-left 127 on MB row 0
//     and 129 on MB column 0; above-right 127 on MB row 0 and the above
//     row's pixel 15 in the last MB column; sub-block rows 1-3 of the right
//     sub-block column reuse the row-0 above-right pixels.
//
// What bounds it on the card. A 1080p frame moves about 16 MB (int32
// residual blocks in, uint8 planes in and out): ~5 us at 3.35 TB/s. The
// real bound is the dependency chain: 2(R-1)+C = 254 diagonals at 1080p,
// each at most 68 MBs wide, so the card is mostly idle and each diagonal
// costs a launch. This first version launches once per diagonal from one
// host call (intra_wavefront below), one 256-thread block per MB (one luma
// pixel per thread, then chroma), and returns at once for inter MBs. A
// persistent row-lagged kernel or a CUDA graph is the next step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBPred = 4;

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}
__device__ __forceinline__ int e3(int a, int b, int c) {
  return (a + 2 * b + c + 2) >> 2;
}
__device__ __forceinline__ int h2(int a, int b) { return (a + b + 1) >> 1; }

// One pixel (i, j) of a 4x4 B_PRED sub-block (vp8_intra4x4_predict_c).
// A[0..7] above (4 above + 4 above-right), L[0..3] left, tl top-left.
__device__ int bpred_pixel(int mode, const int* A, const int* L, int tl,
                           int i, int j) {
  // pp = L3 L2 L1 L0 tl A0 A1 A2 A3 (for RD / VR / HD)
  int pp[9] = {L[3], L[2], L[1], L[0], tl, A[0], A[1], A[2], A[3]};
  auto ed = [&](int k) { return e3(pp[k], pp[k + 1], pp[k + 2]); };
  auto hd = [&](int k) { return h2(pp[k], pp[k + 1]); };
  switch (mode) {
    case 0: {  // B_DC
      return (A[0] + A[1] + A[2] + A[3] + L[0] + L[1] + L[2] + L[3] + 4) >> 3;
    }
    case 1:  // B_TM
      return clamp255(L[i] + A[j] - tl);
    case 2:  // B_VE
      return e3(j == 0 ? tl : A[j - 1], A[j], A[j + 1]);
    case 3: {  // B_HE
      int a = i == 0 ? tl : L[i - 1];
      int c = i == 3 ? L[3] : L[i + 1];
      return e3(a, L[i], c);
    }
    case 4: {  // B_LD
      int k = i + j;
      return k < 6 ? e3(A[k], A[k + 1], A[k + 2]) : e3(A[6], A[7], A[7]);
    }
    case 5:  // B_RD
      return ed(3 - i + j);
    case 6: {  // B_VR
      const int r0[4] = {hd(4), hd(5), hd(6), hd(7)};
      const int r1[4] = {ed(3), ed(4), ed(5), ed(6)};
      const int r2[4] = {ed(2), hd(4), hd(5), hd(6)};
      const int r3[4] = {ed(1), ed(3), ed(4), ed(5)};
      return i == 0 ? r0[j] : i == 1 ? r1[j] : i == 2 ? r2[j] : r3[j];
    }
    case 7: {  // B_VL
      auto ev = [&](int k) { return e3(A[k], A[k + 1], A[k + 2]); };
      auto hv = [&](int k) { return h2(A[k], A[k + 1]); };
      const int r0[4] = {hv(0), hv(1), hv(2), hv(3)};
      const int r1[4] = {ev(0), ev(1), ev(2), ev(3)};
      const int r2[4] = {hv(1), hv(2), hv(3), ev(4)};
      const int r3[4] = {ev(1), ev(2), ev(3), ev(5)};
      return i == 0 ? r0[j] : i == 1 ? r1[j] : i == 2 ? r2[j] : r3[j];
    }
    case 8: {  // B_HD
      const int r0[4] = {hd(3), ed(3), ed(4), ed(5)};
      const int r1[4] = {hd(2), ed(2), hd(3), ed(3)};
      const int r2[4] = {hd(1), ed(1), hd(2), ed(2)};
      const int r3[4] = {hd(0), ed(0), hd(1), ed(1)};
      return i == 0 ? r0[j] : i == 1 ? r1[j] : i == 2 ? r2[j] : r3[j];
    }
    default: {  // B_HU
      const int* q = L;
      const int r0[4] = {h2(q[0], q[1]), e3(q[0], q[1], q[2]), h2(q[1], q[2]),
                         e3(q[1], q[2], q[3])};
      const int r1[4] = {h2(q[1], q[2]), e3(q[1], q[2], q[3]), h2(q[2], q[3]),
                         e3(q[2], q[3], q[3])};
      const int r2[4] = {h2(q[2], q[3]), e3(q[2], q[3], q[3]), q[3], q[3]};
      return i == 0 ? r0[j] : i == 1 ? r1[j] : i == 2 ? r2[j] : q[3];
    }
  }
}

// 16x16 / 8x8 prediction (reconintra.c), mode clipped to DC/V/H/TM.
__device__ int pred_pixel(int mode, const int* above, const int* left,
                          int tl, bool up, bool lf, int n, int log2n,
                          int py, int px) {
  mode = mode < 0 ? 0 : (mode > 3 ? 3 : mode);
  if (mode == 1) return above[px];
  if (mode == 2) return left[py];
  if (mode == 3) return clamp255(left[py] + above[px] - tl);
  if (!up && !lf) return 128;
  int total = 0;
  if (up)
    for (int k = 0; k < n; ++k) total += above[k];
  if (lf)
    for (int k = 0; k < n; ++k) total += left[k];
  int shift = log2n - 1 + (up ? 1 : 0) + (lf ? 1 : 0);
  return (total + (1 << (shift - 1))) >> shift;
}

__global__ void intra_diag_kernel(uint8_t* __restrict__ y, int ys,
                                  uint8_t* __restrict__ u,
                                  uint8_t* __restrict__ v, int cs,
                                  const int32_t* __restrict__ ry,
                                  const int32_t* __restrict__ ru,
                                  const int32_t* __restrict__ rv,
                                  const int32_t* __restrict__ params,
                                  int pstride, int C, int d, int r_lo) {
  const int r = r_lo + blockIdx.x;
  const int c = d - 2 * r;
  const int n = r * C + c;
  const int32_t* p = params + (int64_t)n * pstride;
  if (p[2] == 0) return;  // inter MB: its reconstruction is in place
  const int mode = p[0];
  const int uv_mode = p[1];
  const int t = threadIdx.x;
  const bool up = r > 0, lf = c > 0;

  uint8_t* Y = y + (int64_t)(r * 16) * ys + c * 16;
  __shared__ int above[16], left[16], ar[4], tl;
  __shared__ int c_above[2][8], c_left[2][8], c_tl[2];
  __shared__ int ws[17][21];

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
  __syncthreads();

  const int32_t* RY = ry + (int64_t)n * 256;
  if (mode != kBPred) {
    const int py = t >> 4, px = t & 15;
    const int pred = pred_pixel(mode, above, left, tl, up, lf, 16, 4, py, px);
    Y[py * ys + px] = (uint8_t)clamp255(pred + RY[t]);
  } else {
    if (t < 17) ws[0][t] = t == 0 ? tl : above[t - 1];
    if (t < 16) ws[1 + t][0] = left[t];
    if (t < 16) ws[(t >> 2) * 4][17 + (t & 3)] = ar[t & 3];
    __syncthreads();
    for (int k = 0; k < 16; ++k) {
      const int ir = k >> 2, ic = k & 3;
      if (t < 16) {
        const int i = t >> 2, j = t & 3;
        int A[8], L[4];
        for (int q = 0; q < 8; ++q) A[q] = ws[4 * ir][1 + 4 * ic + q];
        for (int q = 0; q < 4; ++q) L[q] = ws[1 + 4 * ir + q][4 * ic];
        const int tl4 = ws[4 * ir][4 * ic];
        int bm = p[4 + k];
        bm = bm < 0 ? 0 : (bm > 9 ? 9 : bm);
        const int pred = bpred_pixel(bm, A, L, tl4, i, j);
        const int py = 4 * ir + i, px = 4 * ic + j;
        ws[1 + py][1 + px] = clamp255(pred + RY[py * 16 + px]);
      }
      __syncthreads();
    }
    Y[(t >> 4) * ys + (t & 15)] = (uint8_t)ws[1 + (t >> 4)][1 + (t & 15)];
  }

  if (t < 128) {
    const int pl = t >> 6, k = t & 63, py = k >> 3, px = k & 7;
    uint8_t* P = (pl == 0 ? u : v) + (int64_t)(r * 8) * cs + c * 8;
    const int32_t* RC = (pl == 0 ? ru : rv) + (int64_t)n * 64;
    const int pred = pred_pixel(uv_mode, c_above[pl], c_left[pl], c_tl[pl],
                                up, lf, 8, 3, py, px);
    P[py * cs + px] = (uint8_t)clamp255(pred + RC[k]);
  }
}

}  // namespace

// y/u/v point at pixel (0,0) of the MB grid inside bordered planes (row
// strides ys / cs bytes); residuals are [R*C,16,16] / [R*C,8,8] int32;
// params is [R*C, >=20] int32 with row stride pstride. Launches one kernel
// per non-empty diagonal (2(R-1)+C of them when C > 1) on `stream`.
extern "C" int intra_wavefront(void* y, int ys, void* u, void* v, int cs,
                               const void* ry, const void* ru, const void* rv,
                               const void* params, int pstride, int R, int C,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = 2 * (R - 1) + C;
  for (int d = 0; d < D; ++d) {
    int r_lo = (d - C + 2) / 2;
    if (r_lo < 0) r_lo = 0;
    int r_hi = d / 2;
    if (r_hi > R - 1) r_hi = R - 1;
    if (r_hi < r_lo) continue;  // empty diagonal (odd d when C == 1)
    intra_diag_kernel<<<r_hi - r_lo + 1, 256, 0, s>>>(
        static_cast<uint8_t*>(y), ys, static_cast<uint8_t*>(u),
        static_cast<uint8_t*>(v), cs, static_cast<const int32_t*>(ry),
        static_cast<const int32_t*>(ru), static_cast<const int32_t*>(rv),
        static_cast<const int32_t*>(params), pstride, C, d, r_lo);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
