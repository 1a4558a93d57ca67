// VP8 intra prediction shared by the intra wavefront (intra_wavefront.cu,
// K1) and the encode wavefront (encode_wavefront.cu, K5): 16x16 / 8x8
// DC/V/H/TM (reconintra.c) and the ten 4x4 B_PRED sub-modes
// (reconintra4x4.c) over a workspace that holds the sub-blocks' edges.
#pragma once
#include <cstdint>

namespace {

constexpr int kBPred = 4;  // the B_PRED luma mode

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}
__device__ __forceinline__ int e3(int a, int b, int c) {
  return (a + 2 * b + c + 2) >> 2;
}
__device__ __forceinline__ int h2(int a, int b) { return (a + b + 1) >> 1; }

// B_PRED sub-modes B_VE..B_HU (2-9): pixel (i,j) of a 4x4 sub-block is
// e3 (op 0) or h2 (op 1) of E[m], E[m+1] (, E[m+2]) over the edge vector
// E = L3 L2 L1 L0 tl A0..A7 (reconintra4x4.c), indices clamped to [0,12];
// the entry is op << 4 | (m + 1), row-major over (i,j).
__constant__ unsigned char kBCode[8][16] = {
    {5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7, 8},
    {3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 0, 0, 0, 0},
    {6, 7, 8, 9, 7, 8, 9, 10, 8, 9, 10, 11, 9, 10, 11, 12},
    {4, 5, 6, 7, 3, 4, 5, 6, 2, 3, 4, 5, 1, 2, 3, 4},
    {21, 22, 23, 24, 4, 5, 6, 7, 3, 21, 22, 23, 2, 4, 5, 6},
    {22, 23, 24, 25, 6, 7, 8, 9, 23, 24, 25, 10, 7, 8, 9, 11},
    {20, 4, 5, 6, 19, 3, 20, 4, 18, 2, 19, 3, 17, 1, 18, 2},
    {19, 2, 18, 1, 18, 1, 17, 0, 17, 0, 16, 16, 16, 16, 16, 16}};

// The B_PRED workspace: row 0 holds the top-left, above and above-right
// pixels, column 0 the left ones, cell (1+y, 1+x) pixel (y, x) of the MB;
// rows 4, 8 and 12 carry the MB's above-right pixels in columns 17-20.
typedef int Ws[17][21];

// E[k] of sub-block (ir, ic), k clamped to [0, 12].
__device__ __forceinline__ int edge_px(const Ws& ws, int ir, int ic, int k) {
  k = k < 0 ? 0 : (k > 12 ? 12 : k);
  return k < 4 ? ws[4 * ir + 4 - k][4 * ic] : ws[4 * ir][4 * ic + k - 4];
}

// One pixel (i, j) of a sub-block under sub-mode `mode`
// (vp8_intra4x4_predict_c), from its edge vector E(k) (k clamped to
// [0, 12] by E) and, for modes 2-9, the pixel's kBCode entry.
template <typename Edge>
__device__ __forceinline__ int bpred_from_edge(int mode, int code,
                                               const Edge& E, int i, int j) {
  if (mode == 0)  // B_DC
    return (E(0) + E(1) + E(2) + E(3) + E(5) + E(6) + E(7) + E(8) + 4) >> 3;
  if (mode == 1)  // B_TM
    return clamp255(E(3 - i) + E(5 + j) - E(4));
  const int m = (code & 15) - 1;
  return (code >> 4) ? h2(E(m), E(m + 1)) : e3(E(m), E(m + 1), E(m + 2));
}

// One pixel (i, j) of sub-block (ir, ic) of the workspace under `mode`.
__device__ __forceinline__ int bpred_pixel(int mode, const Ws& ws, int ir,
                                           int ic, int i, int j) {
  return bpred_from_edge(
      mode, mode >= 2 ? kBCode[mode - 2][4 * i + j] : 0,
      [&](int k) { return edge_px(ws, ir, ic, k); }, i, j);
}

// DC prediction from the sums of the above and left pixels (reconintra.c).
__device__ __forceinline__ int dc_value(int sum_above, int sum_left, bool up,
                                        bool lf, int log2n) {
  if (!up && !lf) return 128;
  const int shift = log2n - 1 + (up ? 1 : 0) + (lf ? 1 : 0);
  return ((up ? sum_above : 0) + (lf ? sum_left : 0) + (1 << (shift - 1))) >>
         shift;
}

// 16x16 / 8x8 prediction of pixel (py, px) (reconintra.c), mode clipped to
// DC/V/H/TM, with the DC value given.
__device__ __forceinline__ int pred_mb_pixel(int mode, const int* above,
                                             const int* left, int tl, int dc,
                                             int py, int px) {
  mode = mode < 0 ? 0 : (mode > 3 ? 3 : mode);
  if (mode == 1) return above[px];
  if (mode == 2) return left[py];
  if (mode == 3) return clamp255(left[py] + above[px] - tl);
  return dc;
}

// The same, summing the edges for the DC value.
__device__ int pred_pixel(int mode, const int* above, const int* left,
                          int tl, bool up, bool lf, int n, int log2n,
                          int py, int px) {
  int dc = 0;
  if (mode <= 0) {
    int sum_above = 0, sum_left = 0;
    for (int k = 0; k < n; ++k) {
      sum_above += above[k];
      sum_left += left[k];
    }
    dc = dc_value(sum_above, sum_left, up, lf, log2n);
  }
  return pred_mb_pixel(mode, above, left, tl, dc, py, px);
}

}  // namespace
