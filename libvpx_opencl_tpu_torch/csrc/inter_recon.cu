// inter_recon: stages 1-2 of a VP8 frame in one launch (sm_90a): every
// MB's residual blocks, and every inter MB's reconstruction written into
// fresh bordered planes.
//
// What it replaces. No Pallas kernel: it stands for the JAX package's XLA
// stages `_residuals_*`, `_mc_dense_device` and `_mc_fixup_device` in
// libvpx_opencl_tpu/models/tpu_decoder.py, which the port had written as
// plain torch ops (models/torch_decoder.py:inter_planes over
// ops/transforms.py:compute_residual_blocks and ops/predict.py). Those
// ops cost some 300-450 host launches a frame on the decoder's dispatch
// worker, each taking the interpreter lock; this kernel is one.
//
// What it computes, exactly as inter_planes does:
//   * residuals (decodframe.c:247-305): dequantize the int16 coefficients
//     by the MB's factors, the Y2 inverse WHT (full, or the DC-only form
//     when eobs[24] <= 1) into the Y blocks' DCs when the MB has Y2, and the
//     24 inverse DCTs (idctllm.c), with the C code's int16 stores; written
//     for every MB as resid_y [N,16,16], resid_u/v [N,8,8] int32, the layout
//     K1 reads;
//   * prediction of every inter MB of `inter_idx` from the reference its
//     table row names: the two-pass 6-tap filter (filter.c; the bilinear
//     taps come embedded in the same [8,6] table), a 16x16 luma and two 8x8
//     chroma blocks, or for a SPLITMV MB (reconinter.c:449-525) one 4x4 tile
//     per luma sub-block and chroma quad with its own MV. Every window is
//     placed by jax.lax.dynamic_slice's start rule (ops/predict.py:
//     _slice_start: a negative start counted once from the end, then
//     clamped so that the window fits), a 16x16 block's window as one;
//   * prediction + residual, clamped to 0..255, into the planes. Intra MBs
//     are left to K1.
//
// Design. A grid of N + K blocks of 128 threads: block b < N computes MB
// b's residual and stores it; block N + j computes MB inter_idx[j]'s
// residual again, in registers, and reconstructs it. The two never write
// the same bytes. Within a block:
//   1. 50 threads load the MB's 800 bytes of coefficients, 16 bytes each,
//      and dequantize them into shared memory; one thread runs the WHT;
//   2. 96 threads run the IDCTs, a column each then a pixel row of 4 each;
//      thread k keeps pixel row k of the residual (a 16-byte run of the MB
//      image: luma rows first, then U, then V) in registers and either
//      stores it as one int4 (coalesced) or adds it to its prediction;
//   3. the 24 tiles (16 luma, 4 U, 4 V; a 16x16 block's tiles cut from its
//      one clamped window) each take a 9x9 reference window: a thread per
//      window row filters it horizontally into shared memory (9 x 4
//      values), then a thread per output row filters vertically, adds its
//      residual row and stores 4 pixels as one 32-bit word.
//
// What bounds it on the card. Bytes: a 1080p frame (8160 MBs) reads 6.5 MB
// of coefficients (again for inter MBs) and writes 12.5 MB of int32
// residuals; inter MBs read up to 24 x 81 reference bytes and write 384
// pixels each: about 20-28 MB, 6-8 us at 3.35 TB/s. The arithmetic is
// ~40 integer operations per output pixel. Its time on the card matters
// less than the host launches it removes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBorder = 32;  // luma plane border; chroma kBorder / 2
constexpr int kCoeffs = 25 * 16;
constexpr int kRows = 96;    // runs of 4 pixels: 64 luma, 16 U, 16 V
constexpr int kTiles = 24;   // 16 luma sub-blocks, 4 U and 4 V quads
constexpr int kWin = 9;      // a 4x4 tile's window: 4 + 5 taps' reach

struct Args {
  const int32_t* tab;        // [N, tstride] per-MB rows
  int tstride;
  int c_ref, c_hasy2, c_y2big, c_dq, c_mv, c_uvmv;
  const int16_t* qcoeff;     // [N, 25, 16], 16-byte aligned
  const int64_t* inter_idx;  // [K]
  const int64_t* pos;        // [S] rows of the inter list, increasing
  const int32_t* split_ymv;  // [S, 16, 2] (row, col)
  const int32_t* split_uvmv; // [S, 4, 2]
  int S;
  const int32_t* taps;       // [8, 6]
  const uint8_t* ref[3][3];  // [plane y/u/v][last, golden, altref]
  int32_t* resid[3];         // [N,16,16], [N,8,8], [N,8,8]
  uint8_t* out[3];           // bordered planes, rows ys / cs bytes
  int ys, cs;
  int R, C;
};

__device__ __forceinline__ int s16(int v) {
  return ((v + 32768) & 0xFFFF) - 32768;
}

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// jax.lax.dynamic_slice's start rule for a window of w in an axis of dim
__device__ __forceinline__ int slice_start(int s, int dim, int w) {
  if (s < 0) s += dim;
  return min(max(s, 0), dim - w);
}

// Pixel row k (0..95) of an MB's residual image: its tile (= its IDCT
// block: luma by*4+bx, U 16+q, V 20+q), the row within the tile, the plane,
// the pixel row and column within the MB, and the offset of its 4 values in
// the plane's [n,n] residual image (k*4 for luma, (k-64)%16*4 for chroma).
struct Row {
  int tile, i, plane, prow, pcol, roff;
};

__device__ __forceinline__ Row row_of(int k) {
  Row r;
  if (k < 64) {
    const int row = k >> 2, grp = k & 3;
    r.tile = (row >> 2) * 4 + grp;
    r.i = row & 3;
    r.plane = 0;
    r.prow = row;
    r.pcol = grp * 4;
    r.roff = k * 4;
  } else {
    const int kk = (k - 64) & 15, row = kk >> 1, grp = kk & 1;
    r.plane = k < 80 ? 1 : 2;
    r.tile = 16 + (r.plane - 1) * 4 + (row >> 2) * 2 + grp;
    r.i = row & 3;
    r.prow = row;
    r.pcol = grp * 4;
    r.roff = kk * 4;
  }
  return r;
}

// vp8_short_idct4x4llm_c's butterfly (idctllm.c:28-119)
__device__ __forceinline__ void idct_butterfly(int i0, int i1, int i2, int i3,
                                               int& a1, int& b1, int& c1,
                                               int& d1) {
  a1 = i0 + i2;
  b1 = i0 - i2;
  c1 = ((i1 * 35468) >> 16) - (i3 + ((i3 * 20091) >> 16));
  d1 = (i1 + ((i1 * 20091) >> 16)) + ((i3 * 35468) >> 16);
}

// vp8_short_inv_walsh4x4_c (idctllm.c:140-192): x raster [16] -> the 16 Y
// blocks' DCs in block raster order
__device__ void inv_walsh(const int* x, int* out) {
  int t[16];
  for (int j = 0; j < 4; ++j) {
    const int a1 = x[j] + x[12 + j], b1 = x[4 + j] + x[8 + j];
    const int c1 = x[4 + j] - x[8 + j], d1 = x[j] - x[12 + j];
    t[j] = s16(a1 + b1);
    t[4 + j] = s16(c1 + d1);
    t[8 + j] = s16(a1 - b1);
    t[12 + j] = s16(d1 - c1);
  }
  for (int k = 0; k < 4; ++k) {
    const int* r = t + 4 * k;
    const int a1 = r[0] + r[3], b1 = r[1] + r[2];
    const int c1 = r[1] - r[2], d1 = r[0] - r[3];
    out[4 * k + 0] = s16((a1 + b1 + 3) >> 3);
    out[4 * k + 1] = s16((c1 + d1 + 3) >> 3);
    out[4 * k + 2] = s16((a1 - b1 + 3) >> 3);
    out[4 * k + 3] = s16((d1 - c1 + 3) >> 3);
  }
}

// The split slot of inter-list row j (pos is increasing), or -1.
__device__ __forceinline__ int split_slot(const int64_t* pos, int S, int j) {
  int lo = 0, hi = S - 1;
  while (lo <= hi) {
    const int mid = (lo + hi) >> 1;
    const int64_t p = pos[mid];
    if (p == j) return mid;
    if (p < j) lo = mid + 1; else hi = mid - 1;
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads) inter_recon_kernel(const Args a) {
  __shared__ int d[25][17];         // dequantized coefficients, raster
  __shared__ int vt[kTiles][4][5];  // the IDCTs' vertical pass
  __shared__ int taps[48];
  __shared__ int oy[kTiles], ox[kTiles], xp[kTiles], yp[kTiles];
  __shared__ const uint8_t* src[kTiles];
  __shared__ int h[kTiles][kWin][4];  // horizontally filtered windows

  const int t = threadIdx.x;
  const int N = a.R * a.C;
  const bool inter = (int)blockIdx.x >= N;
  const int j = blockIdx.x - N;
  const int n = inter ? (int)a.inter_idx[j] : (int)blockIdx.x;
  const int32_t* row = a.tab + (int64_t)n * a.tstride;

  // 1. coefficients: thread k < 50 takes 8 of block k/2, dequantized by
  // Y (dq 0-1), U/V (dq 4-5) or Y2 (dq 2-3) factors, DC at position 0
  if (t < kCoeffs / 8) {
    const int4 w =
        reinterpret_cast<const int4*>(a.qcoeff + (int64_t)n * kCoeffs)[t];
    const int16_t* q = reinterpret_cast<const int16_t*>(&w);
    const int blk = t >> 1, p0 = (t & 1) * 8;
    const int f = a.c_dq + (blk < 16 ? 0 : (blk < 24 ? 4 : 2));
    const int dc = row[f], ac = row[f + 1];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      d[blk][p0 + k] = s16(q[k] * (p0 + k == 0 ? dc : ac));
  }
  if (inter && t < 48) taps[t] = a.taps[t];
  __syncthreads();
  if (t == 0 && row[a.c_hasy2] != 0) {
    int dcs[16];
    if (row[a.c_y2big] != 0) {
      int x[16];
      for (int k = 0; k < 16; ++k) x[k] = d[24][k];
      inv_walsh(x, dcs);
    } else {
      const int v = s16((d[24][0] + 3) >> 3);
      for (int k = 0; k < 16; ++k) dcs[k] = v;
    }
    for (int k = 0; k < 16; ++k) d[k][0] = dcs[k];
  }
  __syncthreads();

  // 2. IDCTs: a column of block t/4 each, then pixel row t of the MB image
  if (t < kRows) {
    const int blk = t >> 2, c = t & 3;
    int a1, b1, c1, d1;
    idct_butterfly(d[blk][c], d[blk][4 + c], d[blk][8 + c], d[blk][12 + c],
                   a1, b1, c1, d1);
    vt[blk][0][c] = s16(a1 + d1);
    vt[blk][1][c] = s16(b1 + c1);
    vt[blk][2][c] = s16(b1 - c1);
    vt[blk][3][c] = s16(a1 - d1);
  }

  // the prediction's tiles: reference plane, window origin, phases
  if (inter && t < kTiles) {
    const int r = n / a.C, c = n % a.C;
    const int ref = row[a.c_ref];
    const int pl = t < 16 ? 0 : (t < 20 ? 1 : 2);
    const bool luma = pl == 0;
    const int b = luma ? kBorder : kBorder / 2;
    const int size = luma ? 16 : 8;
    const int H = a.R * size + 2 * b, W = (luma ? a.ys : a.cs);
    const int q = luma ? t : (t - 16) & 3;          // tile within its block
    const int ty = luma ? q >> 2 : q >> 1, tx = luma ? q & 3 : q & 1;
    const int s = a.S ? split_slot(a.pos, a.S, j) : -1;
    int mvr, mvc, y0, x0;
    if (s >= 0) {
      const int32_t* mv = luma ? a.split_ymv + (int64_t)s * 32 + q * 2
                               : a.split_uvmv + (int64_t)s * 8 + q * 2;
      mvr = mv[0];
      mvc = mv[1];
      y0 = slice_start(b + r * size + ty * 4 + (mvr >> 3) - 2, H, kWin);
      x0 = slice_start(b + c * size + tx * 4 + (mvc >> 3) - 2, W, kWin);
    } else {
      const int col = luma ? a.c_mv : a.c_uvmv;
      mvr = row[col];
      mvc = row[col + 1];
      y0 = slice_start(b + r * size + (mvr >> 3) - 2, H, size + 5) + ty * 4;
      x0 = slice_start(b + c * size + (mvc >> 3) - 2, W, size + 5) + tx * 4;
    }
    oy[t] = y0;
    ox[t] = x0;
    xp[t] = mvc & 7;
    yp[t] = mvr & 7;
    src[t] = a.ref[pl][ref == 0 ? 0 : (ref == 1 ? 1 : 2)];
  }
  __syncthreads();

  Row pr;
  int res[4];
  if (t < kRows) {
    pr = row_of(t);
    const int* v = vt[pr.tile][pr.i];
    int a1, b1, c1, d1;
    idct_butterfly(v[0], v[1], v[2], v[3], a1, b1, c1, d1);
    res[0] = s16((a1 + d1 + 4) >> 3);
    res[1] = s16((b1 + c1 + 4) >> 3);
    res[2] = s16((b1 - c1 + 4) >> 3);
    res[3] = s16((a1 - d1 + 4) >> 3);
    if (!inter) {
      const int per = pr.plane == 0 ? 256 : 64;
      *reinterpret_cast<int4*>(a.resid[pr.plane] + (int64_t)n * per +
                               pr.roff) = make_int4(res[0], res[1], res[2],
                                                    res[3]);
    }
  }
  if (!inter) return;

  // 3. horizontal pass: window row e % 9 of tile e / 9
  for (int e = t; e < kTiles * kWin; e += kThreads) {
    const int tile = e / kWin, wr = e - tile * kWin;
    const int stride = tile < 16 ? a.ys : a.cs;
    const uint8_t* p = src[tile] + (int64_t)(oy[tile] + wr) * stride +
                       ox[tile];
    int w[kWin];
#pragma unroll
    for (int k = 0; k < kWin; ++k) w[k] = p[k];
    const int* f = taps + xp[tile] * 6;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += w[m + k] * f[k];
      h[tile][wr][m] = clamp255((acc + 64) >> 7);
    }
  }
  __syncthreads();

  // vertical pass, residual, clamp: pixel row t, 4 pixels in one store
  if (t < kRows) {
    const int* f = taps + yp[pr.tile] * 6;
    uint32_t packed = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += h[pr.tile][pr.i + k][m] * f[k];
      const int px = clamp255(clamp255((acc + 64) >> 7) + res[m]);
      packed |= (uint32_t)px << (8 * m);
    }
    const int r = n / a.C, c = n % a.C;
    const int size = pr.plane == 0 ? 16 : 8;
    const int b = pr.plane == 0 ? kBorder : kBorder / 2;
    const int stride = pr.plane == 0 ? a.ys : a.cs;
    uint8_t* dst = a.out[pr.plane] +
                   (int64_t)(b + r * size + pr.prow) * stride + b +
                   c * size + pr.pcol;
    *reinterpret_cast<uint32_t*>(dst) = packed;
  }
}

}  // namespace

// tab: [N, >= MB_COLS] int32 rows with row stride tstride, the six column
// indexes after it; qcoeff [N,25,16] int16, 16-byte aligned; inter_idx [K]
// int64; pos [S] int64 (increasing), split_ymv [S,16,2], split_uvmv [S,4,2]
// int32 (S = 0: no SPLITMV MB; the pointers are then not read); taps [8,6]
// int32; refs: 9 plane pointers, y then u then v, each last, golden,
// altref (not read when K = 0); resid_y/u/v [N,16,16] / [N,8,8] int32;
// y/u/v: bordered uint8 planes' first bytes (row strides ys / cs bytes;
// the reference planes have the same geometry). One launch on `stream`;
// returns cudaGetLastError().
extern "C" int inter_recon(const void* tab, int tstride, int c_ref,
                           int c_hasy2, int c_y2big, int c_dq, int c_mv,
                           int c_uvmv, const void* qcoeff,
                           const void* inter_idx, int K, const void* pos,
                           const void* split_ymv, const void* split_uvmv,
                           int S, const void* taps, void* const* refs,
                           void* resid_y, void* resid_u, void* resid_v,
                           void* y, int ys, void* u, void* v, int cs, int R,
                           int C, void* stream) {
  Args a;
  a.tab = static_cast<const int32_t*>(tab);
  a.tstride = tstride;
  a.c_ref = c_ref;
  a.c_hasy2 = c_hasy2;
  a.c_y2big = c_y2big;
  a.c_dq = c_dq;
  a.c_mv = c_mv;
  a.c_uvmv = c_uvmv;
  a.qcoeff = static_cast<const int16_t*>(qcoeff);
  a.inter_idx = static_cast<const int64_t*>(inter_idx);
  a.pos = static_cast<const int64_t*>(pos);
  a.split_ymv = static_cast<const int32_t*>(split_ymv);
  a.split_uvmv = static_cast<const int32_t*>(split_uvmv);
  a.S = S;
  a.taps = static_cast<const int32_t*>(taps);
  for (int p = 0; p < 3; ++p)
    for (int k = 0; k < 3; ++k)
      a.ref[p][k] = static_cast<const uint8_t*>(refs[p * 3 + k]);
  a.resid[0] = static_cast<int32_t*>(resid_y);
  a.resid[1] = static_cast<int32_t*>(resid_u);
  a.resid[2] = static_cast<int32_t*>(resid_v);
  a.out[0] = static_cast<uint8_t*>(y);
  a.out[1] = static_cast<uint8_t*>(u);
  a.out[2] = static_cast<uint8_t*>(v);
  a.ys = ys;
  a.cs = cs;
  a.R = R;
  a.C = C;
  inter_recon_kernel<<<R * C + K, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
