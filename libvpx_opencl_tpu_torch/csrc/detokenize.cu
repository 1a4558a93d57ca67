// K4: VP8 token decode, the boolean arithmetic decoder and the detokenizer
// over every MB of a frame, as one launch (sm_90a).
//
// Replaces libvpx_opencl_tpu/ops/entropy_device.py:detokenize_frame_device,
// a jitted lax.scan over MBs with a lax.while_loop of branchless bool reads
// per block (XLA, no Pallas kernel). Its plain version is
// ops/entropy_device.py:detokenize_frame_plain; outputs equal the JAX
// function's bit for bit, the partition states included.
//
// What it computes. Partition p decodes MB rows p, p+P, p+2P, ...
// (decodframe.c:1112-1129). Per MB: a skip MB clears its above/left
// contexts (0-7, and 8 with Y2) and outputs zeros with skipped = 1;
// otherwise 25 blocks (24 without Y2) run the token loop of
// detokenize.c:245-330 with the entropy contexts above[c][9] (shared by all
// rows) and left[9] (reset per row), and skipped = (eobtotal == 0) with
// eobtotal starting at -16 with Y2. The bool decoder is boolread.cuh's,
// the 24-bit window of the JAX function.
//
// Schedule. One block, one warp per partition, lane 0 decodes (two lanes of
// one warp that wait on each other would serialise). MB (r,c) reads and
// then writes above[c], which MB (r-1,c) wrote last: so row r may take
// column c once row r-1 has finished c+1 MBs, a lag of 1. Rows of one
// partition run in order on its own lane, so a lane waits only on the row
// above, which another lane owns (with P = 1 there is no wait at all).
// above, the per-row progress counters and coef_probs live in shared
// memory; progress is published with st.release.cta after the MB's context
// stores and read with ld.acquire.cta. A wait that takes 10 s means a
// broken schedule and traps (rowlag.cuh's watchdog) instead of hanging the
// card. Partitions with no row (R < P) return states0 unchanged.
//
// What bounds it on the card. The bytes are few: the keyframe of
// bench_1080p.ivf reads a 518 KB partition and writes 13 MB of int32
// coefficients (the wrapper zeroes them before the launch; the lane stores
// only the coefficients it decodes, plus every eobs/skipped entry of its
// MBs): ~4 us at 3.35 TB/s. What holds it is the chain of dependent bool
// reads on the longest lane: 6.33 million on that keyframe, 1.1-1.3
// million per inter frame. On an H100 80GB HBM3 at 700 W (SM clock 1980
// MHz) K4 takes ~95 ns per read on the keyframe and ~130 ns on inter
// frames (chip_smoke.py), against 72-98 ns for the read chain alone
// (tools/profile_bool_chain.py): most of K4's time per read is the read
// chain itself.
// One thread per partition is all the parallelism the bitstream gives, so
// K4 is slower than the host's C++ detokenizer, and the decoders keep the
// host path.
#include <cstdint>
#include <cuda_runtime.h>

#include "boolread.cuh"
#include "rowlag.cuh"

namespace {

constexpr int kMaxRows = 1024;  // VP8 sizes are 14 bits: <= 1024 MBs
constexpr int kMaxCols = 1024;
constexpr int kMaxParts = 8;
constexpr int kProbs = 4 * 8 * 3 * 11;

__constant__ int8_t kZigzag[16] = {0, 1,  4,  8,  5, 2,  3,  6,
                                   9, 12, 13, 10, 7, 11, 14, 15};
__constant__ int8_t kBands[16] = {0, 1, 2, 3, 6, 4, 5, 6,
                                  6, 6, 6, 6, 6, 6, 6, 7};
__constant__ int8_t kBlock2Above[25] = {0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3, 0,
                                        1, 2, 3, 4, 5, 4, 5, 6, 7, 6, 7, 8};
__constant__ int8_t kBlock2Left[25] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3,
                                       3, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8};
__constant__ int16_t kCatMin[6] = {5, 7, 11, 19, 35, 67};
__constant__ int8_t kCatLen[6] = {1, 2, 3, 4, 5, 11};
__constant__ uint8_t kCatProbs[6][11] = {
    {159},
    {165, 145},
    {173, 148, 140},
    {176, 155, 140, 135},
    {180, 157, 141, 134, 130},
    {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129}};

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

using boolread::BoolDecoder;
using boolread::read_bool;
using boolread::read_sign;

// One 4x4 block's token loop into qrow (zero on entry, raster order);
// probs [8][3][11] of the block type. Returns the eob; nz = any coded.
__device__ __forceinline__ int decode_block(BoolDecoder& s, const int* probs,
                                            int start, int ctx, int* qrow,
                                            int& nz) {
  int c = start;
  bool check_eob = true;
  nz = 0;
  while (c < 16) {
    const int* p = probs + (kBands[c] * 3 + ctx) * 11;
    if (check_eob && !read_bool(s, p[0])) break;  // EOB
    if (!read_bool(s, p[1])) {                     // ZERO token
      if (c == 15) break;  // malformed-input guard: eob 15
      ctx = 0;
      check_eob = false;
      ++c;
      continue;
    }
    int val;
    if (!read_bool(s, p[2])) {
      val = 1;
      ctx = 1;
    } else {
      ctx = 2;
      if (!read_bool(s, p[3])) {
        if (!read_bool(s, p[4]))
          val = 2;
        else
          val = read_bool(s, p[5]) ? 4 : 3;
      } else {
        int cat;
        if (!read_bool(s, p[6]))
          cat = read_bool(s, p[7]);
        else if (!read_bool(s, p[8]))
          cat = 2 + read_bool(s, p[9]);
        else
          cat = 4 + read_bool(s, p[10]);
        int extra = 0;  // fixed probabilities, MSB first
        for (int j = 0; j < kCatLen[cat]; ++j)
          extra = (extra << 1) | read_bool(s, kCatProbs[cat][j]);
        val = kCatMin[cat] + extra;
      }
    }
    if (read_sign(s)) val = -val;
    qrow[kZigzag[c]] = val;
    nz = 1;
    check_eob = true;
    if (c == 15) break;  // a coded 16th coefficient leaves eob 15
    ++c;
  }
  return c;
}

__global__ void __launch_bounds__(kMaxParts * 32)
    detokenize_kernel(const uint8_t* __restrict__ bufs, int L,
                      const int* __restrict__ blens,
                      const int* __restrict__ states0,
                      const int* __restrict__ coef_probs,
                      const uint8_t* __restrict__ has_y2,
                      const int* __restrict__ skip_in, int* __restrict__ q,
                      int* __restrict__ eobs, int* __restrict__ skipped,
                      int* __restrict__ states, int R, int C, int P) {
  __shared__ int probs[kProbs];
  __shared__ int8_t above[kMaxCols * 9];
  __shared__ int progress[kMaxRows];  // MBs row r has finished
  for (int i = threadIdx.x; i < kProbs; i += blockDim.x)
    probs[i] = coef_probs[i];
  for (int i = threadIdx.x; i < C * 9; i += blockDim.x) above[i] = 0;
  for (int i = threadIdx.x; i < R; i += blockDim.x) progress[i] = 0;
  __syncthreads();
  const int p = threadIdx.x >> 5;
  if ((threadIdx.x & 31) != 0 || p >= P) return;

  BoolDecoder s;
  s.buf = bufs + static_cast<size_t>(p) * L;
  s.last = L - 1;
  s.blen = blens[p];
  s.value = static_cast<uint32_t>(states0[4 * p]);
  s.range = states0[4 * p + 1];
  s.count = states0[4 * p + 2];
  s.pos = states0[4 * p + 3];

  for (int r = p; r < R; r += P) {
    int left[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    int seen = r == 0 ? C : 0;  // MBs of row r-1 known finished
    for (int c = 0; c < C; ++c) {
      if (seen <= c) {
        const uint64_t t0 = rowlag::globaltimer_ns();
        unsigned ns = 0;
        while ((seen = ld_acquire_cta(progress + r - 1)) <= c) {
          if (rowlag::globaltimer_ns() - t0 > rowlag::kWatchdogNs) __trap();
          if (ns) __nanosleep(ns);
          ns = ns ? (ns < 256 ? 2 * ns : 256) : 16;
        }
      }
      const int n = r * C + c;
      int8_t* ab = above + c * 9;
      int* e = eobs + static_cast<size_t>(n) * 25;
      const bool y2 = has_y2[n] != 0;
      if (skip_in[n] != 0) {
        // vp8_reset_mb_tokens_context (detokenize.c:70-84)
        for (int k = 0; k < (y2 ? 9 : 8); ++k) ab[k] = left[k] = 0;
        for (int k = 0; k < 25; ++k) e[k] = 0;
        skipped[n] = 1;
      } else {
        int eobtotal = y2 ? -16 : 0;
        if (!y2) e[24] = 0;
        for (int k = 0; k < (y2 ? 25 : 24); ++k) {
          // order and types of detokenize.c:183-243: with Y2, block 24
          // first (type 1), then Y (type 0, from coefficient 1) and UV
          // (type 2); without, Y (type 3) and UV
          int i, btype, start = 0;
          if (y2) {
            i = k == 0 ? 24 : k - 1;
            btype = k == 0 ? 1 : (k <= 16 ? 0 : 2);
            start = (k >= 1 && k <= 16) ? 1 : 0;
          } else {
            i = k;
            btype = k < 16 ? 3 : 2;
          }
          const int ia = kBlock2Above[i], il = kBlock2Left[i];
          int nz;
          const int eob = decode_block(
              s, probs + btype * (8 * 3 * 11), start, ab[ia] + left[il],
              q + (static_cast<size_t>(n) * 25 + i) * 16, nz);
          e[i] = eob;
          ab[ia] = static_cast<int8_t>(nz);
          left[il] = nz;
          eobtotal += eob;
        }
        skipped[n] = eobtotal == 0;
      }
      st_release_cta(progress + r, c + 1);
    }
  }
  states[4 * p] = static_cast<int>(s.value);
  states[4 * p + 1] = s.range;
  states[4 * p + 2] = s.count;
  states[4 * p + 3] = s.pos;
}

}  // namespace

// bufs [P, L] u8, blens [P], states0 [P, 4], coef_probs [4, 8, 3, 11],
// has_y2 [N] u8, skip_in [N] (all int32 but bufs and has_y2); outputs q
// [N, 25, 16] (zero on entry), eobs [N, 25], skipped [N], states [P, 4].
extern "C" int detokenize(const void* bufs, int L, const void* blens,
                          const void* states0, const void* coef_probs,
                          const void* has_y2, const void* skip_in, void* q,
                          void* eobs, void* skipped, void* states, int R,
                          int C, int P, void* stream) {
  if (R < 1 || R > kMaxRows || C < 1 || C > kMaxCols || P < 1 ||
      P > kMaxParts || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  detokenize_kernel<<<1, P * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bufs), L, static_cast<const int*>(blens),
      static_cast<const int*>(states0), static_cast<const int*>(coef_probs),
      static_cast<const uint8_t*>(has_y2), static_cast<const int*>(skip_in),
      static_cast<int*>(q), static_cast<int*>(eobs),
      static_cast<int*>(skipped), static_cast<int*>(states), R, C, P);
  return static_cast<int>(cudaGetLastError());
}
