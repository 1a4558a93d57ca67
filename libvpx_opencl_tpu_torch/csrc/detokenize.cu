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
// Reads. A lane whose range starts in [128, 256], under probabilities that
// all lie in [0, 255] (checked while they are staged), runs boolread's
// fast read: a register look-ahead feeds its fill, and both outcomes of a
// read are normalised beside its compare. Any other lane runs the exact
// read, which follows the JAX function on any state. The token loop loads
// a token's 11 probabilities into registers as it starts (its (band,
// context) row, three 16-byte shared-memory loads); the tree's reads take
// them from there, the next probability picked by a select on the bit
// where the tree allows it, and the category extra bits read in a loop
// under their fixed probabilities.
//
// Schedule. One block, one warp per partition, lane 0 decodes (two lanes of
// one warp that wait on each other would serialise). MB (r,c) reads and
// then writes above[c], which MB (r-1,c) wrote last: so row r may take
// column c once row r-1 has finished c+1 MBs, a lag of 1. Rows of one
// partition run in order on its own lane, so a lane waits only on the row
// above, which another lane owns (with P = 1 there is no wait at all).
// above (9 context bits per column), the per-row progress counters and
// coef_probs (rows of 12 ints) live in shared memory; progress is
// published with st.release.cta after the MB's context store and read
// with ld.acquire.cta. A wait that takes 10 s means a
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
// MHz) K4 takes ~71 ns per read on the keyframe and ~100 ns on inter
// frames (tools/profile_k4_k6.py), against ~46-51 ns for the fast read's
// chain alone and ~81 ns for the exact one's (tools/profile_bool_chain.py);
// before its redesign ~95 / ~130 ns. The rest is the token loop around
// the reads (a row of probabilities per token, the tree's branches, the
// contexts per block).
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

constexpr int kRows = 4 * 8 * 3;   // probability rows [type][band][ctx]
constexpr int kRowInts = 12;       // 11 probabilities and a pad: 3 x 16 B

__constant__ int8_t kZigzag[16] = {0, 1,  4,  8,  5, 2,  3,  6,
                                   9, 12, 13, 10, 7, 11, 14, 15};
// COEF_BANDS[c] for c = 0..15, three bits each
constexpr unsigned long long kBandBits =
    0ull | 1ull << 3 | 2ull << 6 | 3ull << 9 | 6ull << 12 | 4ull << 15 |
    5ull << 18 | 6ull << 21 | 6ull << 24 | 6ull << 27 | 6ull << 30 |
    6ull << 33 | 6ull << 36 | 6ull << 39 | 6ull << 42 | 7ull << 45;

// The above and left context slots of block i (vp8_block2above/left):
// Y blocks by their column and row, U and V by the nibbles below, Y2 8.
__device__ __forceinline__ int block2above(int i) {
  return i < 16 ? (i & 3) : i < 24 ? (0x76765454u >> (4 * (i - 16))) & 15 : 8;
}

__device__ __forceinline__ int block2left(int i) {
  return i < 16 ? (i >> 2) : i < 24 ? (0x77665544u >> (4 * (i - 16))) & 15 : 8;
}

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

__constant__ int16_t kCatMin[6] = {5, 7, 11, 19, 35, 67};
__constant__ int8_t kCatLen[6] = {1, 2, 3, 4, 5, 11};
__constant__ uint8_t kCatProbs[6][11] = {
    {159},
    {165, 145},
    {173, 148, 140},
    {176, 155, 140, 135},
    {180, 157, 141, 134, 130},
    {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129}};

// The value of DCT_VAL_CATEGORY1..6 (cat 0..5): its extra bits, MSB first,
// under their fixed probabilities (tokenize.c's Pcat tables). One read in
// a loop: the kernel's code stays small enough for the instruction cache.
template <bool kFast>
__device__ __forceinline__ int cat_value(BoolDecoder& s, int cat) {
  int e = 0;
  const int n = kCatLen[cat];
#pragma unroll 1
  for (int j = 0; j < n; ++j)
    e = e << 1 | read_bool<kFast>(s, kCatProbs[cat][j]);
  return kCatMin[cat] + e;
}

// One 4x4 block's token loop into qrow (zero on entry, raster order);
// probs the block type's rows [8][3][kRowInts]. Returns the eob; nz = any
// coded. A token's 11 probabilities come into registers as the token
// starts (three 16-byte loads of its (band, context) row); the tree's
// reads then take them from registers, the next read's probability picked
// by a select on the bit where the tree allows it.
template <bool kFast>
__device__ __forceinline__ int decode_block(BoolDecoder& s, const int* probs,
                                            int start, int ctx, int* qrow,
                                            int& nz) {
  int c = start;
  bool check_eob = true;
  nz = 0;
  while (c < 16) {
    const int band = static_cast<int>((kBandBits >> (3 * c)) & 7);
    const int4* row =
        reinterpret_cast<const int4*>(probs + (band * 3 + ctx) * kRowInts);
    const int4 pa = row[0], pb = row[1], pc = row[2];
    if (check_eob && !read_bool<kFast>(s, pa.x)) break;  // EOB
    if (!read_bool<kFast>(s, pa.y)) {                     // ZERO token
      if (c == 15) break;  // malformed-input guard: eob 15
      ctx = 0;
      check_eob = false;
      ++c;
      continue;
    }
    int val;
    if (!read_bool<kFast>(s, pa.z)) {
      val = 1;
      ctx = 1;
    } else {
      ctx = 2;
      const int b3 = read_bool<kFast>(s, pa.w);
      const int b = read_bool<kFast>(s, b3 ? pb.z : pb.x);  // p6 : p4
      if (!b3) {
        val = b ? 3 + read_bool<kFast>(s, pb.y) : 2;         // p5
      } else if (!b) {
        val = cat_value<kFast>(s, read_bool<kFast>(s, pb.w));  // p7
      } else {
        const int b8 = read_bool<kFast>(s, pc.x);            // p8
        val = cat_value<kFast>(
            s, 2 + 2 * b8 + read_bool<kFast>(s, b8 ? pc.z : pc.y));
      }
    }
    if (read_sign<kFast>(s)) val = -val;
    qrow[kZigzag[c]] = val;
    nz = 1;
    check_eob = true;
    if (c == 15) break;  // a coded 16th coefficient leaves eob 15
    ++c;
  }
  return c;
}

// Partition p's rows: MB rows p, p+P, ... left to right, each MB once row
// r-1 has finished c+1 MBs. The MB's above contexts (column c's 9 bits in
// shared memory) and the row's left contexts are bit masks in registers;
// the next MB's flags are loaded while this one decodes.
template <bool kFast>
__device__ __forceinline__ void decode_lane(
    BoolDecoder& s, const int* probs, uint16_t* above, int* progress,
    const uint8_t* __restrict__ has_y2, const int* __restrict__ skip_in,
    int* __restrict__ q, int* __restrict__ eobs, int* __restrict__ skipped,
    int p, int R, int C, int P) {
  int n_skip = p < R ? skip_in[p * C] : 0;
  bool n_y2 = p < R ? has_y2[p * C] != 0 : false;
  for (int r = p; r < R; r += P) {
    unsigned left = 0;
    int seen = r == 0 ? C : 0;  // MBs of row r-1 known finished
    for (int c = 0; c < C; ++c) {
      const int n = r * C + c;
      const int skip = n_skip;
      const bool y2 = n_y2;
      const int nn = c + 1 < C ? n + 1 : (r + P < R ? (r + P) * C : n);
      n_skip = skip_in[nn];
      n_y2 = has_y2[nn] != 0;
      if (seen <= c) {
        const uint64_t t0 = rowlag::globaltimer_ns();
        unsigned ns = 0;
        while ((seen = ld_acquire_cta(progress + r - 1)) <= c) {
          if (rowlag::globaltimer_ns() - t0 > rowlag::kWatchdogNs) __trap();
          if (ns) __nanosleep(ns);
          ns = ns ? (ns < 256 ? 2 * ns : 256) : 16;
        }
      }
      int* e = eobs + static_cast<size_t>(n) * 25;
      unsigned ab = above[c];
      if (skip != 0) {
        // vp8_reset_mb_tokens_context (detokenize.c:70-84)
        const unsigned keep = y2 ? ~0x1ffu : ~0xffu;
        ab &= keep;
        left &= keep;
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
          const int ia = block2above(i), il = block2left(i);
          int nz;
          const int eob = decode_block<kFast>(
              s, probs + btype * (8 * 3 * kRowInts), start,
              ((ab >> ia) & 1) + ((left >> il) & 1),
              q + (static_cast<size_t>(n) * 25 + i) * 16, nz);
          e[i] = eob;
          ab = (ab & ~(1u << ia)) | (static_cast<unsigned>(nz) << ia);
          left = (left & ~(1u << il)) | (static_cast<unsigned>(nz) << il);
          eobtotal += eob;
        }
        skipped[n] = eobtotal == 0;
      }
      above[c] = static_cast<uint16_t>(ab);
      st_release_cta(progress + r, c + 1);
    }
  }
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
  __shared__ __align__(16) int probs[kRows * kRowInts];
  __shared__ uint16_t above[kMaxCols];  // 9 context bits per column
  __shared__ int progress[kMaxRows];  // MBs row r has finished
  bool in_range = true;               // every probability in [0, 255]
  for (int i = threadIdx.x; i < kRows * kRowInts; i += blockDim.x) {
    const int j = i % kRowInts;
    const int v = j < 11 ? coef_probs[i / kRowInts * 11 + j] : 0;
    probs[i] = v;
    in_range = in_range && v >= 0 && v <= 255;
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) above[i] = 0;
  for (int i = threadIdx.x; i < R; i += blockDim.x) progress[i] = 0;
  in_range = __syncthreads_and(in_range);
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
  if (in_range && s.range >= 128 && s.range <= 256) {
    boolread::start(s);
    decode_lane<true>(s, probs, above, progress, has_y2, skip_in, q, eobs,
                      skipped, p, R, C, P);
  } else {
    decode_lane<false>(s, probs, above, progress, has_y2, skip_in, q, eobs,
                       skipped, p, R, C, P);
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
