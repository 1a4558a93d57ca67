// The VP8 bool decoder of K4 (detokenize.cu), in the 32-bit form of
// dboolhuff.h:51-116 that the JAX package's ops/entropy_device.py uses: a
// 24-bit window in a uint32 (BITS = 24), the fill as three unrolled steps
// with the LOTS_OF_BITS end, reads past blen giving 0. It is not the host
// runtime's 64-bit window (csrc/host/vp8_entropy.cpp), whose states after
// the same bits differ. tools/profile_bool_chain.cu times read_bool alone.
#pragma once
#include <cstdint>

namespace boolread {

constexpr int kBits = 24;
constexpr int kLotsOfBits = 0x4000;

struct BoolDecoder {
  const uint8_t* buf;
  int last;  // L - 1: reads clamp their index to the padded buffer
  int blen;
  uint32_t value;
  int range;
  int count;
  int pos;
};

// vp8_norm[range] under the JAX gather's index rules (a negative index
// wraps once, then clamps to [0, 255]); range is in [1, 256] on any stream.
__device__ __forceinline__ int norm_shift(int range) {
  int i = range < 0 ? range + 256 : range;
  i = min(max(i, 0), 255);
  return i == 0 ? 0 : __clz(i) - 24;
}

// VP8DX_BOOL_DECODER_FILL, BITS = 24, three unrolled steps: a loop would
// take a fourth byte when count < -15 on entry (shift = 8 - count).
__device__ __forceinline__ void fill(BoolDecoder& s) {
  int shift = kBits - 8 - (s.count + 8);
  const int bits_left = (s.blen - s.pos) * 8;
  const int x = shift + 8 - bits_left;
  int loop_end = 0;
  if (x >= 0) {
    s.count += kLotsOfBits;
    loop_end = x;
    if (bits_left <= 0) return;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (shift < loop_end) break;
    if (s.pos < s.blen && shift < 32) {
      const int i = min(max(s.pos, 0), s.last);
      s.value |= static_cast<uint32_t>(__ldg(s.buf + i)) << shift;
    }
    s.count += 8;
    s.pos += 1;
    shift -= 8;
  }
}

// vp8dx_decode_bool
__device__ __forceinline__ int read_bool(BoolDecoder& s, int prob) {
  const int split = 1 + (((s.range - 1) * prob) >> 8);
  if (s.count < 0) fill(s);
  const uint32_t bigsplit = static_cast<uint32_t>(split) << (kBits - 8);
  const int bit = s.value >= bigsplit;
  int range = split;
  if (bit) {
    range = s.range - split;
    s.value -= bigsplit;
  }
  const int sh = norm_shift(range);
  s.value <<= sh;
  s.range = range << sh;
  s.count -= sh;
  return bit;
}

// DECODE_AND_APPLYSIGN: split = (range + 1) >> 1 and one unconditional
// doubling; range may reach 256 and value 2^25.
__device__ __forceinline__ int read_sign(BoolDecoder& s) {
  const int split = (s.range + 1) >> 1;
  if (s.count < 0) fill(s);
  const uint32_t bigsplit = static_cast<uint32_t>(split) << (kBits - 8);
  const int neg = s.value >= bigsplit;
  int range = split;
  if (neg) {
    range = s.range - split;
    s.value -= bigsplit;
  }
  s.range = range + range;
  s.value += s.value;
  s.count -= 1;
  return neg;
}

}  // namespace boolread
