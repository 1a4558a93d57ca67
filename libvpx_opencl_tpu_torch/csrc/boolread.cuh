// The VP8 bool decoder of K4 (detokenize.cu), in the 32-bit form of
// dboolhuff.h:51-116 that the JAX package's ops/entropy_device.py uses: a
// 24-bit window in a uint32 (BITS = 24), the fill as three unrolled steps
// with the LOTS_OF_BITS end, reads past blen giving 0. It is not the host
// runtime's 64-bit window (csrc/host/vp8_entropy.cpp), whose states after
// the same bits differ. tools/profile_bool_chain.cu times read_bool alone.
//
// Two forms of a read, one state (value, range, count, pos: what K4 reports):
//   * read_bool<false>, the exact form: the JAX gather's index rules in
//     norm_shift, every byte loaded by the fill itself, inside the chain;
//   * read_bool<true>, the fast form, for a lane whose range starts in
//     [128, 256] under probabilities in [0, 255]. Every read then leaves a
//     range in [128, 256] and a pre-normalisation range in [1, 255]
//     (tests/test_torch_boolread.py proves it over every pair), where
//     norm_shift is clz - 24; both outcomes are normalised beside the
//     compare, so the chain is the split, the compare and a select. Its
//     fill takes the 2 or 3 bytes from two aligned words loaded at the
//     previous fill (a register look-ahead), and falls back to the exact
//     fill near the end of the partition (where LOTS_OF_BITS applies) or
//     off the usual states, for good.
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
  // look-ahead: the aligned words at and after the one holding byte pos,
  // and pos's byte offset in the first (times 8); valid while `ahead`
  uint32_t w0, w1;
  int off8;
  bool ahead;
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
__device__ __forceinline__ void fill_exact(BoolDecoder& s) {
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

// Load the aligned words that hold bytes pos..pos+3. Only words holding a
// byte of the partition buffer are read; bytes at or past blen in them
// are never used (the fast fill needs blen - pos > k).
__device__ __forceinline__ void look_ahead(BoolDecoder& s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s.buf + s.pos);
  const uintptr_t end = reinterpret_cast<uintptr_t>(s.buf + s.blen);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  s.off8 = static_cast<int>(a & 3) * 8;
  s.w0 = reinterpret_cast<uintptr_t>(w) < end ? __ldg(w) : 0u;
  s.w1 = reinterpret_cast<uintptr_t>(w + 1) < end ? __ldg(w + 1) : 0u;
}

// Start the look-ahead for a lane whose pos and blen lie in its buffer.
__device__ __forceinline__ void start(BoolDecoder& s) {
  s.ahead = s.pos >= 0 && s.pos <= s.blen && s.blen <= s.last + 1;
  if (s.ahead) look_ahead(s);
}

// The exact fill's result while count >= -8 (shift <= 16) and more than
// shift + 8 bits are left: k = 2 or 3 bytes at pos, at shifts shift,
// shift - 8, ..., taken from the look-ahead.
__device__ __forceinline__ void fill_fast(BoolDecoder& s) {
  const int shift = 8 - s.count;
  if (s.ahead && shift <= 16 && (s.blen - s.pos) * 8 > shift + 8) {
    const int k = (shift >> 3) + 1;
    const uint32_t be =
        __byte_perm(__funnelshift_r(s.w0, s.w1, s.off8), 0, 0x0123);
    s.value |= (be >> (32 - 8 * k)) << (shift - 8 * (k - 1));
    s.count += 8 * k;
    s.pos += k;
    look_ahead(s);
  } else {
    s.ahead = false;
    fill_exact(s);
  }
}

// vp8dx_decode_bool
template <bool kFast>
__device__ __forceinline__ int read_bool(BoolDecoder& s, int prob) {
  const int split = 1 + (((s.range - 1) * prob) >> 8);
  if (s.count < 0) {
    if (kFast)
      fill_fast(s);
    else
      fill_exact(s);
  }
  const uint32_t bigsplit = static_cast<uint32_t>(split) << (kBits - 8);
  const int bit = s.value >= bigsplit;
  if (kFast) {
    const int r1 = s.range - split;
    const int sh0 = __clz(split) - 24, sh1 = __clz(r1) - 24;
    const uint32_t v0 = s.value << sh0, v1 = (s.value - bigsplit) << sh1;
    s.value = bit ? v1 : v0;
    s.range = bit ? r1 << sh1 : split << sh0;
    s.count -= bit ? sh1 : sh0;
  } else {
    int range = split;
    if (bit) {
      range = s.range - split;
      s.value -= bigsplit;
    }
    const int sh = norm_shift(range);
    s.value <<= sh;
    s.range = range << sh;
    s.count -= sh;
  }
  return bit;
}

// DECODE_AND_APPLYSIGN: split = (range + 1) >> 1 and one unconditional
// doubling; range may reach 256 and value 2^25.
template <bool kFast>
__device__ __forceinline__ int read_sign(BoolDecoder& s) {
  const int split = (s.range + 1) >> 1;
  if (s.count < 0) {
    if (kFast)
      fill_fast(s);
    else
      fill_exact(s);
  }
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
