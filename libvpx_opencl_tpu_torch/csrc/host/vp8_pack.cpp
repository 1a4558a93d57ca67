// Host token-pack runtime: the bool ENCODER + whole-frame token counting
// and packing in C++ (the vp8_pack_tokens / tokenize.c+boolhuff.c role,
// ref: vp8/encoder/bitstream.c:322-420, vp8/encoder/boolhuff.{h,c}).
//
// The Python encoder (models/encoder.py _count_tokens/_pack_mb_tokens)
// stays as the golden reference; this runtime is differential-tested
// byte-exact against it (tests/test_native_pack.py) and replaces it on
// the production path — per-coefficient Python was 1.5-2.8 s/frame at
// 720p, this walk is ~5 ms.
#include <cstdint>
#include <cstring>
#include <vector>

#include "vp8_tables.h"

namespace {

const int8_t kCoefBands[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};
const int8_t kBlock2Above[25] = {0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3,
                                 4, 5, 4, 5, 6, 7, 6, 7, 8};
const int8_t kBlock2Left[25] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                4, 4, 5, 5, 6, 6, 7, 7, 8};
const int kCatMin[6] = {5, 7, 11, 19, 35, 67};
const uint8_t* const kCatProbs[6] = {kPcat1, kPcat2, kPcat3,
                                     kPcat4, kPcat5, kPcat6};
const int kCatBits[6] = {1, 2, 3, 4, 5, 11};

const int B_PRED_M = 4;
const int SPLITMV_M = 9;

// vp8/encoder/boolhuff.{h,c}: 24-bit lowvalue window with carry
// propagation into emitted bytes; 32-zero-bit flush.
struct BoolEnc {
  uint32_t lowvalue = 0;
  uint32_t range = 255;
  int count = -24;
  std::vector<uint8_t> buf;

  inline void put(int bit, int prob) {
    uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    uint32_t low = lowvalue;
    uint32_t rng;
    if (bit) {
      low += split;
      rng = range - split;
    } else {
      rng = split;
    }
    int shift = kNorm[rng];
    rng <<= shift;
    int cnt = count + shift;
    if (cnt >= 0) {
      int offset = shift - cnt;
      if ((low << (offset - 1)) & 0x80000000u) {
        // carry into already-emitted bytes (boolhuff.h:100-110)
        long x = (long)buf.size() - 1;
        while (x >= 0 && buf[x] == 0xFF) {
          buf[x] = 0;
          x--;
        }
        if (x >= 0) buf[x]++;
      }
      buf.push_back((low >> (24 - offset)) & 0xFF);
      low <<= offset;
      shift = cnt;
      low &= 0xFFFFFF;
      cnt -= 8;
    }
    lowvalue = low << shift;
    range = rng;
    count = cnt;
  }

  void stop() {
    for (int i = 0; i < 32; i++) put(0, 128);
  }
};

inline void write_cat(BoolEnc& e, int cat, int av) {
  int extra = av - kCatMin[cat];
  int nb = kCatBits[cat];
  const uint8_t* p = kCatProbs[cat];
  for (int i = 0; i < nb; i++) e.put((extra >> (nb - 1 - i)) & 1, p[i]);
}

// One 4x4 block of tokens (dual of detokenize.c's state machine; mirrors
// models/encoder.py _pack_block_tokens exactly). probs = [8][3][11] for
// the block type. Returns nonzero flag.
inline int pack_block(BoolEnc* e, const uint8_t* probs, const int16_t* q,
                      int eob, int start, int ctx, int64_t* counts) {
  int cpos = start;
  bool prev_zero = false;
  int nonzero = 0;
  while (cpos < 16) {
    const int band = kCoefBands[cpos];
    const uint8_t* p = probs + (band * 3 + ctx) * 11;
    int64_t* cnt = counts ? counts + (band * 3 + ctx) * 11 * 2 : nullptr;
    if (cpos >= eob) {
      if (!prev_zero) {
        if (e) e->put(0, p[0]);
        if (cnt) cnt[0 * 2 + 0]++;
      }
      break;
    }
    int v = q[kZigzag[cpos]];
    if (!prev_zero) {
      if (e) e->put(1, p[0]);
      if (cnt) cnt[0 * 2 + 1]++;
    }
    if (v == 0) {
      if (e) e->put(0, p[1]);
      if (cnt) cnt[1 * 2 + 0]++;
      ctx = 0;
      prev_zero = true;
      cpos++;
      continue;
    }
    if (e) e->put(1, p[1]);
    if (cnt) cnt[1 * 2 + 1]++;
    nonzero = 1;
    prev_zero = false;
    int av = v < 0 ? -v : v;
    if (av == 1) {
      if (e) e->put(0, p[2]);
      if (cnt) cnt[2 * 2 + 0]++;
      ctx = 1;
    } else {
      if (e) e->put(1, p[2]);
      if (cnt) cnt[2 * 2 + 1]++;
      ctx = 2;
      if (av <= 4) {
        if (e) e->put(0, p[3]);
        if (cnt) cnt[3 * 2 + 0]++;
        if (av == 2) {
          if (e) e->put(0, p[4]);
          if (cnt) cnt[4 * 2 + 0]++;
        } else {
          if (e) e->put(1, p[4]);
          if (cnt) cnt[4 * 2 + 1]++;
          if (e) e->put(av - 3, p[5]);
          if (cnt) cnt[5 * 2 + (av - 3)]++;
        }
      } else if (av <= 10) {
        if (e) e->put(1, p[3]);
        if (cnt) cnt[3 * 2 + 1]++;
        if (e) e->put(0, p[6]);
        if (cnt) cnt[6 * 2 + 0]++;
        if (av <= 6) {
          if (e) e->put(0, p[7]);
          if (cnt) cnt[7 * 2 + 0]++;
          if (e) write_cat(*e, 0, av);
        } else {
          if (e) e->put(1, p[7]);
          if (cnt) cnt[7 * 2 + 1]++;
          if (e) write_cat(*e, 1, av);
        }
      } else if (av <= 34) {
        if (e) e->put(1, p[3]);
        if (cnt) cnt[3 * 2 + 1]++;
        if (e) e->put(1, p[6]);
        if (cnt) cnt[6 * 2 + 1]++;
        if (e) e->put(0, p[8]);
        if (cnt) cnt[8 * 2 + 0]++;
        if (av <= 18) {
          if (e) e->put(0, p[9]);
          if (cnt) cnt[9 * 2 + 0]++;
          if (e) write_cat(*e, 2, av);
        } else {
          if (e) e->put(1, p[9]);
          if (cnt) cnt[9 * 2 + 1]++;
          if (e) write_cat(*e, 3, av);
        }
      } else {
        if (e) e->put(1, p[3]);
        if (cnt) cnt[3 * 2 + 1]++;
        if (e) e->put(1, p[6]);
        if (cnt) cnt[6 * 2 + 1]++;
        if (e) e->put(1, p[8]);
        if (cnt) cnt[8 * 2 + 1]++;
        if (av <= 66) {
          if (e) e->put(0, p[10]);
          if (cnt) cnt[10 * 2 + 0]++;
          if (e) write_cat(*e, 4, av);
        } else {
          if (e) e->put(1, p[10]);
          if (cnt) cnt[10 * 2 + 1]++;
          if (e) write_cat(*e, 5, av);
        }
      }
    }
    if (e) e->put(v < 0 ? 1 : 0, 128);  // sign
    cpos++;
  }
  return nonzero;
}

// Shared MB walk: counts when counts!=nullptr, packs when encs!=nullptr.
// coef_probs / counts layout: [4][8][3][11](x2).
void walk_frame(const int16_t* qcoeff, const int32_t* eobs,
                const int32_t* modes, const int32_t* skip, int R, int C,
                int mb_no_coeff_skip, const uint8_t* coef_probs,
                BoolEnc* encs, int nparts, int64_t* counts) {
  std::vector<int32_t> above(C * 9, 0);
  std::vector<int32_t> left(9, 0);
  for (int r = 0; r < R; r++) {
    std::memset(left.data(), 0, sizeof(int32_t) * 9);
    BoolEnc* e = encs ? &encs[r % nparts] : nullptr;
    for (int c = 0; c < C; c++) {
      const int n = r * C + c;
      const int mode = modes[n];
      const bool has_y2 = (mode != B_PRED_M && mode != SPLITMV_M);
      int32_t* actx = above.data() + c * 9;
      if (mb_no_coeff_skip && skip[n]) {
        // vp8_reset_mb_tokens_context dual (detokenize.c:70-84)
        std::memset(actx, 0, sizeof(int32_t) * 8);
        std::memset(left.data(), 0, sizeof(int32_t) * 8);
        if (has_y2) {
          actx[8] = 0;
          left[8] = 0;
        }
        continue;
      }
      int order[25];
      int norder = 0;
      if (has_y2) {
        order[norder++] = 24;
        for (int i = 0; i < 24; i++) order[norder++] = i;
      } else {
        for (int i = 0; i < 24; i++) order[norder++] = i;
      }
      for (int oi = 0; oi < norder; oi++) {
        const int i = order[oi];
        int btype;
        if (has_y2)
          btype = (i == 24) ? 1 : (i < 16 ? 0 : 2);
        else
          btype = (i < 16) ? 3 : 2;
        const int start = (has_y2 && i < 16) ? 1 : 0;
        const int ia = kBlock2Above[i], il = kBlock2Left[i];
        const int ctx = actx[ia] + left[il];
        const int16_t* q = qcoeff + ((int64_t)n * 25 + i) * 16;
        const int eob = eobs[n * 25 + i];
        const uint8_t* probs =
            coef_probs ? coef_probs + btype * 8 * 3 * 11 : nullptr;
        int64_t* cnt = counts ? counts + btype * 8 * 3 * 11 * 2 : nullptr;
        int nz = pack_block(e, probs, q, eob, start, ctx, cnt);
        actx[ia] = left[il] = nz;
      }
    }
  }
}

}  // namespace

extern "C" {

// Dry token walk accumulating branch counts [4][8][3][11][2] (the
// ENTROPY_STATS gathering role feeding vp8_update_coef_probs).
// coef_probs unused for counting (pass nullptr-equivalent behavior).
int vp8e_count_tokens(const int16_t* qcoeff, const int32_t* eobs,
                      const int32_t* modes, const int32_t* skip, int R,
                      int C, int mb_no_coeff_skip, int64_t* counts) {
  walk_frame(qcoeff, eobs, modes, skip, R, C, mb_no_coeff_skip, nullptr,
             nullptr, 0, counts);
  return 0;
}

// Pack every token partition: rows r%nparts go to partition r%nparts
// (vp8_pack_tokens_into_partitions, bitstream.c:456-492).  Outputs the
// flushed partitions concatenated into out_buf with per-partition sizes
// in part_sizes.  Returns total bytes, or -1 if out_cap is too small.
int64_t vp8e_pack_tokens(const int16_t* qcoeff, const int32_t* eobs,
                         const int32_t* modes, const int32_t* skip, int R,
                         int C, int mb_no_coeff_skip,
                         const uint8_t* coef_probs, int nparts,
                         uint8_t* out_buf, int64_t out_cap,
                         int64_t* part_sizes) {
  std::vector<BoolEnc> encs(nparts);
  walk_frame(qcoeff, eobs, modes, skip, R, C, mb_no_coeff_skip, coef_probs,
             encs.data(), nparts, nullptr);
  int64_t total = 0;
  for (int p = 0; p < nparts; p++) {
    encs[p].stop();
    part_sizes[p] = (int64_t)encs[p].buf.size();
    total += part_sizes[p];
  }
  if (total > out_cap) return -1;
  int64_t off = 0;
  for (int p = 0; p < nparts; p++) {
    std::memcpy(out_buf + off, encs[p].buf.data(), encs[p].buf.size());
    off += (int64_t)encs[p].buf.size();
  }
  return total;
}

}  // extern "C"
