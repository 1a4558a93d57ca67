// TPU VP8 framework — native host entropy runtime.
//
// The inherently serial layer of VP8 decode (boolean-arithmetic mode/MV and
// coefficient token decode) runs on the host CPU; this module is its
// performance implementation (the role vp8/decoder/{dboolhuff,decodemv,
// detokenize}.c play in the reference, here exposed as a C ABI consumed via
// ctypes and operating directly on the framework's struct-of-arrays frame
// representation).
//
// Behavior is specified by the reference decoder (bit-exactness contract):
//   bool decoder .... dboolhuff.{h,c} (64-bit window, zero-fill past end)
//   mode/MV ......... decodemv.c
//   detokenize ...... detokenize.c (incl. its distinct sign-renorm path)
// and is differentially tested against the pure-Python golden model.

#include <cstdint>
#include <cstring>
#include "vp8_tables.h"

namespace {

constexpr int kLotsOfBits = 0x40000000;

struct BoolDec {
  const uint8_t* buf;
  size_t size;
  size_t pos;
  uint64_t value;
  int count;
  uint32_t range;

  void fill() {
    int shift = 64 - 8 - (count + 8);
    long bits_left = (long)(size - pos) * 8;
    int x = shift + 8 - (int)bits_left;
    int loop_end = 0;
    if (x >= 0) {
      count += kLotsOfBits;
      loop_end = x;
      if (!bits_left) return;
    }
    while (shift >= loop_end) {
      count += 8;
      value |= (uint64_t)buf[pos++] << shift;
      shift -= 8;
    }
  }

  void init(const uint8_t* b, size_t n) {
    buf = b; size = n; pos = 0; value = 0; count = -8; range = 255;
    fill();
  }

  int read(int prob) {
    uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    if (count < 0) fill();
    uint64_t bigsplit = (uint64_t)split << (64 - 8);
    int bit;
    uint32_t r;
    if (value >= bigsplit) {
      r = range - split;
      value -= bigsplit;
      bit = 1;
    } else {
      r = split;
      bit = 0;
    }
    int shift = kNorm[r];
    range = r << shift;
    value <<= shift;
    count -= shift;
    return bit;
  }

  int read_bit() { return read(0x80); }

  int read_literal(int bits) {
    int z = 0;
    for (int i = 0; i < bits; i++) z = (z << 1) | read(0x80);
    return z;
  }

  int read_tree(const int8_t* tree, const uint8_t* probs) {
    int i = tree[read(probs[0])];
    while (i > 0) i = tree[i + read(probs[i >> 1])];
    return -i;
  }

  // detokenize.c DECODE_AND_APPLYSIGN: split=(range+1)>>1, one unconditional
  // doubling (range may transiently reach 256)
  int read_sign_det() {
    uint32_t split = (range + 1) >> 1;
    if (count < 0) fill();
    uint64_t bigsplit = (uint64_t)split << (64 - 8);
    int neg;
    if (value < bigsplit) {
      range = split;
      neg = 0;
    } else {
      range -= split;
      value -= bigsplit;
      neg = 1;
    }
    range += range;
    value += value;
    count -= 1;
    return neg;
  }
};

enum { DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED_M,
       NEARESTMV, NEARMV, ZEROMV, NEWMV, SPLITMV_M };
enum { INTRA_FR, LAST_FR, GOLDEN_FR, ALTREF_FR };

const int8_t kModeToBmode[4] = {0 /*B_DC*/, 2 /*B_VE*/, 3 /*B_HE*/,
                                1 /*B_TM*/};

// decodemv.c:163-170
const uint8_t kFillCount[4] = {8, 8, 4, 1};
const uint8_t kFillOffset[4][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15},
    {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
// findnearmv.c:14
const uint8_t kSplitOffset[4][16] = {
    {0, 8}, {0, 2}, {0, 2, 8, 10},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
// decodemv.c:224 vp8_sub_mv_ref_prob3
const uint8_t kSubMvRefProb3[8][3] = {
    {147, 136, 18}, {223, 1, 34}, {106, 145, 1}, {208, 1, 1},
    {179, 121, 1},  {223, 1, 34}, {179, 121, 1}, {208, 1, 1}};

struct MV { int32_t row, col; };

int read_mvcomponent(BoolDec& bc, const uint8_t* p) {
  // read_mvcomponent (decodemv.c:76-107); p = 19 probs
  const int MVPsign = 1, MVPshort = 2, MVPbits = 9;
  int x = 0;
  if (bc.read(p[0])) {
    for (int i = 0; i < 3; i++) x += bc.read(p[MVPbits + i]) << i;
    for (int i = 9; i > 3; i--) x += bc.read(p[MVPbits + i]) << i;
    if (!(x & 0xFFF0) || bc.read(p[MVPbits + 3])) x += 8;
  } else {
    x = bc.read_tree(kSmallMvTree, p + MVPshort);
  }
  if (x && bc.read(p[MVPsign])) x = -x;
  return x;
}

}  // namespace

extern "C" {

// Mode/MV decode for a whole frame (vp8_decode_mode_mvs, decodemv.c:583-664).
// Grids are padded (+1 top row, +1 left col): index (r+1)*(C+1)+(c+1).
// Returns 0; final bool state written to io_state[4] = {pos, value, count,
// range} (value split hi/lo not needed: stored as two u64 slots).
int vp8e_decode_modes(
    const uint8_t* buf, int64_t size, int64_t pos, uint64_t value,
    int64_t count, int64_t range_in, int frame_type, int R, int C,
    int mb_no_coeff_skip, int update_mb_seg_map,
    const uint8_t* seg_tree_probs,          // [3]
    uint8_t* ymode_prob,                    // [4] fc, in/out
    uint8_t* uv_mode_prob,                  // [3] fc, in/out
    const uint8_t* bmode_prob,              // [9] fc
    uint8_t* mvc,                           // [2*19] fc, in/out
    const int32_t* sign_bias,               // [4]
    int32_t* mode, int32_t* ref_frame,      // [(R+1)*(C+1)]
    int32_t* mv,                            // [(R+1)*(C+1)*2]
    int32_t* bmode,                         // [(R+1)*(C+1)*16]
    int32_t* bmv,                           // [(R+1)*(C+1)*16*2]
    int32_t* uv_mode, int32_t* skip,        // [R*C]
    int32_t* partitioning, int32_t* need_clamp,  // [R*C]
    int32_t* seg_map,                       // [R*C] in/out
    uint8_t* out_probs,                     // [4] skip_false/intra/last/gf
    int64_t* out_state) {                   // [4] pos/value/count/range
  BoolDec bc{buf, (size_t)size, (size_t)pos, value, (int)count,
             (uint32_t)range_in};
  const int PC = C + 1;
  auto M = [&](int pr, int pc) { return pr * PC + pc; };

  // mb_mode_mv_init (decodemv.c:177-221)
  int prob_skip_false = 0, prob_intra = 0, prob_last = 0, prob_gf = 0;
  if (mb_no_coeff_skip) prob_skip_false = bc.read_literal(8);
  if (frame_type != 0) {
    prob_intra = bc.read_literal(8);
    prob_last = bc.read_literal(8);
    prob_gf = bc.read_literal(8);
    if (bc.read_bit())
      for (int i = 0; i < 4; i++) ymode_prob[i] = bc.read_literal(8);
    if (bc.read_bit())
      for (int i = 0; i < 3; i++) uv_mode_prob[i] = bc.read_literal(8);
    for (int comp = 0; comp < 2; comp++)
      for (int i = 0; i < 19; i++)
        if (bc.read(kMvUpdateProbs[comp][i])) {
          int x = bc.read_literal(7);
          mvc[comp * 19 + i] = x ? x << 1 : 1;
        }
  }
  out_probs[0] = prob_skip_false;
  out_probs[1] = prob_intra;
  out_probs[2] = prob_last;
  out_probs[3] = prob_gf;

  for (int r = 0; r < R; r++) {
    for (int c = 0; c < C; c++) {
      const int pr = r + 1, pc = c + 1, n = r * C + c, m = M(pr, pc);
      // segment map (decodemv.c:582-620)
      if (update_mb_seg_map) {
        int seg;
        if (bc.read(seg_tree_probs[0]))
          seg = 2 + bc.read(seg_tree_probs[2]);
        else
          seg = bc.read(seg_tree_probs[1]);
        seg_map[n] = seg;
      } else if (frame_type == 0) {
        seg_map[n] = 0;
      }
      skip[n] = mb_no_coeff_skip ? bc.read(prob_skip_false) : 0;

      if (frame_type == 0) {
        // read_kf_modes (decodemv.c:49-74)
        ref_frame[m] = INTRA_FR;
        mv[m * 2] = mv[m * 2 + 1] = 0;
        int ym = bc.read_tree(kKfYmodeTree, kKfYmodeProb);
        mode[m] = ym;
        if (ym == B_PRED_M) {
          for (int i = 0; i < 16; i++) {
            int A, L;
            if (i < 4) {
              int am = mode[M(pr - 1, pc)];
              A = (am == B_PRED_M) ? bmode[M(pr - 1, pc) * 16 + i + 12]
                                   : (am <= TM_PRED ? kModeToBmode[am] : 0);
            } else {
              A = bmode[m * 16 + i - 4];
            }
            if ((i & 3) == 0) {
              int lm = mode[M(pr, pc - 1)];
              L = (lm == B_PRED_M) ? bmode[M(pr, pc - 1) * 16 + i + 3]
                                   : (lm <= TM_PRED ? kModeToBmode[lm] : 0);
            } else {
              L = bmode[m * 16 + i - 1];
            }
            bmode[m * 16 + i] = bc.read_tree(kBmodeTree, kKfBmodeProb[A][L]);
          }
        }
        uv_mode[n] = bc.read_tree(kUvModeTree, kKfUvModeProb);
        continue;
      }

      // read_mb_modes_mv (decodemv.c:320-580)
      if (!bc.read(prob_intra)) {
        ref_frame[m] = INTRA_FR;
        mv[m * 2] = mv[m * 2 + 1] = 0;
        int ym = bc.read_tree(kYmodeTree, ymode_prob);
        mode[m] = ym;
        if (ym == B_PRED_M)
          for (int i = 0; i < 16; i++)
            bmode[m * 16 + i] = bc.read_tree(kBmodeTree, bmode_prob);
        uv_mode[n] = bc.read_tree(kUvModeTree, uv_mode_prob);
        continue;
      }
      int ref = LAST_FR;
      if (bc.read(prob_last)) ref = 2 + bc.read(prob_gf);
      ref_frame[m] = ref;
      uv_mode[n] = DC_PRED;

      // near-MV accumulation (decodemv.c:348-407)
      MV near_mvs[4] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
      int cnt[4] = {0, 0, 0, 0};
      int cntx = 0, nmv = 0;
      auto bias = [&](MV v, int nb_ref) -> MV {
        if (sign_bias[nb_ref] != sign_bias[ref]) return MV{-v.row, -v.col};
        return v;
      };
      const int ma = M(pr - 1, pc), ml = M(pr, pc - 1), mal = M(pr - 1, pc - 1);
      MV above_mv{mv[ma * 2], mv[ma * 2 + 1]};
      MV left_mv{mv[ml * 2], mv[ml * 2 + 1]};
      MV al_mv{mv[mal * 2], mv[mal * 2 + 1]};
      if (ref_frame[ma] != INTRA_FR) {
        if (above_mv.row || above_mv.col) {
          near_mvs[++nmv] = bias(above_mv, ref_frame[ma]);
          ++cntx;
        }
        cnt[cntx] += 2;
      }
      if (ref_frame[ml] != INTRA_FR) {
        if (left_mv.row || left_mv.col) {
          MV t = bias(left_mv, ref_frame[ml]);
          if (t.row != near_mvs[nmv].row || t.col != near_mvs[nmv].col) {
            near_mvs[++nmv] = t;
            ++cntx;
          }
          cnt[cntx] += 2;
        } else {
          cnt[0] += 2;
        }
      }
      if (ref_frame[mal] != INTRA_FR) {
        if (al_mv.row || al_mv.col) {
          MV t = bias(al_mv, ref_frame[mal]);
          if (t.row != near_mvs[nmv].row || t.col != near_mvs[nmv].col) {
            near_mvs[++nmv] = t;
            ++cntx;
          }
          cnt[cntx] += 1;
        } else {
          cnt[0] += 1;
        }
      }

      if (!bc.read(kModeContexts[cnt[0]][0])) {
        mode[m] = ZEROMV;
        mv[m * 2] = mv[m * 2 + 1] = 0;
        continue;
      }

      const int m2l = -((c * 16) << 3), m2r = ((C - 1 - c) * 16) << 3;
      const int m2t = -((r * 16) << 3), m2b = ((R - 1 - r) * 16) << 3;
      const int MARGIN = 16 << 3;
      auto clamp2 = [&](MV v) -> MV {
        v.col = v.col < m2l - MARGIN ? m2l - MARGIN
                : (v.col > m2r + MARGIN ? m2r + MARGIN : v.col);
        v.row = v.row < m2t - MARGIN ? m2t - MARGIN
                : (v.row > m2b + MARGIN ? m2b + MARGIN : v.row);
        return v;
      };
      auto out_of_bounds = [&](MV v) -> int {
        return (v.col < m2l - MARGIN) | (v.col > m2r + MARGIN) |
               (v.row < m2t - MARGIN) | (v.row > m2b + MARGIN);
      };

      if (cnt[3] && near_mvs[nmv].row == near_mvs[1].row &&
          near_mvs[nmv].col == near_mvs[1].col)
        cnt[1] += 1;
      cnt[3] = ((mode[ma] == SPLITMV_M) + (mode[ml] == SPLITMV_M)) * 2 +
               (mode[mal] == SPLITMV_M);
      if (cnt[2] > cnt[1]) {
        int t = cnt[1]; cnt[1] = cnt[2]; cnt[2] = t;
        MV tv = near_mvs[1]; near_mvs[1] = near_mvs[2]; near_mvs[2] = tv;
      }

      if (!bc.read(kModeContexts[cnt[1]][1])) {
        mode[m] = NEARESTMV;
        MV v = clamp2(near_mvs[1]);
        mv[m * 2] = v.row; mv[m * 2 + 1] = v.col;
        continue;
      }
      if (!bc.read(kModeContexts[cnt[2]][2])) {
        mode[m] = NEARMV;
        MV v = clamp2(near_mvs[2]);
        mv[m * 2] = v.row; mv[m * 2 + 1] = v.col;
        continue;
      }
      if (cnt[1] >= cnt[0]) near_mvs[0] = near_mvs[1];
      MV best = clamp2(near_mvs[0]);

      if (bc.read(kModeContexts[cnt[3]][3])) {
        // decode_split_mv (decodemv.c:250-318)
        mode[m] = SPLITMV_M;
        int s;
        if (bc.read(110)) {
          s = 2;
          if (bc.read(111)) s = bc.read(150);
        } else {
          s = 3;
        }
        int nclamp = 0;
        const int num_p = kMbSplitCount[s];
        for (int j = 0; j < num_p; j++) {
          const int k = kSplitOffset[s][j];
          MV leftv, abovev;
          if ((k & 3) == 0) {
            if (mode[ml] != SPLITMV_M)
              leftv = MV{mv[ml * 2], mv[ml * 2 + 1]};
            else
              leftv = MV{bmv[(ml * 16 + k + 3) * 2],
                         bmv[(ml * 16 + k + 3) * 2 + 1]};
          } else {
            leftv = MV{bmv[(m * 16 + k - 1) * 2], bmv[(m * 16 + k - 1) * 2 + 1]};
          }
          if (k < 4) {
            if (mode[ma] != SPLITMV_M)
              abovev = MV{mv[ma * 2], mv[ma * 2 + 1]};
            else
              abovev = MV{bmv[(ma * 16 + k + 12) * 2],
                          bmv[(ma * 16 + k + 12) * 2 + 1]};
          } else {
            abovev = MV{bmv[(m * 16 + k - 4) * 2], bmv[(m * 16 + k - 4) * 2 + 1]};
          }
          const int lez = !(leftv.row | leftv.col);
          const int aez = !(abovev.row | abovev.col);
          const int lea = leftv.row == abovev.row && leftv.col == abovev.col;
          const uint8_t* prob = kSubMvRefProb3[(aez << 2) | (lez << 1) | lea];
          MV blockmv{0, 0};
          if (bc.read(prob[0])) {
            if (bc.read(prob[1])) {
              if (bc.read(prob[2])) {
                blockmv.row = (read_mvcomponent(bc, mvc) << 1) + best.row;
                blockmv.col = (read_mvcomponent(bc, mvc + 19) << 1) + best.col;
              }
            } else {
              blockmv = abovev;
            }
          } else {
            blockmv = leftv;
          }
          nclamp |= out_of_bounds(blockmv);
          const int fc_n = kFillCount[s];
          for (int f = 0; f < fc_n; f++) {
            int fo = kFillOffset[s][j * fc_n + f];
            bmv[(m * 16 + fo) * 2] = blockmv.row;
            bmv[(m * 16 + fo) * 2 + 1] = blockmv.col;
          }
        }
        partitioning[n] = s;
        need_clamp[n] = nclamp;
        mv[m * 2] = bmv[(m * 16 + 15) * 2];
        mv[m * 2 + 1] = bmv[(m * 16 + 15) * 2 + 1];
      } else {
        mode[m] = NEWMV;
        MV v;
        v.row = (read_mvcomponent(bc, mvc) << 1) + best.row;
        v.col = (read_mvcomponent(bc, mvc + 19) << 1) + best.col;
        need_clamp[n] = out_of_bounds(v);
        mv[m * 2] = v.row; mv[m * 2 + 1] = v.col;
      }
    }
  }
  out_state[0] = (int64_t)bc.pos;
  out_state[1] = (int64_t)bc.value;  // note: reinterpreted u64
  out_state[2] = bc.count;
  out_state[3] = bc.range;
  return 0;
}

// Whole-frame token decode (vp8_decode_mb_tokens, detokenize.c:183-384,
// with the per-partition row round-robin of decodframe.c:1112-1129).
int vp8e_detokenize(
    const uint8_t* data, const int64_t* part_off, const int64_t* part_size,
    int nparts, const uint8_t* coef_probs,  // [4*8*3*11], current fc
    int R, int C, const int32_t* mode_padded,  // [(R+1)*(C+1)]
    int32_t* skip,                             // [R*C] in/out
    int16_t* qcoeff,                           // [R*C*25*16] (zeroed)
    int32_t* eobs) {                           // [R*C*25] (zeroed)
  BoolDec bcs[8];
  for (int i = 0; i < nparts; i++)
    bcs[i].init(data + part_off[i], (size_t)part_size[i]);
  const int PC = C + 1;
  int8_t* above = new int8_t[C * 9]();
  int8_t left[9];

  for (int r = 0; r < R; r++) {
    std::memset(left, 0, sizeof(left));
    BoolDec& bc = bcs[r % nparts];
    for (int c = 0; c < C; c++) {
      const int n = r * C + c;
      const int mbmode = mode_padded[(r + 1) * PC + (c + 1)];
      const int has_y2 = (mbmode != B_PRED_M && mbmode != SPLITMV_M);
      int8_t* a9 = above + c * 9;
      if (skip[n]) {
        // vp8_reset_mb_tokens_context (detokenize.c:70-84)
        std::memset(a9, 0, 8);
        std::memset(left, 0, 8);
        if (has_y2) { a9[8] = 0; left[8] = 0; }
        continue;
      }
      int16_t* q = qcoeff + n * 25 * 16;
      int32_t* e = eobs + n * 25;
      int eobtotal = has_y2 ? -16 : 0;
      // block order: [24, 0..15, 16..23] when has_y2 else [0..15, 16..23]
      for (int oi = 0; oi < (has_y2 ? 25 : 24); oi++) {
        int i;
        if (has_y2) i = (oi == 0) ? 24 : (oi - 1);
        else i = oi;
        int btype;
        if (has_y2) btype = (i == 24) ? 1 : (i < 16 ? 0 : 2);
        else btype = (i < 16) ? 3 : 2;
        const int start = (has_y2 && i < 16) ? 1 : 0;
        static const int8_t b2a[25] = {0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3,
                                       0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 6, 7, 8};
        static const int8_t b2l[25] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
                                       3, 3, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8};
        const int ia = b2a[i], il = b2l[i];
        int ctx = a9[ia] + left[il];
        a9[ia] = left[il] = 0;
        const uint8_t* probs = coef_probs + btype * 8 * 3 * 11;
        int16_t* qb = q + i * 16;
        int cpos = start;
        bool check_eob = true;
        while (cpos < 16) {
          const uint8_t* p = probs + (kCoefBands[cpos] * 3 + ctx) * 11;
          if (check_eob && !bc.read(p[0])) break;
          if (!bc.read(p[1])) {  // ZERO
            if (cpos == 15) break;  // malformed-input guard (eob stays 15)
            ctx = 0;
            check_eob = false;
            cpos++;
            continue;
          }
          check_eob = true;
          a9[ia] = left[il] = 1;
          int val;
          if (!bc.read(p[2])) {
            val = 1;
            ctx = 1;
          } else {
            ctx = 2;
            if (!bc.read(p[3])) {
              if (!bc.read(p[4])) val = 2;
              else if (!bc.read(p[5])) val = 3;
              else val = 4;
            } else if (!bc.read(p[6])) {
              if (!bc.read(p[7])) {
                val = 5;
                val += bc.read(kPcat1[0]);
              } else {
                val = 7;
                int ev = 0;
                for (int t = 0; t < 2; t++) ev = (ev << 1) | bc.read(kPcat2[t]);
                val += ev;
              }
            } else if (!bc.read(p[8])) {
              if (!bc.read(p[9])) {
                val = 11;
                int ev = 0;
                for (int t = 0; t < 3; t++) ev = (ev << 1) | bc.read(kPcat3[t]);
                val += ev;
              } else {
                val = 19;
                int ev = 0;
                for (int t = 0; t < 4; t++) ev = (ev << 1) | bc.read(kPcat4[t]);
                val += ev;
              }
            } else if (!bc.read(p[10])) {
              val = 35;
              int ev = 0;
              for (int t = 0; t < 5; t++) ev = (ev << 1) | bc.read(kPcat5[t]);
              val += ev;
            } else {
              val = 67;
              int ev = 0;
              for (int t = 0; t < 11; t++) ev = (ev << 1) | bc.read(kPcat6[t]);
              val += ev;
            }
          }
          if (bc.read_sign_det()) val = -val;
          qb[kZigzag[cpos]] = (int16_t)val;
          if (cpos == 15) break;  // eob stays 15 (detokenize.c exit path)
          cpos++;
        }
        e[i] = cpos;
        eobtotal += cpos;
      }
      if (eobtotal == 0) skip[n] = 1;
    }
  }
  delete[] above;
  return 0;
}

}  // extern "C"
