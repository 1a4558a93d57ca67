// Host mode/MV pack runtime: the per-MB mode section of partition 0 in
// C++ (the vp8_pack_inter_mode_mvs / write_kfmodes role, ref:
// vp8/encoder/bitstream.c:846-1100), plus the MV->coding-mode mapping
// and the dry counting pass that feeds the mode/MV probability updates.
//
// The Python implementation in models/encoder.py (_pack_mb_modes,
// _find_near, _write_mv, _count_mv_component) stays as the golden
// reference; this walk is differential-tested byte-exact against it.
#include <cstdint>
#include <cstring>
#include <vector>

#include "vp8_tables.h"

namespace {

const int B_PRED_M = 4;
const int ZEROMV_M = 7;
const int NEARESTMV_M = 5;
const int NEARMV_M = 6;
const int NEWMV_M = 8;
const int SPLITMV_M = 9;
const int INTRA_FRAME = 0;
const int LAST_FRAME = 1;
const int GOLDEN_FRAME = 2;

// decodemv.c:224 (indexed by (aez<<2)|(lez<<1)|lea)
const uint8_t kSubMvRefProb3[8][3] = {
    {147, 136, 18}, {223, 1, 34}, {106, 145, 1}, {208, 1, 1},
    {179, 121, 1}, {223, 1, 34}, {179, 121, 1}, {208, 1, 1}};
const int8_t kMbSplitOffset[4][16] = {
    {0, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 2, 8, 10, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
// findnearmv.h:129-182 (16x16 mode -> B mode for keyframe bmode context)
const int8_t kModeToBmode[4] = {0, 2, 3, 1};  // DC,V,H,TM -> B_DC,B_VE,B_HE,B_TM

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
};

// generic tree token write (dual of vp8_treed_read): DFS to the leaf
// -value, emitting branch bits with probs[node>>1]
bool tree_dfs(const int8_t* tree, int node, int value, BoolEnc* e,
              const uint8_t* probs, std::vector<std::pair<int, int>>* path) {
  for (int bit = 0; bit < 2; bit++) {
    int nxt = tree[node + bit];
    if (nxt <= 0) {
      if (-nxt == value) {
        path->push_back({node, bit});
        return true;
      }
    } else {
      path->push_back({node, bit});
      if (tree_dfs(tree, nxt, value, e, probs, path)) return true;
      path->pop_back();
    }
  }
  return false;
}

inline void write_tree(BoolEnc& e, const int8_t* tree, const uint8_t* probs,
                       int value) {
  std::vector<std::pair<int, int>> path;
  tree_dfs(tree, 0, value, &e, probs, &path);
  for (auto& nb : path) e.put(nb.second, probs[nb.first >> 1]);
}

struct MvStats {
  int64_t sign[2];
  int64_t short_flag[2];
  int64_t shortc[8];
  int64_t bits[10][2];
};

struct Ctx {
  int R, C;
  const int32_t* mode;   // [(R+1)*(C+1)]
  const int32_t* reff;   // [(R+1)*(C+1)]
  const int32_t* mv;     // [(R+1)*(C+1)*2]
  const int32_t* bmode;  // [(R+1)*(C+1)*16]
  const int32_t* bmv;    // [(R+1)*(C+1)*16*2]
  const int32_t* split_part;  // [R*C]
  const int32_t* skip;        // [R*C]
  const int32_t* segmap;      // [R*C] (has_segmap)
  int has_segmap;
  const uint8_t* seg_tree_probs;  // [3]
  int mb_no_coeff_skip;
  int prob_skip_false, prob_intra, prob_last, prob_gf;
  const uint8_t* ymode_prob;    // [4]
  const uint8_t* uv_mode_prob;  // [3]
  const int32_t* uvmode;        // [R*C]
  const uint8_t* mvc;           // [2*19]
  // counting outputs (dry pass)
  int64_t* ymode_ct;  // [5]
  int64_t* uv_ct;     // [4]
  MvStats* mvstats;   // [2]
  // set by write_mv on an odd delta, which the format cannot carry
  mutable bool odd_mv;

  inline int gmode(int pr, int pc) const { return mode[pr * (C + 1) + pc]; }
  inline int gref(int pr, int pc) const { return reff[pr * (C + 1) + pc]; }
  inline const int32_t* gmv(int pr, int pc) const {
    return mv + (pr * (C + 1) + pc) * 2;
  }
  inline int gbmode(int pr, int pc, int b) const {
    return bmode[(pr * (C + 1) + pc) * 16 + b];
  }
  inline const int32_t* gbmv(int pr, int pc, int b) const {
    return bmv + ((pr * (C + 1) + pc) * 16 + b) * 2;
  }
};

// vp8_find_near_mvs + mv_ref_probs (findnearmv.c:24-140); identical
// lattice to models/encoder.py _find_near.
void find_near(const Ctx& g, int r, int c, int near_out[2], int nearest_out[2],
               int best_out[2], uint8_t probs[4]) {
  const int pr = r + 1, pc = c + 1;
  int near_mvs[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
  int cnt[4] = {0, 0, 0, 0};
  int cntx = 0;
  int nmv = 0;
  const int nr[3] = {pr - 1, pr, pr - 1};
  const int nc[3] = {pc, pc - 1, pc - 1};
  const int w[3] = {2, 2, 1};
  for (int idx = 0; idx < 3; idx++) {
    int nref = g.gref(nr[idx], nc[idx]);
    const int32_t* m = g.gmv(nr[idx], nc[idx]);
    if (nref != INTRA_FRAME) {
      if (m[0] != 0 || m[1] != 0) {
        if (idx == 0) {
          nmv++;
          near_mvs[nmv][0] = m[0];
          near_mvs[nmv][1] = m[1];
          cntx++;
        } else {
          if (m[0] != near_mvs[nmv][0] || m[1] != near_mvs[nmv][1]) {
            nmv++;
            near_mvs[nmv][0] = m[0];
            near_mvs[nmv][1] = m[1];
            cntx++;
          }
        }
        cnt[cntx] += w[idx];
      } else {
        cnt[0] += w[idx];
      }
    }
  }
  if (cnt[3] && near_mvs[nmv][0] == near_mvs[1][0] &&
      near_mvs[nmv][1] == near_mvs[1][1])
    cnt[1] += 1;
  cnt[3] = ((g.gmode(pr - 1, pc) == SPLITMV_M) +
            (g.gmode(pr, pc - 1) == SPLITMV_M)) * 2 +
           (g.gmode(pr - 1, pc - 1) == SPLITMV_M);
  if (cnt[2] > cnt[1]) {
    std::swap(cnt[1], cnt[2]);
    std::swap(near_mvs[1][0], near_mvs[2][0]);
    std::swap(near_mvs[1][1], near_mvs[2][1]);
  }
  if (cnt[1] >= cnt[0]) {
    near_mvs[0][0] = near_mvs[1][0];
    near_mvs[0][1] = near_mvs[1][1];
  }
  const int MARGIN = 16 << 3;
  const int lo_c = -(c * 16 << 3) - MARGIN,
            hi_c = ((g.C - 1 - c) * 16 << 3) + MARGIN;
  const int lo_r = -(r * 16 << 3) - MARGIN,
            hi_r = ((g.R - 1 - r) * 16 << 3) + MARGIN;
  auto clampv = [&](const int in[2], int out[2]) {
    out[0] = in[0] < lo_r ? lo_r : (in[0] > hi_r ? hi_r : in[0]);
    out[1] = in[1] < lo_c ? lo_c : (in[1] > hi_c ? hi_c : in[1]);
  };
  clampv(near_mvs[2], near_out);
  clampv(near_mvs[1], nearest_out);
  clampv(near_mvs[0], best_out);
  for (int i = 0; i < 4; i++) probs[i] = (uint8_t)kModeContexts[cnt[i]][i];
}

inline void count_mv_component(MvStats& st, int v) {
  int x = v < 0 ? -v : v;
  if (v > 0)
    st.sign[0]++;
  else if (v < 0)
    st.sign[1]++;
  if (x < 8) {
    st.short_flag[0]++;
    st.shortc[x]++;
  } else {
    st.short_flag[1]++;
    for (int k = 0; k < 10; k++) st.bits[k][(x >> k) & 1]++;
  }
}

// dual of read_mvcomponent (decodemv.c:76-107); delta in 1/8 units, even
// (the Python golden asserts it): an odd one would be counted as
// delta >> 1 but written as |delta| >> 1, so it is refused (g.odd_mv)
void write_mv(const Ctx& g, BoolEnc* e, int delta, int comp, bool counting) {
  if (delta & 1) {
    g.odd_mv = true;
    return;
  }
  if (counting && g.mvstats) count_mv_component(g.mvstats[comp], delta >> 1);
  if (!e) return;
  int x = (delta < 0 ? -delta : delta) >> 1;
  const uint8_t* p = g.mvc + comp * 19;
  const int MVPsign = 1, MVPshort = 2, MVPbits = 9;
  if (x < 8) {
    e->put(0, p[0]);
    write_tree(*e, kSmallMvTree, p + MVPshort, x);
  } else {
    e->put(1, p[0]);
    for (int i = 0; i < 3; i++) e->put((x >> i) & 1, p[MVPbits + i]);
    for (int i = 9; i > 3; i--) e->put((x >> i) & 1, p[MVPbits + i]);
    if (x & 0xFFF0) e->put((x >> 3) & 1, p[MVPbits + 3]);
  }
  if (x) e->put(delta < 0 ? 1 : 0, p[MVPsign]);
}

inline int above_bmode(const Ctx& g, int pr, int pc, int b) {
  if (b < 4) {
    int m = g.gmode(pr - 1, pc);
    if (m == B_PRED_M) return g.gbmode(pr - 1, pc, b + 12);
    return (m >= 0 && m < 4) ? kModeToBmode[m] : 0;
  }
  return g.gbmode(pr, pc, b - 4);
}

inline int left_bmode(const Ctx& g, int pr, int pc, int b) {
  if (b % 4 == 0) {
    int m = g.gmode(pr, pc - 1);
    if (m == B_PRED_M) return g.gbmode(pr, pc - 1, b + 3);
    return (m >= 0 && m < 4) ? kModeToBmode[m] : 0;
  }
  return g.gbmode(pr, pc, b - 1);
}

inline void above_bmv(const Ctx& g, int pr, int pc, int b, int out[2]) {
  if (b < 4) {
    if (g.gmode(pr - 1, pc) != SPLITMV_M) {
      const int32_t* m = g.gmv(pr - 1, pc);
      out[0] = m[0];
      out[1] = m[1];
    } else {
      const int32_t* m = g.gbmv(pr - 1, pc, b + 12);
      out[0] = m[0];
      out[1] = m[1];
    }
    return;
  }
  const int32_t* m = g.gbmv(pr, pc, b - 4);
  out[0] = m[0];
  out[1] = m[1];
}

inline void left_bmv(const Ctx& g, int pr, int pc, int b, int out[2]) {
  if (b % 4 == 0) {
    if (g.gmode(pr, pc - 1) != SPLITMV_M) {
      const int32_t* m = g.gmv(pr, pc - 1);
      out[0] = m[0];
      out[1] = m[1];
    } else {
      const int32_t* m = g.gbmv(pr, pc - 1, b + 3);
      out[0] = m[0];
      out[1] = m[1];
    }
    return;
  }
  const int32_t* m = g.gbmv(pr, pc, b - 1);
  out[0] = m[0];
  out[1] = m[1];
}

// one MB's mode section (dual of _pack_mb_modes); e==nullptr -> dry
// counting pass
void pack_mb_modes(const Ctx& g, BoolEnc* e, int r, int c, int keyframe,
                   bool counting) {
  const int pr = r + 1, pc = c + 1;
  const int mode = g.gmode(pr, pc);
  if (g.has_segmap && e) {
    int seg = g.segmap[r * g.C + c];
    const uint8_t* p = g.seg_tree_probs;
    if (seg < 2) {
      e->put(0, p[0]);
      e->put(seg, p[1]);
    } else {
      e->put(1, p[0]);
      e->put(seg - 2, p[2]);
    }
  }
  if (g.mb_no_coeff_skip && e)
    e->put(g.skip[r * g.C + c], g.prob_skip_false);
  if (keyframe) {
    if (!e) return;
    write_tree(*e, kKfYmodeTree, kKfYmodeProb, mode);
    if (mode == B_PRED_M) {
      for (int i = 0; i < 16; i++) {
        int a = above_bmode(g, pr, pc, i);
        int l = left_bmode(g, pr, pc, i);
        write_tree(*e, kBmodeTree, kKfBmodeProb[a][l],
                   g.gbmode(pr, pc, i));
      }
    }
    write_tree(*e, kUvModeTree, kKfUvModeProb, g.uvmode[r * g.C + c]);
    return;
  }
  const int is_inter = g.gref(pr, pc) != INTRA_FRAME;
  if (e) e->put(is_inter ? 1 : 0, g.prob_intra);
  if (!is_inter) {
    if (counting) {
      if (g.ymode_ct) g.ymode_ct[mode]++;
      if (g.uv_ct) g.uv_ct[g.uvmode[r * g.C + c]]++;
    }
    if (!e) return;
    write_tree(*e, kYmodeTree, g.ymode_prob, mode);
    if (mode == B_PRED_M)
      for (int i = 0; i < 16; i++)
        write_tree(*e, kBmodeTree, kBmodeProb, g.gbmode(pr, pc, i));
    write_tree(*e, kUvModeTree, g.uv_mode_prob, g.uvmode[r * g.C + c]);
    return;
  }
  const int ref_used = g.gref(pr, pc);
  if (e) {
    if (ref_used == LAST_FRAME) {
      e->put(0, g.prob_last);
    } else {
      e->put(1, g.prob_last);
      e->put(ref_used == GOLDEN_FRAME ? 0 : 1, g.prob_gf);
    }
  }
  int nearv[2], nearestv[2], best[2];
  uint8_t probs[4];
  find_near(g, r, c, nearv, nearestv, best, probs);
  const int32_t* mvv = g.gmv(pr, pc);
  if (mode == ZEROMV_M) {
    if (e) e->put(0, probs[0]);
  } else if (mode == NEARESTMV_M) {
    if (e) {
      e->put(1, probs[0]);
      e->put(0, probs[1]);
    }
  } else if (mode == NEARMV_M) {
    if (e) {
      e->put(1, probs[0]);
      e->put(1, probs[1]);
      e->put(0, probs[2]);
    }
  } else if (mode == NEWMV_M) {
    if (e) {
      e->put(1, probs[0]);
      e->put(1, probs[1]);
      e->put(1, probs[2]);
      e->put(0, probs[3]);
    }
    write_mv(g, e, mvv[0] - best[0], 0, counting);
    write_mv(g, e, mvv[1] - best[1], 1, counting);
  } else {  // SPLITMV (decode_split_mv dual, decodemv.c:250-318)
    if (e) {
      e->put(1, probs[0]);
      e->put(1, probs[1]);
      e->put(1, probs[2]);
      e->put(1, probs[3]);
    }
    int s_ = g.split_part[r * g.C + c];
    if (e) write_tree(*e, kMbSplitTree, kMbSplitProbs, s_);
    int num_p = kMbSplitCount[s_];
    for (int j = 0; j < num_p; j++) {
      int k = kMbSplitOffset[s_][j];
      const int32_t* blockmv = g.gbmv(pr, pc, k);
      int lmv[2], amv[2];
      left_bmv(g, pr, pc, k, lmv);
      above_bmv(g, pr, pc, k, amv);
      bool lez = lmv[0] == 0 && lmv[1] == 0;
      bool aez = amv[0] == 0 && amv[1] == 0;
      bool lea = lmv[0] == amv[0] && lmv[1] == amv[1];
      const uint8_t* prob =
          kSubMvRefProb3[((int)aez << 2) | ((int)lez << 1) | (int)lea];
      if (blockmv[0] == lmv[0] && blockmv[1] == lmv[1]) {
        if (e) e->put(0, prob[0]);
      } else if (blockmv[0] == amv[0] && blockmv[1] == amv[1]) {
        if (e) {
          e->put(1, prob[0]);
          e->put(0, prob[1]);
        }
      } else if (blockmv[0] == 0 && blockmv[1] == 0) {
        if (e) {
          e->put(1, prob[0]);
          e->put(1, prob[1]);
          e->put(0, prob[2]);
        }
      } else {
        if (e) {
          e->put(1, prob[0]);
          e->put(1, prob[1]);
          e->put(1, prob[2]);
        }
        write_mv(g, e, blockmv[0] - best[0], 0, counting);
        write_mv(g, e, blockmv[1] - best[1], 1, counting);
      }
    }
  }
}

void fill_ctx(Ctx& g, int R, int C, const int32_t* mode, const int32_t* reff,
              const int32_t* mv, const int32_t* bmode, const int32_t* bmv,
              const int32_t* split_part, const int32_t* skip,
              const int32_t* uvmode, const int32_t* segmap, int has_segmap,
              const uint8_t* seg_tree_probs, int mb_no_coeff_skip,
              int prob_skip_false, int prob_intra, int prob_last, int prob_gf,
              const uint8_t* ymode_prob, const uint8_t* uv_mode_prob,
              const uint8_t* mvc) {
  g.R = R;
  g.C = C;
  g.mode = mode;
  g.reff = reff;
  g.mv = mv;
  g.bmode = bmode;
  g.bmv = bmv;
  g.split_part = split_part;
  g.skip = skip;
  g.uvmode = uvmode;
  g.segmap = segmap;
  g.has_segmap = has_segmap;
  g.seg_tree_probs = seg_tree_probs;
  g.mb_no_coeff_skip = mb_no_coeff_skip;
  g.prob_skip_false = prob_skip_false;
  g.prob_intra = prob_intra;
  g.prob_last = prob_last;
  g.prob_gf = prob_gf;
  g.ymode_prob = ymode_prob;
  g.uv_mode_prob = uv_mode_prob;
  g.mvc = mvc;
  g.ymode_ct = nullptr;
  g.uv_ct = nullptr;
  g.mvstats = nullptr;
  g.odd_mv = false;
}

}  // namespace

extern "C" {

// MV -> cheapest coding mode mapping for inter MBs (the reference's
// rd_pick_inter_mode chooses modes directly; the batched TPU decision
// emits MVs, mapped here by the exact near-MV lattice).  mode grid is
// updated in place: ZEROMV/NEARESTMV/NEARMV/NEWMV.
int vp8e_map_mv_modes(int R, int C, int32_t* mode, const int32_t* reff,
                      const int32_t* mv, const int32_t* bmode,
                      const int32_t* bmv, const int32_t* split_part,
                      const int32_t* skip) {
  Ctx g;
  fill_ctx(g, R, C, mode, reff, mv, bmode, bmv, split_part, skip, nullptr,
           nullptr, 0, nullptr, 0, 0, 0, 0, 0, nullptr, nullptr, nullptr);
  for (int r = 0; r < R; r++)
    for (int c = 0; c < C; c++) {
      const int pr = r + 1, pc = c + 1;
      if (g.gref(pr, pc) == INTRA_FRAME) continue;
      if (mode[pr * (C + 1) + pc] == SPLITMV_M) continue;
      const int32_t* mvv = g.gmv(pr, pc);
      int newmode;
      if (mvv[0] == 0 && mvv[1] == 0) {
        newmode = ZEROMV_M;
      } else {
        int nearv[2], nearestv[2], best[2];
        uint8_t probs[4];
        find_near(g, r, c, nearv, nearestv, best, probs);
        if (mvv[0] == nearestv[0] && mvv[1] == nearestv[1])
          newmode = NEARESTMV_M;
        else if (mvv[0] == nearv[0] && mvv[1] == nearv[1])
          newmode = NEARMV_M;
        else
          newmode = NEWMV_M;
      }
      mode[pr * (C + 1) + pc] = newmode;
    }
  return 0;
}

// Dry counting pass over the mode section (inter frames): accumulates
// ymode[5]/uv[4] histograms and per-component MV event stats
// (MVcount role feeding vp8_write_mvprobs).  mvstats layout per comp:
// [sign0, sign1, short0, short1, shortc[8], bits[10][2]] = 32 int64.
// Returns -2 if an MV delta is odd, else 0.
int vp8e_count_modes(int R, int C, const int32_t* mode, const int32_t* reff,
                     const int32_t* mv, const int32_t* bmode,
                     const int32_t* bmv, const int32_t* split_part,
                     const int32_t* skip, const int32_t* uvmode,
                     int64_t* ymode_ct, int64_t* uv_ct, int64_t* mvstats) {
  Ctx g;
  fill_ctx(g, R, C, mode, reff, mv, bmode, bmv, split_part, skip, uvmode,
           nullptr, 0, nullptr, 0, 0, 0, 0, 0, nullptr, nullptr, nullptr);
  MvStats st[2];
  std::memset(st, 0, sizeof(st));
  g.ymode_ct = ymode_ct;
  g.uv_ct = uv_ct;
  g.mvstats = st;
  for (int r = 0; r < R; r++)
    for (int c = 0; c < C; c++) pack_mb_modes(g, nullptr, r, c, 0, true);
  for (int comp = 0; comp < 2; comp++) {
    int64_t* o = mvstats + comp * 32;
    o[0] = st[comp].sign[0];
    o[1] = st[comp].sign[1];
    o[2] = st[comp].short_flag[0];
    o[3] = st[comp].short_flag[1];
    for (int i = 0; i < 8; i++) o[4 + i] = st[comp].shortc[i];
    for (int k = 0; k < 10; k++) {
      o[12 + 2 * k] = st[comp].bits[k][0];
      o[12 + 2 * k + 1] = st[comp].bits[k][1];
    }
  }
  return g.odd_mv ? -2 : 0;
}

// Real mode-section pack, continuing an in-progress partition-0 bool
// encoder.  state = [lowvalue, range, count, buf_len in/out]; buf holds
// the bytes emitted so far and receives the appended section (caller
// provides buf_cap headroom; returns -1 on overflow, -2 if an MV delta is
// odd).
int64_t vp8e_pack_modes(int R, int C, int keyframe, const int32_t* mode,
                        const int32_t* reff, const int32_t* mv,
                        const int32_t* bmode, const int32_t* bmv,
                        const int32_t* split_part, const int32_t* skip,
                        const int32_t* uvmode, const int32_t* segmap,
                        int has_segmap, const uint8_t* seg_tree_probs,
                        int mb_no_coeff_skip, int prob_skip_false,
                        int prob_intra, int prob_last, int prob_gf,
                        const uint8_t* ymode_prob, const uint8_t* uv_mode_prob,
                        const uint8_t* mvc, uint8_t* buf, int64_t buf_cap,
                        int64_t* state) {
  Ctx g;
  fill_ctx(g, R, C, mode, reff, mv, bmode, bmv, split_part, skip, uvmode,
           segmap, has_segmap, seg_tree_probs, mb_no_coeff_skip,
           prob_skip_false, prob_intra, prob_last, prob_gf, ymode_prob,
           uv_mode_prob, mvc);
  BoolEnc e;
  e.lowvalue = (uint32_t)state[0];
  e.range = (uint32_t)state[1];
  e.count = (int)state[2];
  int64_t len = state[3];
  e.buf.assign(buf, buf + len);
  for (int r = 0; r < R; r++)
    for (int c = 0; c < C; c++)
      pack_mb_modes(g, &e, r, c, keyframe, false);
  if (g.odd_mv) return -2;
  if ((int64_t)e.buf.size() > buf_cap) return -1;
  std::memcpy(buf, e.buf.data(), e.buf.size());
  state[0] = e.lowvalue;
  state[1] = e.range;
  state[2] = e.count;
  state[3] = (int64_t)e.buf.size();
  return (int64_t)e.buf.size();
}

}  // extern "C"
