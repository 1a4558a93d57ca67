// The bool decoder's read chain alone, one thread, for
// tools/profile_bool_chain.py: what a serial read costs on the card without
// the detokenizer around it. The reads are K4's own (csrc/boolread.cuh):
// read_bool<false>, the exact form (K4 before its redesign and its
// fall-back), and read_bool<true>, the fast form K4 runs.
#include <cstdint>
#include <cuda_runtime.h>

#include "boolread.cuh"

namespace {

// mode 0: the exact read, a fixed probability; 1: the exact read, the
// probability loaded from shared memory at an index made of the last bit
// (a dependent load per read, as the old token tree's); 2: the exact read,
// a branch on the last bit picks the probability; 3: the fast read, a
// fixed probability; 4: the fast read, a select on the last bit picks the
// probability from registers (the new token tree's)
__global__ void chain(const uint8_t* buf, int blen, int n, int mode,
                      const int* table, int* out) {
  __shared__ int t[16];
  if (threadIdx.x < 16) t[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  if (threadIdx.x != 0) return;
  boolread::BoolDecoder s{buf, blen - 1, blen, 0, 255, -8, 0};
  int ones = 0, bit = 0;
  if (mode >= 3) {
    boolread::start(s);
    const int pa = t[3], pb = t[12];
    if (mode == 3) {
      for (int i = 0; i < n; ++i) {
        bit = boolread::read_bool<true>(s, 200);
        ones += bit;
      }
    } else {
      for (int i = 0; i < n; ++i) {
        bit = boolread::read_bool<true>(s, bit ? pa : pb);
        ones += bit;
      }
    }
  } else {
    for (int i = 0; i < n; ++i) {
      if (mode == 0)
        bit = boolread::read_bool<false>(s, 200);
      else if (mode == 1)
        bit = boolread::read_bool<false>(s, t[(bit << 3) | (i & 7)]);
      else if (bit)
        bit = boolread::read_bool<false>(s, 180);
      else
        bit = boolread::read_bool<false>(s, 60);
      ones += bit;
    }
  }
  out[0] = ones;
  out[1] = s.pos;
}

}  // namespace

extern "C" int bool_chain(const void* buf, int blen, int n, int mode,
                          const void* table, void* out, void* stream) {
  if (mode < 0 || mode > 4 || n < 0 || blen < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  chain<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), blen, n, mode,
      static_cast<const int*>(table), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
