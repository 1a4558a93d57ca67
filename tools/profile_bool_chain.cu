// The bool decoder's read chain alone, one thread, for
// tools/profile_bool_chain.py: what a serial read costs on the card without
// the detokenizer around it. read_bool is K4's own (csrc/boolread.cuh).
#include <cstdint>
#include <cuda_runtime.h>

#include "boolread.cuh"

namespace {

// mode 0: a fixed probability; 1: the probability loaded from shared
// memory at an index made of the last bit (a dependent load per read, as
// the token tree's); 2: a branch on the last bit picks the probability
__global__ void chain(const uint8_t* buf, int blen, int n, int mode,
                      const int* table, int* out) {
  __shared__ int t[16];
  if (threadIdx.x < 16) t[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  if (threadIdx.x != 0) return;
  boolread::BoolDecoder s{buf, blen - 1, blen, 0, 255, -8, 0};
  int ones = 0, bit = 0;
  for (int i = 0; i < n; ++i) {
    if (mode == 0)
      bit = boolread::read_bool(s, 200);
    else if (mode == 1)
      bit = boolread::read_bool(s, t[(bit << 3) | (i & 7)]);
    else if (bit)
      bit = boolread::read_bool(s, 180);
    else
      bit = boolread::read_bool(s, 60);
    ones += bit;
  }
  out[0] = ones;
  out[1] = s.pos;
}

}  // namespace

extern "C" int bool_chain(const void* buf, int blen, int n, int mode,
                          const void* table, void* out, void* stream) {
  if (mode < 0 || mode > 2 || n < 0 || blen < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  chain<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), blen, n, mode,
      static_cast<const int*>(table), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
