// K3: exhaustive full-pel SAD grid of the encoder's motion search.
//
// Replaces the Pallas TPU kernel libvpx_opencl_tpu/ops/me_pallas.py
// (_sad_kernel / sad_grid_pallas): for every macroblock, the sum of absolute
// differences between its 16x16 source block and the reference at each of
// the (2*rng+1)^2 full-pel offsets of a (2*rng+16)^2 window
// (vp8_full_search_sad, mcomp.c:1295).
//
// What bounds it on an H100: operations. At 1080p (8160 MBs, rng 16) the
// grid is 8160 x 1089 x 256 absolute differences of about three integer
// operations each, against a few tens of megabytes moved. The TPU kernel
// put 128 MBs on the lane axis and walked a static column correlation
// because its compiler has no dynamic sublane slice; none of that carries
// over. Here one thread block owns one MB: it stages the MB's window
// (bytes, read straight from the bordered reference plane, so no gathered
// [N,48,48] tensor exists) and its source block in shared memory, and its
// threads share out the offsets, each summing 256 differences in int32.
// Threads of a warp read neighbouring window bytes and the same source
// word (a broadcast), so shared memory serves both without conflicts.
//
// Output order is (dy, dx) = (-rng + i, -rng + j) at out[n][i][j]: the
// step-1 grid order of ops/me.py, whose shared penalty + argmin code runs
// after this kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sad_grid_kernel(const uint8_t* __restrict__ plane, int stride,
                                const int* __restrict__ wy,
                                const int* __restrict__ wx,
                                const int* __restrict__ src,
                                int* __restrict__ out, int rng) {
    extern __shared__ int smem[];
    int* s_src = smem;                                      // [16*16] int32
    uint8_t* s_win = reinterpret_cast<uint8_t*>(smem + 256);  // [w*w] bytes
    const int n = blockIdx.x;
    const int w = 2 * rng + 16;
    const int n_c = 2 * rng + 1;

    const uint8_t* base = plane + (size_t)wy[n] * stride + wx[n];
    for (int k = threadIdx.x; k < w * w; k += blockDim.x) {
        int r = k / w, c = k - r * w;
        s_win[k] = base[(size_t)r * stride + c];
    }
    for (int k = threadIdx.x; k < 256; k += blockDim.x)
        s_src[k] = src[(size_t)n * 256 + k];
    __syncthreads();

    int* o = out + (size_t)n * n_c * n_c;
    for (int k = threadIdx.x; k < n_c * n_c; k += blockDim.x) {
        int i = k / n_c, j = k - i * n_c;
        const uint8_t* p = s_win + i * w + j;
        int sad = 0;
        for (int r = 0; r < 16; ++r) {
#pragma unroll
            for (int c = 0; c < 16; ++c)
                sad += abs((int)p[r * w + c] - s_src[r * 16 + c]);
        }
        o[k] = sad;
    }
}

}  // namespace

// plane: uint8 reference plane (row stride `stride` bytes); wy, wx [n]:
// top-left of each MB's window in the plane (the caller guarantees that
// the whole window lies inside it); src [n,16,16] int32; out
// [n, 2*rng+1, 2*rng+1] int32. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int sad_grid(const void* plane, int stride, const void* wy,
                        const void* wx, const void* src, void* out, int n,
                        int rng, void* stream) {
    const int w = 2 * rng + 16;
    const size_t shared = 256 * sizeof(int) + (size_t)w * w;
    sad_grid_kernel<<<n, 256, shared, (cudaStream_t)stream>>>(
        (const uint8_t*)plane, stride, (const int*)wy, (const int*)wx,
        (const int*)src, (int*)out, rng);
    return (int)cudaGetLastError();
}
