// K3: exhaustive full-pel SAD grid of the encoder's motion search.
//
// Replaces the Pallas TPU kernel libvpx_opencl_tpu/ops/me_pallas.py
// (_sad_kernel / sad_grid_pallas): for every macroblock, the sum of absolute
// differences between its 16x16 source block and the reference at each of
// the (2*rng+1)^2 full-pel offsets of a (2*rng+16)^2 window
// (vp8_full_search_sad, mcomp.c:1295).
//
// What bounds it on an H100: operations. At 1080p (8160 MBs, rng 16) the
// grid is 8160 x 1089 x 256 = 2.27e9 absolute differences against a few
// tens of megabytes moved: at three operations per pixel over the FP32
// rate (67e12/s) the bound is 0.102 ms. The TPU kernel put 128 MBs on the
// lane axis and walked a static column correlation because its compiler
// has no dynamic sublane slice; none of that carries over. Scalar int32
// code (a thread per offset, a pixel per step, two shared-memory loads per
// pixel) issues at a quarter of the FP32 rate and cannot come near the
// bound, so this kernel works on packed bytes:
//
//  * The source block is packed once per MB into 64 little-endian words
//    (4 pixels each) in shared memory, one row = one 16-byte uint4 that all
//    threads of the MB read as a broadcast. The caller guarantees values in
//    [0, 255]. The per-MB stride is 17 uint4, so two MBs of one warp fall
//    on different banks.
//  * Windows are staged byte by byte from the bordered plane (wx is
//    arbitrary; ~2.3 KB per MB, small beside the compute) with a row pitch
//    that is a multiple of 16 bytes, so every window word a thread reads is
//    an aligned 32-bit load. Pitch padding and a tail are zero-filled; they
//    are read only into offsets that are never stored.
//  * Register blocking: a thread owns one dy and a run of K = 11
//    consecutive dx (at rng 16: 33 dy x 3 groups = 99 threads per MB, no
//    ragged tail; other radii keep a ragged last group whose extra offsets
//    are computed and dropped). Per window row it loads the 8 words that
//    cover its 26 bytes once, aligns them to its first dx with one funnel
//    shift each, and forms the 4 words of each of its K offsets with
//    compile-time funnel shifts (shared between offsets by the compiler).
//  * Each packed step is `__vabsdiffu4` (SASS VABSDIFF4: four byte
//    absolute differences) and `__dp4a(d, 0x01010101, acc)` (IDP: their
//    sum into a 32-bit accumulator; a SAD reaches 255 * 256 = 65280). No
//    shared-memory load per pixel. The one-instruction form
//    `vabsdiff4.u32.u32.u32.add` is also one SASS VABSDIFF4 (1600
//    instructions in the kernel against 2304 with the IDPs), but on an
//    H100 it ran slower (0.174 against 0.156 ms per 1080p launch, timed in
//    turns in one process). At 0.156 ms the card retires one VABSDIFF4
//    warp instruction per ~8-9 clocks per SM sub-partition (704 per thread,
//    the rest of the kernel's instructions fit in the issue slots between),
//    so that pipe sets the time, and the IDPs run beside it.
//
// The geometry (threads per MB, K, groups, MBs per block, pitch, shared
// bytes) comes from ops/me_sad.py:_plan, which the CPU tests check; the
// entry point refuses a plan this build cannot run.
//
// Output order is (dy, dx) = (-rng + i, -rng + j) at out[n][i][j]: the
// step-1 grid order of ops/me.py, whose shared penalty + argmin code runs
// after this kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 11;                  // dx offsets per thread
constexpr int NA = (K + 14) / 4 + 1;   // aligned words a row run needs
constexpr int NW = NA + 1;             // words loaded per row (any j0 & 3)
constexpr int SRC_PITCH = 17;          // uint4 per MB's packed source
constexpr int MAX_THREADS = 512;
constexpr int MAX_SHARED = 48 * 1024;

// acc + |a0-b0| + |a1-b1| + |a2-b2| + |a3-b3| over the four bytes
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
    return __dp4a(__vabsdiffu4(a, b), 0x01010101u, acc);
}

__global__ void __launch_bounds__(MAX_THREADS, 2)
sad_grid_kernel(const uint8_t* __restrict__ plane, int stride,
                const int* __restrict__ wy, const int* __restrict__ wx,
                const int* __restrict__ src, int* __restrict__ out, int n,
                int rng, int groups, int mbs, int pitch, int shared) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int n_c = 2 * rng + 1;
    const int w = n_c + 15;
    const int tpm = n_c * groups;
    const int n0 = blockIdx.x * mbs;
    const int nm = min(mbs, n - n0);
    uint4* s_src = reinterpret_cast<uint4*>(smem);       // [mbs][SRC_PITCH]
    uint8_t* s_win = smem + mbs * SRC_PITCH * 16;        // [mbs][w][pitch]

    // -- stage: packed source words, then windows (+ zero tail) ----------
    uint32_t* s_srcw = reinterpret_cast<uint32_t*>(s_src);
    for (int e = threadIdx.x; e < mbs * 64; e += blockDim.x) {
        const int m = e >> 6, q = e & 63;
        uint32_t v = 0;
        if (m < nm) {
            const int* p = src + (size_t)(n0 + m) * 256 + 4 * q;
            v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
        }
        s_srcw[m * SRC_PITCH * 4 + q] = v;
    }
    // a window row per full warp (a partial last warp lacks lanes)
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    for (int row = warp; warp < n_warps && row < mbs * w; row += n_warps) {
        const int m = row / w, r = row - m * w;
        uint8_t* dst = s_win + (size_t)row * pitch;
        const uint8_t* base = m < nm
            ? plane + (size_t)(wy[n0 + m] + r) * stride + wx[n0 + m]
            : nullptr;
        for (int c = lane; c < pitch; c += 32)
            dst[c] = (base != nullptr && c < w) ? base[c] : 0;
    }
    for (int c = threadIdx.x + mbs * w * pitch;
         c < shared - mbs * SRC_PITCH * 16; c += blockDim.x)
        s_win[c] = 0;
    __syncthreads();

    // -- one dy, K consecutive dx per thread ------------------------------
    const int m = threadIdx.x / tpm;
    if (m >= nm) return;
    const int l = threadIdx.x - m * tpm;
    const int i = l / groups;
    const int j0 = (l - i * groups) * K;
    const unsigned sh = 8u * (j0 & 3);
    const uint32_t* wrow = reinterpret_cast<const uint32_t*>(
        s_win + ((size_t)m * w + i) * pitch) + (j0 >> 2);
    const int pw = pitch >> 2;
    const uint4* srow = s_src + m * SRC_PITCH;

    uint32_t acc[K];
#pragma unroll
    for (int t = 0; t < K; ++t) acc[t] = 0;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        const uint4 sv = srow[r];
        const uint32_t s4[4] = {sv.x, sv.y, sv.z, sv.w};
        uint32_t wv[NW];
#pragma unroll
        for (int q = 0; q < NW; ++q) wv[q] = wrow[r * pw + q];
        // a[q]: window bytes j0 + 4q .. j0 + 4q + 3 of this row
        uint32_t a[NA];
#pragma unroll
        for (int q = 0; q < NA; ++q)
            a[q] = __funnelshift_r(wv[q], wv[q + 1], sh);
#pragma unroll
        for (int t = 0; t < K; ++t) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int b = (t >> 2) + q;
                const uint32_t x = (t & 3)
                    ? __funnelshift_r(a[b], a[b + 1], 8 * (t & 3)) : a[b];
                acc[t] = sad4(x, s4[q], acc[t]);
            }
        }
    }
    int* o = out + ((size_t)(n0 + m) * n_c + i) * n_c + j0;
#pragma unroll
    for (int t = 0; t < K; ++t)
        if (j0 + t < n_c) o[t] = (int)acc[t];
}

}  // namespace

// plane: uint8 reference plane (row stride `stride` bytes); wy, wx [n]:
// top-left of each MB's window in the plane (the caller guarantees that
// the whole window lies inside it); src [n,16,16] int32 with values in
// [0, 255]; out [n, 2*rng+1, 2*rng+1] int32. k, groups, mbs, pitch and
// shared: the launch geometry of ops/me_sad.py:_plan (k must equal this
// build's K). Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan this build cannot run.
extern "C" int sad_grid(const void* plane, int stride, const void* wy,
                        const void* wx, const void* src, void* out, int n,
                        int rng, int k, int groups, int mbs, int pitch,
                        int shared, void* stream) {
    const int n_c = 2 * rng + 1;
    const int threads = mbs * n_c * groups;
    const int w = n_c + 15;
    if (k != K || rng < 1 || groups * K < n_c || mbs < 1 || threads < 32 ||
        threads > MAX_THREADS || pitch % 16 != 0 || pitch < w ||
        shared > MAX_SHARED ||
        shared < mbs * (SRC_PITCH * 16 + w * pitch) +
                     4 * (((groups - 1) * K) / 4 + NW) - pitch)
        return (int)cudaErrorInvalidValue;
    sad_grid_kernel<<<(n + mbs - 1) / mbs, threads, shared,
                      (cudaStream_t)stream>>>(
        (const uint8_t*)plane, stride, (const int*)wy, (const int*)wx,
        (const int*)src, (int*)out, n, rng, groups, mbs, pitch, shared);
    return (int)cudaGetLastError();
}
