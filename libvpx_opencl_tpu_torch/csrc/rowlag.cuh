// Row tickets and progress counters shared by the persistent row-lagged
// wavefront kernels (intra_wavefront.cu, lf_wavefront.cu,
// encode_wavefront.cu).
//
// `sync` is an int32 scratch array of R+1 zeros that the wrapper allocates
// on the launch stream: sync[0] hands out MB rows in start order, sync[1+r]
// counts the MBs that row r has finished. The pattern is that of CUTLASS's
// GenericBarrier (cutlass/barrier.h, wait_eq / arrive_inc): one thread
// spins on an acquire load and the threads meet at a barrier; publishing
// is a barrier, then one release store.
//
// A block is `nw` worker threads and, after them, one publisher warp. The
// release waits until the block's stores have reached memory, so the
// publisher issues it while the workers go on with the next MB:
//   workers:   ... MB c's stores; [bar.sync 3]; bar.arrive 2
//   publisher: bar.sync 2; st.release progress; bar.arrive 3
// Barrier 1 orders the workers among themselves (barrier 0, __syncthreads,
// is the whole block's).
#pragma once
#include <cstdint>

namespace rowlag {

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait never takes more than microseconds; one that takes this long
// means a broken schedule, and the kernel traps (a launch error) instead
// of hanging the card.
constexpr uint64_t kWatchdogNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// The next MB row in start order, the same value in every thread; >= R
// once none is left. A block only ever waits on a row whose ticket was
// taken earlier, i.e. by a block that is already running, so the kernel
// cannot deadlock whatever the grid size or the other work on the card.
__device__ __forceinline__ int take_row(int* sync) {
  __shared__ int row;
  __syncthreads();  // every thread has read the previous ticket
  if (threadIdx.x == 0) row = atomicAdd(sync, 1);
  __syncthreads();
  return row;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// One thread: spin until row r-1 has finished `need` MBs (r > 0). It keeps
// the last count it saw in `seen` and polls only when that is short. A
// barrier of the threads that read those MBs' pixels must follow.
__device__ __forceinline__ void poll_above(const int* sync, int r, int need,
                                           int& seen) {
  if (seen >= need) return;
  const int* p = sync + r;  // progress of row r-1
  const uint64_t t0 = globaltimer_ns();
  unsigned ns = 0;
  int v;
  while ((v = ld_acquire(p)) < need) {
    if (globaltimer_ns() - t0 > kWatchdogNs) __trap();
    if (ns) __nanosleep(ns);
    ns = ns ? (ns < 256 ? 2 * ns : 256) : 16;
  }
  seen = v;
}

// Block until row r-1 has finished `need` MBs (r > 0): worker thread 0
// polls. Ends with the workers' barrier, after which every worker may read
// what those MBs wrote.
__device__ __forceinline__ void wait_above(const int* sync, int r, int need,
                                           int& seen, int nw) {
  if (threadIdx.x == 0) poll_above(sync, r, need, seen);
  bar_sync(1, nw);
}

// Workers: hand "row r has finished `done` MBs" to the publisher. Every
// pixel those MBs wrote has been stored; `pending` says whether the
// publisher has yet to confirm the previous hand-over. On return every
// worker has finished the MBs (so shared memory may be reused).
__device__ __forceinline__ void hand_over(int* slot, int done, bool& pending,
                                          int nw) {
  if (pending)
    bar_sync(3, nw + 32);  // the previous value is released
  else
    bar_sync(1, nw);
  if (threadIdx.x == 0) *slot = done;
  bar_arrive(2, nw + 32);
  pending = true;
}

// Workers, at the end of a row: wait for the last hand-over's release.
__device__ __forceinline__ void drain(bool& pending, int nw) {
  if (pending) bar_sync(3, nw + 32);
  pending = false;
}

// The publisher warp, for row r: release each value handed over until the
// row is complete (C MBs).
__device__ __forceinline__ void publisher(int* sync, int r, const int* slot,
                                          int C, int nw) {
  int done;
  do {
    bar_sync(2, nw + 32);
    done = *slot;
    if ((threadIdx.x & 31) == 0) st_release(sync + 1 + r, done);
    bar_arrive(3, nw + 32);
  } while (done < C);
}

}  // namespace rowlag
