// What the kernels that spread one step over the whole card share: the
// cp.async helpers (split_step.cuh's column-split launches and
// grid_beam.cuh's persistent searches) and the grid barrier of a
// cooperative launch.
#pragma once

#include <cuda_runtime.h>

namespace icee {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A barrier over every block of a cooperative launch (which guarantees
// that all blocks are resident at once, so spinning cannot deadlock).
// `count` is zero at launch and only grows: the g-th barrier of a launch
// releases once it reaches g * gridDim.x.  Writes before the barrier are
// visible after it to every block that reads through L2 (__ldcg,
// cp.async.cg): thread 0 fences, arrives, spins with acquire loads and
// fences again, and the block barriers order the other threads around
// it.  Every thread of every block must call it, with the same `gen`.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned& gen) {
  __syncthreads();
  ++gen;
  if (threadIdx.x == 0) {
    const unsigned target = gen * gridDim.x;
    __threadfence();
    atomicAdd(count, 1u);
    unsigned seen;
    for (unsigned spins = 0;; ++spins) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
      if (static_cast<int>(seen - target) >= 0) break;
      if (spins == (1u << 28)) __trap();  // a block never came: fail, not hang
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace icee
