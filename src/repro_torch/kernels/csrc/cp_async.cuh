// Asynchronous global -> shared copies (sm_80 and later), the only inline PTX
// of the port's kernels.
//
// cp_async16 starts a 16-byte copy of which the first `src_bytes` (0..16) are
// read from `gmem` and the rest are zero-filled; cp_async_commit closes the
// calling thread's group of copies; cp_async_wait<N> waits until at most N of
// its groups are still in flight. A copy is visible to the other threads of
// the block after the issuing thread has waited for it and a __syncthreads.
#pragma once

namespace rt {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace rt
