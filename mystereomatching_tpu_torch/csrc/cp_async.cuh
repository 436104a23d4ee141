// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), shared by the kernels that stage their inputs through
// shared memory: the SGM scans (sgm_band.cuh) and kernel B (arm_taps.cu).
// A copy bypasses the registers; the copies issued between two commits
// form one group, and cp_async_wait<n> returns once at most n groups are
// still in flight.
#pragma once

#include <cuda_runtime.h>

namespace mysm {

__device__ __forceinline__ unsigned smem_addr(void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 4 bytes; both addresses 4-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// 16 bytes; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace mysm
