// The volume storage types of the kernels: float32, or bfloat16 as the
// JAX package's vol_dtype="bfloat16" stores its volumes. Shared by kernels
// B (arm_taps.cu), C and E (sgm_band.cuh) and D (wta.cu).
//
// Values are computed in float. A bfloat16 kernel rounds to bfloat16 after
// every operation (round_to), as the JAX CPU path does: XLA computes a
// bfloat16 add in float and rounds the result once, and so does
// __fadd_rn followed by __float2bfloat16_rn. For float, round_to is the
// identity, so the float32 kernels compute what they did before.
#pragma once

#include <cfloat>
#include <type_traits>

#include <cuda_bf16.h>

namespace mysm {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kIsBf16 = std::is_same_v<T, bf16>;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

// x rounded to T's precision, held in a float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (kIsBf16<T>) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// x (already representable in T, or rounded to it) stored as T
template <typename T>
__device__ __forceinline__ T narrow(float x) {
  if constexpr (kIsBf16<T>) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

// T's largest finite value, as a float: the SGM scans' edge fill
template <typename T>
constexpr float kMaxValue = kIsBf16<T> ? 0x1.fep127f : FLT_MAX;

}  // namespace mysm
