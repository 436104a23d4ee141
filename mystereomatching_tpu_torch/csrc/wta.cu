// Kernel D: winner-take-all over the disparity axis.
//
// Replaces the TPU kernel `_wta_kernel` in
// mystereomatching_tpu/ops/pallas_kernels.py (called through `wta_pallas`
// from `wta.wta`).
//
// What it computes: out[v, u] = the first d achieving min_d vol[d, v, u]
// (max for choose_small = 0), int32 [H, W], as jnp.argmin / torch.argmin,
// for a float32 or a bfloat16 volume. A NaN counts as the extreme, so the
// first NaN wins, as in both of those (ZNCC's cost is NaN where rounding
// makes a window's squared deviation negative). A bfloat16 cost is widened
// to float before it is compared; widening keeps the order, so the result
// is exact.
//
// What bounds it on the H100: memory. It reads the [D, H, W] volume once
// (4 D or 2 D bytes a pixel) and writes 4 bytes a pixel.
//
// Design: one thread per pixel, looping over d with a strict comparison
// so that the first occurrence wins. The loop only notes whether it saw a
// NaN (one OR, off the chain of comparisons); a pixel that has one walks its
// column again to the first NaN. Threads of a warp are neighbours
// along W, so every disparity plane is read coalesced.
#include <cstdint>

#include <cuda_runtime.h>

#include "storage.cuh"

namespace {

template <typename T>
__global__ void wta_kernel(const T* __restrict__ vol, int32_t* __restrict__ out, int nd,
                           long long hw, int choose_small) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= hw) return;
  float best = mysm::widen(vol[p]);
  int arg = 0;
  bool nan = best != best;
  for (int d = 1; d < nd; ++d) {
    const float c = mysm::widen(vol[d * hw + p]);
    nan |= c != c;
    if (choose_small ? c < best : c > best) {
      best = c;
      arg = d;
    }
  }
  if (nan) {
    arg = 0;
    while (mysm::widen(vol[arg * hw + p]) == mysm::widen(vol[arg * hw + p])) ++arg;
  }
  out[p] = arg;
}

template <typename T>
int launch(const void* vol, int32_t* out, int nd, long long hw, int choose_small,
           cudaStream_t stream) {
  const int threads = 256;
  wta_kernel<T><<<static_cast<unsigned>((hw + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const T*>(vol), out, nd, hw, choose_small);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vol: [D, H, W] float32 (mysm_wta) or bfloat16 (mysm_wta_bf16); out:
// [H, W] int32.
extern "C" int mysm_wta(const float* vol, int32_t* out, int nd, int h, int w, int choose_small,
                        void* stream) {
  return launch<float>(vol, out, nd, static_cast<long long>(h) * w, choose_small,
                       static_cast<cudaStream_t>(stream));
}
extern "C" int mysm_wta_bf16(const void* vol, int32_t* out, int nd, int h, int w,
                             int choose_small, void* stream) {
  return launch<mysm::bf16>(vol, out, nd, static_cast<long long>(h) * w, choose_small,
                            static_cast<cudaStream_t>(stream));
}
