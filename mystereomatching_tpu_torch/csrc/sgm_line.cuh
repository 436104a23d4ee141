// The SGM path-cost recurrence along one scan line, walked by one warp.
// Shared by kernel C (sgm_scan.cu, lines along H or W) and kernel E
// (sgm_diag.cu, diagonal lines); they differ only in which lines exist and
// where each starts.
//
// What it computes, for one volume's [D, H, W] costs and one scan line:
//   minL = min_d L(prev, d)
//   best = min(min(L(prev, d), minL + P2 s), min(L(prev, d-1), L(prev, d+1)) + P1 s)
//   L(cur, d) = (C(cur, d) + best) - minL
// with s = pscale at cur and L(prev) = 0 before the first step of the line
// (so the first step gives L = C, the reference's scan-edge rule,
// h:2277-2279). The operation order is that of sgm._scan_down and the TPU
// kernels; with -fmad=false the result is bit-identical to the plain torch
// versions.
//
// Slot k of lane l holds d = 32 k + l (D = 60 gives 2 slots a lane). The
// carried D-vector lives in registers; the min over D is a butterfly of
// shuffles; the d-1 and d+1 neighbours come from shuffles, with FLT_MAX
// past either end.
#pragma once

#include <cfloat>
#include <type_traits>

#include <cuda_runtime.h>

namespace mysm {

constexpr unsigned kFullMask = 0xffffffffu;

// vb, pb, ob: the volume's costs, penalty scales and path costs; the
// line's pixels sit at start + t * step (t < n_steps) of an [H, W] plane,
// and disparity d of a pixel at d * plane past it.
template <int kSlots>
__device__ __forceinline__ void sgm_line(const float* __restrict__ vb,
                                         const float* __restrict__ pb,
                                         float* __restrict__ ob, long long plane,
                                         long long start, long long step, int n_steps,
                                         int nd, float p1, float p2) {
  const int lane = threadIdx.x & 31;
  float prev[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) prev[k] = 0.0f;

  for (int t = 0; t < n_steps; ++t) {
    const long long off = start + t * step;
    const float s = pb[off];
    float min_l = FLT_MAX;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (k * 32 + lane < nd) min_l = fminf(min_l, prev[k]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) min_l = fminf(min_l, __shfl_xor_sync(kFullMask, min_l, o));
    const float p1s = __fmul_rn(p1, s);
    const float jump = __fadd_rn(min_l, __fmul_rn(p2, s));

    float cur[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int d = k * 32 + lane;
      // d - 1: lane - 1 of this slot, or lane 31 of the slot below
      float up = __shfl_up_sync(kFullMask, prev[k], 1);
      const float below = __shfl_sync(kFullMask, k > 0 ? prev[k - 1] : FLT_MAX, 31);
      if (lane == 0) up = below;
      // d + 1: lane + 1 of this slot, or lane 0 of the slot above
      float dn = __shfl_down_sync(kFullMask, prev[k], 1);
      const float above = __shfl_sync(kFullMask, k + 1 < kSlots ? prev[k + 1] : FLT_MAX, 0);
      if (lane == 31) dn = above;
      if (d + 1 >= nd) dn = FLT_MAX;
      cur[k] = 0.0f;
      if (d < nd) {
        const float c = vb[d * plane + off];
        const float best = fminf(fminf(prev[k], jump), __fadd_rn(fminf(up, dn), p1s));
        cur[k] = __fsub_rn(__fadd_rn(c, best), min_l);
        ob[d * plane + off] = cur[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) prev[k] = cur[k];
  }
}

// Calls f(std::integral_constant<int, kSlots>{}) with kSlots = ceil(nd / 32);
// returns false, calling nothing, unless 1 <= nd <= 256.
template <typename F>
bool with_slots(int nd, F&& f) {
  switch ((nd + 31) / 32) {
    case 1: f(std::integral_constant<int, 1>{}); return true;
    case 2: f(std::integral_constant<int, 2>{}); return true;
    case 3: f(std::integral_constant<int, 3>{}); return true;
    case 4: f(std::integral_constant<int, 4>{}); return true;
    case 5: f(std::integral_constant<int, 5>{}); return true;
    case 6: f(std::integral_constant<int, 6>{}); return true;
    case 7: f(std::integral_constant<int, 7>{}); return true;
    case 8: f(std::integral_constant<int, 8>{}); return true;
    default: return false;
  }
}

}  // namespace mysm
