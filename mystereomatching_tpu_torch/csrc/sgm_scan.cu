// Kernel C: the SGM path-cost recurrence along H or W, forward or backward.
//
// Replaces the TPU kernel `_sgm_kernel` in
// mystereomatching_tpu/ops/pallas_kernels.py (called through
// `sgm_scan_pallas` from `sgm.sgm_directions`).
//
// What it computes, for G volumes [G, D, H, W] and one scan direction:
//   minL = min_d L(prev, d)
//   best = min(min(L(prev, d), minL + P2 s), min(L(prev, d-1), L(prev, d+1)) + P1 s)
//   L(cur, d) = (C(cur, d) + best) - minL
// with s = pscale[g, cur] and L(prev) = 0 before the first step of a scan
// line (so the first step gives L = C, the reference's scan-edge rule,
// h:2277-2279). The operation order is that of sgm._scan_down and the TPU
// kernel; with -fmad=false the result is bit-identical to the plain torch
// version.
//
// What bounds it on the H100: latency. Each scan line is a chain of H or W
// dependent steps, each with a warp-wide min reduction; only
// G x (number of lines) warps exist (about 900 for a Teddy-sized pair).
// Each step reads D costs and writes D path costs.
//
// Design: one warp per (volume, scan line), with D across the lanes
// (slot k of lane l holds d = 32 k + l; D = 60 gives 2 slots a lane). The
// carried row lives in registers while a loop walks the scan axis; that
// loop replaces the TPU's sequential H-chunk grid and its VMEM carry. The
// min over D is a butterfly of shuffles; the d-1 and d+1 neighbours come
// from shuffles, with FLT_MAX past either end. The scan axis and its
// direction are strides, so no transposed or flipped copy is made.
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

template <int kSlots>
__global__ void sgm_scan_kernel(const float* __restrict__ vol,
                                const float* __restrict__ pscale,
                                float* __restrict__ out, int g, int nd, int h,
                                int w, int along_w, int reverse, float p1, float p2) {
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int n_lines = along_w ? h : w;
  const int n_steps = along_w ? w : h;
  if (warp >= static_cast<long long>(g) * n_lines) return;  // whole warps leave
  const int gi = static_cast<int>(warp / n_lines);
  const int line = static_cast<int>(warp % n_lines);
  const long long plane = static_cast<long long>(h) * w;
  const long long line_off = along_w ? static_cast<long long>(line) * w : line;
  const long long step_stride = along_w ? 1 : w;
  const float* vb = vol + gi * nd * plane + line_off;
  float* ob = out + gi * nd * plane + line_off;
  const float* pb = pscale + gi * plane + line_off;

  float prev[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) prev[k] = 0.0f;

  for (int t = 0; t < n_steps; ++t) {
    const long long off = (reverse ? n_steps - 1 - t : t) * step_stride;
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

template <int kSlots>
void launch(const float* vol, const float* pscale, float* out, int g, int nd, int h,
            int w, int along_w, int reverse, float p1, float p2, cudaStream_t stream) {
  const long long threads_total = static_cast<long long>(g) * (along_w ? h : w) * 32;
  const int threads = 256;
  sgm_scan_kernel<kSlots><<<static_cast<unsigned>((threads_total + threads - 1) / threads),
                            threads, 0, stream>>>(vol, pscale, out, g, nd, h, w, along_w,
                                                  reverse, p1, p2);
}

}  // namespace

// vol/out: [G, D, H, W] float32, D <= 256; pscale: [G, H, W] float32.
// along_w: 1 scans along W, 0 along H; reverse: 1 scans from the far end.
extern "C" int mysm_sgm_scan(const float* vol, const float* pscale, float* out, int g,
                             int nd, int h, int w, int along_w, int reverse, float p1,
                             float p2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((nd + 31) / 32) {
    case 1: launch<1>(vol, pscale, out, g, nd, h, w, along_w, reverse, p1, p2, s); break;
    case 2: launch<2>(vol, pscale, out, g, nd, h, w, along_w, reverse, p1, p2, s); break;
    case 3: launch<3>(vol, pscale, out, g, nd, h, w, along_w, reverse, p1, p2, s); break;
    case 4: launch<4>(vol, pscale, out, g, nd, h, w, along_w, reverse, p1, p2, s); break;
    case 5: launch<5>(vol, pscale, out, g, nd, h, w, along_w, reverse, p1, p2, s); break;
    case 6: launch<6>(vol, pscale, out, g, nd, h, w, along_w, reverse, p1, p2, s); break;
    case 7: launch<7>(vol, pscale, out, g, nd, h, w, along_w, reverse, p1, p2, s); break;
    case 8: launch<8>(vol, pscale, out, g, nd, h, w, along_w, reverse, p1, p2, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
