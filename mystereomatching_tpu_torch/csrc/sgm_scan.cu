// Kernel C: the SGM path-cost recurrence along H or W, forward or backward.
//
// Replaces the TPU kernel `_sgm_kernel` in
// mystereomatching_tpu/ops/pallas_kernels.py (called through
// `sgm_scan_pallas` from `sgm.sgm_directions`).
//
// What it computes, for G volumes [G, D, H, W] and one scan direction: the
// recurrence of sgm_line.cuh along every row (along W) or column (along H),
// from the far end when `reverse`.
//
// What bounds it on the H100: latency. Each scan line is a chain of H or W
// dependent steps, each with a warp-wide min reduction; only
// G x (number of lines) warps exist (about 900 for a Teddy-sized pair).
// Each step reads D costs and writes D path costs.
//
// Design: one warp per (volume, scan line), with D across the lanes
// (sgm_line.cuh). The loop along the line replaces the TPU's sequential
// H-chunk grid and its VMEM carry. The scan axis and its direction are a
// start offset and a stride, so no transposed or flipped copy is made.
#include "sgm_line.cuh"

namespace {

template <int kSlots>
__global__ void sgm_scan_kernel(const float* __restrict__ vol,
                                const float* __restrict__ pscale,
                                float* __restrict__ out, int g, int nd, int h,
                                int w, int along_w, int reverse, float p1, float p2) {
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int n_lines = along_w ? h : w;
  const int n_steps = along_w ? w : h;
  if (warp >= static_cast<long long>(g) * n_lines) return;  // whole warps leave
  const int gi = static_cast<int>(warp / n_lines);
  const int line = static_cast<int>(warp % n_lines);
  const long long plane = static_cast<long long>(h) * w;
  const long long line_off = along_w ? static_cast<long long>(line) * w : line;
  const long long stride = along_w ? 1 : w;
  const long long start = line_off + (reverse ? (n_steps - 1) * stride : 0);
  mysm::sgm_line<kSlots>(vol + gi * nd * plane, pscale + gi * plane, out + gi * nd * plane,
                         plane, start, reverse ? -stride : stride, n_steps, nd, p1, p2);
}

}  // namespace

// vol/out: [G, D, H, W] float32, D <= 256; pscale: [G, H, W] float32.
// along_w: 1 scans along W, 0 along H; reverse: 1 scans from the far end.
extern "C" int mysm_sgm_scan(const float* vol, const float* pscale, float* out, int g,
                             int nd, int h, int w, int along_w, int reverse, float p1,
                             float p2, void* stream) {
  const long long threads_total = static_cast<long long>(g) * (along_w ? h : w) * 32;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((threads_total + threads - 1) / threads);
  const bool ok = mysm::with_slots(nd, [&](auto slots) {
    sgm_scan_kernel<decltype(slots)::value><<<blocks, threads, 0,
                                              static_cast<cudaStream_t>(stream)>>>(
        vol, pscale, out, g, nd, h, w, along_w, reverse, p1, p2);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
