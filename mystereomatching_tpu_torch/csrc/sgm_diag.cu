// Kernel E: the SGM path-cost recurrence along one diagonal direction.
//
// Replaces the TPU kernel `_sgm_diag_kernel` in
// mystereomatching_tpu/ops/pallas_kernels.py (called through
// `sgm_diag_scan_pallas` from `sgm.sgm_directions`).
//
// What it computes, for G volumes [G, D, H, W] and a predecessor offset
// (rv, ru) with rv, ru in {-1, +1}: the recurrence of sgm_line.cuh along
// every diagonal line, each pixel p = (v, u) following p + r = (v + rv,
// u + ru). A line starts on the predecessor's side, at a pixel whose
// predecessor lies outside the image: on row rv > 0 ? H-1 : 0 (W lines) or,
// for the other H-1 rows, on column ru > 0 ? W-1 : 0; so the corner starts
// one line and there are H + W - 1 lines a volume. Each step moves
// (-rv, -ru); the longest line has min(H, W) steps.
//
// What bounds it on the H100: latency, as kernel C. Each line is a chain
// of dependent steps with a warp-wide min reduction, and the lines differ
// in length (1 to min(H, W) steps), so warps on short lines leave early.
// Each step reads D costs and writes D path costs.
//
// Design: one warp per (volume, diagonal line), with D across the lanes and
// the carried D-vector in registers (sgm_line.cuh), so a pixel's
// predecessor is the warp's previous step. The TPU kernel's [G, H, W, D]
// transpose, its W tiles with a ping-pong boundary scratch and its 8-row
// chunk grid existed because VMEM is small; here the volume is read in
// place through a 2-D stride, with no transpose, skew or flip.
#include "sgm_line.cuh"

namespace {

template <int kSlots>
__global__ void sgm_diag_kernel(const float* __restrict__ vol,
                                const float* __restrict__ pscale,
                                float* __restrict__ out, int g, int nd, int h, int w,
                                int rv, int ru, float p1, float p2) {
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int n_lines = h + w - 1;
  if (warp >= static_cast<long long>(g) * n_lines) return;  // whole warps leave
  const int gi = static_cast<int>(warp / n_lines);
  const int line = static_cast<int>(warp % n_lines);
  int v, u;
  if (line < w) {               // on the start row
    v = rv > 0 ? h - 1 : 0;
    u = line;
  } else {                      // on the start column, the start row left out
    v = line - w + (rv > 0 ? 0 : 1);
    u = ru > 0 ? w - 1 : 0;
  }
  const int rows_left = rv > 0 ? v + 1 : h - v;
  const int cols_left = ru > 0 ? u + 1 : w - u;
  const int n_steps = rows_left < cols_left ? rows_left : cols_left;
  const long long plane = static_cast<long long>(h) * w;
  mysm::sgm_line<kSlots>(vol + gi * nd * plane, pscale + gi * plane, out + gi * nd * plane,
                         plane, static_cast<long long>(v) * w + u,
                         -(static_cast<long long>(rv) * w + ru), n_steps, nd, p1, p2);
}

}  // namespace

// vol/out: [G, D, H, W] float32, D <= 256; pscale: [G, H, W] float32;
// rv, ru: the predecessor offset, each -1 or +1.
extern "C" int mysm_sgm_diag(const float* vol, const float* pscale, float* out, int g, int nd,
                             int h, int w, int rv, int ru, float p1, float p2, void* stream) {
  if ((rv != 1 && rv != -1) || (ru != 1 && ru != -1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads_total = static_cast<long long>(g) * (h + w - 1) * 32;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((threads_total + threads - 1) / threads);
  const bool ok = mysm::with_slots(nd, [&](auto slots) {
    sgm_diag_kernel<decltype(slots)::value><<<blocks, threads, 0,
                                              static_cast<cudaStream_t>(stream)>>>(
        vol, pscale, out, g, nd, h, w, rv, ru, p1, p2);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
