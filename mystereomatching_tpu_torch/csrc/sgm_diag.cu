// Kernel E: the SGM path-cost recurrence along one diagonal direction.
//
// Replaces the TPU kernel `_sgm_diag_kernel` in
// mystereomatching_tpu/ops/pallas_kernels.py (called through
// `sgm_diag_scan_pallas` from `sgm.sgm_directions`).
//
// What it computes, for G volumes [G, D, H, W] (float32 or bfloat16) and a
// predecessor offset
// (rv, ru) with rv, ru in {-1, +1}: the recurrence of sgm_band.cuh along
// every diagonal line, each pixel p = (v, u) following p + r = (v + rv,
// u + ru). Rows are walked from the predecessor's side: step t is row
// rv > 0 ? H-1-t : t. Number the H + W - 1 lines c in [0, H + W - 1) so
// that at step t the lines in the image are lo(t) .. lo(t) + W - 1, line c
// at column c - lo(t), with lo(t) = ru > 0 ? t : H - 1 - t. A line starts
// where its predecessor leaves the image (on the first row walked, or on
// the predecessor's side column) and takes L = C there.
//
// What bounds it on the H100: bytes, as kernel C (sgm_band.cuh).
//
// Design: bands of kLines adjacent lines, staged through shared memory
// kSteps steps at a time (sgm_band.cuh); at each row a band's pixels are
// kLines adjacent columns, and the box slides one column a row. Block k of
// nb = ceil(W / kLines) + 1 a volume takes the bands b = k (mod nb), one
// after the other: the bands in the image at one step are at most nb
// consecutive ones, so at most one of them is the block's, and a warp's line
// of one band leaves the image at least kLines steps before its line of the
// next band enters, so a warp meets at most one line a stage and restarts its carry
// from 0 where that line begins. Every block thus walks the H rows once,
// and at each step the blocks together hold one row's W pixels: the loads
// and stores of all blocks meet on the same rows, as along H, and no block
// waits on a longer line than another's. The TPU kernel's [G, H, W, D]
// transpose, its W tiles with a ping-pong boundary scratch and its 8-row
// chunk grid existed because VMEM is small; here the volume is read in
// place, with no transpose, skew or flip.
#include "sgm_band.cuh"

namespace {

struct Diagonal {
  static constexpr int kLines = 16, kBox = 64, kSteps = kBox / kLines, kCols = kLines;
  static_assert(kSteps <= kLines, "a warp meets at most one line a stage");
  int h, w, rv, ru, k, nb;

  __device__ int n_stages() const { return (h + kSteps - 1) / kSteps; }
  __device__ int lo(int t) const { return ru > 0 ? t : h - 1 - t; }
  __device__ bool in_image(int c, int t) const { return lo(t) <= c && c <= lo(t) + w - 1; }
  // the first line of the block's band in the image at step t, or -1
  __device__ int band_line0(int t) const {
    const int l = lo(t), b_lo = l / kLines;
    const int c = (b_lo + ((k - b_lo) % nb + nb) % nb) * kLines;
    return c <= l + w - 1 ? c : -1;
  }
  // box row = step kSteps s + b / kCols, box column = line band_line0 + b % kCols
  __device__ long long pixel(int s, int b) const {
    const int t = s * kSteps + b / kCols;
    if (t >= h) return -1;
    const int c0 = band_line0(t);
    const int u = c0 + b % kCols - lo(t);
    if (c0 < 0 || u < 0 || u >= w) return -1;
    return static_cast<long long>(rv > 0 ? h - 1 - t : t) * w + u;
  }
  __device__ int walk(int s, int line, int& idx, int& stride, bool& begins) const {
    const int t0 = s * kSteps;
    int first = -1, n = 0, c = -1;
    for (int r = 0; r < kSteps && t0 + r < h; ++r) {
      const int c0 = band_line0(t0 + r);
      if (c0 < 0 || !in_image(c0 + line, t0 + r)) continue;
      if (first < 0) {
        first = r;
        c = c0 + line;
      }
      ++n;
    }
    idx = max(first, 0) * kCols + line;
    stride = kCols;
    begins = first > 0 || t0 == 0 || !in_image(c, t0 - 1);
    return n;
  }
};

template <typename T, int kSlots>
__global__ void __launch_bounds__(Diagonal::kLines * 32, 1)
    sgm_diag_kernel(const T* __restrict__ vol, const float* __restrict__ pscale,
                    T* __restrict__ out, int nd, int h, int w, int nb, int rv, int ru,
                    float p1, float p2) {
  const int gi = blockIdx.x / nb;
  const long long plane = static_cast<long long>(h) * w;
  const long long vol_off = static_cast<long long>(gi) * nd * plane;
  mysm::sgm_band<T, kSlots>(vol + vol_off, pscale + gi * plane, out + vol_off, plane, nd, p1,
                            p2, Diagonal{h, w, rv, ru, static_cast<int>(blockIdx.x % nb), nb});
}

template <typename T>
cudaError_t launch(const void* vol, const float* pscale, void* out, int g, int nd, int h, int w,
                   int rv, int ru, float p1, float p2, void* stream) {
  if ((rv != 1 && rv != -1) || (ru != 1 && ru != -1)) return cudaErrorInvalidValue;
  const int nb = (w + Diagonal::kLines - 1) / Diagonal::kLines + 1;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(g) * nb);
  cudaError_t err = cudaErrorInvalidValue;
  mysm::with_slots(nd, [&](auto slots) {
    constexpr int kSlots = decltype(slots)::value;
    err = mysm::launch_band<T, kSlots, Diagonal>(sgm_diag_kernel<T, kSlots>, blocks, nd, stream,
                                                 static_cast<const T*>(vol), pscale,
                                                 static_cast<T*>(out), nd, h, w, nb, rv, ru, p1,
                                                 p2);
  });
  return err;
}

}  // namespace

// vol/out: [G, D, H, W] float32 (mysm_sgm_diag) or bfloat16
// (mysm_sgm_diag_bf16), D <= 256; pscale: [G, H, W] float32; rv, ru: the
// predecessor offset, each -1 or +1.
extern "C" int mysm_sgm_diag(const float* vol, const float* pscale, float* out, int g, int nd,
                             int h, int w, int rv, int ru, float p1, float p2, void* stream) {
  return static_cast<int>(launch<float>(vol, pscale, out, g, nd, h, w, rv, ru, p1, p2, stream));
}
extern "C" int mysm_sgm_diag_bf16(const void* vol, const float* pscale, void* out, int g,
                                  int nd, int h, int w, int rv, int ru, float p1, float p2,
                                  void* stream) {
  return static_cast<int>(
      launch<mysm::bf16>(vol, pscale, out, g, nd, h, w, rv, ru, p1, p2, stream));
}
