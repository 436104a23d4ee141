// Kernel C: the SGM path-cost recurrence along H or W, forward or backward.
//
// Replaces the TPU kernel `_sgm_kernel` in
// mystereomatching_tpu/ops/pallas_kernels.py (called through
// `sgm_scan_pallas` from `sgm.sgm_directions`).
//
// What it computes, for G volumes [G, D, H, W] (float32 or bfloat16) and
// one scan direction: the recurrence of sgm_band.cuh along every column
// (along H) or row (along W), from the far end when `reverse`.
//
// What bounds it on the H100: bytes (sgm_band.cuh): the costs and scales
// read once and the path costs written once.
//
// Design: one block a band of adjacent scan lines of one volume, staged
// through shared memory a box of kBox pixels at a time (sgm_band.cuh).
// Along H the band is AlongH::kLines columns and a box holds kBox / kLines
// rows of them; along W the band is AlongW::kLines rows and a box holds
// kBox / kLines columns of each, cut at multiples of that from the left in both
// directions so that row segments stay sector-aligned where the rows are.
// The loop over stages replaces the TPU's sequential H-chunk grid and its
// VMEM carry. Directions are start rows, box orders and strides: no
// transposed or flipped copy is made.
//
// The TPU kernel's two optional inputs, which the row-band pipeline passes
// (parallel/sharded.py), are a second kernel along H, sgm_scan_ext_kernel:
// `init_ref` (pallas_kernels.py:788-793), each column's carry read from a
// [G, D, W] row instead of zeros, and `mask_ref` (803-810), each path cost
// multiplied by a [G, H, W] in-image mask, staged in the box beside the
// scales. Its own entry points leave the plain scan's instances as they are.
#include "sgm_band.cuh"

namespace {

// Lines along H: the band is columns x0 .. x0 + kLines - 1; stage s holds
// steps t = kSteps s .. + kSteps - 1 (box row t % kSteps, at image row t,
// or H - 1 - t when reverse), box column = line.
struct AlongH {
  static constexpr int kLines = 16, kBox = 64, kSteps = kBox / kLines, kCols = kLines;
  int h, w, x0, reverse;
  __device__ int n_stages() const { return (h + kSteps - 1) / kSteps; }
  __device__ long long pixel(int s, int b) const {
    const int t = s * kSteps + b / kCols, x = x0 + b % kCols;
    if (t >= h || x >= w) return -1;
    return static_cast<long long>(reverse ? h - 1 - t : t) * w + x;
  }
  __device__ int walk(int s, int line, int& idx, int& stride, bool& begins) const {
    idx = line;
    stride = kCols;
    begins = s == 0;
    return x0 + line < w ? min(kSteps, h - s * kSteps) : 0;
  }
};

// Lines along W: the band is rows y0 .. y0 + kLines - 1 (box row = line);
// stage s holds columns x_of(s) .. + kSteps - 1 (box column x % kSteps),
// counted from the right when reverse, and each line walks them right to
// left when reverse.
struct AlongW {
  static constexpr int kLines = 4, kBox = 64, kSteps = kBox / kLines, kCols = kSteps;
  int h, w, y0, reverse;
  __device__ int n_stages() const { return (w + kSteps - 1) / kSteps; }
  __device__ int x_of(int s) const { return (reverse ? n_stages() - 1 - s : s) * kSteps; }
  __device__ long long pixel(int s, int b) const {
    const int y = y0 + b / kCols, x = x_of(s) + b % kCols;
    if (y >= h || x >= w) return -1;
    return static_cast<long long>(y) * w + x;
  }
  __device__ int walk(int s, int line, int& idx, int& stride, bool& begins) const {
    const int n = y0 + line < h ? min(kSteps, w - x_of(s)) : 0;
    idx = line * kCols + (reverse ? n - 1 : 0);
    stride = reverse ? -1 : 1;
    begins = s == 0;
    return n;
  }
};

template <typename T, int kSlots, class Geom>
__global__ void __launch_bounds__(Geom::kLines * 32, 1)
    sgm_scan_kernel(const T* __restrict__ vol, const float* __restrict__ pscale,
                    T* __restrict__ out, int nd, int h, int w, int n_bands, int reverse,
                    float p1, float p2) {
  const int gi = blockIdx.x / n_bands;
  const int band = blockIdx.x % n_bands;
  const long long plane = static_cast<long long>(h) * w;
  const long long vol_off = static_cast<long long>(gi) * nd * plane;
  mysm::sgm_band<T, kSlots>(vol + vol_off, pscale + gi * plane, out + vol_off, plane, nd, p1,
                            p2, Geom{h, w, band * Geom::kLines, reverse});
}

// Along H with a carried-in row (init [G, D, W], or null) and, when kMasked,
// an in-image mask [G, H, W] of floats 0 or 1.
template <typename T, int kSlots, bool kMasked>
__global__ void __launch_bounds__(AlongH::kLines * 32, 1)
    sgm_scan_ext_kernel(const T* __restrict__ vol, const float* __restrict__ pscale,
                        const T* __restrict__ init, const float* __restrict__ mask,
                        T* __restrict__ out, int nd, int h, int w, int n_bands, int reverse,
                        float p1, float p2) {
  const int gi = blockIdx.x / n_bands;
  const int band = blockIdx.x % n_bands;
  const long long plane = static_cast<long long>(h) * w;
  const long long vol_off = static_cast<long long>(gi) * nd * plane;
  const int x0 = band * AlongH::kLines;
  mysm::sgm_band<T, kSlots, AlongH, kMasked>(
      vol + vol_off, pscale + gi * plane, out + vol_off, plane, nd, p1, p2,
      AlongH{h, w, x0, reverse},
      init != nullptr ? init + static_cast<long long>(gi) * nd * w + x0 : nullptr, w,
      kMasked ? mask + gi * plane : nullptr);
}

template <typename T, bool kMasked>
cudaError_t launch_ext(const void* vol, const float* pscale, const void* init,
                       const float* mask, void* out, int g, int nd, int h, int w, int reverse,
                       float p1, float p2, void* stream) {
  const int n_bands = (w + AlongH::kLines - 1) / AlongH::kLines;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(g) * n_bands);
  cudaError_t err = cudaErrorInvalidValue;
  mysm::with_slots(nd, [&](auto slots) {
    constexpr int kSlots = decltype(slots)::value;
    err = mysm::launch_band<T, kSlots, AlongH, kMasked>(
        sgm_scan_ext_kernel<T, kSlots, kMasked>, blocks, nd, stream,
        static_cast<const T*>(vol), pscale, static_cast<const T*>(init), mask,
        static_cast<T*>(out), nd, h, w, n_bands, reverse, p1, p2);
  });
  return err;
}

template <typename T>
cudaError_t launch_ext_any(const void* vol, const float* pscale, const void* init,
                           const float* mask, void* out, int g, int nd, int h, int w,
                           int reverse, float p1, float p2, void* stream) {
  return mask != nullptr
             ? launch_ext<T, true>(vol, pscale, init, mask, out, g, nd, h, w, reverse, p1, p2,
                                   stream)
             : launch_ext<T, false>(vol, pscale, init, mask, out, g, nd, h, w, reverse, p1, p2,
                                    stream);
}

template <typename T, class Geom>
cudaError_t launch(const void* vol, const float* pscale, void* out, int g, int nd, int h,
                   int w, int reverse, float p1, float p2, void* stream) {
  const int n_bands = ((std::is_same_v<Geom, AlongW> ? h : w) + Geom::kLines - 1) / Geom::kLines;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(g) * n_bands);
  cudaError_t err = cudaErrorInvalidValue;
  mysm::with_slots(nd, [&](auto slots) {
    constexpr int kSlots = decltype(slots)::value;
    err = mysm::launch_band<T, kSlots, Geom>(sgm_scan_kernel<T, kSlots, Geom>, blocks, nd,
                                             stream, static_cast<const T*>(vol), pscale,
                                             static_cast<T*>(out), nd, h, w, n_bands, reverse,
                                             p1, p2);
  });
  return err;
}

template <typename T>
cudaError_t launch_axis(const void* vol, const float* pscale, void* out, int g, int nd, int h,
                        int w, int along_w, int reverse, float p1, float p2, void* stream) {
  return along_w ? launch<T, AlongW>(vol, pscale, out, g, nd, h, w, reverse, p1, p2, stream)
                 : launch<T, AlongH>(vol, pscale, out, g, nd, h, w, reverse, p1, p2, stream);
}

}  // namespace

// vol/out: [G, D, H, W] float32 (mysm_sgm_scan) or bfloat16
// (mysm_sgm_scan_bf16), D <= 256; pscale: [G, H, W] float32. along_w: 1
// scans along W, 0 along H; reverse: 1 scans from the far end.
extern "C" int mysm_sgm_scan(const float* vol, const float* pscale, float* out, int g, int nd,
                             int h, int w, int along_w, int reverse, float p1, float p2,
                             void* stream) {
  return static_cast<int>(
      launch_axis<float>(vol, pscale, out, g, nd, h, w, along_w, reverse, p1, p2, stream));
}
extern "C" int mysm_sgm_scan_bf16(const void* vol, const float* pscale, void* out, int g,
                                  int nd, int h, int w, int along_w, int reverse, float p1,
                                  float p2, void* stream) {
  return static_cast<int>(launch_axis<mysm::bf16>(vol, pscale, out, g, nd, h, w, along_w,
                                                  reverse, p1, p2, stream));
}

// The scan along H with the row-band pipeline's inputs: vol/out as above,
// init [G, D, W] of vol's type (the carry before the first step, or null
// for zeros), mask [G, H, W] float32 of 0s and 1s (or null for none).
extern "C" int mysm_sgm_scan_ext(const float* vol, const float* pscale, const float* init,
                                 const float* mask, float* out, int g, int nd, int h, int w,
                                 int reverse, float p1, float p2, void* stream) {
  return static_cast<int>(launch_ext_any<float>(vol, pscale, init, mask, out, g, nd, h, w,
                                                reverse, p1, p2, stream));
}
extern "C" int mysm_sgm_scan_ext_bf16(const void* vol, const float* pscale, const void* init,
                                      const float* mask, void* out, int g, int nd, int h,
                                      int w, int reverse, float p1, float p2, void* stream) {
  return static_cast<int>(launch_ext_any<mysm::bf16>(vol, pscale, init, mask, out, g, nd, h, w,
                                                     reverse, p1, p2, stream));
}
