// Proper-interpolation kernel: the 16-direction nearest-valid fill of one
// proper-interpolation iteration (properIpol cpp:7395-7490).
//
// Replaces the TPU kernel `_pi_dir_kernel` (one Pallas call per direction,
// through `proper_interpolation_pallas`) and stands for its two other forms,
// `_pi_grid_kernel` (the 16 directions as one grid) and `_pi_dir_kernel_tiled`
// (halo'd tiles for planes beyond VMEM), all in
// mystereomatching_tpu/ops/pallas_kernels.py. It also folds in the reduction
// over directions that JAX runs outside the Pallas kernels. The TPU needed
// the tiled form and the plane-size gate (refine.py:483) because a plane had
// to fit VMEM; here every tap reads global memory through L1/L2, so one
// kernel covers every plane size.
//
// What it computes, for each pixel p of the int32 [H, W] map `disp`:
//   - disp[p] >= 0: out[p] = disp[p];
//   - otherwise, along each ray k = 0..15 of the offset table offs[k][s]
//     (cumulative (dv, du) per step s < depth), the first tap inside the
//     image with disp >= 0 gives the ray's disparity d_k and its colour
//     difference c_k = max over channels of |I(tap) - I(p)| (float32);
//     then, over the rays that found one,
//       disp[p] == disp_occ: out[p] = min d_k (disp[p] if no ray found one);
//       else: out[p] = d_k of the first ray with the strictly smallest c_k
//             among rays with c_k < 255 (disp[p] if there is none).
// This is the XLA path of refine.proper_interpolation (and the plain torch
// version refine.proper_interpolation_plain) rule for rule, so the two are
// equal bit for bit: the colour difference is one float32 subtraction, abs
// and max per channel, which round the same way everywhere.
//
// What bounds it on the H100: memory for the map (read disp and the image
// once, write out once); the taps of invalid pixels re-read neighbours that
// sit in L1/L2. Per invalid pixel up to 16 x depth taps, each a bounds test
// and an int load, plus 3 float loads where the ray hits.
//
// Design: one thread per pixel, threads of a warp neighbours along W, so a
// tap of a warp reads one contiguous run of a row. Valid pixels return at
// once. The offset table (16 x depth x 2 int32) is staged in shared memory.
// The output is a fresh tensor: every tap of an iteration reads the input.
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kDirs = 16;
constexpr int kMaxDepth = 256;

__global__ void pi_scan_kernel(const int32_t* __restrict__ disp,
                               const float* __restrict__ img,
                               const int32_t* __restrict__ offs,
                               int32_t* __restrict__ out, int h, int w, int depth,
                               int disp_occ) {
  extern __shared__ int32_t s_offs[];  // [kDirs * depth * 2]
  for (int j = threadIdx.x; j < kDirs * depth * 2; j += blockDim.x) s_offs[j] = offs[j];
  __syncthreads();

  const long long n = static_cast<long long>(h) * w;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const int32_t d0 = disp[i];
  if (d0 >= 0) {
    out[i] = d0;
    return;
  }
  const int u = static_cast<int>(i % w);
  const int v = static_cast<int>(i / w);
  const float r0 = img[3 * i], g0 = img[3 * i + 1], b0 = img[3 * i + 2];

  bool found_any = false;
  int32_t occ_min = 1000000;
  float best_cd = FLT_MAX;  // stands for +inf: every accepted cd is < 255
  bool any_mis = false;
  int32_t best_d = -1;
  for (int k = 0; k < kDirs; ++k) {
    const int32_t* ray = s_offs + k * depth * 2;
    for (int s = 0; s < depth; ++s) {
      const int tv = v + ray[2 * s];
      const int tu = u + ray[2 * s + 1];
      if (tv < 0 || tv >= h || tu < 0 || tu >= w) continue;
      const long long j = static_cast<long long>(tv) * w + tu;
      const int32_t dk = disp[j];
      if (dk < 0) continue;
      const float cd = fmaxf(fmaxf(fabsf(img[3 * j] - r0), fabsf(img[3 * j + 1] - g0)),
                             fabsf(img[3 * j + 2] - b0));
      found_any = true;
      occ_min = min(occ_min, dk);
      if (cd < 255.0f) {
        any_mis = true;
        if (cd < best_cd) {
          best_cd = cd;
          best_d = dk;
        }
      }
      break;
    }
  }
  if (d0 == disp_occ) {
    out[i] = found_any ? occ_min : d0;
  } else {
    out[i] = any_mis ? best_d : d0;
  }
}

}  // namespace

// disp/out: [H, W] int32; img: [H, W, 3] float32 (channels last, the
// pipeline's image layout); offs: [16, depth, 2] int32 (dv, du), depth <= 256.
extern "C" int mysm_pi_scan(const int32_t* disp, const float* img, const int32_t* offs,
                            int32_t* out, int h, int w, int depth, int disp_occ,
                            void* stream) {
  if (depth < 1 || depth > kMaxDepth) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(h) * w;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const size_t smem = sizeof(int32_t) * kDirs * depth * 2;
  pi_scan_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      disp, img, offs, out, h, w, depth, disp_occ);
  return static_cast<int>(cudaGetLastError());
}
