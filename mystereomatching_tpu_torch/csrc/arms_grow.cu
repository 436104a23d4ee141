// Kernel A: cross-arm growth (calHorVerDis, reference cpp:2959-3050).
//
// Replaces the TPU kernel `_arms_grow_kernel` in
// mystereomatching_tpu/ops/pallas_kernels.py (called through
// `arms_grow_pallas` from `arms._grow_arms`).
//
// What it computes, per pixel p and direction a in {left, right, up, down}:
// the arm reaches length k while, for every j <= k, p + j a lies inside the
// image, max_c |I(p + j a) - I(p + (j-1) a)| <= neigh_thresh and
// max_c |I(p + j a) - I(p)| <= sched[j-1]. The arm is then raised to
// min(min_arm, distance to the border). Output: int32 [4, H, W] in
// L, R, U, D order. The comparisons are those of arms.grow_arms_plain on the
// same float32 differences, so the two agree bit for bit.
//
// What bounds it on the H100: not DRAM (the image is 12 bytes a pixel,
// read once from DRAM, and 16 bytes a pixel are written) but the serial
// walk of up to l_out dependent steps per thread, served from L1/L2. Real
// arms are short (a mean of 1.2 to 1.6 on the synthetic scenes), so a walk
// is a few steps and a warp runs as long as the longest of its 32.
//
// Design: one thread per (pixel, direction pair); grid.y picks the pair
// (0: left/right along W, 1: up/down along H). The thread walks each side
// of its pair and stops at the first failed step, so a short arm costs
// few reads. The anchor schedule is a launch parameter (__grid_constant__,
// a fixed array of kMaxSteps floats): the wrapper copies nothing to the
// card before a launch, and every lane of a warp at step k reads the same
// threshold, which the constant cache broadcasts. The TPU kernel held a
// padded copy of a whole axis in VMEM and evaluated every step for every
// pixel; here out-of-image steps end the walk, as arms._PAD_FAIL makes them
// fail, and no axis-length limit exists (the TPU's arms_grow_fits gate has
// no counterpart). Staging a tile and its l_out halo in shared memory, a
// thread a (pixel, side), was measured and not kept: 3-20% faster on
// 1988x2880 images, slower on a 375x450 one (PERF.md §6).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSteps = 127;  // l_out: the config's bound on arm lengths

struct Sched {
  float t[kMaxSteps];
};

__device__ __forceinline__ float max_abs_diff3(const float* a, const float* b) {
  return fmaxf(fmaxf(fabsf(a[0] - b[0]), fabsf(a[1] - b[1])), fabsf(a[2] - b[2]));
}

__global__ void arms_grow_kernel(const float* __restrict__ img, int32_t* __restrict__ arms,
                                 int h, int w, int l_out, float neigh_thresh, int min_arm,
                                 const __grid_constant__ Sched sched) {
  const long long hw = static_cast<long long>(h) * w;
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= hw) return;
  const int pair = blockIdx.y;                   // 0: L/R along W, 1: U/D along H
  const int v = static_cast<int>(p / w);
  const int u = static_cast<int>(p % w);
  const int pos = pair == 0 ? u : v;
  const int len = pair == 0 ? w : h;
  const long long step = pair == 0 ? 3 : 3LL * w;  // floats between axis neighbours
  const float* center = img + 3 * p;
  for (int side = 0; side < 2; ++side) {          // 0: toward -axis, 1: toward +axis
    const long long dir = side == 0 ? -step : step;
    const int room = side == 0 ? pos : len - 1 - pos;
    const int steps = min(l_out, room);
    const float* prev = center;
    int arm = 0;
    for (int k = 1; k <= steps; ++k) {
      const float* q = prev + dir;
      if (!(max_abs_diff3(q, center) <= sched.t[k - 1] &&
            max_abs_diff3(q, prev) <= neigh_thresh)) {
        break;
      }
      arm = k;
      prev = q;
    }
    arms[(2 * pair + side) * hw + p] = max(arm, min(min_arm, room));
  }
}

}  // namespace

// img: [H, W, 3] float32; sched: host array of l_out floats (1 <= l_out <=
// 127), passed to the kernel by value; arms: [4, H, W] int32.
extern "C" int mysm_arms_grow(const float* img, const float* sched, int32_t* arms, int h,
                              int w, int l_out, float neigh_thresh, int min_arm, void* stream) {
  if (h < 1 || w < 1 || l_out < 1 || l_out > kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Sched s{};
  for (int k = 0; k < l_out; ++k) s.t[k] = sched[k];
  const long long hw = static_cast<long long>(h) * w;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((hw + threads - 1) / threads), 2);
  arms_grow_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, arms, h, w, l_out, neigh_thresh, min_arm, s);
  return static_cast<int>(cudaGetLastError());
}
