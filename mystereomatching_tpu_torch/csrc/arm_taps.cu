// Kernel B: arm-bounded 1-D sum along H or W, with CBCA's area mode.
//
// Replaces the TPU kernels `_taps_kernel` (sum mode; reached through
// `_sublane_pass` / `arm_bounded_sum_pallas` from `aggregation.cbca`'s first
// pass) and `_taps_kernel_area` (through `sublane_pass_area`, CBCA's second
// pass) in mystereomatching_tpu/ops/pallas_kernels.py.
//
// What it computes, for each element x of a [D, H, W] volume:
//   sum mode:  out[x] = sum over k in [-an[x], ap[x]] of vol[x + k e]
//   area mode: out[x] = (sum of vol[x + k e]) / max(sum of area1[x + k e], 1)
// with e a unit step along H or W, arms capped at max_arm and taps off the
// image skipped, and area1 = min(an1, m) + min(ap1, m) + 1 the support count
// of the first pass (arms an1/ap1). All arms are int8 [D, H, W] planes of
// the per-disparity intersected arms.
//
// Sum order: ascending offset, from x - an to x + ap, starting from the
// first term. That is the order of the JAX CPU path
// (arms._arm_bounded_reduce_taps, whose masked taps add an exact +0.0),
// so this kernel is bit-identical to it and to the plain torch version.
// The Pallas kernel adds centre, +1, -1, +2, ... instead, which is not
// bit-identical to that path. Built with -fmad=false.
//
// What bounds it on the H100: memory. Each element reads its taps
// (2 max_arm + 1 at most, about 2-3 at the mean arm of real scenes);
// neighbouring threads share them through L1/L2, so DRAM sees roughly one
// read of vol and the arm planes and one write of out.
//
// Design: one thread per output element, reducing along H or W by stride.
// The TPU's transposes (aggregation.py:58-93) existed only to put the
// reduction axis on sublanes; threads of a warp are neighbours along W, so
// an H pass reads coalesced rows and a W pass reads overlapping cached
// lines. No axis-length limit exists, so the windowed and clone forms of
// the TPU kernel have no counterpart here.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <bool kArea>
__global__ void arm_taps_kernel(const float* __restrict__ vol,
                                const int8_t* __restrict__ an,
                                const int8_t* __restrict__ ap,
                                const int8_t* __restrict__ an1,
                                const int8_t* __restrict__ ap1,
                                float* __restrict__ out, int nd, int h, int w,
                                int along_w, int max_arm) {
  const long long n = static_cast<long long>(nd) * h * w;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const int u = static_cast<int>(i % w);
  const int v = static_cast<int>((i / w) % h);
  const int pos = along_w ? u : v;
  const int len = along_w ? w : h;
  const long long stride = along_w ? 1 : w;
  const int lo = -min(min(static_cast<int>(an[i]), max_arm), pos);
  const int hi = min(min(static_cast<int>(ap[i]), max_arm), len - 1 - pos);
  float acc = 0.0f;
  float area = 0.0f;
  for (int k = lo; k <= hi; ++k) {
    const long long j = i + k * stride;
    acc = __fadd_rn(acc, vol[j]);
    if (kArea) {
      area = __fadd_rn(area, static_cast<float>(min(static_cast<int>(an1[j]), max_arm) +
                                                min(static_cast<int>(ap1[j]), max_arm) + 1));
    }
  }
  out[i] = kArea ? __fdiv_rn(acc, fmaxf(area, 1.0f)) : acc;
}

}  // namespace

// vol/out: [D, H, W] float32; an/ap (and an1/ap1 in area mode, else null):
// [D, H, W] int8. along_w: 1 reduces along W, 0 along H.
extern "C" int mysm_arm_taps(const float* vol, const int8_t* an, const int8_t* ap,
                             const int8_t* an1, const int8_t* ap1, float* out,
                             int nd, int h, int w, int along_w, int max_arm,
                             void* stream) {
  const long long n = static_cast<long long>(nd) * h * w;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (an1 != nullptr) {
    arm_taps_kernel<true><<<blocks, threads, 0, s>>>(vol, an, ap, an1, ap1, out, nd, h,
                                                      w, along_w, max_arm);
  } else {
    arm_taps_kernel<false><<<blocks, threads, 0, s>>>(vol, an, ap, an1, ap1, out, nd,
                                                       h, w, along_w, max_arm);
  }
  return static_cast<int>(cudaGetLastError());
}
