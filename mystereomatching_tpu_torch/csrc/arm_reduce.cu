// Kernel B, integer reduce mode: arm-bounded sum / min / max of int32 planes
// along H or W.
//
// Replaces the TPU kernel `_taps_kernel` with op="min" | "max" | "sum" on
// int32 (mystereomatching_tpu/ops/pallas_kernels.py), as region vote reaches
// it: refine.region_vote / vote_hv -> arms.arm_bounded_reduce -> _try_pallas
// -> arm_bounded_sum_pallas -> _sublane_pass. Kernel B (arm_taps.cu) keeps the
// float32 sum and CBCA area modes; this file is its integer sibling. The port
// runs it for the histogram votes (refine.vote_sums: the sum of a [D + 1, H,
// W] one-hot stack along W, then along H); the unanimity vote runs
// region_vote.cu.
//
// What it computes, for each element x of a [C, H, W] int32 volume:
//   out[x] = op over k in [-an[x], ap[x]] of vol[x + k e]
// with e a unit step along H or W, arms capped at max_arm and taps off the
// image skipped (they would contribute the op's identity). The arms are
// [H, W] int32 planes shared by every channel, as the TPU kernel broadcasts
// a single arm plane (ba == 1): region vote passes the left image's raw
// cross arms, not per-disparity intersected ones.
//
// Integer sum, min and max are exact in any order, so this kernel equals the
// plain torch version (arms.arm_bounded_reduce_plain) bit for bit. The sum
// wraps modulo 2^32 like torch's int32 add (done in unsigned arithmetic).
//
// What bounds it on the H100: memory. Each element reads its taps (2 max_arm
// + 1 at most); neighbouring threads share them through L1/L2, so DRAM sees
// about one read of vol and the arm planes and one write of out. The
// histogram votes call it on [D + 1, H, W] stacks: 83.7 MB a pass at 375x450,
// D=60, 11.8 GB at 1988x2880, D=256.
//
// Design: one thread per output element, reducing along H or W by stride, as
// kernel B does. Threads of a warp are neighbours along W: an H pass reads
// coalesced rows and a W pass reads overlapping cached lines.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

enum Op { kSum = 0, kMin = 1, kMax = 2 };

template <int kOp>
__global__ void arm_reduce_kernel(const int32_t* __restrict__ vol,
                                  const int32_t* __restrict__ an,
                                  const int32_t* __restrict__ ap,
                                  int32_t* __restrict__ out, int nc, int h, int w,
                                  int along_w, int max_arm) {
  const long long plane = static_cast<long long>(h) * w;
  const long long n = nc * plane;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const long long p = i % plane;  // position in the [H, W] arm planes
  const int u = static_cast<int>(p % w);
  const int v = static_cast<int>(p / w);
  const int pos = along_w ? u : v;
  const int len = along_w ? w : h;
  const long long stride = along_w ? 1 : w;
  const int lo = -min(min(an[p], max_arm), pos);
  const int hi = min(min(ap[p], max_arm), len - 1 - pos);
  if (kOp == kSum) {
    uint32_t acc = 0u;
    for (int k = lo; k <= hi; ++k) acc += static_cast<uint32_t>(vol[i + k * stride]);
    out[i] = static_cast<int32_t>(acc);
  } else {
    int32_t acc = kOp == kMin ? INT_MAX : INT_MIN;
    for (int k = lo; k <= hi; ++k) {
      const int32_t x = vol[i + k * stride];
      acc = kOp == kMin ? min(acc, x) : max(acc, x);
    }
    out[i] = acc;
  }
}

}  // namespace

// vol/out: [C, H, W] int32; an/ap: [H, W] int32. along_w: 1 reduces along W,
// 0 along H. op: 0 sum, 1 min, 2 max.
extern "C" int mysm_arm_reduce(const int32_t* vol, const int32_t* an, const int32_t* ap,
                               int32_t* out, int nc, int h, int w, int along_w,
                               int max_arm, int op, void* stream) {
  const long long n = static_cast<long long>(nc) * h * w;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kSum:
      arm_reduce_kernel<kSum><<<blocks, threads, 0, s>>>(vol, an, ap, out, nc, h, w,
                                                         along_w, max_arm);
      break;
    case kMin:
      arm_reduce_kernel<kMin><<<blocks, threads, 0, s>>>(vol, an, ap, out, nc, h, w,
                                                         along_w, max_arm);
      break;
    case kMax:
      arm_reduce_kernel<kMax><<<blocks, threads, 0, s>>>(vol, an, ap, out, nc, h, w,
                                                         along_w, max_arm);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
