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
//             among rays with c_k < 255 (disp[p] if there is none), which is
//             the lexicographic minimum of (c_k, k).
// This is the XLA path of refine.proper_interpolation (and the plain torch
// version refine.proper_interpolation_plain) rule for rule, so the two are
// equal bit for bit: the colour difference is one float32 subtraction, abs
// and max per channel, which round the same way everywhere.
//
// What bounds it on the H100: memory for the map (read disp and the image
// once, write out once), plus the taps of the invalid pixels, which re-read
// neighbours through L1/L2: up to 16 x depth taps a hole, each a bounds test
// and an int load, and 3 float loads where a ray hits. Where holes are
// scattered, those instructions and scattered loads; where they crowd, the
// latency of rays that walk far.
//
// Design: a block takes kPixels consecutive pixels. Its first warps write
// the valid ones through and list the invalid ones (holes) in shared memory
// (__ballot_sync and each warp's count). Then its 16 half-warps take the
// holes in turn, so that holes crowded into one warp spread over the block;
// lane k of a half-warp walks ray k of its hole, kFirst taps in its first
// round of loads (the first tap of most rays of a scattered hole is valid)
// and up to kUnroll at once after it, up to the first valid tap in the
// image, and reads that tap's colour. A hole costs at most
// 1 + ceil((depth - kFirst) / kUnroll) rounds of loads instead of one
// thread's 16 x depth dependent taps. The 16 lanes reduce with shuffles:
// found, the smallest ray disparity, and the lexicographic minimum of
// (colour difference, ray). The offset table sits in shared memory as
// [depth][16] (dv, du) pairs, so the 16 lanes of a step read 128
// consecutive bytes. The output is a fresh tensor: every tap of an
// iteration reads the input.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kDirs = 16;
constexpr int kMaxDepth = 256;
constexpr int kThreads = 256;
constexpr int kPixels = 128;     // pixels of a block
constexpr int kFirst = 1;        // taps of a ray in its first round of loads
constexpr int kUnroll = 2;       // taps of a ray loaded at once after it, at most
constexpr int kNoRay = 1000000;  // the plain version's "no disparity" for the minimum

// One hole at pixel (v, u), value dp, on the 16 lanes of a half-warp (lane
// k walks ray k; `half` is the half-warp's lane mask); lane 0 of it writes
// out.
__device__ __forceinline__ void fill_hole(const int32_t* __restrict__ disp,
                                          const float* __restrict__ img,
                                          int32_t* __restrict__ out, const int2* s_offs, int v,
                                          int u, int32_t dp, int h, int w, int depth,
                                          int disp_occ, int k, unsigned half) {
  const long long p = static_cast<long long>(v) * w + u;
  const float r0 = img[3 * p], g0 = img[3 * p + 1], b0 = img[3 * p + 2];
  bool found = false;
  int32_t dk = kNoRay;  // the ray's disparity; kNoRay where it found none
  int hit = 0;          // its step
  for (int s0 = 0, n = kFirst; s0 < depth && !found; s0 += n, n = kUnroll) {
    int32_t dd[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      dd[t] = -1;
      if (t < n && s0 + t < depth) {
        const int2 o = s_offs[(s0 + t) * kDirs + k];
        const int tv = v + o.x, tu = u + o.y;
        if (tv >= 0 && tv < h && tu >= 0 && tu < w) {
          dd[t] = disp[static_cast<long long>(tv) * w + tu];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      if (!found && dd[t] >= 0) {
        found = true;
        dk = dd[t];
        hit = s0 + t;
      }
    }
  }
  float cd = __int_as_float(0x7f800000);  // +inf: no colour difference below 255
  if (found) {
    const int2 o = s_offs[hit * kDirs + k];
    const long long j = 3 * (static_cast<long long>(v + o.x) * w + u + o.y);
    const float c = fmaxf(fmaxf(fabsf(img[j] - r0), fabsf(img[j + 1] - g0)),
                          fabsf(img[j + 2] - b0));
    if (c < 255.0f) cd = c;
  }
  // across the 16 lanes of the half-warp (xor offsets below 16 stay in it)
  bool any = found;
  int32_t occ_min = dk;
  int best_k = k;
  int32_t best_d = dk;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    any = __shfl_xor_sync(half, static_cast<int>(any), o) != 0 || any;
    occ_min = min(occ_min, __shfl_xor_sync(half, occ_min, o));
    const float ocd = __shfl_xor_sync(half, cd, o);
    const int ok = __shfl_xor_sync(half, best_k, o);
    const int32_t od = __shfl_xor_sync(half, best_d, o);
    if (ocd < cd || (ocd == cd && ok < best_k)) {
      cd = ocd;
      best_k = ok;
      best_d = od;
    }
  }
  if (k == 0) {
    if (dp == disp_occ) {
      out[p] = any ? occ_min : dp;
    } else {
      out[p] = cd < 255.0f ? best_d : dp;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    pi_scan_kernel(const int32_t* __restrict__ disp, const float* __restrict__ img,
                   const int32_t* __restrict__ offs, int32_t* __restrict__ out, int h, int w,
                   int depth, int disp_occ) {
  extern __shared__ int2 s_offs[];      // step s of ray k at s * kDirs + k
  __shared__ int2 s_hole[kPixels];       // the block's holes: (v, u),
  __shared__ int32_t s_value[kPixels];   // and value
  __shared__ int s_count[kPixels / 32];  // holes of each warp
  for (int i = threadIdx.x; i < kDirs * 16; i += kThreads) {  // 16 threads a ray
    const int k = i / 16;
    for (int s = i % 16; s < depth; s += 16) {
      s_offs[s * kDirs + k] = make_int2(offs[2 * (k * depth + s)], offs[2 * (k * depth + s) + 1]);
    }
  }
  const long long n = static_cast<long long>(h) * w;
  const long long base = blockIdx.x * static_cast<long long>(kPixels);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  int32_t d0 = 0;
  bool hole = false;
  unsigned holes = 0;
  if (threadIdx.x < kPixels) {
    if (base + threadIdx.x < n) {
      d0 = disp[base + threadIdx.x];
      hole = d0 < 0;
      if (!hole) out[base + threadIdx.x] = d0;
    }
    holes = __ballot_sync(0xffffffffu, hole);
    if (lane == 0) s_count[warp] = __popc(holes);
  }
  __syncthreads();
  int n_holes = 0, first = 0;  // the block's holes, and those of the warps before this
  for (int i = 0; i < kPixels / 32; ++i) {
    if (i == warp) first = n_holes;
    n_holes += s_count[i];
  }
  if (hole) {
    const int slot = first + __popc(holes & ((1u << lane) - 1));
    const long long p = base + threadIdx.x;
    const int v = static_cast<int>(p / w);
    s_hole[slot] = make_int2(v, static_cast<int>(p - static_cast<long long>(v) * w));
    s_value[slot] = d0;
  }
  __syncthreads();

  const int k = lane & 15;
  const unsigned half = 0xffffu << (lane & 16);  // this half-warp's lanes
  for (int slot = threadIdx.x / 16; slot < n_holes; slot += kThreads / 16) {
    fill_hole(disp, img, out, s_offs, s_hole[slot].x, s_hole[slot].y, s_value[slot], h, w,
              depth, disp_occ, k, half);
  }
}

}  // namespace

// disp/out: [H, W] int32; img: [H, W, 3] float32 (channels last, the
// pipeline's image layout); offs: [16, depth, 2] int32 (dv, du), depth <= 256.
extern "C" int mysm_pi_scan(const int32_t* disp, const float* img, const int32_t* offs,
                            int32_t* out, int h, int w, int depth, int disp_occ,
                            void* stream) {
  if (depth < 1 || depth > kMaxDepth) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(h) * w + kPixels - 1) / kPixels;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int2) * kDirs * depth;
  pi_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(disp, img, offs, out, h, w, depth,
                                                        disp_occ);
  return static_cast<int>(cudaGetLastError());
}
