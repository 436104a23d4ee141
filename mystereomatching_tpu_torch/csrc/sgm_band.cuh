// The SGM path-cost recurrence over a band of scan lines, staged through
// shared memory. Shared by kernel C (sgm_scan.cu, lines along H or W) and
// kernel E (sgm_diag.cu, diagonal lines); they differ only in the geometry
// of a band: which image pixels a stage's box holds and how each line walks
// through it.
//
// What it computes, for one volume's [D, H, W] costs and one scan line:
//   minL = min_d L(prev, d)
//   best = min(min(L(prev, d), minL + P2 s), min(L(prev, d-1), L(prev, d+1)) + P1 s)
//   L(cur, d) = (C(cur, d) + best) - minL
// with s = pscale at cur and L(prev) = 0 before the first step of the line
// (so the first step gives L = C, the reference's scan-edge rule,
// h:2277-2279). Three optional pieces serve the row-band pipeline, whose
// scans cross the bands: an initial carry, the neighbouring band's last L
// row, in place of those zeros; an in-image mask, by which each L is
// multiplied (0 or 1) before it is stored and carried, for skewed diagonal
// buffers; and a copy of each line's last L (the row the next band starts
// from) into a separate row buffer. The
// operation order is that of sgm._scan_down and the TPU kernels; with
// -fmad=false the result is bit-identical to the plain torch versions. The
// volumes are float32 or bfloat16 (the storage type T). In bfloat16 every
// operation rounds to bfloat16 (storage.cuh), P1 s and P2 s too before they
// are added, as the JAX CPU path computes it; the carried
// path costs stay in registers as floats holding bfloat16 values, and the
// edge fill is bfloat16's largest finite value.
//
// What bounds it on the H100: bytes. Each direction reads the costs and the
// penalty scales once and writes the path costs once; the recurrence itself
// (a 5-level shuffle min a step, ~300 cycles) is far shorter than a step's
// share of that traffic, provided the bytes move in whole sectors and
// several steps are in flight.
//
// Design:
// - A block owns a band of Geom::kLines adjacent scan lines of one volume,
//   one warp a line with D across the lanes (slot k of lane l holds
//   d = 32 k + l) and the carried D-vector in registers, as the warp-a-line
//   kernels had.
// - A stage is Geom::kBox / kLines steps of the band: a box of Geom::kBox
//   pixels, Geom::kCols of them adjacent in memory on each image row, for
//   all D.
// - All threads copy the next stages' boxes from device memory into a ring of
//   ring_depth stages in shared memory with 4-byte cp.async (consecutive
//   threads on consecutive columns), while the warps run the recurrence on the
//   current stage. A bfloat16 cost is copied as the aligned 4-byte word that
//   holds it, into its float's slot of the box; the recurrence takes the
//   word's half that holds the cost (from the parity of its element index,
//   kept for each box pixel) and widens it. A box therefore takes the same
//   shared memory in both types. The ring is kMaxRing stages deep where
//   that many fit in a block's 227 KB, else as deep as fits. TMA does not
//   fit: it needs 16-byte global strides, and W * 4 is not one in general
//   (W = 450, and the odd widths of the tests).
// - The recurrence reads C from the box and writes L in place over it; after
//   the stage the block stores the box back out, row segments whole. One
//   __syncthreads before and one after the recurrence, per stage.
// - A box keeps disparity d at d * (kBox + 1), an odd pitch, so the 32 lanes
//   of a warp (32 disparities of one pixel) fall in 32 different banks, and
//   the copies (32 consecutive pixels of one disparity) stay conflict-free.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "storage.cuh"

namespace mysm {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxRing = 4;           // stages in shared memory, at most
constexpr int kMaxSmem = 227 * 1024;  // bytes of shared memory a block may have

// 4-byte words of one stage: a box of kBox pixels for nd disparities, its
// scales, in bfloat16 the parity of each pixel's element index in disparity
// plane 0, and with an in-image mask (kMasked) the mask
template <typename T, bool kMasked = false>
__host__ __device__ constexpr int stage_words(int nd, int box) {
  return nd * (box + 1) + box + (kIsBf16<T> ? box : 0) + (kMasked ? box : 0);
}

// stages in shared memory for up to 32 kSlots disparities
template <typename T, int kSlots, int kBox, bool kMasked = false>
constexpr int ring_depth =
    kMaxSmem / (4 * stage_words<T, kMasked>(32 * kSlots, kBox)) < kMaxRing
        ? kMaxSmem / (4 * stage_words<T, kMasked>(32 * kSlots, kBox))
        : kMaxRing;

// min(a, b), NaN when either is NaN: torch.minimum's and amin's rule (and
// jnp.minimum's), which the plain versions follow. fminf would return the
// other operand, so a NaN cost (ZNCC's, where rounding makes a window's
// variance negative) would stop at the kernel and run on in the plain path.
__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The cost in box slot i: the float itself, or in bfloat16 the half of the
// staged word that holds it (the upper one when its element index is odd).
template <typename T>
__device__ __forceinline__ float box_cost(const float* box, int i, int odd) {
  if constexpr (kIsBf16<T>) {
    const unsigned word = __float_as_uint(box[i]);
    return __uint_as_float(odd ? word & 0xffff0000u : word << 16);
  } else {
    return box[i];
  }
}

// n steps of one scan line through a box: pixel idx, idx + stride, ...;
// costs at box[d * kPitch + idx] are replaced by the path costs (floats),
// scales at scale[idx], in bfloat16 the parities at parity[idx], which
// flip from one disparity plane to the next when the plane is odd
// (plane_odd), and with kMasked the in-image mask at mask[idx]. prev carries
// the line's last path costs between calls.
template <typename T, int kSlots, int kPitch, bool kMasked = false>
__device__ __forceinline__ void sgm_steps(float* box, const float* scale, const int* parity,
                                          const float* mask, int plane_odd, int idx, int stride,
                                          int n, int nd, float p1, float p2,
                                          float (&prev)[kSlots]) {
  constexpr float kBig = kMaxValue<T>;
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < n; ++t, idx += stride) {
    const int odd0 = kIsBf16<T> ? parity[idx] : 0;
    float c[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int d = k * 32 + lane;
      c[k] = d < nd ? box_cost<T>(box, d * kPitch + idx, odd0 ^ (d & plane_odd)) : 0.0f;
    }
    const float s = scale[idx];
    float min_l = kBig;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (k * 32 + lane < nd) min_l = fmin_nan(min_l, prev[k]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) min_l = fmin_nan(min_l, __shfl_xor_sync(kFullMask, min_l, o));
    const float p1s = round_to<T>(__fmul_rn(p1, s));
    const float jump = round_to<T>(__fadd_rn(min_l, round_to<T>(__fmul_rn(p2, s))));
    const float m = kMasked ? mask[idx] : 1.0f;

    float cur[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int d = k * 32 + lane;
      // d - 1: lane - 1 of this slot, or lane 31 of the slot below
      float up = __shfl_up_sync(kFullMask, prev[k], 1);
      const float below = __shfl_sync(kFullMask, k > 0 ? prev[k - 1] : kBig, 31);
      if (lane == 0) up = below;
      // d + 1: lane + 1 of this slot, or lane 0 of the slot above
      float dn = __shfl_down_sync(kFullMask, prev[k], 1);
      const float above = __shfl_sync(kFullMask, k + 1 < kSlots ? prev[k + 1] : kBig, 0);
      if (lane == 31) dn = above;
      if (d + 1 >= nd) dn = kBig;
      cur[k] = 0.0f;
      if (d < nd) {
        const float best =
            fmin_nan(fmin_nan(prev[k], jump), round_to<T>(__fadd_rn(fmin_nan(up, dn), p1s)));
        cur[k] = round_to<T>(__fsub_rn(round_to<T>(__fadd_rn(c[k], best)), min_l));
        if constexpr (kMasked) cur[k] = round_to<T>(__fmul_rn(cur[k], m));
        box[d * kPitch + idx] = cur[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) prev[k] = cur[k];
  }
}

// One block's band of one volume: vol/out [D, H, W] costs and path costs
// (float or bfloat16) and scale [H, W], with plane = H * W. The geometry gives
//   kLines:                  the band's scan lines, one warp each;
//   kBox:                    the pixels of a stage's box;
//   kCols:                   the box's pixels on each image row (a box
//                            pixel b is row b / kCols, column b % kCols);
//   n_stages():              the stages of the band;
//   pixel(s, b):             the plane offset of pixel b of stage s's box,
//                            or -1 where that pixel lies outside the image
//                            or outside the band's lines;
//   walk(s, l, idx, stride, begins):
//                            the steps of line l in stage s (returned), the
//                            box pixel of the first and the stride, and
//                            whether the first is the first step of a line
//                            (the warp's carry restarts there: from 0, or
//                            from init).
// init, when not null, is the carry each line starts from: line l's path
// cost at disparity d is init[d * init_pitch + l]. With kMasked, mask [H, W]
// holds the in-image mask (0 or 1) by which every path cost is multiplied;
// a null mask stages 1.0f instead, and x * 1.0f is x in both types. With
// kEdge and a non-null edge, each line's last step is also stored at
// edge[d * geom.edge_pitch() + geom.edge(s, b)] (edge(s, b) is -1 for
// every other box pixel).
template <typename T, int kSlots, class Geom, bool kMasked = false, bool kEdge = false>
__device__ __forceinline__ void sgm_band(const T* __restrict__ vol,
                                         const float* __restrict__ scale,
                                         T* __restrict__ out, long long plane, int nd,
                                         float p1, float p2, const Geom& geom,
                                         const T* __restrict__ init = nullptr,
                                         long long init_pitch = 0,
                                         const float* __restrict__ mask = nullptr,
                                         T* __restrict__ edge = nullptr) {
  constexpr int kBox = Geom::kBox, kPitch = kBox + 1;
  constexpr int kThreads = Geom::kLines * 32;
  constexpr int kDStride = kThreads / kBox;  // disparities between a thread's copies
  constexpr int kRing = ring_depth<T, kSlots, kBox, kMasked>;
  // offset of a stage's mask in its box: after the costs, scales and parities
  constexpr int kMaskAt = kBox + (kIsBf16<T> ? kBox : 0);
  static_assert(kThreads % kBox == 0, "every thread copies the same pixel of each box");
  static_assert(kRing >= 2, "the ring holds the current stage and the next");
  extern __shared__ float ring[];
  const int b = threadIdx.x % kBox;       // this thread's pixel of every box
  const int d0 = threadIdx.x / kBox;      // its first disparity
  const int line = threadIdx.x / 32;
  const int n_stages = geom.n_stages();
  const int plane_odd = static_cast<int>(plane & 1);
  auto box_of = [&](int s) { return ring + (s % kRing) * stage_words<T, kMasked>(nd, kBox); };
  auto load = [&](int s) {
    if (s >= n_stages) return;
    const long long off = geom.pixel(s, b);
    if (off < 0) return;
    float* box = box_of(s);
    for (int d = d0; d < nd; d += kDStride) {
      const T* src = vol + d * plane + off;
      if constexpr (kIsBf16<T>) {  // the aligned word holding it
        cp_async4(box + d * kPitch + b,
                  reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(src) & ~uintptr_t{3}));
      } else {
        cp_async4(box + d * kPitch + b, src);
      }
    }
    if (d0 == 0) {
      cp_async4(box + nd * kPitch + b, scale + off);
      if constexpr (kIsBf16<T>) {
        reinterpret_cast<int*>(box + nd * kPitch + kBox)[b] =
            static_cast<int>((reinterpret_cast<uintptr_t>(vol + off) >> 1) & 1);
      }
      if constexpr (kMasked) {
        if (mask != nullptr) {
          cp_async4(box + nd * kPitch + kMaskAt + b, mask + off);
        } else {
          box[nd * kPitch + kMaskAt + b] = 1.0f;
        }
      }
    }
  };

  float prev[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) prev[k] = 0.0f;
  // one commit group a stage, empty past the end, so that the wait below
  // always leaves exactly the kRing - 2 newer stages in flight
  for (int s = 0; s < kRing - 1; ++s) {
    load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // stage s is in; stage s - 1's box has been stored
    load(s + kRing - 1);
    cp_async_commit();
    float* box = box_of(s);
    int idx = 0, stride = 0;
    bool begins = false;
    const int n = geom.walk(s, line, idx, stride, begins);
    if (begins) {
      const int lane = threadIdx.x & 31;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int d = k * 32 + lane;
        prev[k] = init != nullptr && n > 0 && d < nd ? widen(init[d * init_pitch + line]) : 0.0f;
      }
    }
    sgm_steps<T, kSlots, kPitch, kMasked>(
        box, box + nd * kPitch, reinterpret_cast<const int*>(box + nd * kPitch + kBox),
        box + nd * kPitch + kMaskAt, plane_odd, idx, stride, n, nd, p1, p2, prev);
    __syncthreads();  // every line's path costs of stage s are in the box
    const long long off = geom.pixel(s, b);
    if (off >= 0) {
      for (int d = d0; d < nd; d += kDStride) out[d * plane + off] = narrow<T>(box[d * kPitch + b]);
      if constexpr (kEdge) {
        const int e = edge != nullptr ? geom.edge(s, b) : -1;
        if (e >= 0) {
          const long long pitch = geom.edge_pitch();
          for (int d = d0; d < nd; d += kDStride) {
            edge[d * pitch + e] = narrow<T>(box[d * kPitch + b]);
          }
        }
      }
    }
  }
}

// Calls f(std::integral_constant<int, kSlots>{}) with kSlots = ceil(nd / 32);
// returns false, calling nothing, unless 1 <= nd <= 256.
template <typename F>
bool with_slots(int nd, F&& f) {
  switch ((nd + 31) / 32) {
    case 1: f(std::integral_constant<int, 1>{}); return true;
    case 2: f(std::integral_constant<int, 2>{}); return true;
    case 3: f(std::integral_constant<int, 3>{}); return true;
    case 4: f(std::integral_constant<int, 4>{}); return true;
    case 5: f(std::integral_constant<int, 5>{}); return true;
    case 6: f(std::integral_constant<int, 6>{}); return true;
    case 7: f(std::integral_constant<int, 7>{}); return true;
    case 8: f(std::integral_constant<int, 8>{}); return true;
    default: return false;
  }
}

// Launches kernel<<<blocks, Geom's threads, ring>>> with the ring of boxes
// of storage type T (with their masks when kMasked) for nd <= 32 kSlots
// disparities as dynamic shared memory
// (above 48 KB it must be allowed first, for each instance; the carveout
// asks for all of it, so that blocks whose rings are small share an SM);
// returns the CUDA error.
template <typename T, int kSlots, class Geom, bool kMasked = false, typename Kernel,
          typename... Args>
cudaError_t launch_band(Kernel kernel, unsigned blocks, int nd, void* stream, Args... args) {
  const int bytes = ring_depth<T, kSlots, Geom::kBox, kMasked> *
                    stage_words<T, kMasked>(nd, Geom::kBox) * 4;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  kernel<<<blocks, Geom::kLines * 32, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace mysm
