// The SGM-layout probes: the path-cost scan of kernel C on volumes laid out
// [G, H, D, W], the D values of a row stored together, scanned top-down
// along H. On no pipeline path: they answer, on this card, the questions
// the TPU probes asked about kernel C.
//
// Replaces the four TPU kernels of scripts/check_sgm3.py, check_sgm4.py and
// check_sgm5.py, each split over H chunks in VMEM with the carry in scratch:
//   check_sgm3.py:18 kern_hdw (pallas_call :49), a block a (g, W tile)
//                                         -> sgm_probe_hdw_kernel
//   check_sgm4.py:17 kern_g (:48), all G volumes in one block
//                                         -> sgm_probe_g_kernel
//   check_sgm5.py:17 make(kind) (:53), G in the block, the row loop rolled
//                                         -> sgm_probe_rolled_kernel (prev, full),
//                                            sgm_probe_rolled_kernel_copy (copy)
//   check_sgm5.py:74 make_unrolled(kind) (:108), the row loop unrolled
//                                         -> sgm_probe_unrolled_kernel (full),
//                                            sgm_probe_unrolled_kernel_copy (copy)
// Here each covers the whole of H in one launch.
//
// What they compute, per column x of volume g, from a zero carry L(-1) = 0
// (row r's costs C(r, d), its penalty scale s = ps[g, r, x]):
//   full: minL = min_d L(r-1, d)
//         best = min(min(L(r-1, d), minL + p2 s), min(L(r-1, d-1), L(r-1, d+1)) + p1 s)
//         L(r, d) = (C(r, d) + best) - minL,  L(r-1, -1) = L(r-1, D) = edge
//   copy: L(r, d) = C(r, d) * 1.01
//   prev: L(r, d) = C(r, d) + L(r-1, d) * 0.5
// The full kinds add in the TPU kernels' order, which is kernel C's (see
// sgm_band.cuh), so with -fmad=false a full scan transposed to
// [G, D, H, W] equals kernel C's downward scan bit for bit. The edge is
// FLT_MAX for kern_hdw and kern_g, 3.4e38 for check_sgm5.py's kinds: it
// never wins a min unless every cost is that large.
//
// What bounds them on the H100: bytes. Each reads the costs (and in full
// the scales) once and writes the path costs once, against about 8
// operations an element.
//
// Design (simple first): a block is a tile of 32 adjacent columns (a
// warp's width) of one volume (hdw) or of all G (g, rolled prev and full,
// unrolled full), 8 warps a volume; warp j of a volume takes disparities j,
// j + 8, ..., so that each load and store of a warp is one 128-byte row
// segment of one disparity. A thread keeps its disparities' costs for the next two rows
// in registers (kPer of them a row, chosen from D at launch): each row's
// loads are issued two rows ahead, so that their latency hides behind two
// rows' work (PERF.md compares one row ahead). prev keeps its carry in
// registers too; full keeps the carry in shared memory, [2][G][D][32]
// (double-buffered: a thread reads its neighbours' d - 1 and d + 1 from the
// other warps), and each warp's minimum of its new path costs,
// [2][8 G][32]; one __syncthreads a row.
// D <= 256 (kPer <= 32 floats); full's shared memory is
// 256 (D + 8) G bytes, at most 227 KB. The unrolled full kind unrolls the
// row loop by kUnroll = 8 (the TPU's chunk is a multiple of 8 rows).
//
// Both copies, rolled and unrolled, are one streaming pass instead
// (stream_copy, launched as sgm_probe_rolled_kernel_copy and
// sgm_probe_unrolled_kernel_copy, so that a profile names each apart): the
// copy carries nothing from row to row, so the row walk above, the TPU's
// sequential grid carried over, only held the card to ceil(W / 32) blocks
// (15 at W = 450, 32 at W = 1000, on 132 SMs). "Rolled" and "unrolled" name
// how the TPU kernels wrote their row loop; the function, c * 1.01, is the
// same. The pass goes over the G H D W elements as one flat array, a block a
// tile of kStreamTile floats (9,888 blocks at [4, 375, 60, 450]): each
// thread loads its kStreamVec 16-byte words before it stores any, with
// scalars for the at most 3 elements before vol's first 16-byte boundary and
// after its last (every element a scalar where vol and out lie differently
// against 16 bytes), and 64-bit offsets; ps is not read.
#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;      // columns a block: a warp's width
constexpr int kWarpsPerG = 8;  // warps a volume
constexpr int kMaxG = 4;       // volumes in one block: 32 kMaxG warps
constexpr int kUnroll = 8;     // rows an unrolled step
constexpr int kMaxSmem = 227 * 1024;
constexpr int kStreamThreads = 256;  // the streaming copy: threads a block
constexpr int kStreamVec = 4;        // 16-byte words a thread, all loaded before any store
constexpr int kStreamTile = kStreamThreads * kStreamVec * 4;  // floats a block

enum Kind { kCopy = 0, kPrev = 1, kFull = 2 };
enum Entry { kHdw = 0, kG = 1, kRolled = 2, kUnrolled = 3 };

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float copy_body(float c) { return __fmul_rn(c, 1.01f); }

// The streaming copy: out = vol * 1.01 over the n floats of vol, on
// ceil(n / kStreamTile) blocks. Where vol and out start at the same offset
// within 16 bytes, block b takes the 16-byte words [b, b + 1) kStreamTile / 4
// from vol's first 16-byte boundary on; block 0 also the scalars before it
// (at most 3), the last block those after the last word (at most 3).
// Otherwise block b takes the elements [b, b + 1) kStreamTile as scalars.
__device__ __forceinline__ void stream_copy(const float* __restrict__ vol,
                                            float* __restrict__ out, long long n) {
  const unsigned skew = static_cast<unsigned>(reinterpret_cast<size_t>(vol) & 15);
  if (skew != (reinterpret_cast<size_t>(out) & 15)) {
    const long long t0 = static_cast<long long>(blockIdx.x) * kStreamTile;
    const long long t1 = t0 + kStreamTile < n ? t0 + kStreamTile : n;
    for (long long i = t0 + threadIdx.x; i < t1; i += kStreamThreads) {
      out[i] = copy_body(vol[i]);
    }
    return;
  }
  const long long first = ((16 - skew) & 15) / 4;  // scalars before the first boundary
  const long long head = first < n ? first : n;
  const long long words = (n - head) / 4;
  const long long w0 = static_cast<long long>(blockIdx.x) * (kStreamTile / 4);
  const float4* v4 = reinterpret_cast<const float4*>(vol + head);
  float4* o4 = reinterpret_cast<float4*>(out + head);
  float4 c[kStreamVec];
#pragma unroll
  for (int k = 0; k < kStreamVec; ++k) {
    const long long i = w0 + k * kStreamThreads + threadIdx.x;
    if (i < words) c[k] = v4[i];
  }
#pragma unroll
  for (int k = 0; k < kStreamVec; ++k) {
    const long long i = w0 + k * kStreamThreads + threadIdx.x;
    if (i < words) {
      o4[i] = make_float4(copy_body(c[k].x), copy_body(c[k].y), copy_body(c[k].z),
                          copy_body(c[k].w));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < head) out[threadIdx.x] = copy_body(vol[threadIdx.x]);
  const long long tail = head + 4 * words + threadIdx.x;
  if (blockIdx.x == gridDim.x - 1 && tail < n) out[tail] = copy_body(vol[tail]);
}

__global__ void __launch_bounds__(kStreamThreads)
    sgm_probe_rolled_kernel_copy(const float* __restrict__ vol, float* __restrict__ out,
                                 long long n) {
  stream_copy(vol, out, n);
}

__global__ void __launch_bounds__(kStreamThreads)
    sgm_probe_unrolled_kernel_copy(const float* __restrict__ vol, float* __restrict__ out,
                                   long long n) {
  stream_copy(vol, out, n);
}

// The rows of one block: volumes g0 .. g0 + blockDim.y / 8 - 1, columns
// x0 .. x0 + 31. vol/out [G, H, D, W]; ps [G, H, W].
template <int kKind, int kPer, int kRowUnroll>
__device__ __forceinline__ void probe_rows(const float* __restrict__ vol,
                                           const float* __restrict__ ps,
                                           float* __restrict__ out, int g0, int nd, int h,
                                           int w, float p1, float p2, float edge) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int gl = wy / kWarpsPerG;  // volume within the block
  const int j = wy % kWarpsPerG;   // first disparity of this warp
  const int gb = blockDim.y / kWarpsPerG;
  const int x = blockIdx.x * kCols + lane;
  const bool in = x < w;
  const int n = j < nd ? (nd - 1 - j) / kWarpsPerG + 1 : 0;  // this thread's disparities
  const int dstep = kWarpsPerG * w;  // from one of them to the next, in a row
  const long long row_stride = static_cast<long long>(nd) * w;
  const long long first = static_cast<long long>(g0 + gl) * h * row_stride + j * w + x;
  const float* s_col = ps + static_cast<long long>(g0 + gl) * h * w + x;
  // full: carry[2][gb][nd][kCols], then pmin[2][8 gb][kCols]; a thread's
  // disparity d = j + 8 k of volume gl at carry[(gl nd + d) kCols + lane]
  const int plane = gb * nd * kCols;
  float* carry = smem + (gl * nd + j) * kCols + lane;
  float* pmin = smem + 2 * plane + lane;
  const int cstep = kWarpsPerG * kCols;

  float c[kPer], cn[kPer], prev[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    c[k] = (in && k < n) ? vol[first + k * dstep] : 0.0f;
    cn[k] = (in && k < n && h > 1) ? vol[first + row_stride + k * dstep] : 0.0f;
    prev[k] = 0.0f;
    if constexpr (kKind == kFull) {
      if (k < n) carry[k * cstep] = 0.0f;
    }
  }
  if constexpr (kKind == kFull) {
    pmin[wy * kCols] = 0.0f;
    __syncthreads();
  }

#pragma unroll kRowUnroll
  for (int r = 0; r < h; ++r) {
    // the costs of the row after next, loaded two rows ahead
    const float* vn = vol + first + (r + 2) * row_stride;
    float cnn[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) cnn[k] = (in && k < n && r + 2 < h) ? vn[k * dstep] : 0.0f;
    float* o = out + first + r * row_stride;
    if constexpr (kKind == kFull) {
      const int cur = r & 1;
      const float* cin = carry + cur * plane;
      float* cout = carry + (cur ^ 1) * plane;
      const float* pin = pmin + (cur * gb + gl) * kWarpsPerG * kCols;
      float min_l = inf_f();
#pragma unroll
      for (int jj = 0; jj < kWarpsPerG; ++jj) min_l = fminf(min_l, pin[jj * kCols]);
      const float s = in ? s_col[static_cast<long long>(r) * w] : 0.0f;
      const float p1s = __fmul_rn(p1, s);
      const float jump = __fadd_rn(min_l, __fmul_rn(p2, s));
      float my_min = inf_f();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int d = j + kWarpsPerG * k;
        if (k < n) {
          const float up = d > 0 ? cin[k * cstep - kCols] : edge;
          const float dn = d + 1 < nd ? cin[k * cstep + kCols] : edge;
          const float best =
              fminf(fminf(cin[k * cstep], jump), __fadd_rn(fminf(up, dn), p1s));
          const float l = __fsub_rn(__fadd_rn(c[k], best), min_l);
          if (in) o[k * dstep] = l;
          cout[k * cstep] = l;
          my_min = fminf(my_min, l);
        }
      }
      pmin[((cur ^ 1) * gb * kWarpsPerG + wy) * kCols] = my_min;
      __syncthreads();
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (in && k < n) {
          const float l = __fadd_rn(c[k], __fmul_rn(prev[k], 0.5f));  // prev
          prev[k] = l;
          o[k * dstep] = l;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      c[k] = cn[k];
      cn[k] = cnn[k];
    }
  }
}

// One kernel a TPU kernel, so that each is named apart in a profile. The
// grid is (column tiles, G / volumes a block); blockDim (32, 8 volumes a block).
template <int kPer>
__global__ void __launch_bounds__(kCols * kWarpsPerG)
    sgm_probe_hdw_kernel(const float* vol, const float* ps, float* out, int nd, int h, int w,
                         float p1, float p2, float edge) {
  probe_rows<kFull, kPer, 1>(vol, ps, out, blockIdx.y * (blockDim.y / kWarpsPerG), nd, h, w,
                             p1, p2, edge);
}

template <int kPer>
__global__ void __launch_bounds__(kCols * kWarpsPerG * kMaxG)
    sgm_probe_g_kernel(const float* vol, const float* ps, float* out, int nd, int h, int w,
                       float p1, float p2, float edge) {
  probe_rows<kFull, kPer, 1>(vol, ps, out, blockIdx.y * (blockDim.y / kWarpsPerG), nd, h, w,
                             p1, p2, edge);
}

template <int kKind, int kPer>
__global__ void __launch_bounds__(kCols * kWarpsPerG * kMaxG)
    sgm_probe_rolled_kernel(const float* vol, const float* ps, float* out, int nd, int h,
                            int w, float p1, float p2, float edge) {
  probe_rows<kKind, kPer, 1>(vol, ps, out, blockIdx.y * (blockDim.y / kWarpsPerG), nd, h, w,
                             p1, p2, edge);
}

template <int kKind, int kPer>
__global__ void __launch_bounds__(kCols * kWarpsPerG * kMaxG)
    sgm_probe_unrolled_kernel(const float* vol, const float* ps, float* out, int nd, int h,
                              int w, float p1, float p2, float edge) {
  probe_rows<kKind, kPer, kUnroll>(vol, ps, out, blockIdx.y * (blockDim.y / kWarpsPerG), nd,
                                   h, w, p1, p2, edge);
}

using KernelFn = void (*)(const float*, const float*, float*, int, int, int, float, float,
                          float);

template <int kPer>
KernelFn pick(int entry, int kind) {
  switch (entry) {
    case kHdw: return kind == kFull ? sgm_probe_hdw_kernel<kPer> : nullptr;
    case kG: return kind == kFull ? sgm_probe_g_kernel<kPer> : nullptr;
    case kRolled:
      return kind == kPrev   ? sgm_probe_rolled_kernel<kPrev, kPer>
             : kind == kFull ? sgm_probe_rolled_kernel<kFull, kPer>
                             : nullptr;
    case kUnrolled: return kind == kFull ? sgm_probe_unrolled_kernel<kFull, kPer> : nullptr;
    default: return nullptr;
  }
}

}  // namespace

// vol/out: [G, H, D, W] float32, D <= 256; ps: [G, H, W] float32. entry:
// 0 hdw (a block a volume's column tile), 1 g (a block all G volumes'
// tile, G <= 4), 2 rolled, 3 unrolled (as g); kind: 0 copy, 1 prev, 2 full
// (hdw and g: full only; unrolled: copy or full; copy, rolled or unrolled,
// the streaming pass). edge: the value beyond disparities 0 and D - 1 in
// full.
extern "C" int mysm_sgm_probe(const float* vol, const float* ps, float* out, int g, int nd,
                              int h, int w, int entry, int kind, float p1, float p2,
                              float edge, void* stream) {
  if (g < 1 || nd < 1 || nd > 256 || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((entry == kRolled || entry == kUnrolled) && kind == kCopy) {
    if (g > kMaxG) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long n = static_cast<long long>(g) * h * nd * w;
    const long long blocks = (n + kStreamTile - 1) / kStreamTile;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    const auto copy = entry == kRolled ? sgm_probe_rolled_kernel_copy
                                       : sgm_probe_unrolled_kernel_copy;
    copy<<<static_cast<unsigned>(blocks), kStreamThreads, 0, s>>>(vol, out, n);
    return static_cast<int>(cudaGetLastError());
  }
  const int per = (nd + kWarpsPerG - 1) / kWarpsPerG;
  const KernelFn fn = per <= 8 ? pick<8>(entry, kind) : per <= 16 ? pick<16>(entry, kind)
                                                                  : pick<32>(entry, kind);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int gb = entry == kHdw ? 1 : g;  // volumes a block
  if (gb > kMaxG) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem =
      kind == kFull ? sizeof(float) * 2 * gb * (nd + kWarpsPerG) * kCols : 0;
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((w + kCols - 1) / kCols, g / gb);
  const dim3 block(kCols, kWarpsPerG * gb);
  fn<<<grid, block, smem, s>>>(vol, ps, out, nd, h, w, p1, p2, edge);
  return static_cast<int>(cudaGetLastError());
}
