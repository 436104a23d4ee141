// The taps probes: kernel B's arm-bounded sum written each of the ways the
// TPU probes of scripts/ asked about. On no pipeline path: they answer, on
// this card, what one taps pass costs by layout and by offset scheme.
//
// Replaces the eight TPU kernels of scripts/micro3.py, micro_cbca2.py,
// micro_cbca3.py and micro_cbca5.py (pallas_call line in brackets):
//   micro3.py:34 _kb (:99), rolled registers        -> taps_probe_roll_kernel_{h,w}
//   micro3.py:55 _kc (:99), a zero-padded scratch    -> taps_probe_slice_kernel_{h,w} (dyn)
//   micro_cbca2.py:58 _taps_kernel_fixed (:168)      -> taps_probe_slice_kernel_h (fixed)
//   micro_cbca2.py:83 _taps_kernel_seg (:168)        -> taps_probe_slice_kernel_h (seg)
//   micro_cbca2.py:117 = micro_cbca3.py:131 _taps_kernel_clones (:168, :165)
//                                                    -> taps_probe_clones_kernel (clones)
//   micro_cbca3.py:72 _taps_kernel_oct (:165)        -> taps_probe_clones_kernel (oct)
//   micro_cbca3.py:100 _taps_kernel_clseg (:165)     -> taps_probe_clones_kernel (clseg)
//   micro_cbca5.py:38 _taps_kernel_static (:79)      -> taps_probe_static_kernel
//
// What they compute, for each element x of float32 vol [N, H, W] with int32
// arms an, ap [N, H, W] capped at m = max_arm, along H or W (unit step e):
//   out[x] = vol[x], then for k = 1 .. m: += (ap >= k ? vol[x + k e] : 0),
//                                         += (an >= k ? vol[x - k e] : 0)
// in that order, each add rounded once (the production _taps_kernel's
// order, not kernel B's ascending one). vol is 0 off the image, except in
// roll, where x + k e wraps around the whole axis (_kb's pltpu.roll), and in
// fixed, where every tap reads vol[x - (m % 8) e] (_taps_kernel_fixed's
// aligned base, a timing floor that is wrong by design). A trip count below
// m (a block's or a segment's largest arm) skips only masked taps, which
// add +0.0.
//
// What bounds them on the H100: bytes. Each reads vol and the two int32 arm
// planes once and writes out once (16 bytes an element), against about 4 m
// operations an element in roll and dyn (every step runs) and 2 a tap
// inside the arms elsewhere; real arms average a few taps.
//
// Design (simple first; no tuning):
// - roll: the line lives in registers. Along W a warp holds a row, lane l
//   positions 8 l .. 8 l + 7 (n <= 256) or 16 l .. 16 l + 15 (n <= 512),
//   staged through shared memory at a skewed index (p + p / 32, so the
//   slot reads are conflict-free); a step shifts each line by one with
//   __shfl_sync. Along H a block holds 16 columns, a thread 8 rows of one
//   (n <= 512 rows, 16 ceil(n / 8) threads); the rows cross the thread
//   boundaries through shared memory (double-buffered, one barrier a step).
//   Both wrap at position n - 1, inside the registers of whichever thread
//   holds it.
// - slice: a zero-padded strip in shared memory, read at runtime offsets.
//   Along H a block holds 32 columns (a lane a column) by H + 2 m rows,
//   row-major, so a warp reads one 128-byte row a tap; along W a warp holds
//   a row of W + 2 m. fixed and seg take their trip count from the block's
//   largest in-image arm (per seg rows for seg): each warp's maximum by
//   __reduce_max_sync, then atomicMax in shared memory before the taps.
// - clones: the TPU's 8-aligned sublane slice becomes an aligned float4
//   read of 4 consecutive rows. Copy r of the zero-padded column holds
//   padded[j + r] at j, so the taps at x +- k of a thread's 4 rows start on a
//   4-float boundary of copy k % 4 (forward) or -k % 4 (backward): 4 copies
//   suffice, not the TPU's 8. Each copy is column-major, m8 = 8 ceil(m / 8)
//   + 8 rows of zeros on each side (the TPU's pad, which the oct kind's
//   overshoot of up to 7 taps needs), len = 8 ceil((4 ceil(H / 4) + 2 m8) /
//   8) rows, at a column stride of len rounded up to 4 mod 32 words: the 8
//   lanes of a float4 phase, 8 columns, then fall on 32 different banks (a
//   stride of 472 = 24 mod 32 would put 4 columns on one bank group). At
//   H = 375, m = 34: len 472, stride 484, 4 copies x 8 columns x 484 x 4 B =
//   61,952 B, 3 blocks an SM; 16 columns (124 KB) would leave one. A block
//   is 8 columns of one plane, its 256 threads 8 columns x 32 row groups of
//   4 rows. oct unrolls 8 taps an octave with the copy index static.
// - static: slice's strip with m = 34 a template constant, every tap's
//   offset an immediate; each octave of kOct taps runs only when the block's
//   largest arm reaches its first tap (block-uniform, so no divergence);
//   the accumulator stays in a register.
// fixed, seg, clones, oct, clseg and static read the arms twice (once for
// the block's largest, once for the masks; the second read mostly from L2).
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxLine = 512;     // roll: the longest line
constexpr int kRollCols = 16;     // roll along H: columns a block
constexpr int kRollRows = 8;      // roll along H: rows a thread
constexpr int kStrip = 32;        // slice, static: columns a block, a lane each
constexpr int kCloneCols = 8;     // clones: columns a block
constexpr int kCopies = 4;        // clones: shifted copies (float4 alignment)
constexpr int kStaticArm = 34;    // static: the TPU probe's max_arm

enum Entry { kRoll = 0, kSlice = 1, kClones = 2, kStatic = 3 };
enum SliceKind { kDyn = 0, kFixed = 1, kSeg = 2 };
enum CloneKind { kClonesDyn = 0, kOct = 1, kClseg = 2 };

__host__ __device__ constexpr int round_up(int x, int a) { return (x + a - 1) / a * a; }

// acc + (on ? x : +0.0f), rounded once: every probe's masked add.
__device__ __forceinline__ float tap(float acc, bool on, float x) {
  return __fadd_rn(acc, on ? x : 0.0f);
}

__device__ __forceinline__ size_t plane_offset(int plane, int h, int w) {
  return static_cast<size_t>(plane) * h * w;
}

// ---- roll ----------------------------------------------------------------

__host__ __device__ constexpr int skew(int p) { return p + (p >> 5); }

// Along W: a warp a row of n <= 32 kP elements, lane l at positions
// l kP .. l kP + kP - 1. Grid: ceil(lines / 8) blocks of 256.
template <int kP>
__global__ void __launch_bounds__(kThreads)
    taps_probe_roll_kernel_w(const float* __restrict__ vol, const int* __restrict__ an,
                             const int* __restrict__ ap, float* __restrict__ out,
                             long long lines, int n, int m) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long line = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (line >= lines) return;  // whole warps; no block barrier follows
  float* row = smem + warp * skew(32 * kP);
  int* irow = reinterpret_cast<int*>(row);
  const size_t base = static_cast<size_t>(line) * n;
  const int p0 = lane * kP;

  float acc[kP], f[kP], b[kP];
  int cn[kP], cp[kP];
  for (int p = lane; p < n; p += 32) row[skew(p)] = vol[base + p];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kP; ++j) acc[j] = p0 + j < n ? row[skew(p0 + j)] : 0.0f;
  __syncwarp();
  for (int p = lane; p < n; p += 32) irow[skew(p)] = an[base + p];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kP; ++j) cn[j] = p0 + j < n ? min(irow[skew(p0 + j)], m) : 0;
  __syncwarp();
  for (int p = lane; p < n; p += 32) irow[skew(p)] = ap[base + p];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    cp[j] = p0 + j < n ? min(irow[skew(p0 + j)], m) : 0;
    f[j] = acc[j];
    b[j] = acc[j];
  }
  __syncwarp();

  const int jw = n - 1 - p0;          // the slot of position n - 1, where it is this lane's
  const int last_lane = (n - 1) / kP;  // the lane holding position n - 1
  for (int k = 1; k <= m; ++k) {
    // forward: position p takes (p + 1) mod n; backward: (p - 1) mod n
    const float next = __shfl_down_sync(kFull, f[0], 1);
    const float first = __shfl_sync(kFull, f[0], 0);
    float last = b[kP - 1];
#pragma unroll
    for (int j = 0; j < kP; ++j) last = j == jw ? b[j] : last;
    const float prev = __shfl_up_sync(kFull, b[kP - 1], 1);
    const float wrap = __shfl_sync(kFull, last, last_lane);
#pragma unroll
    for (int j = 0; j < kP; ++j) f[j] = j == jw ? first : (j + 1 < kP ? f[j + 1] : next);
#pragma unroll
    for (int j = kP - 1; j > 0; --j) b[j] = b[j - 1];
    b[0] = lane == 0 ? wrap : prev;
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      acc[j] = tap(acc[j], cp[j] >= k, f[j]);
      acc[j] = tap(acc[j], cn[j] >= k, b[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    if (p0 + j < n) row[skew(p0 + j)] = acc[j];
  }
  __syncwarp();
  for (int p = lane; p < n; p += 32) out[base + p] = row[skew(p)];
}

// Along H: a block 16 columns of one plane, thread (g, c) rows 8 g .. 8 g + 7
// of column c; blockDim 16 ceil(h / 8) <= 1024. Grid (ceil(w / 16), N).
// Shared memory: the forward and backward hand-offs, [2][G][16] each.
__global__ void __launch_bounds__(1024)
    taps_probe_roll_kernel_h(const float* __restrict__ vol, const int* __restrict__ an,
                             const int* __restrict__ ap, float* __restrict__ out, int h,
                             int w, int m) {
  extern __shared__ float smem[];
  const int groups = blockDim.x / kRollCols;
  const int c = threadIdx.x % kRollCols;
  const int g = threadIdx.x / kRollCols;
  const int x = blockIdx.x * kRollCols + c;
  const size_t base = plane_offset(blockIdx.y, h, w) + x;
  const int r0 = g * kRollRows;

  float acc[kRollRows], f[kRollRows], b[kRollRows];
  int cn[kRollRows], cp[kRollRows];
#pragma unroll
  for (int j = 0; j < kRollRows; ++j) {
    const bool ok = x < w && r0 + j < h;
    const size_t i = base + static_cast<size_t>(r0 + j) * w;
    acc[j] = ok ? vol[i] : 0.0f;
    cn[j] = ok ? min(an[i], m) : 0;
    cp[j] = ok ? min(ap[i], m) : 0;
    f[j] = acc[j];
    b[j] = acc[j];
  }
  const int jw = h - 1 - r0;  // the slot of row h - 1, where it is this thread's
  const int gn = g + 1 == groups ? 0 : g + 1;
  const int gp = g == 0 ? groups - 1 : g - 1;
  for (int k = 1; k <= m; ++k) {
    float* hf = smem + (k & 1) * groups * kRollCols;
    float* hb = smem + (2 + (k & 1)) * groups * kRollCols;
    float last = b[kRollRows - 1];
#pragma unroll
    for (int j = 0; j < kRollRows; ++j) last = j == jw ? b[j] : last;
    hf[g * kRollCols + c] = f[0];
    hb[g * kRollCols + c] = last;
    __syncthreads();
    const float next = hf[gn * kRollCols + c];
    const float first = hf[c];
    const float prev = hb[gp * kRollCols + c];
#pragma unroll
    for (int j = 0; j < kRollRows; ++j) {
      f[j] = j == jw ? first : (j + 1 < kRollRows ? f[j + 1] : next);
    }
#pragma unroll
    for (int j = kRollRows - 1; j > 0; --j) b[j] = b[j - 1];
    b[0] = prev;
#pragma unroll
    for (int j = 0; j < kRollRows; ++j) {
      acc[j] = tap(acc[j], cp[j] >= k, f[j]);
      acc[j] = tap(acc[j], cn[j] >= k, b[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kRollRows; ++j) {
    if (x < w && r0 + j < h) out[base + static_cast<size_t>(r0 + j) * w] = acc[j];
  }
}

// ---- the strip along H: slice (dyn, fixed, seg) and static ---------------

// Stages the strip of 32 columns (a lane each) of plane blockIdx.y into s
// [(h + 2 m)][32], row r holding image row r - m (0 off the image and past
// w); with kseg, kseg[y / seg] becomes the largest in-image arm (capped at
// m, at least 0) of the strip's rows in each segment of seg rows.
__device__ __forceinline__ void stage_strip(const float* __restrict__ vol,
                                            const int* __restrict__ an,
                                            const int* __restrict__ ap, float* s, int* kseg,
                                            int nseg, int h, int w, int m, int seg) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = blockIdx.x * kStrip + lane;
  const size_t base = plane_offset(blockIdx.y, h, w) + x;
  for (int i = threadIdx.x; i < nseg; i += blockDim.x) kseg[i] = 0;
  for (int r = warp; r < h + 2 * m; r += kWarps) {
    const int y = r - m;
    s[r * kStrip + lane] =
        (y >= 0 && y < h && x < w) ? vol[base + static_cast<size_t>(y) * w] : 0.0f;
  }
  __syncthreads();
  if (nseg > 0) {
    for (int y = warp; y < h; y += kWarps) {
      const size_t i = base + static_cast<size_t>(y) * w;
      const int a = __reduce_max_sync(kFull, x < w ? min(max(an[i], ap[i]), m) : 0);
      if (lane == 0) atomicMax(&kseg[y / seg], a);
    }
    __syncthreads();
  }
}

// kKind kDyn (_kc: every element runs m steps), kFixed (_taps_kernel_fixed:
// the block's largest arm, every tap at the aligned base) or kSeg
// (_taps_kernel_seg: each segment of seg rows its own largest arm). Grid
// (ceil(w / 32), N), 256 threads; shared memory: the segments' largest arms
// (4 ceil(nseg / 4) ints), then the strip.
template <int kKind>
__global__ void __launch_bounds__(kThreads)
    taps_probe_slice_kernel_h(const float* __restrict__ vol, const int* __restrict__ an,
                              const int* __restrict__ ap, float* __restrict__ out, int h,
                              int w, int m, int seg) {
  extern __shared__ float smem[];
  const int nseg = kKind == kDyn ? 0 : (h + seg - 1) / seg;
  int* kseg = reinterpret_cast<int*>(smem);
  float* s = smem + round_up(nseg, 4);
  stage_strip(vol, an, ap, s, kseg, nseg, h, w, m, seg);
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * kStrip + lane;
  if (x >= w) return;  // no barrier follows
  const size_t base = plane_offset(blockIdx.y, h, w) + x;
  const int fixed = m - m % 8;  // _taps_kernel_fixed's aligned base, in strip rows
  for (int y = threadIdx.x >> 5; y < h; y += kWarps) {
    const size_t i = base + static_cast<size_t>(y) * w;
    const int cn = min(an[i], m);
    const int cp = min(ap[i], m);
    const float* centre = s + (y + m) * kStrip + lane;
    float acc = *centre;
    const int trips = kKind == kDyn ? m : kseg[y / seg];
    if (kKind == kFixed) {
      const float t = s[(y + fixed) * kStrip + lane];
      for (int k = 1; k <= trips; ++k) {
        acc = tap(acc, cp >= k, t);
        acc = tap(acc, cn >= k, t);
      }
    } else {
      for (int k = 1; k <= trips; ++k) {
        acc = tap(acc, cp >= k, centre[k * kStrip]);
        acc = tap(acc, cn >= k, centre[-k * kStrip]);
      }
    }
    out[i] = acc;
  }
}

// _kc along W: a warp a row of the [N H, W] lines, staged zero-padded into
// shared memory (w + 2 m floats a warp); lanes on consecutive columns.
// Grid ceil(lines / 8) blocks of 256.
__global__ void __launch_bounds__(kThreads)
    taps_probe_slice_kernel_w(const float* __restrict__ vol, const int* __restrict__ an,
                              const int* __restrict__ ap, float* __restrict__ out,
                              long long lines, int w, int m) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long line = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (line >= lines) return;  // whole warps; no block barrier follows
  const int len = w + 2 * m;
  float* row = smem + warp * len;
  const size_t base = static_cast<size_t>(line) * w;
  for (int p = lane; p < len; p += 32) {
    row[p] = p >= m && p < m + w ? vol[base + p - m] : 0.0f;
  }
  __syncwarp();
  for (int x = lane; x < w; x += 32) {
    const int cn = min(an[base + x], m);
    const int cp = min(ap[base + x], m);
    const float* centre = row + m + x;
    float acc = *centre;
    for (int k = 1; k <= m; ++k) {
      acc = tap(acc, cp >= k, centre[k]);
      acc = tap(acc, cn >= k, centre[-k]);
    }
    out[base + x] = acc;
  }
}

// _taps_kernel_static: max_arm kArm and every tap offset compile-time
// constants; an octave of kOct taps runs only when the block's largest arm
// reaches its first tap. Grid (ceil(w / 32), N), 256 threads.
template <int kArm, int kOct>
__global__ void __launch_bounds__(kThreads)
    taps_probe_static_kernel(const float* __restrict__ vol, const int* __restrict__ an,
                             const int* __restrict__ ap, float* __restrict__ out, int h,
                             int w) {
  extern __shared__ float smem[];
  int* kseg = reinterpret_cast<int*>(smem);
  float* s = smem + 4;
  stage_strip(vol, an, ap, s, kseg, 1, h, w, kArm, h);
  const int kmax = kseg[0];
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * kStrip + lane;
  if (x >= w) return;  // no barrier follows
  const size_t base = plane_offset(blockIdx.y, h, w) + x;
  for (int y = threadIdx.x >> 5; y < h; y += kWarps) {
    const size_t i = base + static_cast<size_t>(y) * w;
    const int cn = min(an[i], kArm);
    const int cp = min(ap[i], kArm);
    const float* centre = s + (y + kArm) * kStrip + lane;
    float acc = *centre;
#pragma unroll
    for (int k = 1; k <= kArm; ++k) {
      // an octave's gate; kmax is the block's, so later octaves fail too
      if ((k - 1) % kOct == 0 && kmax < k) break;
      acc = tap(acc, cp >= k, centre[k * kStrip]);
      acc = tap(acc, cn >= k, centre[-k * kStrip]);
    }
    out[i] = acc;
  }
}

// ---- clones ----------------------------------------------------------------

__host__ __device__ constexpr int clone_pad(int m) { return round_up(m, 8) + 8; }
__host__ __device__ constexpr int clone_len(int h, int m) {
  return round_up(round_up(h, 4) + 2 * clone_pad(m), 8);
}
__host__ __device__ constexpr int clone_stride(int len) { return len + (36 - len % 32) % 32; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The forward tap fw and then the backward tap bw of 4 rows, each masked.
__device__ __forceinline__ void tap4(float4& acc, float4 fw, float4 bw, const int* cn,
                                     const int* cp, int k, bool live) {
  acc.x = tap(tap(acc.x, live && cp[0] >= k, fw.x), live && cn[0] >= k, bw.x);
  acc.y = tap(tap(acc.y, live && cp[1] >= k, fw.y), live && cn[1] >= k, bw.y);
  acc.z = tap(tap(acc.z, live && cp[2] >= k, fw.z), live && cn[2] >= k, bw.z);
  acc.w = tap(tap(acc.w, live && cp[3] >= k, fw.w), live && cn[3] >= k, bw.w);
}

// kKind kClonesDyn (the copy index k % 4 at runtime), kOct (8 taps an
// octave, the copy index static) or kClseg (kClonesDyn with each segment's
// largest arm). Grid (ceil(w / 8), N), 256 threads: column c = t % 8, row
// groups t / 8 + 32 i of 4 rows. Shared memory: the segments' largest arms
// (4 ceil(nseg / 4) ints), then copy r of column c at (8 r + c) stride.
template <int kKind>
__global__ void __launch_bounds__(kThreads)
    taps_probe_clones_kernel(const float* __restrict__ vol, const int* __restrict__ an,
                             const int* __restrict__ ap, float* __restrict__ out, int h,
                             int w, int m, int seg) {
  extern __shared__ float smem[];
  const int m8 = clone_pad(m);
  const int len = clone_len(h, m);
  const int stride = clone_stride(len);
  const int nseg = kKind == kClseg ? (h + seg - 1) / seg : 1;
  int* kseg = reinterpret_cast<int*>(smem);
  float* copies = smem + round_up(nseg, 4);
  const int c = threadIdx.x % kCloneCols;
  const int t8 = threadIdx.x / kCloneCols;  // 0 .. 31; a warp's 4 are consecutive
  const int x = blockIdx.x * kCloneCols + c;
  const bool col_ok = x < w;
  const size_t base = plane_offset(blockIdx.y, h, w) + x;
  for (int i = threadIdx.x; i < nseg; i += blockDim.x) kseg[i] = 0;
  // copy r holds padded[j + r] at j; padded[q] is image row q - m8, 0 off it
  for (int q = t8; q < len + kCopies - 1; q += 32) {
    const int y = q - m8;
    const float v = col_ok && y >= 0 && y < h ? vol[base + static_cast<size_t>(y) * w] : 0.0f;
#pragma unroll
    for (int r = 0; r < kCopies; ++r) {
      const int j = q - r;
      if (j >= 0 && j < len) copies[(r * kCloneCols + c) * stride + j] = v;
    }
  }
  __syncthreads();
  // the largest arm: a warp's 4 rows lie in one segment (seg % 4 == 0)
  for (int y = t8; y < round_up(h, 4); y += 32) {
    const size_t i = base + static_cast<size_t>(y) * w;
    const int a = __reduce_max_sync(kFull, col_ok && y < h ? min(max(an[i], ap[i]), m) : 0);
    if ((threadIdx.x & 31) == 0) atomicMax(&kseg[kKind == kClseg ? y / seg : 0], a);
  }
  __syncthreads();
  if (!col_ok) return;  // no barrier follows
  const float* col = copies + c * stride + m8;  // copy 0 at image row 0
  const int cstride = kCloneCols * stride;      // from copy r to copy r + 1
  for (int y0 = 4 * t8; y0 < h; y0 += 4 * 32) {
    int cn[4], cp[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool ok = y0 + t < h;
      const size_t i = base + static_cast<size_t>(y0 + t) * w;
      cn[t] = ok ? min(an[i], m) : 0;
      cp[t] = ok ? min(ap[i], m) : 0;
    }
    float4 acc = ld4(col + y0);
    const int trips = kseg[kKind == kClseg ? y0 / seg : 0];
    if (kKind == kOct) {
      for (int q = 0; q < (trips + 8) / 8; ++q) {
#pragma unroll
        for (int r8 = 0; r8 < 8; ++r8) {
          const int k = 8 * q + r8;
          const int r = r8 & 3;
          const int r2 = (4 - r) & 3;
          tap4(acc, ld4(col + r * cstride + y0 + 8 * q + (r8 - r)),
               ld4(col + r2 * cstride + y0 - 8 * q - (r8 + r2)), cn, cp, k, k >= 1);
        }
      }
    } else {
      for (int k = 1; k <= trips; ++k) {
        const int r = k & 3;
        const int r2 = (4 - r) & 3;
        tap4(acc, ld4(col + r * cstride + y0 + k - r), ld4(col + r2 * cstride + y0 - k - r2),
             cn, cp, k, true);
      }
    }
    const float res[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (y0 + t < h) out[base + static_cast<size_t>(y0 + t) * w] = res[t];
    }
  }
}

// Sets a kernel's dynamic shared memory limit where it needs more than 48 KB.
template <typename Fn>
cudaError_t allow_smem(Fn fn, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidConfiguration;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename Fn, typename... Args>
int launch(Fn fn, dim3 grid, int threads, size_t smem, cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vol/out: [n, h, w] float32; an/ap: [n, h, w] int32. entry 0 roll (kind:
// axis 1 = H or 2 = W; the line at most 512 long), 1 slice (kind 0 dyn
// along axis, 1 fixed or 2 seg along H, param = seg), 2 clones (kind 0
// clones, 1 oct or 2 clseg along H, param = seg, a multiple of 4), 3 static
// (along H, max_arm 34, param = the octave, 8, 16 or 34).
extern "C" int mysm_taps_probe(const float* vol, const int* an, const int* ap, float* out,
                               int n, int h, int w, int entry, int kind, int axis,
                               int max_arm, int param, void* stream) {
  if (n < 1 || h < 1 || w < 1 || max_arm < 0 || (axis != 1 && axis != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long lines = static_cast<long long>(n) * h;
  const dim3 strips((w + kStrip - 1) / kStrip, n);
  const size_t strip_smem = sizeof(float) * static_cast<size_t>(h + 2 * max_arm) * kStrip;
  switch (entry) {
    case kRoll: {
      const int len = axis == 1 ? h : w;
      if (len > kMaxLine) return static_cast<int>(cudaErrorInvalidValue);
      if (axis == 1) {
        const int groups = (h + kRollRows - 1) / kRollRows;
        return launch(taps_probe_roll_kernel_h, dim3((w + kRollCols - 1) / kRollCols, n),
                      kRollCols * groups, sizeof(float) * 4 * groups * kRollCols, st, vol, an,
                      ap, out, h, w, max_arm);
      }
      const dim3 grid(static_cast<unsigned>((lines + kWarps - 1) / kWarps));
      if (w <= 32 * 8) {
        return launch(taps_probe_roll_kernel_w<8>, grid, kThreads,
                      sizeof(float) * kWarps * skew(32 * 8), st, vol, an, ap, out, lines, w,
                      max_arm);
      }
      return launch(taps_probe_roll_kernel_w<16>, grid, kThreads,
                    sizeof(float) * kWarps * skew(32 * 16), st, vol, an, ap, out, lines, w,
                    max_arm);
    }
    case kSlice: {
      if (kind == kDyn && axis == 2) {
        return launch(taps_probe_slice_kernel_w,
                      dim3(static_cast<unsigned>((lines + kWarps - 1) / kWarps)), kThreads,
                      sizeof(float) * kWarps * (w + 2 * max_arm), st, vol, an, ap, out, lines,
                      w, max_arm);
      }
      if (axis != 1) return static_cast<int>(cudaErrorInvalidValue);
      const int seg = kind == kSeg ? param : h;
      if (seg < 1) return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem =
          strip_smem + (kind == kDyn ? 0 : sizeof(int) * round_up((h + seg - 1) / seg, 4));
      switch (kind) {
        case kDyn:
          return launch(taps_probe_slice_kernel_h<kDyn>, strips, kThreads, smem, st, vol, an,
                        ap, out, h, w, max_arm, seg);
        case kFixed:
          return launch(taps_probe_slice_kernel_h<kFixed>, strips, kThreads, smem, st, vol,
                        an, ap, out, h, w, max_arm, seg);
        case kSeg:
          return launch(taps_probe_slice_kernel_h<kSeg>, strips, kThreads, smem, st, vol, an,
                        ap, out, h, w, max_arm, seg);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    case kClones: {
      if (axis != 1 || (kind == kClseg && (param < 4 || param % 4 != 0))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const int seg = kind == kClseg ? param : h;
      const int nseg = kind == kClseg ? (h + seg - 1) / seg : 1;
      const size_t smem = sizeof(int) * round_up(nseg, 4) +
                          sizeof(float) * kCopies * kCloneCols *
                              static_cast<size_t>(clone_stride(clone_len(h, max_arm)));
      const dim3 grid((w + kCloneCols - 1) / kCloneCols, n);
      switch (kind) {
        case kClonesDyn:
          return launch(taps_probe_clones_kernel<kClonesDyn>, grid, kThreads, smem, st, vol,
                        an, ap, out, h, w, max_arm, seg);
        case kOct:
          return launch(taps_probe_clones_kernel<kOct>, grid, kThreads, smem, st, vol, an, ap,
                        out, h, w, max_arm, seg);
        case kClseg:
          return launch(taps_probe_clones_kernel<kClseg>, grid, kThreads, smem, st, vol, an,
                        ap, out, h, w, max_arm, seg);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    case kStatic: {
      if (axis != 1 || max_arm != kStaticArm) return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem = strip_smem + sizeof(int) * 4;
      switch (param) {
        case 8:
          return launch(taps_probe_static_kernel<kStaticArm, 8>, strips, kThreads, smem, st,
                        vol, an, ap, out, h, w);
        case 16:
          return launch(taps_probe_static_kernel<kStaticArm, 16>, strips, kThreads, smem, st,
                        vol, an, ap, out, h, w);
        case kStaticArm:
          return launch(taps_probe_static_kernel<kStaticArm, kStaticArm>, strips, kThreads,
                        smem, st, vol, an, ap, out, h, w);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
