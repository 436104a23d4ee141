// Region vote: one unanimity pass of refine.region_vote in one kernel.
//
// Replaces, on every path that runs region vote, the TPU kernel `_taps_kernel`
// with op="min" and the int32 "sum" (mystereomatching_tpu/ops/pallas_kernels.py),
// as region vote reaches it four times an iteration: refine.region_vote ->
// arms.arm_bounded_reduce -> _try_pallas -> arm_bounded_sum_pallas. Those four
// passes and the elementwise work around them (the valid mask, the stack of
// d and -d, the accept rule) are one launch here, and no intermediate goes
// to device memory. arm_reduce.cu stays as the general single-axis
// counterpart of arm_bounded_reduce.
//
// What it computes, for each pixel p = (v, u) of an int32 [H, W] map d with
// the left image's raw int32 [4, H, W] cross arms (L, R, U, D): over p's
// cross support (rows v + k, k in [-U(p), D(p)]; in each such row q the
// columns u + j, j in [-L(q), R(q)]; every arm capped at max_arm and at the
// border) the smallest and the largest valid (d >= 0) value and the count of
// valid pixels. An invalid p takes that value where the count exceeds s_thres
// and the smallest equals the largest; every other pixel keeps d. This equals
// refine.region_vote_plain bit for bit: integer min, max and sum are exact
// in any order, and the accept rule is the plain version's (min == max,
// min != INT32_MAX, count > s_thres). The min is taken as an unsigned min over
// every tap (negative values wrap above every valid one), the max over every
// tap (negative values lie below every valid one); both are read only where
// the count is positive.
//
// What bounds it on the H100: bytes, at the least: the map, its four arm
// planes and the output are 24 bytes a pixel, each read or written once. At
// real arm lengths the taps take more issue slots than that (up to 2 max_arm
// + 1 a pixel in each pass, a shared-memory read and three integer operations
// each), so the design keeps every tap in shared memory and skips the rows,
// and the tiles, that no invalid pixel's support reaches.
//
// Design: a block owns a tile of kTileW columns (a lane each) by kTileH rows.
// Every copy is a cp.async of whole row segments, a warp a row.
//   1. The tile's rows of d and of its U and D arms are staged; every
//      invalid pixel marks, in its column, the rows its vertical arms reach
//      (a shared-memory min and max a column), and those intervals' hull is
//      the rows the tile needs. A tile with no invalid pixel copies d.
//   2. The W pass runs over the needed rows in stages of kChunk rows through
//      a ring of kStages buffers (kStages - 1 stages in flight while one is
//      summed): a stage holds its rows of d over the tile's columns plus
//      max_arm columns of halo on each side, and those rows' L and R arms
//      over the tile's columns. A lane sums its column's taps along its row,
//      for the rows its column needs only, and keeps the row's min, max and
//      count in shared memory (kTileH + 2 max_arm rows of them).
//   3. The H pass: each invalid pixel walks its vertical arms over those
//      results (one lane a column, so every read is conflict-free) and
//      applies the accept rule; the block writes its tile of the new map.
// kTileH is 32: on an NVIDIA H100 80GB HBM3, 64-row tiles took 0.0183 ms
// against 0.0132-0.0137 on the Teddy map and gained 5% on frame C's
// (tools/arms_vote_variants.py, which rewrites kTileH). Any max_arm up to 127 fits in shared memory (82 KB a
// block at max_arm 34, 190 KB at max_arm 127).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kTileW = 32;    // a tile's columns, one lane each
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;    // rows a stage of the W pass
constexpr int kStages = 3;    // the W pass's ring of stages
constexpr int kMaxArm = 127;
constexpr int kTileH = 32;   // a tile's rows

struct Args {
  const int32_t* disp;
  const int32_t* arms;  // [4, H, W]: L, R, U, D
  int32_t* out;
  int h, w, max_arm, s_thres;
};

// Shared memory of a block, in 4-byte words: the tile's d, U and D; the
// ring's stages (rows of d, then their L and R arms); the W pass's min, max
// and count for each of the tile's rows and their halo; each column's row
// interval.
struct Layout {
  int span;  // a staged row of d: kTileW + 2 max_arm columns
  int rows;  // kTileH + 2 max_arm
  __host__ __device__ explicit Layout(int m) : span(kTileW + 2 * m), rows(kTileH + 2 * m) {}
  __host__ __device__ int stage_words() const { return kChunk * (span + 2 * kTileW); }
  __host__ __device__ int words() const {
    return 3 * kTileH * kTileW + kStages * stage_words() + 3 * rows * kTileW + 2 * kTileW;
  }
};

__global__ void __launch_bounds__(kThreads) region_vote_kernel(const Args a) {
  extern __shared__ __align__(16) int smem[];
  const int m = a.max_arm, h = a.h, w = a.w;
  const Layout lay(m);
  int* d_t = smem;  // [kTileH][kTileW] each: d, U, D of the tile
  int* up_t = d_t + kTileH * kTileW;
  int* dn_t = up_t + kTileH * kTileW;
  int* ring = dn_t + kTileH * kTileW;  // [kStages] of [kChunk][span] d, [kChunk][kTileW] L, R
  unsigned* mn = reinterpret_cast<unsigned*>(ring + kStages * lay.stage_words());
  int* mx = reinterpret_cast<int*>(mn + lay.rows * kTileW);
  int* cnt = mx + lay.rows * kTileW;
  int* lo_col = cnt + lay.rows * kTileW;
  int* hi_col = lo_col + kTileW;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kTileW, r0 = blockIdx.y * kTileH;
  const int u = c0 + lane;
  const int th = min(kTileH, h - r0), ntile = min(kTileW, w - c0);
  const long long hw = static_cast<long long>(h) * w;
  const int32_t* arm_l = a.arms;
  const int32_t* arm_r = a.arms + hw;
  const int32_t* arm_u = a.arms + 2 * hw;
  const int32_t* arm_d = a.arms + 3 * hw;

  // 1. the tile, and the rows that each column's invalid pixels reach
  if (threadIdx.x < kTileW) {
    lo_col[threadIdx.x] = INT_MAX;
    hi_col[threadIdx.x] = INT_MIN;
  }
  for (int i = warp; i < th; i += kWarps) {
    if (lane >= ntile) break;
    const long long p = static_cast<long long>(r0 + i) * w + u;
    mysm::cp_async4(d_t + i * kTileW + lane, a.disp + p);
    mysm::cp_async4(up_t + i * kTileW + lane, arm_u + p);
    mysm::cp_async4(dn_t + i * kTileW + lane, arm_d + p);
  }
  mysm::cp_async_commit();
  mysm::cp_async_wait<0>();
  __syncthreads();
  if (lane < ntile) {
    for (int i = warp; i < th; i += kWarps) {
      const int v = r0 + i, j = i * kTileW + lane;
      if (d_t[j] >= 0) continue;
      const int up = min(min(up_t[j], m), v), dn = min(min(dn_t[j], m), h - 1 - v);
      if (-up <= dn) {
        atomicMin(&lo_col[lane], v - up);
        atomicMax(&hi_col[lane], v + dn);
      }
    }
  }
  __syncthreads();
  const int t_lo = __reduce_min_sync(0xffffffffu, lo_col[lane]);
  const int t_hi = __reduce_max_sync(0xffffffffu, hi_col[lane]);

  // 2. the W pass over rows t_lo..t_hi (block-uniform)
  if (t_lo <= t_hi) {
    const int cs = max(c0 - m, 0), ce = min(c0 + kTileW + m, w);  // staged columns
    const int n_chunks = (t_hi - t_lo) / kChunk + 1;
    auto stage_chunk = [&](int c) {
      int* dd = ring + (c % kStages) * lay.stage_words();
      int* dl = dd + kChunk * lay.span;
      int* dr = dl + kChunk * kTileW;
      const int g = t_lo + c * kChunk, n = min(kChunk, t_hi + 1 - g);
      for (int r = warp; r < n; r += kWarps) {
        const long long row = static_cast<long long>(g + r) * w;
        for (int col = cs + lane; col < ce; col += 32) {
          mysm::cp_async4(dd + r * lay.span + (col - (c0 - m)), a.disp + row + col);
        }
        if (lane < ntile) {
          mysm::cp_async4(dl + r * kTileW + lane, arm_l + row + u);
          mysm::cp_async4(dr + r * kTileW + lane, arm_r + row + u);
        }
      }
    };
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < n_chunks) stage_chunk(c);
      mysm::cp_async_commit();
    }
    const int lo_c = lo_col[lane], hi_c = hi_col[lane];
    for (int c = 0; c < n_chunks; ++c) {
      if (c + kStages - 1 < n_chunks) stage_chunk(c + kStages - 1);
      mysm::cp_async_commit();
      mysm::cp_async_wait<kStages - 1>();
      __syncthreads();
      const int* dd = ring + (c % kStages) * lay.stage_words();
      const int* dl = dd + kChunk * lay.span;
      const int* dr = dl + kChunk * kTileW;
      const int g = t_lo + c * kChunk, n = min(kChunk, t_hi + 1 - g);
      for (int r = warp; r < n; r += kWarps) {
        const int v = g + r;
        if (lane >= ntile || v < lo_c || v > hi_c) continue;
        const int lo = -min(min(dl[r * kTileW + lane], m), u);
        const int hi = min(min(dr[r * kTileW + lane], m), w - 1 - u);
        const int* row = dd + r * lay.span + lane + m;
        unsigned vmin = UINT_MAX;
        int vmax = INT_MIN, count = 0;
        for (int k = lo; k <= hi; ++k) {
          const int x = row[k];
          vmin = min(vmin, static_cast<unsigned>(x));
          vmax = max(vmax, x);
          count += x >= 0;
        }
        const int i = (v - r0 + m) * kTileW + lane;
        mn[i] = vmin;
        mx[i] = vmax;
        cnt[i] = count;
      }
      __syncthreads();
    }
  }

  // 3. the H pass and the accept rule
  if (lane >= ntile) return;
  for (int i = warp; i < th; i += kWarps) {
    const int v = r0 + i, j = i * kTileW + lane;
    const int d = d_t[j];
    int res = d;
    if (d < 0) {
      const int lo = -min(min(up_t[j], m), v), hi = min(min(dn_t[j], m), h - 1 - v);
      unsigned vmin = UINT_MAX;
      int vmax = INT_MIN, count = 0;
      for (int k = lo; k <= hi; ++k) {
        const int x = (i + m + k) * kTileW + lane;
        vmin = min(vmin, mn[x]);
        vmax = max(vmax, mx[x]);
        count += cnt[x];
      }
      const int dmin = static_cast<int>(vmin);
      if (count > 0 && count > a.s_thres && dmin == vmax && dmin != INT_MAX) res = dmin;
    }
    a.out[static_cast<long long>(v) * w + u] = res;
  }
}

}  // namespace

// disp/out: [H, W] int32; arms: [4, H, W] int32 (L, R, U, D); max_arm in
// [0, 127].
extern "C" int mysm_region_vote(const int32_t* disp, const int32_t* arms, int32_t* out, int h,
                                int w, int max_arm, int s_thres, void* stream) {
  if (h < 1 || w < 1 || max_arm < 0 || max_arm > kMaxArm) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{disp, arms, out, h, w, max_arm, s_thres};
  const int bytes = Layout(max_arm).words() * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      region_vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((w + kTileW - 1) / kTileW),
                  static_cast<unsigned>((h + kTileH - 1) / kTileH));
  region_vote_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
