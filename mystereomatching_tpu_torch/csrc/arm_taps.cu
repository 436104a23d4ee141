// Kernel B: arm-bounded 1-D sum along H or W, with CBCA's area mode.
//
// Replaces the TPU kernels `_taps_kernel` (sum mode; reached through
// `_sublane_pass` / `arm_bounded_sum_pallas` from `aggregation.cbca`'s first
// pass) and `_taps_kernel_area` (through `sublane_pass_area`, CBCA's second
// pass) in mystereomatching_tpu/ops/pallas_kernels.py, with their clone and
// windowed forms (`_taps_kernel_clones`, `_taps_windowed_kernel`): no axis
// length or max_arm limit exists here, so those have no counterpart.
//
// What it computes, for each element x of a [D, H, W] volume:
//   sum mode:  out[x] = sum over k in [-an[x], ap[x]] of vol[x + k e]
//   area mode: out[x] = (sum of vol[x + k e]) / max(sum of area1[x + k e], 1)
// with e a unit step along H or W, arms capped at max_arm and taps off the
// image skipped, and area1 = min(an1, m) + min(ap1, m) + 1 the support count
// of the first pass (arms an1/ap1). All arms are int8 [D, H, W] planes of
// the per-disparity intersected arms. vol and out are float32, or
// bfloat16 (the JAX package's vol_dtype="bfloat16").
//
// Sum order: ascending offset, from x - an to x + ap, starting from 0.0f,
// with __fadd_rn: the order of the JAX CPU path
// (arms._arm_bounded_reduce_taps, whose masked taps add an exact +0.0), so
// this kernel is bit-identical to it and to the plain torch version. Built
// with -fmad=false. The area count is summed as an integer: each area1 lies
// in [-255, 255] and a window holds at most 255 of them, so every partial
// sum is an integer below 2^24 in magnitude and the ascending float sum is
// exactly the integer sum converted to float.
//
// In bfloat16 the order is the same and every add rounds to bfloat16, as
// the JAX CPU path computes it (storage.cuh): acc = bf16(acc + tap) from
// 0, the area count likewise as a running bfloat16 sum of the area1
// values (exact up to 256, rounded beyond, unlike the float32 count), and
// the area mode's result is bf16(float(sum) / max(float(count), 1)).
//
// What bounds it on the H100: bytes. A pass reads vol and the int8 arm
// planes once and writes out once; at the mean window of real scenes (about
// 3 taps) the arithmetic is small beside that. Long windows (about 22 taps
// on the blocky 1988x2880 test image) make the taps' adds and shared-memory
// reads the larger cost.
//
// Design: every input byte comes from device memory once, in whole row
// segments; vol goes through shared memory with cp.async (16-byte copies
// when W % 4 == 0 and vol is 16-byte aligned, 4-byte ones otherwise), the
// int8 arm planes as the aligned 16-byte words that cover each row. The
// area count min(an1, m) + min(ap1, m) + 1 is computed once per staged
// element and kept as int16. A bfloat16 volume is staged as the aligned
// 16-byte words covering its row segment, as the arm planes are, and
// widened into the float rows the sums read; the sums then run as in
// float32, rounding as above.
// - Along W: a warp owns one row of the [D * H, W] volume over a tile of at
//   most kTileCap columns plus max_arm columns of halo on each side (whole
//   rows up to kTileCap). It stages the row, counts its areas and sums
//   each column's taps, one lane a column, with no barrier but __syncwarp. Lanes whose
//   windows start at one column (the pixels of one support region) read one
//   address, a broadcast.
// - Along H: a block owns a strip of 32 columns of one disparity plane and
//   walks down H, kStage rows a stage, through a ring of shared memory that
//   holds the rows being summed, their max_arm rows of halo and the
//   kInFlight - 1 stages being copied, so each row is read once and the
//   copies overlap the sums. One lane a column, so a warp's taps always fall
//   in 32 different banks; a window is added as at most two runs of
//   consecutive ring rows.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "storage.cuh"

namespace {

using mysm::cp_async16;
using mysm::cp_async4;
using mysm::cp_async_commit;
using mysm::cp_async_wait;
using mysm::kIsBf16;
using mysm::round_to;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCap = 512;   // along W: the columns of a tile, at most
constexpr int kStrip = 32;      // along H: the columns of a block's strip, one a lane
constexpr int kStage = 32;      // along H: the rows of a stage
constexpr int kInFlight = 3;    // along H: the ring's stages being copied, plus one

static_assert(kStrip == 32 && kStage % kWarps == 0, "along H: a lane a column, a warp a row");

__host__ __device__ constexpr int round_up(int x, int a) { return (x + a - 1) / a * a; }

template <typename T>
struct Volume {
  const T* vol;
  const int8_t* an;   // the output's arms
  const int8_t* ap;
  const int8_t* an1;  // the first pass's arms (area mode)
  const int8_t* ap1;
  T* out;
  long long rows;  // D * H rows of W elements
  int h, w, max_arm;
};

__device__ __forceinline__ int area1(int an1, int ap1, int m) {
  return min(an1, m) + min(ap1, m) + 1;
}

// The int8 planes are staged as the aligned 16-byte words that cover the
// bytes [src, src + n), whatever the row's alignment: word q of them lands at
// dst + 16 q (dst 16-byte aligned), and src's first byte at dst +
// first_byte(src). A word may reach up to 15 bytes outside the row, never
// outside its aligned word, and so never into another memory page.
constexpr int kWord = 16;
__device__ __forceinline__ int first_byte(const int8_t* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) % kWord);
}
__device__ __forceinline__ int covering_words(const int8_t* src, int n) {
  return (first_byte(src) + n + kWord - 1) / kWord;
}
__device__ __forceinline__ void copy_word(int8_t* dst, const int8_t* src, int q) {
  const uintptr_t word = reinterpret_cast<uintptr_t>(src) / kWord + q;
  cp_async16(dst + kWord * q, reinterpret_cast<const void*>(word * kWord));
}
constexpr int kBWords = kStrip / kWord + 1;  // along H: the words covering a strip's int8 row
constexpr int kBPitch = kWord * kBWords;     // along H: the bytes a staged int8 row takes
constexpr int kVWords = 2 * kStrip / kWord + 1;  // along H: the same for a bfloat16 row
constexpr int kVPitch = kWord * kVWords;

// Starts copying the covering words of [src, src + n) into dst, word q by
// thread t + i * nt; returns first_byte(src).
__device__ __forceinline__ int stage_bytes(int8_t* dst, const int8_t* src, int n, int t, int nt) {
  const int words = covering_words(src, n);
  for (int q = t; q < words; q += nt) copy_word(dst, src, q);
  return first_byte(src);
}

// The area count of a window: an exact int in float32, a float holding the
// running bfloat16 sum in bfloat16.
template <typename T>
using Count = std::conditional_t<kIsBf16<T>, float, int>;

// Adds n taps, `stride` elements apart from vol[0], to acc in ascending
// offset, and in area mode their area counts (from area[0]) to count,
// rounding each add to T.
template <typename T, bool kArea>
__device__ __forceinline__ void add_taps(const float* vol, const int16_t* area, int n,
                                         int stride, float& acc, Count<T>& count) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    acc = round_to<T>(__fadd_rn(acc, vol[k * stride]));
    if constexpr (kArea && kIsBf16<T>) {
      count = round_to<T>(__fadd_rn(count, static_cast<float>(area[k * stride])));
    } else if constexpr (kArea) {
      count += area[k * stride];
    }
  }
}

// The output: the sum, or in area mode the sum over the counted area, as T.
template <typename T, bool kArea>
__device__ __forceinline__ T result(float acc, Count<T> count) {
  return mysm::narrow<T>(kArea ? __fdiv_rn(acc, fmaxf(static_cast<float>(count), 1.0f)) : acc);
}

// Along W, the bytes of a warp's row of shared memory: vol widened to float
// (pitch floats), the area counts (pitch int16, area mode), the planes an,
// ap (an1, ap1) at bpitch bytes each, then in bfloat16 the words covering
// the staged vol segment.
template <typename T, bool kArea>
__host__ __device__ constexpr int w_row_bytes(int pitch, int bpitch) {
  return 4 * pitch + (kArea ? 2 * pitch + 2 * bpitch : 0) + 2 * bpitch +
         (kIsBf16<T> ? 2 * pitch + 2 * kWord : 0);
}

// Along W: warp j of block b owns row 8 (b / n_tiles) + j of the [D * H, W]
// volume over tile b % n_tiles, columns [c0, c0 + tile) and the halo, in a
// row of shared memory laid out as w_row_bytes says.
template <typename T, bool kArea, bool kVec>
__global__ void __launch_bounds__(kThreads)
    arm_taps_kernel_w(Volume<T> v, int tile, int n_tiles, int pitch, int bpitch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x / n_tiles) * kWarps + warp;
  if (r >= v.rows) return;  // no block-wide barrier follows
  const int m = v.max_arm, w = v.w;
  const int c0 = static_cast<int>(blockIdx.x % n_tiles) * tile;
  const int c1 = min(w, c0 + tile);
  const int s = max(0, c0 - m) & ~3;
  const int e = kVec ? round_up(min(w, c1 + m), 4) : min(w, c1 + m);
  const int n = e - s;
  float* vs = reinterpret_cast<float*>(smem + warp * w_row_bytes<T, kArea>(pitch, bpitch));
  int16_t* as = reinterpret_cast<int16_t*>(vs + pitch);
  int8_t* bs = reinterpret_cast<int8_t*>(as + (kArea ? pitch : 0));
  int8_t* vraw = bs + (kArea ? 4 : 2) * bpitch;  // bfloat16: the words covering vol
  const long long off = r * w + s;
  int sh_vol = 0;
  if constexpr (kIsBf16<T>) {
    sh_vol = stage_bytes(vraw, reinterpret_cast<const int8_t*>(v.vol + off), 2 * n, lane, 32);
  } else if (kVec) {
    for (int q = lane; 4 * q < n; q += 32) cp_async16(vs + 4 * q, v.vol + off + 4 * q);
  } else {
    for (int q = lane; q < n; q += 32) cp_async4(vs + q, v.vol + off + q);
  }
  const int sh_an = stage_bytes(bs, v.an + off, n, lane, 32);
  const int sh_ap = stage_bytes(bs + bpitch, v.ap + off, n, lane, 32);
  int sh_an1 = 0, sh_ap1 = 0;
  if (kArea) {
    sh_an1 = stage_bytes(bs + 2 * bpitch, v.an1 + off, n, lane, 32);
    sh_ap1 = stage_bytes(bs + 3 * bpitch, v.ap1 + off, n, lane, 32);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  if (kArea || kIsBf16<T>) {
    for (int q = lane; q < n; q += 32) {
      if constexpr (kIsBf16<T>) vs[q] = mysm::widen(reinterpret_cast<const T*>(vraw + sh_vol)[q]);
      if (kArea) {
        as[q] = static_cast<int16_t>(
            area1(bs[2 * bpitch + sh_an1 + q], bs[3 * bpitch + sh_ap1 + q], m));
      }
    }
    __syncwarp();
  }
  for (int c = c0 + lane; c < c1; c += 32) {
    const int q = c - s;
    const int lo = -min(min(static_cast<int>(bs[sh_an + q]), m), c);
    const int hi = min(min(static_cast<int>(bs[bpitch + sh_ap + q]), m), w - 1 - c);
    float acc = 0.0f;
    Count<T> count = 0;
    add_taps<T, kArea>(vs + q + lo, as + q + lo, hi - lo + 1, 1, acc, count);
    v.out[r * w + c] = result<T, kArea>(acc, count);
  }
}

// Along H: block b owns columns [kStrip (b % n_strips), + kStrip) of
// disparity plane b / n_strips and walks down its rows, kStage a stage,
// through a ring of `ring` rows (a multiple of kStage) in shared memory: vol
// ([ring][kStrip] floats), the area counts in area mode ([ring][kStrip]
// int16) and the output's arms an, ap ([ring][2][kBPitch] int8, each row
// as the words covering it). At iteration i stage i is in, the next
// kInFlight - 2 stages are in flight, and the warps sum the rows of stage
// i - lag (lag * kStage >= max_arm). In area mode an1 and ap1 go into a
// buffer of kInFlight stages, whose counts are taken once stage i is in; a
// bfloat16 vol goes into such a buffer too ([kInFlight][kStage][kVPitch],
// each row as the words covering it), and is widened into the ring then.
// Thread (warp j, lane) handles rows j, j + 8, j + 16 and j + 24 of a
// stage, in column lane of the strip.
template <typename T, bool kArea, bool kVec>
__global__ void __launch_bounds__(kThreads)
    arm_taps_kernel_h(Volume<T> v, int n_strips, int ring, int lag) {
  constexpr int kEach = kStage / kWarps;  // rows of a stage a thread handles
  constexpr int kPlanes = kArea ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* vs = reinterpret_cast<float*>(smem);
  int16_t* as = reinterpret_cast<int16_t*>(vs + ring * kStrip);
  int8_t* own = reinterpret_cast<int8_t*>(as + (kArea ? ring * kStrip : 0));
  int8_t* first = own + ring * 2 * kBPitch;  // an1, ap1: [kInFlight][kStage][2][kBPitch]
  int8_t* vstage = first + (kArea ? kInFlight * kStage * 2 * kBPitch : 0);  // bfloat16 vol
  const int m = v.max_arm, h = v.h, w = v.w;
  const int s = static_cast<int>(blockIdx.x % n_strips) * kStrip;
  const long long plane_row = static_cast<long long>(blockIdx.x / n_strips) * h;
  const int e = min(w, s + kStrip);
  const int n_stages = (h + kStage - 1) / kStage, ring_stages = ring / kStage;
  const int lane = threadIdx.x & 31, j = threadIdx.x / 32;
  auto row_of = [&](int x) { return j + kWarps * x; };  // this thread's row x of a stage
  auto plane = [&](int p) { return p == 0 ? v.an : p == 1 ? v.ap : p == 2 ? v.an1 : v.ap1; };
  // where the strip's first byte of plane p lands in its staged row vo:
  // first_byte of its address, from the low bits alone
  unsigned low[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    low[p] = static_cast<unsigned>(reinterpret_cast<uintptr_t>(plane(p)) + plane_row * w + s);
  }
  auto shift = [&](int p, int vo) {
    return static_cast<int>((low[p] + static_cast<unsigned>(vo) * static_cast<unsigned>(w)) % kWord);
  };
  // the same for the bfloat16 vol's staged rows
  const unsigned low_vol =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(v.vol + plane_row * w + s));
  auto vol_shift = [&](int vo) {
    return static_cast<int>(
        (low_vol + static_cast<unsigned>(vo) * static_cast<unsigned>(2 * w)) % kWord);
  };

  auto load = [&](int st) {  // vol and the int8 planes of stage st
    if (st < n_stages) {
      const int v0 = st * kStage, rows = min(kStage, h - v0);
      const int slot0 = (st % ring_stages) * kStage;
      const long long g0 = (plane_row + v0) * w + s;
      if constexpr (kIsBf16<T>) {
        int8_t* buf = vstage + (st % kInFlight) * kStage * kVPitch;
        for (int it = threadIdx.x; it < kStage * kVWords; it += kThreads) {
          const int q = it % kVWords, row = it / kVWords;
          const int8_t* src =
              reinterpret_cast<const int8_t*>(v.vol + g0 + row * static_cast<long long>(w));
          if (row < rows && q < covering_words(src, 2 * (e - s))) {
            copy_word(buf + row * kVPitch, src, q);
          }
        }
      } else if (kVec) {
        for (int it = threadIdx.x; it < kStage * kStrip / 4; it += kThreads) {
          const int row = it / (kStrip / 4), q = 4 * (it % (kStrip / 4));
          if (row < rows && s + q < e) {
            cp_async16(vs + (slot0 + row) * kStrip + q,
                       v.vol + g0 + row * static_cast<long long>(w) + q);
          }
        }
      } else {
#pragma unroll
        for (int x = 0; x < kEach; ++x) {
          const int row = row_of(x);
          if (row < rows && s + lane < e) {
            cp_async4(vs + (slot0 + row) * kStrip + lane,
                      v.vol + g0 + row * static_cast<long long>(w) + lane);
          }
        }
      }
      int8_t* buf = first + (st % kInFlight) * kStage * 2 * kBPitch;
      for (int it = threadIdx.x; it < kStage * kPlanes * kBWords; it += kThreads) {
        const int q = it % kBWords, p = it / kBWords % kPlanes, row = it / (kBWords * kPlanes);
        const int8_t* src = plane(p) + g0 + row * static_cast<long long>(w);
        if (row < rows && q < covering_words(src, e - s)) {
          copy_word(p < 2 ? own + ((slot0 + row) * 2 + p) * kBPitch
                          : buf + (row * 2 + p - 2) * kBPitch, src, q);
        }
      }
    }
    cp_async_commit();
  };

  for (int st = 0; st < kInFlight - 1; ++st) load(st);
  for (int i = 0; i < n_stages + lag; ++i) {
    const int slot_i = (i % ring_stages) * kStage;  // stage i's first slot
    cp_async_wait<kInFlight - 2>();
    __syncthreads();  // stage i is in; iteration i - 1's sums are done
    load(i + kInFlight - 1);
    if ((kArea || kIsBf16<T>) && i < n_stages) {  // stage i's area counts, bfloat16 vol
      const int8_t* buf = first + (i % kInFlight) * kStage * 2 * kBPitch;
      const int8_t* vbuf = vstage + (i % kInFlight) * kStage * kVPitch;
#pragma unroll
      for (int x = 0; x < kEach; ++x) {
        const int row = row_of(x), vo = i * kStage + row;
        if (vo >= h) continue;
        if (kArea) {
          as[(slot_i + row) * kStrip + lane] = static_cast<int16_t>(
              area1(buf[row * 2 * kBPitch + shift(2, vo) + lane],
                    buf[(row * 2 + 1) * kBPitch + shift(3, vo) + lane], m));
        }
        if constexpr (kIsBf16<T>) {
          if (s + lane < e) {
            vs[(slot_i + row) * kStrip + lane] =
                mysm::widen(reinterpret_cast<const T*>(vbuf + row * kVPitch + vol_shift(vo))[lane]);
          }
        }
      }
      __syncthreads();
    }
    const int c = i - lag;
    if (c < 0) continue;
    const int slot_c = (c % ring_stages) * kStage;
#pragma unroll
    for (int x = 0; x < kEach; ++x) {
      const int vo = c * kStage + row_of(x);
      if (vo >= h || s + lane >= e) continue;
      const int at = slot_c + row_of(x);
      const int lo = -min(min(static_cast<int>(own[at * 2 * kBPitch + shift(0, vo) + lane]), m), vo);
      const int hi = min(min(static_cast<int>(own[(at * 2 + 1) * kBPitch + shift(1, vo) + lane]), m),
                         h - 1 - vo);
      // the taps' slots: from `a`, wrapping once at most
      const int n = hi - lo + 1;
      int a = at + lo;
      if (a < 0) {
        a += ring;
      } else if (a >= ring) {  // arms below 0 start the window past the output
        a -= ring;
      }
      const int n1 = min(n, ring - a);
      float acc = 0.0f;
      Count<T> count = 0;
      add_taps<T, kArea>(vs + a * kStrip + lane, as + a * kStrip + lane, n1, kStrip, acc, count);
      add_taps<T, kArea>(vs + lane, as + lane, n - n1, kStrip, acc, count);
      v.out[(plane_row + vo) * w + s + lane] = result<T, kArea>(acc, count);
    }
  }
}

// Allows `bytes` of dynamic shared memory for kernel, then launches it.
template <typename Kernel, typename... Args>
cudaError_t launch_with(Kernel kernel, long long blocks, int bytes, cudaStream_t stream,
                        Args... args) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, bool kArea>
cudaError_t launch(const Volume<T>& v, bool along_w, cudaStream_t stream) {
  const int m = v.max_arm;
  // float32 rows of 4-byte-aligned length take 16-byte copies; bfloat16
  // ones come as covering words whatever W
  const bool vec =
      !kIsBf16<T> && v.w % 4 == 0 && reinterpret_cast<uintptr_t>(v.vol) % 16 == 0;
  if (along_w) {
    const int n_tiles0 = (v.w + kTileCap - 1) / kTileCap;
    const int tile = round_up((v.w + n_tiles0 - 1) / n_tiles0, 4);
    const int n_tiles = (v.w + tile - 1) / tile;
    const int pitch = round_up(tile + 2 * m + 8, 8);  // the staged columns, at most
    const int bpitch = round_up(pitch + 2 * kWord - 4, kWord);  // the words covering them
    const int bytes = kWarps * w_row_bytes<T, kArea>(pitch, bpitch);
    const long long blocks = (v.rows + kWarps - 1) / kWarps * n_tiles;
    auto kernel = arm_taps_kernel_w<T, kArea, false>;
    if constexpr (!kIsBf16<T>) {
      if (vec) kernel = arm_taps_kernel_w<T, kArea, true>;
    }
    return launch_with(kernel, blocks, bytes, stream, v, tile, n_tiles, pitch, bpitch);
  }
  const int n_strips = (v.w + kStrip - 1) / kStrip;
  const int lag = (m + kStage - 1) / kStage;
  const int ring = (kInFlight + 2 * lag) * kStage;  // >= (kInFlight + lag) * kStage + m
  const int bytes = ring * kStrip * (4 + (kArea ? 2 : 0)) + ring * 2 * kBPitch +
                    (kArea ? kInFlight * kStage * 2 * kBPitch : 0) +
                    (kIsBf16<T> ? kInFlight * kStage * kVPitch : 0);
  const long long blocks = v.rows / v.h * n_strips;
  auto kernel = arm_taps_kernel_h<T, kArea, false>;
  if constexpr (!kIsBf16<T>) {
    if (vec) kernel = arm_taps_kernel_h<T, kArea, true>;
  }
  return launch_with(kernel, blocks, bytes, stream, v, n_strips, ring, lag);
}

template <typename T>
int launch_mode(const void* vol, const int8_t* an, const int8_t* ap, const int8_t* an1,
                const int8_t* ap1, void* out, int nd, int h, int w, int along_w, int max_arm,
                void* stream) {
  if (max_arm < 0 || max_arm > 127) return static_cast<int>(cudaErrorInvalidValue);
  const Volume<T> v{static_cast<const T*>(vol), an, ap, an1, ap1, static_cast<T*>(out),
                    static_cast<long long>(nd) * h, h, w, max_arm};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(an1 != nullptr ? launch<T, true>(v, along_w != 0, s)
                                         : launch<T, false>(v, along_w != 0, s));
}

}  // namespace

// vol/out: [D, H, W] float32 (mysm_arm_taps) or bfloat16
// (mysm_arm_taps_bf16); an/ap (and an1/ap1 in area mode, else null):
// [D, H, W] int8. along_w: 1 reduces along W, 0 along H. max_arm: 0-127.
extern "C" int mysm_arm_taps(const float* vol, const int8_t* an, const int8_t* ap,
                             const int8_t* an1, const int8_t* ap1, float* out,
                             int nd, int h, int w, int along_w, int max_arm,
                             void* stream) {
  return launch_mode<float>(vol, an, ap, an1, ap1, out, nd, h, w, along_w, max_arm, stream);
}
extern "C" int mysm_arm_taps_bf16(const void* vol, const int8_t* an, const int8_t* ap,
                                  const int8_t* an1, const int8_t* ap1, void* out, int nd, int h,
                                  int w, int along_w, int max_arm, void* stream) {
  return launch_mode<mysm::bf16>(vol, an, ap, an1, ap1, out, nd, h, w, along_w, max_arm,
                                 stream);
}
