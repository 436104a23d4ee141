// Copy-bandwidth probe: out = in * 1.0001f, tile by tile.
//
// Replaces the TPU kernel `copy_kern` in scripts/check_bw.py (its
// pallas_call times the same scaled copy of a [4, 375, 60, 450] float32
// array in several VMEM block shapes). It is on no pipeline path: it
// measures how close to the card's nominal 3.35 TB/s a streaming kernel
// gets, the yardstick of every other kernel's bound.
//
// What it computes: out[i] = in[i] * 1.0001f for every element of a
// float32 array viewed as [rows, W], rounded once, as torch's
// `x * 1.0001` is on a float32 tensor.
//
// What bounds it on the H100: memory. 8 bytes an element (one read, one
// write) against one multiply.
//
// Design: a block of 256 threads a tile of tile_rows rows by tile_cols
// columns (the TPU probe's block shapes, their minor two dimensions), the
// grid one block a tile. Where W and the tile width are multiples of 4 and
// the buffers 16-byte aligned (`vec` 4), the tensor memory accelerator
// moves the data and no thread holds it in registers: the tile's rows, each
// cut into parts of at most kStage floats, pass through a ring of kStages
// shared-memory stages. One thread fills a stage with a bulk copy
// (cp.async.bulk) that completes on the stage's mbarrier, kAhead stages
// ahead of the one the block scales; the block scales that stage in place;
// the same thread writes it back with a bulk copy and, before the stage is
// filled again, waits until that copy has read it. The ring takes 128 KB,
// so an SM holds one such block, and the block scheduler streams the tiles
// through the SMs. Otherwise (ragged widths, buffers off 16 bytes) the
// threads move floats, each loading its kPer elements of a batch of the
// tile before it stores any, two blocks an SM. Offsets are 64-bit. A
// persistent grid walking the tiles, with this ring or in registers, was
// slower on the 4 GiB buffer (PERF.md). The loops over tiles stride
// by the grid, so with one block a tile each runs once; they are kept in
// the form that was measured: a plainer float path, one tile's batches
// without them, spilled more and took 25% longer at W = 450.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 4096;  // floats a stage (16 KB): at most one tile row
constexpr int kStages = 8;    // stages in the ring
constexpr int kAhead = 4;     // stages filled ahead of the one the block scales
constexpr int kPer = 32;      // floats a thread loads before it stores any, on the float path
constexpr size_t kSmem = sizeof(float) * kStage * kStages + sizeof(uint64_t) * kStages;
constexpr float kScale = 1.0001f;

__device__ __forceinline__ float scale(float v) { return __fmul_rn(v, kScale); }
__device__ __forceinline__ float4 scale(float4 v) {
  return make_float4(scale(v.x), scale(v.y), scale(v.z), scale(v.w));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The tiles of a float32 [rows, w] array: tile t is (t / tiles_w, t % tiles_w).
struct Tiling {
  long long rows, tiles;
  int w, tile_rows, tile_cols, tiles_w;
  // tile t's first row r0 and column c0, and its nr rows and nc columns
  __device__ __forceinline__ void tile(long long t, long long* r0, int* c0, int* nr,
                                       int* nc) const {
    *r0 = t / tiles_w * tile_rows;
    *c0 = static_cast<int>(t % tiles_w) * tile_cols;
    *nr = static_cast<int>(min(static_cast<long long>(tile_rows), rows - *r0));
    *nc = min(tile_cols, w - *c0);
  }
};

// The float path: batch j of a tile of nr x nc floats at (r0, c0), its
// elements [j, j + 1) kThreads kPer in row-major order over the tile.
__device__ __forceinline__ void float_batch(const float* __restrict__ in,
                                            float* __restrict__ out, long long r0, int c0,
                                            int nr, int nc, int w, long long j) {
  const long long n = static_cast<long long>(nr) * nc;
  const long long b = j * kThreads * kPer + threadIdx.x;
  if (b >= n) return;
  const int dr = kThreads / nc, dc = kThreads % nc;  // kThreads elements on, as (rows, cols)
  const int r = static_cast<int>(b / nc), c = static_cast<int>(b % nc);
  float v[kPer];
  int rr = r, cc = c;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (b + k * kThreads < n) v[k] = in[(r0 + rr) * w + c0 + cc];
    cc += dc;
    rr += dr;
    if (cc >= nc) cc -= nc, ++rr;
  }
  rr = r, cc = c;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (b + k * kThreads < n) out[(r0 + rr) * w + c0 + cc] = scale(v[k]);
    cc += dc;
    rr += dr;
    if (cc >= nc) cc -= nc, ++rr;
  }
}

__device__ __forceinline__ void float_tiles(const float* in, float* out, const Tiling& tl) {
  const long long nb =
      (static_cast<long long>(tl.tile_rows) * tl.tile_cols + kThreads * kPer - 1) /
      (kThreads * kPer);
  long long r0;
  int c0, nr, nc;
  for (long long t = blockIdx.x; t < tl.tiles; t += gridDim.x) {
    tl.tile(t, &r0, &c0, &nr, &nc);
    for (long long j = 0; j < nb; ++j) float_batch(in, out, r0, c0, nr, nc, tl.w, j);
  }
}

// The bulk-copy path's piece p of this block: part p % parts of row
// (p / parts) % tile_rows of the block's (p / parts / tile_rows)-th tile;
// *g its first element, *len its floats (0 past the array's last row or
// column).
__device__ __forceinline__ void piece(const Tiling& tl, int parts, long long p, long long* g,
                                      int* len) {
  const long long per_tile = static_cast<long long>(tl.tile_rows) * parts;
  const long long tlocal = p / per_tile, rem = p - tlocal * per_tile;
  const long long t = blockIdx.x + tlocal * gridDim.x;
  const int rr = static_cast<int>(rem / parts), part = static_cast<int>(rem % parts);
  const long long r = t / tl.tiles_w * tl.tile_rows + rr;
  const int c0 = static_cast<int>(t % tl.tiles_w) * tl.tile_cols;
  const int c = c0 + part * kStage, c1 = min(c0 + tl.tile_cols, tl.w);
  *len = r < tl.rows && c < c1 ? min(kStage, c1 - c) : 0;
  *g = r * tl.w + c;
}

// The bulk-copy path: w and tile_cols multiples of 4, in/out 16-byte aligned.
__device__ __forceinline__ void bulk_tiles(const float* in, float* out, const Tiling& tl) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + kStage * kStages);
  const int parts = (tl.tile_cols + kStage - 1) / kStage;
  const long long mine =
      blockIdx.x < tl.tiles ? (tl.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long pieces = mine * tl.tile_rows * parts;
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(full + s))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the leader fills piece p's stage, or arrives on its barrier where it is empty
  auto fill = [&](long long p) {
    long long g;
    int len;
    piece(tl, parts, p, &g, &len);
    const int s = static_cast<int>(p % kStages);
    const uint32_t bar = smem_addr(full + s);
    if (len == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
      return;
    }
    const uint32_t bytes = static_cast<uint32_t>(len * sizeof(float));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(stage + s * kStage)),
        "l"(in + g), "r"(bytes), "r"(bar)
        : "memory");
  };
  if (leader) {
    for (long long p = 0; p < kAhead && p < pieces; ++p) fill(p);
  }
  for (long long p = 0; p < pieces; ++p) {
    const int s = static_cast<int>(p % kStages);
    long long g;
    int len;
    piece(tl, parts, p, &g, &len);
    mbar_wait(smem_addr(full + s), static_cast<uint32_t>((p / kStages) & 1));
    float4* v = reinterpret_cast<float4*>(stage + s * kStage);
    for (int i = threadIdx.x; i < len / 4; i += kThreads) v[i] = scale(v[i]);
    // the threads' writes to the stage, before the bulk copy reads it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (leader) {
      if (len > 0) {
        const uint32_t bytes = static_cast<uint32_t>(len * sizeof(float));
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                         out + g),
                     "r"(smem_addr(v)), "r"(bytes)
                     : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the stage piece p + kAhead fills last held piece p + kAhead - kStages:
      // wait until all write-backs but the newest kStages - kAhead, that
      // piece's among them, have read their stages
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kStages - kAhead) : "memory");
      if (p + kAhead < pieces) fill(p + kAhead);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
    copy_bw_kernel(const float* __restrict__ in, float* __restrict__ out, Tiling tl, int vec) {
  if (vec == 4) {
    bulk_tiles(in, out, tl);
    return;
  }
  float_tiles(in, out, tl);
}

}  // namespace

// in/out: float32 [rows, w]; tiles of tile_rows x tile_cols elements, a
// block a tile. vec 4 moves the data by bulk copies through shared memory
// (w and tile_cols multiples of 4, in/out 16-byte aligned), vec 1 as floats.
extern "C" int mysm_copy_bw(const float* in, float* out, long long rows, int w, int tile_rows,
                            int tile_cols, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_rows < 1 || tile_cols < 1 || w < 1 || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_w = (w + tile_cols - 1) / tile_cols;
  const long long tiles = (rows + tile_rows - 1) / tile_rows * tiles_w;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(
      copy_bw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tiling tl{rows, tiles, w, tile_rows, tile_cols, tiles_w};
  copy_bw_kernel<<<static_cast<unsigned>(tiles), kThreads, vec == 4 ? kSmem : 0, s>>>(in, out,
                                                                                    tl, vec);
  return static_cast<int>(cudaGetLastError());
}
