// Copy-bandwidth probe: out = in * 1.0001f, tile by tile.
//
// Replaces the TPU kernel `copy_kern` in scripts/check_bw.py (its
// pallas_call times the same scaled copy of a [4, 375, 60, 450] float32
// array in several VMEM block shapes). It is on no pipeline path: it
// measures how close to the card's nominal 3.35 TB/s a plain streaming
// kernel gets, the yardstick of every other kernel's bound.
//
// What it computes: out[i] = in[i] * 1.0001f for every element of a
// float32 array viewed as [rows, W], rounded once, as torch's
// `x * 1.0001` is on a float32 tensor.
//
// What bounds it on the H100: memory. 8 bytes an element (one read, one
// write) against one multiply.
//
// Design: a block of 256 threads owns a tile of tile_rows rows by
// tile_cols columns (the TPU probe's block shapes, their minor two
// dimensions) and walks it row by row, its threads on neighbouring
// columns, so every row segment is read and written coalesced. Where W and
// the tile width are multiples of 4 and the pointers 16-byte aligned, a
// thread moves a float4 at a time (`vec` 4), else one float.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kScale = 1.0001f;

__device__ __forceinline__ float4 scale(float4 v) {
  return make_float4(v.x * kScale, v.y * kScale, v.z * kScale, v.w * kScale);
}
__device__ __forceinline__ float scale(float v) { return v * kScale; }

// T is float or float4; w, tile_cols and the column indices count T's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    copy_bw_kernel(const T* __restrict__ in, T* __restrict__ out, long long rows, int w,
                   int tile_rows, int tile_cols) {
  const int tiles_w = (w + tile_cols - 1) / tile_cols;
  const long long r0 = static_cast<long long>(blockIdx.x / tiles_w) * tile_rows;
  const int c0 = static_cast<int>(blockIdx.x % tiles_w) * tile_cols;
  const int c1 = min(c0 + tile_cols, w);
  const long long r1 = min(r0 + tile_rows, rows);
  for (long long r = r0; r < r1; ++r) {
    const long long base = r * w;
    for (int c = c0 + static_cast<int>(threadIdx.x); c < c1; c += kThreads)
      out[base + c] = scale(in[base + c]);
  }
}

template <typename T>
int launch(const void* in, void* out, long long rows, int w, int tile_rows, int tile_cols,
           cudaStream_t stream) {
  const long long tiles = (rows + tile_rows - 1) / tile_rows * ((w + tile_cols - 1) / tile_cols);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  copy_bw_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), rows, w, tile_rows, tile_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in/out: float32 [rows, w]; tiles of tile_rows x tile_cols elements. vec 4
// moves float4s (w and tile_cols multiples of 4, in/out 16-byte aligned),
// vec 1 floats.
extern "C" int mysm_copy_bw(const float* in, float* out, long long rows, int w, int tile_rows,
                            int tile_cols, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_rows < 1 || tile_cols < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4) return launch<float4>(in, out, rows, w / 4, tile_rows, tile_cols / 4, s);
  return launch<float>(in, out, rows, w, tile_rows, tile_cols, s);
}
