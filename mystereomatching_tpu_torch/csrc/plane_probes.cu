// Gather and prefix-sum probes on a float32 plane: the primitive moves of
// the NL tree filter (a gather of rows a level, a running sum down a path).
//
// Replaces the four TPU kernels of scripts/micro4.py (one pallas_call at
// :37, each on a [375, 450] float32 plane held whole in VMEM):
//   k_gather_sub (:8)   o[a, b] = x[idx[a, b], b]   -> gather_rows_kernel
//   k_gather_lane (:14) o[a, b] = x[a, idx[a, b]]   -> gather_cols_kernel
//   k_cumsum_sub (:19)  cumsum along axis 0         -> cumsum_rows_kernel
//   k_cumsum_lane (:22) cumsum along axis 1         -> cumsum_cols_kernel
// They are on no pipeline path.
//
// What they compute: the gathers as jnp.take_along_axis / torch.gather,
// with int32 indices; an index outside its axis gives NaN, as
// take_along_axis fills (torch.gather raises instead). The cumsums add in
// sequential order in float32, so they equal ops/plane_probes.py's
// cumsum_sequential bit for bit and differ from a float64 sum by the
// rounding of each partial sum.
//
// What bounds them on the H100: memory. A gather moves 12 bytes an element
// (index and output, and the source read once at best), a cumsum 8, each
// against one add or none.
//
// Design (simple first): the gathers take one thread an output element
// over a grid-stride loop, neighbouring threads on neighbouring columns,
// so the index and the output move coalesced and only the source reads
// scatter. The cumsums take one thread a column (along axis 0: each row's
// loads coalesce across the threads) or a row (along axis 1: each thread
// walks its own row, the loads of a warp 32 rows apart, which L1 serves
// over the row's cache lines); the loop is unrolled so that loads issue
// ahead of the dependent adds.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 128;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                       float* __restrict__ out, int rows_x, long long n, int cols) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += stride) {
    const int r = idx[i];
    const int c = static_cast<int>(i % cols);
    out[i] = (r >= 0 && r < rows_x) ? x[static_cast<long long>(r) * cols + c] : nan_f();
  }
}

__global__ void __launch_bounds__(kThreads)
    gather_cols_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                       float* __restrict__ out, int cols_x, long long n, int cols) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += stride) {
    const int c = idx[i];
    const long long r = i / cols;
    out[i] = (c >= 0 && c < cols_x) ? x[r * cols_x + c] : nan_f();
  }
}

__global__ void __launch_bounds__(kScanThreads)
    cumsum_rows_kernel(const float* __restrict__ x, float* __restrict__ out, long long rows,
                       int cols) {
  const int c = blockIdx.x * kScanThreads + threadIdx.x;
  if (c >= cols) return;
  float acc = 0.0f;
#pragma unroll 8
  for (long long r = 0; r < rows; ++r) {
    acc += x[r * cols + c];
    out[r * cols + c] = acc;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    cumsum_cols_kernel(const float* __restrict__ x, float* __restrict__ out, long long rows,
                       int cols) {
  const long long r = blockIdx.x * static_cast<long long>(kScanThreads) + threadIdx.x;
  if (r >= rows) return;
  const float* xr = x + r * cols;
  float* orow = out + r * cols;
  float acc = 0.0f;
#pragma unroll 8
  for (int c = 0; c < cols; ++c) {
    acc += xr[c];
    orow[c] = acc;
  }
}

unsigned gather_blocks(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 132LL * 64 ? blocks : 132LL * 64);
}

}  // namespace

// out[a, b] = x[idx[a, b], b]: x [rows_x, cols], idx and out [n / cols, cols].
extern "C" int mysm_gather_rows(const float* x, const int* idx, float* out, int rows_x,
                                long long n, int cols, void* stream) {
  if (n < 1 || cols < 1 || rows_x < 1) return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_kernel<<<gather_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, out, rows_x, n, cols);
  return static_cast<int>(cudaGetLastError());
}

// out[a, b] = x[a, idx[a, b]]: x [n / cols, cols_x], idx and out [n / cols, cols].
extern "C" int mysm_gather_cols(const float* x, const int* idx, float* out, int cols_x,
                                long long n, int cols, void* stream) {
  if (n < 1 || cols < 1 || cols_x < 1) return static_cast<int>(cudaErrorInvalidValue);
  gather_cols_kernel<<<gather_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, out, cols_x, n, cols);
  return static_cast<int>(cudaGetLastError());
}

// Running sums down each column (axis 0, along_rows 1) or along each row
// (axis 1, along_rows 0) of x [rows, cols].
extern "C" int mysm_cumsum(const float* x, float* out, long long rows, int cols, int along_rows,
                           void* stream) {
  if (rows < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (along_rows) {
    cumsum_rows_kernel<<<(cols + kScanThreads - 1) / kScanThreads, kScanThreads, 0, s>>>(
        x, out, rows, cols);
  } else {
    const long long blocks = (rows + kScanThreads - 1) / kScanThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    cumsum_cols_kernel<<<static_cast<unsigned>(blocks), kScanThreads, 0, s>>>(x, out, rows,
                                                                            cols);
  }
  return static_cast<int>(cudaGetLastError());
}
