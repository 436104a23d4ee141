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
// scatter. cumsum_rows takes one thread a column: each row's loads
// coalesce across the threads; the loop is unrolled so that loads issue
// ahead of the dependent adds.
//
// cumsum_cols stages its rows through shared memory: a thread that walked
// its own row in device memory would make each load of a warp touch 32
// cache lines, a row apart, and a block of 128 such threads leaves most
// SMs idle (3 blocks at [375, 450]). A block takes a band of `band`
// consecutive rows, one contiguous span of device memory, with band chosen
// at launch so that about kFillBlocks blocks run where R allows (2 rows at
// R = 375, up to kScanThreads at R = 168750); the adds are not the cost
// (450 dependent adds take about a microsecond). For each tile of the
// band's columns:
//   1. all its threads copy the tile into shared memory, coalesced, in
//      16-byte loads where the tile is the whole span (a scalar head and
//      tail around the span's 16-byte words: a band starts aligned only
//      where row0 C % 4 == 0), else a scalar a row segment;
//   2. shared rows are padded to an odd stride (450 gave 2-way bank
//      conflicts), so that a warp's 32 threads, each on its own row, read
//      32 different banks;
//   3. thread t adds row t left to right, starting from -0.0 (so that the
//      first sum is x[t, 0] itself) and carrying its sum in a register
//      from tile to tile, and writes each partial sum back in place;
//   4. the tile goes back to device memory as it came in.
// A tile is the whole row where band (C | 1) floats fit kMaxBandBytes,
// else the widest odd number of columns that fits: a row longer than one
// tile is done in column chunks. The sums keep their sequential order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 128;
constexpr int kFillBlocks = 2 * 132;         // cumsum_cols: blocks wanted, two an SM
constexpr int kMaxBandBytes = 48 * 1024;     // cumsum_cols: shared memory a block
constexpr int kWordsInFlight = 4;            // cumsum_cols: 16-byte loads a thread at once

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

// Moves `rows` row segments of `len` floats between device memory, where
// segment r starts at g + r cols, and shared memory, where it starts at
// sm + r stride: into shared memory (kIn) or back out. Where len == cols
// the segments are one span, moved in 16-byte words from g's first 16-byte
// boundary on, kWordsInFlight a thread loaded before any is placed, with
// scalars for the at most 3 elements before that boundary and after the
// last word.
template <bool kIn>
__device__ __forceinline__ void move_band(float* g, float* sm, int rows, int len, int cols,
                                          int stride) {
  const int n = rows * len;
  if (len != cols) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / len;
      const int c = e - r * len;
      float* gp = g + static_cast<long long>(r) * cols + c;
      float* sp = sm + r * stride + c;
      if (kIn) *sp = *gp; else *gp = *sp;
    }
    return;
  }
  const int first = static_cast<int>(((16 - (reinterpret_cast<size_t>(g) & 15)) & 15) / 4);
  const int head = first < n ? first : n;
  const int words = (n - head) / 4;
  const int tail = n - head - 4 * words;
  if (threadIdx.x < head + tail) {
    const int e = threadIdx.x < head ? threadIdx.x : threadIdx.x + 4 * words;
    const int r = e / cols;
    float* sp = sm + r * stride + e - r * cols;
    if (kIn) *sp = g[e]; else g[e] = *sp;
  }
  float4* g4 = reinterpret_cast<float4*>(g + head);
  for (int v0 = threadIdx.x; v0 < words; v0 += kWordsInFlight * blockDim.x) {
    float q[kWordsInFlight][4];
    if (kIn) {
#pragma unroll
      for (int k = 0; k < kWordsInFlight; ++k) {
        const int v = v0 + k * blockDim.x;
        if (v < words) {
          const float4 w = g4[v];
          q[k][0] = w.x;
          q[k][1] = w.y;
          q[k][2] = w.z;
          q[k][3] = w.w;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWordsInFlight; ++k) {
      const int v = v0 + k * blockDim.x;
      if (v >= words) break;
      const int e = head + 4 * v;
      int r = e / cols;
      int c = e - r * cols;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kIn) sm[r * stride + c] = q[k][j]; else q[k][j] = sm[r * stride + c];
        if (++c == cols) {
          c = 0;
          ++r;
        }
      }
      if (!kIn) g4[v] = make_float4(q[k][0], q[k][1], q[k][2], q[k][3]);
    }
  }
}

// Running sums along the rows of x [rows, cols], block b the rows
// [b band, (b + 1) band), tiles of `tile` columns at `stride` floats a
// shared row (odd, at least tile).
__global__ void __launch_bounds__(kScanThreads)
    cumsum_cols_kernel(const float* __restrict__ x, float* __restrict__ out, long long rows,
                       int cols, int band, int tile, int stride) {
  extern __shared__ float sm[];
  const long long row0 = static_cast<long long>(blockIdx.x) * band;
  const int nb = static_cast<int>(rows - row0 < band ? rows - row0 : band);
  float* src = const_cast<float*>(x) + row0 * cols;
  float* dst = out + row0 * cols;
  float* mine = sm + threadIdx.x * stride;
  float acc = -0.0f;
  for (int c0 = 0; c0 < cols; c0 += tile) {
    const int len = cols - c0 < tile ? cols - c0 : tile;
    if (c0 > 0) __syncthreads();  // the last tile is out of shared memory
    move_band<true>(src + c0, sm, nb, len, cols, stride);
    __syncthreads();
    if (threadIdx.x < nb) {
#pragma unroll 8
      for (int c = 0; c < len; ++c) {
        acc = __fadd_rn(acc, mine[c]);
        mine[c] = acc;
      }
    }
    __syncthreads();
    move_band<false>(dst + c0, sm, nb, len, cols, stride);
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
    const long long fill = (rows + kFillBlocks - 1) / kFillBlocks;
    const int band = static_cast<int>(fill < kScanThreads ? fill : kScanThreads);
    const long long blocks = (rows + band - 1) / band;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    int cap = kMaxBandBytes / static_cast<int>(sizeof(float)) / band;  // floats a shared row
    cap -= 1 - cap % 2;  // odd
    const int tile = (cols | 1) <= cap ? cols : cap;
    const int stride = tile | 1;
    cumsum_cols_kernel<<<static_cast<unsigned>(blocks), kScanThreads,
                         sizeof(float) * band * stride, s>>>(x, out, rows, cols, band, tile,
                                                             stride);
  }
  return static_cast<int>(cudaGetLastError());
}
