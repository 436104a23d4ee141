// Kernel C: the SGM path-cost recurrence along H or W, forward or backward.
//
// Replaces the TPU kernel `_sgm_kernel` in
// mystereomatching_tpu/ops/pallas_kernels.py (called through
// `sgm_scan_pallas` from `sgm.sgm_directions`).
//
// What it computes, for G volumes [G, D, H, W] (float32 or bfloat16) and
// one scan direction: the recurrence of sgm_band.cuh along every column
// (along H) or row (along W), from the far end when `reverse`.
//
// What bounds it on the H100: bytes (sgm_band.cuh): the costs and scales
// read once and the path costs written once.
//
// Design: one block a band of adjacent scan lines of one volume, staged
// through shared memory a box of kBox pixels at a time (sgm_band.cuh).
// Along H the band is AlongH::kLines columns and a box holds kBox / kLines
// rows of them; along W the band is AlongW::kLines rows and a box holds
// kBox / kLines columns of each, cut at multiples of that from the left in both
// directions so that row segments stay sector-aligned where the rows are.
// The loop over stages replaces the TPU's sequential H-chunk grid and its
// VMEM carry. Directions are start rows, box orders and strides: no
// transposed or flipped copy is made.
//
// The TPU kernel's two optional inputs, which the row-band pipeline passes
// (parallel/sharded.py), are a second kernel along H, sgm_scan_ext_kernel:
// `init_ref` (pallas_kernels.py:788-793), each column's carry read from a
// [D, w] row instead of zeros, and `mask_ref` (803-810), each path cost
// multiplied by an in-image mask staged in the box beside the scales.
//
// The second kernel takes a table of scans, each a W chunk of its own
// [D, h, pitch] buffer, as a __grid_constant__ launch parameter, so that a
// band's whole wavefront chunk step (every direction of a band order, for
// every volume) is one launch that fills the card: the blocks are numbered
// over every scan's bands, and a block finds its scan from the prefix
// counts in the table. A scan reads its chunk in place, at its column
// offset with the buffer's pitch, writes its path costs in place into its
// output buffer, and copies its last row, the one the next band starts
// from, into a contiguous [D, w] row ready to send. The mask is a per-scan
// runtime choice, uniform over a block: an unmasked scan stages 1.0f and
// multiplies by it, which is exact in both types. In bfloat16 each cost is
// still staged as the aligned word holding it with the parity of its
// element index, taken from its address, so odd pitches (a skewed buffer of
// W + Hg - 1 columns) and odd chunk offsets keep working. 16-byte copies and
// TMA do not fit: neither the offsets nor the pitches are multiples of 16
// bytes in general (1749 columns, chunks at 219 c).
//
// What bounds the chunk scans on the H100: the row walk, not the bytes. A
// chunk step moves some 290 MB (0.087 ms at 3.35 TB/s), but a block walks
// its chunk's 250 rows one stage of kSteps rows at a time, and every scan
// of a launch walks them side by side; the table makes all of them one
// walk. Most of a stage is its staging, 4-byte copies of row segments
// kLines columns wide at any alignment, in and out: with the recurrence
// left out a launch still takes about 70% of its time (PERF.md, section
// 6), and a deeper or shallower ring changes it by under 2%. The block
// width (TableH::kLines columns: 16 or 4) trades blocks for warps a
// block: a launch whose blocks at 4 columns fit on the SMs walks faster at
// 4, one that would not fit at 16; the wrapper chooses from the launch's
// blocks (8 columns lost to one of the two in every case measured). Two
// rows a stage (kSteps) were 1-4% faster than four at both widths.
#include "sgm_band.cuh"

namespace {

// Lines along H: the band is columns x0 .. x0 + kLines - 1; stage s holds
// steps t = kSteps s .. + kSteps - 1 (box row t % kSteps, at image row t,
// or H - 1 - t when reverse), box column = line.
struct AlongH {
  static constexpr int kLines = 16, kBox = 64, kSteps = kBox / kLines, kCols = kLines;
  int h, w, x0, reverse;
  __device__ int n_stages() const { return (h + kSteps - 1) / kSteps; }
  __device__ long long pixel(int s, int b) const {
    const int t = s * kSteps + b / kCols, x = x0 + b % kCols;
    if (t >= h || x >= w) return -1;
    return static_cast<long long>(reverse ? h - 1 - t : t) * w + x;
  }
  __device__ int walk(int s, int line, int& idx, int& stride, bool& begins) const {
    idx = line;
    stride = kCols;
    begins = s == 0;
    return x0 + line < w ? min(kSteps, h - s * kSteps) : 0;
  }
};

// Lines along W: the band is rows y0 .. y0 + kLines - 1 (box row = line);
// stage s holds columns x_of(s) .. + kSteps - 1 (box column x % kSteps),
// counted from the right when reverse, and each line walks them right to
// left when reverse.
struct AlongW {
  static constexpr int kLines = 4, kBox = 64, kSteps = kBox / kLines, kCols = kSteps;
  int h, w, y0, reverse;
  __device__ int n_stages() const { return (w + kSteps - 1) / kSteps; }
  __device__ int x_of(int s) const { return (reverse ? n_stages() - 1 - s : s) * kSteps; }
  __device__ long long pixel(int s, int b) const {
    const int y = y0 + b / kCols, x = x_of(s) + b % kCols;
    if (y >= h || x >= w) return -1;
    return static_cast<long long>(y) * w + x;
  }
  __device__ int walk(int s, int line, int& idx, int& stride, bool& begins) const {
    const int n = y0 + line < h ? min(kSteps, w - x_of(s)) : 0;
    idx = line * kCols + (reverse ? n - 1 : 0);
    stride = reverse ? -1 : 1;
    begins = s == 0;
    return n;
  }
};

template <typename T, int kSlots, class Geom>
__global__ void __launch_bounds__(Geom::kLines * 32, 1)
    sgm_scan_kernel(const T* __restrict__ vol, const float* __restrict__ pscale,
                    T* __restrict__ out, int nd, int h, int w, int n_bands, int reverse,
                    float p1, float p2) {
  const int gi = blockIdx.x / n_bands;
  const int band = blockIdx.x % n_bands;
  const long long plane = static_cast<long long>(h) * w;
  const long long vol_off = static_cast<long long>(gi) * nd * plane;
  mysm::sgm_band<T, kSlots>(vol + vol_off, pscale + gi * plane, out + vol_off, plane, nd, p1,
                            p2, Geom{h, w, band * Geom::kLines, reverse});
}

// Lines along H of a table's scan: the band is columns x0 .. x0 + kLines - 1
// of a chunk w columns wide, rows pitch elements apart; stage s holds steps
// t = kSteps s .. + kSteps - 1 (box row t % kSteps, at image row t, or
// h - 1 - t when reverse), box column = line. kMinBlocks: the blocks an SM
// that __launch_bounds__ keeps registers for.
template <int kLines_>
struct TableH {
  static constexpr int kLines = kLines_, kSteps = 2, kBox = kLines * kSteps, kCols = kLines;
  static constexpr int kMinBlocks = 16 / kLines;
  int h, w, pitch, x0, reverse;
  __device__ int n_stages() const { return (h + kSteps - 1) / kSteps; }
  __device__ long long pixel(int s, int b) const {
    const int t = s * kSteps + b / kCols, x = x0 + b % kCols;
    if (t >= h || x >= w) return -1;
    return static_cast<long long>(reverse ? h - 1 - t : t) * pitch + x;
  }
  __device__ int walk(int s, int line, int& idx, int& stride, bool& begins) const {
    idx = line;
    stride = kCols;
    begins = s == 0;
    return x0 + line < w ? min(kSteps, h - s * kSteps) : 0;
  }
  // the column of the edge row (relative to x0) that pixel b of stage s
  // holds: its line's last step, or -1
  __device__ int edge(int s, int b) const {
    return s * kSteps + b / kCols == h - 1 && x0 + b % kCols < w ? b % kCols : -1;
  }
  __device__ long long edge_pitch() const { return w; }
};

constexpr int kMaxScans = 32;
constexpr int kTableFields = 12;  // int64 fields of a scan in mysm_sgm_scan_ext's desc

// One scan of a table: its chunk's column 0 in each buffer (costs and path
// costs [D, h, pitch] plane elements apart, scales and mask [h, pitch]);
// init and edge are [D, w] rows, mask, init and edge may be null.
struct ChunkScan {
  const void* vol;
  const float* pscale;
  const float* mask;
  const void* init;
  void* out;
  void* edge;
  long long plane;
  int pitch, h, w, reverse;
  int first_block;  // blocks of the scans before it
};

struct ScanTable {
  ChunkScan scan[kMaxScans];
  int n;
};

template <typename T, int kSlots, int kLines>
__global__ void __launch_bounds__(kLines * 32, TableH<kLines>::kMinBlocks)
    sgm_scan_ext_kernel(const __grid_constant__ ScanTable table, int nd, float p1,
                          float p2) {
  int i = 0;
  while (i + 1 < table.n && static_cast<int>(blockIdx.x) >= table.scan[i + 1].first_block) ++i;
  const ChunkScan& sc = table.scan[i];
  const int x0 = (static_cast<int>(blockIdx.x) - sc.first_block) * kLines;
  const T* init = static_cast<const T*>(sc.init);
  T* edge = static_cast<T*>(sc.edge);
  mysm::sgm_band<T, kSlots, TableH<kLines>, true, true>(
      static_cast<const T*>(sc.vol), sc.pscale, static_cast<T*>(sc.out), sc.plane, nd, p1, p2,
      TableH<kLines>{sc.h, sc.w, sc.pitch, x0, sc.reverse},
      init != nullptr ? init + x0 : nullptr, sc.w, sc.mask, edge != nullptr ? edge + x0 : nullptr);
}

// The table from desc (n scans of kTableFields int64: vol, pscale, mask,
// init, out, edge, plane, pitch, h, w, reverse, unused); returns the blocks
// at kLines columns a block, or -1 if the table is refused.
template <int kLines>
long long make_table(const long long* desc, int n, ScanTable& table) {
  if (n < 1 || n > kMaxScans) return -1;
  long long blocks = 0;
  table.n = n;
  for (int i = 0; i < n; ++i) {
    const long long* f = desc + i * kTableFields;
    ChunkScan& sc = table.scan[i];
    sc.vol = reinterpret_cast<const void*>(f[0]);
    sc.pscale = reinterpret_cast<const float*>(f[1]);
    sc.mask = reinterpret_cast<const float*>(f[2]);
    sc.init = reinterpret_cast<const void*>(f[3]);
    sc.out = reinterpret_cast<void*>(f[4]);
    sc.edge = reinterpret_cast<void*>(f[5]);
    sc.plane = f[6];
    sc.pitch = static_cast<int>(f[7]);
    sc.h = static_cast<int>(f[8]);
    sc.w = static_cast<int>(f[9]);
    sc.reverse = static_cast<int>(f[10]);
    if (sc.h < 1 || sc.w < 1 || sc.w > sc.pitch) return -1;
    sc.first_block = static_cast<int>(blocks);
    blocks += (sc.w + kLines - 1) / kLines;
  }
  return blocks < (1LL << 31) ? blocks : -1;
}

template <typename T, int kLines>
cudaError_t launch_table(const long long* desc, int n, int nd, float p1, float p2,
                         void* stream) {
  ScanTable table;
  const long long blocks = make_table<kLines>(desc, n, table);
  if (blocks < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  mysm::with_slots(nd, [&](auto slots) {
    constexpr int kSlots = decltype(slots)::value;
    err = mysm::launch_band<T, kSlots, TableH<kLines>, true>(
        sgm_scan_ext_kernel<T, kSlots, kLines>, static_cast<unsigned>(blocks), nd, stream,
        table, nd, p1, p2);
  });
  return err;
}

template <typename T>
cudaError_t launch_table_lines(const long long* desc, int n, int nd, int lines, float p1,
                               float p2, void* stream) {
  switch (lines) {
    case 16: return launch_table<T, 16>(desc, n, nd, p1, p2, stream);
    case 4: return launch_table<T, 4>(desc, n, nd, p1, p2, stream);
    default: return cudaErrorInvalidValue;
  }
}

// out3 = (ring stages, dynamic shared memory bytes a block, blocks an SM
// the occupancy calculator allows) of the table kernel's instance
template <typename T, int kLines>
cudaError_t table_info(int nd, int* out3) {
  cudaError_t err = cudaErrorInvalidValue;
  mysm::with_slots(nd, [&](auto slots) {
    constexpr int kSlots = decltype(slots)::value;
    constexpr int kBox = TableH<kLines>::kBox;
    const int ring = mysm::ring_depth<T, kSlots, kBox, true>;
    const int bytes = ring * mysm::stage_words<T, true>(nd, kBox) * 4;
    auto kernel = sgm_scan_ext_kernel<T, kSlots, kLines>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    int per_sm = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLines * 32, bytes);
    }
    out3[0] = ring;
    out3[1] = bytes;
    out3[2] = per_sm;
  });
  return err;
}

template <typename T>
cudaError_t table_info_lines(int nd, int lines, int* out3) {
  switch (lines) {
    case 16: return table_info<T, 16>(nd, out3);
    case 4: return table_info<T, 4>(nd, out3);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, class Geom>
cudaError_t launch(const void* vol, const float* pscale, void* out, int g, int nd, int h,
                   int w, int reverse, float p1, float p2, void* stream) {
  const int n_bands = ((std::is_same_v<Geom, AlongW> ? h : w) + Geom::kLines - 1) / Geom::kLines;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(g) * n_bands);
  cudaError_t err = cudaErrorInvalidValue;
  mysm::with_slots(nd, [&](auto slots) {
    constexpr int kSlots = decltype(slots)::value;
    err = mysm::launch_band<T, kSlots, Geom>(sgm_scan_kernel<T, kSlots, Geom>, blocks, nd,
                                             stream, static_cast<const T*>(vol), pscale,
                                             static_cast<T*>(out), nd, h, w, n_bands, reverse,
                                             p1, p2);
  });
  return err;
}

template <typename T>
cudaError_t launch_axis(const void* vol, const float* pscale, void* out, int g, int nd, int h,
                        int w, int along_w, int reverse, float p1, float p2, void* stream) {
  return along_w ? launch<T, AlongW>(vol, pscale, out, g, nd, h, w, reverse, p1, p2, stream)
                 : launch<T, AlongH>(vol, pscale, out, g, nd, h, w, reverse, p1, p2, stream);
}

}  // namespace

// vol/out: [G, D, H, W] float32 (mysm_sgm_scan) or bfloat16
// (mysm_sgm_scan_bf16), D <= 256; pscale: [G, H, W] float32. along_w: 1
// scans along W, 0 along H; reverse: 1 scans from the far end.
extern "C" int mysm_sgm_scan(const float* vol, const float* pscale, float* out, int g, int nd,
                             int h, int w, int along_w, int reverse, float p1, float p2,
                             void* stream) {
  return static_cast<int>(
      launch_axis<float>(vol, pscale, out, g, nd, h, w, along_w, reverse, p1, p2, stream));
}
extern "C" int mysm_sgm_scan_bf16(const void* vol, const float* pscale, void* out, int g,
                                  int nd, int h, int w, int along_w, int reverse, float p1,
                                  float p2, void* stream) {
  return static_cast<int>(launch_axis<mysm::bf16>(vol, pscale, out, g, nd, h, w, along_w,
                                                  reverse, p1, p2, stream));
}

// A table of n <= 32 scans along H (sgm_scan_ext_kernel): desc holds
// kTableFields int64 a scan (vol, pscale, mask, init, out, edge pointers,
// the D-plane stride, pitch, h, w, reverse, unused). Every scan has nd <= 256
// disparities of float32 (mysm_sgm_scan_ext) or bfloat16 (_bf16); lines:
// the block width in columns, 16 or 4.
extern "C" int mysm_sgm_scan_ext(const long long* desc, int n, int nd, int lines, float p1,
                                   float p2, void* stream) {
  return static_cast<int>(launch_table_lines<float>(desc, n, nd, lines, p1, p2, stream));
}
extern "C" int mysm_sgm_scan_ext_bf16(const long long* desc, int n, int nd, int lines,
                                        float p1, float p2, void* stream) {
  return static_cast<int>(launch_table_lines<mysm::bf16>(desc, n, nd, lines, p1, p2, stream));
}
// The ring stages, shared memory bytes a block and blocks an SM of the
// table kernel at nd disparities, bf16 or float32, lines columns a block.
extern "C" int mysm_sgm_scan_ext_info(int nd, int bf16, int lines, int* out3) {
  return static_cast<int>(bf16 ? table_info_lines<mysm::bf16>(nd, lines, out3)
                               : table_info_lines<float>(nd, lines, out3));
}
