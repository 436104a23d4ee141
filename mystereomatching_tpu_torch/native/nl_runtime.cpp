// Host runtime of the NL tree filter: the 3x3 median prefilter and the
// grid minimum spanning tree, rooted by a breadth-first walk.
//
// This package's own copy of `msm_median3x3_u8` and `msm_mst_grid_n` in
// mystereomatching_tpu/native/nl_runtime.cpp (the port imports nothing of
// the JAX package). Kruskal over edges sorted by a stable 256-bin counting
// sort, then a BFS from node 0: the reference's algorithm and tie order
// (qx_mst_kruskals_image.cpp:167-277). No TPU kernel does this work; it
// runs on the host, before the device work of a frame.
//
// Build: c++ -O3 -std=c++17 -fPIC -shared (done at first use by
// mystereomatching_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// 3x3 median, per channel, replicate border. src/dst: [h, w, ch] uint8.
void msm_median3x3_u8(const uint8_t* src, uint8_t* dst, int h, int w, int ch) {
  std::vector<uint8_t> win(9);
  for (int c = 0; c < ch; ++c) {
    for (int v = 0; v < h; ++v) {
      for (int u = 0; u < w; ++u) {
        int k = 0;
        for (int dv = -1; dv <= 1; ++dv) {
          int vv = std::min(std::max(v + dv, 0), h - 1);
          for (int du = -1; du <= 1; ++du) {
            int uu = std::min(std::max(u + du, 0), w - 1);
            win[k++] = src[(vv * w + uu) * ch + c];
          }
        }
        std::nth_element(win.begin(), win.begin() + 4, win.end());
        dst[(v * w + u) * ch + c] = win[4];
      }
    }
  }
}

// image: [h, w, ch] uint8. Outputs, [h * w] each: parent (node 0, the
// root, is its own), weight (max-channel |dI| of the edge to the parent)
// and order (the BFS order: parents before children, each node's children
// consecutive). nr: 4 or 8 neighbours (qx_mst_kruskals_image.h:11-12; the
// 8-neighbour list appends per cell the down-right then the down-left
// diagonal, row-major, cpp:71-86).
void msm_mst_grid_n(const uint8_t* image, int h, int w, int ch, int nr, int32_t* parent,
                    int32_t* weight, int32_t* order) {
  const int n = h * w;
  const int ne4 = h * (w - 1) + (h - 1) * w;
  const int ne = nr == 8 ? ne4 + 2 * (h - 1) * (w - 1) : ne4;
  std::vector<int32_t> eu(ne), ev(ne);
  std::vector<uint8_t> ew(ne);
  int k = 0;
  auto wdiff = [&](int a, int b) {
    int m = 0;
    for (int c = 0; c < ch; ++c)
      m = std::max(m, std::abs(static_cast<int>(image[a * ch + c]) -
                               static_cast<int>(image[b * ch + c])));
    return static_cast<uint8_t>(m);
  };
  for (int v = 0; v < h; ++v)  // right edges, row-major
    for (int u = 0; u + 1 < w; ++u) {
      int a = v * w + u;
      eu[k] = a; ev[k] = a + 1; ew[k] = wdiff(a, a + 1); ++k;
    }
  for (int u = 0; u < w; ++u)  // down edges, column-major (the reference's order)
    for (int v = 0; v + 1 < h; ++v) {
      int a = v * w + u;
      eu[k] = a; ev[k] = a + w; ew[k] = wdiff(a, a + w); ++k;
    }
  if (nr == 8)  // diagonals, row-major, down-right then down-left
    for (int v = 0; v + 1 < h; ++v)
      for (int u = 0; u + 1 < w; ++u) {
        int a = v * w + u;
        eu[k] = a; ev[k] = a + w + 1; ew[k] = wdiff(a, a + w + 1); ++k;
        eu[k] = a + 1; ev[k] = a + w; ew[k] = wdiff(a + 1, a + w); ++k;
      }

  // stable 256-bin counting sort of the edge indices by weight
  std::vector<int> bins(257, 0);
  for (int i = 0; i < ne; ++i) bins[ew[i] + 1]++;
  for (int b = 0; b < 256; ++b) bins[b + 1] += bins[b];
  std::vector<int32_t> sorted(ne);
  {
    std::vector<int> pos(bins.begin(), bins.end() - 1);
    for (int i = 0; i < ne; ++i) sorted[pos[ew[i]]++] = i;
  }

  // Kruskal with a path-compressing union-find
  std::vector<int32_t> uf(n);
  for (int i = 0; i < n; ++i) uf[i] = i;
  auto find = [&](int x) {
    int r = x;
    while (uf[r] != r) r = uf[r];
    while (uf[x] != r) { int nx = uf[x]; uf[x] = r; x = nx; }
    return r;
  };
  // adjacency lists of the chosen edges (each list newest first)
  const int slots = n > 1 ? 2 * (n - 1) : 0;
  std::vector<int32_t> head(n, -1), nxt(slots), adj(slots), adjw(slots);
  int m = 0;
  for (int s = 0; s < ne && m < slots; ++s) {
    int e = sorted[s];
    int ra = find(eu[e]), rb = find(ev[e]);
    if (ra == rb) continue;
    uf[ra] = rb;
    adj[m] = ev[e]; adjw[m] = ew[e]; nxt[m] = head[eu[e]]; head[eu[e]] = m; ++m;
    adj[m] = eu[e]; adjw[m] = ew[e]; nxt[m] = head[ev[e]]; head[ev[e]] = m; ++m;
  }

  // BFS from node 0
  std::vector<int32_t> queue(n);
  std::vector<uint8_t> seen(n, 0);
  int qh = 0, qt = 0;
  queue[qt++] = 0; seen[0] = 1; parent[0] = 0; weight[0] = 0;
  while (qh < qt) {
    int x = queue[qh++];
    for (int e = head[x]; e != -1; e = nxt[e]) {
      int y = adj[e];
      if (!seen[y]) {
        seen[y] = 1;
        parent[y] = x;
        weight[y] = adjw[e];
        queue[qt++] = y;
      }
    }
  }
  std::memcpy(order, queue.data(), sizeof(int32_t) * n);
}

}  // extern "C"
