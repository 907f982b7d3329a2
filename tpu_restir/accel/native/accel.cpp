// Native acceleration-structure builders (the Embree build-side
// replacement, SURVEY.md §2.3): Morton clustering and a binned-SAH BVH2,
// compiled to a shared library and bound via ctypes
// (tpu_restir/accel/native/__init__.py). Host-side only — traversal runs
// on the device; these builders produce the flattened arrays the device
// backends consume. OpenMP-parallel over triangles like the rest of the
// host pipeline.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t expand_bits(uint64_t v) {
  v &= 0x1fffff;
  v = (v | (v << 32)) & 0x1F00000000FFFFull;
  v = (v | (v << 16)) & 0x1F0000FF0000FFull;
  v = (v | (v << 8)) & 0x100F00F00F00F00Full;
  v = (v | (v << 4)) & 0x10C30C30C30C30C3ull;
  v = (v | (v << 2)) & 0x1249249249249249ull;
  return v;
}

struct Box {
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const float* p) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], p[a]);
      hi[a] = std::max(hi[a], p[a]);
    }
  }
  void grow(const Box& b) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], b.lo[a]);
      hi[a] = std::max(hi[a], b.hi[a]);
    }
  }
  float area() const {
    float e0 = std::max(hi[0] - lo[0], 0.f);
    float e1 = std::max(hi[1] - lo[1], 0.f);
    float e2 = std::max(hi[2] - lo[2], 0.f);
    return e0 * e1 + e1 * e2 + e2 * e0;
  }
};

}  // namespace

extern "C" {

// tri_v: (n, 3, 3) float32. Outputs: order (n) int32, cmin/cmax
// ((n+cluster_size-1)/cluster_size, 3) float32. Returns cluster count.
int accel_build_clusters(const float* tri_v, int n, int cluster_size,
                         int* order_out, float* cmin_out, float* cmax_out) {
  if (n <= 0 || cluster_size <= 0) return 0;
  std::vector<double> cent(3 * n);
  double lo[3] = {DBL_MAX, DBL_MAX, DBL_MAX};
  double hi[3] = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
#pragma omp parallel for
  for (int i = 0; i < n; ++i) {
    for (int a = 0; a < 3; ++a) {
      double c = (tri_v[i * 9 + 0 + a] + tri_v[i * 9 + 3 + a] +
                  tri_v[i * 9 + 6 + a]) / 3.0;
      cent[i * 3 + a] = c;
    }
  }
  for (int i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], cent[i * 3 + a]);
      hi[a] = std::max(hi[a], cent[i * 3 + a]);
    }

  std::vector<std::pair<uint64_t, int>> keys(n);
#pragma omp parallel for
  for (int i = 0; i < n; ++i) {
    uint64_t code = 0;
    for (int a = 0; a < 3; ++a) {
      double ext = std::max(hi[a] - lo[a], 1e-20);
      double q = (cent[i * 3 + a] - lo[a]) / ext * ((1 << 21) - 1);
      uint64_t qi = (uint64_t)std::min(std::max(q, 0.0),
                                       (double)((1 << 21) - 1));
      code |= expand_bits(qi) << (2 - a);
    }
    keys[i] = {code, i};
  }
  std::stable_sort(keys.begin(), keys.end());

  int n_clusters = (n + cluster_size - 1) / cluster_size;
  for (int i = 0; i < n; ++i) order_out[i] = keys[i].second;
#pragma omp parallel for
  for (int c = 0; c < n_clusters; ++c) {
    Box box;
    int lo_i = c * cluster_size;
    int hi_i = std::min(n, lo_i + cluster_size);
    for (int i = lo_i; i < hi_i; ++i) {
      const float* v = tri_v + (size_t)keys[i].second * 9;
      box.grow(v);
      box.grow(v + 3);
      box.grow(v + 6);
    }
    std::memcpy(cmin_out + c * 3, box.lo, 12);
    std::memcpy(cmax_out + c * 3, box.hi, 12);
  }
  return n_clusters;
}

// Binned-SAH BVH2. Outputs sized by caller to capacity 2n nodes:
// node_min/node_max (2n,3), left/right/start/count (2n,), order (n).
// Returns node count; max_depth written to *max_depth_out.
int accel_build_bvh2(const float* tri_v, int n, int leaf_size, int n_bins,
                     float* node_min, float* node_max, int* left, int* right,
                     int* start, int* count, int* order, int* max_depth_out) {
  if (n <= 0) return 0;
  std::vector<Box> tbox(n);
  std::vector<float> cent(3 * n);
#pragma omp parallel for
  for (int i = 0; i < n; ++i) {
    Box b;
    b.grow(tri_v + (size_t)i * 9);
    b.grow(tri_v + (size_t)i * 9 + 3);
    b.grow(tri_v + (size_t)i * 9 + 6);
    tbox[i] = b;
    for (int a = 0; a < 3; ++a)
      cent[i * 3 + a] = 0.5f * (b.lo[a] + b.hi[a]);
  }
  for (int i = 0; i < n; ++i) order[i] = i;

  struct Task { int node, lo, hi, depth; };
  std::vector<Task> stack;
  int n_nodes = 1;
  int max_depth = 1;
  stack.push_back({0, 0, n, 1});

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    max_depth = std::max(max_depth, t.depth);
    Box nb;
    for (int i = t.lo; i < t.hi; ++i) nb.grow(tbox[order[i]]);
    std::memcpy(node_min + t.node * 3, nb.lo, 12);
    std::memcpy(node_max + t.node * 3, nb.hi, 12);
    int m = t.hi - t.lo;
    if (m <= leaf_size) {
      left[t.node] = -1;
      right[t.node] = -1;
      start[t.node] = t.lo;
      count[t.node] = m;
      continue;
    }
    // centroid bounds + widest axis
    Box cb;
    for (int i = t.lo; i < t.hi; ++i) cb.grow(&cent[order[i] * 3]);
    int axis = 0;
    float ext = -1;
    for (int a = 0; a < 3; ++a) {
      float e = cb.hi[a] - cb.lo[a];
      if (e > ext) { ext = e; axis = a; }
    }
    int mid;
    if (ext <= 1e-12f) {
      mid = t.lo + m / 2;
    } else {
      std::vector<int> bin_count(n_bins, 0);
      std::vector<Box> bin_box(n_bins);
      auto bin_of = [&](int prim) {
        int b = (int)((cent[prim * 3 + axis] - cb.lo[axis]) / ext * n_bins);
        return std::min(b, n_bins - 1);
      };
      for (int i = t.lo; i < t.hi; ++i) {
        int b = bin_of(order[i]);
        bin_count[b]++;
        bin_box[b].grow(tbox[order[i]]);
      }
      // sweep for best split
      std::vector<float> rarea(n_bins);
      Box acc;
      int best = -1;
      float best_cost = FLT_MAX;
      for (int b = n_bins - 1; b >= 1; --b) {
        acc.grow(bin_box[b]);
        rarea[b] = acc.area();
      }
      acc = Box();
      int nl = 0;
      for (int b = 1; b < n_bins; ++b) {
        acc.grow(bin_box[b - 1]);
        nl += bin_count[b - 1];
        int nr = m - nl;
        if (nl == 0 || nr == 0) continue;
        float cost = nl * acc.area() + nr * rarea[b];
        if (cost < best_cost) { best_cost = cost; best = b; }
      }
      if (best < 0) {
        mid = t.lo + m / 2;
      } else {
        auto it = std::stable_partition(
            order + t.lo, order + t.hi,
            [&](int prim) { return bin_of(prim) < best; });
        mid = (int)(it - order);
        if (mid == t.lo || mid == t.hi) mid = t.lo + m / 2;
      }
    }
    int l_node = n_nodes++;
    int r_node = n_nodes++;
    left[t.node] = l_node;
    right[t.node] = r_node;
    start[t.node] = 0;
    count[t.node] = 0;
    stack.push_back({l_node, t.lo, mid, t.depth + 1});
    stack.push_back({r_node, mid, t.hi, t.depth + 1});
  }
  *max_depth_out = max_depth;
  return n_nodes;
}

}  // extern "C"
