// Host-side point-cloud ops of the port: voxel-grid downsample and
// spatial-hash radius queries, for the offline preprocessors and the OpenGF
// loader (scream_tpu_torch/data/). The port's own copy of the JAX package's
// native library, so that the port builds nothing from the JAX package:
// the same code, so both give the same bits.
//
// The reference leans on Open3D's C++ for these host-path ops
// (voxel_down_sample: reference process_3d_match.py:31, process_kitti.py:55,
// datasets/open_gf.py:22; KDTreeFlann radius search: reference
// utils.py:94-108).
//
// Build (scream_tpu_torch/native/__init__.py, at first use):
//   g++ -O3 -fPIC -shared pointops.cpp -o libpointops_<hash>.so
//
// Semantics, matched by the numpy plain versions beside the bindings:
//   * voxel key = floor((p - min) / voxel), linearized x-major, output
//     ordered by key, centroid per voxel (float64 sums in input order).
//   * radius queries use a uniform grid of cell == radius, scanning the 27
//     neighboring cells; a point at exactly the radius counts.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <algorithm>

extern "C" {

// Voxel-grid downsample.
//   points: n x 3 float64, voxel: edge length
//   out_points: capacity n x 3 (written with the centroids)
// Returns the number of occupied voxels (centroids written, ordered by
// linearized voxel key).
int64_t voxel_downsample(const double* points, int64_t n, double voxel,
                         double* out_points) {
  if (n <= 0) return 0;
  double mn[3] = {points[0], points[1], points[2]};
  for (int64_t i = 1; i < n; ++i)
    for (int d = 0; d < 3; ++d) mn[d] = std::min(mn[d], points[i * 3 + d]);

  int64_t dims[3] = {1, 1, 1};
  std::vector<int64_t> coord(n * 3);
  for (int64_t i = 0; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      int64_t c = (int64_t)std::floor((points[i * 3 + d] - mn[d]) / voxel);
      coord[i * 3 + d] = c;
      dims[d] = std::max(dims[d], c + 1);
    }
  }

  struct Acc { double s[3] = {0, 0, 0}; int64_t cnt = 0; };
  std::unordered_map<int64_t, Acc> cells;
  cells.reserve((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t key = (coord[i * 3] * dims[1] + coord[i * 3 + 1]) * dims[2]
                  + coord[i * 3 + 2];
    Acc& a = cells[key];
    for (int d = 0; d < 3; ++d) a.s[d] += points[i * 3 + d];
    a.cnt += 1;
  }

  std::vector<int64_t> keys;
  keys.reserve(cells.size());
  for (auto& kv : cells) keys.push_back(kv.first);
  std::sort(keys.begin(), keys.end());

  int64_t m = 0;
  for (int64_t key : keys) {
    const Acc& a = cells[key];
    for (int d = 0; d < 3; ++d)
      out_points[m * 3 + d] = a.s[d] / (double)a.cnt;
    ++m;
  }
  return m;
}

}  // extern "C"

namespace {

// Uniform grid over query-space with cell size == radius.
struct Grid {
  double origin[3];
  double cell;
  int64_t dims[3];
  std::unordered_map<int64_t, std::vector<int32_t>> buckets;

  int64_t key_of(const double* p) const {
    int64_t c[3];
    for (int d = 0; d < 3; ++d) {
      int64_t v = (int64_t)std::floor((p[d] - origin[d]) / cell);
      c[d] = std::max((int64_t)0, std::min(v, dims[d] - 1));
    }
    return (c[0] * dims[1] + c[1]) * dims[2] + c[2];
  }
};

void build_grid(Grid& g, const double* pts, int64_t m, double radius) {
  g.cell = radius > 0 ? radius : 1.0;
  if (m <= 0) {  // empty reference cloud: no buckets, every query misses
    for (int d = 0; d < 3; ++d) { g.origin[d] = 0.0; g.dims[d] = 1; }
    return;
  }
  double mx[3];
  for (int d = 0; d < 3; ++d) { g.origin[d] = pts[d]; mx[d] = pts[d]; }
  for (int64_t i = 1; i < m; ++i)
    for (int d = 0; d < 3; ++d) {
      g.origin[d] = std::min(g.origin[d], pts[i * 3 + d]);
      mx[d] = std::max(mx[d], pts[i * 3 + d]);
    }
  for (int d = 0; d < 3; ++d)
    g.dims[d] = std::max((int64_t)1,
                         (int64_t)std::floor((mx[d] - g.origin[d]) / g.cell) + 1);
  g.buckets.reserve((size_t)m);
  for (int64_t i = 0; i < m; ++i)
    g.buckets[g.key_of(pts + i * 3)].push_back((int32_t)i);
}

template <typename Fn>
void for_neighbors(const Grid& g, const double* q, Fn&& fn) {
  int64_t c[3];
  for (int d = 0; d < 3; ++d) {
    int64_t v = (int64_t)std::floor((q[d] - g.origin[d]) / g.cell);
    c[d] = std::max((int64_t)0, std::min(v, g.dims[d] - 1));
  }
  for (int64_t dx = -1; dx <= 1; ++dx)
    for (int64_t dy = -1; dy <= 1; ++dy)
      for (int64_t dz = -1; dz <= 1; ++dz) {
        int64_t x = c[0] + dx, y = c[1] + dy, z = c[2] + dz;
        if (x < 0 || y < 0 || z < 0 || x >= g.dims[0] || y >= g.dims[1] ||
            z >= g.dims[2])
          continue;
        auto it = g.buckets.find((x * g.dims[1] + y) * g.dims[2] + z);
        if (it == g.buckets.end()) continue;
        for (int32_t idx : it->second) fn(idx);
      }
}

inline double dist2(const double* a, const double* b) {
  double s = 0;
  for (int d = 0; d < 3; ++d) {
    double t = a[d] - b[d];
    s += t * t;
  }
  return s;
}

}  // namespace

extern "C" {

// For each of the n query points, 1 if any of the m reference points lies
// within `radius` (the overlap test of utils.get_correspondences).
void radius_has_neighbor(const double* query, int64_t n, const double* ref,
                         int64_t m, double radius, uint8_t* out) {
  Grid g;
  build_grid(g, ref, m, radius);
  double r2 = radius * radius;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t hit = 0;
    for_neighbors(g, query + i * 3, [&](int32_t j) {
      if (!hit && dist2(query + i * 3, ref + j * 3) <= r2) hit = 1;
    });
    out[i] = hit;
  }
}

// Counts of reference points within `radius` of each query point.
void radius_count(const double* query, int64_t n, const double* ref, int64_t m,
                  double radius, int32_t* out) {
  Grid g;
  build_grid(g, ref, m, radius);
  double r2 = radius * radius;
  for (int64_t i = 0; i < n; ++i) {
    int32_t cnt = 0;
    for_neighbors(g, query + i * 3, [&](int32_t j) {
      if (dist2(query + i * 3, ref + j * 3) <= r2) ++cnt;
    });
    out[i] = cnt;
  }
}

// Index of the highest-z reference point within 2-D `radius` of each query
// point, or -1 (the DSM extraction of process_open_gf.py:217-231).
void highest_in_radius_2d(const double* query, int64_t n, const double* ref,
                          int64_t m, double radius, int32_t* out) {
  // 2-D grid: use z = 0 for bucketing.
  std::vector<double> flat((size_t)m * 3);
  for (int64_t i = 0; i < m; ++i) {
    flat[i * 3] = ref[i * 3];
    flat[i * 3 + 1] = ref[i * 3 + 1];
    flat[i * 3 + 2] = 0.0;
  }
  Grid g;
  build_grid(g, flat.data(), m, radius);
  double r2 = radius * radius;
  for (int64_t i = 0; i < n; ++i) {
    double q2[3] = {query[i * 3], query[i * 3 + 1], 0.0};
    int32_t best = -1;
    double best_z = -1e300;
    for_neighbors(g, q2, [&](int32_t j) {
      double dx = query[i * 3] - ref[j * 3];
      double dy = query[i * 3 + 1] - ref[j * 3 + 1];
      if (dx * dx + dy * dy > r2) return;
      double z = ref[j * 3 + 2];
      // Equal heights tie-break to the lowest index (bucket scan order is
      // arbitrary), as the numpy plain version does.
      if (z > best_z || (z == best_z && (best < 0 || j < best))) {
        best_z = z;
        best = j;
      }
    });
    out[i] = best;
  }
}

}  // extern "C"
