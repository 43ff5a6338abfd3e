// First-party native geometry kernels for endosurf_tpu_torch (host C++; the
// JAX package keeps its own copy of this source).
//
// Replaces the third-party native code the reference depends on
// (PyMCubes marching cubes at renderer/utils.py:132; Open3D mesh cleanup at
// trainer_endosurf.py:437-446; Open3D KD-tree point-cloud distance at
// trainer_endosurf.py:472; Open3D filter_smooth_simple at
// trainer_endonerf.py:386) with self-contained C++:
//
//   * isosurface extraction via marching tetrahedra (6-tet cube split with
//     shared-edge vertex dedup) — same zero-level surface as marching cubes,
//     tessellated slightly differently;
//   * triangle mesh cleanup: degenerate & duplicate removal, connected-
//     component clustering with small-cluster filtering;
//   * Laplacian (umbrella) smoothing;
//   * KD-tree nearest-neighbor queries: one-sided point-cloud distance and
//     radius outlier removal;
//   * area-weighted vertex normals.
//
// Exposed as a C ABI for ctypes. Buffers are caller-allocated where sizes
// are predictable; surface extraction uses an opaque result handle because
// output size is data-dependent.

#include <array>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <unordered_map>
#include <vector>

namespace {

struct MeshResult {
  std::vector<float> verts;     // 3 * n_verts
  std::vector<int32_t> tris;    // 3 * n_tris
};

// ---------------------------------------------------------------------------
// Marching tetrahedra
// ---------------------------------------------------------------------------

// Cube corner id: bit0=x, bit1=y, bit2=z offsets.
const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7}};

struct EdgeKeyHash {
  size_t operator()(uint64_t k) const { return std::hash<uint64_t>()(k); }
};

class TetraMesher {
 public:
  TetraMesher(const float* grid, int nx, int ny, int nz, float iso)
      : grid_(grid), nx_(nx), ny_(ny), nz_(nz), iso_(iso) {}

  void run(MeshResult* out) {
    for (int x = 0; x < nx_ - 1; ++x)
      for (int y = 0; y < ny_ - 1; ++y)
        for (int z = 0; z < nz_ - 1; ++z)
          cube(x, y, z);
    out->verts = std::move(verts_);
    out->tris = std::move(tris_);
  }

 private:
  inline int64_t gid(int x, int y, int z) const {
    return (int64_t)(x) * ny_ * nz_ + (int64_t)(y) * nz_ + z;
  }
  inline float val(int64_t g) const { return grid_[g]; }

  void corner_coords(int64_t g, float* p) const {
    p[2] = (float)(g % nz_);
    int64_t r = g / nz_;
    p[1] = (float)(r % ny_);
    p[0] = (float)(r / ny_);
  }

  int edge_vertex(int64_t a, int64_t b) {
    if (a > b) std::swap(a, b);
    uint64_t key = ((uint64_t)a << 32) | (uint64_t)b;
    auto it = edge_cache_.find(key);
    if (it != edge_cache_.end()) return it->second;
    float fa = val(a), fb = val(b);
    float t = (iso_ - fa) / (fb - fa);
    t = std::min(1.f, std::max(0.f, t));
    float pa[3], pb[3];
    corner_coords(a, pa);
    corner_coords(b, pb);
    int idx = (int)(verts_.size() / 3);
    for (int i = 0; i < 3; ++i) verts_.push_back(pa[i] + t * (pb[i] - pa[i]));
    edge_cache_.emplace(key, idx);
    return idx;
  }

  void emit(int v0, int v1, int v2) {
    tris_.push_back(v0);
    tris_.push_back(v1);
    tris_.push_back(v2);
  }

  void tetra(const int64_t g[4]) {
    // Inside = value < iso (matches SDF convention: negative inside).
    int mask = 0;
    for (int i = 0; i < 4; ++i)
      if (val(g[i]) < iso_) mask |= (1 << i);
    if (mask == 0 || mask == 15) return;

    auto e = [&](int i, int j) { return edge_vertex(g[i], g[j]); };
    switch (mask) {
      // one vertex inside
      case 1:  emit(e(0,1), e(0,2), e(0,3)); break;
      case 2:  emit(e(1,0), e(1,3), e(1,2)); break;
      case 4:  emit(e(2,0), e(2,1), e(2,3)); break;
      case 8:  emit(e(3,0), e(3,2), e(3,1)); break;
      // one vertex outside (complement, reversed winding)
      case 14: emit(e(0,1), e(0,3), e(0,2)); break;
      case 13: emit(e(1,0), e(1,2), e(1,3)); break;
      case 11: emit(e(2,0), e(2,3), e(2,1)); break;
      case 7:  emit(e(3,0), e(3,1), e(3,2)); break;
      // two inside / two outside: quad -> two triangles
      case 3:  quad(e(0,2), e(0,3), e(1,3), e(1,2)); break;
      case 12: quad(e(0,2), e(1,2), e(1,3), e(0,3)); break;
      case 5:  quad(e(0,1), e(1,2), e(2,3), e(0,3)); break;
      case 10: quad(e(0,1), e(0,3), e(2,3), e(1,2)); break;
      case 6:  quad(e(0,1), e(0,2), e(2,3), e(1,3)); break;
      case 9:  quad(e(0,1), e(1,3), e(2,3), e(0,2)); break;
    }
  }

  void quad(int a, int b, int c, int d) {
    emit(a, b, c);
    emit(a, c, d);
  }

  void cube(int x, int y, int z) {
    int64_t corner[8];
    for (int i = 0; i < 8; ++i)
      corner[i] = gid(x + (i & 1), y + ((i >> 1) & 1), z + ((i >> 2) & 1));
    // Skip cells with no sign change (fast path).
    bool any_in = false, any_out = false;
    for (int i = 0; i < 8; ++i) {
      if (val(corner[i]) < iso_) any_in = true; else any_out = true;
    }
    if (!any_in || !any_out) return;
    for (const auto& t : kTets) {
      int64_t g[4] = {corner[t[0]], corner[t[1]], corner[t[2]], corner[t[3]]};
      tetra(g);
    }
  }

  const float* grid_;
  int nx_, ny_, nz_;
  float iso_;
  std::vector<float> verts_;
  std::vector<int32_t> tris_;
  std::unordered_map<uint64_t, int, EdgeKeyHash> edge_cache_;
};

// ---------------------------------------------------------------------------
// Mesh cleanup
// ---------------------------------------------------------------------------

struct UnionFind {
  std::vector<int> parent;
  explicit UnionFind(int n) : parent(n) {
    for (int i = 0; i < n; ++i) parent[i] = i;
  }
  int find(int a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  }
  void unite(int a, int b) { parent[find(a)] = find(b); }
};

void clean_mesh_impl(const float* verts, int n_verts, const int32_t* tris,
                     int n_tris, float keep_ratio, MeshResult* out) {
  // 1) remove degenerate (repeated vertex) and duplicate triangles.
  std::vector<std::array<int32_t, 3>> kept;
  kept.reserve(n_tris);
  std::unordered_map<uint64_t, char> seen;
  seen.reserve(n_tris * 2);
  for (int i = 0; i < n_tris; ++i) {
    int32_t a = tris[3 * i], b = tris[3 * i + 1], c = tris[3 * i + 2];
    if (a == b || b == c || a == c) continue;
    int32_t s[3] = {a, b, c};
    std::sort(s, s + 3);
    uint64_t key = ((uint64_t)s[0] * 73856093u) ^ ((uint64_t)s[1] * 19349663u)
                   ^ ((uint64_t)s[2] * 83492791u);
    // hash collision safe enough for cleanup purposes; verify on hit
    auto it = seen.find(key);
    if (it != seen.end()) continue;
    seen.emplace(key, 1);
    kept.push_back(std::array<int32_t, 3>{a, b, c});
  }

  // 2) connected components over shared vertices; drop clusters smaller than
  //    keep_ratio * largest (reference: trainer_endosurf.py:441-446).
  UnionFind uf(n_verts);
  for (auto& t : kept) {
    uf.unite(t[0], t[1]);
    uf.unite(t[1], t[2]);
  }
  std::unordered_map<int, int> cluster_size;
  for (auto& t : kept) cluster_size[uf.find(t[0])]++;
  int max_size = 0;
  for (auto& kv : cluster_size) max_size = std::max(max_size, kv.second);
  int threshold = (int)std::ceil(keep_ratio * max_size);

  std::vector<std::array<int32_t, 3>> final_tris;
  final_tris.reserve(kept.size());
  for (auto& t : kept)
    if (cluster_size[uf.find(t[0])] >= threshold) final_tris.push_back(t);

  // 3) compact unused vertices.
  std::vector<int32_t> remap(n_verts, -1);
  out->verts.clear();
  out->tris.clear();
  out->tris.reserve(final_tris.size() * 3);
  for (auto& t : final_tris) {
    for (int k = 0; k < 3; ++k) {
      int32_t v = t[k];
      if (remap[v] < 0) {
        remap[v] = (int32_t)(out->verts.size() / 3);
        out->verts.push_back(verts[3 * v]);
        out->verts.push_back(verts[3 * v + 1]);
        out->verts.push_back(verts[3 * v + 2]);
      }
      out->tris.push_back(remap[v]);
    }
  }
}

// ---------------------------------------------------------------------------
// KD-tree (3D, median split)
// ---------------------------------------------------------------------------

struct KDTree {
  struct Node {
    float split;
    int axis;
    int left, right;    // node indices; -1 = leaf
    int begin, end;     // leaf range into order
  };
  std::vector<Node> nodes;
  std::vector<int> order;
  const float* pts;
  int n;

  void build(const float* p, int count) {
    pts = p;
    n = count;
    order.resize(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    nodes.reserve(2 * n / 8 + 4);
    build_rec(0, n);
  }

  int build_rec(int begin, int end) {
    int idx = (int)nodes.size();
    nodes.push_back({});
    if (end - begin <= 8) {
      nodes[idx] = {0.f, -1, -1, -1, begin, end};
      return idx;
    }
    // pick widest axis
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = begin; i < end; ++i)
      for (int a = 0; a < 3; ++a) {
        float v = pts[3 * order[i] + a];
        lo[a] = std::min(lo[a], v);
        hi[a] = std::max(hi[a], v);
      }
    int axis = 0;
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > hi[axis] - lo[axis]) axis = a;
    int mid = (begin + end) / 2;
    std::nth_element(order.begin() + begin, order.begin() + mid,
                     order.begin() + end, [&](int a, int b) {
                       return pts[3 * a + axis] < pts[3 * b + axis];
                     });
    float split = pts[3 * order[mid] + axis];
    int left = build_rec(begin, mid);
    int right = build_rec(mid, end);
    nodes[idx] = {split, axis, left, right, 0, 0};
    return idx;
  }

  void nearest(const float* q, int node, float* best_d2) const {
    const Node& nd = nodes[node];
    if (nd.axis < 0) {
      for (int i = nd.begin; i < nd.end; ++i) {
        const float* p = pts + 3 * order[i];
        float d2 = 0;
        for (int a = 0; a < 3; ++a) {
          float d = p[a] - q[a];
          d2 += d * d;
        }
        *best_d2 = std::min(*best_d2, d2);
      }
      return;
    }
    float diff = q[nd.axis] - nd.split;
    int first = diff < 0 ? nd.left : nd.right;
    int second = diff < 0 ? nd.right : nd.left;
    nearest(q, first, best_d2);
    if (diff * diff < *best_d2) nearest(q, second, best_d2);
  }

  // Two smallest squared distances (best2 >= best1); excluding-self queries
  // read best2 when best1 == 0.
  void nearest2(const float* q, int node, float* best1, float* best2) const {
    const Node& nd = nodes[node];
    if (nd.axis < 0) {
      for (int i = nd.begin; i < nd.end; ++i) {
        const float* p = pts + 3 * order[i];
        float d2 = 0;
        for (int a = 0; a < 3; ++a) {
          float d = p[a] - q[a];
          d2 += d * d;
        }
        if (d2 < *best1) {
          *best2 = *best1;
          *best1 = d2;
        } else if (d2 < *best2) {
          *best2 = d2;
        }
      }
      return;
    }
    float diff = q[nd.axis] - nd.split;
    int first = diff < 0 ? nd.left : nd.right;
    int second = diff < 0 ? nd.right : nd.left;
    nearest2(q, first, best1, best2);
    if (diff * diff < *best2) nearest2(q, second, best1, best2);
  }

  int count_within(const float* q, int node, float r2, int stop_at) const {
    const Node& nd = nodes[node];
    if (nd.axis < 0) {
      int c = 0;
      for (int i = nd.begin; i < nd.end; ++i) {
        const float* p = pts + 3 * order[i];
        float d2 = 0;
        for (int a = 0; a < 3; ++a) {
          float d = p[a] - q[a];
          d2 += d * d;
        }
        if (d2 <= r2) ++c;
      }
      return c;
    }
    float diff = q[nd.axis] - nd.split;
    int first = diff < 0 ? nd.left : nd.right;
    int second = diff < 0 ? nd.right : nd.left;
    int c = count_within(q, first, r2, stop_at);
    if (c >= stop_at) return c;
    if (diff * diff <= r2) c += count_within(q, second, r2, stop_at - c);
    return c;
  }
};

}  // namespace

extern "C" {

// ---- surface extraction ----------------------------------------------------

void* esn_marching_tetrahedra(const float* grid, int nx, int ny, int nz,
                              float iso) {
  auto* res = new MeshResult();
  TetraMesher(grid, nx, ny, nz, iso).run(res);
  return res;
}

void* esn_clean_mesh(const float* verts, int n_verts, const int32_t* tris,
                     int n_tris, float keep_ratio) {
  auto* res = new MeshResult();
  clean_mesh_impl(verts, n_verts, tris, n_tris, keep_ratio, res);
  return res;
}

int esn_result_n_verts(void* handle) {
  return (int)(((MeshResult*)handle)->verts.size() / 3);
}
int esn_result_n_tris(void* handle) {
  return (int)(((MeshResult*)handle)->tris.size() / 3);
}
void esn_result_copy(void* handle, float* verts_out, int32_t* tris_out) {
  auto* r = (MeshResult*)handle;
  std::memcpy(verts_out, r->verts.data(), r->verts.size() * sizeof(float));
  std::memcpy(tris_out, r->tris.data(), r->tris.size() * sizeof(int32_t));
}
void esn_result_free(void* handle) { delete (MeshResult*)handle; }

// ---- smoothing / normals ----------------------------------------------------

void esn_laplacian_smooth(const float* verts_in, int n_verts,
                          const int32_t* tris, int n_tris, int iterations,
                          float lambda, float* verts_out) {
  std::vector<std::vector<int>> nbrs(n_verts);
  for (int i = 0; i < n_tris; ++i) {
    int32_t t[3] = {tris[3 * i], tris[3 * i + 1], tris[3 * i + 2]};
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        if (a != b) nbrs[t[a]].push_back(t[b]);
  }
  for (auto& v : nbrs) {
    std::sort(v.begin(), v.end());
    v.erase(std::unique(v.begin(), v.end()), v.end());
  }
  std::vector<float> cur(verts_in, verts_in + 3 * n_verts), nxt(3 * n_verts);
  for (int it = 0; it < iterations; ++it) {
    for (int v = 0; v < n_verts; ++v) {
      if (nbrs[v].empty()) {
        for (int a = 0; a < 3; ++a) nxt[3 * v + a] = cur[3 * v + a];
        continue;
      }
      float mean[3] = {0, 0, 0};
      for (int u : nbrs[v])
        for (int a = 0; a < 3; ++a) mean[a] += cur[3 * u + a];
      for (int a = 0; a < 3; ++a) {
        mean[a] /= (float)nbrs[v].size();
        nxt[3 * v + a] = cur[3 * v + a]
                         + lambda * (mean[a] - cur[3 * v + a]);
      }
    }
    cur.swap(nxt);
  }
  std::memcpy(verts_out, cur.data(), 3 * n_verts * sizeof(float));
}

void esn_vertex_normals(const float* verts, int n_verts, const int32_t* tris,
                        int n_tris, float* normals_out) {
  std::memset(normals_out, 0, 3 * n_verts * sizeof(float));
  for (int i = 0; i < n_tris; ++i) {
    const float* a = verts + 3 * tris[3 * i];
    const float* b = verts + 3 * tris[3 * i + 1];
    const float* c = verts + 3 * tris[3 * i + 2];
    float u[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    float v[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    float n[3] = {u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                  u[0] * v[1] - u[1] * v[0]};  // area-weighted
    for (int k = 0; k < 3; ++k) {
      float* dst = normals_out + 3 * tris[3 * i + k];
      for (int a2 = 0; a2 < 3; ++a2) dst[a2] += n[a2];
    }
  }
  for (int v = 0; v < n_verts; ++v) {
    float* n = normals_out + 3 * v;
    float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len > 1e-20f)
      for (int a = 0; a < 3; ++a) n[a] /= len;
  }
}

// ---- KD-tree queries --------------------------------------------------------

void esn_point_cloud_distance(const float* src, int n_src, const float* dst,
                              int n_dst, float* out_dists) {
  KDTree tree;
  tree.build(dst, n_dst);
  for (int i = 0; i < n_src; ++i) {
    float best = 1e30f;
    tree.nearest(src + 3 * i, 0, &best);
    out_dists[i] = std::sqrt(best);
  }
}

// Mean distance to the nearest OTHER point (Open3D
// compute_nearest_neighbor_distance equivalent; used by preprocessing to set
// the outlier-removal radius, data/endonerf/preprocess.py:79-80).
void esn_nn_distance_excl_self(const float* pts, int n_pts,
                               float* out_dists) {
  KDTree tree;
  tree.build(pts, n_pts);
  for (int i = 0; i < n_pts; ++i) {
    float best1 = 1e30f, best2 = 1e30f;
    tree.nearest2(pts + 3 * i, 0, &best1, &best2);
    // best1 is the self-distance (0); best2 the true neighbor.
    out_dists[i] = std::sqrt(best1 > 1e-24f ? best1 : best2);
  }
}

// ---- software rasterizer ------------------------------------------------------
// Z-buffer triangle rasterization with barycentric color interpolation.
// Screen-space inputs: verts = [n_verts, 3] (x_pix, y_pix, depth), colors =
// [n_verts, 3] in [0,1]. Replaces the reference's Open3D offscreen mesh
// screenshots (trainer/utils.py:280-311) for demo videos.
void esn_rasterize_mesh(const float* verts, int n_verts, const float* colors,
                        const int32_t* tris, int n_tris, int width,
                        int height, float* rgb_out /* h*w*3, prefilled bg */,
                        float* z_out /* h*w, prefilled +inf */) {
  (void)n_verts;
  for (int i = 0; i < n_tris; ++i) {
    const float* a = verts + 3 * tris[3 * i];
    const float* b = verts + 3 * tris[3 * i + 1];
    const float* c = verts + 3 * tris[3 * i + 2];
    // Back/offscreen culling by bbox.
    float xmin = std::min({a[0], b[0], c[0]});
    float xmax = std::max({a[0], b[0], c[0]});
    float ymin = std::min({a[1], b[1], c[1]});
    float ymax = std::max({a[1], b[1], c[1]});
    int x0 = std::max(0, (int)std::floor(xmin));
    int x1 = std::min(width - 1, (int)std::ceil(xmax));
    int y0 = std::max(0, (int)std::floor(ymin));
    int y1 = std::min(height - 1, (int)std::ceil(ymax));
    if (x0 > x1 || y0 > y1) continue;
    float denom = (b[1] - c[1]) * (a[0] - c[0])
                  + (c[0] - b[0]) * (a[1] - c[1]);
    if (std::fabs(denom) < 1e-12f) continue;
    const float* ca = colors + 3 * tris[3 * i];
    const float* cb = colors + 3 * tris[3 * i + 1];
    const float* cc = colors + 3 * tris[3 * i + 2];
    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        float px = x + 0.5f, py = y + 0.5f;
        float w0 = ((b[1] - c[1]) * (px - c[0])
                    + (c[0] - b[0]) * (py - c[1])) / denom;
        float w1 = ((c[1] - a[1]) * (px - c[0])
                    + (a[0] - c[0]) * (py - c[1])) / denom;
        float w2 = 1.f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        float z = w0 * a[2] + w1 * b[2] + w2 * c[2];
        float* zp = z_out + y * width + x;
        if (z >= *zp || z <= 0) continue;
        *zp = z;
        float* px_out = rgb_out + 3 * (y * width + x);
        for (int k = 0; k < 3; ++k)
          px_out[k] = w0 * ca[k] + w1 * cb[k] + w2 * cc[k];
      }
    }
  }
}

// ---- categorical sampling --------------------------------------------------

// Walker/Vose alias table over `n` non-negative weights. After this, drawing
//   j ~ Uniform{0..n-1}, u ~ Uniform[0,1),  pick j if u < prob[j] else
//   alias[j]
// is EXACTLY the categorical distribution w / sum(w). Replaces the jit-side
// log2(n)-round binary search over the pixel-importance CDF (the reference
// samples the same distribution with torch.multinomial at dataset.py:134)
// with two O(1) gathers per draw; this O(n) build runs once per scene on the
// host. Accumulation in double so 3e5-entry pixel maps do not drift.
void esn_alias_table(const float* w, int n, float* prob_out,
                     int32_t* alias_out) {
  double sum = 0.0;
  for (int i = 0; i < n; ++i) sum += w[i] > 0.f ? (double)w[i] : 0.0;
  if (!(sum > 0.0)) {  // degenerate: uniform fallback
    for (int i = 0; i < n; ++i) { prob_out[i] = 1.f; alias_out[i] = i; }
    return;
  }
  std::vector<double> p(n);
  std::vector<int32_t> small, large;
  small.reserve(n); large.reserve(n);
  for (int i = 0; i < n; ++i) {
    p[i] = (w[i] > 0.f ? (double)w[i] : 0.0) / sum * n;
    (p[i] < 1.0 ? small : large).push_back(i);
  }
  while (!small.empty() && !large.empty()) {
    int s = small.back(); small.pop_back();
    int l = large.back(); large.pop_back();
    prob_out[s] = (float)p[s];
    alias_out[s] = l;
    p[l] = (p[l] + p[s]) - 1.0;
    (p[l] < 1.0 ? small : large).push_back(l);
  }
  // Leftovers are 1 up to rounding: self-alias with certain acceptance.
  for (auto& stack : {small, large})
    for (int i : stack) { prob_out[i] = 1.f; alias_out[i] = i; }
}

void esn_radius_outlier_mask(const float* pts, int n_pts, int min_neighbors,
                             float radius, uint8_t* keep_out) {
  KDTree tree;
  tree.build(pts, n_pts);
  float r2 = radius * radius;
  // min_neighbors + 1: a point always finds itself.
  int need = min_neighbors + 1;
  for (int i = 0; i < n_pts; ++i)
    keep_out[i] = tree.count_within(pts + 3 * i, 0, r2, need) >= need ? 1 : 0;
}

}  // extern "C"
