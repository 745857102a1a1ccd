// Native SBVH builder + flattener for tpu_rt_torch: the port's own copy of
// tpu_rt/native/sbvh.cc, code unchanged, so that both packages build
// bit-identical trees (tests/test_torch_host.py holds them so).
//
// C++ implementation of the same split-BVH algorithm as
// tpu_rt_torch/bvh/builder.py (the numpy version is the semantic definition;
// behavioral spec follows the reference SplitBVHBuilder,
// src/rt/bvh/SplitBVHBuilder.cc — object sweep splits, 128-bin spatial
// splits with enter/exit counts and unsplit/duplicate arbitration, spatial
// gate on child overlap area, degenerate culling), producing the flattened
// Compact2-equivalent arrays (tpu_rt/bvh/flatten.py layout: 16 floats per
// node, Woop rows, explicit leaf counts) in one call.
//
// Exposed via a C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr float kMaxF = std::numeric_limits<float>::max();

struct Vec3 {
  float x = 0, y = 0, z = 0;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
  float& at(int i) { return i == 0 ? x : (i == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline Vec3 vsub(const Vec3& a, const Vec3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(const Vec3& a, const Vec3& b) {
  return (double)a.x * b.x + (double)a.y * b.y + (double)a.z * b.z;
}

struct AABB {
  Vec3 lo{kInf, kInf, kInf};
  Vec3 hi{-kInf, -kInf, -kInf};
  void grow(const Vec3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
  void grow(const AABB& b) { lo = vmin(lo, b.lo); hi = vmax(hi, b.hi); }
  void intersect(const AABB& b) { lo = vmax(lo, b.lo); hi = vmin(hi, b.hi); }
  bool valid() const { return lo.x <= hi.x && lo.y <= hi.y && lo.z <= hi.z; }
  float area() const {
    if (!valid()) return 0.0f;
    float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
    return 2.0f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Reference {
  int tri = -1;
  AABB bounds;
};

struct Params {
  float split_alpha = 1e-5f;
  int min_leaf = 1, max_leaf = 8;
  float tri_cost = 1.0f, node_cost = 1.0f;
  int max_depth = 64, max_spatial_depth = 48, num_bins = 128;
};

struct Node {
  AABB bounds;
  int left = -1, right = -1;  // indices into node pool; -1 -> leaf
  int lo = 0, hi = 0;         // leaf range into tri_out
};

struct Builder {
  const int* tri_vtx;
  const float* vtx;
  int num_tris;
  Params p;

  std::vector<Reference> refs;      // reference stack
  std::vector<Node> nodes;          // node pool
  std::vector<int> tri_out;         // leaf triangle stream
  long long num_duplicates = 0;
  float min_overlap = 0.0f;

  std::vector<AABB> right_bounds;   // sweep scratch
  // spatial bins
  struct Bin { AABB bounds; int enter = 0, exit = 0; };
  std::vector<Bin> bins;            // [3][num_bins]

  Vec3 vert(int vi) const { return {vtx[3 * vi], vtx[3 * vi + 1], vtx[3 * vi + 2]}; }

  int run() {
    refs.resize(num_tris);
    AABB root_bounds;
    for (int i = 0; i < num_tris; i++) {
      refs[i].tri = i;
      for (int j = 0; j < 3; j++) refs[i].bounds.grow(vert(tri_vtx[3 * i + j]));
      root_bounds.grow(refs[i].bounds);
    }
    min_overlap = root_bounds.area() * p.split_alpha;
    right_bounds.resize(std::max(num_tris, p.num_bins));
    bins.resize(3 * p.num_bins);
    nodes.reserve(num_tris * 2 + 16);
    if (num_tris == 0) {
      nodes.push_back(Node{});
      return 0;
    }
    return build_node((int)refs.size(), root_bounds, 0);
  }

  int make_leaf(int num_ref, const AABB& bounds) {
    Node n;
    n.bounds = bounds;
    n.lo = (int)tri_out.size();
    for (int i = 0; i < num_ref; i++) {
      tri_out.push_back(refs.back().tri);
      refs.pop_back();
    }
    n.hi = (int)tri_out.size();
    nodes.push_back(n);
    return (int)nodes.size() - 1;
  }

  struct ObjectSplit {
    float sah = kMaxF;
    int dim = 0, num_left = 0;
    AABB left_b, right_b;
    double tie = std::numeric_limits<double>::max();
    bool found = false;
  };

  struct SpatialSplit {
    float sah = kMaxF;
    int dim = 0;
    float pos = 0;
    bool found = false;
  };

  static bool ref_less(const Reference& a, const Reference& b, int dim) {
    float ca = a.bounds.lo[dim] + a.bounds.hi[dim];
    float cb = b.bounds.lo[dim] + b.bounds.hi[dim];
    return ca < cb || (ca == cb && a.tri < b.tri);
  }

  float tri_cost(int n) const { return (float)n * p.tri_cost; }

  ObjectSplit find_object_split(int num_ref, float node_sah) {
    ObjectSplit best;
    Reference* base = refs.data() + refs.size() - num_ref;
    for (int dim = 0; dim < 3; dim++) {
      std::sort(base, base + num_ref,
                [dim](const Reference& a, const Reference& b) { return ref_less(a, b, dim); });
      AABB rb;
      for (int i = num_ref - 1; i > 0; i--) {
        rb.grow(base[i].bounds);
        right_bounds[i - 1] = rb;
      }
      AABB lb;
      for (int i = 1; i < num_ref; i++) {
        lb.grow(base[i - 1].bounds);
        float sah = node_sah + lb.area() * tri_cost(i) +
                    right_bounds[i - 1].area() * tri_cost(num_ref - i);
        double tie = (double)i * i + (double)(num_ref - i) * (num_ref - i);
        if (sah < best.sah || (sah == best.sah && tie < best.tie)) {
          best.sah = sah;
          best.tie = tie;
          best.dim = dim;
          best.num_left = i;
          best.left_b = lb;
          best.right_b = right_bounds[i - 1];
          best.found = true;
        }
      }
    }
    return best;
  }

  // Clip triangle `tri` to the slab [lo_pos, hi_pos] along dim (each side
  // optional), intersect with ref bounds.  Same algebra as the reference's
  // splitReference/iterative chop (see tpu_rt/bvh/builder.py for the
  // equivalence argument).
  AABB clip_to_slab(int tri, const AABB& ref_b, int dim, float lo_pos, bool clip_lo,
                    float hi_pos, bool clip_hi) const {
    Vec3 v[3] = {vert(tri_vtx[3 * tri]), vert(tri_vtx[3 * tri + 1]), vert(tri_vtx[3 * tri + 2])};
    AABB out;
    for (int k = 0; k < 3; k++) {
      float c = v[k][dim];
      bool inside = true;
      if (clip_lo && c < lo_pos) inside = false;
      if (clip_hi && c > hi_pos) inside = false;
      if (inside) out.grow(v[k]);
    }
    const int edges[3][2] = {{2, 0}, {0, 1}, {1, 2}};
    for (auto& e : edges) {
      const Vec3 &a = v[e[0]], &b = v[e[1]];
      float ca = a[dim], cb = b[dim];
      for (int side = 0; side < 2; side++) {
        bool enabled = side == 0 ? clip_lo : clip_hi;
        float pos = side == 0 ? lo_pos : hi_pos;
        if (!enabled) continue;
        if ((ca < pos && cb > pos) || (ca > pos && cb < pos)) {
          float t = (pos - ca) / (cb - ca);
          t = std::min(1.0f, std::max(0.0f, t));
          Vec3 pt = {a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t, a.z + (b.z - a.z) * t};
          out.grow(pt);
        }
      }
    }
    if (clip_lo) out.lo.at(dim) = lo_pos;
    if (clip_hi) out.hi.at(dim) = hi_pos;
    out.intersect(ref_b);
    return out;
  }

  SpatialSplit find_spatial_split(int num_ref, float node_sah, const AABB& node_b) {
    SpatialSplit best;
    const int nb = p.num_bins;
    Vec3 origin = node_b.lo;
    Vec3 size = vsub(node_b.hi, node_b.lo);
    Vec3 bin_size = {size.x / nb, size.y / nb, size.z / nb};

    for (auto& b : bins) b = Bin{};

    Reference* base = refs.data() + refs.size() - num_ref;
    for (int dim = 0; dim < 3; dim++) {
      if (bin_size[dim] <= 0) continue;
      float inv = 1.0f / bin_size[dim];
      Bin* db = bins.data() + dim * nb;
      for (int i = 0; i < num_ref; i++) {
        const Reference& r = base[i];
        int first = std::min(nb - 1, std::max(0, (int)((r.bounds.lo[dim] - origin[dim]) * inv)));
        int last = std::min(nb - 1, std::max(first, (int)((r.bounds.hi[dim] - origin[dim]) * inv)));
        if (first == last) {
          db[first].bounds.grow(r.bounds);
        } else {
          for (int bin = first; bin <= last; bin++) {
            float lo_pos = origin[dim] + bin_size[dim] * bin;
            float hi_pos = origin[dim] + bin_size[dim] * (bin + 1);
            db[bin].bounds.grow(clip_to_slab(r.tri, r.bounds, dim, lo_pos, bin > first,
                                             hi_pos, bin < last));
          }
        }
        db[first].enter++;
        db[last].exit++;
      }

      AABB rb;
      for (int i = nb - 1; i > 0; i--) {
        rb.grow(db[i].bounds);
        right_bounds[i - 1] = rb;
      }
      AABB lb;
      int left_num = 0, right_num = num_ref;
      for (int i = 1; i < nb; i++) {
        lb.grow(db[i - 1].bounds);
        left_num += db[i - 1].enter;
        right_num -= db[i - 1].exit;
        float sah = node_sah + lb.area() * tri_cost(left_num) +
                    right_bounds[i - 1].area() * tri_cost(right_num);
        if (sah < best.sah) {
          best.sah = sah;
          best.dim = dim;
          best.pos = origin[dim] + bin_size[dim] * i;
          best.found = true;
        }
      }
    }
    return best;
  }

  // Returns (n_left, left_bounds, n_right, right_bounds); refs reordered so
  // the right child's refs are on top of the stack.
  struct SplitResult {
    int n_left = 0, n_right = 0;
    AABB left_b, right_b;
  };

  SplitResult perform_object_split(int num_ref, const ObjectSplit& s) {
    Reference* base = refs.data() + refs.size() - num_ref;
    int dim = s.dim;
    std::sort(base, base + num_ref,
              [dim](const Reference& a, const Reference& b) { return ref_less(a, b, dim); });
    SplitResult r;
    r.n_left = s.num_left;
    r.n_right = num_ref - s.num_left;
    r.left_b = s.left_b;
    r.right_b = s.right_b;
    return r;
  }

  SplitResult perform_spatial_split(int num_ref, const SpatialSplit& s) {
    // Stable partition into left / straddle / right (preserving scan order
    // within each class; see builder.py note on the deliberate deviation
    // from the reference's swap ordering).
    size_t start = refs.size() - num_ref;
    std::vector<Reference> lefts, rights, mids;
    lefts.reserve(num_ref);
    rights.reserve(num_ref);
    AABB lb, rb;
    for (size_t i = start; i < refs.size(); i++) {
      const Reference& r = refs[i];
      if (r.bounds.hi[s.dim] <= s.pos) {
        lb.grow(r.bounds);
        lefts.push_back(r);
      } else if (r.bounds.lo[s.dim] >= s.pos) {
        rb.grow(r.bounds);
        rights.push_back(r);
      } else {
        mids.push_back(r);
      }
    }

    for (const Reference& r : mids) {
      AABB sl = clip_to_slab(r.tri, r.bounds, s.dim, 0, false, s.pos, true);
      AABB sr = clip_to_slab(r.tri, r.bounds, s.dim, s.pos, true, 0, false);

      AABB lub = lb; lub.grow(r.bounds);
      AABB rub = rb; rub.grow(r.bounds);
      AABB ldb = lb; ldb.grow(sl);
      AABB rdb = rb; rdb.grow(sr);

      float lac = tri_cost((int)lefts.size());
      float rac = tri_cost((int)rights.size());
      float lbc = tri_cost((int)lefts.size() + 1);
      float rbc = tri_cost((int)rights.size() + 1);

      float unsplit_l = lub.area() * lbc + rb.area() * rac;
      float unsplit_r = lb.area() * lac + rub.area() * rbc;
      float duplicate = ldb.area() * lbc + rdb.area() * rbc;
      float m = std::min(unsplit_l, std::min(unsplit_r, duplicate));

      if (m == unsplit_l) {
        lb = lub;
        lefts.push_back(r);
      } else if (m == unsplit_r) {
        rb = rub;
        rights.push_back(r);
      } else {
        lb = ldb;
        rb = rdb;
        Reference rl = r; rl.bounds = sl;
        Reference rr = r; rr.bounds = sr;
        lefts.push_back(rl);
        rights.push_back(rr);
      }
    }

    refs.resize(start);
    refs.insert(refs.end(), lefts.begin(), lefts.end());
    refs.insert(refs.end(), rights.begin(), rights.end());

    SplitResult out;
    out.n_left = (int)lefts.size();
    out.n_right = (int)rights.size();
    out.left_b = lb;
    out.right_b = rb;
    return out;
  }

  int build_node(int num_ref, AABB bounds, int level) {
    // Degenerate culling (keeps scan order; removeSwap order is irrelevant).
    {
      size_t start = refs.size() - num_ref;
      size_t w = start;
      for (size_t i = start; i < refs.size(); i++) {
        Vec3 sz = vsub(refs[i].bounds.hi, refs[i].bounds.lo);
        float mn = std::min(sz.x, std::min(sz.y, sz.z));
        float mx = std::max(sz.x, std::max(sz.y, sz.z));
        float sum = sz.x + sz.y + sz.z;
        if (!(mn < 0.0f || sum == mx)) refs[w++] = refs[i];
      }
      refs.resize(w);
      num_ref = (int)(refs.size() - start);
    }

    if (num_ref <= p.min_leaf || level >= p.max_depth) return make_leaf(num_ref, bounds);

    float area = bounds.area();
    float leaf_sah = area * tri_cost(num_ref);
    float node_sah = area * 2.0f * p.node_cost;

    ObjectSplit obj = find_object_split(num_ref, node_sah);

    SpatialSplit spatial;
    if (level < p.max_spatial_depth && obj.found) {
      AABB overlap = obj.left_b;
      overlap.intersect(obj.right_b);
      if (overlap.area() >= min_overlap) spatial = find_spatial_split(num_ref, node_sah, bounds);
    }

    float obj_sah = obj.found ? obj.sah : kMaxF;
    float spa_sah = spatial.found ? spatial.sah : kMaxF;
    float min_sah = std::min(leaf_sah, std::min(obj_sah, spa_sah));
    if (min_sah == leaf_sah && num_ref <= p.max_leaf) return make_leaf(num_ref, bounds);

    SplitResult sr;
    bool have = false;
    if (spatial.found && min_sah == spa_sah) {
      sr = perform_spatial_split(num_ref, spatial);
      have = sr.n_left > 0 && sr.n_right > 0;
      if (!have) num_ref = sr.n_left + sr.n_right;
    }
    if (!have) sr = perform_object_split(num_ref, obj);

    num_duplicates += sr.n_left + sr.n_right - num_ref;

    // Right child refs are on top: build right first.
    int right = build_node(sr.n_right, sr.right_b, level + 1);
    int left = build_node(sr.n_left, sr.left_b, level + 1);
    Node n;
    n.bounds = bounds;
    n.left = left;
    n.right = right;
    nodes.push_back(n);
    return (int)nodes.size() - 1;
  }
};

// ---------------------------------------------------------------------------
// Flatten to the FlatBVH layout (matches tpu_rt/bvh/flatten.py).
// ---------------------------------------------------------------------------

struct FlatOut {
  std::vector<float> node_rows;   // [n*16]
  std::vector<float> woop;        // [m*12]
  std::vector<int> tri_index;     // [m]
  std::vector<int> leaf_counts;   // [m+1]
};

void woopify_one(const int* tri_vtx, const float* vtx, int tri, float* out12) {
  auto V = [&](int corner) -> Vec3 {
    int vi = tri_vtx[3 * tri + corner];
    return {vtx[3 * vi], vtx[3 * vi + 1], vtx[3 * vi + 2]};
  };
  Vec3 v0 = V(0), v1 = V(1), v2 = V(2);
  Vec3 e1 = vsub(v0, v2), e2 = vsub(v1, v2);
  Vec3 n = cross(e1, e2);
  // A = [e1 | e2 | n]; inverse via adjugate / det (det = |n|^2).
  double a[3][3] = {{e1.x, e2.x, n.x}, {e1.y, e2.y, n.y}, {e1.z, e2.z, n.z}};
  double det = dot(n, n);
  double c[3][3];
  c[0][0] = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  c[0][1] = a[0][2] * a[2][1] - a[0][1] * a[2][2];
  c[0][2] = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  c[1][0] = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  c[1][1] = a[0][0] * a[2][2] - a[0][2] * a[2][0];
  c[1][2] = a[0][2] * a[1][0] - a[0][0] * a[1][2];
  c[2][0] = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  c[2][1] = a[0][1] * a[2][0] - a[0][0] * a[2][1];
  c[2][2] = a[0][0] * a[1][1] - a[0][1] * a[1][0];
  double inv[3][3], t[3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) inv[i][j] = c[i][j] / det;
  for (int i = 0; i < 3; i++)
    t[i] = -(inv[i][0] * v2.x + inv[i][1] * v2.y + inv[i][2] * v2.z);
  out12[0] = (float)inv[2][0]; out12[1] = (float)inv[2][1]; out12[2] = (float)inv[2][2];
  out12[3] = (float)-t[2];
  out12[4] = (float)inv[0][0]; out12[5] = (float)inv[0][1]; out12[6] = (float)inv[0][2];
  out12[7] = (float)t[0];
  out12[8] = (float)inv[1][0]; out12[9] = (float)inv[1][1]; out12[10] = (float)inv[1][2];
  out12[11] = (float)t[1];
}

void flatten(const Builder& b, int root, FlatOut& out) {
  const auto& nodes = b.nodes;
  const auto& tri_stream = b.tri_out;

  auto is_leaf = [&](int i) { return nodes[i].left < 0; };

  if (is_leaf(root)) {
    // Single-leaf scene: synthesized root (see flatten.py).
    int n_tris = nodes[root].hi - nodes[root].lo;
    out.node_rows.assign(16, 0.0f);
    const AABB& bb = nodes[root].bounds;
    float* r = out.node_rows.data();
    r[0] = bb.lo.x; r[1] = bb.hi.x; r[2] = bb.lo.y; r[3] = bb.hi.y;
    r[4] = 0; r[5] = -1; r[6] = 0; r[7] = -1;
    r[8] = bb.lo.z; r[9] = bb.hi.z; r[10] = 0; r[11] = -1;
    int links[4] = {~0, ~n_tris, n_tris, 0};
    std::memcpy(r + 12, links, 16);
    out.tri_index.assign(tri_stream.begin() + nodes[root].lo, tri_stream.begin() + nodes[root].hi);
    out.woop.resize((size_t)n_tris * 12);
    for (int i = 0; i < n_tris; i++)
      woopify_one(b.tri_vtx, b.vtx, out.tri_index[i], out.woop.data() + (size_t)i * 12);
    out.leaf_counts.assign(n_tris + 1, 0);
    out.leaf_counts[0] = n_tris;
    return;
  }

  std::vector<std::pair<int, int>> stack;  // (node, row)
  out.node_rows.assign(16, 0.0f);
  stack.push_back({root, 0});
  while (!stack.empty()) {
    auto [ni, row] = stack.back();
    stack.pop_back();
    int links[4] = {0, 0, 0, 0};
    float boxes[12] = {0};
    int children[2] = {nodes[ni].left, nodes[ni].right};
    for (int i = 0; i < 2; i++) {
      const Node& ch = nodes[children[i]];
      if (i == 0) {
        boxes[0] = ch.bounds.lo.x; boxes[1] = ch.bounds.hi.x;
        boxes[2] = ch.bounds.lo.y; boxes[3] = ch.bounds.hi.y;
        boxes[8] = ch.bounds.lo.z; boxes[9] = ch.bounds.hi.z;
      } else {
        boxes[4] = ch.bounds.lo.x; boxes[5] = ch.bounds.hi.x;
        boxes[6] = ch.bounds.lo.y; boxes[7] = ch.bounds.hi.y;
        boxes[10] = ch.bounds.lo.z; boxes[11] = ch.bounds.hi.z;
      }
      if (ch.left >= 0) {
        links[i] = (int)(out.node_rows.size() / 16);
        out.node_rows.resize(out.node_rows.size() + 16, 0.0f);
        stack.push_back({children[i], links[i]});
      } else {
        int first = (int)out.tri_index.size();
        int count = ch.hi - ch.lo;
        links[i] = ~first;
        links[2 + i] = count;
        for (int k = ch.lo; k < ch.hi; k++) out.tri_index.push_back(tri_stream[k]);
      }
    }
    float* r = out.node_rows.data() + (size_t)row * 16;
    std::memcpy(r, boxes, sizeof(boxes));
    std::memcpy(r + 12, links, sizeof(links));
  }

  size_t m = out.tri_index.size();
  out.woop.resize(m * 12);
  for (size_t i = 0; i < m; i++)
    woopify_one(b.tri_vtx, b.vtx, out.tri_index[i], out.woop.data() + i * 12);

  out.leaf_counts.assign(m + 1, 0);
  size_t n_nodes = out.node_rows.size() / 16;
  for (size_t i = 0; i < n_nodes; i++) {
    const float* r = out.node_rows.data() + i * 16;
    int links[4];
    std::memcpy(links, r + 12, sizeof(links));
    for (int c = 0; c < 2; c++)
      if (links[c] < 0) out.leaf_counts[~links[c]] = links[2 + c];
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.  Output arrays are malloc'd; free with sbvh_free.
int sbvh_build(const int* tri_vtx, int num_tris, const float* vtx_pos, int num_verts,
               float split_alpha, int min_leaf, int max_leaf, float tri_cost,
               float node_cost, int max_depth, int max_spatial_depth, int num_bins,
               float** nodes_out, long long* num_nodes, float** woop_out,
               long long* num_refs, int** tri_index_out, int** leaf_counts_out,
               long long* num_duplicates, double* sah_cost) {
  (void)num_verts;
  Builder b;
  b.tri_vtx = tri_vtx;
  b.vtx = vtx_pos;
  b.num_tris = num_tris;
  b.p.split_alpha = split_alpha;
  b.p.min_leaf = min_leaf;
  b.p.max_leaf = max_leaf;
  b.p.tri_cost = tri_cost;
  b.p.node_cost = node_cost;
  b.p.max_depth = max_depth;
  b.p.max_spatial_depth = max_spatial_depth;
  b.p.num_bins = num_bins;

  int root = b.run();

  FlatOut out;
  flatten(b, root, out);

  // SAH of the finished tree (matches builder.py _compute_sah_cost).
  double cost = 0.0;
  {
    float root_area = std::max(b.nodes[root].bounds.area(), 1e-30f);
    std::vector<std::pair<int, double>> st{{root, 1.0}};
    while (!st.empty()) {
      auto [ni, prob] = st.back();
      st.pop_back();
      const Node& n = b.nodes[ni];
      if (n.left < 0) {
        cost += prob * (double)(n.hi - n.lo) * b.p.tri_cost;
      } else {
        cost += prob * 2.0 * b.p.node_cost;
        for (int c : {n.left, n.right})
          st.push_back({c, prob * (b.nodes[c].bounds.area() / root_area)});
      }
    }
  }

  *num_nodes = (long long)(out.node_rows.size() / 16);
  *num_refs = (long long)out.tri_index.size();
  *num_duplicates = b.num_duplicates;
  *sah_cost = cost;

  *nodes_out = (float*)std::malloc(out.node_rows.size() * sizeof(float));
  *woop_out = (float*)std::malloc(out.woop.size() * sizeof(float));
  *tri_index_out = (int*)std::malloc(std::max<size_t>(1, out.tri_index.size()) * sizeof(int));
  *leaf_counts_out = (int*)std::malloc(out.leaf_counts.size() * sizeof(int));
  if (!*nodes_out || !*woop_out || !*tri_index_out || !*leaf_counts_out) return 1;
  std::memcpy(*nodes_out, out.node_rows.data(), out.node_rows.size() * sizeof(float));
  std::memcpy(*woop_out, out.woop.data(), out.woop.size() * sizeof(float));
  std::memcpy(*tri_index_out, out.tri_index.data(), out.tri_index.size() * sizeof(int));
  std::memcpy(*leaf_counts_out, out.leaf_counts.data(), out.leaf_counts.size() * sizeof(int));
  return 0;
}

void sbvh_free(void* p) { std::free(p); }

}  // extern "C"
