// Native host-side geometry kernels for the offline pipeline.
//
// TPU-native replacement of the reference's Open3D C++ components
// (match_splat.py:206-227 registration_icp / :240-251 RaycastingScene —
// SURVEY.md N8/N9): a 3-D KD-tree for ICP nearest-neighbour
// correspondences and a triangle BVH for point-to-mesh distance and
// ray-parity occupancy queries.  Exposed through a plain C ABI consumed
// via ctypes (sim_a_splat_torch/native.py); the Python layer keeps
// a pure-numpy fallback so the framework runs even where no compiler
// exists.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread geometry.cpp -o _geom.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <numeric>
#include <thread>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

inline void parallel_for(int64_t n, int64_t grain,
                         const std::function<void(int64_t, int64_t)> &body) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1,
                                                      (n + grain - 1) / grain));
  if (nt == 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(body, lo, hi);
  }
  for (auto &t : ts) t.join();
}

// ------------------------------ KD-tree ------------------------------

struct KDTree {
  // flat median-split tree over 3-D points; leaves hold up to kLeaf ids
  static constexpr int kLeaf = 16;
  struct Node {
    double split;
    int32_t axis;      // -1 ⇒ leaf
    int32_t left, right;   // children, or [begin, end) into ids for leaves
  };
  std::vector<double> pts;   // (n, 3) copy, original order
  std::vector<int64_t> ids;  // permutation, leaves index into this
  std::vector<Node> nodes;

  int32_t build(int64_t lo, int64_t hi) {
    int32_t me = (int32_t)nodes.size();
    nodes.push_back({});
    if (hi - lo <= kLeaf) {
      nodes[me] = {0.0, -1, (int32_t)lo, (int32_t)hi};
      return me;
    }
    double mins[3] = {kInf, kInf, kInf}, maxs[3] = {-kInf, -kInf, -kInf};
    for (int64_t i = lo; i < hi; ++i)
      for (int a = 0; a < 3; ++a) {
        double v = pts[ids[i] * 3 + a];
        mins[a] = std::min(mins[a], v);
        maxs[a] = std::max(maxs[a], v);
      }
    int axis = 0;
    for (int a = 1; a < 3; ++a)
      if (maxs[a] - mins[a] > maxs[axis] - mins[axis]) axis = a;
    int64_t mid = (lo + hi) / 2;
    std::nth_element(ids.begin() + lo, ids.begin() + mid, ids.begin() + hi,
                     [&](int64_t x, int64_t y) {
                       return pts[x * 3 + axis] < pts[y * 3 + axis];
                     });
    double split = pts[ids[mid] * 3 + axis];
    int32_t l = build(lo, mid);
    int32_t r = build(mid, hi);
    nodes[me] = {split, (int32_t)axis, l, r};
    return me;
  }

  void query1(const double *q, int64_t *best_id, double *best_d2) const {
    *best_d2 = kInf;
    *best_id = -1;
    // explicit stack of (node, min possible squared dist along split planes)
    struct Item { int32_t node; double d2; };
    Item stack[128];
    int sp = 0;
    stack[sp++] = {0, 0.0};
    while (sp) {
      Item it = stack[--sp];
      if (it.d2 >= *best_d2) continue;
      const Node &n = nodes[it.node];
      if (n.axis < 0) {
        for (int32_t i = n.left; i < n.right; ++i) {
          const double *p = &pts[ids[i] * 3];
          double dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
          double d2 = dx * dx + dy * dy + dz * dz;
          if (d2 < *best_d2) { *best_d2 = d2; *best_id = ids[i]; }
        }
        continue;
      }
      double delta = q[n.axis] - n.split;
      int32_t near = delta <= 0 ? n.left : n.right;
      int32_t far = delta <= 0 ? n.right : n.left;
      stack[sp++] = {far, it.d2 + delta * delta};   // lower bound via plane
      stack[sp++] = {near, it.d2};
    }
  }
};

// ------------------------- triangle BVH ------------------------------

struct AABB {
  double lo[3] = {kInf, kInf, kInf}, hi[3] = {-kInf, -kInf, -kInf};
  void grow(const double *p) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], p[a]);
      hi[a] = std::max(hi[a], p[a]);
    }
  }
  void grow(const AABB &o) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], o.lo[a]);
      hi[a] = std::max(hi[a], o.hi[a]);
    }
  }
  double dist2(const double *p) const {
    double d2 = 0;
    for (int a = 0; a < 3; ++a) {
      double d = std::max({lo[a] - p[a], 0.0, p[a] - hi[a]});
      d2 += d * d;
    }
    return d2;
  }
  // does the +z ray from p possibly hit the box?
  bool hit_up(const double *p) const {
    return p[0] >= lo[0] && p[0] <= hi[0] && p[1] >= lo[1] &&
           p[1] <= hi[1] && hi[2] >= p[2];
  }
};

// Ericson, Real-Time Collision Detection §5.1.5 — closest point on triangle
inline double point_tri_d2(const double *p, const double *a, const double *b,
                           const double *c) {
  double ab[3], ac[3], ap[3];
  for (int k = 0; k < 3; ++k) {
    ab[k] = b[k] - a[k];
    ac[k] = c[k] - a[k];
    ap[k] = p[k] - a[k];
  }
  auto dot = [](const double *u, const double *v) {
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
  };
  double d1 = dot(ab, ap), d2 = dot(ac, ap);
  double cl[3];
  if (d1 <= 0 && d2 <= 0) { std::memcpy(cl, a, 24); goto done; }
  {
    double bp[3] = {p[0] - b[0], p[1] - b[1], p[2] - b[2]};
    double d3 = dot(ab, bp), d4 = dot(ac, bp);
    if (d3 >= 0 && d4 <= d3) { std::memcpy(cl, b, 24); goto done; }
    double vc = d1 * d4 - d3 * d2;
    if (vc <= 0 && d1 >= 0 && d3 <= 0) {
      double v = d1 / (d1 - d3);
      for (int k = 0; k < 3; ++k) cl[k] = a[k] + v * ab[k];
      goto done;
    }
    double cp[3] = {p[0] - c[0], p[1] - c[1], p[2] - c[2]};
    double d5 = dot(ab, cp), d6 = dot(ac, cp);
    if (d6 >= 0 && d5 <= d6) { std::memcpy(cl, c, 24); goto done; }
    double vb = d5 * d2 - d1 * d6;
    if (vb <= 0 && d2 >= 0 && d6 <= 0) {
      double w = d2 / (d2 - d6);
      for (int k = 0; k < 3; ++k) cl[k] = a[k] + w * ac[k];
      goto done;
    }
    double va = d3 * d6 - d5 * d4;
    if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
      double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
      for (int k = 0; k < 3; ++k) cl[k] = b[k] + w * (c[k] - b[k]);
      goto done;
    }
    {
      double denom = 1.0 / (va + vb + vc);
      double v = vb * denom, w = vc * denom;
      for (int k = 0; k < 3; ++k) cl[k] = a[k] + ab[k] * v + ac[k] * w;
    }
  }
done:
  double dx = p[0] - cl[0], dy = p[1] - cl[1], dz = p[2] - cl[2];
  return dx * dx + dy * dy + dz * dz;
}

struct BVH {
  static constexpr int kLeaf = 4;
  struct Node {
    AABB box;
    int32_t left, right;  // children; leaf ⇔ left < 0, tris in [~left, right)
  };
  std::vector<double> verts;    // (nv, 3)
  std::vector<int64_t> faces;   // (nf, 3)
  std::vector<int32_t> order;   // tri permutation
  std::vector<Node> nodes;
  std::vector<double> centroids;

  const double *vert(int64_t f, int corner) const {
    return &verts[faces[f * 3 + corner] * 3];
  }

  int32_t build(int32_t lo, int32_t hi) {
    int32_t me = (int32_t)nodes.size();
    nodes.push_back({});
    AABB box;
    for (int32_t i = lo; i < hi; ++i)
      for (int c = 0; c < 3; ++c) box.grow(vert(order[i], c));
    nodes[me].box = box;
    if (hi - lo <= kLeaf) {
      nodes[me].left = ~lo;
      nodes[me].right = hi;
      return me;
    }
    AABB cbox;
    for (int32_t i = lo; i < hi; ++i) cbox.grow(&centroids[order[i] * 3]);
    int axis = 0;
    for (int a = 1; a < 3; ++a)
      if (cbox.hi[a] - cbox.lo[a] > cbox.hi[axis] - cbox.lo[axis]) axis = a;
    int32_t mid = (lo + hi) / 2;
    std::nth_element(order.begin() + lo, order.begin() + mid,
                     order.begin() + hi, [&](int32_t x, int32_t y) {
                       return centroids[x * 3 + axis] <
                              centroids[y * 3 + axis];
                     });
    int32_t l = build(lo, mid);
    int32_t r = build(mid, hi);
    nodes[me].left = l;
    nodes[me].right = r;
    return me;
  }

  void distance1(const double *p, double *out_d, int64_t *out_tri) const {
    double best = kInf;
    int64_t best_tri = -1;
    struct Item { int32_t node; double d2; };
    Item stack[128];
    int sp = 0;
    stack[sp++] = {0, nodes[0].box.dist2(p)};
    while (sp) {
      Item it = stack[--sp];
      if (it.d2 >= best) continue;
      const Node &n = nodes[it.node];
      if (n.left < 0) {
        for (int32_t i = ~n.left; i < n.right; ++i) {
          int64_t f = order[i];
          double d2 = point_tri_d2(p, vert(f, 0), vert(f, 1), vert(f, 2));
          if (d2 < best) { best = d2; best_tri = f; }
        }
        continue;
      }
      double dl = nodes[n.left].box.dist2(p);
      double dr = nodes[n.right].box.dist2(p);
      // push farther first so nearer is processed next (better pruning)
      if (dl <= dr) {
        if (dr < best) stack[sp++] = {n.right, dr};
        if (dl < best) stack[sp++] = {n.left, dl};
      } else {
        if (dl < best) stack[sp++] = {n.left, dl};
        if (dr < best) stack[sp++] = {n.right, dr};
      }
    }
    *out_d = std::sqrt(best);
    *out_tri = best_tri;
  }

  // +z ray crossing parity (watertight assumption).  The caller nudges the
  // origin off exact edge alignments, same as the numpy fallback.
  bool occupancy1(const double *p0) const {
    double p[3] = {p0[0] + 1.2345678e-7, p0[1] + 2.3456789e-7, p0[2]};
    int64_t crossings = 0;
    int32_t stack[128];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      const Node &n = nodes[stack[--sp]];
      if (!n.box.hit_up(p)) continue;
      if (n.left < 0) {
        for (int32_t i = ~n.left; i < n.right; ++i) {
          int64_t f = order[i];
          const double *a = vert(f, 0), *b = vert(f, 1), *c = vert(f, 2);
          // 2-D containment in the xy projection
          double s1 = (a[0] - p[0]) * (b[1] - p[1]) -
                      (a[1] - p[1]) * (b[0] - p[0]);
          double s2 = (b[0] - p[0]) * (c[1] - p[1]) -
                      (b[1] - p[1]) * (c[0] - p[0]);
          double s3 = (c[0] - p[0]) * (a[1] - p[1]) -
                      (c[1] - p[1]) * (a[0] - p[0]);
          bool in2d = (s1 >= 0 && s2 >= 0 && s3 >= 0) ||
                      (s1 <= 0 && s2 <= 0 && s3 <= 0);
          if (!in2d) continue;
          double n0 = (b[1] - a[1]) * (c[2] - a[2]) -
                      (b[2] - a[2]) * (c[1] - a[1]);
          double n1 = (b[2] - a[2]) * (c[0] - a[0]) -
                      (b[0] - a[0]) * (c[2] - a[2]);
          double n2 = (b[0] - a[0]) * (c[1] - a[1]) -
                      (b[1] - a[1]) * (c[0] - a[0]);
          if (std::abs(n2) <= 1e-12) continue;
          double d = n0 * a[0] + n1 * a[1] + n2 * a[2];
          double zhit = (d - n0 * p[0] - n1 * p[1]) / n2;
          if (zhit > p[2] + 1e-12) ++crossings;
        }
        continue;
      }
      stack[sp++] = n.left;
      stack[sp++] = n.right;
    }
    return (crossings & 1) != 0;
  }
};

}  // namespace

extern "C" {

// --------------------------- KD-tree C ABI ---------------------------

void *sas_kd_build(const double *pts, int64_t n) {
  auto *t = new KDTree();
  t->pts.assign(pts, pts + n * 3);
  t->ids.resize(n);
  std::iota(t->ids.begin(), t->ids.end(), 0);
  t->nodes.reserve(2 * n / KDTree::kLeaf + 4);
  if (n > 0) t->build(0, n);
  return t;
}

void sas_kd_query(const void *tree, const double *q, int64_t m,
                  int64_t *out_idx, double *out_dist) {
  const auto *t = static_cast<const KDTree *>(tree);
  parallel_for(m, 1024, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double d2;
      t->query1(q + i * 3, &out_idx[i], &d2);
      out_dist[i] = std::sqrt(d2);
    }
  });
}

void sas_kd_free(void *tree) { delete static_cast<KDTree *>(tree); }

// ----------------------------- BVH C ABI -----------------------------

void *sas_bvh_build(const double *verts, int64_t nv, const int64_t *faces,
                    int64_t nf) {
  auto *b = new BVH();
  b->verts.assign(verts, verts + nv * 3);
  b->faces.assign(faces, faces + nf * 3);
  b->order.resize(nf);
  std::iota(b->order.begin(), b->order.end(), 0);
  b->centroids.resize(nf * 3);
  for (int64_t f = 0; f < nf; ++f)
    for (int a = 0; a < 3; ++a)
      b->centroids[f * 3 + a] =
          (b->vert(f, 0)[a] + b->vert(f, 1)[a] + b->vert(f, 2)[a]) / 3.0;
  b->nodes.reserve(2 * nf / BVH::kLeaf + 4);
  if (nf > 0) b->build(0, (int32_t)nf);
  return b;
}

void sas_bvh_distance(const void *bvh, const double *pts, int64_t m,
                      double *out_dist, int64_t *out_tri) {
  const auto *b = static_cast<const BVH *>(bvh);
  parallel_for(m, 256, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      b->distance1(pts + i * 3, &out_dist[i], &out_tri[i]);
  });
}

void sas_bvh_occupancy(const void *bvh, const double *pts, int64_t m,
                       uint8_t *out) {
  const auto *b = static_cast<const BVH *>(bvh);
  parallel_for(m, 256, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) out[i] = b->occupancy1(pts + i * 3);
  });
}

void sas_bvh_free(void *bvh) { delete static_cast<BVH *>(bvh); }

}  // extern "C"
