// tpurt native host components: fast Wavefront OBJ parsing and SAH BVH
// construction. These are the host-side hot paths (the reference keeps
// them in C++ too: src/readobj.hpp); the device compute path stays in
// JAX/XLA. Exposed as a plain C ABI for ctypes.
//
// Semantics mirror tpurt/accel/bvh.py and tpurt/scene/obj.py exactly:
//   * SAH with 5 candidate planes per axis at fractions (i+1)/6,
//     cost = halfArea * numTris, vertex-tight child boxes
//     (readobj.hpp:119-163);
//   * stop at depth 0 / <=2 tris / cost >= parent, with forced
//     midpoint-then-median splits above leaf_cap;
//   * stable partition by centroid < splitPos;
//   * flat node list, children adjacent.
// Float32 arithmetic is used throughout so trees match the numpy
// builder except for ULP-level SAH ties (image output never depends on
// BVH shape).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <utility>
#include <vector>

extern "C" {

struct TnNode {
  float bmin[3];
  float bmax[3];
  int64_t child;  // first child index; 0 = leaf
  int64_t first;  // first triangle
  int64_t ntris;  // 0 = internal
};

namespace {

struct Builder {
  float* pos;          // (n, 9) triangle vertices, permuted in place
  float* nrm;          // (n, 9) vertex normals, permuted alongside
  int64_t* aux;        // optional (n,) payload permuted alongside
  std::vector<TnNode>* nodes;
  std::vector<int64_t> scratch;

  void bounds_of(int64_t f, int64_t n, float* bmin, float* bmax) const {
    for (int a = 0; a < 3; ++a) {
      bmin[a] = std::numeric_limits<float>::infinity();
      bmax[a] = -std::numeric_limits<float>::infinity();
    }
    for (int64_t i = f; i < f + n; ++i) {
      const float* v = pos + 9 * i;
      for (int k = 0; k < 3; ++k)
        for (int a = 0; a < 3; ++a) {
          float c = v[3 * k + a];
          if (c < bmin[a]) bmin[a] = c;
          if (c > bmax[a]) bmax[a] = c;
        }
    }
  }

  static float node_cost(const float size[3], int64_t n) {
    float half_area = size[0] * (size[1] + size[2]) + size[1] * size[2];
    return half_area * (float)n;
  }

  float centroid(int64_t i, int axis) const {
    const float* v = pos + 9 * i;
    return (v[axis] + v[3 + axis] + v[6 + axis]) / 3.0f;
  }

  // Evaluate one SAH candidate; +inf when a side is empty.
  float eval_split(int64_t f, int64_t n, int axis, float split) const {
    float amin[3], amax[3], bmin[3], bmax[3];
    for (int a = 0; a < 3; ++a) {
      amin[a] = bmin[a] = std::numeric_limits<float>::infinity();
      amax[a] = bmax[a] = -std::numeric_limits<float>::infinity();
    }
    int64_t na = 0, nb = 0;
    for (int64_t i = f; i < f + n; ++i) {
      bool in_a = centroid(i, axis) < split;
      float* lo = in_a ? amin : bmin;
      float* hi = in_a ? amax : bmax;
      (in_a ? na : nb)++;
      const float* v = pos + 9 * i;
      for (int k = 0; k < 3; ++k)
        for (int a = 0; a < 3; ++a) {
          float c = v[3 * k + a];
          if (c < lo[a]) lo[a] = c;
          if (c > hi[a]) hi[a] = c;
        }
    }
    if (na == 0 || nb == 0) return std::numeric_limits<float>::infinity();
    float sa[3], sb[3];
    for (int a = 0; a < 3; ++a) {
      sa[a] = amax[a] - amin[a];
      sb[a] = bmax[a] - bmin[a];
    }
    return node_cost(sa, na) + node_cost(sb, nb);
  }

  // Stable partition of [f, f+n) by pred; returns count on the A side.
  int64_t partition(int64_t f, int64_t n, int axis, float split,
                    const bool* median_mask) {
    scratch.clear();
    std::vector<int64_t>& order = scratch;
    order.reserve(n);
    for (int64_t i = 0; i < n; ++i) {
      bool in_a = median_mask ? median_mask[i] : (centroid(f + i, axis) < split);
      if (in_a) order.push_back(i);
    }
    int64_t na = (int64_t)order.size();
    for (int64_t i = 0; i < n; ++i) {
      bool in_a = median_mask ? median_mask[i] : (centroid(f + i, axis) < split);
      if (!in_a) order.push_back(i);
    }
    std::vector<float> tmp9(9 * n);
    auto permute9 = [&](float* arr) {
      for (int64_t i = 0; i < n; ++i)
        std::memcpy(&tmp9[9 * i], arr + 9 * (f + order[i]), 9 * sizeof(float));
      std::memcpy(arr + 9 * f, tmp9.data(), 9 * n * sizeof(float));
    };
    permute9(pos);
    permute9(nrm);
    if (aux) {
      std::vector<int64_t> tmp(n);
      for (int64_t i = 0; i < n; ++i) tmp[i] = aux[f + order[i]];
      std::memcpy(aux + f, tmp.data(), n * sizeof(int64_t));
    }
    return na;
  }

  void split(int64_t parent, int depth, int leaf_cap) {
    int64_t n = (*nodes)[parent].ntris;
    if (depth == 0 || n <= 2) return;
    int64_t f = (*nodes)[parent].first;

    // ChooseSplitAxisAndPosition (readobj.hpp:142-163).
    float best_cost = std::numeric_limits<float>::max();
    int best_axis = 0;
    float best_pos = 0.0f;
    for (int axis = 0; axis < 3; ++axis) {
      float lo = (*nodes)[parent].bmin[axis];
      float hi = (*nodes)[parent].bmax[axis];
      for (int i = 0; i < 5; ++i) {
        float t = (float)(i + 1) / 6.0f;
        float split_pos = lo + (hi - lo) * t;
        float cost = eval_split(f, n, axis, split_pos);
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_pos = split_pos;
        }
      }
    }
    float size[3];
    for (int a = 0; a < 3; ++a)
      size[a] = (*nodes)[parent].bmax[a] - (*nodes)[parent].bmin[a];
    bool forced = leaf_cap > 0 && n > leaf_cap;
    if (best_cost >= node_cost(size, n) && !forced) return;

    int64_t na = 0;
    for (int64_t i = 0; i < n; ++i)
      na += centroid(f + i, best_axis) < best_pos;
    bool median = false;
    std::vector<char> mask;
    if ((na == 0 || na == n) && forced) {
      // SAH declined/degenerated on a fat leaf: midpoint of the longest
      // axis, then a median split.
      int axis = 0;
      for (int a = 1; a < 3; ++a)
        if (size[a] > size[axis]) axis = a;
      float mid = (*nodes)[parent].bmin[axis] + size[axis] * 0.5f;
      na = 0;
      for (int64_t i = 0; i < n; ++i) na += centroid(f + i, axis) < mid;
      if (na == 0 || na == n) {
        std::vector<std::pair<float, int64_t>> cs(n);
        for (int64_t i = 0; i < n; ++i) cs[i] = {centroid(f + i, axis), i};
        std::stable_sort(cs.begin(), cs.end(),
                         [](const std::pair<float, int64_t>& x,
                            const std::pair<float, int64_t>& y) {
                           return x.first < y.first;
                         });
        mask.assign(n, 0);
        for (int64_t i = 0; i < n / 2; ++i) mask[cs[i].second] = 1;
        median = true;
      }
      best_axis = axis;
      best_pos = mid;
    }
    if (!median && (na == 0 || na == n)) return;
    na = partition(f, n, best_axis, best_pos,
                   median ? reinterpret_cast<const bool*>(mask.data())
                          : nullptr);
    {
    int64_t child = (int64_t)nodes->size();
    (*nodes)[parent].child = child;
    (*nodes)[parent].ntris = 0;
    TnNode a{}, b{};
    a.first = f;
    a.ntris = na;
    b.first = f + na;
    b.ntris = n - na;
    bounds_of(a.first, a.ntris, a.bmin, a.bmax);
    bounds_of(b.first, b.ntris, b.bmin, b.bmax);
    nodes->push_back(a);
    nodes->push_back(b);
    split(child, depth - 1, leaf_cap);
    split(child + 1, depth - 1, leaf_cap);
    }
  }
};

}  // namespace

// Build a BVH over pos/nrm[first:first+n] (permuted in place, aux too
// when non-null). Appends nodes into out (capacity cap); returns the
// root index, or -1 if capacity would be exceeded.
int64_t tn_build_bvh(float* pos, float* nrm, int64_t* aux, int64_t first,
                     int64_t n, int max_depth, int leaf_cap, TnNode* out,
                     int64_t out_offset, int64_t cap, int64_t* out_count) {
  std::vector<TnNode> nodes;
  nodes.reserve(2 * n + 1);
  Builder b{pos, nrm, aux, &nodes, {}};
  TnNode root{};
  root.first = first;
  root.ntris = n;
  b.bounds_of(first, n, root.bmin, root.bmax);
  nodes.push_back(root);
  b.split(0, max_depth, leaf_cap);
  if ((int64_t)nodes.size() > cap) return -1;
  // Rebase child links by out_offset so callers can share one array.
  for (auto& nd : nodes)
    if (nd.ntris == 0) nd.child += out_offset;
  std::memcpy(out + out_offset, nodes.data(), nodes.size() * sizeof(TnNode));
  *out_count = (int64_t)nodes.size();
  return out_offset;
}

// ---------------------------------------------------------------------------
// OBJ parsing (semantics of tpurt/scene/obj.py / readobj.hpp:270-344).
// Two-pass C ABI: count, then fill caller-allocated buffers.
// ---------------------------------------------------------------------------

namespace {

struct ObjData {
  std::vector<float> verts, norms;
  std::vector<int64_t> fv, fn;  // per-face 3 indices each (0-based)
};

bool parse_obj_impl(const char* text, int64_t len, ObjData& d) {
  const char* p = text;
  const char* end = text + len;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    // trim leading whitespace
    const char* q = p;
    while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (line_end - q >= 2 && q[0] == 'v' && q[1] == ' ') {
      float x, y, z;
      if (sscanf(q, "v %f %f %f", &x, &y, &z) == 3) {
        d.verts.push_back(x);
        d.verts.push_back(y);
        d.verts.push_back(z);
      }
    } else if (line_end - q >= 3 && q[0] == 'v' && q[1] == 'n' && q[2] == ' ') {
      float x, y, z;
      if (sscanf(q, "vn %f %f %f", &x, &y, &z) == 3) {
        d.norms.push_back(x);
        d.norms.push_back(y);
        d.norms.push_back(z);
      }
    } else if (line_end - q >= 2 && q[0] == 'f' && q[1] == ' ') {
      long long v[3], t[3], nn[3];
      int m = sscanf(q, "f %lld/%lld/%lld %lld/%lld/%lld %lld/%lld/%lld",
                     &v[0], &t[0], &nn[0], &v[1], &t[1], &nn[1], &v[2], &t[2],
                     &nn[2]);
      bool ok = (m == 9);
      if (!ok) {
        m = sscanf(q, "f %lld//%lld %lld//%lld %lld//%lld", &v[0], &nn[0],
                   &v[1], &nn[1], &v[2], &nn[2]);
        ok = (m == 6);
      }
      if (ok) {
        int64_t nv = (int64_t)d.verts.size() / 3;
        int64_t nn_count = (int64_t)d.norms.size() / 3;
        bool in_bounds = true;
        for (int k = 0; k < 3; ++k) {
          if (v[k] < 1 || v[k] > nv || nn[k] < 1 || nn[k] > nn_count)
            in_bounds = false;
        }
        if (in_bounds) {
          for (int k = 0; k < 3; ++k) {
            d.fv.push_back(v[k] - 1);
            d.fn.push_back(nn[k] - 1);
          }
        }
      }
      // unsupported/out-of-bounds faces are skipped (warn-free here; the
      // Python layer warns)
    }
    p = line_end + 1;
  }
  return true;
}

}  // namespace

int64_t tn_obj_tri_count(const char* text, int64_t len) {
  ObjData d;
  parse_obj_impl(text, len, d);
  return (int64_t)d.fv.size() / 3;
}

int64_t tn_obj_parse(const char* text, int64_t len, float* pos, float* nrm) {
  ObjData d;
  parse_obj_impl(text, len, d);
  int64_t n = (int64_t)d.fv.size() / 3;
  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      int64_t vi = d.fv[3 * i + k];
      int64_t ni = d.fn[3 * i + k];
      for (int a = 0; a < 3; ++a) {
        pos[9 * i + 3 * k + a] = d.verts[3 * vi + a];
        nrm[9 * i + 3 * k + a] = d.norms[3 * ni + a];
      }
    }
  }
  return n;
}

}  // extern "C"
