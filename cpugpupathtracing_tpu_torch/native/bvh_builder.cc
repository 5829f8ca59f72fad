// Native BVH builder (a copy of the JAX package's native/bvh_builder.cc).
//
// It reproduces the JAX package's numpy builder (its models/bvh.py)
// BIT-FOR-BIT (same f32 arithmetic, candidate order, tie-breaks, NaN
// empty-side rejection, stable partition, forced median splits) and is
// the port's only BVH builder.  native/__init__.py builds it with
//   g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off
// (-ffp-contract=off: no FMA contraction, keeping float results
// identical to numpy's non-fused ops.)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

inline float half_area(const V3& mn, const V3& mx) {
  // GetAABBVolume (Source/Primitives.cpp:280-284): xy + yz + zx in f32.
  float ex = mx.x - mn.x, ey = mx.y - mn.y, ez = mx.z - mn.z;
  return ex * ey + ey * ez + ez * ex;
}

inline void grow(V3& mn, V3& mx, const V3& p) {
  mn.x = std::min(mn.x, p.x); mn.y = std::min(mn.y, p.y); mn.z = std::min(mn.z, p.z);
  mx.x = std::max(mx.x, p.x); mx.y = std::max(mx.y, p.y); mx.z = std::max(mx.z, p.z);
}

constexpr float BIG = 1e30f;

struct Builder {
  const float* tv;  // (T, 9) v0,v1,v2
  int T;
  int option;
  int max_leaf;
  int leaf_stop;  // stop subdividing at <= N tris (0 = off); fat leaves
                  // for the packet tables, where a leaf is one row

  std::vector<V3> cen, tmin, tmax;
  std::vector<int32_t> perm;
  float* nodes_min;
  float* nodes_max;
  int32_t* left_first;
  int32_t* prim_count;
  int next_node = 0;
  int max_depth = 0;

  float axis_of(const V3& v, int a) const { return a == 0 ? v.x : (a == 1 ? v.y : v.z); }

  void node_bounds(int node, int first, int count) {
    V3 mn{BIG, BIG, BIG}, mx{-BIG, -BIG, -BIG};
    for (int i = first; i < first + count; ++i) {
      int t = perm[i];
      grow(mn, mx, tmin[t]);
      // grow with tmax too (min of tmax can't shrink mn below tmin mins,
      // matching numpy's min-over-tmin / max-over-tmax)
      mx.x = std::max(mx.x, tmax[t].x);
      mx.y = std::max(mx.y, tmax[t].y);
      mx.z = std::max(mx.z, tmax[t].z);
    }
    nodes_min[3 * node + 0] = mn.x; nodes_min[3 * node + 1] = mn.y; nodes_min[3 * node + 2] = mn.z;
    nodes_max[3 * node + 0] = mx.x; nodes_max[3 * node + 1] = mx.y; nodes_max[3 * node + 2] = mx.z;
  }

  // EvaluateSAH (Source/BVH.cpp:299-327): full sweep, empty side gives
  // 0 * inf = NaN and is rejected by the strict '<'.
  float sah_cost(int first, int count, int axis, float pos) const {
    V3 lmn{BIG, BIG, BIG}, lmx{-BIG, -BIG, -BIG};
    V3 rmn{BIG, BIG, BIG}, rmx{-BIG, -BIG, -BIG};
    int32_t nl = 0, nr = 0;
    for (int i = first; i < first + count; ++i) {
      int t = perm[i];
      if (axis_of(cen[t], axis) < pos) {
        ++nl; grow(lmn, lmx, tmin[t]);
        lmx.x = std::max(lmx.x, tmax[t].x); lmx.y = std::max(lmx.y, tmax[t].y); lmx.z = std::max(lmx.z, tmax[t].z);
      } else {
        ++nr; grow(rmn, rmx, tmin[t]);
        rmx.x = std::max(rmx.x, tmax[t].x); rmx.y = std::max(rmx.y, tmax[t].y); rmx.z = std::max(rmx.z, tmax[t].z);
      }
    }
    return (float)nl * half_area(lmn, lmx) + (float)nr * half_area(rmn, rmx);
  }

  // returns true + axis/pos, or false for leaf
  bool choose_split(int node, int first, int count, int& axis, float& pos) {
    const V3 nmn{nodes_min[3 * node], nodes_min[3 * node + 1], nodes_min[3 * node + 2]};
    const V3 nmx{nodes_max[3 * node], nodes_max[3 * node + 1], nodes_max[3 * node + 2]};
    if (option == 0) {  // NAIVE_SPLIT (Source/BVH.cpp:208-224)
      if (count <= 2) return false;
      V3 ext{nmx.x - nmn.x, nmx.y - nmn.y, nmx.z - nmn.z};
      axis = 0;
      if (ext.y > ext.x) axis = 1;
      if (axis_of(ext, 2) > axis_of(ext, axis)) axis = 2;
      pos = axis_of(nmn, axis) + axis_of(ext, axis) * 0.5f;
      return true;
    }
    float parent_cost = half_area(nmn, nmx) * (float)count;
    if (option == 1) {  // SAH_SPLIT_INTERVALS (Source/BVH.cpp:225-259)
      float cheapest = BIG;
      int best_axis = 0; float best_pos = 0.0f; bool found = false;
      for (int si = 0; si < 8; ++si) {
        for (int a = 0; a < 3; ++a) {
          float width = axis_of(nmx, a) - axis_of(nmn, a);
          float frac = (float)si / 8.0f;
          float p = width * frac + axis_of(nmn, a);
          float c = sah_cost(first, count, a, p);
          if (c < cheapest) {  // NaN never passes
            cheapest = c; best_axis = a; best_pos = p; found = true;
          }
        }
      }
      if (!found || !(cheapest < BIG) || cheapest >= parent_cost) return false;
      axis = best_axis; pos = best_pos;
      return true;
    }
    // option 2: SAH_SPLIT_PRIMITIVES, corrected full sweep with
    // prefix/suffix bounds (the JAX package's models/bvh.py _choose_split).
    {
      double best_cost = std::numeric_limits<double>::infinity();
      int best_axis = -1; float best_pos = 0.0f;
      std::vector<int> order(count);
      std::vector<float> csort(count);
      std::vector<V3> pre_mn(count), pre_mx(count), suf_mn(count), suf_mx(count);
      for (int a = 0; a < 3; ++a) {
        for (int i = 0; i < count; ++i) order[i] = perm[first + i];
        std::stable_sort(order.begin(), order.end(), [&](int x, int y) {
          return axis_of(cen[x], a) < axis_of(cen[y], a);
        });
        for (int i = 0; i < count; ++i) csort[i] = axis_of(cen[order[i]], a);
        V3 mn{BIG, BIG, BIG}, mx{-BIG, -BIG, -BIG};
        for (int i = 0; i < count; ++i) {
          grow(mn, mx, tmin[order[i]]);
          mx.x = std::max(mx.x, tmax[order[i]].x); mx.y = std::max(mx.y, tmax[order[i]].y); mx.z = std::max(mx.z, tmax[order[i]].z);
          pre_mn[i] = mn; pre_mx[i] = mx;
        }
        mn = {BIG, BIG, BIG}; mx = {-BIG, -BIG, -BIG};
        for (int i = count - 1; i >= 0; --i) {
          grow(mn, mx, tmin[order[i]]);
          mx.x = std::max(mx.x, tmax[order[i]].x); mx.y = std::max(mx.y, tmax[order[i]].y); mx.z = std::max(mx.z, tmax[order[i]].z);
          suf_mn[i] = mn; suf_mx[i] = mx;
        }
        for (int i = 0; i < count; ++i) {
          if (i > 0 && csort[i] == csort[i - 1]) continue;  // unique ks
          int k = i;  // searchsorted-left of csort[i]
          float la = k == 0 ? std::nanf("") : half_area(pre_mn[k - 1], pre_mx[k - 1]) * (float)k;
          float ra = k == count ? std::nanf("") : half_area(suf_mn[k], suf_mx[k]) * (float)(count - k);
          float cost = la + ra;
          if (!std::isnan(cost) && cost < best_cost) {
            best_cost = cost; best_axis = a; best_pos = csort[k < count ? k : count - 1];
          }
        }
      }
      if (best_axis < 0 || best_cost >= parent_cost) return false;
      axis = best_axis; pos = best_pos;
      return true;
    }
  }

  void build() {
    left_first[0] = 0;
    prim_count[0] = T;
    node_bounds(0, 0, T);
    next_node = 1;
    std::vector<std::pair<int, int>> stack;  // (node, depth)
    stack.emplace_back(0, 0);
    std::vector<int32_t> tmp;
    while (!stack.empty()) {
      auto [node, depth] = stack.back();
      stack.pop_back();
      max_depth = std::max(max_depth, depth);
      int first = left_first[node];
      int count = prim_count[node];
      if (leaf_stop > 0 && count <= leaf_stop) continue;

      int axis; float pos;
      bool split = choose_split(node, first, count, axis, pos);
      bool forced = false;
      if (!split && max_leaf > 0 && count > max_leaf) {
        // forced median split on the widest centroid axis (_median_split)
        V3 lo{BIG, BIG, BIG}, hi{-BIG, -BIG, -BIG};
        for (int i = first; i < first + count; ++i) {
          const V3& c = cen[perm[i]];
          lo.x = std::min(lo.x, c.x); lo.y = std::min(lo.y, c.y); lo.z = std::min(lo.z, c.z);
          hi.x = std::max(hi.x, c.x); hi.y = std::max(hi.y, c.y); hi.z = std::max(hi.z, c.z);
        }
        float ex = hi.x - lo.x, ey = hi.y - lo.y, ez = hi.z - lo.z;
        axis = 0;
        if (ey > ex) axis = 1;
        float m = axis == 0 ? ex : ey;
        if (ez > m) axis = 2;
        std::vector<float> vals(count);
        for (int i = 0; i < count; ++i) vals[i] = axis_of(cen[perm[first + i]], axis);
        std::sort(vals.begin(), vals.end());
        double med = (count % 2) ? (double)vals[count / 2]
                                 : ((double)vals[count / 2 - 1] + (double)vals[count / 2]) / 2.0;
        float medf = (float)med;
        float lo_a = axis_of(lo, axis);
        if (medf <= lo_a) {
          float best = BIG; bool any = false;
          for (float v : vals) if (v > lo_a && v < best) { best = v; any = true; }
          if (any) medf = best;
        }
        pos = medf;
        split = true;
        forced = true;
      }
      if (!split) continue;

      // stable partition: left block keeps order, then right block
      tmp.clear();
      tmp.reserve(count);
      int nl = 0;
      for (int i = first; i < first + count; ++i)
        if (axis_of(cen[perm[i]], axis) < pos) { tmp.push_back(perm[i]); ++nl; }
      for (int i = first; i < first + count; ++i)
        if (!(axis_of(cen[perm[i]], axis) < pos)) tmp.push_back(perm[i]);

      if (nl == 0 || nl == count) {
        if (forced || (max_leaf > 0 && count > max_leaf)) {
          nl = count / 2;  // index-halves split: keep original order
          for (int i = 0; i < count; ++i) tmp[i] = perm[first + i];
        } else {
          continue;
        }
      }
      std::memcpy(&perm[first], tmp.data(), count * sizeof(int32_t));

      int li = next_node++;
      int ri = next_node++;
      left_first[li] = first; prim_count[li] = nl;
      left_first[ri] = first + nl; prim_count[ri] = count - nl;
      node_bounds(li, first, nl);
      node_bounds(ri, first + nl, count - nl);
      left_first[node] = li;
      prim_count[node] = 0;
      stack.emplace_back(ri, depth + 1);
      stack.emplace_back(li, depth + 1);
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Output buffers must have capacity:
//   nodes_min/max: 4*T*3 floats; left_first/prim_count: 4*T ints;
//   perm: T ints; out_info: [num_nodes, max_depth].
int bvh_build(const float* tri_verts, int num_tris, int build_option,
              int max_leaf_size, int leaf_stop, float* nodes_min,
              float* nodes_max, int32_t* left_first, int32_t* prim_count,
              int32_t* perm, int32_t* out_info) {
  if (num_tris <= 0) return 1;
  Builder b;
  b.tv = tri_verts;
  b.T = num_tris;
  b.option = build_option;
  b.max_leaf = max_leaf_size;
  b.leaf_stop = leaf_stop;
  b.nodes_min = nodes_min;
  b.nodes_max = nodes_max;
  b.left_first = left_first;
  b.prim_count = prim_count;

  b.cen.resize(num_tris);
  b.tmin.resize(num_tris);
  b.tmax.resize(num_tris);
  b.perm.resize(num_tris);
  for (int t = 0; t < num_tris; ++t) {
    const float* v = tri_verts + 9 * t;
    V3 v0{v[0], v[1], v[2]}, v1{v[3], v[4], v[5]}, v2{v[6], v[7], v[8]};
    // centroid = (v0+v1+v2) * 0.3333f (Source/Primitives.cpp:255-258)
    b.cen[t] = V3{(v0.x + v1.x + v2.x) * 0.3333f,
                  (v0.y + v1.y + v2.y) * 0.3333f,
                  (v0.z + v1.z + v2.z) * 0.3333f};
    b.tmin[t] = V3{std::min(std::min(v0.x, v1.x), v2.x),
                   std::min(std::min(v0.y, v1.y), v2.y),
                   std::min(std::min(v0.z, v1.z), v2.z)};
    b.tmax[t] = V3{std::max(std::max(v0.x, v1.x), v2.x),
                   std::max(std::max(v0.y, v1.y), v2.y),
                   std::max(std::max(v0.z, v1.z), v2.z)};
    b.perm[t] = t;
  }
  b.build();
  std::memcpy(perm, b.perm.data(), num_tris * sizeof(int32_t));
  out_info[0] = b.next_node;
  out_info[1] = b.max_depth;
  return 0;
}
}
