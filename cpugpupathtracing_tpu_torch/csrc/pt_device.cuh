// Per-ray body of the ADVANCED path tracer: BVH traversal (closest-hit
// and any-hit), Moller-Trumbore leaf tests, analytic sphere/plane tests
// and the TracePathAdvanced shading body (Source/Main.cpp:396-579); the
// Whitted body (whitted.cuh) reuses the analytic tests and the RNG.
//
// Ports of the JAX package's shared Pallas device functions:
//   ops/megakernel.py            _emit_traversal, _analytic_tests,
//                                _shade_surface, _analytic_occluded_nee,
//                                _xs32, _u2f, _umod
//   ops/traverse_packet_slim.py  _leaf_tests (8 x 16-col shading records,
//                                14 x 9-col occlusion records)
// Every RNG draw, predicate, epsilon and f32 association follows those
// functions op for op; build with --fmad=false and without fast-math so
// no product is contracted and division / sqrt stay IEEE.  Hits are then
// bit-equal to the brute-force oracle on every ray, thanks to two rules
// that _emit_traversal lacks: an exact tie in t goes to the lower original
// triangle id (closest_hit), and the slab of a zero direction component
// includes the box's faces (zero_slab).  Transcendentals (sinf, cosf,
// expf, rsqrtf) may differ from XLA's by ULPs (the megakernel contract).
//
// One thread traces one ray with its own stack; the packet machinery of
// the TPU kernels (shared row stacks, frame stacks, SMEM staging) is a
// schedule for that machine and is not ported.  The node tables it reads
// are: the variant walks (kVar) read every layout of the JAX package's
// CPUGPU_SMEMTREE, CPUGPU_PACKET_TREE=w16 and CPUGPU_FUSED -- 64-col rows
// with the entries in a side table, 48-col bounds-only rows with the
// side table, 128-col 16-wide rows, and the fused node|leaf table of
// 128-col rows whose entries >= fused_nn are leaf rows of the same table
// (Tree::ents, cols, width, fused_nn) -- while the plain walks
// (kVar = false) read the 64-col rows with the entries at cols 48..55
// only, and compile as they did before the variants.  The TLAS instance
// machinery of ops/traverse_packet_slim.py is: with kInst, an entry above
// SLIM_EMPTY (SLIM_EMPTY + 1 + instance id) moves the ray into the
// instance's object space by its 3x4 inst_inv row (the direction stays
// unnormalised, so t stays the world ray's parameter), pushes RESTORE and
// descends into the instance's BLAS root; popping RESTORE restores the
// world ray.  A hit carries its instance id, and its normal stays in
// object space until shade_extend's epilogue (inst_nrm) or
// models/scene.hit_surface turns it into a world normal.  The kernel entry
// points are in pt_frame.cu (whole frame), megakernel.cu (per depth),
// traverse.cu (standalone traversal) and whitted.cu (Whitted frame),
// their shared launch code in pt_launch.cuh.

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define PT_HD __host__ __device__ __forceinline__
#else
#define PT_HD inline
#endif

namespace pt {

constexpr int PT_STACK = 64;  // ops/pt_frame.py PT_STACK mirrors it
// the variant walks' stack: a 16-wide row leaves up to 15 siblings
// pending per level (ops/pt_frame.py PT_STACK_W16 mirrors it; the scene
// build refuses a tree whose worst case would not fit)
constexpr int PT_STACK_W16 = 128;
constexpr int SLIM_EMPTY = 0x40000000;
// stack marker: leave instance space (below SLIM_EMPTY, far above any
// real node row)
constexpr int RESTORE = 0x3FFFFFFF;
constexpr int LEAF_TRIS = 8;
constexpr int OCCL_TRIS = 14;
constexpr int OCCL_STRIDE = 9;
constexpr float TRI_DET_EPS = 0.001f;
constexpr float PLANE_DENOM_EPS = 1e-6f;
constexpr float BIG = 1e30f;
constexpr float RAY_TMAX = 1e34f;
constexpr float RAY_NUDGE = 0.001f;
constexpr float TWO_NUDGE = (float)(2.0 * 0.001);
constexpr float PI_F = 3.14159265f;
constexpr float TWO_PI_F = (float)(2.0 * 3.14159265);
constexpr float INV_PI_F = (float)(1.0 / 3.14159265);
constexpr float INV_TWO_PI_F = (float)(1.0 / (2.0 * 3.14159265));
constexpr float F32_SCALE = (float)2.3283064365387e-10;
constexpr float INF_F = __builtin_huge_valf();

// material columns (M, 14)
constexpr int M_ALBEDO = 0, M_SPECULAR = 3, M_REFRACT = 4, M_ABSORB = 5,
              M_IOR = 8, M_EMISSIVE = 9, M_INTENSITY = 12, M_IS_LIGHT = 13,
              M_COLS = 14;
// light columns (L, 10)
constexpr int L_CENTER = 0, L_RADIUS = 3, L_AREA = 4, L_EMISSION = 5,
              L_IS_SPHERE = 9, L_COLS = 10;
// sphere (S, 6): center, radius^2, mat, is_light; plane (P, 7): point,
// normal, mat; light triangle (LT, 12): v0, v1, v2, normal
constexpr int S_RSQ = 3, S_COLS = 6, P_COLS = 7, LT_COLS = 12;

// ---- loads and bit casts -------------------------------------------------

template <typename T>
PT_HD T ld(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

struct F4 {
  float x, y, z, w;
};

// 16-byte load (p must be 16-byte aligned)
PT_HD F4 ld4(const float* p) {
#ifdef __CUDA_ARCH__
  float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return {v.x, v.y, v.z, v.w};
#else
  return {p[0], p[1], p[2], p[3]};
#endif
}

PT_HD int as_int(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int i;
  std::memcpy(&i, &f, sizeof(i));
  return i;
#endif
}

PT_HD float rsqrt_f(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / std::sqrt(x);
#endif
}

// ---- RNG (Include/Random.h) ---------------------------------------------

PT_HD uint32_t xs32(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

// correctly rounded u32 -> f32, times 2^-32
PT_HD float u2f(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __uint2float_rn(v) * F32_SCALE;
#else
  return static_cast<float>(v) * F32_SCALE;
#endif
}

// ---- scene -----------------------------------------------------------------

struct Tables {  // small scene tables (shared memory on the card)
  const float* mats;
  int num_mats;
  const float* lights;
  int num_lights;
  const float* ltri;
  const int* ltmeta;  // (L, 2) start, count into ltri
  int mesh_lights;
  const float* sph;
  int num_sph;
  const float* pln;
  int num_pln;
  const int* objmat;
  int num_objs;
  const int* sphmat;
  const int* plnmat;
};

struct Tree {  // one slim 8-wide tree: (B, 64) nodes, (NL, 128) leaf rows
  const float* nodes;
  const float* ltris;
  const int* roots;
  int nroots;
  bool occl;  // leaf rows hold 14 bare 9-col records (bvh8.to_slim_occl)
  // with count_iters: one byte per node / leaf row, set to 1 when a walk
  // reads the row (the rows the launch touched); else null
  unsigned char* seen_node;
  unsigned char* seen_leaf;
  // the object-space instance machinery (walks with kInst): per instance
  // the world -> object 3x4 rows (I, 12), the normal matrix (I, 9, read
  // by shade_extend's epilogue only) and the BLAS root row (I,)
  const float* inst_inv;
  const float* inst_nrm;
  const int* inst_root;
  int num_inst;
  // the node layout, read by the variant walks (kVar) only: the side
  // table of 8 entries per node row or null (entries in the row), the
  // row length in f32 (48, 64 or 128), the arity (8 or 16), and for a
  // fused node|leaf table its node-row count (0 otherwise)
  const int* ents;
  int cols, width, fused_nn;
};

struct Counters {  // work done: node / leaf rows visited, rays traversed
  unsigned long long node = 0, leaf = 0, snode = 0, sleaf = 0, ray = 0,
                     sray = 0;
};
constexpr int NUM_COUNTERS = 6;

struct Hit {
  float t;
  int tri, obj;
  float nx, ny, nz;
  int iid;  // instance of the hit, -1 for a world-space hit
};

PT_HD float inv_dir(float d) { return d == 0.0f ? BIG : 1.0f / d; }

// A ray as the slab tests see it: origin, reciprocal direction (the
// zero-direction rule of megakernel._emit_traversal: 1/0 -> 1e30) and a
// mask of its exactly-zero direction components (bit 0 x, 1 y, 2 z).
struct SlabRay {
  float ox, oy, oz, ix, iy, iz;
  int zero;
};

PT_HD SlabRay slab_ray(float ox, float oy, float oz, float dx, float dy,
                       float dz) {
  return {ox, oy, oz, inv_dir(dx), inv_dir(dy), inv_dir(dz),
          (dx == 0.0f ? 1 : 0) | (dy == 0.0f ? 2 : 0) | (dz == 0.0f ? 4 : 0)};
}

// Slab of one axis with a zero direction component: the whole line when
// the origin lies within [lo, hi] (faces included), else empty.  With
// 1e30 for 1/0 an origin exactly on a face gives (face - o) * 1e30 = 0
// and would cull a box whose face holds the ray -- and with it a triangle
// the ray meets on that face, which the brute-force oracle does see.
PT_HD void zero_slab(float lo, float hi, float o, float& t1, float& t2) {
  t1 = lo <= o ? -INF_F : INF_F;
  t2 = o <= hi ? INF_F : -INF_F;
}

// The 8 slab tests of one block of child slots: bounds at `bnd` (48 f32:
// a 48- or 64-col row, or one half of a 16-wide row), entries at `ent_p`
// (8 i32, in the row or in a side table).  Pushes every child the ray
// enters before `t` (at `t` too when `at_t`: a closest-hit walk must
// still visit boxes that may hold an exact tie), in slot order, onto a
// stack of kCap entries.  Validity lives in the entry (ent != SLIM_EMPTY),
// never the bounds: a 48-col table's empty slot has NaN bounds, which
// fminf / fmaxf would drop.  Sets `passed` when a child passes.  Returns
// false if the stack is full.
template <int kCap>
PT_HD bool push_row(const float* bnd, const int* ent_p, const SlabRay& r,
                    float t, bool at_t, int* stack, int& sp, bool& passed) {
  float b[48];
#pragma unroll
  for (int q = 0; q < 12; ++q) {
    F4 v = ld4(bnd + 4 * q);
    b[4 * q] = v.x;
    b[4 * q + 1] = v.y;
    b[4 * q + 2] = v.z;
    b[4 * q + 3] = v.w;
  }
  const float* ef = reinterpret_cast<const float*>(ent_p);
  F4 e0 = ld4(ef), e1 = ld4(ef + 4);
  int ent[8] = {as_int(e0.x), as_int(e0.y), as_int(e0.z), as_int(e0.w),
                as_int(e1.x), as_int(e1.y), as_int(e1.z), as_int(e1.w)};
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float* c = b + 6 * k;  // min xyz, max xyz
    float tx1 = (c[0] - r.ox) * r.ix;
    float ty1 = (c[1] - r.oy) * r.iy;
    float tz1 = (c[2] - r.oz) * r.iz;
    float tx2 = (c[3] - r.ox) * r.ix;
    float ty2 = (c[4] - r.oy) * r.iy;
    float tz2 = (c[5] - r.oz) * r.iz;
    if (r.zero) {
      if (r.zero & 1) zero_slab(c[0], c[3], r.ox, tx1, tx2);
      if (r.zero & 2) zero_slab(c[1], c[4], r.oy, ty1, ty2);
      if (r.zero & 4) zero_slab(c[2], c[5], r.oz, tz1, tz2);
    }
    float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
    float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
    bool before = tmin < t || (at_t && tmin == t);
    if (tmax >= tmin && before && tmax > 0.0f && ent[k] != SLIM_EMPTY) {
      passed = true;
      if (sp < kCap) {
        stack[sp++] = ent[k];
      } else {
        ok = false;
      }
    }
  }
  return ok;
}

// The plain walks' node step: one row of a 64-col table, the entries at
// cols 48..55, onto a stack of PT_STACK entries.  With kDepth, adds 1 to
// *depth when at least one child passes (the per-ray reading of the
// Pallas kernel's `depth += any(bm[k])`).  Returns false if the stack is
// full.
template <bool kDepth = false>
PT_HD bool push_children(const float* row, const SlabRay& r, float t,
                         bool at_t, int* stack, int& sp,
                         int* depth = nullptr) {
  bool passed = false;
  bool ok = push_row<PT_STACK>(row, reinterpret_cast<const int*>(row + 48),
                               r, t, at_t, stack, sp, passed);
  if constexpr (kDepth) *depth += passed ? 1 : 0;
  return ok;
}

// The variant walks' node step of row `e` of any layout (Tree::ents,
// cols, width): one block of 8 slots, two for a 16-wide row (slots 0..7,
// then 8..15, so children are pushed in slot order).  With kDepth adds 1
// to *depth when at least one child passes.  Returns false if the stack
// is full.
template <bool kDepth = false>
PT_HD bool push_node(const Tree& tr, int e, const SlabRay& r, float t,
                     bool at_t, int* stack, int& sp, int* depth = nullptr) {
  const float* row = tr.nodes + (size_t)e * tr.cols;
  const int* ent = tr.ents ? tr.ents + (size_t)e * 8
                           : reinterpret_cast<const int*>(row + 6 * tr.width);
  bool passed = false;
  bool ok = push_row<PT_STACK_W16>(row, ent, r, t, at_t, stack, sp, passed);
  if (tr.width == 16) {
    ok &= push_row<PT_STACK_W16>(row + 48, ent + 8, r, t, at_t, stack, sp,
                                  passed);
  }
  if constexpr (kDepth) *depth += passed ? 1 : 0;
  return ok;
}

// An entry of a variant walk: a node row (fused: below fused_nn; split
// tables: >= 0), else a leaf; its leaf row (the byte map's index: fused
// e - fused_nn, split -e - 1) and the row's records (fused: row e of the
// fused table itself).
PT_HD bool var_is_node(const Tree& tr, int e) {
  return tr.fused_nn ? e < tr.fused_nn : e >= 0;
}

PT_HD int var_leaf_row(const Tree& tr, int e) {
  return tr.fused_nn ? e - tr.fused_nn : -e - 1;
}

PT_HD const float* var_leaf(const Tree& tr, int e) {
  return tr.fused_nn ? tr.nodes + (size_t)e * 128
                     : tr.ltris + (size_t)(-e - 1) * 128;
}

// Moller-Trumbore in the association of traverse_packet_slim._leaf_tests
// (double-sided, |det| >= 1e-3).  Returns the hit distance tt > 0, or -1
// when rejected; the caller compares tt with the ray's current t.
PT_HD float tri_test(float ox, float oy, float oz, float dx, float dy,
                     float dz, float v0x, float v0y, float v0z, float e1x,
                     float e1y, float e1z, float e2x, float e2y,
                     float e2z) {
  float hx = dy * e2z - dz * e2y;
  float hy = dz * e2x - dx * e2z;
  float hz = dx * e2y - dy * e2x;
  float a = e1x * hx + e1y * hy + e1z * hz;
  bool det_ok = fabsf(a) >= TRI_DET_EPS;
  float f = 1.0f / (det_ok ? a : 1.0f);
  float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  float u = f * (sx * hx + sy * hy + sz * hz);
  float qx = sy * e1z - sz * e1y;
  float qy = sz * e1x - sx * e1z;
  float qz = sx * e1y - sy * e1x;
  float vv = f * (dx * qx + dy * qy + dz * qz);
  float tt = f * (e2x * qx + e2y * qy + e2z * qz);
  bool ok = det_ok && u >= 0.0f && u <= 1.0f && vv >= 0.0f &&
            (u + vv) <= 1.0f && tt > 0.0f;
  return ok ? tt : -1.0f;
}

// The ray of a walk in its current space: world space, or after an
// instance entry that instance's object space (kInst walks).
struct WalkRay {
  float ox, oy, oz, dx, dy, dz;
  SlabRay sr;
  int iid;
};

PT_HD WalkRay world_ray(float ox, float oy, float oz, float dx, float dy,
                        float dz) {
  return {ox, oy, oz, dx, dy, dz, slab_ray(ox, oy, oz, dx, dy, dz), -1};
}

// One control entry of a kInst walk, before the node / leaf cases: on
// RESTORE the world ray `w` comes back (and the caller pops); on an
// instance entry the ray moves into the instance's object space by its
// inst_inv row in _enter's association, RESTORE is pushed and `e`
// becomes the BLAS root (the caller descends without a pop).  Returns 1
// after an instance entry, 2 after RESTORE, 0 for a node or leaf entry.
PT_HD int instance_entry(const Tree& tr, const WalkRay& w, WalkRay& cur,
                         int& e, int* stack, int& sp, bool& ok) {
  if (e == RESTORE) {
    cur = w;
    return 2;
  }
  if (e <= SLIM_EMPTY) return 0;
  int k = e - SLIM_EMPTY - 1;
  k = k < 0 ? 0 : (k > tr.num_inst - 1 ? tr.num_inst - 1 : k);
  const float* m = tr.inst_inv + 12 * k;
  const float ox = w.ox, oy = w.oy, oz = w.oz;
  const float dx = w.dx, dy = w.dy, dz = w.dz;
  cur.ox = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
  cur.oy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
  cur.oz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
  cur.dx = m[0] * dx + m[1] * dy + m[2] * dz;
  cur.dy = m[4] * dx + m[5] * dy + m[6] * dz;
  cur.dz = m[8] * dx + m[9] * dy + m[10] * dz;
  cur.sr = slab_ray(cur.ox, cur.oy, cur.oz, cur.dx, cur.dy, cur.dz);
  cur.iid = k;
  if (sp < PT_STACK) {
    stack[sp++] = RESTORE;
  } else {
    ok = false;
  }
  e = ld(tr.inst_root + k);
  return 1;
}

// Closest hit over a shading tree (_emit_traversal, any_hit=False):
// h.t starts at the ray's t_init; on a hit h holds t, original triangle
// id, object, flat normal and instance.  A hit replaces the current one
// when it is strictly nearer (the strict accept of _leaf_tests) or, at
// exactly the same t, has the lower original id (then the lower
// instance): exact ties (a ray through a shared vertex or edge) then
// resolve as the brute-force oracle resolves them, whatever order the
// walk visits the leaves in, so hits are bitwise the oracle's on every
// ray.  With kInst the walk runs the instance machinery; with kDepth it
// counts into *depth the node rows at which a child passed the push test
// (instance entries and RESTORE are no node rows; a BLAS root is).
// With kVar the walk reads the tree's layout (push_node, var_*; never
// with kInst).  Returns false on a stack overflow.
template <bool kInst = false, bool kDepth = false, bool kVar = false>
PT_HD bool closest_hit(const Tree& tr, float ox, float oy, float oz,
                       float dx, float dy, float dz, Hit& h,
                       unsigned long long& it_node,
                       unsigned long long& it_leaf, int* depth = nullptr) {
  static_assert(!(kInst && kVar), "the instance arms walk 64-col rows");
  const WalkRay w = world_ray(ox, oy, oz, dx, dy, dz);
  WalkRay cur = w;
  int stack[kVar ? PT_STACK_W16 : PT_STACK];
  int sp = 0;
  bool ok = true;
  for (int i = 1; i < tr.nroots; ++i) stack[sp++] = tr.roots[i];
  int e = tr.roots[0];
  for (;;) {
    if (kInst && instance_entry(tr, w, cur, e, stack, sp, ok) == 1) continue;
    if (kInst && e == RESTORE) {
      // the world ray is back; pop below
    } else if (kVar ? var_is_node(tr, e) : e >= 0) {
      ++it_node;
      if (tr.seen_node) tr.seen_node[e] = 1;
      if constexpr (kVar) {
        ok &= push_node<kDepth>(tr, e, cur.sr, h.t, true, stack, sp, depth);
      } else {
        ok &= push_children<kDepth>(tr.nodes + (size_t)e * 64, cur.sr, h.t,
                                    true, stack, sp, depth);
      }
    } else {
      ++it_leaf;
      if (tr.seen_leaf) tr.seen_leaf[kVar ? var_leaf_row(tr, e) : -e - 1] = 1;
      const float* row =
          kVar ? var_leaf(tr, e) : tr.ltris + (size_t)(-e - 1) * 128;
#pragma unroll 2
      for (int c = 0; c < LEAF_TRIS; ++c) {
        const float* r = row + 16 * c;
        F4 a = ld4(r), b = ld4(r + 4), d4 = ld4(r + 8), p = ld4(r + 12);
        float tt = tri_test(cur.ox, cur.oy, cur.oz, cur.dx, cur.dy, cur.dz,
                            a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, d4.x);
        const int id = as_int(p.y);
        const bool tie = tt == h.t && (id < h.tri ||
                                       (kInst && id == h.tri && cur.iid < h.iid));
        if (tt >= 0.0f && (tt < h.t || tie)) {
          h.t = tt;
          h.tri = id;
          h.obj = as_int(p.x);
          h.nx = d4.y;
          h.ny = d4.z;
          h.nz = d4.w;
          h.iid = cur.iid;
        }
      }
    }
    if (sp == 0) break;
    e = stack[--sp];
  }
  return ok;
}

// Any hit with t < tmax over an occlusion tree (14 bare records per leaf
// row) or a shading tree (8 records of 16 cols).  Sets `occluded`; with
// kReport (shading trees only) also writes the record it found into
// `found` (t, original id, object, flat normal, instance).  With kInst
// the walk runs the instance machinery; kDepth counts as in closest_hit,
// up to the row that ends the walk; kVar reads the tree's layout.
// Returns false on a stack overflow.
template <bool kReport = false, bool kInst = false, bool kDepth = false,
          bool kVar = false>
PT_HD bool any_hit(const Tree& tr, float ox, float oy, float oz, float dx,
                   float dy, float dz, float tmax, bool& occluded,
                   unsigned long long& it_node, unsigned long long& it_leaf,
                   Hit* found = nullptr, int* depth = nullptr) {
  static_assert(!(kInst && kVar), "the instance arms walk 64-col rows");
  const WalkRay w = world_ray(ox, oy, oz, dx, dy, dz);
  WalkRay cur = w;
  int stack[kVar ? PT_STACK_W16 : PT_STACK];
  int sp = 0;
  bool ok = true;
  occluded = false;
  for (int i = 1; i < tr.nroots; ++i) stack[sp++] = tr.roots[i];
  int e = tr.roots[0];
  for (;;) {
    if (kInst && instance_entry(tr, w, cur, e, stack, sp, ok) == 1) continue;
    if (kInst && e == RESTORE) {
      // the world ray is back; pop below
    } else if (kVar ? var_is_node(tr, e) : e >= 0) {
      ++it_node;
      if (tr.seen_node) tr.seen_node[e] = 1;
      if constexpr (kVar) {
        ok &= push_node<kDepth>(tr, e, cur.sr, tmax, false, stack, sp, depth);
      } else {
        ok &= push_children<kDepth>(tr.nodes + (size_t)e * 64, cur.sr, tmax,
                                    false, stack, sp, depth);
      }
    } else {
      ++it_leaf;
      if (tr.seen_leaf) tr.seen_leaf[kVar ? var_leaf_row(tr, e) : -e - 1] = 1;
      const float* row =
          kVar ? var_leaf(tr, e) : tr.ltris + (size_t)(-e - 1) * 128;
      const int ntri = tr.occl ? OCCL_TRIS : LEAF_TRIS;
      const int stride = tr.occl ? OCCL_STRIDE : 16;
      for (int c = 0; c < ntri; ++c) {
        const float* r = row + stride * c;
        float tt = tri_test(cur.ox, cur.oy, cur.oz, cur.dx, cur.dy, cur.dz,
                            ld(r), ld(r + 1), ld(r + 2), ld(r + 3), ld(r + 4),
                            ld(r + 5), ld(r + 6), ld(r + 7), ld(r + 8));
        if (tt >= 0.0f && tt < tmax) {
          occluded = true;
          if constexpr (kReport) {
            found->t = tt;
            found->tri = as_int(ld(r + 13));
            found->obj = as_int(ld(r + 12));
            found->nx = ld(r + 9);
            found->ny = ld(r + 10);
            found->nz = ld(r + 11);
            found->iid = cur.iid;
          }
          return ok;
        }
      }
    }
    if (sp == 0) break;
    e = stack[--sp];
  }
  return ok;
}

// ---- analytic primitives (megakernel._analytic_tests) ---------------------

// sphere s: hit distance ts or +inf (the shared predicate of the closest
// and the occlusion tests)
PT_HD float sphere_t(const float* s, float ox, float oy, float oz, float dx,
                     float dy, float dz) {
  float elx = s[0] - ox, ely = s[1] - oy, elz = s[2] - oz;
  float rsq = s[S_RSQ];
  float tca = elx * dx + ely * dy + elz * dz;
  float d2 = (elx * elx + ely * ely + elz * elz) - tca * tca;
  float thc = sqrtf(fmaxf(rsq - d2, 0.0f));
  float t0 = tca - thc;
  float t1 = tca + thc;
  float ts = t0 < 0.0f ? t1 : t0;
  bool vs = tca >= 0.0f && d2 <= rsq && ts >= 0.0f;
  return vs ? ts : INF_F;
}

PT_HD float plane_t(const float* p, float ox, float oy, float oz, float dx,
                    float dy, float dz) {
  float denom = dx * p[3] + dy * p[4] + dz * p[5];
  bool den_ok = fabsf(denom) > PLANE_DENOM_EPS;
  float tp = ((p[0] - ox) * p[3] + (p[1] - oy) * p[4] + (p[2] - oz) * p[5]) /
             (den_ok ? denom : 1.0f);
  return (den_ok && tp > 0.0f) ? tp : INF_F;
}

// kind: 0 = mesh/miss, 1 + s = sphere s, 1 + S + p = plane p
PT_HD void analytic_tests(const Tables& tb, float ox, float oy, float oz,
                          float dx, float dy, float dz, float& t, int& kind) {
  if (tb.num_sph) {
    float best = INF_F;
    int bj = 0;
    for (int s = 0; s < tb.num_sph; ++s) {
      float ts = sphere_t(tb.sph + S_COLS * s, ox, oy, oz, dx, dy, dz);
      if (ts < t && ts < best) {
        best = ts;
        bj = s;
      }
    }
    if (best < INF_F) {  // jnp.isfinite(best): best is +inf or a hit
      t = best;
      kind = 1 + bj;
    }
  }
  if (tb.num_pln) {
    float best = INF_F;
    int bj = 0;
    for (int p = 0; p < tb.num_pln; ++p) {
      float tp = plane_t(tb.pln + P_COLS * p, ox, oy, oz, dx, dy, dz);
      if (tp < t && tp < best) {
        best = tp;
        bj = p;
      }
    }
    if (best < INF_F) {  // jnp.isfinite(best): best is +inf or a hit
      t = best;
      kind = 1 + tb.num_sph + bj;
    }
  }
}

// analytic occluders of a shadow ray (_analytic_occluded_nee)
PT_HD bool analytic_occluded(const Tables& tb, float ox, float oy, float oz,
                             float dx, float dy, float dz, float tmax) {
  for (int s = 0; s < tb.num_sph; ++s) {
    if (sphere_t(tb.sph + S_COLS * s, ox, oy, oz, dx, dy, dz) < tmax) return true;
  }
  for (int p = 0; p < tb.num_pln; ++p) {
    if (plane_t(tb.pln + P_COLS * p, ox, oy, oz, dx, dy, dz) < tmax) return true;
  }
  return false;
}

// ---- shading (megakernel._shade_surface) ----------------------------------

struct Path {  // the per-lane carry between depths
  float ox, oy, oz, dx, dy, dz;
  uint32_t state;
  float tpx, tpy, tpz, enx, eny, enz;
  bool active;
  int spec;
};

struct Shadow {  // the NEE shadow ray and its premultiplied contribution
  bool sneed;
  float ox, oy, oz, dx, dy, dz, tmax, cr, cg, cb;
};

struct Mode {
  bool nee, rr, cosine, ref_pdf;
};

// One vertex of TracePathAdvanced on the closest hit `h` of the ray in
// `ps`: analytic tests, light-hit emission (NEE double-count guard),
// NEE light sample, Russian roulette, lobe selection, dielectric /
// Fresnel / Beer and the bounce.  Updates `ps`; returns the shadow ray.
PT_HD Shadow shade_surface(const Tables& tb, const Mode& md, Path& ps,
                           bool depth0, Hit h) {
  const float ox = ps.ox, oy = ps.oy, oz = ps.oz;
  const float dx = ps.dx, dy = ps.dy, dz = ps.dz;
  uint32_t state = ps.state;
  bool active = ps.active;
  const bool is_spec = ps.spec != 0;
  float t = h.t;
  int kind = 0;
  analytic_tests(tb, ox, oy, oz, dx, dy, dz, t, kind);

  bool hit_any = h.tri >= 0 || kind > 0;
  active = active && hit_any;

  // hit surface (GetRayHitResult, Main.cpp:325-338)
  float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
  float nx = h.nx, ny = h.ny, nz = h.nz;
  int mat_idx = (h.obj >= 1 && h.obj < tb.num_objs) ? tb.objmat[h.obj]
                                                    : tb.objmat[0];
  if (kind >= 1 && kind <= tb.num_sph) {
    int s = kind - 1;
    const float* sp = tb.sph + S_COLS * s;
    float vx = px - sp[0], vy = py - sp[1], vz = pz - sp[2];
    float l_s = sqrtf(vx * vx + vy * vy + vz * vz);
    nx = vx / l_s;
    ny = vy / l_s;
    nz = vz / l_s;
    mat_idx = tb.sphmat[s];
  } else if (kind > tb.num_sph) {
    int p = kind - 1 - tb.num_sph;
    const float* pp = tb.pln + P_COLS * p;
    nx = pp[3];
    ny = pp[4];
    nz = pp[5];
    mat_idx = tb.plnmat[p];
  }
  if (mat_idx < 0 || mat_idx >= tb.num_mats) mat_idx = 0;
  const float* M = tb.mats + M_COLS * mat_idx;
  const float alb_r = M[M_ALBEDO], alb_g = M[M_ALBEDO + 1], alb_b = M[M_ALBEDO + 2];
  const float m_spec = M[M_SPECULAR], m_refr = M[M_REFRACT], m_ior = M[M_IOR];
  const bool is_light = M[M_IS_LIGHT] > 0.5f;

  // light hit (Main.cpp:424-431)
  float tpx = ps.tpx, tpy = ps.tpy, tpz = ps.tpz;
  float enx = ps.enx, eny = ps.eny, enz = ps.enz;
  bool hit_light = active && is_light;
  bool add_em = md.nee ? (hit_light && (depth0 || is_spec)) : hit_light;
  if (add_em) {
    float inten = M[M_INTENSITY];
    enx = enx + tpx * M[M_EMISSIVE] * inten;
    eny = eny + tpy * M[M_EMISSIVE + 1] * inten;
    enz = enz + tpz * M[M_EMISSIVE + 2] * inten;
  }
  active = active && !hit_light;

  float dw = fmaxf(0.0f, 1.0f - m_spec - m_refr);
  float brdf_r = alb_r * INV_PI_F, brdf_g = alb_g * INV_PI_F,
        brdf_b = alb_b * INV_PI_F;

  Shadow sh = {false, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // NEE (Main.cpp:439-465; sample_light draw layout)
  if (md.nee) {
    bool do_nee = active && dw > 0.001f;
    state = xs32(state);
    int li = (int)(state % (uint32_t)tb.num_lights);
    const float* L = tb.lights + L_COLS * li;
    float lcx = L[L_CENTER], lcy = L[L_CENTER + 1], lcz = L[L_CENTER + 2];
    float lrad = L[L_RADIUS], larea = L[L_AREA];

    // random_point_sphere_facing (Source/Primitives.cpp:214-220)
    float tcx = px - lcx, tcy = py - lcy, tcz = pz - lcz;
    float l_tp = sqrtf(tcx * tcx + tcy * tcy + tcz * tcz);
    float fx = tcx / l_tp, fy = tcy / l_tp, fz = tcz / l_tp;
    state = xs32(state);
    float u1 = u2f(state);
    state = xs32(state);
    float u2 = u2f(state);
    float zz = 1.0f - 2.0f * u1;
    float rr_ = sqrtf(fmaxf(0.0f, 1.0f - zz * zz));
    float phi = TWO_PI_F * u2;
    float sx = rr_ * cosf(phi), sy = rr_ * sinf(phi), sz = zz;
    float flip = (sx * fx + sy * fy + sz * fz < 0.0f) ? -1.0f : 1.0f;
    sx = sx * flip;
    sy = sy * flip;
    sz = sz * flip;
    float lpx = lcx + lrad * sx, lpy = lcy + lrad * sy, lpz = lcz + lrad * sz;
    float r_d = fmaxf(lrad, 1e-20f);
    float lnx = (lpx - lcx) / r_d, lny = (lpy - lcy) / r_d, lnz = (lpz - lcz) / r_d;
    state = xs32(state);
    if (tb.mesh_lights) {
      // mesh-light arm: uniform triangle of the picked light, fold-sampled
      int st = tb.ltmeta[2 * li], cnt = tb.ltmeta[2 * li + 1];
      int ti = cnt ? st + (int)(state % (uint32_t)cnt) : 0;
      state = xs32(state);
      float u0m = u2f(state);
      state = xs32(state);
      float u1m = u2f(state);
      bool over = (u0m + u1m) > 1.0f;
      float alpha = over ? 1.0f - u0m : u0m;
      float beta = over ? 1.0f - u1m : u1m;
      float gamma = 1.0f - alpha - beta;
      const float* T = tb.ltri + LT_COLS * ti;
      if (!(L[L_IS_SPHERE] > 0.5f)) {
        lpx = alpha * T[0] + beta * T[3] + gamma * T[6];
        lpy = alpha * T[1] + beta * T[4] + gamma * T[7];
        lpz = alpha * T[2] + beta * T[5] + gamma * T[8];
        lnx = T[9];
        lny = T[10];
        lnz = T[11];
      }
    } else {
      // stream-layout dummies (sample_light's no-mesh-light arm)
      state = xs32(state);
      state = xs32(state);
    }

    float tlx = lpx - px, tly = lpy - py, tlz = lpz - pz;
    float dist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
    float d_d = fmaxf(dist, 1e-20f);
    tlx = tlx / d_d;
    tly = tly / d_d;
    tlz = tlz / d_d;
    float ndotl = nx * tlx + ny * tly + nz * tlz;
    float nldotl = -(lnx * tlx + lny * tly + lnz * tlz);
    bool sneed = do_nee && ndotl > 0.0f && nldotl > 0.0f;
    if (sneed) {
      float solid = (nldotl * larea) / fmaxf(dist * dist, 1e-20f);
      float s_ = ndotl * solid;
      float nl_f = (float)tb.num_lights;
      sh.sneed = true;
      sh.cr = tpx * s_ * brdf_r * L[L_EMISSION] * nl_f * dw;
      sh.cg = tpy * s_ * brdf_g * L[L_EMISSION + 1] * nl_f * dw;
      sh.cb = tpz * s_ * brdf_b * L[L_EMISSION + 2] * nl_f * dw;
      sh.ox = px + tlx * RAY_NUDGE;
      sh.oy = py + tly * RAY_NUDGE;
      sh.oz = pz + tlz * RAY_NUDGE;
      sh.dx = tlx;
      sh.dy = tly;
      sh.dz = tlz;
      sh.tmax = dist - TWO_NUDGE;
    }
  }

  // Russian roulette (Main.cpp:468-475)
  if (md.rr) {
    float surv = fminf(fmaxf(fmaxf(fmaxf(alb_r, alb_g), alb_b), 0.1f), 1.0f);
    state = xs32(state);
    float r_rr = u2f(state);
    active = active && !(surv < r_rr);
    if (active) {
      tpx = tpx / surv;
      tpy = tpy / surv;
      tpz = tpz / surv;
    }
  }

  // lobe selection (Main.cpp:478-570)
  state = xs32(state);
  float r_lobe = u2f(state);
  bool sel_spec = active && r_lobe < m_spec;
  bool sel_diel = active && !sel_spec && r_lobe < m_spec + m_refr;
  bool sel_diff = active && !sel_spec && !sel_diel;

  float ddn = dx * nx + dy * ny + dz * nz;
  float rfx = dx - 2.0f * nx * ddn;
  float rfy = dy - 2.0f * ny * ddn;
  float rfz = dz - 2.0f * nz * ddn;

  float cosi_raw = fminf(fmaxf(ddn, -1.0f), 1.0f);
  bool outside = cosi_raw < 0.0f;
  bool inside = !outside;
  float cosi = fabsf(cosi_raw);
  float etai = outside ? 1.0f : m_ior;
  float etat = outside ? m_ior : 1.0f;
  float nrx = outside ? nx : -nx, nry = outside ? ny : -ny, nrz = outside ? nz : -nz;
  float eta = etai / etat;
  float kk = 1.0f - eta * eta * (1.0f - cosi * cosi);
  bool tir = kk < 0.0f;
  float coef = eta * cosi - sqrtf(fmaxf(kk, 0.0f));
  float rx = dx * eta + coef * nrx;
  float ry = dy * eta + coef * nry;
  float rz = dz * eta + coef * nrz;
  float l_r = sqrtf(rx * rx + ry * ry + rz * rz);
  rx = rx / l_r;
  ry = ry / l_r;
  rz = rz / l_r;
  float angle_in = ddn;
  float angle_out = rx * nx + ry * ny + rz * nz;
  float s_pol = (etai * angle_in - etat * angle_out) / (etai * angle_in + etat * angle_out);
  float p_pol = (etai * angle_out - etat * angle_in) / (etai * angle_out + etat * angle_in);
  float fr = 0.5f * (s_pol * s_pol + p_pol * p_pol);
  if (tir) fr = 1.0f;
  state = xs32(state);
  float r_fr = u2f(state);
  bool choose_refract = r_fr > fr;

  // diffuse bounce (Main.cpp:548-568)
  state = xs32(state);
  float du1 = u2f(state);
  state = xs32(state);
  float du2 = u2f(state);
  float dzz = 1.0f - 2.0f * du1;
  float rr2 = sqrtf(fmaxf(0.0f, 1.0f - dzz * dzz));
  float dphi = TWO_PI_F * du2;
  float ux = rr2 * cosf(dphi), uy = rr2 * sinf(dphi), uz = dzz;
  float dfx, dfy, dfz, weight;
  if (md.cosine) {
    // normalize_safe(normal + d, fallback=normal)
    float wx = nx + ux, wy = ny + uy, wz = nz + uz;
    float len_sq = wx * wx + wy * wy + wz * wz;
    bool ok_l = len_sq > 1e-20f;
    float scale_l = ok_l ? rsqrt_f(fmaxf(len_sq, 1e-20f)) : 0.0f;
    dfx = ok_l ? wx * scale_l : nx;
    dfy = ok_l ? wy * scale_l : ny;
    dfz = ok_l ? wz * scale_l : nz;
    float ndotr = dfx * nx + dfy * ny + dfz * nz;
    weight = md.ref_pdf ? ndotr / INV_TWO_PI_F
                        : ndotr / (fmaxf(ndotr, 1e-6f) / PI_F);
  } else {
    float fl2 = (ux * nx + uy * ny + uz * nz < 0.0f) ? -1.0f : 1.0f;
    dfx = ux * fl2;
    dfy = uy * fl2;
    dfz = uz * fl2;
    float ndotr = dfx * nx + dfy * ny + dfz * nz;
    weight = md.ref_pdf ? ndotr / (fmaxf(ndotr, 1e-6f) / PI_F)
                        : ndotr / INV_TWO_PI_F;
  }

  bool diel_bounce = sel_diel && !tir;
  bool diel_refract = diel_bounce && choose_refract;
  bool diel_reflect = diel_bounce && !choose_refract;

  float ndx = dx, ndy = dy, ndz = dz;
  if (sel_spec || diel_reflect) {
    ndx = rfx;
    ndy = rfy;
    ndz = rfz;
  }
  if (diel_refract) {
    ndx = rx;
    ndy = ry;
    ndz = rz;
  }
  if (sel_diff) {
    ndx = dfx;
    ndy = dfy;
    ndz = dfz;
  }

  float tm_r = 1.0f, tm_g = 1.0f, tm_b = 1.0f;
  if (sel_spec || diel_reflect || diel_refract) {
    tm_r = alb_r;
    tm_g = alb_g;
    tm_b = alb_b;
  }
  if (diel_refract && inside) {
    // Beer's-law absorption on medium exit (Main.cpp:524-532)
    tm_r = alb_r * expf(-M[M_ABSORB] * t);
    tm_g = alb_g * expf(-M[M_ABSORB + 1] * t);
    tm_b = alb_b * expf(-M[M_ABSORB + 2] * t);
  }
  if (sel_diff) {
    tm_r = weight * brdf_r;
    tm_g = weight * brdf_g;
    tm_b = weight * brdf_b;
  }
  tpx = tpx * tm_r;
  tpy = tpy * tm_g;
  tpz = tpz * tm_b;

  bool bounced = sel_spec || diel_bounce || sel_diff;
  int spec = (sel_spec || diel_bounce) ? 1 : ps.spec;
  if (sel_diff) spec = 0;
  if (bounced) {
    ps.ox = px + ndx * RAY_NUDGE;
    ps.oy = py + ndy * RAY_NUDGE;
    ps.oz = pz + ndz * RAY_NUDGE;
    ps.dx = ndx;
    ps.dy = ndy;
    ps.dz = ndz;
  }
  ps.state = state;
  ps.tpx = tpx;
  ps.tpy = tpy;
  ps.tpz = tpz;
  ps.enx = enx;
  ps.eny = eny;
  ps.enz = enz;
  ps.active = active;
  ps.spec = spec;
  return sh;
}

// ---- one path vertex, shared by every kernel of the ADVANCED mode ---------
//
// pt_frame runs extend + unoccluded + add_light for every depth of a lane
// in one launch; the per-depth pipeline runs extend in shade_extend and
// unoccluded + add_light in shadow_resolve, with the shadow ray passed
// through memory as f32 columns.  Both routes thus do the same
// operations in the same order and give bitwise the same energy, state
// and traced counts.

// One depth of a live path: the closest hit of its ray, then the shading
// body.  With kInst the hit's object-space normal first becomes
// normalize(inst_nrm @ n) (megakernel.py's instanced epilogue, the
// arithmetic of models/scene.hit_surface).  Updates `ps` and returns the
// NEE shadow ray (all zero unless sneed).  kVar: the variant walk.
// Clears `ok` on a stack overflow.
template <bool kInst = false, bool kVar = false>
PT_HD Shadow extend(const Tree& tree, const Tables& tb, const Mode& md,
                    Path& ps, bool depth0, Counters& cnt, bool& ok) {
  ++cnt.ray;
  Hit h = {RAY_TMAX, -1, -1, 0.0f, 0.0f, 0.0f, -1};
  ok &= closest_hit<kInst, false, kVar>(tree, ps.ox, ps.oy, ps.oz, ps.dx,
                                        ps.dy, ps.dz, h, cnt.node, cnt.leaf);
  if (kInst && h.iid >= 0) {
    const float* m = tree.inst_nrm + 9 * h.iid;
    const float n0 = h.nx, n1 = h.ny, n2 = h.nz;
    const float wx = ld(m) * n0 + ld(m + 1) * n1 + ld(m + 2) * n2;
    const float wy = ld(m + 3) * n0 + ld(m + 4) * n1 + ld(m + 5) * n2;
    const float wz = ld(m + 6) * n0 + ld(m + 7) * n1 + ld(m + 8) * n2;
    const float wl = sqrtf(wx * wx + wy * wy + wz * wz);
    if (wl > 0.0f) {
      h.nx = wx / wl;
      h.ny = wy / wl;
      h.nz = wz / wl;
    }
  }
  return shade_surface(tb, md, ps, depth0, h);
}

// The NEE shadow test of a shadow ray with sneed set: any hit over the
// any-hit tree, then the analytic occluders.  True when the light is
// visible.  kVar: the variant walk.  Clears `ok` on a stack overflow.
template <bool kInst = false, bool kVar = false>
PT_HD bool unoccluded(const Tree& sh_tree, const Tables& tb, const Shadow& sh,
                      Counters& cnt, bool& ok) {
  ++cnt.sray;
  bool occ = false;
  ok &= any_hit<false, kInst, false, kVar>(sh_tree, sh.ox, sh.oy, sh.oz,
                                           sh.dx, sh.dy, sh.dz, sh.tmax, occ,
                                           cnt.snode, cnt.sleaf);
  if (!occ) {
    occ = analytic_occluded(tb, sh.ox, sh.oy, sh.oz, sh.dx, sh.dy, sh.dz,
                            sh.tmax);
  }
  return !occ;
}

// The energy add of a visible light sample (Main.cpp:459-463).
PT_HD void add_light(float& enx, float& eny, float& enz, const Shadow& sh) {
  enx = enx + sh.cr;
  eny = eny + sh.cg;
  enz = enz + sh.cb;
}

// ---- per-lane columns ------------------------------------------------------

struct Params {
  Tree tree, sh_tree;
  const float* ray[6];     // ox oy oz dx dy dz, (n,) each
  const long long* state;  // (n,) u32 values in an int64 carrier
  const float* tp_in[3];   // carry-in throughput, or null (fresh paths)
  const float* en_in[3];   // carry-in energy
  const int* flags_in;     // carry-in active | spec << 1 (| sneed << 2)
  float* ray_out[6];       // carry-out rays, or null
  long long* state_out;
  float* tp_out[3];        // carry-out throughput
  float* en_out[3];
  int* flags_out;          // carry-out active | spec << 1 (| sneed << 2)
  int* tr_out;             // rays traced by the lane
  // shadow columns: origin xyz, direction xyz, tmax, contribution rgb;
  // written by shade_extend, read by shadow_resolve
  float* shadow[10];
  int n, depths, depth_base;  // shade_extend: depth_base = absolute depth
  Mode mode;
};

// A lane's path from the carry-in columns, or a fresh path (throughput
// 1, energy 0, active, not specular) when there are none.
PT_HD Path load_path(const Params& p, int lane) {
  Path ps;
  ps.ox = p.ray[0][lane];
  ps.oy = p.ray[1][lane];
  ps.oz = p.ray[2][lane];
  ps.dx = p.ray[3][lane];
  ps.dy = p.ray[4][lane];
  ps.dz = p.ray[5][lane];
  ps.state = (uint32_t)p.state[lane];
  if (p.tp_in[0]) {
    ps.tpx = p.tp_in[0][lane];
    ps.tpy = p.tp_in[1][lane];
    ps.tpz = p.tp_in[2][lane];
    ps.enx = p.en_in[0][lane];
    ps.eny = p.en_in[1][lane];
    ps.enz = p.en_in[2][lane];
    int fl = p.flags_in[lane];
    ps.active = (fl & 1) != 0;
    ps.spec = (fl >> 1) & 1;
  } else {
    ps.tpx = ps.tpy = ps.tpz = 1.0f;
    ps.enx = ps.eny = ps.enz = 0.0f;
    ps.active = true;
    ps.spec = 0;
  }
  return ps;
}

// State and energy out; with carry-out columns also rays, throughput and
// flags (plus bit 2 = sneed).
PT_HD void store_path(const Params& p, int lane, const Path& ps, bool sneed) {
  p.state_out[lane] = (long long)ps.state;
  p.en_out[0][lane] = ps.enx;
  p.en_out[1][lane] = ps.eny;
  p.en_out[2][lane] = ps.enz;
  if (p.ray_out[0]) {
    p.ray_out[0][lane] = ps.ox;
    p.ray_out[1][lane] = ps.oy;
    p.ray_out[2][lane] = ps.oz;
    p.ray_out[3][lane] = ps.dx;
    p.ray_out[4][lane] = ps.dy;
    p.ray_out[5][lane] = ps.dz;
    p.tp_out[0][lane] = ps.tpx;
    p.tp_out[1][lane] = ps.tpy;
    p.tp_out[2][lane] = ps.tpz;
    p.flags_out[lane] =
        (ps.active ? 1 : 0) | (ps.spec << 1) | (sneed ? 4 : 0);
  }
}

// ---- one lane of each kernel -----------------------------------------------

// pt_frame: every depth of one lane; the lane leaves the loop when its
// path dies (its RNG state then stays as it is).  kVar: both walks read
// their tree's layout.  Returns false on a stack overflow.
template <bool kVar = false>
PT_HD bool trace_lane(const Params& p, const Tables& tb, int lane,
                      Counters& cnt) {
  Path ps = load_path(p, lane);
  int tr = 0;
  bool ok = true;
  for (int d = 0; d < p.depths && ps.active; ++d) {
    tr += 1;
    Shadow sh = extend<false, kVar>(p.tree, tb, p.mode, ps,
                                    d + p.depth_base == 0, cnt, ok);
    if (sh.sneed) {
      tr += 1;
      if (unoccluded<false, kVar>(p.sh_tree, tb, sh, cnt, ok)) {
        add_light(ps.enx, ps.eny, ps.enz, sh);
      }
    }
  }
  store_path(p, lane, ps, false);
  p.tr_out[lane] = tr;
  return ok;
}

// shade_extend: one depth (p.depth_base, absolute) of one lane (kInst: on
// the instance machinery).  A lane
// that is not active passes its columns through with flags & 3 and zero
// shadow columns (the per-lane form of the Pallas kernel's dead-tile
// rule); a live lane writes its next ray and carry, flags with bit 2 =
// sneed, and its shadow ray (zero unless sneed, so tmax = sneed ? tmax :
// 0).  kVar: the variant walk.  Returns false on a stack overflow.
template <bool kInst = false, bool kVar = false>
PT_HD bool shade_extend_lane(const Params& p, const Tables& tb, int lane,
                             Counters& cnt) {
  Path ps = load_path(p, lane);
  Shadow sh = {false, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool ok = true;
  if (ps.active) {
    sh = extend<kInst, kVar>(p.tree, tb, p.mode, ps, p.depth_base == 0, cnt,
                             ok);
  }
  store_path(p, lane, ps, sh.sneed);
  const float cols[10] = {sh.ox, sh.oy, sh.oz, sh.dx, sh.dy,
                          sh.dz, sh.tmax, sh.cr, sh.cg, sh.cb};
#pragma unroll
  for (int c = 0; c < 10; ++c) p.shadow[c][lane] = cols[c];
  return ok;
}

// shadow_resolve: a lane with sneed (flags bit 2) runs the shadow test
// of its shadow ray over p.sh_tree (kInst: on the instance machinery)
// and adds the contribution when the light is visible; every other lane
// copies its energy.  kVar: the variant walk.  Returns false on a stack
// overflow.
template <bool kInst = false, bool kVar = false>
PT_HD bool shadow_resolve_lane(const Params& p, const Tables& tb, int lane,
                               Counters& cnt) {
  float enx = p.en_in[0][lane], eny = p.en_in[1][lane],
        enz = p.en_in[2][lane];
  bool ok = true;
  if ((p.flags_in[lane] >> 2) & 1) {
    Shadow sh;
    sh.sneed = true;
    sh.ox = p.shadow[0][lane];
    sh.oy = p.shadow[1][lane];
    sh.oz = p.shadow[2][lane];
    sh.dx = p.shadow[3][lane];
    sh.dy = p.shadow[4][lane];
    sh.dz = p.shadow[5][lane];
    sh.tmax = p.shadow[6][lane];
    sh.cr = p.shadow[7][lane];
    sh.cg = p.shadow[8][lane];
    sh.cb = p.shadow[9][lane];
    if (unoccluded<kInst, kVar>(p.sh_tree, tb, sh, cnt, ok)) {
      add_light(enx, eny, enz, sh);
    }
  }
  p.en_out[0][lane] = enx;
  p.en_out[1][lane] = eny;
  p.en_out[2][lane] = enz;
  return ok;
}

// ---- launch arguments (filled by ops/pt_frame.py through ctypes) ---------

// Field order and types mirror ops/pt_frame.py's _PtArgs ctypes structure.
struct PtArgs {
  const void* nodes;
  const void* ltris;
  const void* sh_nodes;
  const void* sh_ltris;
  const void* small;  // packed small tables, see small_layout
  const void* ray[6];
  const void* state;
  const void* tp_in[3];
  const void* en_in[3];
  const void* flags_in;
  void* ray_out[6];
  void* state_out;
  void* tp_out[3];
  void* en_out[3];
  void* flags_out;
  void* tr_out;
  void* hit_out[7];   // traverse: t, tri, obj, nx, ny, nz, iid (or null)
  void* depth_out;    // traverse: (n,) i32 bvh_depth (count_depth), or null
  const void* t_init;  // traverse: (n,) f32 per-lane t bound, or null
  const void* active;  // traverse: (n,) i32 lane mask, or null (all)
  void* shadow[10];   // Params::shadow: shade_extend out, shadow_resolve in
  void* iters;        // NUM_COUNTERS u64 work counters (Counters order), or null
  void* seen[4];      // u8 row bitmaps (Tree::seen_*): node, leaf, shadow
                      // node, shadow leaf rows; null unless counting
  // the instance machinery of both trees (Tree::inst_*), or null
  const void* inst_inv;
  const void* inst_nrm;
  const void* inst_root;
  // the entry side tables (B + V, 8) i32 of both trees, or null
  const void* ents;
  const void* sh_ents;
  void* status;       // i32, bit 0 set on a traversal stack overflow
  void* stream;
  int small_words;
  int mat_rows, light_rows, ltri_rows, sph_rows, pln_rows, obj_rows;
  int num_sph, num_pln, num_lights, nroots, sh_nroots, mesh_lights, sh_occl;
  int n, depths, depth_base, nee, rr, cosine, ref_pdf, any_hit, num_inst;
  // the node layout (Tree::fused_nn, width, cols; the shadow tree's
  // width and fused_nn are the closest-hit tree's unless sh_occl, when
  // it is 8-wide and split)
  int fused_nn, width, cols, sh_cols;
};

// True when a launch needs the variant walks (kVar): a side table, or
// node rows other than the plain 64-col, 8-wide, split ones.
PT_HD bool variant(const PtArgs& a) {
  return a.ents || a.sh_ents || a.fused_nn || a.width != 8 || a.cols != 64 ||
         a.sh_cols != 64;
}

// The layout of PtArgs as this compiler sees it: its size and the
// offsets of depth_out, ents and its last field, which ops/pt_frame.py
// holds against its ctypes mirror when it loads a build (a field out of
// step would shift every later one silently).
inline void args_layout(long long* out) {
  out[0] = (long long)sizeof(PtArgs);
  out[1] = (long long)offsetof(PtArgs, depth_out);
  out[2] = (long long)offsetof(PtArgs, ents);
  out[3] = (long long)offsetof(PtArgs, sh_cols);
}

// Word offsets of the packed small tables: mats (M, 14), lights (L, 10),
// light triangles (LT, 12), spheres (S, 6), planes (P, 7) as f32, then
// as i32 bits objmat (O), sphmat (S), plnmat (P), light_tri_meta (L, 2),
// closest-hit roots, shadow roots.
PT_HD int small_words(const PtArgs& a) {
  return a.mat_rows * M_COLS + a.light_rows * L_COLS + a.ltri_rows * LT_COLS +
         a.sph_rows * (S_COLS + 1) + a.pln_rows * (P_COLS + 1) + a.obj_rows +
         2 * a.light_rows + a.nroots + a.sh_nroots;
}

PT_HD void unpack(const PtArgs& a, const float* small, Tables& tb, Tree& tree,
                  Tree& sh_tree) {
  const float* f = small;
  tb.mats = f;
  tb.num_mats = a.mat_rows;
  f += a.mat_rows * M_COLS;
  tb.lights = f;
  tb.num_lights = a.num_lights;
  f += a.light_rows * L_COLS;
  tb.ltri = f;
  f += a.ltri_rows * LT_COLS;
  tb.sph = f;
  tb.num_sph = a.num_sph;
  f += a.sph_rows * S_COLS;
  tb.pln = f;
  tb.num_pln = a.num_pln;
  f += a.pln_rows * P_COLS;
  const int* w = reinterpret_cast<const int*>(f);
  tb.objmat = w;
  tb.num_objs = a.obj_rows;
  w += a.obj_rows;
  tb.sphmat = w;
  w += a.sph_rows;
  tb.plnmat = w;
  w += a.pln_rows;
  tb.ltmeta = w;
  tb.mesh_lights = a.mesh_lights;
  w += 2 * a.light_rows;
  unsigned char* const* seen = reinterpret_cast<unsigned char* const*>(a.seen);
  const float* inv = static_cast<const float*>(a.inst_inv);
  const float* nrm = static_cast<const float*>(a.inst_nrm);
  const int* iroot = static_cast<const int*>(a.inst_root);
  tree = {static_cast<const float*>(a.nodes), static_cast<const float*>(a.ltris),
          w, a.nroots, false, seen[0], seen[1], inv, nrm, iroot, a.num_inst,
          static_cast<const int*>(a.ents), a.cols, a.width, a.fused_nn};
  w += a.nroots;
  sh_tree = {static_cast<const float*>(a.sh_nodes),
             static_cast<const float*>(a.sh_ltris), w, a.sh_nroots,
             a.sh_occl != 0, seen[2], seen[3], inv, nrm, iroot, a.num_inst,
             static_cast<const int*>(a.sh_ents), a.sh_cols,
             a.sh_occl ? 8 : a.width, a.sh_occl ? 0 : a.fused_nn};
}

PT_HD Params make_params(const PtArgs& a, const Tree& tree,
                         const Tree& sh_tree) {
  Params p;
  p.tree = tree;
  p.sh_tree = sh_tree;
  for (int c = 0; c < 6; ++c) {
    p.ray[c] = static_cast<const float*>(a.ray[c]);
    p.ray_out[c] = static_cast<float*>(a.ray_out[c]);
  }
  for (int c = 0; c < 3; ++c) {
    p.tp_in[c] = static_cast<const float*>(a.tp_in[c]);
    p.en_in[c] = static_cast<const float*>(a.en_in[c]);
    p.tp_out[c] = static_cast<float*>(a.tp_out[c]);
    p.en_out[c] = static_cast<float*>(a.en_out[c]);
  }
  for (int c = 0; c < 10; ++c) p.shadow[c] = static_cast<float*>(a.shadow[c]);
  p.state =static_cast<const long long*>(a.state);
  p.flags_in = static_cast<const int*>(a.flags_in);
  p.state_out = static_cast<long long*>(a.state_out);
  p.flags_out = static_cast<int*>(a.flags_out);
  p.tr_out = static_cast<int*>(a.tr_out);
  p.n = a.n;
  p.depths = a.depths;
  p.depth_base = a.depth_base;
  p.mode = {a.nee != 0, a.rr != 0, a.cosine != 0, a.ref_pdf != 0};
  return p;
}

// One lane of traverse_packet_slim: over the closest-hit tree, the
// nearest hit closer than the lane's t_init (closest_hit's exact-tie rule
// included) or, with any_hit, the first one the walk finds; with kInst on
// the instance machinery, the hit's instance (the 7th output column) and
// its normal in object space.  A lane that is not active, and a lane
// that hits nothing, writes t_init, ids -1 and a zero normal.  Without
// t_init / active columns every lane is active with t_init = RAY_TMAX
// (the closest-hit test of ops/pt_frame.py).  With kDepth (count_depth:
// a.depth_out set) the lane also writes its walk's bvh_depth, 0 when it
// is not active.  kVar: the variant walk.
template <bool kInst = false, bool kDepth = false, bool kVar = false>
PT_HD bool traverse_lane(const PtArgs& a, const Tree& tree, int lane,
                         Counters& cnt) {
  const float* const* r = reinterpret_cast<const float* const*>(a.ray);
  const float t0 =
      a.t_init ? static_cast<const float*>(a.t_init)[lane] : RAY_TMAX;
  const bool act = !a.active || static_cast<const int*>(a.active)[lane] != 0;
  Hit h = {t0, -1, -1, 0.0f, 0.0f, 0.0f, -1};
  int depth = 0;
  bool ok = true;
  if (act) {
    ++cnt.ray;
    if (a.any_hit) {
      bool occ = false;
      ok = any_hit<true, kInst, kDepth, kVar>(
          tree, r[0][lane], r[1][lane], r[2][lane], r[3][lane], r[4][lane],
          r[5][lane], t0, occ, cnt.node, cnt.leaf, &h, &depth);
    } else {
      ok = closest_hit<kInst, kDepth, kVar>(tree, r[0][lane], r[1][lane],
                                            r[2][lane], r[3][lane],
                                            r[4][lane], r[5][lane], h,
                                            cnt.node, cnt.leaf, &depth);
    }
  }
  if constexpr (kDepth) static_cast<int*>(a.depth_out)[lane] = depth;
  static_cast<float*>(a.hit_out[0])[lane] = h.t;
  static_cast<int*>(a.hit_out[1])[lane] = h.tri;
  static_cast<int*>(a.hit_out[2])[lane] = h.obj;
  static_cast<float*>(a.hit_out[3])[lane] = h.nx;
  static_cast<float*>(a.hit_out[4])[lane] = h.ny;
  static_cast<float*>(a.hit_out[5])[lane] = h.nz;
  if (a.hit_out[6]) static_cast<int*>(a.hit_out[6])[lane] = h.iid;
  return ok;
}

}  // namespace pt
