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
// bit-equal to the brute-force oracle on every ray, thanks to three rules
// that _emit_traversal lacks: an exact tie in t goes to the lower original
// triangle id (closest_hit), the slab of a zero direction component
// includes the box's faces (zero_slab), and the slab test is conservative
// by 1 + 2 gamma_3 (slab_hit), so a ray grazing a flat box's edge keeps
// the box.  Transcendentals (sinf, cosf,
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
// only, and compile as they did before the variants.  The leaf arms
// (kLeaf, variant walks only) read the occlusion tree's leaves of the JAX
// package's CPUGPU_LEAF14 and CPUGPU_OCCL2: a closest hit over the
// 14-record occlusion rows with the id, object and normal from a payload
// row at the same offset (Tree::pay), and an any hit over leaves of two
// rows (28 records).  The 16-wide occlusion rows of CPUGPU_OCCL_W16 are
// the variant walks' 16-wide rows.  The TLAS instance
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
// floats in a leaf row of every leaf table (shading, occlusion, fused)
constexpr int LEAF_COLS = 128;
// the leaf layout of a walk (template argument kLeaf): kLeafShade reads
// the rows Tree::occl names (8 shading records of 16 cols, or 14 bare
// occlusion records of 9 cols); kLeafOccl / kLeafOccl2 read occlusion
// leaves of one / two rows (bvh8.to_slim_occl rows_per_leaf: leaf entry
// -(k + 1) owns rows R k .. R k + R - 1)
constexpr int kLeafShade = 0, kLeafOccl = 1, kLeafOccl2 = 2;
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

// Element i of a lane column, read (col_ld) or written (col_st); with kCs
// as streaming traffic (ld.global.cs / st.global.cs: the lines are the
// first to leave the caches, so a launch's columns, read and written
// once, do not push the tree's rows out of L2).  The host build reads
// and writes plainly.
template <bool kCs, typename T>
PT_HD T col_ld(const T* p, int i) {
#ifdef __CUDA_ARCH__
  if constexpr (kCs) return __ldcs(p + i);
#endif
  return p[i];
}

template <bool kCs, typename T>
PT_HD void col_st(T* p, int i, T v) {
#ifdef __CUDA_ARCH__
  if constexpr (kCs) {
    __stcs(p + i, v);
    return;
  }
#endif
  p[i] = v;
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
  // the leaf-14 payload rows (NO, 128) parallel to the occlusion leaf
  // rows (bvh8.occl_payload: [nx, ny, nz, obj, id] at each record's
  // offset), read by the closest hit of the leaf arms; null otherwise
  const float* pay;
  // with count_iters: one byte per payload record (row * OCCL_TRIS +
  // record), set to 1 when the leaf-14 closest hit reads its payload (a
  // record that passes the triangle test); else null
  unsigned char* seen_pay;
  // with count_iters: the launch's warp trips and lane trips of the walk
  // loops of pt_frame and traverse (count_trip, count_trip_vote), shared
  // by both trees; else null
  unsigned long long* trips;
};

struct Counters {  // work done: node / leaf rows visited, rays traversed
  unsigned long long node = 0, leaf = 0, snode = 0, sleaf = 0, ray = 0,
                     sray = 0;
  // shadow_resolve's count arm: the most rows one shadow ray's walk
  // visited (the launch's longest walk; a maximum, not a sum); the
  // Whitted kernel's: the most live depths of one lane
  unsigned long long longest = 0;
};
// the summed counts (node .. sray); the count arms' iters then hold the
// warp and lane trips (Tree::trips) and the longest walk
constexpr int NUM_COUNTERS = 6;

// One trip of a walk loop under count_iters (trips non-null): a warp trip
// counted once by the lowest lane of __activemask(), a lane trip once per
// active lane (the lowest lane adds the mask's population), so that lane
// trips / (32 warp trips) is the share of a warp's lanes that work in a
// trip.  The host build runs one lane at a time: a warp of one lane.  Only
// pt_frame's and traverse's walks count, and only in the kernel arm of
// their count launches (kTrips): even untaken, the check and the warp
// intrinsic in the loop slowed the walk on the card (PERF.md).
PT_HD void count_trip(unsigned long long* trips) {
  if (!trips) return;
#ifdef __CUDA_ARCH__
  const unsigned m = __activemask();
  if ((threadIdx.x & 31u) == (unsigned)(__ffs(m) - 1)) {
    atomicAdd(trips, 1ull);
    atomicAdd(trips + 1, (unsigned long long)__popc(m));
  }
#else
  trips[0] += 1;
  trips[1] += 1;
#endif
}

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

// The conservative slab test (Ize, "Robust BVH Ray Traversal", JCGT
// 2(2), 2013): whether a ray whose entry and exit distances of a child
// box are tmin and tmax enters it before t (at t too when at_t) in front
// of its origin.  tmax and t are widened by 1 + 2 gamma_3 (gamma_n = n u
// / (1 - n u), u = 2^-24; 1 + 3 * 2^-23 in f32) before the compares: each
// plane distance (b - o) * inv carries up to three roundings, and without
// the margin a ray that grazes the edge of a flat box (the ground quad's
// box has zero height) can find tmax < tmin by one rounding while the
// triangle test accepts the hit.  The margin only adds visits: hits stay
// the triangle test's, so they can only move toward brute force.  Every
// walk of the port takes its slab passes from here (the labs'
// lab_device.cuh slab_pass, ops/pt_frame.py slab_pass).
constexpr float SLAB_PAD = 0x1.000006p+0f;

PT_HD bool slab_hit(float tmin, float tmax, float t, bool at_t) {
  const float hi = tmax * SLAB_PAD, tp = t * SLAB_PAD;
  const bool before = tmin < tp || (at_t && tmin == tp);
  return hi >= tmin && before && tmax > 0.0f;
}

// The slab test of one child box c (min xyz, max xyz): whether the ray
// enters it before t (at t too when at_t; slab_hit).
PT_HD bool slab_child(const float* c, const SlabRay& r, float t, bool at_t) {
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
  return slab_hit(tmin, tmax, t, at_t);
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
    if (slab_child(b + 6 * k, r, t, at_t) && ent[k] != SLIM_EMPTY) {
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

// Where a node row's child slots lie: slot k's six bounds (min xyz, max
// xyz) at bnd + 6k, its entry at ent[k], for k < width (a 16-wide row's
// slots 8..15 fill its second 48 floats).  The plain walks' rows have 64
// cols, the entries at cols 48..55; a variant layout (kVar) reads
// Tree::cols and width, the entries after the bounds in the row or in
// the side table ents (8 a row).  Every walk's node step reads a row
// through it.
struct NodeSlots {
  const float* bnd;
  const int* ent;
  int width;
};

template <bool kVar>
PT_HD NodeSlots node_slots(const Tree& tr, int e) {
  if constexpr (!kVar) {
    const float* row = tr.nodes + (size_t)e * 64;
    return {row, reinterpret_cast<const int*>(row + 48), 8};
  }
  const float* row = tr.nodes + (size_t)e * tr.cols;
  const int* ent = tr.ents ? tr.ents + (size_t)e * 8
                           : reinterpret_cast<const int*>(row + 6 * tr.width);
  return {row, ent, tr.width};
}

// A walk's node step of row `e` (node_slots): one block of 8 slots, two
// for a 16-wide row (slots 0..7, then 8..15, so children are pushed in
// slot order), onto a stack of PT_STACK entries (PT_STACK_W16 with kVar).
// With kDepth adds 1 to *depth when at least one child passes (the
// per-ray reading of the Pallas kernel's `depth += any(bm[k])`).  Returns
// false if the stack is full.
template <bool kDepth, bool kVar>
PT_HD bool push_node(const Tree& tr, int e, const SlabRay& r, float t,
                     bool at_t, int* stack, int& sp, int* depth) {
  constexpr int kCap = kVar ? PT_STACK_W16 : PT_STACK;
  const NodeSlots s = node_slots<kVar>(tr, e);
  bool passed = false;
  bool ok = push_row<kCap>(s.bnd, s.ent, r, t, at_t, stack, sp, passed);
  if (kVar && s.width == 16) {
    ok &= push_row<kCap>(s.bnd + 48, s.ent + 8, r, t, at_t, stack, sp,
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
  return tr.fused_nn ? tr.nodes + (size_t)e * LEAF_COLS
                     : tr.ltris + (size_t)(-e - 1) * LEAF_COLS;
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

// Rows per leaf of a leaf arm's occlusion leaves.
template <int kLeaf>
constexpr int kOcclRows = kLeaf == kLeafOccl2 ? 2 : 1;

// The first leaf row of occlusion leaf entry e under a leaf arm, with
// every row of the leaf marked in seen_leaf.
template <int kLeaf>
PT_HD int occl_leaf_row(const Tree& tr, int e) {
  const int r0 = kOcclRows<kLeaf> * (-e - 1);
  if (tr.seen_leaf) {
    for (int q = 0; q < kOcclRows<kLeaf>; ++q) tr.seen_leaf[r0 + q] = 1;
  }
  return r0;
}

// The rows of leaf entry e's records, consecutive, LEAF_COLS floats each,
// every row marked in seen_leaf: a leaf arm's kOcclRows occlusion rows
// (occl_leaf_row), else the entry's one row (var_leaf under a variant
// layout, else row -e - 1 of the leaf table).
template <bool kVar, int kLeaf>
PT_HD const float* leaf_rows(const Tree& tr, int e) {
  if constexpr (kLeaf != kLeafShade) {
    return tr.ltris + (size_t)occl_leaf_row<kLeaf>(tr, e) * LEAF_COLS;
  } else {
    if (tr.seen_leaf) tr.seen_leaf[kVar ? var_leaf_row(tr, e) : -e - 1] = 1;
    return kVar ? var_leaf(tr, e) : tr.ltris + (size_t)(-e - 1) * LEAF_COLS;
  }
}

// Record k of one leaf row: an occlusion record [v0, e1, e2] (9 cols, k <
// OCCL_TRIS), or a shading record (16 cols, k < LEAF_TRIS).
PT_HD const float* occl_record(const float* row, int k) {
  return row + OCCL_STRIDE * k;
}

PT_HD const float* shade_record(const float* row, int k) {
  return row + 16 * k;
}

// Record k of a whole leaf from its rows (leaf_rows): occlusion records
// run on into the next row (a 2-row leaf's 14..27), shading records fill
// one row.
PT_HD const float* leaf_record(const float* rows, bool occl, int k) {
  return occl ? occl_record(rows + (size_t)(k / OCCL_TRIS) * LEAF_COLS,
                            k % OCCL_TRIS)
              : shade_record(rows, k);
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

// tri_test of the ray against the 9-col [v0, e1, e2] occlusion record at r
// (scalar loads: a record at stride 9 is not 16-byte aligned).
PT_HD float occl_tri_test(const WalkRay& c, const float* r) {
  return tri_test(c.ox, c.oy, c.oz, c.dx, c.dy, c.dz, ld(r), ld(r + 1),
                  ld(r + 2), ld(r + 3), ld(r + 4), ld(r + 5), ld(r + 6),
                  ld(r + 7), ld(r + 8));
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

// A node row of a walk: its slab tests at t (at t too when at_t), the
// passing children pushed in slot order (push_node), the row counted and
// marked.
template <bool kDepth, bool kVar>
PT_HD void visit_node(const Tree& tr, int e, const SlabRay& sr, float t,
                      bool at_t, int* stack, int& sp, bool& ok,
                      unsigned long long& it_node, int* depth) {
  ++it_node;
  if (tr.seen_node) tr.seen_node[e] = 1;
  ok &= push_node<kDepth, kVar>(tr, e, sr, t, at_t, stack, sp, depth);
}

// closest_hit's test of shading leaf entry e: its 8 records of 16 cols
// (four 16-byte loads each) in slot order, under the exact-tie rule.
template <bool kInst, bool kVar>
PT_HD void leaf_closest(const Tree& tr, int e, const WalkRay& cur, Hit& h,
                        unsigned long long& it_leaf) {
  ++it_leaf;
  const float* row = leaf_rows<kVar, kLeafShade>(tr, e);
#pragma unroll 2
  for (int c = 0; c < LEAF_TRIS; ++c) {
    const float* r = shade_record(row, c);
    F4 a = ld4(r), b = ld4(r + 4), d4 = ld4(r + 8), p = ld4(r + 12);
    float tt = tri_test(cur.ox, cur.oy, cur.oz, cur.dx, cur.dy, cur.dz, a.x,
                        a.y, a.z, a.w, b.x, b.y, b.z, b.w, d4.x);
    const int id = as_int(p.y);
    const bool tie =
        tt == h.t && (id < h.tri || (kInst && id == h.tri && cur.iid < h.iid));
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

// A vote of the postponed-leaf walk (closest_hit's kPost arm): whether p
// holds on some lane of the warp, every lane taking part.  The host build
// runs a warp of one lane, whose vote is its own predicate.
PT_HD bool warp_any(bool p) {
#ifdef __CUDA_ARCH__
  return __any_sync(0xffffffffu, p);
#else
  return p;
#endif
}

// One trip of the postponed-leaf walk under count_iters (trips non-null):
// a warp trip, and a lane trip per lane that reads a row in it (`works`),
// so that lane trips are the rows visited, as in count_trip.  Every lane
// of the warp takes part; the host build counts its one lane.
PT_HD void count_trip_vote(unsigned long long* trips, bool works) {
  if (!trips) return;
#ifdef __CUDA_ARCH__
  const unsigned m = __ballot_sync(0xffffffffu, works);
  if ((threadIdx.x & 31u) == 0) {
    atomicAdd(trips, 1ull);
    atomicAdd(trips + 1, (unsigned long long)__popc(m));
  }
#else
  trips[0] += 1;
  trips[1] += works ? 1 : 0;
#endif
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
// with kInst).  With a leaf arm (kLeafOccl, kLeafOccl2; kVar only) the
// leaves are occlusion leaves of 14 records per row, tested in order with
// the same rule: a record's id, object and normal come from the payload
// row at its offset (CPUGPU_LEAF14), or, without payload rows, the hit
// keeps only its t and takes id 1 (the JAX function's t-only query).
// kTrips (count launches): count the loop's trips (count_trip).
//
// kPost (shading leaves only, without kInst or kDepth): postponed leaves
// (Aila and Laine, HPG 2009, at warp granularity: the labs' L4, v1).
// Every lane of the warp calls the walk, a lane without a ray with
// `walk` false (it takes part in the votes only).  A popped leaf is
// parked in the ray's one pending slot and the walk goes on over nodes;
// a trip is a leaf trip when some lane pops a leaf while its slot is
// full, or when no lane holds a node entry -- then every lane with a
// parked or a current leaf tests one leaf (the parked one first, the
// current one parked in its place) and the lanes whose entry was a leaf
// pop -- else a node trip.  So a warp's trips are all node rows or all
// leaf rows.  Hits stay bitwise by the tie rule: a parked leaf only lets
// nodes be tested at a larger t, which adds visits and loses none.  The
// visit counts may differ from the slot-order walk's.  Returns false on
// a stack overflow.
template <bool kInst = false, bool kDepth = false, bool kVar = false,
          int kLeaf = kLeafShade, bool kTrips = false, bool kPost = false>
PT_HD bool closest_hit(const Tree& tr, float ox, float oy, float oz,
                       float dx, float dy, float dz, Hit& h,
                       unsigned long long& it_node,
                       unsigned long long& it_leaf, int* depth = nullptr,
                       bool walk = true) {
  static_assert(!(kInst && kVar), "the instance arms walk 64-col rows");
  static_assert(kLeaf == kLeafShade || kVar, "the leaf arms are variant");
  static_assert(!kPost || (!kInst && !kDepth && kLeaf == kLeafShade),
                "postponed leaves: shading leaves, no instances, no depth");
  const WalkRay w = world_ray(ox, oy, oz, dx, dy, dz);
  WalkRay cur = w;
  int stack[kVar ? PT_STACK_W16 : PT_STACK];
  int sp = 0;
  bool ok = true;
  for (int i = 1; i < tr.nroots; ++i) stack[sp++] = tr.roots[i];
  int e = tr.roots[0];
  if constexpr (kPost) {
    bool live = walk;     // e holds an entry
    bool parked = false;  // `pend` holds a leaf entry
    int pend = 0;
    while (warp_any(live || parked)) {
      const bool leaf = live && !(kVar ? var_is_node(tr, e) : e >= 0);
      const bool node = live && !leaf;
      bool pop;
      if (warp_any(leaf && parked) || !warp_any(node)) {
        // a leaf trip: the parked leaf first, the current one parked in
        // its place; a lane that holds a node entry keeps it
        if constexpr (kTrips) count_trip_vote(tr.trips, leaf || parked);
        if (leaf || parked) {
          leaf_closest<false, kVar>(tr, parked ? pend : e, cur, h, it_leaf);
        }
        if (leaf && parked) pend = e;
        parked = leaf && parked;
        pop = leaf;
      } else {
        // a node trip: no lane that pops a leaf has one parked
        if constexpr (kTrips) count_trip_vote(tr.trips, node);
        if (node) {
          visit_node<false, kVar>(tr, e, cur.sr, h.t, true, stack, sp, ok,
                                  it_node, depth);
        }
        if (leaf) {
          pend = e;
          parked = true;
        }
        pop = live;
      }
      if (pop) {
        if (sp == 0) {
          live = false;
        } else {
          e = stack[--sp];
        }
      }
    }
    return ok;
  }
  for (;;) {
    if constexpr (kTrips) count_trip(tr.trips);
    if (kInst && instance_entry(tr, w, cur, e, stack, sp, ok) == 1) continue;
    if (kInst && e == RESTORE) {
      // the world ray is back; pop below
    } else if (kVar ? var_is_node(tr, e) : e >= 0) {
      visit_node<kDepth, kVar>(tr, e, cur.sr, h.t, true, stack, sp, ok,
                               it_node, depth);
    } else if constexpr (kLeaf != kLeafShade) {
      ++it_leaf;
      const int r0 = occl_leaf_row<kLeaf>(tr, e);
      for (int q = 0; q < kOcclRows<kLeaf>; ++q) {
        const float* row = tr.ltris + (size_t)(r0 + q) * LEAF_COLS;
        const float* prow =
            tr.pay ? tr.pay + (size_t)(r0 + q) * LEAF_COLS : nullptr;
        for (int c = 0; c < OCCL_TRIS; ++c) {
          const float tt = occl_tri_test(cur, occl_record(row, c));
          if (tt >= 0.0f && tt <= h.t) {
            const float* p = prow ? occl_record(prow, c) : nullptr;
            if (p && tr.seen_pay) tr.seen_pay[(r0 + q) * OCCL_TRIS + c] = 1;
            const int id = p ? as_int(ld(p + 4)) : 1;
            if (tt < h.t || id < h.tri) {
              h.t = tt;
              h.tri = id;
              h.obj = p ? as_int(ld(p + 3)) : -1;
              h.nx = p ? ld(p) : 0.0f;
              h.ny = p ? ld(p + 1) : 0.0f;
              h.nz = p ? ld(p + 2) : 0.0f;
            }
          }
        }
      }
    } else {
      leaf_closest<kInst, kVar>(tr, e, cur, h, it_leaf);
    }
    if (sp == 0) break;
    e = stack[--sp];
  }
  return ok;
}

// Records 4g .. 4g + kRec - 1 of an occlusion row from the kVec4 aligned
// float4 at `g4` (B3's 16-byte reads, occl_row_any_vec): each one's
// tri_test, the first hit with 0 <= t < tmax in record order into
// `first` (-1 while none).
template <int kRec, int kVec4>
PT_HD void occl_group(const WalkRay& c, const float* g4, float tmax,
                      float& first) {
  float r[36];
#pragma unroll
  for (int q = 0; q < kVec4; ++q) {
    const F4 v = ld4(g4 + 4 * q);
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < kRec; ++k) {
    const float* x = r + OCCL_STRIDE * k;
    const float tt = tri_test(c.ox, c.oy, c.oz, c.dx, c.dy, c.dz, x[0],
                              x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8]);
    if (first < 0.0f && tt >= 0.0f && tt < tmax) first = tt;
  }
}

// The 14 records of an occlusion row (16-byte aligned) read as 16-byte
// vectors: records 4g .. 4g + 3 are the row's floats 36g .. 36g + 35,
// nine aligned float4 (g = 0, 1, 2), and records 12 and 13 lie in floats
// 108 .. 127, the row's last five -- 32 vector loads for a whole row where
// the scalar reads (occl_tri_test) make up to 126.  Every record is
// tested (no exit at the first hit), so that no load waits on an earlier
// record's test.  Returns the t of the first record in record order with
// 0 <= t < tmax, or -1.
PT_HD float occl_row_any_vec(const WalkRay& c, const float* row,
                             float tmax) {
  float first = -1.0f;
#pragma unroll
  for (int g = 0; g < 3; ++g) occl_group<4, 9>(c, row + 36 * g, tmax, first);
  occl_group<2, 5>(c, row + 108, tmax, first);
  return first;
}

// The 14 records of an occlusion row tested in order by scalar loads (a
// record at stride 9 is not 16-byte aligned), or with kVec by
// occl_row_any_vec: the t of the first with 0 <= t < tmax, or -1.
template <bool kVec>
PT_HD float occl_row_any(const WalkRay& c, const float* row, float tmax) {
  if constexpr (kVec) return occl_row_any_vec(c, row, tmax);
  for (int k = 0; k < OCCL_TRIS; ++k) {
    const float tt = occl_tri_test(c, occl_record(row, k));
    if (tt >= 0.0f && tt < tmax) return tt;
  }
  return -1.0f;
}

// The any-hit test of leaf entry e of a walk (any_hit's leaf step): its
// records in order until one has t < tmax.  Returns true on such a
// record; with kReport (shading trees only) also writes it into `found`
// (t, original id, object, flat normal, instance), or over an occlusion
// tree its t and id 1.  The leaf's rows are counted (it_leaf) and marked
// (seen_leaf).
template <bool kReport, bool kVar, int kLeaf, bool kVec>
PT_HD bool leaf_any(const Tree& tr, int e, const WalkRay& cur, float tmax,
                    unsigned long long& it_leaf, Hit* found) {
  ++it_leaf;
  float tt = -1.0f;
  const float* rows = leaf_rows<kVar, kLeaf>(tr, e);
  if constexpr (kLeaf != kLeafShade) {
    for (int q = 0; q < kOcclRows<kLeaf> && tt < 0.0f; ++q) {
      tt = occl_row_any<kVec>(cur, rows + (size_t)q * LEAF_COLS, tmax);
    }
  } else {
    if (!tr.occl) {
#pragma unroll 2
      for (int c = 0; c < LEAF_TRIS; ++c) {
        const float* r = shade_record(rows, c);
        F4 a = ld4(r), b = ld4(r + 4), d4 = ld4(r + 8);
        tt = tri_test(cur.ox, cur.oy, cur.oz, cur.dx, cur.dy, cur.dz, a.x,
                      a.y, a.z, a.w, b.x, b.y, b.z, b.w, d4.x);
        if (tt >= 0.0f && tt < tmax) {
          if constexpr (kReport) {
            const F4 p = ld4(r + 12);
            found->t = tt;
            found->tri = as_int(p.y);
            found->obj = as_int(p.x);
            found->nx = d4.y;
            found->ny = d4.z;
            found->nz = d4.w;
            found->iid = cur.iid;
          }
          return true;
        }
      }
      return false;
    }
    // a 1-row occlusion leaf read by the default arm (pt_frame's and
    // shadow_resolve's shadow trees)
    tt = occl_row_any<kVec>(cur, rows, tmax);
  }
  if (tt < 0.0f) return false;
  if constexpr (kReport) {
    found->t = tt;
    found->tri = 1;
  }
  return true;
}

// Any hit with t < tmax over an occlusion tree (14 bare records per leaf
// row) or a shading tree (8 records of 16 cols, four 16-byte loads each,
// as closest_hit reads them; the 9-col occlusion records at their
// unaligned stride stay scalar unless kVec): leaf_any at each leaf.  Sets
// `occluded`; with kReport (shading trees only) also writes the record it
// found into `found` (t, original id, object, flat normal, instance).
// With kInst the walk runs the instance machinery; kDepth counts as in
// closest_hit, up to the row that ends the walk; kVar reads the tree's
// layout.  A leaf arm (kLeafOccl, kLeafOccl2; kVar only) reads occlusion
// leaves of one or two rows (14 or 28 records in order), and with
// kReport writes the t of the record it found and id 1 (the occlusion
// bit of the JAX function).  kTrips (count launches): count the loop's
// trips (count_trip).  kVec (B3's walks): occlusion rows read as 16-byte
// vectors (occl_row_any_vec).  Returns false on a stack overflow.
template <bool kReport = false, bool kInst = false, bool kDepth = false,
          bool kVar = false, int kLeaf = kLeafShade, bool kTrips = false,
          bool kVec = false>
PT_HD bool any_hit(const Tree& tr, float ox, float oy, float oz, float dx,
                   float dy, float dz, float tmax, bool& occluded,
                   unsigned long long& it_node, unsigned long long& it_leaf,
                   Hit* found = nullptr, int* depth = nullptr) {
  static_assert(!(kInst && kVar), "the instance arms walk 64-col rows");
  static_assert(kLeaf == kLeafShade || kVar, "the leaf arms are variant");
  const WalkRay w = world_ray(ox, oy, oz, dx, dy, dz);
  WalkRay cur = w;
  int stack[kVar ? PT_STACK_W16 : PT_STACK];
  int sp = 0;
  bool ok = true;
  occluded = false;
  for (int i = 1; i < tr.nroots; ++i) stack[sp++] = tr.roots[i];
  int e = tr.roots[0];
  for (;;) {
    if constexpr (kTrips) count_trip(tr.trips);
    if (kInst && instance_entry(tr, w, cur, e, stack, sp, ok) == 1) continue;
    if (kInst && e == RESTORE) {
      // the world ray is back; pop below
    } else if (kVar ? var_is_node(tr, e) : e >= 0) {
      visit_node<kDepth, kVar>(tr, e, cur.sr, tmax, false, stack, sp, ok,
                               it_node, depth);
    } else if (leaf_any<kReport, kVar, kLeaf, kVec>(tr, e, cur, tmax,
                                                    it_leaf, found)) {
      occluded = true;
      return ok;
    }
    if (sp == 0) break;
    e = stack[--sp];
  }
  return ok;
}

// ---- analytic primitives (megakernel._analytic_tests) ---------------------

// sphere s: hit distance ts or +inf (the shared predicate of the closest
// and the occlusion tests).  A ray behind the sphere or passing outside
// it (NaN included) returns before the square root: the same value.
PT_HD float sphere_t(const float* s, float ox, float oy, float oz, float dx,
                     float dy, float dz) {
  float elx = s[0] - ox, ely = s[1] - oy, elz = s[2] - oz;
  float rsq = s[S_RSQ];
  float tca = elx * dx + ely * dy + elz * dz;
  float d2 = (elx * elx + ely * ely + elz * elz) - tca * tca;
  if (!(tca >= 0.0f && d2 <= rsq)) return INF_F;
  float thc = sqrtf(fmaxf(rsq - d2, 0.0f));
  float t0 = tca - thc;
  float t1 = tca + thc;
  float ts = t0 < 0.0f ? t1 : t0;
  return ts >= 0.0f ? ts : INF_F;
}

// plane p: hit distance tp or +inf.  Where the signs of the numerator and
// the denominator already rule a hit out (tp would be <= 0 or NaN) it
// returns before the division: the same value.
PT_HD float plane_t(const float* p, float ox, float oy, float oz, float dx,
                    float dy, float dz) {
  float denom = dx * p[3] + dy * p[4] + dz * p[5];
  bool den_ok = fabsf(denom) > PLANE_DENOM_EPS;
  float num = (p[0] - ox) * p[3] + (p[1] - oy) * p[4] + (p[2] - oz) * p[5];
  if (!den_ok || num == 0.0f || (num > 0.0f) != (denom > 0.0f)) return INF_F;
  float tp = num / denom;
  return tp > 0.0f ? tp : INF_F;
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
// NEE shadow ray (all zero unless sneed).  kVar: the variant walk; kLeaf:
// its leaf arm (kLeafOccl: the leaf-14 walk with payload rows); kTrips:
// the walk counts its trips; kPost: the closest hit with postponed leaves
// (closest_hit's kPost), which every thread of the warp calls, one
// without a live path with `walk` false (it only votes, and `ps` stays as
// it is).  Clears `ok` on a stack overflow.
template <bool kInst = false, bool kVar = false, int kLeaf = kLeafShade,
          bool kTrips = false, bool kPost = false>
PT_HD Shadow extend(const Tree& tree, const Tables& tb, const Mode& md,
                    Path& ps, bool depth0, Counters& cnt, bool& ok,
                    bool walk = true) {
  Hit h = {RAY_TMAX, -1, -1, 0.0f, 0.0f, 0.0f, -1};
  if (walk) ++cnt.ray;
  ok &= closest_hit<kInst, false, kVar, kLeaf, kTrips, kPost>(
      tree, ps.ox, ps.oy, ps.oz, ps.dx, ps.dy, ps.dz, h, cnt.node, cnt.leaf,
      nullptr, walk);
  if (!walk) return {false, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
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
// visible.  kVar: the variant walk; kLeaf: its leaf arm (kLeafOccl2:
// 2-row occlusion leaves); kTrips: the walk counts its trips; kVec: the
// occlusion rows read as 16-byte vectors (B3).  Clears `ok` on a stack
// overflow.
template <bool kInst = false, bool kVar = false, int kLeaf = kLeafShade,
          bool kTrips = false, bool kVec = false>
PT_HD bool unoccluded(const Tree& sh_tree, const Tables& tb, const Shadow& sh,
                      Counters& cnt, bool& ok) {
  ++cnt.sray;
  bool occ = false;
  ok &= any_hit<false, kInst, false, kVar, kLeaf, kTrips, kVec>(
      sh_tree, sh.ox, sh.oy, sh.oz, sh.dx, sh.dy, sh.dz, sh.tmax, occ,
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
// 1, energy 0, active, not specular) when there are none.  kCs: streaming
// loads (col_ld).
template <bool kCs = false>
PT_HD Path load_path(const Params& p, int lane) {
  Path ps;
  ps.ox = col_ld<kCs>(p.ray[0], lane);
  ps.oy = col_ld<kCs>(p.ray[1], lane);
  ps.oz = col_ld<kCs>(p.ray[2], lane);
  ps.dx = col_ld<kCs>(p.ray[3], lane);
  ps.dy = col_ld<kCs>(p.ray[4], lane);
  ps.dz = col_ld<kCs>(p.ray[5], lane);
  ps.state = (uint32_t)col_ld<kCs>(p.state, lane);
  if (p.tp_in[0]) {
    ps.tpx = col_ld<kCs>(p.tp_in[0], lane);
    ps.tpy = col_ld<kCs>(p.tp_in[1], lane);
    ps.tpz = col_ld<kCs>(p.tp_in[2], lane);
    ps.enx = col_ld<kCs>(p.en_in[0], lane);
    ps.eny = col_ld<kCs>(p.en_in[1], lane);
    ps.enz = col_ld<kCs>(p.en_in[2], lane);
    int fl = col_ld<kCs>(p.flags_in, lane);
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
// flags (plus bit 2 = sneed).  kCs: streaming stores (col_st).
template <bool kCs = false>
PT_HD void store_path(const Params& p, int lane, const Path& ps, bool sneed) {
  col_st<kCs>(p.state_out, lane, (long long)ps.state);
  col_st<kCs>(p.en_out[0], lane, ps.enx);
  col_st<kCs>(p.en_out[1], lane, ps.eny);
  col_st<kCs>(p.en_out[2], lane, ps.enz);
  if (p.ray_out[0]) {
    col_st<kCs>(p.ray_out[0], lane, ps.ox);
    col_st<kCs>(p.ray_out[1], lane, ps.oy);
    col_st<kCs>(p.ray_out[2], lane, ps.oz);
    col_st<kCs>(p.ray_out[3], lane, ps.dx);
    col_st<kCs>(p.ray_out[4], lane, ps.dy);
    col_st<kCs>(p.ray_out[5], lane, ps.dz);
    col_st<kCs>(p.tp_out[0], lane, ps.tpx);
    col_st<kCs>(p.tp_out[1], lane, ps.tpy);
    col_st<kCs>(p.tp_out[2], lane, ps.tpz);
    col_st<kCs>(p.flags_out, lane,
                (ps.active ? 1 : 0) | (ps.spec << 1) | (sneed ? 4 : 0));
  }
}

// ---- one lane of each kernel -----------------------------------------------

// pt_frame: every depth of one lane, as a run of depth steps that a
// thread can interleave with other lanes' (pt_frame.cu's persistent
// warps): begin_lane, then step_lane while it returns true.  A lane leaves
// when its path dies (its RNG state then stays as it is) or its span
// ends, and then writes its outputs at its own index.
struct LaneRun {
  int lane, d, tr;  // the lane, the depths it has run, the rays it traced
  Path ps;
};

// Start lane `lane`: its path from the carry-in columns.  Returns true
// when the path runs a depth; else writes the lane's outputs (a dead
// carry-in lane, or a span of no depths) and returns false.
PT_HD bool begin_lane(const Params& p, int lane, LaneRun& run) {
  run.lane = lane;
  run.d = 0;
  run.tr = 0;
  run.ps = load_path(p, lane);
  if (p.depths > 0 && run.ps.active) return true;
  store_path(p, lane, run.ps, false);
  p.tr_out[lane] = 0;
  return false;
}

// One depth of a live lane: extend (closest hit and shading), then the
// NEE shadow test and the light's add.  Returns true while the lane runs
// more depths; else writes its outputs and returns false.  kVar: both
// walks read their tree's layout; kShLeaf: the shadow walk's leaf arm
// (kLeafOccl2); kTrips: the walks count their trips (count_iters' arm).
// Clears `ok` on a stack overflow.
template <bool kVar, int kShLeaf, bool kTrips>
PT_HD bool step_lane(const Params& p, const Tables& tb, LaneRun& run,
                     Counters& cnt, bool& ok) {
  run.tr += 1;
  Shadow sh = extend<false, kVar, kLeafShade, kTrips>(
      p.tree, tb, p.mode, run.ps, run.d + p.depth_base == 0, cnt, ok);
  if (sh.sneed) {
    run.tr += 1;
    if (unoccluded<false, kVar, kShLeaf, kTrips>(p.sh_tree, tb, sh, cnt, ok)) {
      add_light(run.ps.enx, run.ps.eny, run.ps.enz, sh);
    }
  }
  run.d += 1;
  if (run.d < p.depths && run.ps.active) return true;
  store_path(p, run.lane, run.ps, false);
  p.tr_out[run.lane] = run.tr;
  return false;
}

// pt_frame's lane body run to its end (the host build's schedule, which
// counts trips whenever count_iters asks).  Returns false on a stack
// overflow.
template <bool kVar = false, int kShLeaf = kLeafShade>
PT_HD bool trace_lane(const Params& p, const Tables& tb, int lane,
                      Counters& cnt) {
  LaneRun run;
  bool ok = true;
  if (begin_lane(p, lane, run)) {
    while (step_lane<kVar, kShLeaf, true>(p, tb, run, cnt, ok)) {
    }
  }
  return ok;
}

// shade_extend: one depth (p.depth_base, absolute) of one lane (kInst: on
// the instance machinery).  A lane that is not active passes its columns
// through with flags & 3 and zero shadow columns (the per-lane form of
// the Pallas kernel's dead-tile rule); a live lane writes its next ray
// and carry, flags with bit 2 = sneed, and its shadow ray (zero unless
// sneed, so tmax = sneed ? tmax : 0).  Its columns, 60 bytes in and 100
// out whether the lane is live or not, are read and written as streaming
// traffic (col_ld, col_st), so that they do not push the tree's rows out
// of L2 while the launch's slowest walks run.  kVar: the variant walk;
// kLeaf: its leaf arm (kLeafOccl: the leaf-14 walk); kTrips: the walk
// counts its trips (count_iters' arm).  Over shading leaves without
// instances (postponed's launches) the closest hit walks with postponed
// leaves at every depth, and every thread of the warp calls it (a thread
// without a live path only votes; one past n writes nothing); the
// instance and leaf-14 arms walk in slot order.  Returns false on a
// stack overflow.
template <bool kInst = false, bool kVar = false, int kLeaf = kLeafShade,
          bool kTrips = false>
PT_HD bool shade_extend_lane(const Params& p, const Tables& tb, int lane,
                             Counters& cnt) {
  constexpr bool kPost = !kInst && kLeaf == kLeafShade;
  const bool in = lane < p.n;
  Path ps{};
  if (in) ps = load_path<true>(p, lane);
  Shadow sh = {false, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool ok = true;
  if (kPost || ps.active) {
    sh = extend<kInst, kVar, kLeaf, kTrips, kPost>(
        p.tree, tb, p.mode, ps, p.depth_base == 0, cnt, ok, ps.active);
  }
  if (in) {
    store_path<true>(p, lane, ps, sh.sneed);
    const float cols[10] = {sh.ox, sh.oy, sh.oz, sh.dx, sh.dy,
                            sh.dz, sh.tmax, sh.cr, sh.cg, sh.cb};
#pragma unroll
    for (int c = 0; c < 10; ++c) col_st<true>(p.shadow[c], lane, cols[c]);
  }
  return ok;
}

// shadow_resolve's walk of lane `lane`, which has a shadow ray (sneed)
// and energy `en` (read by the caller), by its own thread: the shadow
// test of its ray over p.sh_tree (kInst: on the instance machinery; the
// occlusion rows read as 16-byte vectors), then its energy plus the
// contribution when the light is visible, written at the lane.  Its
// columns are read and written as streaming traffic.  kVar: the variant
// walk; kLeaf: its leaf arm (kLeafOccl2); kTrips: the walk counts its
// trips and the lane's rows visited (Counters::longest).  Clears `ok` on a
// stack overflow.
template <bool kInst = false, bool kVar = false, int kLeaf = kLeafShade,
          bool kTrips = false>
PT_HD void shadow_walk(const Params& p, const Tables& tb, int lane,
                       float (&en)[3], Counters& cnt, bool& ok) {
  Shadow sh;
  sh.sneed = true;
  float* const f[10] = {&sh.ox, &sh.oy, &sh.oz, &sh.dx, &sh.dy,
                        &sh.dz, &sh.tmax, &sh.cr, &sh.cg, &sh.cb};
#pragma unroll
  for (int c = 0; c < 10; ++c) *f[c] = col_ld<true>(p.shadow[c], lane);
  const unsigned long long rows0 = cnt.snode + cnt.sleaf;
  if (unoccluded<kInst, kVar, kLeaf, kTrips, true>(p.sh_tree, tb, sh, cnt,
                                                   ok)) {
    add_light(en[0], en[1], en[2], sh);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) col_st<true>(p.en_out[c], lane, en[c]);
  if constexpr (kTrips) {
    const unsigned long long rows = cnt.snode + cnt.sleaf - rows0;
    if (rows > cnt.longest) cnt.longest = rows;
  }
}

// shadow_resolve on one lane (the host build's schedule, lane by lane;
// csrc/megakernel.cu gives a warp with few shadow rays to all its lanes):
// a lane with sneed (flags bit 2) takes shadow_walk, every other lane
// copies its energy.  Returns false on a stack overflow.
template <bool kInst = false, bool kVar = false, int kLeaf = kLeafShade,
          bool kTrips = false>
PT_HD bool shadow_resolve_lane(const Params& p, const Tables& tb, int lane,
                               Counters& cnt) {
  bool ok = true;
  float en[3];
  for (int c = 0; c < 3; ++c) en[c] = p.en_in[c][lane];
  if ((p.flags_in[lane] >> 2) & 1) {
    shadow_walk<kInst, kVar, kLeaf, kTrips>(p, tb, lane, en, cnt, ok);
  } else {
    for (int c = 0; c < 3; ++c) p.en_out[c][lane] = en[c];
  }
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
  void* iters;        // NUM_COUNTERS u64 work counters (Counters order),
                      // then pt_frame's warp and lane trips, or null
  void* seen[5];      // u8 bitmaps (Tree::seen_*): node, leaf, shadow node,
                      // shadow leaf rows, payload records; null unless
                      // counting
  // the instance machinery of both trees (Tree::inst_*), or null
  const void* inst_inv;
  const void* inst_nrm;
  const void* inst_root;
  // the entry side tables (B + V, 8) i32 of both trees, or null
  const void* ents;
  const void* sh_ents;
  // the closest-hit tree's leaf-14 payload rows (Tree::pay), or null
  const void* pay;
  void* status;       // i32, bit 0 set on a traversal stack overflow
  void* next;         // pt_frame: i32 zeroed, the next lane to fetch
  void* stream;
  int small_words;
  int mat_rows, light_rows, ltri_rows, sph_rows, pln_rows, obj_rows;
  int num_sph, num_pln, num_lights, nroots, sh_nroots, mesh_lights, sh_occl;
  int n, depths, depth_base, nee, rr, cosine, ref_pdf, any_hit, num_inst;
  // the node layout (Tree::fused_nn, width, cols; the shadow tree's
  // fused_nn is the closest-hit tree's unless sh_occl, when it is split)
  int fused_nn, width, cols, sh_cols;
  // occl: the closest-hit tree holds occlusion leaves (traverse's occl
  // arms); occl_rows: the rows per leaf of the launch's occlusion tree (1
  // or 2, CPUGPU_OCCL2); sh_width: the shadow tree's arity (8 or 16)
  int occl, occl_rows, sh_width;
};

// True when a launch needs the variant walks (kVar): a side table, or
// node rows other than the plain 64-col, 8-wide, split ones.
PT_HD bool variant(const PtArgs& a) {
  return a.ents || a.sh_ents || a.fused_nn || a.width != 8 || a.cols != 64 ||
         a.sh_cols != 64;
}

// The leaf arm (kLeaf) of a launch's walk over its closest-hit tree: an
// occlusion tree (shade_extend's leaf-14 payload, traverse_packet_slim's
// occl) of 2-row leaves (kLeafOccl2) or 1-row ones (kLeafOccl), else
// shading leaves.
PT_HD int leaf_arm(const PtArgs& a) {
  if (!a.occl) return kLeafShade;
  return a.occl_rows == 2 ? kLeafOccl2 : kLeafOccl;
}

// The leaf arm of a launch's walk over its shadow tree: kLeafOccl2 for an
// occlusion tree of 2-row leaves; the 1-row occlusion leaves are read by
// the default arm (Tree::occl).
PT_HD int sh_leaf_arm(const PtArgs& a) {
  return a.sh_occl && a.occl_rows == 2 ? kLeafOccl2 : kLeafShade;
}

// True when a launch asks for an arm that is not built: the instance
// machinery over variant tables or with a leaf arm.
PT_HD bool refused(const PtArgs& a) {
  return a.num_inst > 0 && (variant(a) || leaf_arm(a) != kLeafShade ||
                            sh_leaf_arm(a) != kLeafShade);
}

// The layout of PtArgs as this compiler sees it: its size and the
// offsets of depth_out, pay and its last field, which ops/pt_frame.py
// holds against its ctypes mirror when it loads a build (a field out of
// step would shift every later one silently).
inline void args_layout(long long* out) {
  out[0] = (long long)sizeof(PtArgs);
  out[1] = (long long)offsetof(PtArgs, depth_out);
  out[2] = (long long)offsetof(PtArgs, pay);
  out[3] = (long long)offsetof(PtArgs, sh_width);
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
  unsigned long long* trips =
      a.iters ? static_cast<unsigned long long*>(a.iters) + NUM_COUNTERS
              : nullptr;
  const float* inv = static_cast<const float*>(a.inst_inv);
  const float* nrm = static_cast<const float*>(a.inst_nrm);
  const int* iroot = static_cast<const int*>(a.inst_root);
  tree = {static_cast<const float*>(a.nodes), static_cast<const float*>(a.ltris),
          w, a.nroots, false, seen[0], seen[1], inv, nrm, iroot, a.num_inst,
          static_cast<const int*>(a.ents), a.cols, a.width, a.fused_nn,
          static_cast<const float*>(a.pay), seen[4], trips};
  w += a.nroots;
  sh_tree = {static_cast<const float*>(a.sh_nodes),
             static_cast<const float*>(a.sh_ltris), w, a.sh_nroots,
             a.sh_occl != 0, seen[2], seen[3], inv, nrm, iroot, a.num_inst,
             static_cast<const int*>(a.sh_ents), a.sh_cols, a.sh_width,
             a.sh_occl ? 0 : a.fused_nn, nullptr, nullptr, trips};
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

// Whether lane `lane` of a traverse_packet_slim launch is active (every
// lane without an active column).
PT_HD bool lane_active(const PtArgs& a, int lane) {
  return !a.active || static_cast<const int*>(a.active)[lane] != 0;
}

// traverse_packet_slim's outputs of lane `lane`: the hit h and, with
// kDepth, the walk's bvh_depth.
template <bool kDepth>
PT_HD void write_hit(const PtArgs& a, int lane, const Hit& h, int depth) {
  if constexpr (kDepth) static_cast<int*>(a.depth_out)[lane] = depth;
  static_cast<float*>(a.hit_out[0])[lane] = h.t;
  static_cast<int*>(a.hit_out[1])[lane] = h.tri;
  static_cast<int*>(a.hit_out[2])[lane] = h.obj;
  static_cast<float*>(a.hit_out[3])[lane] = h.nx;
  static_cast<float*>(a.hit_out[4])[lane] = h.ny;
  static_cast<float*>(a.hit_out[5])[lane] = h.nz;
  if (a.hit_out[6]) static_cast<int*>(a.hit_out[6])[lane] = h.iid;
}

// The lane's t bound: its t_init, or RAY_TMAX without the column (the
// closest-hit test of ops/pt_frame.py).
PT_HD float lane_t_init(const PtArgs& a, int lane) {
  return a.t_init ? static_cast<const float*>(a.t_init)[lane] : RAY_TMAX;
}

// The outputs of a lane that is not active: t_init, ids -1, a zero
// normal, instance -1 and, with kDepth, bvh_depth 0.
template <bool kDepth>
PT_HD void dead_lane(const PtArgs& a, int lane) {
  write_hit<kDepth>(a, lane, {lane_t_init(a, lane), -1, -1, 0.0f, 0.0f, 0.0f,
                              -1}, 0);
}

// True when a launch's closest hits walk with postponed leaves
// (closest_hit's kPost): the closest-hit query over shading leaves,
// without count_depth (its count follows the slot-order walk's visit
// order) and without instances (a parked leaf would outlive its
// instance's RESTORE).
PT_HD bool postponed(const PtArgs& a) {
  return !a.any_hit && !a.depth_out && a.num_inst == 0 &&
         leaf_arm(a) == kLeafShade;
}

// The walk of one active lane of traverse_packet_slim: over the
// closest-hit tree, the nearest hit closer than the lane's t_init
// (closest_hit's exact-tie rule included) or, with any_hit, the first
// one the walk finds; with kInst on the instance machinery, the hit's
// instance (the 7th output column) and its normal in object space.  A
// lane that hits nothing writes t_init, ids -1 and a zero normal.  With
// kDepth (count_depth: a.depth_out set) the lane also writes its walk's
// bvh_depth.  kVar: the variant walk; kLeaf: its leaf arm over an
// occlusion tree (traverse_packet_slim's occl: the any hit, the leaf-14
// closest hit with payload rows, or the t-only closest hit); kTrips: the
// walk counts its trips; kPost: the closest hit with postponed leaves
// (postponed(a)), which every lane of the warp calls, a lane without a
// ray with `walk` false (it writes nothing).  Returns false on a stack
// overflow.
template <bool kInst = false, bool kDepth = false, bool kVar = false,
          int kLeaf = kLeafShade, bool kTrips = false, bool kPost = false>
PT_HD bool trace_ray(const PtArgs& a, const Tree& tree, int lane,
                     Counters& cnt, bool walk = true) {
  const float* const* r = reinterpret_cast<const float* const*>(a.ray);
  float ray[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float t0 = 0.0f;
  if (walk) {
    ++cnt.ray;
    t0 = lane_t_init(a, lane);
    for (int c = 0; c < 6; ++c) ray[c] = r[c][lane];
  }
  Hit h = {t0, -1, -1, 0.0f, 0.0f, 0.0f, -1};
  int depth = 0;
  bool ok;
  if constexpr (kPost) {
    ok = closest_hit<false, false, kVar, kLeafShade, kTrips, true>(
        tree, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], h, cnt.node,
        cnt.leaf, nullptr, walk);
  } else if (a.any_hit) {
    bool occ = false;
    ok = any_hit<true, kInst, kDepth, kVar, kLeaf, kTrips>(
        tree, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], t0, occ,
        cnt.node, cnt.leaf, &h, &depth);
  } else {
    ok = closest_hit<kInst, kDepth, kVar, kLeaf, kTrips>(
        tree, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], h, cnt.node,
        cnt.leaf, &depth);
  }
  if (walk) write_hit<kDepth>(a, lane, h, depth);
  return ok;
}

// One lane of traverse_packet_slim in the host build's schedule, lane by
// lane: the walk of an active lane (trace_ray, counting its trips
// whenever count_iters asks), the outputs of a lane that is not active
// (dead_lane).  Returns false on a stack overflow.
template <bool kInst = false, bool kDepth = false, bool kVar = false,
          int kLeaf = kLeafShade, bool kPost = false>
PT_HD bool traverse_lane(const PtArgs& a, const Tree& tree, int lane,
                         Counters& cnt) {
  if (!lane_active(a, lane)) {
    dead_lane<kDepth>(a, lane);
    return true;
  }
  return trace_ray<kInst, kDepth, kVar, kLeaf, true, kPost>(a, tree, lane,
                                                            cnt);
}

}  // namespace pt
