// Shared device code of the traversal labs (lab2.cu, lab3.cu,
// phase_lab.cu): the launch arguments, the row tests and the per-warp
// counters.  The arithmetic is pt_device.cuh's (slab_ray, zero_slab,
// tri_test), so every lab's closest hit is bitwise the standalone
// traversal's (traverse.cu) whatever order its schedule visits the tree
// in: the face-inclusive slab of a zero direction component, boxes at
// exactly t still visited, an exact tie in t to the lower id.
//
// The labs are schedules of the TPU packet kernel (tools/kernel_lab2.py,
// kernel_lab3.py, phase_lab.py).  On the TPU a row of 128 lanes shares
// one entry and one SMEM stack, and a group of 8 rows iterates together.
// Here one thread is one ray with its own stack in local memory, and the
// 32 rays of a warp iterate together: every loop runs while any lane of
// the warp is alive (__any_sync), each trip takes at most one entry per
// lane, and the lanes that are done idle through the warp's remaining
// trips.  The per-tile counters of the labs (one per 1024 lanes) are sums
// over the tile's 32 warps: `iters` the warp's trips, `leafs` the trips
// in which a lane of the warp tested a leaf row (L1, L2) or that ran in
// leaf mode (L4).

#pragma once

#include <cuda_runtime.h>

#include "pt_device.cuh"

namespace lab {

constexpr int kBlock = 128;
constexpr int kTile = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int DONE = 0x7FFFFFFF;
// stacks: the linear stack of kernel_lab2 (STACK), the frame stacks of
// 24 frames of 9 (8-wide) and 17 (16-wide) words (FSTACK); the wrappers
// (labs/common.py) refuse a tree too deep for them
constexpr int STACK = 64;
constexpr int FRAME8 = 9, FRAME16 = 17;
constexpr int FSTACK8 = FRAME8 * 24, FSTACK16 = FRAME16 * 24;
// work counters of a count launch: node rows slab-tested, leaf rows
// tested, triangle records tested
constexpr int NUM_COUNTS = 3;

struct LabArgs {
  const float* nodes;  // (B, 64) node rows, or the fused (B + NL, 128) table
  const float* ltris;  // (NL, 128) leaf rows of split tables
  const int* roots;    // (nroots,) on the device
  const float* ray[6];
  const float* t_init;
  const int* active;
  float* t_out;
  int* hit_out;
  int* obj_out;
  int* iters;  // (ceil(n / 1024),) zeroed, or null
  int* leafs;  // (ceil(n / 1024),) zeroed, or null
  // a count launch: one byte per table row (node rows, then leaf rows;
  // a fused table's rows in place), set when a walk reads the row, and
  // the NUM_COUNTS work counters; else null
  unsigned char* seen;
  unsigned long long* counts;
  int* status;  // bit 0: a stack would have overflowed
  void* stream;
  int n, nroots;
  int nn;         // node rows of a fused table (leaf entries >= nn), or 0
  int node_rows;  // B: the seen map's first leaf row
  int flags;      // the arm (each unit's launch entry says how)
};

PT_HD int ctz(unsigned v) {
#ifdef __CUDA_ARCH__
  return __ffs(v) - 1;
#else
  return __builtin_ctz(v);
#endif
}

struct LHit {
  float t;
  int tri, obj;
};

// The lane's ray and its slab form.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  pt::SlabRay sr;
};

__device__ __forceinline__ Ray load_ray(const LabArgs& a, int lane) {
  Ray r;
  r.ox = a.ray[0][lane];
  r.oy = a.ray[1][lane];
  r.oz = a.ray[2][lane];
  r.dx = a.ray[3][lane];
  r.dy = a.ray[4][lane];
  r.dz = a.ray[5][lane];
  r.sr = pt::slab_ray(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
  return r;
}

// The slab tests of one block of 8 child slots (bounds b: 48 f32 in
// registers, 6 per slot; entries ent): bit k of the mask when slot k
// holds a child the ray enters before t (at t too with at_t); with kNear
// also the slot of the least entry distance in the lab's order (the
// first strict minimum over slots, a slot that fails counting +inf),
// folded into *best / *best_k from slot `base` on.
template <bool kNear>
PT_HD unsigned slab8(const float* b, const int* ent, const pt::SlabRay& r,
                     float t, bool at_t, int base, float* best, int* best_k) {
  unsigned w = 0;
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
      if (r.zero & 1) pt::zero_slab(c[0], c[3], r.ox, tx1, tx2);
      if (r.zero & 2) pt::zero_slab(c[1], c[4], r.oy, ty1, ty2);
      if (r.zero & 4) pt::zero_slab(c[2], c[5], r.oz, tz1, tz2);
    }
    float tmin =
        fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
    float tmax =
        fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
    bool before = tmin < t || (at_t && tmin == t);
    bool pass = tmax >= tmin && before && tmax > 0.0f &&
                ent[k] != pt::SLIM_EMPTY;
    w |= pass ? (1u << k) : 0u;
    if constexpr (kNear) {
      const float dist = pass ? tmin : pt::INF_F;
      if (base + k == 0) {
        *best = dist;
        *best_k = 0;
      } else if (dist < *best) {
        *best = dist;
        *best_k = base + k;
      }
    }
  }
  return w;
}

// kCount float4 of a row into registers (out: 4 kCount f32).
template <int kCount>
PT_HD void load_row(const float* row, float* out) {
#pragma unroll
  for (int q = 0; q < kCount; ++q) {
    pt::F4 v = pt::ld4(row + 4 * q);
    out[4 * q] = v.x;
    out[4 * q + 1] = v.y;
    out[4 * q + 2] = v.z;
    out[4 * q + 3] = v.w;
  }
}

// kCount i32 entries from their f32 bits.
template <int kCount>
PT_HD void entries(const float* f, int* ent) {
#pragma unroll
  for (int k = 0; k < kCount; ++k) ent[k] = pt::as_int(f[k]);
}

// A shading record's hit (v0, e1, e2 at rec[0..8], object and id at
// rec[12], rec[13]) against the lane's closest hit: taken when strictly
// nearer, or at exactly the same t with the lower id -- with kLex the
// lower (object, id), for the 16-wide tables whose ids are local to
// their object (objects' triangles are numbered in object order, so it
// is the order of the global ids).
template <bool kLex>
PT_HD void record_closest(const Ray& r, const float* rec, LHit& h) {
  const float tt = pt::tri_test(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, rec[0],
                                rec[1], rec[2], rec[3], rec[4], rec[5],
                                rec[6], rec[7], rec[8]);
  const int id = pt::as_int(rec[13]), obj = pt::as_int(rec[12]);
  const bool lower = kLex ? (obj < h.obj || (obj == h.obj && id < h.tri))
                          : id < h.tri;
  if (tt >= 0.0f && (tt < h.t || (tt == h.t && lower))) {
    h.t = tt;
    h.tri = id;
    h.obj = obj;
  }
}

// The 8 records of a leaf row in slot order for a closest hit; the
// row's first kHave f32 come from `pre` (registers), the rest from
// memory.
template <bool kLex, int kHave = 0>
PT_HD void leaf_closest(const float* row, const float* pre, const Ray& r,
                        LHit& h) {
#pragma unroll
  for (int c = 0; c < pt::LEAF_TRIS; ++c) {
    float rec[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = 16 * c + 4 * j;
      if (q + 4 <= kHave) {
        rec[4 * j] = pre[q];
        rec[4 * j + 1] = pre[q + 1];
        rec[4 * j + 2] = pre[q + 2];
        rec[4 * j + 3] = pre[q + 3];
      } else {
        pt::F4 v = pt::ld4(row + q);
        rec[4 * j] = v.x;
        rec[4 * j + 1] = v.y;
        rec[4 * j + 2] = v.z;
        rec[4 * j + 3] = v.w;
      }
    }
    record_closest<kLex>(r, rec, h);
  }
}

// Per-lane work counts of a count launch.
struct Counts {
  unsigned long long node = 0, leaf = 0, tri = 0;
};

// Mark a row read in the count launch's map.
PT_HD void mark(const LabArgs& a, int row) {
  if (a.seen) a.seen[row] = 1;
}

// After the loop: the warp's trips (and leaf trips) into its tile's
// counters, the count launch's work counters summed over the warp, and
// the overflow flag.  Every lane of the warp takes part.
__device__ __forceinline__ void finish(const LabArgs& a, int lane,
                                       int trips, int leaf_trips,
                                       const Counts& c, bool ok) {
  if (!ok) atomicOr(a.status, 1);
  const bool first = (threadIdx.x & 31) == 0;
  if (first && a.iters) atomicAdd(a.iters + lane / kTile, trips);
  if (first && a.leafs) atomicAdd(a.leafs + lane / kTile, leaf_trips);
  if (!a.counts) return;
  unsigned long long v[NUM_COUNTS] = {c.node, c.leaf, c.tri};
#pragma unroll
  for (int k = 0; k < NUM_COUNTS; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(kFull, v[k], off);
    }
  }
  if (first) {
#pragma unroll
    for (int k = 0; k < NUM_COUNTS; ++k) atomicAdd(a.counts + k, v[k]);
  }
}

// The lane's outputs: its hit, or t_init and ids -1 when it is not active.
__device__ __forceinline__ void store(const LabArgs& a, int lane,
                                      const LHit& h) {
  if (lane >= a.n) return;
  a.t_out[lane] = h.t;
  a.hit_out[lane] = h.tri;
  a.obj_out[lane] = h.obj;
}

__device__ __forceinline__ bool lane_active(const LabArgs& a, int lane) {
  return lane < a.n && (a.active == nullptr || a.active[lane] != 0);
}

// Launch `kernel` over a->n lanes in blocks of kBlock on a->stream;
// returns cudaGetLastError().  Never synchronises.
inline int launch(void (*kernel)(const LabArgs), const LabArgs* a) {
  if (a->n <= 0) return 0;
  const int grid = (a->n + kBlock - 1) / kBlock;
  kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(a->stream)>>>(*a);
  return (int)cudaGetLastError();
}

// LabArgs' size and two offsets, for the ctypes mirror's check.
inline void args_layout(long long* out) {
  out[0] = (long long)sizeof(LabArgs);
  out[1] = (long long)offsetof(LabArgs, status);
  out[2] = (long long)offsetof(LabArgs, flags);
}

}  // namespace lab
