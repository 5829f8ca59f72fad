// Shared device code of the traversal labs (lab2.cu, lab3.cu,
// phase_lab.cu): the launch arguments, the row tests and the per-warp
// counters.  The arithmetic is pt_device.cuh's (slab_ray, zero_slab,
// slab_hit, tri_test), so every lab's closest hit is bitwise the
// standalone traversal's (traverse.cu) whatever order its schedule visits
// the tree in: the face-inclusive slab of a zero direction component, the
// conservative slab margin, boxes at exactly t still visited, an exact
// tie in t to the lower id.
//
// The labs are schedules of the TPU packet kernel (tools/kernel_lab2.py,
// kernel_lab3.py, phase_lab.py).  On the TPU a row of 128 lanes shares
// one entry and one SMEM stack, and a group of 8 rows iterates together.
// Here one thread is one ray with its own stack in local memory, and the
// 32 rays of a warp iterate together: every loop runs while any lane of
// the warp is alive (__any_sync), each trip takes at most one entry per
// lane.  In L3, L4, L6 and L7 a warp holds the rays of 32 consecutive
// lanes, the lanes that are done idle through the warp's remaining trips,
// and the per-tile counters (one per 1024 lanes) are sums over the tile's
// 32 warps: `iters` the warp's trips, `leafs` the trips that ran in leaf
// mode (L4).  L1 and L2 (lab2.cu) refill a lane whose ray has ended from
// a list of the active lanes, and count per ray instead.

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
  // L6 / L7 (kernel_lab.cu): per lane the interior trips in which the
  // ray entered a child (or null), and the (node_rows, 8) i32 entry
  // mirror of the shared-memory arm
  int* depth_out;
  const int* ents;
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

// The slab arithmetic of one child box c (6 f32: min xyz, max xyz), the
// pieces every lab's slab test is made of (pt_device.cuh's, the
// standalone traversal's).  slab_planes: the six plane distances (tx1,
// ty1, tz1, tx2, ty2, tz2) as (c - o) * inv, or with kFma as
// fmaf(c, inv, -oi) from the ray's hoisted products oi = o * inv (the
// JAX lab's fma arm: not bitwise (c - o) * inv); an axis with a zero
// direction component takes zero_slab's face-inclusive planes.
template <bool kFma = false>
PT_HD void slab_planes(const float* c, const pt::SlabRay& r, const float* oi,
                       float* p) {
  if constexpr (kFma) {
    p[0] = fmaf(c[0], r.ix, -oi[0]);
    p[1] = fmaf(c[1], r.iy, -oi[1]);
    p[2] = fmaf(c[2], r.iz, -oi[2]);
    p[3] = fmaf(c[3], r.ix, -oi[0]);
    p[4] = fmaf(c[4], r.iy, -oi[1]);
    p[5] = fmaf(c[5], r.iz, -oi[2]);
  } else {
    p[0] = (c[0] - r.ox) * r.ix;
    p[1] = (c[1] - r.oy) * r.iy;
    p[2] = (c[2] - r.oz) * r.iz;
    p[3] = (c[3] - r.ox) * r.ix;
    p[4] = (c[4] - r.oy) * r.iy;
    p[5] = (c[5] - r.oz) * r.iz;
  }
  if (r.zero) {
    if (r.zero & 1) pt::zero_slab(c[0], c[3], r.ox, p[0], p[3]);
    if (r.zero & 2) pt::zero_slab(c[1], c[4], r.oy, p[1], p[4]);
    if (r.zero & 4) pt::zero_slab(c[2], c[5], r.oz, p[2], p[5]);
  }
}

// The entry and exit distances of the box from its planes.
PT_HD void slab_span(const float* p, float& tmin, float& tmax) {
  tmin = fmaxf(fmaxf(fminf(p[0], p[3]), fminf(p[1], p[4])), fminf(p[2], p[5]));
  tmax = fminf(fminf(fmaxf(p[0], p[3]), fmaxf(p[1], p[4])), fmaxf(p[2], p[5]));
}

// Whether the ray enters the child (entry ent) before t (at t too with
// at_t): pt_device.cuh's conservative slab_hit.  Validity lives in the
// entry, never the bounds.
PT_HD bool slab_pass(float tmin, float tmax, float t, bool at_t, int ent) {
  return pt::slab_hit(tmin, tmax, t, at_t) && ent != pt::SLIM_EMPTY;
}

// The lab's nearest child, folded slot by slot: slot k's entry distance
// `dist` (+inf for a slot that fails) replaces the best so far only when
// strictly smaller, so the first strict minimum wins (slot 0 when none
// passes).
PT_HD void nearest_fold(float dist, int k, float* best, int* best_k) {
  if (k == 0) {
    *best = dist;
    *best_k = 0;
  } else if (dist < *best) {
    *best = dist;
    *best_k = k;
  }
}

// The slab tests of one block of 8 child slots (bounds b: 48 f32 in
// registers, 6 per slot; entries ent): bit k of the mask when slot k
// holds a child the ray enters before t (at t too with at_t); with kNear
// also the slot of the least entry distance (nearest_fold), folded into
// *best / *best_k from slot `base` on.
template <bool kNear>
PT_HD unsigned slab8(const float* b, const int* ent, const pt::SlabRay& r,
                     float t, bool at_t, int base, float* best, int* best_k) {
  unsigned w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float p[6], tmin, tmax;
    slab_planes(b + 6 * k, r, nullptr, p);
    slab_span(p, tmin, tmax);
    const bool pass = slab_pass(tmin, tmax, t, at_t, ent[k]);
    w |= pass ? (1u << k) : 0u;
    if constexpr (kNear) {
      nearest_fold(pass ? tmin : pt::INF_F, base + k, best, best_k);
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

// A triangle's hit (tt < 0 a miss; id, object obj) against the lane's
// closest hit: taken when strictly nearer, or at exactly the same t with
// the lower id -- with kLex the lower (object, id), for the 16-wide
// tables whose ids are local to their object (objects' triangles are
// numbered in object order, so it is the order of the global ids).
template <bool kLex>
PT_HD void take_closest(float tt, int id, int obj, LHit& h) {
  const bool lower = kLex ? (obj < h.obj || (obj == h.obj && id < h.tri))
                          : id < h.tri;
  if (tt >= 0.0f && (tt < h.t || (tt == h.t && lower))) {
    h.t = tt;
    h.tri = id;
    h.obj = obj;
  }
}

// A shading record's triangle test (tri_test: t, or < 0 for a miss).
PT_HD float record_t(const Ray& r, const float* rec) {
  return pt::tri_test(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, rec[0], rec[1],
                      rec[2], rec[3], rec[4], rec[5], rec[6], rec[7], rec[8]);
}

// A shading record (v0, e1, e2 at rec[0..8], object and id at rec[12],
// rec[13]) against the lane's closest hit.
template <bool kLex>
PT_HD void record_closest(const Ray& r, const float* rec, LHit& h) {
  take_closest<kLex>(record_t(r, rec), pt::as_int(rec[13]),
                     pt::as_int(rec[12]), h);
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

// The frame stack of 9-word frames (8 entries and a mask word, the
// lowest set bit popped first) of L1, L4 and L6.  seed_frames8: the
// roots after the first, 8 to a frame.
PT_HD void seed_frames8(const int* roots, int nroots, int* stack, int& sp) {
  for (int pos = 1; pos < nroots; pos += 8) {
    const int cnt = min(8, nroots - pos);
    for (int i = 0; i < cnt; ++i) stack[sp + i] = roots[pos + i];
    stack[sp + 8] = (1 << cnt) - 1;
    sp += FRAME8;
  }
}

// Push the frame of entries ent with mask w (non-zero) onto a stack of
// kCap words; false if it is full (the frame is dropped).
template <int kCap>
PT_HD bool frame_push8(const int* ent, unsigned w, int* stack, int& sp) {
  if (sp + FRAME8 > kCap) return false;
#pragma unroll
  for (int k = 0; k < 8; ++k) stack[sp + k] = ent[k];
  stack[sp + 8] = (int)w;
  sp += FRAME8;
  return true;
}

// Pop the top frame's lowest set slot (sp > 0); the frame goes when its
// mask is empty.
PT_HD int frame_pop8(int* stack, int& sp) {
  const int base = sp - FRAME8;
  const unsigned mw = (unsigned)stack[base + 8];
  const int e = stack[base + ctz(mw)];
  const unsigned rem = mw & (mw - 1);
  stack[base + 8] = (int)rem;
  if (rem == 0) sp = base;
  return e;
}

// Per-lane work counts of a count launch.
struct Counts {
  unsigned long long node = 0, leaf = 0, tri = 0;
};

// Mark a row read in the count launch's map.
PT_HD void mark(const LabArgs& a, int row) {
  if (a.seen) a.seen[row] = 1;
}

// After the loop: the warp's trips (and leaf trips) into counter `tile`
// (its tile of 1024 lanes; L7's pair of tiles), the count launch's work
// counters summed over the warp, and the overflow flag.  Every lane of
// the warp takes part.
__device__ __forceinline__ void finish(const LabArgs& a, int tile,
                                       int trips, int leaf_trips,
                                       const Counts& c, bool ok) {
  if (!ok) atomicOr(a.status, 1);
  const bool first = (threadIdx.x & 31) == 0;
  if (first && a.iters) atomicAdd(a.iters + tile, trips);
  if (first && a.leafs) atomicAdd(a.leafs + tile, leaf_trips);
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

// Launch `kernel` over `threads` threads (a->n by default) in blocks of
// `block` with `smem` bytes of dynamic shared memory on a->stream;
// returns cudaGetLastError().  Never synchronises.
inline int launch(void (*kernel)(const LabArgs), const LabArgs* a,
                  int threads = -1, int block = kBlock, size_t smem = 0) {
  if (threads < 0) threads = a->n;
  if (threads <= 0) return 0;
  const int grid = (threads + block - 1) / block;
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(a->stream)>>>(*a);
  return (int)cudaGetLastError();
}

// LabArgs' size and two offsets, for the ctypes mirror's check.
inline void args_layout(long long* out) {
  out[0] = (long long)sizeof(LabArgs);
  out[1] = (long long)offsetof(LabArgs, status);
  out[2] = (long long)offsetof(LabArgs, flags);
}

}  // namespace lab
