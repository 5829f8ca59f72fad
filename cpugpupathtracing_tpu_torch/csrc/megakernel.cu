// The ADVANCED path tracer's per-depth kernels for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels of ops/megakernel.py, instance
// arms (the TLAS machinery: ops/megakernel.py _emit_traversal's
// num_inst > 0 arm and the inst_nrm normal epilogue) included:
//   shade_extend_kernel    _shade_extend_kernel (launched by shade_extend):
//                          one depth of the wavefront -- the closest hit
//                          over the slim 8-wide tables and the
//                          TracePathAdvanced shading body -- emitting the
//                          next ray and carry, flags (bit 2 = shadow
//                          needed) and the NEE shadow ray with its
//                          premultiplied contribution;
//   shadow_resolve_kernel  _shadow_resolve_kernel (launched by
//                          shadow_resolve): the NEE shadow any-hit over
//                          the occlusion (or shading) tables plus the
//                          analytic occluders, and the energy add.
// models/integrators.py's trace_advanced_mega launches both once per
// depth.  The per-lane bodies (pt_device.cuh shade_extend_lane,
// shadow_resolve_lane) call the same header functions as pt_frame's
// trace_lane, so the two routes agree bitwise per lane.
//
// What bounds them on this card: as for pt_frame, neither HBM bytes nor
// f32 operations.  A shade_extend lane moves 160 bytes of columns and a
// shadow_resolve lane 28-68, but each live lane walks a tree with
// dependent, scattered 256- and 512-byte row loads (mostly L2 hits) and
// divergent branches: load latency and warp divergence bound them.
//
// The node-table variants (kVar: the entry side tables with 64- or
// 48-col rows, 16-wide rows, the fused table; pt_device.cuh push_node)
// are the JAX kernels' arms over those tables, built for the plain
// (non-instanced) arm only, as in the JAX package.  So are the leaf arms
// (pt_device.cuh kLeaf): shade_extend's leaf-14 closest hit over the
// occlusion tree with its payload rows (pay, CPUGPU_LEAF14) and
// shadow_resolve's any hit over 2-row occlusion leaves (occl_rows=2,
// CPUGPU_OCCL2); shadow_resolve over 16-wide occlusion rows
// (CPUGPU_OCCL_W16) is its variant arm at sh_width 16.
//
// What the design does about it: one thread per lane with its own stack
// in local memory; a lane with nothing to do (not active, or no shadow
// ray) only copies its columns, so a depth's cost follows the surviving
// paths -- the per-lane form of the Pallas kernels' skip of all-dead
// 1024-lane sub-tiles; the small scene tables go to shared memory once
// per block (pt_launch.cuh).  Between depths the caller's wavefront
// sorts (compaction, then morton regrouping) pack live lanes into whole
// warps.  shade_extend was redesigned for this card (PERF.md §6),
// against what measurement put on its time: the walks of the live rays
// (throughput-bound on the incoherent bounce rays of depth 1), the
// slowest warp's walk (the later depths: a quarter of the live rays
// takes nearly the time of all of them) and the pass-through of the dead
// lanes, which did not overlap the slowest walk:
// - Streaming columns.  Every lane's columns, 60 bytes in and 100 out,
//   are read and written with ld.global.cs / st.global.cs (pt_device.cuh
//   col_ld, col_st): 332 MB a launch passes through L2 without evicting
//   the tree's rows, which the slowest walks keep reading.
// - Postponed leaves (closest_hit's kPost, as traverse.cu's closest
//   hits) at every depth of the arms over shading leaves without
//   instances (pt::shade_extend_lane): every thread of the warp takes
//   the walk, a thread without a live path only votes.  The instance
//   and leaf-14 arms keep the slot-order walk.
// Built, measured and dropped (PERF.md §6): a warp-uniform exit for
// warps without a live path and a block vote that skips the tables' copy
// where no lane is live (faster on an all-dead launch, slower on every
// launch with live lanes), and prefetching the next stack entry's rows
// into L1 at each pop (slower on every route).
//
// Build: as pt_frame.cu (ops/pt_frame.py builds both, one nvcc each).

#include "pt_launch.cuh"

namespace {

// kInst: the instance arm (the TLAS machinery of the object-space
// instanced scene; the instance tables ride in PtArgs, not in the
// shared-memory pack); kVar: the variant walks (pt::variant); kLeaf: the
// walk's leaf arm (variant only); kTrips: shade_extend's count arm
// (count_iters), whose walks count their warp and lane trips.
// shade_extend is built <false, false>, <true, false>, <false, true> and
// <false, true, kLeafOccl> (pay), each with and without kTrips;
// shadow_resolve <false, false>, <true, false>, <false, true> and
// <false, true, kLeafOccl2>.
template <bool kInst, bool kVar, int kLeaf, bool kTrips>
__global__ void __launch_bounds__(pt::kBlock)
    shade_extend_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  pt::Counters cnt;
  // every thread of the warp takes the lane body (the postponed-leaf
  // walk's votes), one past n without a lane
  const bool ok =
      pt::shade_extend_lane<kInst, kVar, kLeaf, kTrips>(p, tb, lane, cnt);
  pt::finish(a, ok, cnt);
}

template <bool kInst, bool kVar, int kLeaf = pt::kLeafShade>
__global__ void __launch_bounds__(pt::kBlock)
    shadow_resolve_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  pt::Counters cnt;
  const bool ok =
      lane >= a.n ||
      pt::shadow_resolve_lane<kInst, kVar, kLeaf>(p, tb, lane, cnt);
  pt::finish(a, ok, cnt);
}

using Kernel = void (*)(const pt::PtArgs);

// One arm of shade_extend: its count arm (kTrips) under count_iters.
template <bool kInst, bool kVar, int kLeaf = pt::kLeafShade>
Kernel se_arm(const pt::PtArgs& a) {
  if (a.iters) return shade_extend_kernel<kInst, kVar, kLeaf, true>;
  return shade_extend_kernel<kInst, kVar, kLeaf, false>;
}

}  // namespace

// Both entries return cudaGetLastError() after the launch (or -1 when the
// packed small tables do not match the layout, or an instance arm is
// asked for over variant tables or with a leaf arm); they never
// synchronise.
extern "C" int mk_shade_extend_launch(const pt::PtArgs* a) {
  if (pt::refused(*a)) return -1;
  if (a->num_inst > 0) return pt::launch(se_arm<true, false>(*a), a);
  switch (pt::leaf_arm(*a)) {
    case pt::kLeafOccl:
      return pt::launch(se_arm<false, true, pt::kLeafOccl>(*a), a);
    case pt::kLeafOccl2:
      return -1;  // the leaf-14 payload has 1-row leaves only
  }
  return pt::launch(pt::variant(*a) ? se_arm<false, true>(*a)
                                    : se_arm<false, false>(*a),
                    a);
}

extern "C" int mk_shadow_resolve_launch(const pt::PtArgs* a) {
  if (pt::refused(*a)) return -1;
  if (a->num_inst > 0) {
    return pt::launch(shadow_resolve_kernel<true, false>, a);
  }
  if (pt::sh_leaf_arm(*a) == pt::kLeafOccl2) {
    return pt::launch(shadow_resolve_kernel<false, true, pt::kLeafOccl2>, a);
  }
  return pt::variant(*a) ? pt::launch(shadow_resolve_kernel<false, true>, a)
                         : pt::launch(shadow_resolve_kernel<false, false>, a);
}
