// Standalone BVH traversal for Hopper (sm_90a): closest hit or any hit of
// a batch of rays over the slim 8-wide closest-hit tables.
//
// Replaces the JAX package's Pallas kernel ops/traverse_packet_slim.py
// (_traverse_kernel, launched by traverse_packet_slim), its TLAS instance
// machinery (instanced=True: inst_inv, inst_root, the RESTORE marker, the
// hit's instance id) and its BVH-depth count (count_depth: bvh_depth, the
// node rows at which a child passed the push test) included.
// models/scene.intersect_scene calls it for the mesh arm of every scene
// query of the Whitted integrator and of the XLA integrator
// (models/integrators.trace_advanced): the closest hit of each depth's
// rays, counting depth when AOVs are on, and the any-hit of each shadow
// ray.  Per lane: t_init bounds the hit; a lane that is not active writes
// t_init, ids -1 and depth 0.  Returns t, original triangle id, object
// and flat normal (the shading payload of the leaf records).
//
// What bounds it on this card: neither HBM bytes (an active lane reads
// 32 bytes, one that is not active 8, and each writes 24) nor f32
// operations (26 per slab test, 55 per triangle test), but the latency
// of the dependent, scattered 224- and 512-byte node and leaf row loads
// of each ray's walk (mostly L2 hits) and warp divergence between rays
// that walk different subtrees.
//
// The node-table variants (kVar: the entry side tables with 64- or
// 48-col rows, 16-wide rows, the fused table) are the JAX kernel's arms
// over those tables, with and without the depth count, for the plain
// (non-instanced) arm, as in the JAX package.  So are the occl arms
// (pt_device.cuh kLeaf, the JAX function's occl / pay / occl_rows): the
// walk over an occlusion tree of 1-row leaves (kLeafOccl: the any hit,
// the leaf-14 closest hit with the payload rows of CPUGPU_LEAF14, the
// t-only closest hit) or 2-row leaves (kLeafOccl2, CPUGPU_OCCL2), 8- or
// 16-wide, with and without the depth count.
//
// What the design does about it (redesigned for this card; PERF.md §6):
// - Warps half empty on masked launches.  One thread per lane
//   (pt_launch.cuh launch), as before, the caller's morton sort of the
//   wavefront grouping coherent rays into warps: an inactive lane writes
//   its outputs at once (t_init, ids -1, a zero normal, depth 0), a live
//   one walks.  A persistent launch whose warps fetch 32 lanes at a time
//   from a zeroed counter was built and measured (PERF.md §6):
//   it ran the XLA route's sparse any hits ~4% faster, but the WHITTED
//   route's launches ~1% and the instance arm's ~3% slower; schedules
//   that hand a warp more than one fetch's live lanes were slower still.
// - Scalar leaf loads.  The any hit reads a shading leaf's 16-col
//   records with 16-byte loads, as the closest hit does (the 9-col
//   occlusion records at their unaligned stride stay scalar).
// - Lanes idle inside the walk.  The closest hits over shading leaves
//   without count_depth and without instances (pt::postponed: the plain
//   and variant arms) walk with postponed leaves (closest_hit's kPost,
//   the labs' L4 v1): a popped leaf waits in the ray's one slot while the
//   warp votes node trips and leaf trips apart, so a warp's trips are all
//   node rows or all leaf rows.  Hits stay bitwise by the exact-tie rule;
//   visit counts may differ from the slot-order walk's.  count_depth keeps
//   the slot-order walk, whose visit order the count follows, and so does
//   the instance arm, where a parked leaf would outlive its instance's
//   RESTORE.
// The roots ride in shared memory with the launch's small tables.  The
// depth count is one register and one store, built as its own template
// arm so the walks without it compile as before; count launches
// (count_iters) run their own arm (kTrips), whose walks count warp and
// lane trips.
//
// Build: as pt_frame.cu (ops/pt_frame.py builds every unit).

#include "pt_launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// kInst: the instance arm (object-space TLAS machinery); kDepth: the
// count_depth arm (bvh_depth out); kVar: the variant walks
// (pt::variant, never with kInst); kLeaf: the occl arms (variant only);
// kTrips: the count launch's arm (count_iters), whose walks count their
// trips; kPost: the closest hit with postponed leaves (pt::postponed).
// Built twelve ways, each with and without kTrips.
template <bool kInst, bool kDepth, bool kVar, int kLeaf, bool kTrips,
          bool kPost>
__global__ void __launch_bounds__(pt::kBlock)
    traverse_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = lane < a.n;
  const bool act = in && pt::lane_active(a, lane);
  pt::Counters cnt;
  bool ok = true;
  if (in && !act) pt::dead_lane<kDepth>(a, lane);
  // the postponed-leaf walk's votes take the whole warp, unless none of
  // its lanes is live
  if (kPost ? __any_sync(kFull, act) : act) {
    ok = pt::trace_ray<kInst, kDepth, kVar, kLeaf, kTrips, kPost>(
        a, p.tree, lane, cnt, act);
  }
  pt::finish(a, ok, cnt);
}

using Kernel = void (*)(const pt::PtArgs);

// One arm's kernel: its count arm (kTrips) under count_iters.
template <bool kInst, bool kDepth, bool kVar, int kLeaf = pt::kLeafShade,
          bool kPost = false>
Kernel arm(const pt::PtArgs& a) {
  if (a.iters) return traverse_kernel<kInst, kDepth, kVar, kLeaf, true, kPost>;
  return traverse_kernel<kInst, kDepth, kVar, kLeaf, false, kPost>;
}

// The variant walk's kernel under leaf arm kLeaf: with count_depth as the
// launch's depth column asks, or the postponed-leaf closest hit.
template <int kLeaf>
Kernel variant_arm(const pt::PtArgs& a) {
  if constexpr (kLeaf == pt::kLeafShade) {
    if (pt::postponed(a)) return arm<false, false, true, kLeaf, true>(a);
  }
  return a.depth_out ? arm<false, true, true, kLeaf>(a)
                     : arm<false, false, true, kLeaf>(a);
}

// The kernel a launch with these arguments takes (not refused).
Kernel kernel_for(const pt::PtArgs& a) {
  if (a.num_inst > 0) {
    return a.depth_out ? arm<true, true, false>(a) : arm<true, false, false>(a);
  }
  switch (pt::leaf_arm(a)) {
    case pt::kLeafOccl2:
      return variant_arm<pt::kLeafOccl2>(a);
    case pt::kLeafOccl:
      return variant_arm<pt::kLeafOccl>(a);
  }
  if (pt::variant(a)) return variant_arm<pt::kLeafShade>(a);
  if (pt::postponed(a)) return arm<false, false, false, pt::kLeafShade, true>(a);
  return a.depth_out ? arm<false, true, false>(a) : arm<false, false, false>(a);
}

}  // namespace

// Returns cudaGetLastError() after the launch (or -1 when the packed small
// tables do not match the layout, or an instance arm is asked for over
// variant or occlusion tables); never synchronises.
extern "C" int traverse_launch(const pt::PtArgs* a) {
  if (pt::refused(*a)) return -1;
  return pt::launch(kernel_for(*a), a);
}

// PtArgs' size and offsets (pt::args_layout), for the ctypes mirror check.
extern "C" int pt_args_layout(long long* out) {
  pt::args_layout(out);
  return 0;
}
