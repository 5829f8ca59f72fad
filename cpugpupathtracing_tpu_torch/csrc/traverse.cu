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
// (non-instanced) arm, as in the JAX package.
//
// What the design does about it, in this first version: one thread per
// ray with its own stack in local memory, the walk of pt_device.cuh that
// pt_frame and the per-depth kernels also run (16-byte row loads through
// the read-only cache; the closest hit with the oracle's exact-tie rule),
// an any-hit that stops at the first hit; the roots ride in shared memory
// with the launch's small tables.  Lanes that are not active exit at
// once, so a shadow launch's cost follows its shadow rays; the caller's
// morton sort of the wavefront groups coherent rays into warps.  The
// depth count is one register and one store, built as its own template
// arm so the walks without it compile as before.
//
// Build: as pt_frame.cu (ops/pt_frame.py builds every unit).

#include "pt_launch.cuh"

namespace {

// kInst: the instance arm (object-space TLAS machinery); kDepth: the
// count_depth arm (bvh_depth out); kVar: the variant walks
// (pt::variant, never with kInst); built six ways
template <bool kInst, bool kDepth, bool kVar>
__global__ void __launch_bounds__(pt::kBlock)
    traverse_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  pt::Counters cnt;
  const bool ok =
      lane >= a.n ||
      pt::traverse_lane<kInst, kDepth, kVar>(a, p.tree, lane, cnt);
  pt::finish(a, ok, cnt);
}

}  // namespace

// Returns cudaGetLastError() after the launch (or -1 when the packed small
// tables do not match the layout, or an instance arm is asked for over
// variant tables); never synchronises.
extern "C" int traverse_launch(const pt::PtArgs* a) {
  const bool var = pt::variant(*a);
  if (a->num_inst > 0) {
    if (var) return -1;
    return a->depth_out ? pt::launch(traverse_kernel<true, true, false>, a)
                        : pt::launch(traverse_kernel<true, false, false>, a);
  }
  if (var) {
    return a->depth_out ? pt::launch(traverse_kernel<false, true, true>, a)
                        : pt::launch(traverse_kernel<false, false, true>, a);
  }
  return a->depth_out ? pt::launch(traverse_kernel<false, true, false>, a)
                      : pt::launch(traverse_kernel<false, false, false>, a);
}

// PtArgs' size and offsets (pt::args_layout), for the ctypes mirror check.
extern "C" int pt_args_layout(long long* out) {
  pt::args_layout(out);
  return 0;
}
