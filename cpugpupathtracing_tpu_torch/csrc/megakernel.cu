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
// (non-instanced) arm only, as in the JAX package.
//
// What the design does about it, in this first version: one thread per
// lane with its own stack in local memory; a lane with nothing to do
// (not active, or no shadow ray) only copies its columns, so a depth's
// cost follows the surviving paths -- the per-lane form of the Pallas
// kernels' skip of all-dead 1024-lane sub-tiles; the small scene tables
// go to shared memory once per block (pt_launch.cuh).  Between depths
// the caller's wavefront sorts (compaction, then morton regrouping) pack
// live lanes into whole warps.  Persistent threads and node caching in
// shared memory are left for later work.
//
// Build: as pt_frame.cu (ops/pt_frame.py builds both, one nvcc each).

#include "pt_launch.cuh"

namespace {

// kInst: the instance arm (the TLAS machinery of the object-space
// instanced scene; the instance tables ride in PtArgs, not in the
// shared-memory pack); kVar: the variant walks (pt::variant).  Each
// kernel is built <false, false>, <true, false> and <false, true>.
template <bool kInst, bool kVar>
__global__ void __launch_bounds__(pt::kBlock)
    shade_extend_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  pt::Counters cnt;
  const bool ok =
      lane >= a.n || pt::shade_extend_lane<kInst, kVar>(p, tb, lane, cnt);
  pt::finish(a, ok, cnt);
}

template <bool kInst, bool kVar>
__global__ void __launch_bounds__(pt::kBlock)
    shadow_resolve_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  pt::Counters cnt;
  const bool ok =
      lane >= a.n || pt::shadow_resolve_lane<kInst, kVar>(p, tb, lane, cnt);
  pt::finish(a, ok, cnt);
}

}  // namespace

// Both entries return cudaGetLastError() after the launch (or -1 when the
// packed small tables do not match the layout, or an instance arm is
// asked for over variant tables); they never synchronise.
extern "C" int mk_shade_extend_launch(const pt::PtArgs* a) {
  if (a->num_inst > 0) {
    return pt::variant(*a) ? -1 : pt::launch(shade_extend_kernel<true, false>, a);
  }
  return pt::variant(*a) ? pt::launch(shade_extend_kernel<false, true>, a)
                         : pt::launch(shade_extend_kernel<false, false>, a);
}

extern "C" int mk_shadow_resolve_launch(const pt::PtArgs* a) {
  if (a->num_inst > 0) {
    return pt::variant(*a) ? -1
                           : pt::launch(shadow_resolve_kernel<true, false>, a);
  }
  return pt::variant(*a) ? pt::launch(shadow_resolve_kernel<false, true>, a)
                         : pt::launch(shadow_resolve_kernel<false, false>, a);
}
