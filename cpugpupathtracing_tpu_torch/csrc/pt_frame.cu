// The ADVANCED path tracer's whole-frame kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel ops/pt_frame_kernel.py
// (_pt_frame_kernel, launched by pt_frame): every depth of a batch of
// paths -- closest hit over the slim 8-wide tables, the TracePathAdvanced
// shading body, the NEE shadow any-hit over the occlusion tables plus the
// analytic occluders, and the energy add -- in one launch.  Span mode
// (depth_base, carry in / carry out) serves the split-span schedule of
// models/integrators.py.  pt_frame_kernel<false> walks the
// plain 64-col tables; pt_frame_kernel<true> (kVar) walks the node-table
// variants of the JAX kernel's arms -- the entry side tables (ents,
// sh_ents) with 64- or 48-col rows, the 16-wide 128-col rows (width=16)
// and the fused node|leaf table (fused_nn) -- on the closest-hit tree,
// and 64- or 48-col rows with or without sh_ents on the 8-wide shadow
// tree.
//
// What bounds it on this card: neither HBM bytes nor f32 operations.
// A lane reads 32 bytes and writes 24 (64 with the span carry), while its
// tree walk issues tens of dependent 256- and 512-byte node / leaf loads
// (scattered, mostly L2 hits: config 3's tables are 15 MB, inside the
// 50 MB L2) and data-dependent branches.  The kernel is bound by load
// latency and warp divergence: on config 3 at 1920x1080 it runs tens of
// times above the larger of its byte and operation bounds (PERF.md).
//
// The variant rows change the bytes per node visit (224 B loaded from
// every 8-wide layout's row and side table, fused included; 448 B from a
// 16-wide row), not what bounds the kernel.
//
// What the design does about it, in this first version: one thread per
// ray with its own stack in local memory (no shared-stack packets, which
// were the TPU's answer to having no per-lane gathers); node rows are
// read as 16-byte vector loads through the read-only cache; the small
// scene tables (materials, lights, spheres, planes, roots) are copied
// once per block into shared memory, where shading's per-lane divergent
// lookups cost no global traffic; a lane leaves the depth loop as soon as
// its path dies.  Ray compaction, persistent threads and node caching in
// shared memory are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//   -shared -Xcompiler -fPIC --fmad=false  (no fast-math: IEEE division
//   and square root, no contraction, so hits stay bit-equal to the
//   brute-force oracle).  ops/pt_frame.py builds and loads it.

#include "pt_launch.cuh"

namespace {

// kVar: the variant walks (pt::variant); built both ways
template <bool kVar>
__global__ void __launch_bounds__(pt::kBlock)
    pt_frame_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  pt::Counters cnt;
  const bool ok = lane >= a.n || pt::trace_lane<kVar>(p, tb, lane, cnt);
  pt::finish(a, ok, cnt);
}

}  // namespace

// Returns cudaGetLastError() after the launch (or -1 when the packed small
// tables do not match the layout); never synchronises.
extern "C" int pt_frame_launch(const pt::PtArgs* a) {
  return pt::variant(*a) ? pt::launch(pt_frame_kernel<true>, a)
                         : pt::launch(pt_frame_kernel<false>, a);
}
