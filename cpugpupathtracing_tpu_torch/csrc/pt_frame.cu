// The ADVANCED path tracer's whole-frame kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel ops/pt_frame_kernel.py
// (_pt_frame_kernel, launched by pt_frame): every depth of a batch of
// paths -- closest hit over the slim 8-wide tables, the TracePathAdvanced
// shading body, the NEE shadow any-hit over the occlusion tables plus the
// analytic occluders, and the energy add -- in one launch.  Span mode
// (depth_base, carry in / carry out) serves the split-span schedule of
// models/integrators.py.
//
// What bounds it on this card: neither HBM bytes nor f32 operations.
// A lane reads 32 bytes and writes 24 (64 with the span carry), while its
// tree walk issues tens of dependent 256- and 512-byte node / leaf loads
// (scattered, mostly L2 hits: config 3's tables are 15 MB, inside the
// 50 MB L2) and data-dependent branches.  The kernel is bound by load
// latency and warp divergence: on config 3 at 1920x1080 it runs tens of
// times above the larger of its byte and operation bounds (PERF.md).
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

#include <cuda_runtime.h>

#include "pt_device.cuh"

namespace {

constexpr int kBlock = 128;

__device__ void reduce_counters(pt::Counters c, unsigned long long* iters) {
  unsigned long long v[pt::NUM_COUNTERS] = {c.node, c.leaf, c.snode,
                                            c.sleaf, c.ray, c.sray};
#pragma unroll
  for (int k = 0; k < pt::NUM_COUNTERS; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < pt::NUM_COUNTERS; ++k) atomicAdd(iters + k, v[k]);
  }
}

__device__ void load_small(const pt::PtArgs& a, float* smem) {
  const float* src = static_cast<const float*>(a.small);
  for (int i = threadIdx.x; i < a.small_words; i += blockDim.x) {
    smem[i] = src[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock)
    pt_frame_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  load_small(a, smem);
  pt::Tables tb;
  pt::Tree tree, sh_tree;
  pt::unpack(a, smem, tb, tree, sh_tree);
  const pt::Params p = pt::make_params(a, tree, sh_tree);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  pt::Counters cnt;
  if (lane < a.n && !pt::trace_lane(p, tb, lane, cnt)) {
    atomicOr(static_cast<int*>(a.status), 1);
  }
  if (a.iters) {
    reduce_counters(cnt, static_cast<unsigned long long*>(a.iters));
  }
}

__global__ void __launch_bounds__(kBlock)
    pt_closest_hit_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  load_small(a, smem);
  pt::Tables tb;
  pt::Tree tree, sh_tree;
  pt::unpack(a, smem, tb, tree, sh_tree);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  pt::Counters cnt;
  if (lane < a.n && !pt::hit_lane(a, tree, lane, cnt)) {
    atomicOr(static_cast<int*>(a.status), 1);
  }
  if (a.iters) {
    reduce_counters(cnt, static_cast<unsigned long long*>(a.iters));
  }
}

int launch(void (*kernel)(const pt::PtArgs), const pt::PtArgs* a) {
  if (a->small_words != pt::small_words(*a)) return -1;
  if (a->n <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)a->small_words;
  const int grid = (a->n + kBlock - 1) / kBlock;
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(a->stream)>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries return cudaGetLastError() after the launch (or -1 when the
// packed small tables do not match the layout); they never synchronise.
extern "C" int pt_frame_launch(const pt::PtArgs* a) {
  return launch(pt_frame_kernel, a);
}

// Test hook: the kernel's closest-hit traversal alone, over 6 ray
// columns, into hit_out.  The path tracer never calls it.
extern "C" int pt_closest_hit_launch(const pt::PtArgs* a) {
  return launch(pt_closest_hit_kernel, a);
}
