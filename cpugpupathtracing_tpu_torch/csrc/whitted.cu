// The Whitted raytracer's whole-frame kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel ops/whitted_kernel.py
// (_whitted_kernel, launched by whitted_frame): on an all-analytic scene
// (benchmark config 1: spheres, a plane, point lights) every depth of a
// lane -- the sphere / plane closest hit, emission, per-light shadow
// tests and the dielectric / mirror continuation -- in one launch.  The
// per-lane body is whitted.cuh.
//
// What bounds it on this card: HBM bytes, barely.  A lane reads 32 bytes
// (ray and RNG state) and writes 24 (energy, state, traced); in between
// it does ~390 f32 operations per live depth on config 1 (6 sphere and 1
// plane test for the closest hit, shading, the two lights' directions and
// the Fresnel continuation) and ~180 per shadow ray (the 7 occluder
// tests), out of registers and shared memory, with no gathers.  At
// 800x600 and 5 depths that is ~0.28 GFLOP (0.004 ms at the f32 peak)
// against ~27 MB (0.008 ms at the HBM rate), so the bytes bound is the
// larger; the kernel takes ~0.03 ms on an H100 80GB HBM3 at 700 W,
// about 4x above it, where divergence between live and dead lanes of a
// warp and the division / square-root throughput show.  The frame around
// it is bound by the host (the launch is under 1% of it; PERF.md).
//
// What the design does about it, in this first version: one thread per
// lane looping over the depths with the whole carry in registers; the
// small scene tables (materials, lights, spheres, planes) copied once per
// block into shared memory (pt_launch.cuh), where every lane reads them
// with broadcasts; a dead lane only steps its RNG state.
//
// Build: as pt_frame.cu (ops/pt_frame.py builds every unit).

#include "pt_launch.cuh"
#include "whitted.cuh"

namespace {

__global__ void __launch_bounds__(pt::kBlock)
    whitted_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  pt::Counters cnt;
  const bool ok = lane >= a.n || pt::whitted_lane(p, tb, lane, cnt);
  pt::finish(a, ok, cnt);
}

}  // namespace

// Returns cudaGetLastError() after the launch (or -1 when the packed small
// tables do not match the layout); never synchronises.
extern "C" int whitted_launch(const pt::PtArgs* a) {
  return pt::launch(whitted_kernel, a);
}
