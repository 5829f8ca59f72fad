// The ADVANCED path tracer's whole-frame kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel ops/pt_frame_kernel.py
// (_pt_frame_kernel, launched by pt_frame): every depth of a batch of
// paths -- closest hit over the slim 8-wide tables, the TracePathAdvanced
// shading body, the NEE shadow any-hit over the occlusion tables plus the
// analytic occluders, and the energy add -- in one launch.  Span mode
// (depth_base, carry in / carry out) serves the split-span schedule of
// models/integrators.py.  pt_frame_kernel<false, ...> walks the plain
// 64-col tables; pt_frame_kernel<true, ...> (kVar) walks the node-table
// variants of the JAX kernel's arms -- the entry side tables (ents,
// sh_ents) with 64- or 48-col rows, the 16-wide 128-col rows (width=16)
// and the fused node|leaf table (fused_nn) -- on the closest-hit tree,
// and 64- or 48-col rows with or without sh_ents on the 8-wide shadow
// tree.  kShLeaf = kLeafOccl2 is the JAX kernel's occl_rows=2 arm
// (CPUGPU_OCCL2): the shadow walk reads occlusion leaves of two rows, 28
// records, over any of those layouts.
//
// What bounds it on this card: neither HBM bytes nor f32 operations.
// A lane reads 32 bytes and writes 24 (64 with the span carry), while its
// tree walk issues tens of dependent 224-byte node row loads and 512-byte
// leaf loads (scattered, mostly L2 hits: config 3's tables are 15 MB,
// inside the 50 MB L2) and data-dependent branches.  The kernel is bound
// by load latency and warp divergence: on config 3 at 1920x1080 it runs
// tens of times above the larger of its byte and operation bounds
// (PERF.md).  The arithmetic of a walk's trip (IEEE division in the
// triangle test, no contraction) is the bitwise contract and stays.
//
// The design, against the three things that hold such a walk back:
// - Lanes idle inside warps.  Paths die at different depths (a miss,
//   Russian roulette), and a block of one thread per lane holds its SM
//   until its longest path ends.  Instead the launch is persistent (Aila
//   and Laine, HPG 2009; path regeneration, Novak et al., EG 2010): as
//   many blocks as the card keeps resident (pt_launch.cuh
//   launch_persistent).  A thread holds one lane's path; one trip of its
//   loop is one depth step (pt_device.cuh step_lane: closest hit,
//   shading, the NEE shadow walk and its add).  When a path dies or its
//   span ends the thread writes the lane's outputs at the lane's own
//   index; once all of a warp's paths have ended the warp fetches 32
//   neighbouring lanes with one atomicAdd on the wrapper's zeroed
//   counter, one per thread in lane order.  A fetched lane that is
//   already dead (a carry-in lane of the split span's second launch)
//   writes its outputs at once, and its thread waits for the warp's next
//   fetch.  Each lane
//   runs the same arithmetic as before, so energy, RNG state, carry and
//   traced count are unchanged bitwise.  Measured (PERF.md): most idle
//   lanes are inside the walks, not dead paths, and the persistent warps
//   gain by refilling whole warps, not by raising the share of a warp's
//   lanes that work in a trip.  Refilling each thread as its path ends
//   measured slower.
// - Visit order.  Children are pushed in slot order, as B2-B4 push them
//   (pt_device.cuh closest_hit).  A nearest-first push (the labs' L6
//   order="nearest") was tried: it cut node visits by a few percent and
//   ran slower, and is not kept (PERF.md).
// - Stack size and occupancy.  The registers, not the stack, bound the
//   occupancy: kMinBlocks blocks per SM.  A stack sized to the tree's
//   width, and a shared-memory stack laid out [slot][thread], measured no
//   faster and are not kept.
// TMA and wgmma do not apply: each ray loads one data-dependent 224-byte
// node row per trip, not tiles, and the bitwise f32 contract has no
// matrix product.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//   -shared -Xcompiler -fPIC --fmad=false  (no fast-math: IEEE division
//   and square root, no contraction, so hits stay bit-equal to the
//   brute-force oracle).  ops/pt_frame.py builds and loads it.

#include "pt_launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// blocks of kBlock threads __launch_bounds__ asks to keep resident per SM:
// 4, as many as the walks' 119-121 registers allow (5 would cap them at
// 96; PERF.md)
constexpr int kMinBlocks = 4;

// kVar: the variant walks (pt::variant); kShLeaf: the shadow walk's leaf
// arm (pt::kLeafOccl2 for 2-row occlusion leaves, variant walks only);
// kTrips: the count launch's arm, whose walks count their trips
// (count_iters).  Built <false, 0>, <true, 0> and <true, 2>, each with
// and without kTrips.
template <bool kVar, int kShLeaf, bool kTrips>
__global__ void __launch_bounds__(pt::kBlock, kMinBlocks)
    pt_frame_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  int* const next = static_cast<int*>(a.next);
  const int me = threadIdx.x & 31;
  pt::Counters cnt;
  bool ok = true;
  pt::LaneRun run;
  bool busy = false;  // this thread holds a live lane
  for (;;) {
    if (__all_sync(kFull, !busy)) {
      // every path of the warp has ended: fetch the next 32 lanes
      int base = 0;
      if (me == 0) base = atomicAdd(next, 32);
      base = __shfl_sync(kFull, base, 0);
      if (base >= p.n) break;
      busy = base + me < p.n && pt::begin_lane(p, base + me, run);
    } else if (busy) {
      busy = pt::step_lane<kVar, kShLeaf, kTrips>(p, tb, run, cnt, ok);
    }
  }
  pt::finish(a, ok, cnt);
}

using Kernel = void (*)(const pt::PtArgs);

// One arm's kernel: its count arm (kTrips) under count_iters.
template <bool kVar, int kShLeaf>
Kernel arm(const pt::PtArgs& a) {
  if (a.iters) return pt_frame_kernel<kVar, kShLeaf, true>;
  return pt_frame_kernel<kVar, kShLeaf, false>;
}

// The kernel a launch with these arguments takes.
Kernel kernel_for(const pt::PtArgs& a) {
  if (pt::sh_leaf_arm(a) == pt::kLeafOccl2) return arm<true, pt::kLeafOccl2>(a);
  return pt::variant(a) ? arm<true, pt::kLeafShade>(a)
                        : arm<false, pt::kLeafShade>(a);
}

}  // namespace

// Returns cudaGetLastError() after the launch (or -1 when the packed small
// tables do not match the layout, -2 without the fetch counter); never
// synchronises.
extern "C" int pt_frame_launch(const pt::PtArgs* a) {
  return pt::launch_persistent(kernel_for(*a), a);
}

// The threads the launch with these arguments keeps resident (the card's
// SMs x the blocks per SM of the kernel it takes x kBlock; nothing is
// launched), or minus a CUDA error.
extern "C" int pt_frame_resident(const pt::PtArgs* a) {
  int threads = 0;
  const int err = pt::resident_threads(kernel_for(*a), *a, threads);
  return err ? -err : threads;
}
