// The traversal lab L4 for Hopper (sm_90a): closest hit of a ray batch
// over the slim 8-wide split tables with deferred leaves, under the
// schedule of the JAX package's tools/phase_lab.py.
//
// Replaces tools/phase_lab.py's Pallas kernel `traverse_phase`
// (_phase_kernel): L1's frame stack with conditional pushes, plus one
// pending-leaf slot per ray.  A popped leaf is parked in the slot and the
// walk goes on over interior nodes; a trip runs in LEAF MODE when some
// lane of the warp pops a leaf while its slot is full, or when no lane
// holds an interior entry and some lane holds a pending or current leaf.
// In leaf mode every lane with a pending or current leaf tests one leaf
// row (with drain2 both: the pending one, then the current one) and the
// lanes whose current entry was a leaf pop; the others hold their
// entries.  Otherwise the trip is an interior trip: slab, push, pop, a
// popped leaf into the slot.  This is the "while-while" loop with
// postponed leaves of Aila and Laine (HPG 2009) at warp granularity:
// the votes make leaf trips dense.  labs/phase_lab.py wraps it; its plain
// version steps every lane in lockstep, votes per 32 lanes, and equals
// the kernel bitwise, counters included.
//
// What bounds it: as the other walks (lab2.cu), the latency of each
// ray's dependent row loads and the warp's divergence; the split trips
// trade divergence between slab and leaf work for more trips, and a
// parked leaf cannot shrink t until it drains, so slab pruning runs on a
// staler t.
//
// Build: ops/pt_frame.py builds every unit (nvcc, sm_90a, --fmad=false).

#include "lab_device.cuh"

namespace {

using lab::DONE;
using lab::FSTACK8;

template <bool kDrain2>
__global__ void __launch_bounds__(lab::kBlock)
    lab_phase_kernel(const lab::LabArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool act = lab::lane_active(a, lane);
  lab::Ray r{};
  lab::LHit h{lane < a.n ? a.t_init[lane] : 0.0f, -1, -1};
  int stack[FSTACK8];
  int sp = 0, e = DONE, pend = -1;
  bool ok = true;
  if (act) {
    r = lab::load_ray(a, lane);
    e = a.roots[0];
    lab::seed_frames8(a.roots, a.nroots, stack, sp);
  }
  int trips = 0, leaf_trips = 0;
  lab::Counts cnt;
  // the lane's next frame-stack pop (phase_lab's pop: lowest set bit)
  auto pop = [&]() { e = sp > 0 ? lab::frame_pop8(stack, sp) : DONE; };
  auto drain = [&](int lrow) {
    lab::leaf_closest<false>(a.ltris + (size_t)lrow * 128, nullptr, r, h);
    lab::mark(a, a.node_rows + lrow);
    ++cnt.leaf;
    cnt.tri += pt::LEAF_TRIS;
  };
  while (__any_sync(lab::kFull, e != DONE || pend >= 0)) {
    ++trips;
    const bool live = e != DONE;
    const bool is_leaf = live && e < 0;
    const bool is_int = live && e >= 0;
    const bool has_p = pend >= 0;
    const bool collide = __any_sync(lab::kFull, is_leaf && has_p);
    const bool any_int = __any_sync(lab::kFull, is_int);
    const bool any_leafish = __any_sync(lab::kFull, is_leaf || has_p);
    if (collide || (any_leafish && !any_int)) {
      ++leaf_trips;
      if constexpr (kDrain2) {
        if (has_p) drain(pend);
        if (is_leaf) drain(-e - 1);
        pend = -1;
      } else {
        if (has_p || is_leaf) drain(has_p ? pend : -e - 1);
        pend = is_leaf && has_p ? -e - 1 : -1;
      }
      if (is_leaf) pop();
    } else {
      if (is_int) {
        float b[56];
        int ent[8];
        lab::load_row<14>(a.nodes + (size_t)e * 64, b);
        lab::entries<8>(b + 48, ent);
        const unsigned w =
            lab::slab8<false>(b, ent, r.sr, h.t, true, 0, nullptr, nullptr);
        lab::mark(a, e);
        ++cnt.node;
        // a full stack: the wrapper's depth check rules this out
        if (w != 0 && !lab::frame_push8<FSTACK8>(ent, w, stack, sp)) {
          ok = false;
        }
      }
      // a popped leaf waits in the slot (empty here: a full one would
      // have made this a leaf trip)
      if (is_leaf) pend = -e - 1;
      if (live) pop();
    }
  }
  lab::store(a, lane, h);
  lab::finish(a, lane / lab::kTile, trips, leaf_trips, cnt, ok);
}

}  // namespace

// a->flags: bit 0 drain2.  Returns cudaGetLastError() after the launch;
// never synchronises.
extern "C" int phase_launch(const lab::LabArgs* a) {
  return (a->flags & 1) ? lab::launch(lab_phase_kernel<true>, a)
                        : lab::launch(lab_phase_kernel<false>, a);
}
