// Host build of the kernel's per-ray body (pt_device.cuh), for the CPU
// tests only: it runs the same traversal and shading code one lane after
// another, so a test can hold the device code against the plain PyTorch
// version without a card.  It stands in for nothing on the render path.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -ffp-contract=off

#include "pt_device.cuh"

namespace {

int run(const pt::PtArgs* a, bool hits_only) {
  if (a->small_words != pt::small_words(*a)) return -1;
  pt::Tables tb;
  pt::Tree tree, sh_tree;
  pt::unpack(*a, static_cast<const float*>(a->small), tb, tree, sh_tree);
  const pt::Params p = pt::make_params(*a, tree, sh_tree);
  pt::Counters cnt;
  bool ok = true;
  for (int lane = 0; lane < a->n; ++lane) {
    ok &= hits_only ? pt::hit_lane(*a, tree, lane, cnt)
                    : pt::trace_lane(p, tb, lane, cnt);
  }
  if (!ok) *static_cast<int*>(a->status) |= 1;
  if (a->iters) {
    auto* it = static_cast<unsigned long long*>(a->iters);
    it[0] += cnt.node;
    it[1] += cnt.leaf;
    it[2] += cnt.snode;
    it[3] += cnt.sleaf;
    it[4] += cnt.ray;
    it[5] += cnt.sray;
  }
  return 0;
}

}  // namespace

extern "C" int pt_frame_host(const pt::PtArgs* a) { return run(a, false); }

extern "C" int pt_closest_hit_host(const pt::PtArgs* a) { return run(a, true); }
