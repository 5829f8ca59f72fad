// Host build of the kernels' per-lane bodies (pt_device.cuh), for the CPU
// tests only: it runs the same traversal and shading code one lane after
// another, so a test can hold the device code against the plain PyTorch
// versions without a card.  It stands in for nothing on the render path.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -ffp-contract=off

#include "pt_device.cuh"
#include "whitted.cuh"

namespace {

using LaneFn = bool (*)(const pt::Params&, const pt::Tables&, int,
                        pt::Counters&);

bool traverse_body(const pt::Params& p, const pt::Tables&, int lane,
                   pt::Counters& cnt, const pt::PtArgs& a) {
  if (a.depth_out) {
    return a.num_inst > 0
               ? pt::traverse_lane<true, true>(a, p.tree, lane, cnt)
               : pt::traverse_lane<false, true>(a, p.tree, lane, cnt);
  }
  return a.num_inst > 0 ? pt::traverse_lane<true>(a, p.tree, lane, cnt)
                        : pt::traverse_lane<false>(a, p.tree, lane, cnt);
}

int run(const pt::PtArgs* a, LaneFn fn) {
  if (a->small_words != pt::small_words(*a)) return -1;
  pt::Tables tb;
  pt::Tree tree, sh_tree;
  pt::unpack(*a, static_cast<const float*>(a->small), tb, tree, sh_tree);
  const pt::Params p = pt::make_params(*a, tree, sh_tree);
  pt::Counters cnt;
  bool ok = true;
  for (int lane = 0; lane < a->n; ++lane) {
    ok &= fn ? fn(p, tb, lane, cnt) : traverse_body(p, tb, lane, cnt, *a);
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

extern "C" int pt_frame_host(const pt::PtArgs* a) {
  return run(a, pt::trace_lane);
}

extern "C" int traverse_host(const pt::PtArgs* a) {
  return run(a, nullptr);
}

extern "C" int whitted_host(const pt::PtArgs* a) {
  return run(a, pt::whitted_lane);
}

extern "C" int mk_shade_extend_host(const pt::PtArgs* a) {
  return run(a, a->num_inst > 0 ? pt::shade_extend_lane<true>
                                : pt::shade_extend_lane<false>);
}

extern "C" int mk_shadow_resolve_host(const pt::PtArgs* a) {
  return run(a, a->num_inst > 0 ? pt::shadow_resolve_lane<true>
                                : pt::shadow_resolve_lane<false>);
}

extern "C" int pt_args_layout(long long* out) {
  pt::args_layout(out);
  return 0;
}
