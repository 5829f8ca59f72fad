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

// The variant walk of one lane under leaf arm kLeaf, with or without
// count_depth, its closest hits over shading leaves with postponed leaves
// (pt::postponed), as csrc/traverse.cu picks its kernel.
template <int kLeaf>
bool variant_lane(const pt::Params& p, int lane, pt::Counters& cnt,
                  const pt::PtArgs& a) {
  if constexpr (kLeaf == pt::kLeafShade) {
    if (pt::postponed(a)) {
      return pt::traverse_lane<false, false, true, kLeaf, true>(a, p.tree,
                                                                lane, cnt);
    }
  }
  return a.depth_out
             ? pt::traverse_lane<false, true, true, kLeaf>(a, p.tree, lane, cnt)
             : pt::traverse_lane<false, false, true, kLeaf>(a, p.tree, lane,
                                                            cnt);
}

bool traverse_body(const pt::Params& p, const pt::Tables&, int lane,
                   pt::Counters& cnt, const pt::PtArgs& a) {
  if (a.num_inst > 0) {
    return a.depth_out ? pt::traverse_lane<true, true>(a, p.tree, lane, cnt)
                       : pt::traverse_lane<true>(a, p.tree, lane, cnt);
  }
  switch (pt::leaf_arm(a)) {
    case pt::kLeafOccl2:
      return variant_lane<pt::kLeafOccl2>(p, lane, cnt, a);
    case pt::kLeafOccl:
      return variant_lane<pt::kLeafOccl>(p, lane, cnt, a);
  }
  if (pt::variant(a)) return variant_lane<pt::kLeafShade>(p, lane, cnt, a);
  if (pt::postponed(a)) {
    return pt::traverse_lane<false, false, false, pt::kLeafShade, true>(
        a, p.tree, lane, cnt);
  }
  return a.depth_out ? pt::traverse_lane<false, true>(a, p.tree, lane, cnt)
                     : pt::traverse_lane<false>(a, p.tree, lane, cnt);
}

// count_iters: the host run's counts into a->iters.
void add_counts(const pt::PtArgs* a, const pt::Counters& cnt) {
  if (!a->iters) return;
  auto* it = static_cast<unsigned long long*>(a->iters);
  it[0] += cnt.node;
  it[1] += cnt.leaf;
  it[2] += cnt.snode;
  it[3] += cnt.sleaf;
  it[4] += cnt.ray;
  it[5] += cnt.sray;
  if (cnt.longest > it[pt::NUM_COUNTERS + 2]) {
    it[pt::NUM_COUNTERS + 2] = cnt.longest;
  }
}

int run(const pt::PtArgs* a, LaneFn fn) {
  if (a->small_words != pt::small_words(*a) || pt::refused(*a)) return -1;
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
  add_counts(a, cnt);
  return 0;
}

}  // namespace

extern "C" int pt_frame_host(const pt::PtArgs* a) {
  return run(a, pt::sh_leaf_arm(*a) == pt::kLeafOccl2
                    ? pt::trace_lane<true, pt::kLeafOccl2>
                : pt::variant(*a) ? pt::trace_lane<true>
                                  : pt::trace_lane<false>);
}

extern "C" int traverse_host(const pt::PtArgs* a) {
  return run(a, nullptr);
}

// The Whitted kernel's lanes one after another (count_iters' counts
// whenever asked), the traced total summed here.
extern "C" int whitted_host(const pt::PtArgs* a, const pt::WhittedIO* io) {
  if (a->small_words != pt::small_words(*a)) return -1;
  if (!io->traced) return -2;
  pt::Tables tb;
  pt::Tree tree, sh_tree;
  pt::unpack(*a, static_cast<const float*>(a->small), tb, tree, sh_tree);
  const pt::Params p = pt::make_params(*a, tree, sh_tree);
  pt::Counters cnt;
  long long tr = 0;
  for (int lane = 0; lane < a->n; ++lane) {
    tr += pt::whitted_lane<true>(p, tb, *io, lane, true, cnt);
  }
  *static_cast<long long*>(io->traced) = tr;
  add_counts(a, cnt);
  return 0;
}

// shade_extend's lane body under the arguments `a`, as csrc/megakernel.cu
// picks its kernel: with count_iters its count arm (kTrips).  (The host
// build's warp of one lane votes its own predicate in the postponed-leaf
// walk.)
template <bool kTrips>
LaneFn shade_extend_body(const pt::PtArgs& a) {
  constexpr int kShade = pt::kLeafShade;
  if (a.num_inst > 0) {
    return pt::shade_extend_lane<true, false, kShade, kTrips>;
  }
  if (pt::leaf_arm(a) == pt::kLeafOccl) {
    return pt::shade_extend_lane<false, true, pt::kLeafOccl, kTrips>;
  }
  return pt::variant(a) ? pt::shade_extend_lane<false, true, kShade, kTrips>
                        : pt::shade_extend_lane<false, false, kShade, kTrips>;
}

extern "C" int mk_shade_extend_host(const pt::PtArgs* a) {
  if (pt::leaf_arm(*a) == pt::kLeafOccl2) return -1;
  return run(a, a->iters ? shade_extend_body<true>(*a)
                         : shade_extend_body<false>(*a));
}

// shadow_resolve's lane body under the arguments `a`, as
// csrc/megakernel.cu picks its kernel: with count_iters its count arm.
template <bool kTrips>
LaneFn shadow_resolve_body(const pt::PtArgs& a) {
  constexpr int kShade = pt::kLeafShade;
  if (a.num_inst > 0) {
    return pt::shadow_resolve_lane<true, false, kShade, kTrips>;
  }
  if (pt::sh_leaf_arm(a) == pt::kLeafOccl2) {
    return pt::shadow_resolve_lane<false, true, pt::kLeafOccl2, kTrips>;
  }
  return pt::variant(a) ? pt::shadow_resolve_lane<false, true, kShade, kTrips>
                        : pt::shadow_resolve_lane<false, false, kShade, kTrips>;
}

extern "C" int mk_shadow_resolve_host(const pt::PtArgs* a) {
  return run(a, a->iters ? shadow_resolve_body<true>(*a)
                         : shadow_resolve_body<false>(*a));
}

extern "C" int pt_args_layout(long long* out) {
  pt::args_layout(out);
  return 0;
}

extern "C" int whitted_io_layout(long long* out) {
  out[0] = (long long)sizeof(pt::WhittedIO);
  out[1] = (long long)offsetof(pt::WhittedIO, traced);
  out[2] = (long long)offsetof(pt::WhittedIO, scratch);
  return 0;
}
