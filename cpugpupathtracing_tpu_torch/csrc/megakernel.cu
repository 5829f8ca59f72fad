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
// (non-instanced) arm only, as in the JAX package.  So are the leaf arms
// (pt_device.cuh kLeaf): shade_extend's leaf-14 closest hit over the
// occlusion tree with its payload rows (pay, CPUGPU_LEAF14) and
// shadow_resolve's any hit over 2-row occlusion leaves (occl_rows=2,
// CPUGPU_OCCL2); shadow_resolve over 16-wide occlusion rows
// (CPUGPU_OCCL_W16) is its variant arm at sh_width 16.
//
// What the design does about it: one thread per lane (blocks of 128,
// pt_launch.cuh launch); the small scene tables go to shared memory once
// per block; a lane with nothing to do (not active, or no shadow ray)
// only copies its columns, so a depth's cost follows the surviving paths
// -- the per-lane form of the Pallas kernels' skip of all-dead 1024-lane
// sub-tiles.  Between depths the caller's wavefront sorts (compaction,
// then morton regrouping) pack live lanes into whole warps.  Both
// kernels were redesigned for this card (PERF.md §6), each against what
// measurement put on its time.
//
// shade_extend: the walks of the live rays (throughput-bound on the
// incoherent bounce rays of depth 1), the slowest warp's walk (the later
// depths: a quarter of the live rays takes nearly the time of all of
// them) and the pass-through of the dead lanes, which did not overlap
// the slowest walk:
// - Streaming columns.  Every lane's columns, 60 bytes in and 100 out,
//   are read and written with ld.global.cs / st.global.cs (pt_device.cuh
//   col_ld, col_st): 332 MB a launch passes through L2 without evicting
//   the tree's rows, which the slowest walks keep reading.
// - Postponed leaves (closest_hit's kPost, as traverse.cu's closest
//   hits) at every depth of the arms over shading leaves without
//   instances (pt::shade_extend_lane): every thread of the warp takes
//   the walk, a thread without a live path only votes.  The instance
//   and leaf-14 arms keep the slot-order walk.
// Built, measured and dropped: a warp-uniform exit for warps without a
// live path and a block vote that skips the tables' copy where no lane
// is live (faster on an all-dead launch, slower on every launch with
// live lanes), and prefetching the next stack entry's rows into L1 at
// each pop (slower on every route).
//
// shadow_resolve: depth 0 is the throughput of ~760,000 walks of 3.9 rows
// on average; every later depth is its longest walk (52-84 rows), at
// 2.7-3.9 us a row, and the dead lanes' pass-through (0.031 ms of 2
// million lanes) overlaps it:
// - A warp with at most kCoop (16) shadow rays -- the later depths have
//   one in tens to hundreds of lanes -- walks each of them with all 32
//   lanes (coop_any_hit): a node's 8 or 16 slots, a leaf's 8, 14 or 28
//   records, one per lane, read through the same layout helpers as a
//   lane's own walk (pt_device.cuh node_slots, leaf_rows, leaf_record),
//   the passing children on the warp's stack in shared memory.  A row
//   then costs about one load latency and one test, where a lane's own
//   walk pays a latency per group of records and every test in turn.  The
//   instance arm takes it too.  A launch of fewer than half the warps
//   the card keeps resident (kWaveDiv) gives it only warps with at most 2
//   rays.
// - A warp with more walks one ray per lane in slot order; the default
//   any-hit tree's 1-row occlusion leaves are read as 16-byte vectors
//   with every record tested (pt_device.cuh occl_row_any_vec), where the
//   scalar loop's loads of record k + 1 waited on record k's test.
// - Flags and energy are loaded together, every column as streaming
//   traffic (col_ld / col_st), so the tree's rows stay in L2 under the
//   2-million-lane pass-through.
// - 5 blocks per SM on the timed arms without instances (96 registers, no
//   spill), 4 on the instance and count arms.
// Built, measured and dropped: persistent warps that fetch runs of 32 to
// 256 lanes from a counter (with the live lanes compacted into whole
// warps or walked in place: the walks of a dense run sit on few warps,
// and one counter serves 64,800 fetches a launch), postponed leaves for
// the any hit (faster only on the dense depths, and it spills at 96
// registers), blocks of 32 or 64 threads, and other warp limits for the
// shared walk (1, 2, 4, 8, 12, 24, 32).  The count arm's lane trips in a
// shared walk are the lanes with a slot or a record to test.
//
// Build: as pt_frame.cu (ops/pt_frame.py builds both, one nvcc each).

#include "pt_launch.cuh"

namespace {

// kInst: the instance arm (the TLAS machinery of the object-space
// instanced scene; the instance tables ride in PtArgs, not in the
// shared-memory pack); kVar: the variant walks (pt::variant); kLeaf: the
// walk's leaf arm (variant only); kTrips: the count arm (count_iters),
// whose walks count their warp and lane trips (shadow_resolve's also its
// longest walk).  shade_extend is built <false, false>, <true, false>,
// <false, true> and <false, true, kLeafOccl> (pay); shadow_resolve
// <false, false>, <true, false>, <false, true> and <false, true,
// kLeafOccl2>; each with and without kTrips.
template <bool kInst, bool kVar, int kLeaf, bool kTrips>
__global__ void __launch_bounds__(pt::kBlock)
    shade_extend_kernel(const pt::PtArgs a) {
  extern __shared__ float smem[];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  pt::Counters cnt;
  // every thread of the warp takes the lane body (the postponed-leaf
  // walk's votes), one past n without a lane
  const bool ok =
      pt::shade_extend_lane<kInst, kVar, kLeaf, kTrips>(p, tb, lane, cnt);
  pt::finish(a, ok, cnt);
}

constexpr unsigned kFull = 0xffffffffu;
// shadow_resolve: a warp with at most `coop` shadow rays walks each of
// them with all its lanes (coop_any_hit), one after another; one with
// more, each lane its own.  `coop` is kCoop in a launch of at least a
// kWaveDiv-th of the warps the card keeps resident, else kCoopNarrow
// (mk_shadow_resolve_launch): with fewer warps than that, a warp's run of
// shared walks is not hidden behind other warps' work.  Config 3's B3 per
// frame with kCoop against kCoopNarrow (PERF.md §6): 128x72 and
// 8192 check lanes (0.1 of the resident warps) +3% and 4.5x, 160x90
// (0.17) +9%, 240x135 (0.38) +6%; 320x180 (0.68) -4%, 1280x720 -7%.
constexpr int kCoop = 16, kCoopNarrow = 2, kWaveDiv = 2;
// blocks of kBlock threads per SM __launch_bounds__ asks for: 5 on the
// timed arms without instances (registers are allocated 8 at a time, so
// 5 blocks of 128 cap a thread at 96: none spills), 4 on the instance arm
// and on the count arms, which would spill at 96
template <bool kInst, bool kTrips>
constexpr int kSrMinBlocks = kInst || kTrips ? 4 : 5;

// The count arm's trips of one step of coop_any_hit: one warp trip, and
// as lane trips the lanes that test something (`lanes`).
__device__ __forceinline__ void count_coop(const pt::Tree& tr, int me,
                                           unsigned lanes) {
  if (me == 0 && tr.trips) {
    atomicAdd(tr.trips, 1ull);
    atomicAdd(tr.trips + 1, (unsigned long long)lanes);
  }
}

// The any hit of one shadow ray `w` (every lane holds it) over `tr`,
// walked by the whole warp: a node row's child slots tested one per lane
// (pt_device.cuh node_slots; slab_child at the fixed tmax, as push_row),
// the passing children pushed onto the warp's stack in shared memory; a
// leaf's records tested one per lane (leaf_rows, leaf_record; tri_test,
// as leaf_any); with kInst every lane takes the same instance step
// (instance_entry, the same RESTORE written to the same slot).  A row's
// loads are then one parallel round for the warp, where a lane's own
// walk exposes a latency per group of records.  Nodes are tested at the
// fixed tmax, so the walk reaches the rows a lane's walk reaches, and
// finds the same occlusion bit.  Returns whether a record has 0 <= t <
// tmax.  Lane 0 counts the rows and marks the node rows (every lane marks
// a leaf's rows in leaf_rows: the same bytes); `rows` counts every row
// visited; kTrips: a warp trip per step, and as lane trips the lanes
// with a non-empty slot or a record to test (one for an instance step).
// Clears `ok` on a stack overflow.
template <bool kInst, bool kVar, int kLeaf, bool kTrips>
__device__ bool coop_any_hit(const pt::Tree& tr, const pt::WalkRay& w,
                             float tmax, int* stack, int me,
                             pt::Counters& cnt, unsigned long long& rows,
                             bool& ok) {
  constexpr int kCap = kVar ? pt::PT_STACK_W16 : pt::PT_STACK;
  const unsigned below = (1u << me) - 1u;
  pt::WalkRay cur = w;
  int sp = tr.nroots - 1;
  for (int i = 1 + me; i < tr.nroots; i += 32) stack[i - 1] = tr.roots[i];
  int e = tr.roots[0];
  __syncwarp();
  for (;;) {
    if constexpr (kInst) {
      const int step = pt::instance_entry(tr, w, cur, e, stack, sp, ok);
      __syncwarp();
      if (kTrips && step) count_coop(tr, me, 1);
      if (step == 1) continue;
      if (step == 2) {  // the world ray is back
        if (sp == 0) return false;
        e = stack[--sp];
        __syncwarp();
        continue;
      }
    }
    ++rows;
    if (kVar ? pt::var_is_node(tr, e) : e >= 0) {
      if (me == 0) {
        ++cnt.snode;
        if (tr.seen_node) tr.seen_node[e] = 1;
      }
      const pt::NodeSlots s = pt::node_slots<kVar>(tr, e);
      bool pass = false;
      int child = pt::SLIM_EMPTY;
      if (me < s.width) {
        child = pt::ld(s.ent + me);
        float c[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) c[q] = pt::ld(s.bnd + 6 * me + q);
        pass = child != pt::SLIM_EMPTY &&
               pt::slab_child(c, cur.sr, tmax, false);
      }
      if constexpr (kTrips) {
        count_coop(tr, me, __popc(__ballot_sync(kFull,
                                                child != pt::SLIM_EMPTY)));
      }
      const unsigned m = __ballot_sync(kFull, pass);
      const int at = sp + __popc(m & below);
      if (pass && at < kCap) stack[at] = child;
      sp += __popc(m);
      if (sp > kCap) {
        ok = false;
        sp = kCap;
      }
    } else {
      // the leaf's records: 28 of a 2-row occlusion leaf, 14 of a 1-row
      // one, 8 shading records
      const float* lrows = pt::leaf_rows<kVar, kLeaf>(tr, e);
      const bool occl = kLeaf != pt::kLeafShade || tr.occl;
      const int nrec = occl ? pt::kOcclRows<kLeaf> * pt::OCCL_TRIS
                            : pt::LEAF_TRIS;
      const float* rec =
          me < nrec ? pt::leaf_record(lrows, occl, me) : nullptr;
      if (me == 0) ++cnt.sleaf;
      if constexpr (kTrips) {
        count_coop(tr, me, __popc(__ballot_sync(kFull, rec != nullptr)));
      }
      bool hit = false;
      if (rec) {
        float x[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) x[q] = pt::ld(rec + q);
        const float tt = pt::tri_test(cur.ox, cur.oy, cur.oz, cur.dx, cur.dy,
                                      cur.dz, x[0], x[1], x[2], x[3], x[4],
                                      x[5], x[6], x[7], x[8]);
        hit = tt >= 0.0f && tt < tmax;
      }
      if (__any_sync(kFull, hit)) return true;
    }
    __syncwarp();
    if (sp == 0) return false;
    e = stack[--sp];
    __syncwarp();
  }
}

template <bool kInst, bool kVar, int kLeaf, bool kTrips>
__global__ void __launch_bounds__(pt::kBlock, kSrMinBlocks<kInst, kTrips>)
    shadow_resolve_kernel(const pt::PtArgs a, int coop) {
  extern __shared__ float smem[];
  __shared__ int stacks[pt::kBlock / 32][kVar ? pt::PT_STACK_W16
                                              : pt::PT_STACK];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = lane < p.n;
  // the lane's flags and energy in flight together
  int fl = 0;
  float en[3] = {0.0f, 0.0f, 0.0f};
  if (in) {
    fl = pt::col_ld<true>(p.flags_in, lane);
#pragma unroll
    for (int c = 0; c < 3; ++c) en[c] = pt::col_ld<true>(p.en_in[c], lane);
  }
  const bool need = (fl >> 2) & 1;
  pt::Counters cnt;
  bool ok = true;
  const unsigned m = __ballot_sync(kFull, need);
  if (m != 0 && __popc(m) <= coop) {
    // few shadow rays in the warp: each walked by all its lanes
    const int me = threadIdx.x & 31;
    int* const stack = stacks[threadIdx.x >> 5];
    for (unsigned left = m; left; left &= left - 1) {
      const int src = __ffs(left) - 1;
      const int l = lane - me + src;
      float o[7];
#pragma unroll
      for (int c = 0; c < 7; ++c) o[c] = pt::ld(p.shadow[c] + l);
      const pt::WalkRay w = pt::world_ray(o[0], o[1], o[2], o[3], o[4], o[5]);
      unsigned long long rows = 0;
      bool occ = coop_any_hit<kInst, kVar, kLeaf, kTrips>(
          p.sh_tree, w, o[6], stack, me, cnt, rows, ok);
      if (me == src) {
        ++cnt.sray;
        if (!occ) {
          occ = pt::analytic_occluded(tb, o[0], o[1], o[2], o[3], o[4], o[5],
                                      o[6]);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (!occ) en[c] = en[c] + pt::col_ld<true>(p.shadow[7 + c], l);
          pt::col_st<true>(p.en_out[c], l, en[c]);
        }
        if (kTrips && rows > cnt.longest) cnt.longest = rows;
      }
    }
  } else if (need) {
    pt::shadow_walk<kInst, kVar, kLeaf, kTrips>(p, tb, lane, en, cnt, ok);
  }
  if (in && !need) {
#pragma unroll
    for (int c = 0; c < 3; ++c) pt::col_st<true>(p.en_out[c], lane, en[c]);
  }
  pt::finish(a, ok, cnt);
}

using Kernel = void (*)(const pt::PtArgs);
using SrKernel = void (*)(const pt::PtArgs, int);

// One arm of shade_extend: its count arm (kTrips) under count_iters.
template <bool kInst, bool kVar, int kLeaf = pt::kLeafShade>
Kernel se_arm(const pt::PtArgs& a) {
  if (a.iters) return shade_extend_kernel<kInst, kVar, kLeaf, true>;
  return shade_extend_kernel<kInst, kVar, kLeaf, false>;
}

// One arm of shadow_resolve: its count arm (kTrips) under count_iters.
template <bool kInst, bool kVar, int kLeaf = pt::kLeafShade>
SrKernel sr_arm(const pt::PtArgs& a) {
  if (a.iters) return shadow_resolve_kernel<kInst, kVar, kLeaf, true>;
  return shadow_resolve_kernel<kInst, kVar, kLeaf, false>;
}

// The shadow_resolve kernel a launch with these arguments takes.
SrKernel sr_kernel_for(const pt::PtArgs& a) {
  if (a.num_inst > 0) return sr_arm<true, false>(a);
  if (pt::sh_leaf_arm(a) == pt::kLeafOccl2) {
    return sr_arm<false, true, pt::kLeafOccl2>(a);
  }
  return pt::variant(a) ? sr_arm<false, true>(a) : sr_arm<false, false>(a);
}

}  // namespace

// Both entries return cudaGetLastError() after the launch (or -1 when the
// packed small tables do not match the layout, or an instance arm is
// asked for over variant tables or with a leaf arm); they never
// synchronise.
extern "C" int mk_shade_extend_launch(const pt::PtArgs* a) {
  if (pt::refused(*a)) return -1;
  if (a->num_inst > 0) return pt::launch(se_arm<true, false>(*a), a);
  switch (pt::leaf_arm(*a)) {
    case pt::kLeafOccl:
      return pt::launch(se_arm<false, true, pt::kLeafOccl>(*a), a);
    case pt::kLeafOccl2:
      return -1;  // the leaf-14 payload has 1-row leaves only
  }
  return pt::launch(pt::variant(*a) ? se_arm<false, true>(*a)
                                    : se_arm<false, false>(*a),
                    a);
}

extern "C" int mk_shadow_resolve_launch(const pt::PtArgs* a) {
  if (pt::refused(*a)) return -1;
  const SrKernel kernel = sr_kernel_for(*a);
  int threads = 0;
  if (const int err = pt::resident_threads(kernel, *a, threads)) return err;
  const long long warps = ((long long)a->n + 31) / 32;
  const int coop = warps * kWaveDiv >= threads / 32 ? kCoop : kCoopNarrow;
  return pt::launch(kernel, a, coop);
}
