// The traversal lab L3 for Hopper (sm_90a): closest hit or any hit of a
// ray batch over 16-wide fused node|leaf rows, under the schedule of the
// JAX package's tools/kernel_lab3.py.
//
// Replaces tools/kernel_lab3.py's Pallas kernel `traverse16`
// (_lab3_kernel): the table of collapse16 / scene_tables16 (a true
// 16-wide SAH collapse: bounds at cols 0..95, 16 child entries at
// 96..111 -- node rows, or nn + leaf row --, the leaf rows after the node
// rows with 8 shading records each, ids local to their object and the
// object stamped), 17-word frames (16 entries and a mask word) pushed
// only when the mask is non-zero, the lowest set bit popped first or,
// with nearest, the argmin slot (bits 16-19 of the mask word) first; an
// any hit that stops at the first record that hits (t below t_init), and
// the per-tile trip counts of count_iters.  labs/kernel_lab3.py wraps it;
// its plain version steps every lane in lockstep with the same state
// machine and equals the kernel bitwise, counters included.
//
// Schedule on this card (lab_device.cuh): one thread per ray with its own
// stack of 24 frames in local memory, the warp's lanes iterating together
// while any lives.  What bounds it: the latency of each ray's dependent,
// scattered row loads (a 16-wide node row is 448 bytes: 24 float4 of
// bounds and 4 of entries) and the divergence of the warp's rays, as for
// the 8-wide walks; the 16 slab tests of a row double the f32 work of a
// visit, which stays far from the card's f32 rate.  A closest hit's exact
// ties go to the lower (object, id), which is the order of the global ids,
// so its hits equal the standalone traversal's over the 8-wide tree.
//
// Build: ops/pt_frame.py builds every unit (nvcc, sm_90a, --fmad=false).

#include "lab_device.cuh"

namespace {

using lab::DONE;
using lab::FRAME16;
using lab::FSTACK16;

template <bool kAny, bool kNear>
__global__ void __launch_bounds__(lab::kBlock)
    lab_wide_kernel(const lab::LabArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool act = lab::lane_active(a, lane);
  lab::Ray r{};
  lab::LHit h{lane < a.n ? a.t_init[lane] : 0.0f, -1, -1};
  const float t_bound = h.t;
  int stack[FSTACK16];
  int sp = 0, e = DONE;
  bool ok = true;
  if (act) {
    r = lab::load_ray(a, lane);
    e = a.roots[0];
    for (int pos = 1; pos < a.nroots; pos += 16) {
      const int cnt = min(16, a.nroots - pos);
      for (int i = 0; i < cnt; ++i) stack[sp + i] = a.roots[pos + i];
      stack[sp + 16] = (1 << cnt) - 1;
      sp += FRAME16;
    }
  }
  int trips = 0;
  lab::Counts cnt;
  while (__any_sync(lab::kFull, e != DONE)) {
    ++trips;
    if (e == DONE) continue;
    unsigned w = 0;
    int ent[16];
    if (e < a.nn) {
      float best = 0.0f;
      int best_k = 0;
      const float* row = a.nodes + (size_t)e * 128;
      float ef[16];
      lab::load_row<4>(row + 96, ef);
      lab::entries<16>(ef, ent);
      // two blocks of 8 slots: bounds 0..47, then 48..95
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float b[48];
        lab::load_row<12>(row + 48 * half, b);
        w |= lab::slab8<kNear>(b, ent + 8 * half, r.sr,
                               kAny ? t_bound : h.t, !kAny, 8 * half, &best,
                               &best_k)
             << (8 * half);
      }
      if (kNear) w |= (unsigned)best_k << 16;
      lab::mark(a, e);
      ++cnt.node;
    } else {
      const float* row = a.nodes + (size_t)e * 128;
      lab::mark(a, e);
      ++cnt.leaf;
      if constexpr (kAny) {
        for (int c = 0; c < pt::LEAF_TRIS; ++c) {
          const float* rec = row + 16 * c;
          ++cnt.tri;
          const float tt = pt::tri_test(
              r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, pt::ld(rec), pt::ld(rec + 1),
              pt::ld(rec + 2), pt::ld(rec + 3), pt::ld(rec + 4),
              pt::ld(rec + 5), pt::ld(rec + 6), pt::ld(rec + 7),
              pt::ld(rec + 8));
          if (tt >= 0.0f && tt < t_bound) {
            h.t = tt;
            h.tri = pt::as_int(pt::ld(rec + 13));
            h.obj = pt::as_int(pt::ld(rec + 12));
            break;
          }
        }
        if (h.tri >= 0) {  // the first hit ends the lane's walk
          e = DONE;
          continue;
        }
      } else {
        lab::leaf_closest<true>(row, nullptr, r, h);
        cnt.tri += pt::LEAF_TRIS;
      }
    }
    if ((w & 0xFFFFu) != 0) {
      if (sp + FRAME16 > FSTACK16) {
        ok = false;  // the wrapper's depth check rules this out
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) stack[sp + k] = ent[k];
        stack[sp + 16] = (int)w;
        sp += FRAME16;
      }
    }
    if (sp > 0) {
      const int base = sp - FRAME16;
      const unsigned mw = (unsigned)stack[base + 16];
      int kk = lab::ctz(mw & 0xFFFFu);
      if constexpr (kNear) {
        const int bk = (int)((mw >> 16) & 15u);
        if (mw & (1u << bk)) kk = bk;
      }
      const unsigned rem = mw & ~(1u << kk);
      e = stack[base + kk];
      stack[base + 16] = (int)rem;
      if ((rem & 0xFFFFu) == 0) sp = base;
    } else {
      e = DONE;
    }
  }
  lab::store(a, lane, h);
  lab::finish(a, lane / lab::kTile, trips, 0, cnt, ok);
}

}  // namespace

// a->flags: bit 0 any hit, 1 nearest first.  a->iters set: count_iters.
// Returns cudaGetLastError() after the launch; never synchronises.
extern "C" int lab3_launch(const lab::LabArgs* a) {
  const bool any = a->flags & 1, near = a->flags & 2;
  if (any) {
    return near ? lab::launch(lab_wide_kernel<true, true>, a)
                : lab::launch(lab_wide_kernel<true, false>, a);
  }
  return near ? lab::launch(lab_wide_kernel<false, true>, a)
              : lab::launch(lab_wide_kernel<false, false>, a);
}
