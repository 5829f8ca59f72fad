// The traversal labs L1 and L2 for Hopper (sm_90a): closest hit of a ray
// batch over the slim 8-wide tables under the schedules of the JAX
// package's tools/kernel_lab2.py.
//
// Replaces tools/kernel_lab2.py's Pallas kernels: `traverse_lab2` (L1,
// _lab2_kernel) -- the frame stack of 9-word frames (8 entries and a
// mask word, the lowest set bit popped first) or the linear stack, the
// fused node|leaf table or the split tables, the gated leaf phase and the
// conditional frame push -- and `traverse_lab2p` (L2, _lab2p_kernel), the
// software-pipelined body over the fused table: each trip pops the NEXT
// entry and issues its row loads before the CURRENT entry's slab and leaf
// work, then pushes the current entry's children (a pop that precedes a
// same-trip push leaves a bubble trip, as in the lab), with the nearest
// child popped first (the argmin slot in bits 8-10 of the mask word) and
// parent-pointer frames (parent row and mask; the pop re-reads the
// child's entry from the table).  labs/kernel_lab2.py wraps both; its
// plain versions step every lane in lockstep with the same state
// machines and equal the kernels bitwise, counters included.
//
// Schedule on this card (lab_device.cuh): one thread per ray with its own
// stack in local memory, the warp's lanes iterating together while any
// lives; the lab's gate (pl.when(any_leaf)) is a warp vote, its packet
// pushes and pops the lane's own.  What bounds it: as the standalone
// traversal (traverse.cu), neither bytes nor f32 operations but the
// latency of each ray's dependent, scattered 224- and 512-byte row loads
// (mostly L2 hits) and the divergence of the warp's rays.  The pipelined
// arm keeps the next row's first 14 float4 (a node row's bounds and
// entries, a leaf row's first three and a half records) in registers, a
// load in flight across the current entry's work.
//
// Build: ops/pt_frame.py builds every unit (nvcc, sm_90a, --fmad=false).

#include "lab_device.cuh"

namespace {

using lab::DONE;
using lab::FRAME8;
using lab::FSTACK8;

// L1: kFs frame stack (else linear), kFused the fused table (leaf
// entries >= nn, one 128-col table; else 64-col node rows and leaf rows
// -(lrow + 1)), kGate the leaf phase under a warp vote, kCond the frame
// push only when its mask is non-zero.
template <bool kFs, bool kFused, bool kGate, bool kCond>
__global__ void __launch_bounds__(lab::kBlock)
    lab_frame_kernel(const lab::LabArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool act = lab::lane_active(a, lane);
  lab::Ray r{};
  lab::LHit h{lane < a.n ? a.t_init[lane] : 0.0f, -1, -1};
  constexpr int kCap = kFs ? FSTACK8 : lab::STACK;
  constexpr int kCols = kFused ? 128 : 64;
  int stack[kCap];
  int sp = 0, e = DONE;
  bool ok = true;
  if (act) {
    r = lab::load_ray(a, lane);
    e = a.roots[0];
    if constexpr (kFs) {
      lab::seed_frames8(a.roots, a.nroots, stack, sp);
    } else {
      for (int i = 1; i < a.nroots; ++i) stack[sp++] = a.roots[i];
    }
  }
  int trips = 0, leaf_trips = 0;
  lab::Counts cnt;
  while (__any_sync(lab::kFull, e != DONE)) {
    ++trips;
    const bool live = e != DONE;
    const bool leaf = live && (kFused ? e >= a.nn : e < 0);
    const bool interior = live && !leaf;
    const bool any_leaf = __any_sync(lab::kFull, leaf);
    leaf_trips += any_leaf ? 1 : 0;
    unsigned w = 0;
    int ent[8] = {};
    if (interior) {
      float b[56];
      lab::load_row<14>(a.nodes + (size_t)e * kCols, b);
      lab::entries<8>(b + 48, ent);
      w = lab::slab8<false>(b, ent, r.sr, h.t, true, 0, nullptr, nullptr);
      lab::mark(a, e);
      ++cnt.node;
    }
    if (!kGate || any_leaf) {
      if (leaf) {
        const int lrow = kFused ? e - a.nn : -e - 1;
        const float* row = kFused ? a.nodes + (size_t)e * 128
                                  : a.ltris + (size_t)lrow * 128;
        lab::leaf_closest<false>(row, nullptr, r, h);
        lab::mark(a, a.node_rows + lrow);
        ++cnt.leaf;
        cnt.tri += pt::LEAF_TRIS;
      }
    }
    if (!live) continue;
    if constexpr (kFs) {
      if (w != 0 && sp + FRAME8 > kCap) {
        ok = false;  // the wrapper's depth check rules this out
        w = 0;
      }
      if ((!kCond || w != 0) && sp + FRAME8 <= kCap) {
#pragma unroll
        for (int k = 0; k < 8; ++k) stack[sp + k] = ent[k];
        stack[sp + 8] = (int)w;
      }
      if (w != 0) sp += FRAME8;
      e = sp > 0 ? lab::frame_pop8(stack, sp) : DONE;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (w & (1u << k)) {
          if (sp < kCap) {
            stack[sp++] = ent[k];
          } else {
            ok = false;
          }
        }
      }
      e = sp > 0 ? stack[--sp] : DONE;
    }
  }
  lab::store(a, lane, h);
  lab::finish(a, lane / lab::kTile, trips, leaf_trips, cnt, ok);
}

// L2 over the fused table: kFs frame stack (else linear), kNear the
// nearest child first, kParent parent-pointer frames (kFs only).
template <bool kFs, bool kNear, bool kParent>
__global__ void __launch_bounds__(lab::kBlock)
    lab_pipe_kernel(const lab::LabArgs a) {
  static_assert(kFs || !kParent, "parent frames need the frame stack");
  constexpr int kFrame = kParent ? 2 : FRAME8;
  constexpr int kCap = kFs ? FSTACK8 : lab::STACK;
  constexpr int kPre = 56;  // f32 of a row carried in registers
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool act = lab::lane_active(a, lane);
  lab::Ray r{};
  lab::LHit h{lane < a.n ? a.t_init[lane] : 0.0f, -1, -1};
  int stack[kCap];
  int sp = 0, e = DONE;
  float cur[kPre];
  bool ok = true;
  if (act) {
    r = lab::load_ray(a, lane);
    e = a.roots[0];
    int nf = 0;
    for (int pos = 1; pos < a.nroots; pos += 8, ++nf) {
      const int cnt = min(8, a.nroots - pos);
      if constexpr (kParent) {
        stack[sp] = -(nf + 1);  // a seed frame: roots[1 + 8 nf + k]
        stack[sp + 1] = (1 << cnt) - 1;
      } else if constexpr (kFs) {
        for (int i = 0; i < cnt; ++i) stack[sp + i] = a.roots[pos + i];
        stack[sp + 8] = (1 << cnt) - 1;
      } else {
        for (int i = 0; i < cnt; ++i) stack[sp + i] = a.roots[pos + i];
      }
      sp += kFs ? kFrame : cnt;
    }
    lab::load_row<kPre / 4>(a.nodes + (size_t)e * 128, cur);
  }
  int trips = 0, leaf_trips = 0;
  lab::Counts cnt;
  while (__any_sync(lab::kFull, e != DONE || sp > 0)) {
    ++trips;
    const bool live = e != DONE;
    const bool leaf = live && e >= a.nn;
    const bool interior = live && !leaf;
    leaf_trips += __any_sync(lab::kFull, leaf) ? 1 : 0;
    // (1) pop the next entry and issue its row loads
    int nxt = DONE;
    if (sp > 0) {
      if constexpr (kFs) {
        const int base = sp - kFrame;
        const unsigned mw = (unsigned)stack[base + kFrame - 1];
        int kk = lab::ctz(mw & 0xFFu);
        if constexpr (kNear) {
          const int bk = (int)((mw >> 8) & 7u);
          if (mw & (1u << bk)) kk = bk;
        }
        const unsigned rem = mw & ~(1u << kk);
        stack[base + kFrame - 1] = (int)rem;
        if constexpr (kParent) {
          const int par = stack[base];
          nxt = par >= 0
                    ? pt::as_int(pt::ld(a.nodes + (size_t)par * 128 + 48 + kk))
                    : a.roots[1 + 8 * (-par - 1) + kk];
        } else {
          nxt = stack[base + kk];
        }
        if ((rem & 0xFFu) == 0) sp = base;
      } else {
        nxt = stack[--sp];
      }
    }
    float nb[kPre];
    if (nxt != DONE) lab::load_row<kPre / 4>(a.nodes + (size_t)nxt * 128, nb);
    // (2) slab or leaf of the current entry from the carried row
    unsigned w = 0;
    int ent[8];
    lab::entries<8>(cur + 48, ent);
    if (interior) {
      float best = 0.0f;
      int best_k = 0;
      w = lab::slab8<kNear>(cur, ent, r.sr, h.t, true, 0, &best, &best_k);
      if (kNear) w |= (unsigned)best_k << 8;
      lab::mark(a, e);
      ++cnt.node;
    }
    if (leaf) {
      lab::leaf_closest<false, kPre>(a.nodes + (size_t)e * 128, cur, r, h);
      lab::mark(a, e);
      ++cnt.leaf;
      cnt.tri += pt::LEAF_TRIS;
    }
    // (3) push the current entry's children; the next entry becomes current
    if (interior && (w & 0xFFu) != 0) {
      if constexpr (kFs) {
        if (sp + kFrame > kCap) {
          ok = false;
        } else {
          if constexpr (kParent) {
            stack[sp] = e;
          } else {
#pragma unroll
            for (int k = 0; k < 8; ++k) stack[sp + k] = ent[k];
          }
          stack[sp + kFrame - 1] = (int)w;
          sp += kFrame;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (w & (1u << k)) {
            if (sp < kCap) {
              stack[sp++] = ent[k];
            } else {
              ok = false;
            }
          }
        }
      }
    }
    e = nxt;
    if (nxt != DONE) {
#pragma unroll
      for (int q = 0; q < kPre; ++q) cur[q] = nb[q];
    }
  }
  lab::store(a, lane, h);
  lab::finish(a, lane / lab::kTile, trips, leaf_trips, cnt, ok);
}

// kCond only with the frame stack (the linear stack pushes no frames)
template <bool kFs, bool kFused, bool kCond>
int launch_frame(const lab::LabArgs* a, bool gate) {
  return gate ? lab::launch(lab_frame_kernel<kFs, kFused, true, kCond>, a)
              : lab::launch(lab_frame_kernel<kFs, kFused, false, kCond>, a);
}

}  // namespace

// a->flags: bit 0 frame stack, 1 fused, 2 gated leaf phase, 3
// conditional push (frame stack only).  Returns cudaGetLastError() after
// the launch (-1 for flags the lab does not have); never synchronises.
extern "C" int lab2_launch(const lab::LabArgs* a) {
  const bool fs = a->flags & 1, fused = a->flags & 2, gate = a->flags & 4,
             cond = a->flags & 8;
  if (cond && !fs) return -1;
  if (fs && cond) {
    return fused ? launch_frame<true, true, true>(a, gate)
                 : launch_frame<true, false, true>(a, gate);
  }
  if (fs) {
    return fused ? launch_frame<true, true, false>(a, gate)
                 : launch_frame<true, false, false>(a, gate);
  }
  return fused ? launch_frame<false, true, false>(a, gate)
               : launch_frame<false, false, false>(a, gate);
}

// a->flags: bit 0 frame stack, 1 nearest first, 2 parent frames (frame
// stack only).  The table is the fused one.
extern "C" int lab2p_launch(const lab::LabArgs* a) {
  const bool fs = a->flags & 1, near = a->flags & 2, parent = a->flags & 4;
  if (parent && !fs) return -1;
  if (!fs) {
    return near ? lab::launch(lab_pipe_kernel<false, true, false>, a)
                : lab::launch(lab_pipe_kernel<false, false, false>, a);
  }
  if (parent) {
    return near ? lab::launch(lab_pipe_kernel<true, true, true>, a)
                : lab::launch(lab_pipe_kernel<true, false, true>, a);
  }
  return near ? lab::launch(lab_pipe_kernel<true, true, false>, a)
              : lab::launch(lab_pipe_kernel<true, false, false>, a);
}

// LabArgs' size and offsets, for the ctypes mirror's check.
extern "C" int lab_args_layout(long long* out) {
  lab::args_layout(out);
  return 0;
}
