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
// Schedule on this card.  Each ray is walked by one thread with its own
// stack in local memory, as before; what changed is which rays a warp
// holds.  lab_prep_kernel (one thread per lane) writes the outputs of
// the lanes that are not active and appends the active lanes to a list,
// one atomic a block.  The walk kernels then run as persistent blocks
// (as many as the card keeps resident): a warp hands each lane whose ray
// has ended the next ray of the list -- one ballot, one atomic a warp for
// the idle lanes together (Aila and Laine, "Understanding the Efficiency
// of Ray Traversal on GPUs", HPG 2009: persistent while-while traversal
// with ray replacement) -- once kRefill of its lanes are idle.  So a
// warp's lanes no longer idle through its longest ray.  L2 no longer carries the next
// entry's row in registers across the current entry's work (168-170
// registers before, 96 now): staging it in shared memory by cp.async
// took the L1 that the per-lane stacks live in, and a prefetch into L1
// as it is popped was slower than none (PERF.md section 6).
//
// Counters.  A warp's rays depend on the order in which warps finish, so
// the per-tile counters are per-ray sums that no schedule changes: `iters`
// the trips in which the tile's rays held an entry (L2: a current entry or
// one on the stack), `leafs` those in which they tested a leaf row, each
// added once the ray ends.  A count launch adds the launch's warp trips as
// a fourth work counter.  What bounds the walk: as the standalone
// traversal (traverse.cu), neither bytes nor f32 operations but the
// latency of each ray's dependent, scattered 224- and 512-byte row loads
// (mostly L2 hits).
//
// Build: ops/pt_frame.py builds every unit (nvcc, sm_90a, --fmad=false).

#include "lab_device.cuh"

namespace lab2 {

// The schedule's second argument (labs/kernel_lab2.py RefillArgs mirrors
// it).
struct RefillArgs {
  int* lanes;  // (n,) scratch: the active lanes, compacted by the prep
  int* queue;  // 2 scratch words: [0] the active lanes, [1] the next one
};

}  // namespace lab2

namespace {

using lab::DONE;
using lab::FRAME8;
using lab::FSTACK8;
using lab2::RefillArgs;

constexpr int kPrepBlock = 1024;
// a warp refills once this many of its 32 lanes hold no ray: on config
// 3's bounce fan 1-16 time within 2% of each other, 24 a few per cent
// slower, 32 (a whole warp at a time, as pt_frame.cu does) no faster than
// no refill (PERF.md section 6)
constexpr int kRefill = 8;
// the f32 of a row a node's slab tests read: 12 float4 of bounds and 2 of
// entries
constexpr int kNodeF = 56;

// One thread per lane: a lane that is not active gets t_init and ids -1;
// the active lanes go to r.lanes in lane order within a block, one atomic
// a block on r.queue[0].
__global__ void __launch_bounds__(kPrepBlock)
    lab_prep_kernel(const lab::LabArgs a, const RefillArgs r) {
  __shared__ int warp_base[kPrepBlock / 32];
  __shared__ int block_base;
  const int lane = blockIdx.x * kPrepBlock + threadIdx.x;
  const bool act = lab::lane_active(a, lane);
  if (lane < a.n && !act) lab::store(a, lane, {a.t_init[lane], -1, -1});
  const unsigned vote = __ballot_sync(lab::kFull, act);
  const int w = threadIdx.x >> 5, wl = threadIdx.x & 31;
  if (wl == 0) warp_base[w] = __popc(vote);
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int k = 0; k < kPrepBlock / 32; ++k) {
      const int c = warp_base[k];
      warp_base[k] = sum;
      sum += c;
    }
    block_base = sum ? atomicAdd(r.queue, sum) : 0;
  }
  __syncthreads();
  if (act) {
    r.lanes[block_base + warp_base[w] + __popc(vote & ((1u << wl) - 1))] =
        lane;
  }
}

// The warp's refill (every lane takes part): once at least kRefill of its
// lanes are idle, one atomic hands them the next entries of the list in
// lane order.  Returns the lane of the ray this thread now holds (-1:
// none); sets `drained` (warp-uniform) once the list is handed out.
__device__ __forceinline__ int refill(const RefillArgs& r, int count,
                                      bool idle, bool& drained) {
  const unsigned m = __ballot_sync(lab::kFull, idle);
  const int k = __popc(m);
  if (k < kRefill) return -1;
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(r.queue + 1, k);
  base = __shfl_sync(lab::kFull, base, 0);
  if (base + k >= count) drained = true;
  if (!idle) return -1;
  const int slot = base + __popc(m & ((1u << (threadIdx.x & 31)) - 1));
  return slot < count ? r.lanes[slot] : -1;
}

// A ray's end: its outputs and its per-ray trips into its tile's
// counters.
__device__ __forceinline__ void end_ray(const lab::LabArgs& a, int lane,
                                        const lab::LHit& h, int trips,
                                        int leaf_trips) {
  lab::store(a, lane, h);
  if (a.iters) atomicAdd(a.iters + lane / lab::kTile, trips);
  if (a.leafs) atomicAdd(a.leafs + lane / lab::kTile, leaf_trips);
}

// After the loop (every lane of the warp): the overflow flag, and in a
// count launch the work summed over the warp and its warp trips.
__device__ __forceinline__ void finish_walk(const lab::LabArgs& a,
                                            const lab::Counts& c,
                                            unsigned long long warp_trips,
                                            bool ok) {
  if (!ok) atomicOr(a.status, 1);
  if (!a.counts) return;
  unsigned long long v[lab::NUM_COUNTS] = {c.node, c.leaf, c.tri};
#pragma unroll
  for (int k = 0; k < lab::NUM_COUNTS; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(lab::kFull, v[k], off);
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < lab::NUM_COUNTS; ++k) atomicAdd(a.counts + k, v[k]);
    atomicAdd(a.counts + lab::NUM_COUNTS, warp_trips);
  }
}

// L1: kFs frame stack (else linear), kFused the fused table (leaf
// entries >= nn, one 128-col table; else 64-col node rows and leaf rows
// -(lrow + 1)), kGate the leaf phase under a warp vote, kCond the frame
// push only when its mask is non-zero.
template <bool kFs, bool kFused, bool kGate, bool kCond>
__global__ void __launch_bounds__(lab::kBlock)
    lab_frame_kernel(const lab::LabArgs a, const RefillArgs r) {
  constexpr int kCap = kFs ? FSTACK8 : lab::STACK;
  constexpr int kCols = kFused ? 128 : 64;
  const int count = r.queue[0];
  int lane = -1;
  lab::Ray ray{};
  lab::LHit h{};
  int stack[kCap];
  int sp = 0, e = DONE, trips = 0, leaf_trips = 0;
  unsigned long long warp_trips = 0;
  bool drained = false, ok = true;
  lab::Counts cnt;
  while (true) {
    if (!drained) {
      const int got = refill(r, count, lane < 0, drained);
      if (got >= 0) {
        lane = got;
        ray = lab::load_ray(a, lane);
        h = {a.t_init[lane], -1, -1};
        e = a.roots[0];
        sp = trips = leaf_trips = 0;
        if constexpr (kFs) {
          lab::seed_frames8(a.roots, a.nroots, stack, sp);
        } else {
          for (int i = 1; i < a.nroots; ++i) stack[sp++] = a.roots[i];
        }
      }
    }
    if (!__any_sync(lab::kFull, e != DONE)) {
      if (drained) break;
      continue;
    }
    ++warp_trips;
    const bool live = e != DONE;
    const bool leaf = live && (kFused ? e >= a.nn : e < 0);
    const bool interior = live && !leaf;
    trips += live ? 1 : 0;
    leaf_trips += leaf ? 1 : 0;
    unsigned w = 0;
    int ent[8] = {};
    if (interior) {
      float b[56];
      lab::load_row<14>(a.nodes + (size_t)e * kCols, b);
      lab::entries<8>(b + 48, ent);
      w = lab::slab8<false>(b, ent, ray.sr, h.t, true, 0, nullptr, nullptr);
      lab::mark(a, e);
      ++cnt.node;
    }
    if (!kGate || __any_sync(lab::kFull, leaf)) {
      if (leaf) {
        const int lrow = kFused ? e - a.nn : -e - 1;
        const float* row = kFused ? a.nodes + (size_t)e * 128
                                  : a.ltris + (size_t)lrow * 128;
        lab::leaf_closest<false>(row, nullptr, ray, h);
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
    if (e == DONE) {
      end_ray(a, lane, h, trips, leaf_trips);
      lane = -1;
    }
  }
  finish_walk(a, cnt, warp_trips, ok);
}

// L2 over the fused table: kFs frame stack (else linear), kNear the
// nearest child first, kParent parent-pointer frames (kFs only).  Each
// trip keeps the lab's order -- the next entry popped before the current
// one's work, the bubble trip after a pop that preceded a push -- and
// loads a row when it works it, as L1 does: the other warps of the SM
// hide its latency.
template <bool kFs, bool kNear, bool kParent>
__global__ void __launch_bounds__(lab::kBlock)
    lab_pipe_kernel(const lab::LabArgs a, const RefillArgs r) {
  static_assert(kFs || !kParent, "parent frames need the frame stack");
  constexpr int kFrame = kParent ? 2 : FRAME8;
  constexpr int kCap = kFs ? FSTACK8 : lab::STACK;
  const int count = r.queue[0];
  int lane = -1;
  lab::Ray ray{};
  lab::LHit h{};
  int stack[kCap];
  int sp = 0, e = DONE, trips = 0, leaf_trips = 0;
  unsigned long long warp_trips = 0;
  bool drained = false, ok = true;
  lab::Counts cnt;
  while (true) {
    if (!drained) {
      const int got = refill(r, count, lane < 0, drained);
      if (got >= 0) {
        lane = got;
        ray = lab::load_ray(a, lane);
        h = {a.t_init[lane], -1, -1};
        e = a.roots[0];
        sp = trips = leaf_trips = 0;
        int nf = 0;
        for (int pos = 1; pos < a.nroots; pos += 8, ++nf) {
          const int k = min(8, a.nroots - pos);
          if constexpr (kParent) {
            stack[sp] = -(nf + 1);  // a seed frame: roots[1 + 8 nf + k]
            stack[sp + 1] = (1 << k) - 1;
          } else if constexpr (kFs) {
            for (int i = 0; i < k; ++i) stack[sp + i] = a.roots[pos + i];
            stack[sp + 8] = (1 << k) - 1;
          } else {
            for (int i = 0; i < k; ++i) stack[sp + i] = a.roots[pos + i];
          }
          sp += kFs ? kFrame : k;
        }
      }
    }
    const bool alive = e != DONE || sp > 0;
    if (!__any_sync(lab::kFull, alive)) {
      if (drained) break;
      continue;
    }
    ++warp_trips;
    const bool live = e != DONE;
    const bool leaf = live && e >= a.nn;
    const bool interior = live && !leaf;
    trips += alive ? 1 : 0;
    leaf_trips += leaf ? 1 : 0;
    // (1) pop the next entry
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
    // (2) slab or leaf of the current entry
    const float* erow = a.nodes + (size_t)e * 128;
    unsigned w = 0;
    int ent[8];
    if (interior) {
      float b[kNodeF];
      lab::load_row<kNodeF / 4>(erow, b);
      lab::entries<8>(b + 48, ent);
      float best = 0.0f;
      int best_k = 0;
      w = lab::slab8<kNear>(b, ent, ray.sr, h.t, true, 0, &best, &best_k);
      if (kNear) w |= (unsigned)best_k << 8;
      lab::mark(a, e);
      ++cnt.node;
    }
    if (leaf) {
      lab::leaf_closest<false>(erow, nullptr, ray, h);
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
    if (lane >= 0 && e == DONE && sp == 0) {
      end_ray(a, lane, h, trips, leaf_trips);
      lane = -1;
    }
  }
  finish_walk(a, cnt, warp_trips, ok);
}

// A walk kernel's blocks per SM at lab::kBlock threads (queried once).
using Walk = void (*)(const lab::LabArgs, const RefillArgs);

template <Walk kWalk>
int resident_per_sm(int* per_sm) {
  static int cached = 0;
  if (cached == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, kWalk, lab::kBlock, 0);
    if (err != cudaSuccess) {
      cached = 0;
      return (int)err;
    }
  }
  *per_sm = cached;
  return 0;
}

// The queue zeroed and the prep over a->n lanes (a->n > 0) on a->stream.
int launch_prep(const lab::LabArgs* a, const RefillArgs* r) {
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  const int rc = (int)cudaMemsetAsync(r->queue, 0, 2 * sizeof(int), st);
  if (rc != 0) return rc;
  lab_prep_kernel<<<(a->n + kPrepBlock - 1) / kPrepBlock, kPrepBlock, 0,
                    st>>>(*a, *r);
  return 0;
}

// A walk kernel's launch: the prep, then the kernel as persistent blocks
// of lab::kBlock threads, as many as the card keeps resident (fewer when
// the lanes fill fewer).  Returns cudaGetLastError(); never synchronises.
template <Walk kWalk>
int launch_walk(const lab::LabArgs* a, const RefillArgs* r) {
  if (a->n <= 0) return 0;
  int per_sm = 0, dev = 0, sms = 0;
  int rc = resident_per_sm<kWalk>(&per_sm);
  if (rc == 0) rc = (int)cudaGetDevice(&dev);
  if (rc == 0) {
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  }
  if (rc == 0) rc = launch_prep(a, r);
  if (rc != 0) return rc;
  const int need = (a->n + lab::kBlock - 1) / lab::kBlock;
  const int blocks = sms * per_sm;  // 0: cannot be resident, refused below
  kWalk<<<need < blocks ? need : blocks, lab::kBlock, 0,
          static_cast<cudaStream_t>(a->stream)>>>(*a, *r);
  return (int)cudaGetLastError();
}

// An instantiated arm: its launch and its blocks per SM.
struct Entry {
  int (*launch)(const lab::LabArgs*, const RefillArgs*);
  int (*per_sm)(int*);
};

template <Walk kWalk>
Entry entry() {
  return {launch_walk<kWalk>, resident_per_sm<kWalk>};
}

// L1's arm of a->flags: bit 0 frame stack, 1 fused, 2 gated leaf phase,
// 3 conditional push (frame stack only); {null, null} for flags the lab
// does not have.
template <bool kFs, bool kFused, bool kCond>
Entry frame_gate(bool gate) {
  return gate ? entry<lab_frame_kernel<kFs, kFused, true, kCond>>()
              : entry<lab_frame_kernel<kFs, kFused, false, kCond>>();
}

Entry frame_arm(int flags) {
  const bool fs = flags & 1, fused = flags & 2, gate = flags & 4,
             cond = flags & 8;
  if (cond && !fs) return {nullptr, nullptr};
  if (fs && cond) {
    return fused ? frame_gate<true, true, true>(gate)
                 : frame_gate<true, false, true>(gate);
  }
  if (fs) {
    return fused ? frame_gate<true, true, false>(gate)
                 : frame_gate<true, false, false>(gate);
  }
  return fused ? frame_gate<false, true, false>(gate)
               : frame_gate<false, false, false>(gate);
}

// L2's arm of a->flags: bit 0 frame stack, 1 nearest first, 2 parent
// frames (frame stack only).  The table is the fused one.
template <bool kFs, bool kParent>
Entry pipe_near(bool near) {
  return near ? entry<lab_pipe_kernel<kFs, true, kParent>>()
              : entry<lab_pipe_kernel<kFs, false, kParent>>();
}

Entry pipe_arm(int flags) {
  const bool fs = flags & 1, near = flags & 2, parent = flags & 4;
  if (parent && !fs) return {nullptr, nullptr};
  if (!fs) return pipe_near<false, false>(near);
  return parent ? pipe_near<true, true>(near) : pipe_near<true, false>(near);
}

int run(Entry e, const lab::LabArgs* a, const RefillArgs* r) {
  return e.launch ? e.launch(a, r) : -1;
}

int blocks_per_sm(Entry e) {
  int per_sm = 0;
  if (!e.per_sm) return -1;
  const int rc = e.per_sm(&per_sm);
  return rc ? -rc : per_sm;
}

}  // namespace

// Launch L1 (lab2_launch) or L2 (lab2p_launch) on a->stream: the prep
// kernel, then the arm's walk kernel (flags as frame_arm / pipe_arm read
// them).  Returns cudaGetLastError() after the launches (-1 for flags the
// lab does not have); never synchronises.
extern "C" int lab2_launch(const lab::LabArgs* a, const RefillArgs* r) {
  return run(frame_arm(a->flags), a, r);
}

extern "C" int lab2p_launch(const lab::LabArgs* a, const RefillArgs* r) {
  return run(pipe_arm(a->flags), a, r);
}

// Blocks per SM of the arm's walk kernel (a->flags; the second argument
// is unused): lab2_occupancy for L1, lab2p_occupancy for L2; -1 for flags
// the lab does not have, else minus a CUDA error.
extern "C" int lab2_occupancy(const lab::LabArgs* a, const RefillArgs*) {
  return blocks_per_sm(frame_arm(a->flags));
}

extern "C" int lab2p_occupancy(const lab::LabArgs* a, const RefillArgs*) {
  return blocks_per_sm(pipe_arm(a->flags));
}

// The prep alone (the queue zeroed, lab_prep_kernel over a->n lanes), to
// time its share of a launch.  Returns cudaGetLastError().
extern "C" int lab2_prep(const lab::LabArgs* a, const RefillArgs* r) {
  if (a->n <= 0) return 0;
  const int rc = launch_prep(a, r);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// LabArgs' size and offsets, for the ctypes mirror's check.
extern "C" int lab_args_layout(long long* out) {
  lab::args_layout(out);
  return 0;
}
