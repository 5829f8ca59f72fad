// The Whitted raytracer's whole-frame kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel ops/whitted_kernel.py
// (_whitted_kernel, launched by whitted_frame): on an all-analytic scene
// (benchmark config 1: spheres, a plane, point lights) every depth of a
// lane -- the sphere / plane closest hit, emission, per-light shadow
// tests and the dielectric / mirror continuation -- in one launch.  The
// per-lane body is whitted.cuh.
//
// What bounds it on this card: on config 1 (800x600, 5 depths) the
// launch has three parts (PERF.md §6 PR 15): the grid's floor, each
// lane's ray and state in and energy and state out with depth 0's seven
// object tests (an all-miss launch: half of it), depth 0's shading,
// lights and shadow rays on every lane (a quarter), and the glass paths
// that live all 5 depths, whose chain of dependent depths ends the
// launch (a quarter; a few hundred lanes at depths 3-4).  Its bytes (40 a
// lane on the main path) bound it at ~0.006 ms, its f32 operations at
// ~0.004 ms; it runs at ~0.024 ms on an H100 80GB HBM3 at 700 W.  The
// IEEE divisions and square roots of the bitwise contract stay.
//
// The design (redesigned after measuring each part; PERF.md §6 PR 15):
// - One thread per lane in blocks of kBlock, the small scene tables
//   copied once per block into shared memory (pt_launch.cuh setup), as
//   before: reading them through the read-only path instead lost 15% a
//   frame, and a static stride over one or two waves of resident blocks
//   20% (a thread's lanes then run their chains one after another).
// - The lane body skips the arithmetic whose result cannot reach the
//   outputs (whitted.cuh): -22% to -25% a frame, the most of any change.
// - The glue folded into the launch: the rays are read in place -- the
//   renderer's (n, 3) direction rows and its one camera origin (stride
//   0), or six columns -- and the (n, 3) energy and the traced total are
//   written here, so a frame's B5 call launches this kernel and nothing
//   else (the parent's wrapper added six column copies, a stack and a
//   sum: 0.05 ms of device time, more than the kernel).
// - The traced total: each block's sum in one atomic on a scratch word
//   that also counts the blocks done; the last block publishes the total
//   and zeroes the word (add_traced).  A memset of the total before the
//   launch cost ~1 us a frame more, a fence and two more atomics per
//   block 0.5-1.4 us more again.
// Built, measured and dropped: loops unrolled to 16 objects and 8 lights
// (+-3%), a warp with at most 1, 2 or 4 live paths running each with all
// 32 lanes (its object tests one per lane: +11% to +20% a frame inline,
// the registers it needs cost depth 0 more than it saves the chain; +65%
// out of line), the direction and energy rows staged through shared
// memory as 16-byte vectors (+5%), an early exit of the sphere test before
// d2 (+2%), blocks of 32 / 64 / 256 threads (+10% / +2% / +-0%).
//
// Build: as pt_frame.cu (ops/pt_frame.py builds every unit).

#include "pt_launch.cuh"
#include "whitted.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// add_traced's scratch word: the blocks done above kSumBits, the sum of
// their traced rays below
constexpr int kSumBits = 44;
constexpr long long kMaxBlocks = 1ll << (64 - kSumBits);

// The launch's traced rays: each block's sum and a count of one added in
// one atomic to io.scratch; the block that finds every other block
// counted writes the total to io.traced and zeroes the scratch for the
// next launch (the atomics on one word are ordered, so no fence is
// needed).  Every thread of the block takes part.
__device__ __forceinline__ void add_traced(const pt::WhittedIO& io, int tr) {
  __shared__ int warp_tr[pt::kBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    tr += __shfl_down_sync(kFull, tr, off);
  }
  if ((threadIdx.x & 31) == 0) warp_tr[threadIdx.x >> 5] = tr;
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long s = 0;
#pragma unroll
  for (int w = 0; w < pt::kBlock / 32; ++w) s += (unsigned)warp_tr[w];
  auto* acc = static_cast<unsigned long long*>(io.scratch);
  const unsigned long long add = (1ull << kSumBits) | s;
  const unsigned long long old = atomicAdd(acc, add);
  if ((old >> kSumBits) == gridDim.x - 1ull) {
    *static_cast<long long*>(io.traced) =
        (long long)((old + add) & ((1ull << kSumBits) - 1));
    atomicExch(acc, 0ull);
  }
}

// One thread per lane; kTrips: the count arm (count_iters), whose every
// thread takes the lane body (its per-depth warp votes).
template <bool kTrips>
__global__ void __launch_bounds__(pt::kBlock)
    whitted_kernel(const pt::PtArgs a, const pt::WhittedIO io) {
  extern __shared__ float smem[];
  pt::Tables tb;
  const pt::Params p = pt::setup(a, smem, tb);
  const int lane = blockIdx.x * pt::kBlock + threadIdx.x;
  const bool in = lane < a.n;
  pt::Counters cnt;
  int tr = 0;
  if (kTrips || in) tr = pt::whitted_lane<kTrips>(p, tb, io, lane, in, cnt);
  add_traced(io, tr);
  pt::finish(a, true, cnt);
}

using Kernel = void (*)(const pt::PtArgs, const pt::WhittedIO);

Kernel kernel_for(const pt::PtArgs& a) {
  return a.iters ? whitted_kernel<true> : whitted_kernel<false>;
}

}  // namespace

// Launches the Whitted kernel over a->n lanes (fewer than kMaxBlocks
// blocks; n <= 0 launches nothing) through pt::launch, the lanes' rays
// and the traced total as io says.  Returns cudaGetLastError() after the
// launch (or -1 when the packed small tables do not match the layout, -2
// without the traced output or its scratch, -3 for too many lanes); never
// synchronises.
extern "C" int whitted_launch(const pt::PtArgs* a, const pt::WhittedIO* io) {
  if (!io->traced || !io->scratch) return -2;
  if (((long long)a->n + pt::kBlock - 1) / pt::kBlock >= kMaxBlocks) {
    return -3;
  }
  return pt::launch(kernel_for(*a), a, *io);
}

// The threads the card keeps resident for the launch with these arguments
// (its SMs x the blocks per SM of the arm it takes x kBlock; nothing is
// launched), or minus a CUDA error.
extern "C" int whitted_resident(const pt::PtArgs* a, const pt::WhittedIO*) {
  int threads = 0;
  const int err = pt::resident_threads(kernel_for(*a), *a, threads);
  return err ? -err : threads;
}

// sizeof(WhittedIO) and the offsets of traced and scratch, held against
// ops/whitted_kernel.py's ctypes mirror.
extern "C" int whitted_io_layout(long long* out) {
  out[0] = (long long)sizeof(pt::WhittedIO);
  out[1] = (long long)offsetof(pt::WhittedIO, traced);
  out[2] = (long long)offsetof(pt::WhittedIO, scratch);
  return 0;
}
