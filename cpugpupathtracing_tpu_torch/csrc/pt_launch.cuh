// Launch code shared by the ADVANCED mode's kernels (pt_frame.cu,
// megakernel.cu): blocks of kBlock threads -- one thread per lane
// (launch), or as many persistent blocks as the card keeps resident, whose
// threads fetch lanes (launch_persistent, pt_frame) -- the packed small
// scene tables copied once per block into shared memory, the work
// counters reduced per warp, and the stack-overflow flag.

#pragma once

#include <cuda_runtime.h>

#include "pt_device.cuh"

namespace pt {

constexpr int kBlock = 128;

// Copy the packed small tables into shared memory `smem` (every thread
// of the block takes part) and unpack them with the trees: the launch
// parameters of one lane body.
__device__ __forceinline__ Params setup(const PtArgs& a, float* smem,
                                       Tables& tb) {
  const float* src = static_cast<const float*>(a.small);
  for (int i = threadIdx.x; i < a.small_words; i += blockDim.x) {
    smem[i] = src[i];
  }
  __syncthreads();
  Tree tree, sh_tree;
  unpack(a, smem, tb, tree, sh_tree);
  return make_params(a, tree, sh_tree);
}

// After the lane body: set the overflow flag when `ok` is false, and
// with count_iters add the warp's work counters and raise the longest
// walk to the warp's (every thread of the warp takes part, lanes past n
// with zero counts).
__device__ __forceinline__ void finish(const PtArgs& a, bool ok,
                                       const Counters& c) {
  if (!ok) atomicOr(static_cast<int*>(a.status), 1);
  if (!a.iters) return;
  unsigned long long v[NUM_COUNTERS] = {c.node, c.leaf, c.snode,
                                        c.sleaf, c.ray, c.sray};
#pragma unroll
  for (int k = 0; k < NUM_COUNTERS; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
  }
  unsigned long long longest = c.longest;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, longest, off);
    longest = o > longest ? o : longest;
  }
  if ((threadIdx.x & 31) == 0) {
    unsigned long long* iters = static_cast<unsigned long long*>(a.iters);
#pragma unroll
    for (int k = 0; k < NUM_COUNTERS; ++k) atomicAdd(iters + k, v[k]);
    if (longest) atomicMax(iters + NUM_COUNTERS + 2, longest);
  }
}

// Launch `kernel` over a->n lanes on a->stream, with the kernel's other
// arguments `x`; returns cudaGetLastError() (or -1 when the packed small
// tables do not match the layout).  Never synchronises.
template <typename... X>
inline int launch(void (*kernel)(const PtArgs, X...), const PtArgs* a,
                  X... x) {
  if (a->small_words != small_words(*a)) return -1;
  if (a->n <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)a->small_words;
  const int grid = (a->n + kBlock - 1) / kBlock;
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(a->stream)>>>(*a,
                                                                       x...);
  return (int)cudaGetLastError();
}

// The threads `kernel` keeps resident when launched with the arguments
// `a` (its shared memory: the packed small tables): the card's SMs times
// the kernel's blocks per SM at kBlock threads, times kBlock.  Returns a
// CUDA error, else 0.  Nothing is launched.
template <typename Kernel>
inline int resident_threads(Kernel kernel, const PtArgs& a, int& threads) {
  const size_t smem = sizeof(float) * (size_t)a.small_words;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBlock, smem);
  }
  threads = sms * per_sm * kBlock;
  return (int)err;
}

// Launch pt_frame's `kernel` over a->n lanes on a->stream as persistent
// blocks: as many as the card keeps resident (resident_threads), fewer
// when the lanes fill fewer; its threads fetch lanes from the zeroed
// counter a->next.  Returns cudaGetLastError() (or -1 when the packed
// small tables do not match the layout, -2 without a fetch counter).
// Never synchronises.
template <typename Kernel>
inline int launch_persistent(Kernel kernel, const PtArgs* a) {
  if (a->small_words != small_words(*a)) return -1;
  if (!a->next) return -2;
  int threads = 0;
  const int err = resident_threads(kernel, *a, threads);
  if (err) return err;
  if (a->n <= 0) return 0;
  const int need = (a->n + kBlock - 1) / kBlock;
  const int blocks = threads / kBlock;
  // grid 0 (a kernel that cannot be resident) is refused by the launch
  kernel<<<need < blocks ? need : blocks, kBlock,
           sizeof(float) * (size_t)a->small_words,
           static_cast<cudaStream_t>(a->stream)>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace pt
