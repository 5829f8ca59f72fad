// The TPU probes L8 and L9 for Hopper (sm_90a).
//
// L8 replaces tools/profile_tpu2.py's Pallas kernels `trivial` and
// `trivial2` (copy_kernel: o = 2x, launched once and twice chained), a
// launch-overhead probe: scale2_kernel writes o = 2x over n f32.  What
// bounds it: at 1024 f32 nothing but the launch (8 KB of traffic is ~2.4
// ns at 3.35 TB/s), so its shape is what a launch costs.
//
// What the design does about it (redesigned for this card; PERF.md §6):
// the first version ran a scalar grid-stride loop over min(ceil(n /
// 256), 4 x SMs) blocks of 256 threads (4 blocks, 32 warps for 1024
// f32) and asked the runtime for the SM count on every call; it read
// slower than PyTorch's x * 2 timed in turns.  Now each thread moves one
// 16-byte vector (float4) where the input and the output share their
// alignment mod 16, with a scalar head up to the first 16-byte boundary
// and a scalar tail, in the smallest grid of kScaleBlock-thread blocks
// that covers n (one block for 1024 f32); pointers that cannot be
// aligned together take the scalar path over all n.  No runtime query:
// the grid follows from n alone.
//
// L9 replaces tools/smem_probe.py's Pallas kernel `probe` (_kernel), an
// operand-size probe of the TPU's SMEM: one block stages an i32 table of
// `words` words into dynamic shared memory and returns tab[i * 8 + 3]
// (1-D) or tab[i][3] (the (words / 8, 8) 2-D view, whose rows need no
// padding here).  A table above the block's opt-in limit of shared memory
// is refused by cudaFuncSetAttribute: that refusal is the probe's answer
// (smem_probe_launch's REFUSED code), and the error is cleared, so a
// later launch runs.  What bounds it: reading the table once, into one
// SM.
//
// What the design does about it (redesigned for this card; PERF.md §6):
// the first version staged the table with scalar int loads by 256
// threads, one round trip per 256 words (93 rounds for config 3's entry
// mirror), and ran 3.9x slower than torch.take's one-word read.  Now up
// to 1024 threads issue every 16-byte request of the table at once as
// asynchronous copies from global into shared memory
// (cp.async.cg.shared.global, 16 bytes each, L2 to shared memory without
// registers), a word count that is not a multiple of 4 takes a scalar
// tail, and one cp.async.wait_all and __syncthreads() end the staging.
// No byte of shared memory goes to anything but the table (TMA's
// cp.async.bulk would need an 8-byte mbarrier there), so the probe's
// answer, the largest table that fits, is the opt-in limit itself.  The
// wrapper refuses a table that is not 16-byte aligned.
//
// labs/launch_probe.py and labs/smem_probe.py wrap them; their plain
// versions are x * 2 and tab[i * 8 + 3] in PyTorch.
//
// Build: ops/pt_frame.py builds every unit (nvcc, sm_90a, --fmad=false).

#include <cuda_runtime.h>

#include <cstddef>

namespace probes {

// the launch arguments (labs/launch_probe.py ProbeArgs mirrors them)
struct ProbeArgs {
  const void* in;   // L8: (n,) f32; L9: (words,) i32 table
  void* out;        // L8: (n,) f32; L9: (1,) i32
  const int* idx;   // L9: (1,) i32 row index
  void* stream;
  int n;            // L8: elements; L9: table words
  int two_d;        // L9: read through the (words / 8, 8) view
};

}  // namespace probes

namespace {

using probes::ProbeArgs;

// L8's threads per block, each with one float4 (PERF.md §6: the fastest
// of the shapes timed in turns with x * 2)
constexpr int kScaleBlock = 256;
// threads of the staging block: at most one per 16-byte request
constexpr int kSmemBlock = 1024;
// smem_probe_launch's code for a table the device refuses to stage: the
// CUDA error of cudaFuncSetAttribute in the low bits
constexpr int REFUSED = 1 << 16;

// o = 2x: thread t's float4 of the nvec after the scalar head, then one
// scalar of the head or the tail (head + tail elements in all).
__global__ void __launch_bounds__(kScaleBlock)
    scale2_kernel(const float* x, float* o, int n, int head, int nvec) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < nvec) {
    float4 a = reinterpret_cast<const float4*>(x + head)[t];
    a.x = a.x * 2.0f;
    a.y = a.y * 2.0f;
    a.z = a.z * 2.0f;
    a.w = a.w * 2.0f;
    reinterpret_cast<float4*>(o + head)[t] = a;
  }
  const int tail0 = head + 4 * nvec;
  if (t < head + (n - tail0)) {
    const int i = t < head ? t : tail0 + (t - head);
    o[i] = x[i] * 2.0f;
  }
}

__global__ void __launch_bounds__(kSmemBlock)
    smem_probe_kernel(const int* tab, const int* idx, int* out, int words,
                      int two_d) {
  extern __shared__ int4 smem4[];
  int* s = reinterpret_cast<int*>(smem4);
  const int4* src = reinterpret_cast<const int4*>(tab);
  const int quads = words >> 2;
  for (int i = threadIdx.x; i < quads; i += blockDim.x) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem4 + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + i)
                 : "memory");
  }
  for (int i = 4 * quads + threadIdx.x; i < words; i += blockDim.x) {
    s[i] = tab[i];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    const int i = idx[0];
    out[0] = two_d ? reinterpret_cast<const int(*)[8]>(s)[i][3] : s[i * 8 + 3];
  }
}

}  // namespace

// L8: o = 2x on a->stream.  Returns cudaGetLastError(); never
// synchronises.
extern "C" int scale2_launch(const ProbeArgs* a) {
  const int n = a->n;
  if (n <= 0) return 0;
  const float* x = static_cast<const float*>(a->in);
  float* o = static_cast<float*>(a->out);
  const size_t xa = reinterpret_cast<size_t>(x) % 16;
  // head: the scalars before the first 16-byte boundary of both; all n
  // where the two are not aligned alike
  int head = n, nvec = 0;
  if (xa == reinterpret_cast<size_t>(o) % 16 && xa % 4 == 0) {
    head = (int)((16 - xa) % 16 / 4);
    if (head > n) head = n;
    nvec = (n - head) / 4;
  }
  const int scalars = n - 4 * nvec;
  const int threads = nvec > scalars ? nvec : scalars;
  scale2_kernel<<<(threads + kScaleBlock - 1) / kScaleBlock, kScaleBlock, 0,
                  static_cast<cudaStream_t>(a->stream)>>>(x, o, n, head,
                                                          nvec);
  return (int)cudaGetLastError();
}

// L9: one block stages the a->n-word table and reads row *idx.  Returns
// 0, REFUSED | error where the device refuses the table's shared memory
// (the error cleared), -1 for a table that is not 16-byte aligned, or
// the launch's error; never synchronises.
extern "C" int smem_probe_launch(const ProbeArgs* a) {
  const size_t bytes = (size_t)a->n * sizeof(int);
  if (reinterpret_cast<size_t>(a->in) % 16 != 0) return -1;
  const cudaError_t rc = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return REFUSED | (int)rc;
  }
  smem_probe_kernel<<<1, kSmemBlock, bytes,
                      static_cast<cudaStream_t>(a->stream)>>>(
      static_cast<const int*>(a->in), a->idx, static_cast<int*>(a->out), a->n,
      a->two_d);
  return (int)cudaGetLastError();
}

// The current device's shared memory per block with the opt-in
// attribute, bytes (or minus the CUDA error).
extern "C" int smem_optin(const void*) {
  int dev = 0, v = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
  }
  return rc == cudaSuccess ? v : -(int)rc;
}

// ProbeArgs' size and the offsets of stream and two_d, for the ctypes
// mirror's check.
extern "C" int probe_args_layout(long long* out) {
  out[0] = (long long)sizeof(ProbeArgs);
  out[1] = (long long)offsetof(ProbeArgs, stream);
  out[2] = (long long)offsetof(ProbeArgs, two_d);
  return 0;
}
