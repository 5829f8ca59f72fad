// The floor probe L5 for Hopper (sm_90a): K fixed trips per lane of the
// traversal loop body, built up in stages, to price each stage per trip.
//
// Replaces tools/floor_probe.py's Pallas kernel `run` (_probe_kernel).
// Each trip runs the stages of the arm (template argument kStages, the
// bits of STAGE_* below) in the TPU body's order:
//   loads  one node row and one leaf row, both at the lane's entry % 64
//          (without it every row value is the lane group's fill: the t of
//          its first lane);
//   slab   8 slab tests of the node row's boxes; a lane group in which
//          some lane's box passes moves every lane's t on by 1e-7;
//   leaf   8 triangle tests of the leaf row's records, the nearest hit
//          closer than t taken;
//   ctrl   the linear stack's control: 8 conditional pushes of constant
//          entries and a pop; fctrl the frame stack's: a 9-word frame
//          push and a lowest-set-bit pop; neither: the entry steps by one.
// The entries never depend on the data, so every lane takes exactly K
// trips.  A lane's entry sequence is that of its TPU row, (lane % 1024) /
// 128, so it is uniform over a warp and the row loads broadcast.  The TPU
// body couples the 128 lanes of a row (the slab stage's min over the row)
// and the 1024 of a sub-tile (the fill from its first lane); here the 32
// lanes of a warp: the slab stage's vote is __any_sync and the fill is
// lane 0's t (__shfl_sync).  labs/floor_probe.py wraps it; its plain
// version takes the layout ("warp" here, "tpu" for the JAX probe) and
// equals the kernel bitwise: t and the final entry of every lane.
//
// What bounds it: the f32 operations of the slab and leaf stages (26 per
// slab test, 55 per triangle test, over 67 TFLOP/s); the loads read 64
// rows, which stay in L1; the control stages are integer and local-memory
// work that the bound's model has no term for.  One thread per lane with
// its own 64-word stack in local memory, as the traversal kernels.
//
// Build: ops/pt_frame.py builds every unit (nvcc, sm_90a, --fmad=false).

#include <cuda_runtime.h>

#include <cstddef>

namespace floorprobe {

// the launch arguments (labs/floor_probe.py FloorArgs mirrors them)
struct FloorArgs {
  const float* nodes;  // (R >= 64, 64) f32
  const float* ltris;  // (R >= 64, 128) f32
  const float* ray[6];
  float* t_out;
  int* entry_out;
  void* stream;
  int n, k_iters, stages;
};

}  // namespace floorprobe

namespace {

using floorprobe::FloorArgs;

constexpr int kBlock = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 64;  // rows cycled through by the entries
constexpr int kStack = 64;
enum { STAGE_CTRL = 1, STAGE_FCTRL = 2, STAGE_LOADS = 4, STAGE_SLAB = 8,
       STAGE_LEAF = 16 };

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The lowest set bit of an 8-bit frame mask, 7 when none is set (the
// JAX package's _ctz8).
__device__ __forceinline__ int ctz8(int mw) {
  return mw == 0 ? 7 : min(__ffs(mw) - 1, 7);
}

template <int kStages>
__global__ void __launch_bounds__(kBlock) floor_kernel(const FloorArgs a) {
  constexpr bool kCtrl = kStages & STAGE_CTRL, kFctrl = kStages & STAGE_FCTRL,
                 kLoads = kStages & STAGE_LOADS, kSlab = kStages & STAGE_SLAB,
                 kLeaf = kStages & STAGE_LEAF;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = lane < a.n;
  // a lane past n runs on the ray (1, 1, 1, 1, 1, 1), as the plain
  // version's padding: its warp's votes and fill include it
  const float ox = real ? a.ray[0][lane] : 1.0f;
  const float oy = real ? a.ray[1][lane] : 1.0f;
  const float oz = real ? a.ray[2][lane] : 1.0f;
  const float dx = real ? a.ray[3][lane] : 1.0f;
  const float dy = real ? a.ray[4][lane] : 1.0f;
  const float dz = real ? a.ray[5][lane] : 1.0f;
  const float ix = dx == 0.0f ? 1e30f : 1.0f / dx;
  const float iy = dy == 0.0f ? 1e30f : 1.0f / dy;
  const float iz = dz == 0.0f ? 1e30f : 1.0f / dz;
  int e = (lane % 1024) / 128;
  int stack[kStack];
  stack[0] = e + 8;
  int sp = 1;
  float t = ox * 0.0f + 1.0f;
  for (int it = 0; it < a.k_iters; ++it) {
    const bool m = t > -1.0f;
    float nm[48], lm[8][12];
    if constexpr (kLoads) {
      const int row = e >= 0 ? e % kRows : 0;
      const float* np = a.nodes + (size_t)row * 64;
      const float* lp = a.ltris + (size_t)row * 128;
#pragma unroll
      for (int q = 0; q < 12; ++q) {
        const float4 v = ld4(np + 4 * q);
        nm[4 * q] = v.x;
        nm[4 * q + 1] = v.y;
        nm[4 * q + 2] = v.z;
        nm[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 v = ld4(lp + 16 * c + 4 * q);
          lm[c][4 * q] = v.x;
          lm[c][4 * q + 1] = v.y;
          lm[c][4 * q + 2] = v.z;
          lm[c][4 * q + 3] = v.w;
        }
      }
    } else {
      const float f = __shfl_sync(kFull, t, 0);
#pragma unroll
      for (int q = 0; q < 48; ++q) nm[q] = f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int q = 0; q < 12; ++q) lm[c][q] = f;
      }
    }
    if constexpr (kSlab) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float* b = nm + 6 * k;
        const float tx1 = (b[0] - ox) * ix, ty1 = (b[1] - oy) * iy,
                    tz1 = (b[2] - oz) * iz, tx2 = (b[3] - ox) * ix,
                    ty2 = (b[4] - oy) * iy, tz2 = (b[5] - oz) * iz;
        const float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)),
                                 fminf(tz1, tz2));
        const float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)),
                                 fmaxf(tz1, tz2));
        any |= tmax >= tmin && tmin < t && m;
      }
      if (__any_sync(kFull, any)) t = t + 1e-7f;
    }
    if constexpr (kLeaf) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float* tm = lm[c];
        const float hx = dy * tm[8] - dz * tm[7];
        const float hy = dz * tm[6] - dx * tm[8];
        const float hz = dx * tm[7] - dy * tm[6];
        const float aa = tm[3] * hx + tm[4] * hy + tm[5] * hz;
        const bool det_ok = fabsf(aa) >= 0.001f;
        const float f = 1.0f / (det_ok ? aa : 1.0f);
        const float sx = ox - tm[0], sy = oy - tm[1], sz = oz - tm[2];
        const float u = f * (sx * hx + sy * hy + sz * hz);
        const float qx = sy * tm[5] - sz * tm[4];
        const float qy = sz * tm[3] - sx * tm[5];
        const float qz = sx * tm[4] - sy * tm[3];
        const float vv = f * (dx * qx + dy * qy + dz * qz);
        const float tt = f * (tm[6] * qx + tm[7] * qy + tm[8] * qz);
        if (det_ok && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f &&
            tt > 0.0f && tt < t && m) {
          t = tt;
        }
      }
    }
    if constexpr (kFctrl) {
      const bool interior = e >= 0;
      const int w = e % 255 + 1;
      const int base_p = min(sp, kStack - 9);
#pragma unroll
      for (int k = 0; k < 8; ++k) stack[base_p + k] = (e + k + 1) % kRows;
      stack[base_p + 8] = w;
      sp += interior && w != 0 ? 9 : 0;
      sp = min(sp, kStack - 18);
      const bool can = sp > 0;
      const int base = max(sp - 9, 0);
      const int mw = stack[base + 8];
      const int ent = stack[base + ctz8(mw)];
      const int rem = mw & (mw - 1);
      stack[base + 8] = can ? rem : mw;
      if (can && rem == 0) sp = base;
      e = can ? ent : 0;
    } else if constexpr (kCtrl) {
      const bool interior = e >= 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (interior && (e + k) % 3 == 0) {
          stack[min(sp, kStack - 1)] = (e + k + 1) % kRows;
          ++sp;
        }
      }
      sp = min(sp, kStack - 8);
      const bool can = sp > 0;
      const int top = stack[max(sp - 1, 0)];
      e = can ? top : 0;
      if (can) --sp;
    } else {
      e = (e + 1) % kRows;
    }
  }
  if (real) {
    a.t_out[lane] = t;
    a.entry_out[lane] = e;
  }
}

template <int kStages>
int launch(const FloorArgs* a) {
  if (a->n <= 0) return 0;
  const int grid = (a->n + kBlock - 1) / kBlock;
  floor_kernel<kStages>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(a->stream)>>>(*a);
  return (int)cudaGetLastError();
}

// The stage sets of tools/floor_probe.py main, one instantiation each.
struct StageArm {
  int stages;
  int (*launch)(const FloorArgs*);
};
constexpr StageArm ARMS[] = {
    {0, launch<0>},
    {STAGE_CTRL, launch<STAGE_CTRL>},
    {STAGE_FCTRL, launch<STAGE_FCTRL>},
    {STAGE_LOADS, launch<STAGE_LOADS>},
    {STAGE_CTRL | STAGE_LOADS, launch<STAGE_CTRL | STAGE_LOADS>},
    {STAGE_FCTRL | STAGE_LOADS, launch<STAGE_FCTRL | STAGE_LOADS>},
    {STAGE_CTRL | STAGE_LOADS | STAGE_SLAB,
     launch<STAGE_CTRL | STAGE_LOADS | STAGE_SLAB>},
    {STAGE_CTRL | STAGE_LOADS | STAGE_LEAF,
     launch<STAGE_CTRL | STAGE_LOADS | STAGE_LEAF>},
    {STAGE_CTRL | STAGE_LOADS | STAGE_SLAB | STAGE_LEAF,
     launch<STAGE_CTRL | STAGE_LOADS | STAGE_SLAB | STAGE_LEAF>},
    {STAGE_FCTRL | STAGE_LOADS | STAGE_SLAB | STAGE_LEAF,
     launch<STAGE_FCTRL | STAGE_LOADS | STAGE_SLAB | STAGE_LEAF>},
};

}  // namespace

// a->stages: the stage bits.  Returns cudaGetLastError() after the
// launch, or -2 for a stage set that is not instantiated; never
// synchronises.
extern "C" int floor_launch(const FloorArgs* a) {
  for (const StageArm& arm : ARMS) {
    if (arm.stages == a->stages) return arm.launch(a);
  }
  return -2;
}

// FloorArgs' size and the offsets of stream and stages, for the ctypes
// mirror's check.
extern "C" int floor_args_layout(long long* out) {
  out[0] = (long long)sizeof(FloorArgs);
  out[1] = (long long)offsetof(FloorArgs, stream);
  out[2] = (long long)offsetof(FloorArgs, stages);
  return 0;
}
