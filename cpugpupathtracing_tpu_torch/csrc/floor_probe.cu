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
// slab test, 55 per triangle test, over 67 TFLOP/s; built with
// --fmad=false, unfused f32 issues at most half that rate); the loads
// read 64 rows, which stay in L1; the control stages are integer and
// stack work that the bound's model has no term for (labs/floor_probe.py
// control_yardstick prices their stack words at the shared-memory rate).
// One thread per lane.  A lane's 64-word stack lives in shared memory,
// word-major over the block (word k of thread x at k * 128 + x: the 32
// lanes of a warp at any depths fall in 32 banks), 32 KB a block in the
// arms with a control stage; it never depends on the entries being
// uniform over a warp.  The slab and leaf stages test each child box and
// triangle record as its float4 arrive, so only the one under test is
// live in registers (78 at most, no spill: with the whole 48-float node
// row and 96 floats of records live across the stages and the stack in
// local memory, the full frame-stack body took 168 registers and ran
// 3x slower; PERF.md section 6).  ctrl takes the slots that push as a
// mask, as a walk takes its slab tests' pass bits (one e % 3, not one per
// slot), and makes its 8 pushes predicated on the mask's bits.
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
static_assert((kRows & (kRows - 1)) == 0, "the pushes take e's low bits");
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

// The lane's stack word k: word-major over the block, so the 32 lanes of a
// warp at any depths fall in 32 distinct banks.
__device__ __forceinline__ int& word(int* st, int k) { return st[k * kBlock]; }

// One slab test of a child box b (6 f32) against the lane's ray and t.
__device__ __forceinline__ bool slab_one(const float* b, float ox, float oy,
                                         float oz, float ix, float iy,
                                         float iz, float t, bool m) {
  const float tx1 = (b[0] - ox) * ix, ty1 = (b[1] - oy) * iy,
              tz1 = (b[2] - oz) * iz, tx2 = (b[3] - ox) * ix,
              ty2 = (b[4] - oy) * iy, tz2 = (b[5] - oz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)),
                           fminf(tz1, tz2));
  const float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)),
                           fmaxf(tz1, tz2));
  return tmax >= tmin && tmin < t && m;
}

// One triangle record tm (v0, e1, e2) against the lane's ray: t moves to
// a hit nearer than it.
__device__ __forceinline__ void leaf_one(const float* tm, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, bool m, float& t) {
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
  if (det_ok && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f && tt > 0.0f &&
      tt < t && m) {
    t = tt;
  }
}

// kCount float4 at p into v, or the fill f where the arm has no loads.
template <bool kLoads, int kCount>
__device__ __forceinline__ void fetch(const float* p, float f, float* v) {
#pragma unroll
  for (int q = 0; q < kCount; ++q) {
    if constexpr (kLoads) {
      const float4 x = ld4(p + 4 * q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    } else {
      v[4 * q] = v[4 * q + 1] = v[4 * q + 2] = v[4 * q + 3] = f;
    }
  }
}

template <int kStages>
__global__ void __launch_bounds__(kBlock) floor_kernel(const FloorArgs a) {
  constexpr bool kCtrl = kStages & STAGE_CTRL, kFctrl = kStages & STAGE_FCTRL,
                 kLoads = kStages & STAGE_LOADS, kSlab = kStages & STAGE_SLAB,
                 kLeaf = kStages & STAGE_LEAF;
  // the lanes' stacks, kStack words each, in shared memory (an arm
  // without a control stage has none)
  __shared__ int stacks[kCtrl || kFctrl ? kStack * kBlock : 1];
  int* st = stacks + threadIdx.x;
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
  if constexpr (kCtrl || kFctrl) word(st, 0) = e + 8;
  int sp = 1;
  float t = ox * 0.0f + 1.0f;
  for (int it = 0; it < a.k_iters; ++it) {
    const bool m = t > -1.0f;
    // the trip's rows (the loads stage), else the fill: the t of the
    // warp's first lane at the trip's start
    const int row = kLoads ? (e >= 0 ? e % kRows : 0) : 0;
    const float* np = a.nodes + (size_t)row * 64;
    const float* lp = a.ltris + (size_t)row * 128;
    const float f = kLoads ? 0.0f : __shfl_sync(kFull, t, 0);
    // each child box and triangle record is tested as its float4 arrive,
    // so only the one under test is live
    if constexpr (kSlab) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < 8; k += 2) {  // two boxes in three float4
        float b[12];
        fetch<kLoads, 3>(np + 6 * k, f, b);
        any |= slab_one(b, ox, oy, oz, ix, iy, iz, t, m);
        any |= slab_one(b + 6, ox, oy, oz, ix, iy, iz, t, m);
      }
      if (__any_sync(kFull, any)) t = t + 1e-7f;
    }
    if constexpr (kLeaf) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float tm[12];
        fetch<kLoads, 3>(lp + 16 * c, f, tm);
        leaf_one(tm, ox, oy, oz, dx, dy, dz, m, t);
      }
    }
    if constexpr (kFctrl) {
      // e >= 0 on every trip (the start entries and the pushed ones lie
      // in [0, kRows), and a lane that cannot pop takes 0), so % kRows is
      // the low bits and % 255 an unsigned remainder
      const bool interior = e >= 0;
      const int w = (int)((unsigned)e % 255u) + 1;
      const int base_p = min(sp, kStack - 9);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        word(st, base_p + k) = (e + k + 1) & (kRows - 1);
      }
      word(st, base_p + 8) = w;
      sp += interior && w != 0 ? 9 : 0;
      sp = min(sp, kStack - 18);
      const bool can = sp > 0;
      const int base = max(sp - 9, 0);
      const int mw = word(st, base + 8);
      const int ent = word(st, base + ctz8(mw));
      const int rem = mw & (mw - 1);
      word(st, base + 8) = can ? rem : mw;
      if (can && rem == 0) sp = base;
      e = can ? ent : 0;
    } else if constexpr (kCtrl) {
      // the slots that push: k with (e + k) % 3 == 0 of an interior
      // entry, as a mask (the walk's pass bits), then the linear stack's
      // pushes in slot order
      // pushes in slot order, each slot predicated on its bit (a lane's
      // cost does not depend on the other lanes' masks)
      const int r3 = e >= 0 ? e % 3 : 0;
      const unsigned pm =
          e >= 0 ? (0x49u << (r3 == 0 ? 0 : 3 - r3)) & 0xFFu : 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (pm >> k & 1u) {
          // e >= 0 here, so (e + k + 1) % kRows is the low bits
          word(st, min(sp, kStack - 1)) = (e + k + 1) & (kRows - 1);
          ++sp;
        }
      }
      sp = min(sp, kStack - 8);
      const bool can = sp > 0;
      const int top = word(st, max(sp - 1, 0));
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
