#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Drives the port's main paths -- config 3 (glass dragon stand-in, ground
quad, two sphere lights; ADVANCED, depth 5, 1 spp) at 1920x1080 through
`Renderer`, on the whole-frame route (`pt_frame`) and on the per-depth
route (`shade_extend` + `shadow_resolve` per depth, chosen with
CPUGPU_NO_PTFRAME=1); config 1 (spheres, a plane, two point lights;
WHITTED, depth 4) at 800x600 through the whole-frame Whitted kernel
(`whitted_frame`); WHITTED on config 3's scene at 1920x1080 through
`trace_whitted` (`traverse_packet_slim` per scene query); and config 5
(six instanced dragons under a TLAS, refit every frame; ADVANCED, depth
5, 1280x720) on its three routes: flattened whole-frame, flattened
per-depth, and object-space per-depth (CPUGPU_NO_FLATTEN=1, the instance
arms of `shade_extend` and `shadow_resolve`), plus one WHITTED frame of
its object-space scene (the instance arm of `traverse_packet_slim`);
the XLA integrator (`trace_advanced`, `traverse_packet_slim` per scene
query, its count_depth arm with AOVs) on config 3 with AOVs off and on
and in the RAY_DEPTH and BVH_DEPTH views, on config 5's object-space
scene with AOVs, on a mesh light over the light table and on config 1
in ADVANCED mode; config 3 in the BRUTE_FORCE and COMPARISON modes
(`traverse_packet_slim` per scene query); config 2 (the midpoint-split
glTF scene, icosphere fallback) at 1280x720 on both ADVANCED routes;
config 4 (config 3 at 4 spp) as 1-spp sub-steps against the unrolled
frame and through `render_pipelined`; a live material edit on config 3;
and configs 3 and 5 under every node-table layout and
leaf-side / occlusion variant (CPUGPU_LEAF14, CPUGPU_OCCL2,
CPUGPU_OCCL_W16), the traversal labs L1-L4, L6 and L7 on config 3's
bounce fan, and the TPU probes L5, L8 and L9 -- and holds every CUDA
kernel of those paths against its plain PyTorch version on the card.
It also drives the XLA walks (Scene(traversal="wide" | "skip" |
"binary"), no kernel) on configs 3 and 5 against brute force.
Phases, one line each; any failure raises and exits non-zero:

  1. device      the card's name and power limit (nvidia-smi)
  2. build       nvcc build of the kernels from the checkout, one nvcc per
                 unit in parallel (seconds, ptxas per kernel arm: its
                 template arguments, the leaf arm last -- 0 shading
                 leaves, 1 and 2 occlusion leaves of one and two rows)
  3. scene       the JAX-free config-3 scene build (seconds, table bytes)
  4. check       8192 lanes from the middle of the 1920x1080 blocked camera
                 order through pt_frame (single span, split span) and its
                 plain version on the card; closest hits (t, id, object,
                 normal) of the kernel's own traversal against brute force;
                 [check_refill]: the lanes repeated to twice the threads
                 pt_frame's persistent launch keeps resident, one span and
                 both spans with the carry, bitwise the 8192-lane launch;
                 [c2_config3]: the camera lanes whose closest hit the
                 conservative slab margin changed (ROADMAP C2; after phase
                 12 [c2_config5] on config 5's flattened scene)
  5. check_mega  the same lanes: one shade_extend at depth 0 and one
                 shadow_resolve on its outputs against their plain
                 versions (flags and traced exact, energy under the
                 megakernel contract); trace_advanced_mega with and without
                 lane identities against trace_advanced_frame, bitwise
  6. frame       whole-frame route: one warm-up frame; one frame timing
                 each kernel launch; one frame counting each launch's work
                 and holding every 256th lane of both launches (their real
                 inputs: 2 depths with the carry out, then 4 sorted depths
                 with the carry in) against the plain version, with each
                 launch's warp-trip share (lane_share: lane trips / 32
                 warp trips of the walk loops); then timed frames through
                 Renderer
  7. frame_mega  the same on the per-depth route (6 + 6 launches and 3
                 sorts per frame), then one frame from reset on each route
                 with the same seed: images and traced counts equal;
                 [mega_d<depth>_<kernel>] per launch, with its live lanes,
                 warp trips and lane share (shade_extend's count arm)
  8. check_traverse  8192 config-3 lanes: traverse_packet_slim's closest
                 hits of camera rays and any hits of shadow rays toward
                 both lights (half of the lanes inactive), and under one
                 live lane in 32 and none, against its plain version,
                 bitwise (any hits: existence; inactive lanes exact); the
                 lanes repeated past the most threads the card keeps
                 resident, bitwise the 8192-lane launch; each query's lane
                 share, and for a closest hit with postponed leaves the
                 bound from the slot-order walk's counts beside its own
  9. check_whitted  8192 config-1 lanes through whitted_frame (six
                 columns) and whitted_frame_rows against the plain
                 version (bitwise), as given, every lane missing and one
                 live lane a warp ([check_whitted_<mask>]), and against
                 trace_whitted (state and traced exact, energy under the
                 contract)
 10. frame_whitted  config 1 at 800x600 through Renderer: 1 launch per
                 frame and no other device operation in the call, every
                 256th lane of it against the plain version;
                 [whitted_launch] per depth (live lanes, shadow rays,
                 warps with a live lane, lane share), the longest path,
                 the launch with every lane missing (bitwise, and its
                 ms), the glue operations (device_ops: the PyTorch
                 operations that do device work) and the waves; then one
                 frame
                 from reset on trace_whitted (CPUGPU_NO_WHITTED_KERNEL=1):
                 traced equal, image within the golden tolerance
 11. frame_whitted_mesh  WHITTED on config 3's scene at 1920x1080, depth
                 4, through Renderer (trace_whitted): 5 closest-hit and 10
                 any-hit launches and 5 morton5 sorts per frame, every
                 256th lane of each launch against the plain version,
                 each launch's lane share (and on the closest hits the
                 slot-order walk's bound, as in phase 8)
 11a. frame_xla  config 3 at 1920x1080 through Renderer on the XLA
                 integrator, AOVs off (CPUGPU_NO_MEGAKERNEL=1) and on
                 (track_aovs): 6 closest-hit launches (the count_depth arm
                 with AOVs), 6 shadow any-hit launches and 6 morton5 sorts
                 per frame; each run's frame from reset against the
                 whole-frame route's (traced exact, energy under the
                 megakernel contract); every 256th lane of each launch of
                 the AOV run against its plain version (the walk for
                 count_depth, bitwise); timed frames; [xla_l<k>_<kind>]
                 per launch
 11b. frame_views  the RAY_DEPTH and BVH_DEPTH views of config 3 at
                 1920x1080: the accumulator is unchanged across a view
                 frame; ray_depth in [0, depth + 1] and bvh_depth >= 1 on
                 every lane whose primary ray hits a mesh; timed frames
 11c. frame_brute / frame_comparison  config 3 at 1920x1080 in the
                 BRUTE_FORCE mode (trace_brute: one closest-hit launch and
                 one morton5 sort per depth, 6 + 6 a frame) and the
                 COMPARISON mode (left half trace_brute, right half
                 trace_advanced, unsorted: 6 + 12 launches a frame), every
                 256th lane of every launch of one frame against the plain
                 version (bitwise; any hits in existence), timed frames
                 (ms/frame, Mrays/s, B4 launches a frame);
                 [compare_halves]: the COMPARISON frame's left columns
                 equal a BRUTE_FORCE frame's and its right columns an
                 XLA-route ADVANCED frame's, bitwise
 11d. scene2 / frame2 / frame2_mega  config 2 (NAIVE_SPLIT trees) at
                 1280x720 through phases 6 and 7 (2 pt_frame launches and
                 1 sort, 6 + 6 per-depth launches and 3 sorts a frame),
                 every sampled lane's energy bitwise against the plain
                 version, the per-depth frame equal to the whole-frame one
 11e. frame4 / substeps4  config 4 (config 3's scene at 4 spp) through
                 phase 6 (8 pt_frame launches and 4 sorts a frame, every
                 launch sampled); one frame as 1-spp sub-steps and one
                 unrolled (CPUGPU_SPP_UNROLL=1): same launches, same
                 traced count, radiance within 1e-5; render_pipelined
                 timed
 11f. edit3      one material edit between two config-3 frames: the
                 accumulator resets, a new snapshot, and the frame equals
                 a fresh renderer's on the edited scene bitwise
 11g. frontends  `python -m cpugpupathtracing_tpu_torch.cli --scene
                 reference` at 1920x1080 (config 3), 3 frames with
                 --stats-json and --checkpoint, twice in new processes: the
                 second resumes (accumulated 4-6), the PNG decodes, the
                 saved accumulator equals an in-process Renderer's after 6
                 frames bitwise; the scene build, the first frame and a
                 steady frame timed apart; the CLI in WHITTED mode on
                 config 1's scene (1 whitted_frame launch a frame); a
                 LiveViewer over the config-3 renderer (GET /frame.png and
                 /stats.json, POST /input and /control set_material, the
                 edited frame bitwise a fresh renderer's, serve_frames(3),
                 publish's ms); validate_frame clean and on a NaN albedo
                 (FloatingPointError, the state unchanged); profile()'s
                 trace; metrics()'s keys
 11h. sharded    maybe_initialize_distributed at world size 1 through NCCL
                 (a file:// rendezvous under build/); render_frame_sharded
                 on config 3 in the pixels and samples modes, each frame
                 bitwise the Renderer's (2 pt_frame launches and 1 sort);
                 render_rank / trace_rank for every rank of d = 2 and 4 in
                 this process: the pixels slices put together bitwise the
                 frame and 2 frames of 2 spp the Renderer's (sub-steps),
                 the samples sum in rank order bitwise a d-spp unrolled
                 frame;
                 ms a frame of both modes and of the Renderer, in turns
 11i. walks      the XLA walks (Scene(traversal=...), ops/traverse*.py;
                 no kernel): configs 2-4 resolve to the packet route
                 ([walks_resolved]; config 5 in phase 12); for "wide",
                 "skip" and "binary" config 3's snapshot, its 8192 check
                 lanes through intersect_scene (camera rays closest,
                 shadow rays toward light 0 closest and any) against
                 brute force -- t bitwise, object and kind equal, the
                 triangle id but on counted, confirmed exact ties, any-hit
                 existence the closest hits' ([walks_hits_<walk>]) -- and
                 one 1920x1080 ADVANCED frame through Renderer with no
                 kernel launch and no sort: ms (host clock, synchronised),
                 walk calls, steps and host synchronisations per call,
                 peak memory, pixels and traced beside the packet scene's
                 XLA-route frame ([walks_frame]); config 5 at 1280x720 on
                 "wide" and "skip", the hook before each of two frames,
                 every refit bitwise a fresh build's ([walks_frame5]); one
                 BVH_DEPTH frame on "binary" ([walks_bvh_view])
 12. scene5      config 5 built flattened (default) and object-space
                 (CPUGPU_NO_FLATTEN=1, sharing the trees): seconds, table
                 bytes, flat_bytes against the budget, tree rows, TLAS
                 rows and depth, the traversal stack each tree needs
 13. check_inst  8192 config-5 lanes of the object-space scene: the
                 instance arm of traverse_packet_slim (closest hits with
                 their instance, any hits toward a light), one
                 shade_extend and one shadow_resolve, bitwise against
                 their plain versions; the flattened scene's hits against
                 the object-space ones (lanes the triangle test's
                 determinant epsilon explains, the rest within the JAX
                 package's bound); a refit of both snapshots on the card
                 against a fresh build, every table bitwise
 14-16. frame5, frame5_mega, frame5_inst  config 5 at 1280x720 through
                 Renderer on each route, the hook (new transforms, so a
                 refit) before every frame: each launch's lanes, device
                 ms, call_ms and bound, every 256th lane against the plain
                 version, timed frames with the launch and sort counts
                 per route, the refit's own ms; [frame5_<k>_<kernel>] per
                 launch, with its live lanes, warp trips and lane share
 17. compare5 / whitted5  one frame from reset per config-5 route at the
                 same transforms (flattened routes: images and traced
                 equal; object-space: its differences reported), and one
                 WHITTED frame of the object-space scene: 15 launches of
                 traverse_packet_slim's instance arm, every 256th lane
                 against the plain version
 17a. check_depth  B4's count_depth arm on the 8192 check lanes of
                 config 3 (plain arm) and config 5's object-space scene
                 (instance arm), closest and any hits, against the walk
                 (traverse_walk_reference), bitwise on every output
 17b. frame5_aov  config 5 object-space at 1280x720 with AOVs, the hook
                 before every frame: 6 launches of the instance arm's
                 count_depth arm and 6 of its shadow any-hit per frame,
                 every 256th lane of each against its plain version
 17c-d. frame_meshlight, frame_meshless  the tests' mesh-light scene (a
                 mesh light of 80 triangles, over the light table) at
                 1920x1080 and config 1 in ADVANCED mode at 800x600: the
                 gates refuse both, trace_advanced runs every frame (12
                 traversal launches and 6 sorts, and none), timed frames
 17e. check_labs  the traversal labs L1-L4, L6, L7 (labs/: traverse_lab2,
                 traverse_lab2p, traverse16, traverse_phase, traverse_lab,
                 traverse_lab_dual) on 8192 lanes
                 from the middle of config 3's bounce fan
                 (labs/bounce_fan.py: cosine-weighted bounces from the
                 1920x1080 camera hits): every arm of each against its
                 plain version, bitwise on every output, the per-tile trip
                 counters and the rows read included; closest hits
                 against traverse_packet_slim's bitwise, L3's any hit in
                 its occlusion bit (L6's fma arm: mismatches counted;
                 leaf skip: none; slab skip, the sweep, against its plain
                 version on a small tree, and on the check lanes its
                 counters against the row sequence's); L1's and L2's
                 counters per ray (their warps refill finished rays; the
                 warp trips, their schedule's, at least the rays' trips
                 over 32); L2's parent-pointer frames take the frame
                 stack's per-ray trips exactly, L7's warps the max of
                 their paired L6 warps' trips; per L1 / L2 / L6 / L7 arm
                 ([check_labs_arm]) its kernels' registers, shared memory
                 and spills from the build, device ms, bound, the
                 operations at the unfused f32 rate, ns per warp trip, and
                 L1's and L2's blocks per SM, lane trips, warp trips and
                 lane share beside the lockstep schedule's
 17f. labs       the labs' main path: the whole bounce fan (1.07M active
                 lanes) through each of the 36 arms once; before it
                 ([fan_plain]) every L1 and L2 arm on the whole fan
                 against its plain version on the card, bitwise on every
                 output and counter but the warp trips (rays refilled
                 in the middle of a warp's walk) -- hits against
                 traverse_packet_slim's on every active lane, trips, leaf
                 share, device ms, ns per warp trip, the bound from a
                 count launch made before the launch counts are zeroed;
                 L1's and L2's lane trips and lane share, the kernels
                 each launch runs and the prep kernel's share of its ms
 17g. check_floor  the floor probe L5 (labs/floor_probe.py) on the 8192
                 check lanes at 16 trips: each of its ten stage sets
                 against its plain version, bitwise on t and the entry;
                 per stage set ([check_floor_set]) its instantiation's
                 registers, shared memory and spills, device ms, bound,
                 unfused-rate ms, the stack-word yardstick, ns per trip
 17h. floor      L5's main path: each stage set once over the whole fan
                 (2,073,600 lanes) at K = 2000 trips: device ms, ns per
                 warp trip, the bound (slab and leaf operations), the
                 same at the unfused rate, the control's stack words at
                 the shared memory's rate (stack_ms), the resources
 20. layout3      config 3 at 1920x1080 under every node-table layout:
                 the default (CPUGPU_SMEMTREE=48: 48-col rows and the entry
                 side tables), CPUGPU_SMEMTREE=1 (64-col rows with them),
                 CPUGPU_SMEMTREE=0 (plain rows), CPUGPU_PACKET_TREE=w16,
                 CPUGPU_FUSED=1 and both; each built from the checkout
                 (seconds), its arms on the check lanes ([check_<layout>]:
                 every output of every arm bitwise against its plain
                 version, pt_frame also against the plain 64-col arm, B4's
                 closest and any hits with and without count_depth),
                 the whole-frame route (the fused tables through it too,
                 lifting the gate's refusal) and the per-depth route with
                 every launch timed, bounded and sampled, TIMED_FRAMES
                 timed frames and the device-busy share of each, the
                 traversal's main paths ([b4_<layout>]: one XLA frame with
                 AOVs, one WHITTED frame); then the per-depth route
                 without the any-hit tables (CPUGPU_OCCL=0) under w16 and
                 the fused tables.  Every layout's frame from reset equals
                 the default's bitwise on both routes.
 21. layout5      config 5 flattened at 1280x720 under the default, w16,
                 fused and fused w16: flatten bytes against the budget,
                 both routes with the hook before every frame, the refit's
                 ms, a refit against a fresh build (every table, the fused
                 one included, bitwise), frames from reset equal across
                 layouts.
 22. leaf3        config 3 at 1920x1080 under CPUGPU_LEAF14, CPUGPU_OCCL2
                 and CPUGPU_OCCL_W16 (the default 48-col node layout): each
                 built from the checkout (seconds, the any-hit tree's rows,
                 depth and stack), its arms on the check lanes
                 ([check_leaf_<flag>], phase 20's check with B4 over the
                 any-hit tree: every output bitwise against the plain
                 version, pt_frame's 2-row arm also against the plain
                 64-col arm, shade_extend's leaf-14 arm against the
                 shading tables' arm), the routes the gate allows (OCCL2
                 both, LEAF14 and OCCL_W16 per depth) with every launch
                 timed, bounded and sampled bitwise and LEAF_FRAMES timed
                 frames, and B4 over the any-hit tree at
                 full frame ([leaf3_b4_<flag>]: the closest hits of every
                 camera ray with count_depth, the any hits toward light 0
                 of those that hit).  Each flag's frames from reset equal
                 the default layout's bitwise (image and traced count).
 23. leaf5        config 5 flattened at 1280x720 under LEAF14 and OCCL2, as
                 phase 21 runs a layout (LEAF_FRAMES timed frames, not
                 profiled): the routes the gate allows, a refit against a
                 fresh build (the payload rows included) bitwise, frames
                 from reset equal the default's.
 24. launch       L8 (labs/launch_probe.py): the trivial kernel once and
                 twice chained against x * 2 and x * 4 bitwise, then host
                 ms per call, device ms and call_ms of it, of x * 2, and
                 of B4 on the cube and on config 3 at 1-64 tiles;
                 [launch_shape]: the kernel's block and grid at 1024
                 f32, trivial / x * 2 and trivial2 / two chained x * 2
                 timed in turns
 25. smem         L9 (labs/smem_probe.py): tables from 1,024 to 260,000
                 words staged in one block's shared memory: OK exactly up
                 to the opt-in limit, the right word read; a launch after
                 the refusals; per size the kernel's and torch.take's
                 device ms timed in turn, and L8's trivial kernel against
                 x * 2 timed in turn
 26. bench        bench_torch.py (the port's bench.py) in one new
                 process, bench_torch.main once a run: config 3 at
                 1920x1080 (16 frames), config 1 at 800x600 (64), config
                 5 at 1280x720 (8), config 3 under --devices 1 (8): the
                 process exits 0 with one line a run of bench.py's keys,
                 value > 0, every parity gate that applies true
                 (parity_gate.py: B4 plain and instanced against brute
                 force, B5 against trace_whitted on config 1, B1 against
                 the per-depth route where the config takes it), the card
                 in `device`, and only the config's frame kernel in the
                 timed frames (BENCH_DETAIL on stderr); the lines, their
                 details and each run's seconds are printed ([bench_<run>])
 18. the {"kernels": [...]} line: per kernel its check's numbers, and per
     main-path launch its lanes, ms, bound and sampled error; the
     instance arms, the count_depth arms, the variant arms and the leaf
     arms as entries of their own (`*_inst`, `*_depth`, `*_<layout>`,
     `*_<layout>_<occl|occl2|pay|ow16>`); the routes of phases 11c-e as
     entries of their own (`traverse_packet_slim_brute`,
     `traverse_packet_slim_comparison`, `pt_frame_config2`,
     `shade_extend_config2`, `shadow_resolve_config2`,
     `pt_frame_config4`: per launch of a frame its mean ms, bound and
     plain version's ms on the sampled lanes); the six lab kernels with the
     check-lane numbers of their default arm and, per arm, its numbers on
     the fan (`arms`); the probes L5 (per stage set), L8 (per case) and
     L9 (per size)
 19. the last line {"ok": true, "device": {...}}

Phases 3-17 run the plain 64-col arms (CPUGPU_SMEMTREE=0 for their
scenes); the port's default tables (the JAX benchmark's) are the "48"
layout of phase 20.

--profile adds, after phases 6, 7, 10, 11, 11a-e, 14-16 and 17b-d, a
torch.profiler
table of two frames' device time by kernel, the device-busy share of the
frame time and the host-to-device copies from pageable memory per frame,
per route.

Imports nothing of JAX and nothing of the JAX package.  Needs one card;
without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

CHECK_LANES = 8192
# samples a frame of config 4 (the JAX benchmark's config 4 at its
# lowest setting, 4-64 spp)
CONFIG4_SPP = 4
TIMED_FRAMES = 5
# timed frames per route of the leaf phases (22, 23): their arms' numbers
# come from the check lanes and the sampled launches
LEAF_FRAMES = 2
# launch_ms's clock: the spin (GPU cycles) that holds the stream busy
# ahead of each timed launch, and the runs it makes (the spin four times
# longer each) before it gives up
LAUNCH_SPIN_CYCLES = 1_000_000
LAUNCH_ATTEMPTS = 3
# the C entry (ops/pt_frame.py build's namespace) that launches each
# kernel launch_ms times
KERNEL_ENTRIES = {
    "pt_frame_kernel": ("pt_frame_launch",),
    "shade_extend_kernel": ("mk_shade_extend_launch",),
    "shadow_resolve_kernel": ("mk_shadow_resolve_launch",),
    "traverse_kernel": ("traverse_launch",),
    "whitted_kernel": ("whitted_launch",),
}
# aten operations that do no device work (device_ops): allocations (views
# are known by OpOverload.is_view)
NO_DEVICE_WORK = ("aten::empty", "aten::empty_strided", "aten::empty_like",
                  "aten::new_empty", "aten::new_empty_strided")
# every SAMPLE_STRIDE-th lane of a main-path launch is held against the
# plain version (~8100 lanes per launch at 1920x1080)
SAMPLE_STRIDE = 256
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# f32 operations per unit of the kernel's work, counted from
# csrc/pt_device.cuh: one node row = 8 slab tests of 26 ops
# (push_row); one triangle test = 55 ops (tri_test); shading one
# path vertex ~300 ops (shade_surface with NEE sampling, ~20 divisions,
# ~8 square roots, 2 sin/cos pairs and 3 exp counted as one op each)
OPS_NODE = 8 * 26
OPS_TRI = 55
OPS_SHADE = 300
LEAF_TRIS, OCCL_TRIS = 8, 14
# bytes the kernel loads from one row (csrc/pt_device.cuh): a node row's
# 12 float4 of bounds and 2 of entries (push_row), a leaf row's 8
# records of 16 f32 (closest_hit), an occlusion leaf row's 14 of 9
# (any_hit)
NODE_ROW_BYTES = 14 * 16
# node rows of the variant layouts (ops/pt_frame.py LAYOUTS), as push_node
# loads them: 48 f32 of bounds and 8 entries per block of 8 slots, from
# the row or the side table -- 224 B for every 8-wide layout (a fused
# node row's other 72 columns are never read), 448 B and 16 slab tests for
# a 16-wide row (its counts at cols 112..127 are never read); a fused
# leaf row is a leaf row (LEAF_ROW_BYTES)
ROW_COSTS = {
    **{k: (NODE_ROW_BYTES, OPS_NODE) for k in ("64", "ents", "48", "fused")},
    **{k: (2 * NODE_ROW_BYTES, 2 * OPS_NODE) for k in ("w16", "fused_w16")}}
LEAF_ROW_BYTES = LEAF_TRIS * 16 * 4
OCCL_ROW_BYTES = OCCL_TRIS * 9 * 4
# per leaf visit the triangle tests and per distinct leaf row the bytes a
# walk loads (csrc/pt_device.cuh): shading rows (8 records of 16 f32),
# occlusion rows (14 of 9), a 2-row occlusion leaf (28 tests per visit,
# both rows marked read), a leaf-14 row (14 of 9); the leaf-14 arm reads
# a record's payload (its normal, object and id: 5 f32) only when the
# record passes the triangle test, so its payload bytes are charged per
# distinct payload record read (count_iters' pay_recs)
PAY_REC_BYTES = 5 * 4
LEAF_KINDS = {"shade": (LEAF_TRIS, LEAF_ROW_BYTES),
              "occl": (OCCL_TRIS, OCCL_ROW_BYTES),
              "occl2": (2 * OCCL_TRIS, OCCL_ROW_BYTES),
              "pay": (OCCL_TRIS, OCCL_ROW_BYTES)}
# per-lane bytes of a pt_frame launch: rays + RNG state in; the carry in
# (throughput, energy, flags); energy + state + traced out, or the whole
# carry out (rays, state, throughput, energy, flags, traced)
LANE_IN, CARRY_IN, LANE_OUT, CARRY_OUT = 32, 28, 24, 64
# per-lane bytes of shade_extend: 14 columns in (6 ray f32, state 8,
# throughput and energy 3 f32 each, flags i32), 24 out (the same 14 and
# 10 f32 shadow columns), on every lane; of shadow_resolve: flags and
# energy in, energy out on every lane, and the 10 shadow columns in on a
# lane with a shadow ray
SE_LANE = (6 * 4 + 8 + 6 * 4 + 4) + (6 * 4 + 8 + 6 * 4 + 4 + 10 * 4)
SR_LANE, SR_SHADOW = 4 + 12 + 12, 10 * 4
MEGA_KERNELS = ("shade_extend", "shadow_resolve")
# megakernel contract (the JAX package's tests/test_megakernel.py)
FLIP_SHARE_MAX, FLIP_MAX, MEAN_MAX = 0.03, 0.02, 1e-4
# Whitted contract (the JAX package's tests/test_whitted_kernel.py): < 1%
# of lanes beyond 3e-6 + 3e-5 |e|, every difference < 0.05
W_FLIP_SHARE_MAX, W_FLIP_MAX = 0.01, 0.05
# golden image tolerance (tests/test_torch_renderer.py), per 8-bit channel
IMG_EQUAL_MIN, IMG_MEAN_MAX, IMG_MAX_MAX = 0.995, 0.05, 32
# flattened vs object-space instance hits (the JAX package's
# tests/test_packet_instances.py bound: at most 8 of 8192 lanes differ
# in the hit triangle, t within 1e-5 absolute and relative elsewhere),
# after the lanes explain_flattened explains
FLAT_UNEXPLAINED_MAX, FLAT_T_TOL = 8, 1e-5
# bytes of traverse_packet_slim (csrc/pt_device.cuh traverse_lane): on
# every lane t_init and the active flag in (where given) and t, id, object
# and 3 normal columns out; on an active lane also its 6 ray columns in (a
# lane that is not active never loads them)
TRAV_OUT, TRAV_RAY = 6 * 4, 6 * 4
# per-lane bytes of whitted_frame beyond its rays (ray_bytes): the state
# in, energy and state out; the traced total is one int64
WHITTED_LANE = 8 + 3 * 4 + 8
# f32 operations of the Whitted body (csrc/whitted.cuh), counted per
# object of the scene: a sphere test 27 (sphere_t and the closest-hit
# compares), a plane test 18; the occluder tests of a shadow ray 26 and
# 17; per live depth 150 for shading and the Fresnel continuation and 28
# per light for its direction; per shadow ray 9 for the light's add
W_OPS_DEPTH, W_OPS_LIGHT, W_OPS_SHADOW = 150, 28, 9
W_OPS_SPH, W_OPS_PLN, W_OPS_OCC_SPH, W_OPS_OCC_PLN = 27, 18, 26, 17


# the script's start on the host clock: every phase line carries its
# seconds since (t=)
T0 = time.perf_counter()


def say(phase: str, **kw) -> None:
    print(f"[{phase}] t={time.perf_counter() - T0:.1f} "
          + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list:
    """One line per kernel of nvcc's -Xptxas=-v output: the kernel's name,
    its registers, and its stack frame and spills."""
    out, name, frame = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '.*?"
                      r"([A-Za-z]+(?:_[A-Za-z]+)*_kernel)"
                      r"(?:I((?:L[bi]\d+E)+)E|E)", ln)
        if m:
            name, frame = m.group(1), ""
            if m.group(2) is not None:  # the template arguments: the bool
                # arms, then the leaf arm (0: shading leaves; 1, 2: 1- and
                # 2-row occlusion leaves)
                name += "<" + ",".join(
                    v if t == "i" else ("true" if v == "1" else "false")
                    for t, v in re.findall(r"L([bi])(\d+)E", m.group(2))
                ) + ">"
        elif "spill" in ln:
            frame = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {frame}")
            name = None
    return out


def ptxas_resources(name: str) -> str:
    """The build's registers, shared memory, stack frame and spills of the
    kernel instantiation `name` (as ptxas_lines names it)."""
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    for ln in ptxas_lines(ptf.build_log):
        kernel, _, rest = ln.partition(": ")
        if kernel == name:
            return rest
    raise AssertionError(f"ptxas reported no kernel {name}")


def lab_instances(arm) -> list:
    """The kernel instantiations (ptxas_lines' names) that an L1, L2, L6
    or L7 arm of labs/bounce_fan.py launches: L1's and L2's the prep and
    lab_frame_kernel<fs, fused, gate, condpush> or lab_pipe_kernel<fs,
    near, parent>; L6's slab="skip" arm the sweep's three kernels, another
    L6 arm its
    lab_ablate_kernel<leaf, slab, ctrl, smem, fixed, fused, fma, unroll>."""
    from cpugpupathtracing_tpu_torch.labs import kernel_lab as kl

    def bools(*v):
        return ",".join("true" if b else "false" for b in v)

    kw = arm.kw
    if arm.kernel == "L1":
        return ["lab_prep_kernel", "lab_frame_kernel<" + bools(
            kw.get("frame_stack", False), kw.get("fused", False),
            kw.get("gate_leaf", False), kw.get("cond_push", False)) + ">"]
    if arm.kernel == "L2":
        return ["lab_prep_kernel", "lab_pipe_kernel<" + bools(
            kw.get("frame_stack", True), kw.get("nearest", False),
            kw.get("parent", False)) + ">"]
    if arm.kernel == "L7":
        return ["lab_dual_kernel"]
    o = kl.options(**arm.kw)
    if o["slab"] == "skip":
        return ["sweep_prep_kernel", f"sweep_kernel<{kl.SWEEP_RAYS}>",
                "sweep_merge_kernel"]
    leaf, slab, ctrl, smem, fixed, fused, fma, unroll = kl._arm(o)
    flags = ",".join("true" if v else "false"
                     for v in (smem, fixed, fused, fma))
    return [f"lab_ablate_kernel<{kl.LEAF.index(leaf)},{kl.SLAB.index(slab)},"
            f"{kl.CTRL.index(ctrl)},{flags},{unroll}>"]


def sass_twins(lib: str, kernel: str) -> list:
    """Groups (two or more) of the instantiations of `kernel` in the
    shared library `lib` that compiled to the same SASS (cuobjdump -sass,
    each instruction's text), by their template arguments."""
    import hashlib

    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    tool = os.path.join(os.path.dirname(ptf._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    bodies: dict = {}
    name = None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                bodies[name] = []
        elif name and "*/" in ln and ";" in ln:
            bodies[name].append(ln.split("*/", 1)[1].split(";", 1)[0].strip())
    groups: dict = {}
    for fn, ins in bodies.items():
        args = ",".join(v for _, v in re.findall(r"L([bi])(\d+)E", fn))
        digest = hashlib.sha1("\n".join(ins).encode()).hexdigest()
        groups.setdefault(digest, []).append(f"{kernel}<{args}>")
    return [sorted(g) for g in groups.values() if len(g) > 1]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(fn, kernels, reps: int = 1, expect: int | None = None) -> list:
    """Device milliseconds of every launch of the CUDA kernels named in
    `kernels` (a name or a tuple of names of functions in csrc/) while
    fn() runs reps times, in launch order; `expect`, the number of
    launches fn() makes reps times, when the caller knows it.  Raises
    when it sees no launch (or not `expect`).

    The clock is CUDA events, as labs/common.py busy_ms's: each call of
    the kernel's C entry (KERNEL_ENTRIES: the launch and any memset it
    makes) runs between two events behind a spin kernel that holds the
    stream busy while the host enqueues it, so the host's time before the
    launch does not count; where the spin ended first, fn() runs again
    with a spin four times longer.  Every `ms` of the kernels line is this
    clock, the labs', L5's, L8's and L9's too (busy_ms over replays of
    the single launch).  torch.profiler answers no check: on the card's
    machine a short session can lose its first launches or all of them
    (CUPTI stamps device work earlier than the host stamps its launch,
    and Kineto keeps only what falls inside the session; `PERF.md`
    section 7).  Only --profile's tables and L8's and L9's
    profiler_ms, which no check reads, still open sessions."""
    import torch

    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    kernels = (kernels,) if isinstance(kernels, str) else kernels
    lib = ptf.build()
    names = sorted({e for k in kernels for e in KERNEL_ENTRIES[k]})
    entries = {name: getattr(lib, name) for name in names}
    spin = LAUNCH_SPIN_CYCLES
    for _ in range(LAUNCH_ATTEMPTS):
        held = []

        def timed(entry):
            def call(*args):
                torch.cuda._sleep(spin)
                ev = [torch.cuda.Event(), torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)]
                ev[0].record()
                ev[1].record()
                rc = entry(*args)
                idled = ev[0].query()
                ev[2].record()
                held.append((ev, idled))
                return rc
            return call

        torch.cuda.synchronize()
        for name in names:
            setattr(lib, name, timed(entries[name]))
        try:
            for _ in range(reps):
                fn()
        finally:
            for name in names:
                setattr(lib, name, entries[name])
        torch.cuda.synchronize()
        if not any(idled for _, idled in held):
            break
        spin *= 4
    else:
        raise AssertionError(f"launch_ms: the stream idled before a launch "
                             f"of {kernels} in {LAUNCH_ATTEMPTS} runs")
    ms = [ev[1].elapsed_time(ev[2]) for ev, _ in held]
    if not ms or (expect is not None and len(ms) != expect):
        raise AssertionError(f"launch_ms saw {len(ms)} launches of "
                             f"{kernels}, expected {expect or 'some'}")
    return ms


def wrapper_ms(module, names, fn) -> list:
    """Milliseconds of CUDA events around every call of the wrappers
    module.<name> (name in `names`) while fn() runs, in call order: the
    launch's device time plus any wait for the host to enqueue it.  Every
    `call_ms` of a main-path launch is this clock (PRs 1-2 reported it as
    `ms`)."""
    import torch

    events = []
    entries = {name: getattr(module, name) for name in names}

    def timed(entry):
        def call(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = entry(*a, **k)
            ev[1].record()
            events.append(ev)
            return out
        return call

    for name in names:
        setattr(module, name, timed(entries[name]))
    try:
        fn()
    finally:
        for name in names:
            setattr(module, name, entries[name])
    torch.cuda.synchronize()
    return [e0.elapsed_time(e1) for e0, e1 in events]


def timed_plain(fn):
    """(fn(), its milliseconds on the host clock, synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def kernel_ms(fn, kernel: str, reps: int = 20) -> dict:
    """A check's timing of one wrapper call fn(): `ms`, the kernel's mean
    device time per launch (launch_ms), and `call_ms`, CUDA events around
    reps back-to-back calls, which include the wrapper's host time where
    that is the longer."""
    dev_ms = launch_ms(fn, kernel, reps)
    return dict(ms=sum(dev_ms) / len(dev_ms), call_ms=cuda_ms(fn, reps))


def lane_bytes(carry_in: bool, carry_out: bool) -> int:
    return (LANE_IN + (CARRY_IN if carry_in else 0)
            + (CARRY_OUT if carry_out else LANE_OUT))


def bound_ms(iters: dict, lane_bytes_total: int, small_bytes: int,
             shade_ops: int = OPS_SHADE, layouts=("64", "64"),
             leaves=("shade", "occl")):
    """Least time of one launch's work on this run's data: the larger of
    bytes over HBM bandwidth and f32 operations over the f32 peak.  The
    bytes are each lane's input read once and output written once
    (lane_bytes_total), the small scene tables once, and once each table
    row and leaf-14 payload record the launch read (the distinct rows and
    records of count_iters), not whole tables.  iters: a kernel's count_iters counters by name
    (ptf.COUNTERS); shade_ops: operations per closest-hit ray beyond its
    walk (0 for a bare traversal); layouts: the closest-hit and the
    shadow tree's node layout (ROW_COSTS; launch_layouts); leaves: their
    leaf kinds (LEAF_KINDS; leaf_kinds)."""
    c = iters
    (nb, nops), (sb, sops) = ROW_COSTS[layouts[0]], ROW_COSTS[layouts[1]]
    (lt, lb), (st, sbytes) = LEAF_KINDS[leaves[0]], LEAF_KINDS[leaves[1]]
    ops = (nops * c["node"] + sops * c["snode"]
           + OPS_TRI * lt * c["leaf"]
           + OPS_TRI * st * c["sleaf"] + shade_ops * c["ray"])
    rows = (nb * c["node_rows"] + sb * c["snode_rows"]
            + lb * c["leaf_rows"] + sbytes * c["sleaf_rows"]
            + PAY_REC_BYTES * c["pay_recs"])
    t_bytes = (lane_bytes_total + rows + small_bytes) / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def lane_share(it: dict):
    """The share of a warp's lanes that work in a walk trip: count_iters'
    lane trips / (32 warp trips), None where no walk ran."""
    return it["ltrip"] / (32 * it["wtrip"]) if it["wtrip"] else None


def walk_share(name: str, it: dict) -> dict:
    """A launch's live lanes (the rays it traced: shadow_resolve's shadow
    rays, pt_frame's closest-hit and shadow rays), warp trips, lane share
    (lane_share; None where its walks count no trips) and longest walk
    (shadow_resolve's: the most rows one shadow ray's walk visited; 0
    for the other kernels) from its count_iters counters.  In a
    shadow_resolve warp that walks one ray with all its lanes, a trip's
    lane trips are the lanes with a child slot or a record to test."""
    live = {"shade_extend": it["ray"], "shadow_resolve": it["sray"]}.get(
        name, it["ray"] + it["sray"])
    return dict(live=live, warp_trips=it["wtrip"], lane_share=lane_share(it),
                longest=it["longest"])


def launch_layouts(nodes, kw) -> tuple:
    """(closest-hit, shadow) node layouts of a kernel call: its node
    table and keyword arguments (pt_frame's shadow tree is sh_nodes when
    given, else the closest-hit tree; shadow_resolve's and the
    traversal's one tree is both)."""
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    ch = ptf.table_layout(nodes, kw.get("ents"), kw.get("fused_nn", 0),
                          kw.get("width", 8))
    if kw.get("sh_nodes") is None:
        return ch, ch
    return ch, ptf.table_layout(kw["sh_nodes"], kw.get("sh_ents"))


def leaf_kinds(kw, tree_occl: bool = False) -> tuple:
    """(closest-hit, shadow) leaf kinds (LEAF_KINDS) of a kernel call's
    keyword arguments: the leaf-14 payload (pay) or, with tree_occl (a
    traversal's occl), occlusion leaves of occl_rows rows on the walked
    tree; 2-row occlusion leaves on the shadow tree with occl_rows=2."""
    rows2 = kw.get("occl_rows", 1) == 2
    if kw.get("pay") is not None:
        first = "pay"
    elif tree_occl and kw.get("occl"):
        first = "occl2" if rows2 else "occl"
    else:
        first = "shade"
    return first, "occl2" if rows2 and not tree_occl else "occl"


def trav_bytes(lanes: int, live: int, t_init: bool, active: bool) -> int:
    """Lane bytes a traverse_packet_slim launch must move: outputs and the
    given t_init / active columns on every lane, ray columns on the `live`
    (active) lanes only."""
    return lanes * (TRAV_OUT + 4 * t_init + 4 * active) + live * TRAV_RAY


def ray_bytes(lanes: int, rows=None) -> int:
    """Bytes of a whitted_frame launch's ray inputs, each read once: six
    columns, or the (n, 3) origin and direction rows of whitted_frame_rows
    (an origin expanded over every lane, row stride 0, is one row)."""
    if rows is None:
        return 24 * lanes
    return sum(12 if x.stride(0) == 0 else 12 * lanes for x in rows)


def whitted_bound(iters: dict, lanes: int, ds, rays_b: int):
    """Least time of a whitted_frame launch's work on this run's data:
    the operations of its live depths and shadow rays (count_iters' `ray`
    and `sray`, every occluder test of a shadow ray counted) over the f32
    peak, against its rays' bytes (rays_b, ray_bytes), its lanes' other
    bytes, the traced total and the small tables over HBM bandwidth."""
    per_depth = (W_OPS_DEPTH + W_OPS_SPH * ds.num_sph + W_OPS_PLN * ds.num_pln
                 + W_OPS_LIGHT * ds.num_lights)
    per_shadow = (W_OPS_SHADOW + W_OPS_OCC_SPH * ds.num_sph
                  + W_OPS_OCC_PLN * ds.num_pln)
    ops = per_depth * iters["ray"] + per_shadow * iters["sray"]
    small = 4 * sum(t.numel() for t in (ds.mk_mats, ds.mk_lights, ds.mk_sph,
                                         ds.mk_pln, ds.mk_sph_mat,
                                         ds.mk_pln_mat, ds.mk_objmat))
    t_bytes = (lanes * WHITTED_LANE + rays_b + 8 + small) / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def counts() -> dict:
    """Every kernel arm's launch count (ops/pt_frame.py launches, keyed by
    launch_key), and the wavefront sorts."""
    from cpugpupathtracing_tpu_torch.models import integrators
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    return dict(ptf.launches, sorts=integrators.sorts)


def reset_counts() -> None:
    """Every kernel's launch count and the sort count to 0, just before a
    main path runs."""
    from cpugpupathtracing_tpu_torch.models import integrators
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    ptf.launches.clear()
    integrators.sorts = 0


# the launch-count keys of the arms a layout phase runs (arm_keys): a
# phase names the kernels of its route by their plain arm's key, and
# expect_counts reads each through this map
ARM: dict = {}


def arm(name: str) -> str:
    return ARM.get(name, name)


def arm_keys(ds, settings) -> dict:
    """The launch-count key (ptf.launch_key) of each route's kernel on the
    snapshot ds under the current flags: pt_frame on the whole-frame
    route's tables, shade_extend / shadow_resolve on the per-depth route's
    and the traversal (with and without count_depth) on
    intersect_scene's."""
    from cpugpupathtracing_tpu_torch.models import integrators
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    from cpugpupathtracing_tpu_torch.models import scene as scenelib

    key, layout, leaf = ptf.launch_key, ptf.table_layout, ptf.leaf_arm
    tables, kw = integrators.frame_args(ds, settings)
    ch = layout(tables[0], kw["ents"], kw["fused_nn"], kw["width"])
    sh = layout(kw["sh_nodes"], kw["sh_ents"]) if kw.get("occl") else ch
    tables, tkw = integrators.route_tables(ds)
    lay = layout(tables[0], tkw["ents"], tkw["fused_nn"], tkw["width"])
    sn, _, skw = integrators.shadow_tables(ds)
    sleaf = leaf(occl_rows=skw.get("occl_rows", 1),
                 occl_width=skw.get("width", 8) if skw.get("occl") else 8)
    slay = layout(sn, skw.get("ents"), skw.get("fused_nn", 0),
                  skw.get("width", 8))
    pn, _, pf, pe = scenelib.packet_tables(ds)
    play = layout(pn, None if ds.machinery else pe, pf, ds.packet_width)
    return dict(pt_frame=key("pt_frame", ptf.arm_key(ch, sh),
                             leaf=leaf(occl_rows=kw.get("occl_rows", 1))),
                shade_extend=key("shade_extend", lay,
                                 leaf=leaf(pay=tkw.get("pay"))),
                shadow_resolve=key("shadow_resolve", slay, leaf=sleaf),
                traverse_packet_slim=key("traverse_packet_slim", play),
                traverse_packet_slim_depth=key("traverse_packet_slim", play,
                                               depth=True))


@contextlib.contextmanager
def arms(ds, settings):
    """ARM for the block: the arms ds's routes run."""
    ARM.update(arm_keys(ds, settings))
    try:
        yield dict(ARM)
    finally:
        ARM.clear()


def expect_counts(got: dict, what: str, **want) -> None:
    """Raise unless the counts are `want` (each kernel's key read through
    ARM) and 0 for every other kernel."""
    full = {k: 0 for k in got}
    full.update({arm(k): v for k, v in want.items() if v or arm(k) in got})
    if got != full:
        raise AssertionError(f"{what}: launched {got}, expected {full}")


def columns(o, d) -> tuple:
    return tuple(o[:, k].contiguous() for k in range(3)) + tuple(
        d[:, k].contiguous() for k in range(3))


def profile_frames(r, ms_per_frame: float, route: str,
                   frames: int = 2, step=None) -> None:
    """Device kernel time by name over `frames` frames (torch.profiler),
    the device-busy share of the unprofiled frame time, and the
    host-to-device copies from pageable memory per frame (each one
    synchronises the host with the stream); step() runs before each
    frame (config 5's hook)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            if step is not None:
                step()
            r.render_frame(sync=False)
        torch.cuda.synchronize()
    pageable = sum(1 for e in prof.events() if "Pageable" in e.name
                   and "HtoD" in e.name)
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed themselves
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((us / 1e3 / frames, e.count // frames, e.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    say("profile", route=route, frames=frames,
        device_busy_ms_per_frame=busy,
        kernels_per_frame=sum(c for _, c, _ in rows),
        device_busy_share=busy / ms_per_frame,
        pageable_h2d_copies_per_frame=pageable / frames)
    for ms, count, key in rows[:12]:
        print(f"  {ms:8.3f} ms/frame {count:5d}/frame  {key[:100]}",
              flush=True)
    return busy / ms_per_frame


def plain(ptf, tables, rays, state, **kw):
    """pt_frame's plain version on the arguments of a pt_frame call."""
    keys = ("num_lights", "num_sph", "num_pln", "nee", "rr", "cosine",
            "ref_pdf", "depths", "light_tri_meta", "depth_base", "carry_in",
            "carry_out")
    sh_records = (ptf.leaf_records(kw["sh_ltris"], occl=True)
                  if kw.get("occl") else None)
    return ptf.pt_frame_reference(tables[1], *tables[2:], rays, state,
                                  sh_records=sh_records,
                                  **{k: v for k, v in kw.items() if k in keys})


def shade_plain(mk, a, kw, records=None):
    """shade_extend's plain version on the arguments of a shade_extend
    call (a: ten tables, depth, rays, state, throughput, energy,
    flags), its instance arm when kw has the instance tables, brute force
    over the payload records when it has the leaf-14 payload."""
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    keys = ("num_lights", "num_sph", "num_pln", "nee", "rr", "cosine",
            "ref_pdf", "light_tri_meta")
    if kw.get("pay") is not None:
        records = ptf.leaf_records(a[1], occl=True, pay=kw["pay"])
    inst = None
    if kw.get("inst_inv") is not None:
        inst = (a[0], kw["roots"], kw["inst_inv"], kw["inst_nrm"],
                kw["inst_root"])
    return mk.shade_extend_reference(a[1], *a[2:], records=records,
                                     inst=inst, **{k: kw[k] for k in keys})


def resolve_plain(mk, a, kw, records=None):
    """shadow_resolve's plain version on the arguments of a
    shadow_resolve call (a: nodes, ltris, sph, pln, shadow origin,
    direction, tmax, flags, energy, contribution), its instance arm when
    kw has the instance tables."""
    inst = None
    if kw.get("inst_inv") is not None:
        inst = (a[0], kw["roots"], kw["inst_inv"], kw["inst_root"])
    return mk.shadow_resolve_reference(
        *a[1:], num_sph=kw["num_sph"], num_pln=kw["num_pln"],
        occl=kw["occl"], records=records, inst=inst)


def check_mega(ds, settings, o, d, st, ref, small_bytes) -> dict:
    """Phase 5 on the check lanes: one shade_extend at depth 0 and one
    shadow_resolve on its outputs against their plain versions, and the
    per-depth route against `ref` = (energy, state, traced) of pt_frame's
    single span, bitwise.  Returns each kernel's numbers."""
    import torch
    from cpugpupathtracing_tpu_torch.models import integrators
    from cpugpupathtracing_tpu_torch.ops import megakernel as mk
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    dev, n = st.device, st.shape[0]
    rays = columns(o, d)
    one = torch.ones(n, device=dev)
    zero = torch.zeros(n, device=dev)
    flags = torch.ones(n, dtype=torch.int32, device=dev)
    kw = integrators.extend_kwargs(ds, settings)
    skw = integrators.shadow_kwargs(ds)
    a = (*ds.tables(), 0, rays, st, (one, one, one), (zero, zero, zero),
         flags)
    *se, se_it = mk.shade_extend(*a, count_iters=True, **kw)
    sa = (ds.poccl_nodes, ds.poccl_ltris, ds.mk_sph, ds.mk_pln, se[5], se[6],
          se[7], se[4], se[3], se[8])
    *sr, sr_it = mk.shadow_resolve(*sa, count_iters=True, **skw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    se_p = shade_plain(mk, a, kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sr_p = resolve_plain(mk, sa, skw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ptf.check_status(dev)

    def traced(fl):
        return int((fl & 1).sum()) + int(((fl >> 2) & 1).sum())

    if not torch.equal(se[4], se_p[4]):
        raise AssertionError("shade_extend: flags differ from the plain "
                             "version")
    if not torch.equal(se[1], se_p[1]):
        raise AssertionError("shade_extend: RNG state differs from the "
                             "plain version")
    _, se_err, _ = contract(torch.stack(se_p[3], 1), torch.stack(se[3], 1),
                            "shade_extend vs plain")
    _, sr_err, _ = contract(torch.stack(sr_p, 1), torch.stack(sr, 1),
                            "shadow_resolve vs plain")
    if int(bits_differ(tuple(sr), tuple(sr_p)).sum()):
        raise AssertionError("shadow_resolve: energy differs from the plain "
                             "version bitwise")
    se_it = dict(zip(ptf.COUNTERS, (int(v) for v in se_it)))
    sr_it = dict(zip(ptf.COUNTERS, (int(v) for v in sr_it)))
    sr_small = 4 * (ds.mk_sph.numel() + ds.mk_pln.numel())
    out = {
        "shade_extend": dict(
            **kernel_ms(lambda: mk.shade_extend(*a, **kw),
                        "shade_extend_kernel"),
            plain_ms=(t1 - t0) * 1e3, max_abs_err=se_err, iters=se_it,
            bound=bound_ms(se_it, n * SE_LANE, small_bytes)),
        "shadow_resolve": dict(
            **kernel_ms(lambda: mk.shadow_resolve(*sa, **skw),
                        "shadow_resolve_kernel"),
            plain_ms=(t2 - t1) * 1e3, max_abs_err=sr_err, iters=sr_it,
            bound=bound_ms(sr_it, n * SR_LANE + sr_it["sray"] * SR_SHADOW,
                           sr_small)),
    }
    same = {}
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    for label, ix in (("sorted", idx), ("unsorted", None)):
        s_m, res = integrators.trace_advanced_mega(ds, settings, o, d, st,
                                                   idx=ix)
        same[label] = (torch.equal(res.energy, ref[0])
                       and torch.equal(s_m, ref[1])
                       and int(res.traced_rays) == ref[2])
        if not same[label]:
            raise AssertionError(f"per-depth route ({label}) differs from "
                                 "the whole-frame kernel")
    ptf.check_status(dev)
    say("check_mega", lanes=n, traced_kernel=traced(se[4]),
        traced_plain=traced(se_p[4]), flags_equal=True,
        shade_extend_max_abs_err=se_err, shadow_resolve_max_abs_err=sr_err,
        route_bitwise_sorted=same["sorted"],
        route_bitwise_unsorted=same["unsorted"],
        **{f"{k}_{f}": v[f] for k, v in out.items()
           for f in ("ms", "call_ms", "plain_ms")},
        **{f"{k}_bound_ms": v["bound"][0] for k, v in out.items()},
        **{f"{k}_bound_by": v["bound"][1] for k, v in out.items()},
        shade_extend_iters=se_it, shadow_resolve_iters=sr_it)
    return out


def contract(ref, got, what: str):
    """The megakernel contract on per-lane (N, 3) energies."""
    diff = (ref - got).abs()
    flips = (diff > 3e-6 + 3e-5 * ref.abs()).any(dim=1).float().mean().item()
    dmax = diff.max().item()
    dmean = abs(ref.mean().item() - got.mean().item())
    if not (flips < FLIP_SHARE_MAX and dmax < FLIP_MAX and dmean < MEAN_MAX):
        raise AssertionError(
            f"{what}: flip share {flips}, max {dmax}, mean {dmean} break the "
            "megakernel contract")
    return flips, dmax, dmean


def frame_mega(scene, cam_cfg, settings, width, height, small_bytes,
               profile: bool, phase: str = "frame_mega", whole: bool = True):
    """Phase 7: config 3 through Renderer on the per-depth route
    (CPUGPU_NO_PTFRAME=1, restored afterwards); the kernels' arms are
    ARM's.  Returns (the main-path entries of every launch of one frame,
    the timed frames' counts, and a dict of the frame time, rate, the
    per-depth renderer and the from-reset images and traced counts of
    both routes -- of the per-depth route alone when `whole` is False: the
    scene's tables are ones the whole-frame gate refuses), and prints the
    [<phase>] line."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer
    from cpugpupathtracing_tpu_torch.ops import megakernel as mk
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    dev = torch.device("cuda")
    config = RenderConfig(width=width, height=height)
    depths = settings.max_ray_depth + 1
    sorts_per_frame = min(3, settings.max_ray_depth)
    prev = os.environ.get("CPUGPU_NO_PTFRAME")
    os.environ["CPUGPU_NO_PTFRAME"] = "1"
    try:
        r = Renderer(scene, camera=cam_cfg, config=config, settings=settings,
                     device=dev)
        r.render_frame()  # warm-up
        entries = {name: getattr(mk, name) for name in MEGA_KERNELS}

        def instrumented_frame(wrap) -> None:
            for name in MEGA_KERNELS:
                setattr(mk, name, wrap(name, entries[name]))
            try:
                r.render_frame()
            finally:
                for name in MEGA_KERNELS:
                    setattr(mk, name, entries[name])
            torch.cuda.synchronize()

        # one frame timing each launch on the device, one with CUDA events
        # around each wrapper call
        dev_ms = launch_ms(r.render_frame,
                           tuple(f"{name}_kernel" for name in MEGA_KERNELS),
                           expect=2 * depths)
        call_ms = wrapper_ms(mk, MEGA_KERNELS, r.render_frame)

        # one frame counting each launch's work and keeping every
        # SAMPLE_STRIDE-th lane's inputs and outputs for the plain versions
        launches = []

        def counted(name, fn):
            def call(*a, **k):
                *out, iters = fn(*a, count_iters=True, **k)
                # lanes: shade_extend's state, shadow_resolve's flags
                n = a[12 if name == "shade_extend" else 7].shape[0]
                sel = torch.arange(0, n, SAMPLE_STRIDE, device=dev)

                def pick(x):
                    return tuple(pick(y) for y in x) if isinstance(
                        x, tuple) else x[sel]
                if name == "shade_extend":
                    args = a[:11] + tuple(pick(x) for x in a[11:])
                    got = (pick(out[3]), pick(out[4]))
                else:
                    args = a[:4] + tuple(pick(x) for x in a[4:])
                    got = (pick(tuple(out)), None)
                launches.append(dict(name=name, lanes=n, iters=iters,
                                     args=args, kw=k, got=got))
                return tuple(out)
            return call

        instrumented_frame(counted)
        if not (len(launches) == len(dev_ms) == len(call_ms)
                == 2 * depths):
            raise AssertionError(f"{len(launches)} launches in a per-depth "
                                 f"frame, expected {2 * depths}")
        main_path = []
        rec = ptf.leaf_records(scene.device(dev).pltris)
        orec = ptf.leaf_records(scene.device(dev).poccl_ltris, occl=True)
        sr_small = 4 * (scene.device(dev).mk_sph.numel()
                        + scene.device(dev).mk_pln.numel())
        for k, (ln, ms, c_ms) in enumerate(zip(launches, dev_ms, call_ms)):
            it = dict(zip(ptf.COUNTERS, (int(v) for v in ln["iters"])))
            what = f"per-depth launch {k + 1} ({ln['name']}), sampled lanes"
            if ln["name"] == "shade_extend":
                ref, p_ms = timed_plain(lambda: shade_plain(
                    mk, ln["args"], ln["kw"], rec))
                if not torch.equal(ref[4], ln["got"][1]):
                    raise AssertionError(f"{what}: flags differ")
                e_ref, e_got = ref[3], ln["got"][0]
                b = bound_ms(it, ln["lanes"] * SE_LANE, small_bytes,
                             layouts=launch_layouts(ln["args"][0], ln["kw"]),
                             leaves=leaf_kinds(ln["kw"]))
            else:
                e_ref, p_ms = timed_plain(lambda: resolve_plain(
                    mk, ln["args"], ln["kw"],
                    orec if ln["kw"]["occl"] else rec))
                e_got = ln["got"][0]
                b = bound_ms(it, ln["lanes"] * SR_LANE
                             + it["sray"] * SR_SHADOW, sr_small,
                             layouts=launch_layouts(ln["args"][0], ln["kw"]),
                             leaves=leaf_kinds(ln["kw"]))
            flips, err, mean = contract(torch.stack(e_ref, 1),
                                        torch.stack(e_got, 1), what)
            if ln["name"] == "shadow_resolve" and int(bits_differ(
                    tuple(e_got), tuple(e_ref)).sum()):
                raise AssertionError(f"{what}: energy differs bitwise")
            main_path.append(dict(
                name=ln["name"], depth=k // 2,
                layout=launch_layouts(ln["args"][0], ln["kw"])[0],
                lanes=ln["lanes"], ms=ms,
                call_ms=c_ms, plain_ms=p_ms, bound_ms=b[0], bound_by=b[1],
                **walk_share(ln["name"], it),
                sampled_lanes=int(e_got[0].shape[0]), max_abs_err=err,
                flip_share=flips, mean_err=mean,
                energy_bit_mismatches=int(bits_differ(
                    tuple(e_got), tuple(e_ref)).sum()), iters=it))
        ptf.check_status(dev)

        # the main path: timed frames, every count from 0
        ms_per_frame, traced, rate, got = timed_frames(
            r, "per-depth frames", profile, "per-depth",
            shade_extend=depths, shadow_resolve=depths, sorts=sorts_per_frame)
        ptf.check_status(dev)

        # one frame from reset on each route, same seed: equal images
        r_mega = Renderer(scene, camera=cam_cfg, config=config,
                          settings=settings, device=dev)
        r_mega.render_frame()
    finally:
        if prev is None:
            os.environ.pop("CPUGPU_NO_PTFRAME", None)
        else:
            os.environ["CPUGPU_NO_PTFRAME"] = prev
    img = r_mega.image_u32()
    same_image = same_traced = None
    if whole:
        r_whole = Renderer(scene, camera=cam_cfg, config=config,
                           settings=settings, device=dev)
        before = counts().get(arm("pt_frame"), 0)
        r_whole.render_frame()
        if counts().get(arm("pt_frame"), 0) != before + 2:
            raise AssertionError("the whole-frame route did not take "
                                 "pt_frame")
        same_image = bool((img == r_whole.image_u32()).all())
        same_traced = r_mega.stats.traced_rays == r_whole.stats.traced_rays
        if not (same_image and same_traced):
            raise AssertionError("the per-depth route's frame differs from "
                                 "the whole-frame route's")
    energy = r_mega.mean_energy
    if not (math.isfinite(energy) and energy > 0.0):
        raise AssertionError(f"mean energy {energy}")
    if img.shape != (height, width) or not (img != 0xFF000000).any():
        raise AssertionError("the per-depth frame is black")
    say(phase, width=width, height=height, frames=TIMED_FRAMES,
        ms_per_frame=ms_per_frame,
        kernel_share=sum(dev_ms) / ms_per_frame,
        mrays_per_s=rate / 1e6, traced_per_frame=traced,
        launches_per_frame={k: v / TIMED_FRAMES for k, v in got.items()
                            if k != "sorts"},
        sorts_per_frame=got["sorts"] / TIMED_FRAMES, mean_energy=energy,
        image_equal_whole_frame=same_image,
        traced_equal_whole_frame=same_traced)
    for mp in main_path:
        say(f"mega_d{mp['depth']}_{mp['name']}" if phase == "frame_mega"
            else f"{phase}_d{mp['depth']}_{mp['name']}", **mp)
    return main_path, got, dict(
        ms_per_frame=ms_per_frame, mrays_per_s=rate / 1e6, renderer=r,
        image=img, traced=r_mega.stats.traced_rays,
        whole_image=r_whole.image_u32() if whole else None,
        whole_traced=r_whole.stats.traced_rays if whole else None)


def slot_bound(entry, args, kw, lanes_bytes) -> tuple | None:
    """For a closest-hit call that walks with postponed leaves
    (csrc/pt_device.cuh postponed: no any_hit, count_depth, instances or
    occlusion leaves), the bound from the slot-order walk's counts -- the
    count_depth arm's count launch on the same call, whose visits are the
    parent schedule's -- beside its own; None for every other call.
    lanes_bytes(counts): the call's lane bytes (without the depth
    column)."""
    if kw.get("any_hit") or kw.get("count_depth") or kw.get("occl") or any(
            k.startswith("inst_") for k in kw):
        return None
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    *_, slot = entry(*args, **dict(kw, count_depth=True, count_iters=True))
    slot = dict(zip(ptf.COUNTERS, (int(v) for v in slot)))
    lay = launch_layouts(args[3], kw)
    return slot, bound_ms(slot, lanes_bytes(slot), 0, shade_ops=0,
                          layouts=lay, leaves=leaf_kinds(kw, tree_occl=True))


def check_traverse(ds, o, d) -> dict:
    """Phase 8 on the check lanes of config 3: traverse_packet_slim's
    closest hits of the camera rays (even lanes active) and its any hits
    of shadow rays from the camera hits toward each light (odd lanes that
    hit active) against the plain version on the card -- closest hits
    bitwise on every lane (t, id, object, normal; inactive lanes t_init
    and -1), any hits in existence with the inactive lanes exact -- then
    the sparse masks: one live lane in 32 and none, closest and any
    hits, against the plain version alike; and the check lanes with their
    masks repeated past the most threads the card keeps resident (a
    launch of several block waves), every copy bitwise the 8192-lane
    launch.  Per query its lane share and, for a closest
    hit with postponed leaves, the bound from the slot-order walk's
    counts (slot_bound).  Returns each query's numbers."""
    import torch
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps

    dev, n = o.device, o.shape[0]
    rays = columns(o, d)
    ar = torch.arange(n, device=dev)
    even = ar % 2 == 0
    sparse = ar % 32 == 5
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    far = torch.full((n,), 1e34, device=dev)
    rec = ptf.leaf_records(ds.pltris)
    cam = tps.traverse_packet_slim_reference(rays, far, ds.pltris,
                                             records=rec)
    pos = o + d * cam[0][:, None]
    queries = [("closest", rays, far, even, False),
               ("closest_sparse", rays, far, sparse, False),
               ("closest_dead", rays, far, none, False)]
    for li in range(ds.num_lights):
        to_l = ds.mk_lights[li, 0:3][None, :] - pos
        dist = torch.sqrt((to_l * to_l).sum(dim=1))
        to_l = to_l / dist[:, None]
        shadow = columns(pos + to_l * 0.001, to_l)
        tmax = dist - ds.mk_lights[li, 3] - 0.002
        queries.append((f"any_light{li}", shadow, tmax,
                        ~even & (cam[1] >= 0), True))
        if li == 0:
            queries += [("any_sparse", shadow, tmax,
                         sparse & (cam[1] >= 0), True),
                        ("any_dead", shadow, tmax, none, True)]
    out = {}
    for name, qr, t0, act, any_hit in queries:
        args = (qr[:3], qr[3:], t0, ds.pnodes, ds.pltris, ds.proots)
        kw = dict(active=act, any_hit=any_hit, count_depth=False)
        *got, it = tps.traverse_packet_slim(*args, count_iters=True, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = tps.traverse_packet_slim_reference(qr, t0, ds.pltris, active=act,
                                                 any_hit=any_hit, records=rec)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        ptf.check_status(dev)
        got = (got[0], got[1], got[2]) + got[3]
        ref = (ref[0], ref[1], ref[2]) + ref[3]
        if any_hit:
            bad = (got[1] >= 0) != (ref[1] >= 0)
            dead = ~act
            bad |= dead & ((got[0] != t0) | (got[1] != -1) | (got[2] != -1))
        else:
            bad = torch.zeros(n, dtype=torch.bool, device=dev)
            for a_, b_ in zip(got, ref):
                bad |= a_.view(torch.int32) != b_.view(torch.int32)
        mism = int(bad.sum())
        if mism:
            raise AssertionError(f"traverse_packet_slim {name}: {mism} lanes "
                                 "differ from the plain version")
        it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
        lanes = lambda c: trav_bytes(n, c["ray"], True, True)  # noqa: E731
        slot = slot_bound(tps.traverse_packet_slim, args, kw, lanes)
        out[name] = dict(
            active=int(act.sum()), hits=int((got[1] >= 0).sum()),
            mismatches=mism,
            max_abs_err=float((got[0] - ref[0]).abs().max()) if not any_hit
            else 0.0,
            **kernel_ms(lambda: tps.traverse_packet_slim(*args, **kw),
                        "traverse_kernel"),
            plain_ms=plain_ms, iters=it, lane_share=lane_share(it),
            bound=bound_ms(it, lanes(it), 0, shade_ops=0),
            bound_slot_ms=None if slot is None else slot[1][0],
            node_slot=None if slot is None else slot[0]["node"])
        out[name]["got"] = got
    # the check lanes repeated past the most threads the card keeps
    # resident: every copy bitwise the 8192-lane launch
    props = torch.cuda.get_device_properties(0)
    most = props.multi_processor_count * props.max_threads_per_multi_processor
    for name in ("closest", "any_light0"):
        _, qr, t0, act, any_hit = next(q for q in queries if q[0] == name)
        kw = dict(active=act, any_hit=any_hit, count_depth=False)
        reps = most // n + 2
        big = tps.traverse_packet_slim(
            tuple(c.repeat(reps) for c in qr[:3]),
            tuple(c.repeat(reps) for c in qr[3:]), t0.repeat(reps),
            ds.pnodes, ds.pltris, ds.proots,
            **dict(kw, active=act.repeat(reps)))
        ptf.check_status(dev)
        big = (big[0], big[1], big[2]) + big[3]
        mism = int(bits_differ(
            [c.view(reps, n) for c in big],
            [g[None, :].expand(reps, n) for g in out[name]["got"]]).sum())
        if mism:
            raise AssertionError(f"traverse_packet_slim {name} over "
                                 f"{reps * n} lanes: {mism} lanes differ "
                                 "from the 8192-lane launch")
        out[name].update(big_lanes=reps * n, most_resident=most,
                         big_mismatches=mism)
    for v in out.values():
        v.pop("got")
    say("check_traverse", lanes=n, **{
        f"{q}_{k}": v[k] for q, v in out.items()
        for k in ("active", "hits", "mismatches", "ms", "call_ms",
                  "plain_ms", "lane_share", "bound_slot_ms", "node_slot",
                  "big_lanes", "most_resident", "big_mismatches")
        if k in v},
        **{f"{q}_bound_ms": v["bound"][0] for q, v in out.items()},
        **{f"{q}_bound_by": v["bound"][1] for q, v in out.items()},
        **{f"{q}_iters": v["iters"] for q, v in out.items()})
    return out


def whitted_contract(ref, got, what: str):
    """The Whitted contract on per-lane (N, 3) energies."""
    diff = (ref - got).abs()
    flips = (diff > 3e-6 + 3e-5 * ref.abs()).any(dim=1).float().mean().item()
    dmax = diff.max().item()
    if not (flips < W_FLIP_SHARE_MAX and dmax < W_FLIP_MAX):
        raise AssertionError(f"{what}: flip share {flips}, max {dmax} break "
                             "the Whitted contract")
    return flips, dmax


def whitted_args(ds, rays, st):
    return ((ds.mk_mats, ds.mk_lights, ds.mk_sph, ds.mk_pln, ds.mk_sph_mat,
             ds.mk_pln_mat, ds.mk_objmat, rays, st),
            dict(num_lights=ds.num_lights, num_sph=ds.num_sph,
                 num_pln=ds.num_pln))


def miss_rows(o, d):
    """(origin, direction) rows that miss every object of config 1: from
    each lane's origin straight back (+z), away from the scene."""
    import torch

    away = torch.zeros_like(d)
    away[:, 2] = 1.0
    return o, away


def whitted_masks(o, d) -> dict:
    """The check's ray sets as (origin, direction) rows: the lanes as
    given, every lane missing, and one lane a warp (lane 16 of each 32)
    keeping its ray while the other 31 miss."""
    import torch

    mo, md = miss_rows(o, d)
    keep = (torch.arange(o.shape[0], device=o.device) % 32 == 16)[:, None]
    return dict(lanes=(o, d), all_miss=(mo, md),
                one_live_a_warp=(o, torch.where(keep, d, md)))


def check_whitted(ds, settings, o, d, st) -> dict:
    """Phase 9 on 8192 config-1 lanes: whitted_frame (six columns) and
    whitted_frame_rows against the plain version (energy, state and
    traced bitwise) on the lanes, on every lane missing and on one live
    lane a warp; the lanes against trace_whitted (state and traced exact,
    energy under the Whitted contract)."""
    import torch
    from cpugpupathtracing_tpu_torch.models import whitted
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import whitted_kernel as wk

    n = st.shape[0]
    depths = settings.max_ray_depth + 1
    masks = {}
    for mask, (mo, md) in whitted_masks(o, d).items():
        a, kw = whitted_args(ds, columns(mo, md), st)
        *out_k, it = wk.whitted_frame(*a, num_mats=ds.num_mats,
                                      depths=depths, count_iters=True, **kw)
        rows_k = wk.whitted_frame_rows(*a[:7], mo, md, st,
                                       num_mats=ds.num_mats, depths=depths,
                                       **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = wk.whitted_frame_reference(*a, depths=depths, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        same = [torch.equal(x, y) for x, y in zip(out_k, out_p)]
        same += [torch.equal(x, y) for x, y in zip(rows_k, out_p)]
        if not all(same):
            raise AssertionError(f"whitted_frame ({mask}) differs from its "
                                 f"plain version (energy, state, traced; "
                                 f"columns then rows: {same})")
        it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
        masks[mask] = dict(
            a=a, kw=kw, out_k=out_k, out_p=out_p, plain_ms=plain_ms,
            iters=it, bound=whitted_bound(it, n, ds, ray_bytes(n)),
            ms=kernel_ms(lambda: wk.whitted_frame(
                *a, num_mats=ds.num_mats, depths=depths, **kw),
                "whitted_kernel"))
        say(f"check_whitted_{mask}", lanes=n, depths=depths,
            traced=int(out_k[2]), plain_bitwise=True, rows_bitwise=True,
            ms=masks[mask]["ms"]["ms"], call_ms=masks[mask]["ms"]["call_ms"],
            plain_ms=plain_ms, bound_ms=masks[mask]["bound"][0],
            **{k: it[k] for k in ("ray", "sray", "wtrip", "ltrip",
                                  "longest")})
    m = masks["lanes"]
    a, kw, out_k, out_p = m["a"], m["kw"], m["out_k"], m["out_p"]
    s_t, res = whitted.trace_whitted(ds, settings, o, d, st)
    ptf.check_status(st.device)
    if not (torch.equal(s_t, out_k[1])
            and int(res.traced_rays) == int(out_k[2])):
        raise AssertionError("whitted_frame's state or traced differ from "
                             "trace_whitted's")
    flips, dmax = whitted_contract(res.energy, out_k[0],
                                   "whitted_frame vs trace_whitted")
    out = dict(**m["ms"], plain_ms=m["plain_ms"], iters=m["iters"],
               bound=m["bound"],
               max_abs_err=float((out_k[0] - out_p[0]).abs().max()),
               trace_max_abs_err=dmax, trace_flip_share=flips,
               trace_bitwise=torch.equal(res.energy, out_k[0]),
               masks={k: dict(ms=v["ms"]["ms"], call_ms=v["ms"]["call_ms"],
                              bound_ms=v["bound"][0])
                      for k, v in masks.items()})
    say("check_whitted", lanes=n, depths=depths, traced=int(out_k[2]),
        plain_bitwise=True, state_equal_trace_whitted=True,
        traced_equal_trace_whitted=True,
        **{k: out[k] for k in ("max_abs_err", "trace_max_abs_err",
                               "trace_flip_share", "trace_bitwise", "ms",
                               "call_ms", "plain_ms", "iters")},
        bound_ms=out["bound"][0], bound_by=out["bound"][1])
    return out


def device_ops(fn, kernels) -> list:
    """The device operations one fn() runs, in order, without a profiler
    (launch_ms says why): each launch of a kernel of `kernels` (a name or
    a tuple of names, KERNEL_ENTRIES: a call of its C entry) by the
    kernel's name, and each PyTorch operation on a CUDA tensor that does
    device work (a copy, a fill, an elementwise or reduction kernel) by
    the operation's name, e.g. "aten.mul.Tensor"; allocations and views
    (NO_DEVICE_WORK, OpOverload.is_view) do none."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    kernels = (kernels,) if isinstance(kernels, str) else kernels
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and func._schema.name not in NO_DEVICE_WORK:
                flat, _ = tree_flatten((args, kwargs, out))
                if any(isinstance(x, torch.Tensor) and x.is_cuda
                       for x in flat):
                    ops.append(str(func))
            return out

    lib = ptf.build()
    names = {e: k for k in kernels for e in KERNEL_ENTRIES[k]}
    entries = {e: getattr(lib, e) for e in names}

    def counted(e):
        def call(*args):
            ops.append(names[e])
            return entries[e](*args)
        return call

    for e in names:
        setattr(lib, e, counted(e))
    try:
        with Record():
            fn()
    finally:
        for e in names:
            setattr(lib, e, entries[e])
    return ops


def whitted_depths(ds, args, kw, depths: int) -> dict:
    """Per depth of a whitted_frame_rows launch on args (tables, origin,
    direction, state): its live lanes, shadow rays, warps with a live
    lane and lane share, from count launches cut to 1..depths depths (by
    difference), and the launch's longest path."""
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import whitted_kernel as wk

    kw = {k: v for k, v in kw.items() if k != "depths"}
    prev = dict(ray=0, sray=0, wtrip=0, ltrip=0)
    out = dict(live=[], shadow=[], warps=[], lane_share=[])
    for dd in range(1, depths + 1):
        *_, it = wk.whitted_frame_rows(*args, depths=dd, count_iters=True,
                                       **kw)
        it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
        live, warps = it["ltrip"] - prev["ltrip"], it["wtrip"] - prev["wtrip"]
        out["live"].append(it["ray"] - prev["ray"])
        out["shadow"].append(it["sray"] - prev["sray"])
        out["warps"].append(warps)
        out["lane_share"].append(live / (32 * warps) if warps else None)
        prev = it
    out["longest"] = prev["longest"]
    return out


def instrument(module, name, wrap, fn):
    """Run fn() with module.name replaced by wrap(original), then restore
    it and synchronise."""
    import torch

    entry = getattr(module, name)
    setattr(module, name, wrap(entry))
    try:
        fn()
    finally:
        setattr(module, name, entry)
    torch.cuda.synchronize()


def image_delta(a, b) -> dict:
    """The golden tolerance's numbers between two u32 RGBA8 images."""
    import numpy as np

    delta = np.abs(a.view(np.uint8).astype(np.int64)
                   - b.view(np.uint8).astype(np.int64))
    return dict(equal_share=float((delta == 0).mean()),
                mean=float(delta.mean()), max=int(delta.max()))


@contextlib.contextmanager
def frame_count(k: int):
    """TIMED_FRAMES = k for the block."""
    global TIMED_FRAMES
    old, TIMED_FRAMES = TIMED_FRAMES, k
    try:
        yield
    finally:
        TIMED_FRAMES = old


def timed_frames(r, what: str, profile: bool, route: str, **want):
    """Phase body: TIMED_FRAMES frames of r with every count from 0; the
    launch and sort counts must be `want`.  Returns (ms per frame, traced
    rays per frame, rays per second, counts)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    traced = 0
    for _ in range(TIMED_FRAMES):
        traced = traced + r.render_frame(sync=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = counts()
    expect_counts(got, what, **{k: v * TIMED_FRAMES for k, v in want.items()})
    ms = dt * 1e3 / TIMED_FRAMES
    if profile:
        profile_frames(r, ms, route)
    return ms, int(traced) // TIMED_FRAMES, int(traced) / dt, got


def frame_whitted(scene, cam_cfg, settings, width, height, profile: bool):
    """Phase 10: config 1 through Renderer on the whole-frame Whitted
    kernel (whitted_frame_rows: the launch and nothing else on the card).
    Returns (main-path entries, counts)."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models import whitted
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import whitted_kernel as wk

    dev = torch.device("cuda")
    config = RenderConfig(width=width, height=height)
    ds = scene.device(dev)
    r = Renderer(scene, camera=cam_cfg, config=config, settings=settings,
                 device=dev)
    r.render_frame()  # warm-up
    dev_ms = launch_ms(r.render_frame, "whitted_kernel")
    call_ms = wrapper_ms(wk, ("whitted_frame_rows",), r.render_frame)
    launches = []

    def counted(entry):
        def call(*a, **k):
            *out, iters = entry(*a, count_iters=True, **k)
            launches.append(dict(lanes=a[9].shape[0], iters=iters, kw=k,
                                 full=a, got=tuple(out)))
            return tuple(out)
        return call

    instrument(wk, "whitted_frame_rows", counted, r.render_frame)
    if not len(launches) == len(dev_ms) == len(call_ms) == 1:
        raise AssertionError(f"{len(launches)} whitted_frame_rows launches "
                             "in a frame, expected 1")
    ln = launches[0]
    kw = {k: v for k, v in ln["kw"].items() if k != "num_mats"}
    full = ln["full"]
    # the count arm (in the frame) and the timed arm (the frame's
    # inputs again) against the plain version on every lane: energy,
    # state and the traced total bitwise
    ref = wk.whitted_frame_reference(*full[:7], columns(*full[7:9]),
                                     full[9], **kw)
    timed = wk.whitted_frame_rows(*full, **ln["kw"])
    for arm, got in (("count", ln["got"]), ("timed", timed)):
        if not all(torch.equal(x, y) for x, y in zip(ref, got)):
            raise AssertionError(f"whitted_frame_rows' {arm} arm differs "
                                 "from the plain version on the frame's "
                                 "lanes (energy, state, traced)")
    it = dict(zip(ptf.COUNTERS, (int(v) for v in ln["iters"])))
    b = whitted_bound(it, ln["lanes"], ds,
                      ray_bytes(ln["lanes"], rows=full[7:9]))
    # the frame's launch: per depth, every lane missing, the device
    # operations of one call (the launch alone), the waves
    per_depth = whitted_depths(ds, full, ln["kw"], kw["depths"])
    mo, md = miss_rows(*full[7:9])
    miss_args = full[:7] + (mo, md, full[9])
    miss_out = wk.whitted_frame_rows(*miss_args, **ln["kw"])
    miss_ref = wk.whitted_frame_reference(*full[:7], columns(mo, md),
                                          full[9], **kw)
    if not all(torch.equal(x, y) for x, y in zip(miss_out, miss_ref)):
        raise AssertionError("whitted_frame_rows differs from the plain "
                             "version on the frame's lanes all missing")
    miss_ms = launch_ms(lambda: wk.whitted_frame_rows(*miss_args,
                                                      **ln["kw"]),
                        "whitted_kernel", reps=5)
    ops = device_ops(lambda: wk.whitted_frame_rows(*full, **ln["kw"]),
                     "whitted_kernel")
    if ops != ["whitted_kernel"]:
        raise AssertionError(f"a whitted_frame_rows call ran {ops}, "
                             "expected the kernel alone")
    # a rendered frame's trace_whitted_kernel span: its device operations
    # (device_ops); the glue is every one but the kernel
    span_ops = []

    def spanned(entry):
        def call(*a, **k):
            out = []
            span_ops.extend(device_ops(lambda: out.append(entry(*a, **k)),
                                       "whitted_kernel"))
            return out[0]
        return call

    instrument(whitted, "trace_whitted_kernel", spanned, r.render_frame)
    glue = [x for x in span_ops if x != "whitted_kernel"]
    if len(span_ops) - len(glue) != 1:
        raise AssertionError(f"a frame's trace_whitted_kernel ran "
                             f"{span_ops}, expected one whitted_kernel")
    resident = wk.resident_threads(dev)
    main_path = [dict(lanes=ln["lanes"], depths=kw["depths"], ms=dev_ms[0],
                      call_ms=call_ms[0], bound_ms=b[0], bound_by=b[1],
                      checked_lanes=int(ref[1].shape[0]),
                      max_abs_err=float((ref[0] - timed[0]).abs().max()),
                      iters=it, per_depth=per_depth,
                      all_miss_ms=sum(miss_ms) / len(miss_ms),
                      device_ops_per_call=len(ops),
                      glue_launches_per_frame=len(glue), glue_ops=glue,
                      resident_threads=resident,
                      waves=ln["lanes"] / resident)]
    ms, traced, rate, got = timed_frames(r, "whitted frames", profile,
                                         "whitted-kernel", whitted_frame=1)

    # one frame from reset on each route, same seed
    r_k = Renderer(scene, camera=cam_cfg, config=config, settings=settings,
                   device=dev)
    r_k.render_frame()
    prev = os.environ.get("CPUGPU_NO_WHITTED_KERNEL")
    os.environ["CPUGPU_NO_WHITTED_KERNEL"] = "1"
    try:
        before = counts().get("whitted_frame", 0)
        r_t = Renderer(scene, camera=cam_cfg, config=config,
                       settings=settings, device=dev)
        r_t.render_frame()
        if counts().get("whitted_frame", 0) != before:
            raise AssertionError("CPUGPU_NO_WHITTED_KERNEL=1 still took the "
                                 "kernel")
    finally:
        if prev is None:
            os.environ.pop("CPUGPU_NO_WHITTED_KERNEL", None)
        else:
            os.environ["CPUGPU_NO_WHITTED_KERNEL"] = prev
    img = r_k.image_u32()
    delta = image_delta(img, r_t.image_u32())
    if r_k.stats.traced_rays != r_t.stats.traced_rays or not (
            delta["equal_share"] >= IMG_EQUAL_MIN
            and delta["mean"] <= IMG_MEAN_MAX and delta["max"] <= IMG_MAX_MAX):
        raise AssertionError(f"the Whitted routes' frames differ: traced "
                             f"{r_k.stats.traced_rays} vs "
                             f"{r_t.stats.traced_rays}, image {delta}")
    energy = r_k.mean_energy
    if not (math.isfinite(energy) and energy > 0.0):
        raise AssertionError(f"mean energy {energy}")
    if img.shape != (height, width) or not (img != 0xFF000000).any():
        raise AssertionError("the Whitted frame is black")
    say("frame_whitted", width=width, height=height, frames=TIMED_FRAMES,
        depths=settings.max_ray_depth + 1, ms_per_frame=ms,
        kernel_share=main_path[0]["ms"] / ms, mrays_per_s=rate / 1e6,
        traced_per_frame=traced, launches_per_frame=1, mean_energy=energy,
        traced_equal_trace_whitted=True,
        image_vs_trace_whitted=delta)
    say("whitted_launch", **main_path[0])
    return main_path, got


def frame_whitted_mesh(scene, cam_cfg, settings, width, height,
                       profile: bool):
    """Phase 11: WHITTED on config 3's scene through Renderer, i.e.
    trace_whitted with one closest-hit and one any-hit launch per light
    of traverse_packet_slim per depth and a morton5 sort after each; each
    launch timed and its sampled lanes held against the plain version
    (traverse_main_path).  Returns (main-path entries, counts)."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    dev = torch.device("cuda")
    ds = scene.device(dev)
    depths = settings.max_ray_depth + 1
    per_depth = 1 + ds.num_lights
    r = Renderer(scene, camera=cam_cfg,
                 config=RenderConfig(width=width, height=height),
                 settings=settings, device=dev)
    r.render_frame()  # warm-up
    main_path = traverse_main_path(r.render_frame, "WHITTED mesh frame",
                                   per_depth)
    if len(main_path) != depths * per_depth:
        raise AssertionError(f"{len(main_path)} traversal launches in a "
                             f"frame, expected {depths * per_depth}")
    ms, traced, rate, got = timed_frames(
        r, "whitted mesh frames", profile, "whitted-mesh",
        traverse_packet_slim=depths * per_depth, sorts=depths)
    energy = frame_checks(r, "the Whitted mesh frame", height, width)
    say("frame_whitted_mesh", width=width, height=height,
        frames=TIMED_FRAMES, depths=depths, ms_per_frame=ms,
        kernel_share=sum(mp["ms"] for mp in main_path) / ms,
        mrays_per_s=rate / 1e6, traced_per_frame=traced,
        launches_per_frame=depths * per_depth, sorts_per_frame=depths,
        mean_energy=energy)
    for mp in main_path:
        say(f"whitted_mesh_d{mp['depth']}_{mp['kind']}", **mp)
    return main_path, got


# ---- 11i: the XLA walks (Scene(traversal="wide" | "skip" | "binary")) ----

WALKS = ("wide", "skip", "binary")
# the tables of each walk's snapshot (scene.WALK_FIELDS)
WALK_TABLES = {"wide": ("tri_obj", "wnodes", "wtris9", "wleaf_id",
                        "inst_blas_root"),
               "skip": ("tri_obj", "snodes12", "stris9", "sleaf_id",
                        "inst_blas_root_skip"),
               "binary": ("tri_obj", "nodes8", "tri_perm")}


def walk_scene(make, walk, share=None):
    """A benchscenes config on the XLA walk `walk`; with `share` (a scene
    of the same config) it takes that scene's meshes and trees, so only
    the snapshot is built."""
    scene, cam, settings, w, h, hook = make()
    scene.traversal = walk
    if share is not None:
        for ob, oa in zip(scene.objects, share.objects):
            ob.mesh, ob.blas, ob.own, ob.wide = oa.mesh, oa.blas, oa.own, \
                oa.wide
    return scene, cam, settings, w, h, hook


def walk_reference(ds, o, d, t_init, active=None):
    """The closest hit of every object by brute force, independent of
    intersect_scene: the mesh triangles of tris9 (ops/intersect.py
    brute_force_nearest_triangle), every sphere and plane tested
    (intersect_sphere / intersect_plane), the nearest taken by one argmin
    over mesh, spheres, planes in that order (a tie keeps the first):
    (t, object, kind, primitive)."""
    import torch
    from cpugpupathtracing_tpu_torch.models import scene as scenelib
    from cpugpupathtracing_tpu_torch.ops import intersect as isect

    tr = ds.tris9
    t, tri = isect.brute_force_nearest_triangle(
        o, d, tr[:, 0:3], tr[:, 3:6], tr[:, 6:9], t_init)
    tri = tri.to(torch.int32)
    cand_t, cand_obj, cand_kind, cand_prim = [t], [
        torch.where(tri >= 0, ds.tri_obj[tri.clamp(min=0).long()], -1)], [
        torch.full_like(tri, scenelib.PRIM_MESH)], [tri]
    sph, pln = ds.mk_sph[:ds.num_sph], ds.mk_pln[:ds.num_pln]
    for rows, objs, test, kind, a, b in (
            (sph, ds.sph_obj, isect.intersect_sphere, scenelib.PRIM_SPHERE,
             slice(0, 3), 3),
            (pln, ds.pln_obj, isect.intersect_plane, scenelib.PRIM_PLANE,
             slice(0, 3), slice(3, 6))):
        for j in range(rows.shape[0]):
            _, tj = test(o, d, rows[j, a], rows[j, b])
            cand_t.append(tj)
            cand_obj.append(torch.full_like(tri, int(objs[j])))
            cand_kind.append(torch.full_like(tri, kind))
            cand_prim.append(torch.full_like(tri, j))
    k = torch.argmin(torch.stack(cand_t, dim=1), dim=1)[:, None]
    t, obj, kind, tri = (torch.gather(torch.stack(c, dim=1), 1, k)[:, 0]
                         for c in (cand_t, cand_obj, cand_kind, cand_prim))
    if active is not None:
        t = torch.where(active, t, t_init)
        obj = torch.where(active, obj, -1)
    return t, obj, kind, tri


def walk_hits(ds, o, d, walk):
    """[walks_hits_<walk>]: the config-3 check lanes through intersect_scene
    on the walk's snapshot: camera rays (closest), and shadow rays from
    their brute-force hits toward light 0 (closest and any hit, the lanes
    that hit active).  t bitwise brute force's on every lane; object and
    kind equal; the triangle id equal but on exact ties in t (the walks
    resolve them in visit order, brute force by the lowest id), which are
    counted and each confirmed a tie; any-hit existence equal to the
    closest hits'.  Each query also runs with the CUDA graphs off
    (traverse.GRAPH_MAX_LANES = 0: every step launched from the host),
    every field bitwise the graphs' run.  Returns the numbers."""
    import torch
    from cpugpupathtracing_tpu_torch.models import scene as scenelib
    from cpugpupathtracing_tpu_torch.ops import intersect as isect
    from cpugpupathtracing_tpu_torch.ops import traverse as trav

    n, dev = o.shape[0], o.device
    far = torch.full((n,), 1e34, device=dev)
    out = {}
    ref = walk_reference(ds, o, d, far)
    hit = ref[1] >= 0
    shadow, tmax, act = shadow_query(ds, o, d, ref[0], hit)
    so = torch.stack(shadow[:3], dim=1)
    sd = torch.stack(shadow[3:], dim=1)
    sref = walk_reference(ds, so, sd, tmax, act)
    for name, qo, qd, t0, a, r in (("camera", o, d, far, None, ref),
                                   ("shadow", so, sd, tmax, act, sref)):
        graph_max = trav.GRAPH_MAX_LANES
        try:
            trav.GRAPH_MAX_LANES = 0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            h0 = scenelib.intersect_scene(ds, qo, qd, t0, active=a)
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t1) * 1e3
        finally:
            trav.GRAPH_MAX_LANES = graph_max
        scenelib.intersect_scene(ds, qo, qd, t0, active=a)  # capture
        trav.reset_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h = scenelib.intersect_scene(ds, qo, qd, t0, active=a)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        st = dict(trav.stats)
        bad_g = sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                    if x.dtype == torch.float32 else int((x != y).sum())
                    for x, y in zip(h[:6], h0[:6]))
        if bad_g:
            raise AssertionError(f"walk {walk} {name}: the graphs' run "
                                 f"differs from the host-launched one in "
                                 f"{bad_g} values")
        live = torch.ones(n, dtype=torch.bool, device=dev) if a is None else a
        bad_t = int(((h.t.view(torch.int32) != r[0].view(torch.int32))
                     & live).sum())
        bad_o = int((((h.obj != r[1]) | (h.kind != r[2])) & live).sum())
        mesh = live & (h.kind == scenelib.PRIM_MESH) & (h.obj >= 0)
        other = mesh & (h.prim != r[3])
        ties = 0
        if other.any():
            # the walk's triangle at the same t: an exact tie
            rows = ds.tris9[h.prim[other].long()]
            ok, tt = isect.intersect_triangle(
                qo[other], qd[other], rows[:, 0:3], rows[:, 3:6],
                rows[:, 6:9])
            tie = ok & (tt.view(torch.int32) == h.t[other].view(torch.int32))
            ties = int(tie.sum())
            if ties != int(other.sum()):
                raise AssertionError(
                    f"walk {walk} {name}: {int(other.sum()) - ties} hits on "
                    "another triangle than brute force's, not at a tie")
        if bad_t or bad_o:
            raise AssertionError(f"walk {walk} {name}: t differs from brute "
                                 f"force on {bad_t} lanes, object or kind on "
                                 f"{bad_o}")
        res = dict(active=int(live.sum()), hits=int((h.obj >= 0).sum()),
                   mesh_hits=int(mesh.sum()), t_mismatches=bad_t,
                   obj_mismatches=bad_o, id_ties=ties, ms=ms,
                   ms_graphs_off=eager_ms, graph_mismatches=bad_g,
                   steps_per_call=st["steps"] / max(st["calls"], 1),
                   syncs_per_call=st["syncs"] / max(st["calls"], 1),
                   replays=st["replays"], walk_calls=st["calls"])
        if name == "shadow":
            trav.reset_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ha = scenelib.intersect_scene(ds, qo, qd, t0, active=a,
                                          any_hit=True)
            torch.cuda.synchronize()
            res["any_ms"] = (time.perf_counter() - t1) * 1e3
            res["any_steps_per_call"] = trav.stats["steps"]
            bad = int((((ha.obj >= 0) != (h.obj >= 0)) & live).sum())
            if bad:
                raise AssertionError(f"walk {walk}: {bad} any hits differ "
                                     "in existence from the closest hits")
            res["any_mismatches"] = bad
        out[name] = res
        say(f"walks_hits_{walk}", query=name, **res)
    return out


def walk_frame(r, what):
    """One timed frame of the renderer r on an XLA walk from zeroed
    counts: no kernel launch and no sort; (ms, traced, walk stats, peak
    bytes above the frame's start)."""
    import torch
    from cpugpupathtracing_tpu_torch.ops import traverse as trav

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trav.reset_stats()
    t0 = time.perf_counter()
    r.render_frame()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    expect_counts(counts(), what)
    return (ms, r.stats.traced_rays, dict(trav.stats),
            torch.cuda.max_memory_allocated() - base)


def walks(scene, cam_cfg, settings, width, height, dev, scene4) -> dict:
    """Phase 11i: the XLA walks on the card.  Configs 2-4 resolve to the
    packet route ([walks_resolved]; config 5 in phase 12).  For "wide",
    "skip" and "binary": config 3's snapshot on the walk (host seconds,
    table bytes), its check lanes through intersect_scene against brute
    force (walk_hits), and one 1920x1080 ADVANCED frame through Renderer
    (the XLA route: no kernel launch, no sort) with its ms, walk calls,
    steps, host synchronisations and CUDA-graph replays per call, the
    graphs it captured, peak memory, and the pixels and traced count
    beside the packet scene's XLA-route frame; then the same frame in a
    new renderer (the snapshot's graphs cached), equal to the first, and
    the device memory the snapshot's graphs held then.  For
    "wide" and "skip": config 5 at 1280x720, the hook (a refit) before
    each of two frames, and after each refit the walk's TLAS rows,
    inst_inv, inst_nrm and world bounds bitwise a fresh build's.  One
    BVH_DEPTH frame on the "binary" scene.  Returns the numbers."""
    import torch
    from cpugpupathtracing_tpu_torch import benchscenes
    from cpugpupathtracing_tpu_torch.config import (DebugRenderMode,
                                                    RenderConfig)
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    s2 = benchscenes.config2_path_tracer_midpoint()[0]
    resolved = {2: s2.device(dev).traversal,
                3: scene.device(dev).traversal,
                4: scene4.device(dev).traversal}
    say("walks_resolved", **{f"config{k}": v for k, v in resolved.items()})
    if set(resolved.values()) != {"packet"}:
        raise AssertionError(f"a main-path config left the packet route: "
                             f"{resolved}")

    config = RenderConfig(width=width, height=height)
    with environ(CPUGPU_NO_MEGAKERNEL="1"):
        ref = Renderer(scene, camera=cam_cfg, config=config,
                       settings=settings, device=dev)
        ref.render_frame()
    ref_img, ref_traced = ref.image_u32(), ref.stats.traced_rays
    del ref
    o, d, _ = middle_lanes(cam_cfg, width, height, dev)
    out, share = {}, None
    make3 = benchscenes.config3_sah_dielectrics
    for walk in WALKS:
        sw, *_ = walk_scene(make3, walk, share)
        share = share or sw
        t0 = time.perf_counter()
        ds = sw.device(dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if ds.traversal != walk:
            raise AssertionError(f"the {walk} scene resolved to "
                                 f"{ds.traversal}")
        tb = ds.table_bytes()
        hits = walk_hits(ds, o, d, walk)
        r = Renderer(sw, camera=cam_cfg, config=config, settings=settings,
                     device=dev)
        ms, traced, st, peak = walk_frame(r, f"walk {walk} frame")
        energy = frame_checks(r, f"walk {walk} frame", height, width)
        differ = int((r.image_u32() != ref_img).sum())
        # the same frame again in a new renderer, the graphs cached
        r = Renderer(sw, camera=cam_cfg, config=config, settings=settings,
                     device=dev)
        ms2, traced2, st2, _ = walk_frame(r, f"walk {walk} second frame")
        if traced2 != traced or int((r.image_u32() != ref_img).sum()) \
                != differ:
            raise AssertionError(f"walk {walk}: the second frame from "
                                 "renderer differs from the first")
        # what the snapshot's cached graphs hold on the card after the
        # frames: the bytes allocated and reserved that dropping them frees
        # (the cached blocks outside them released first)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        alloc, resv = torch.cuda.memory_allocated(), \
            torch.cuda.memory_reserved()
        graphs = len(ds.walk_graphs)
        graph_lanes = sum(g.width for g in ds.walk_graphs.values())
        ds.walk_graphs.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        graph_bytes = alloc - torch.cuda.memory_allocated()
        graph_reserved = resv - torch.cuda.memory_reserved()
        res = dict(build_seconds=build_s,
                   walk_table_bytes=sum(v for k, v in tb.items()
                                        if k in WALK_TABLES[walk]),
                   ms_per_frame=ms, ms_second_frame=ms2,
                   captures=st["captures"],
                   captures_second_frame=st2["captures"],
                   graphs_cached=graphs, graph_lanes=graph_lanes,
                   graph_bytes=graph_bytes,
                   graph_reserved_bytes=graph_reserved,
                   walk_calls=st["calls"],
                   steps_per_call=st["steps"] / st["calls"],
                   syncs_per_call=st["syncs"] / st["calls"],
                   replays_per_call=st["replays"] / st["calls"],
                   lane_steps_per_call=st["lane_steps"] / st["calls"],
                   peak_bytes=peak, traced=traced, traced_packet=ref_traced,
                   pixels_differ=differ, pixels=width * height,
                   mean_energy=energy)
        if walk == "wide":
            res["wstack_depth"] = ds.wstack_depth
        say("walks_frame", walk=walk, width=width, height=height, **res)
        out[walk] = dict(hits=hits, frame=res)
        if walk == "binary":
            r.set_debug_mode(DebugRenderMode.BVH_DEPTH)
            acc = r._accumulator.clone()
            ms, traced, st, peak = walk_frame(r, "binary BVH_DEPTH frame")
            if not torch.equal(acc, r._accumulator) or \
                    traced != width * height:
                raise AssertionError("the BVH_DEPTH view changed the "
                                     f"accumulator or traced {traced}")
            px = torch.from_numpy(r.image_u32().astype("int64"))
            say("walks_bvh_view", walk=walk, ms_per_frame=ms,
                walk_calls=st["calls"], steps_per_call=st["steps"],
                peak_bytes=peak, traced=traced,
                distinct_pixels=int(torch.unique(px).numel()))
            out["bvh_view_ms"] = ms
        del r, ds

    make5 = benchscenes.config5_tlas_animated
    share5 = None
    for walk in ("wide", "skip"):
        s5, cam5, st5, w5, h5, hook5 = walk_scene(make5, walk, share5)
        share5 = share5 or s5
        t0 = time.perf_counter()
        ds5 = s5.device(dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        r = Renderer(s5, camera=cam5, config=RenderConfig(width=w5,
                                                          height=h5),
                     settings=st5, device=dev)
        frames = []
        for k in range(2):
            hook5(k, r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if s5.device(dev) is not ds5:
                raise AssertionError(f"config 5 {walk}: rebuilt, not refit")
            torch.cuda.synchronize()
            refit_ms = (time.perf_counter() - t0) * 1e3
            fresh, *_ = walk_scene(make5, walk, s5)
            for ob, oa in zip(fresh.objects, s5.objects):
                if oa.instances is not None:
                    ob.instances = oa.instances.copy()
            fds = fresh.build_device(dev)
            names = WALK_TABLES[walk] + ("inst_inv", "inst_nrm", "world_lo",
                                         "world_inv_extent")
            bad = [n for n in names if not torch.equal(
                *(as_bits(getattr(x, n))[0] for x in (ds5, fds)))]
            if bad:
                raise AssertionError(f"config 5 {walk}: refit differs from a "
                                     f"fresh build in {bad}")
            ms, traced, st, peak = walk_frame(r, f"config 5 {walk} frame")
            energy = frame_checks(r, f"config 5 {walk} frame", h5, w5)
            frames.append(dict(ms=ms, refit_ms=refit_ms,
                               walk_calls=st["calls"],
                               steps_per_call=st["steps"] / st["calls"],
                               syncs_per_call=st["syncs"] / st["calls"],
                               replays_per_call=st["replays"] / st["calls"],
                               captures=st["captures"],
                               peak_bytes=peak, traced=traced,
                               mean_energy=energy))
        say("walks_frame5", walk=walk, width=w5, height=h5,
            build_seconds=build_s, instances=ds5.num_instances,
            refit_bitwise_fresh=True, frames=frames)
        out[f"{walk}_config5"] = frames
        del r
    return out


# ---- config 5: TLAS instancing --------------------------------------------

@contextlib.contextmanager
def environ(**kv):
    """Set (a value) or unset (None) environment variables for the block,
    then restore them."""
    prev = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _NoRenderer:
    """A hook's renderer argument where there is no renderer."""

    def reset(self) -> None:
        pass


def config5(share=None):
    """A config-5 scene; with `share` (another config-5 scene) it reuses
    that scene's meshes and trees, so only the snapshot is built."""
    from cpugpupathtracing_tpu_torch import benchscenes

    scene, cam, settings, w, h, hook = benchscenes.config5_tlas_animated()
    if share is not None:
        for ob, oa in zip(scene.objects, share.objects):
            ob.mesh, ob.blas = oa.mesh, oa.blas
    return scene, cam, settings, w, h, hook


def scene5(dev) -> dict:
    """Phase 12: config 5 built twice from the checkout, flattened (the
    default) and on the object-space machinery (CPUGPU_NO_FLATTEN=1,
    sharing the first build's trees)."""
    import torch

    out = {}
    for route, no_flatten in (("flat", None), ("obj", "1")):
        scene, cam, settings, w, h, hook = config5(
            share=out["flat"]["scene"] if out else None)
        t0 = time.perf_counter()
        with environ(CPUGPU_NO_FLATTEN=no_flatten):
            ds = scene.device(dev)
        torch.cuda.synchronize()
        out[route] = dict(scene=scene, hook=hook, ds=ds,
                          seconds=time.perf_counter() - t0,
                          info=dict(scene.build_info))
    flat, obj = out["flat"], out["obj"]
    if not flat["ds"].packet_flattened or not obj["ds"].machinery:
        raise AssertionError("config 5 did not build one flattened and one "
                             "object-space snapshot")
    if {flat["ds"].traversal, obj["ds"].traversal} != {"packet"}:
        raise AssertionError("config 5 left the packet route")
    for k in ("flat", "obj"):
        say("scene5", route=k, seconds=round(out[k]["seconds"], 2),
            traversal=out[k]["ds"].traversal,
            flattened=out[k]["ds"].packet_flattened,
            instances=out[k]["ds"].num_instances,
            flat_bytes=out[k]["info"]["flat_bytes"],
            flatten_budget_bytes=int(out[k]["info"]["flatten_budget_mb"]
                                     * 1e6),
            node_rows=out[k]["ds"].pnodes.shape[0],
            leaf_rows=out[k]["ds"].pltris.shape[0],
            occl_node_rows=out[k]["ds"].poccl_nodes.shape[0],
            occl_leaf_rows=out[k]["ds"].poccl_ltris.shape[0],
            tlas_rows=out[k]["info"]["tlas_rows"],
            tlas_depth=out[k]["info"]["tlas_depth"],
            stack_need=out[k]["info"]["stack_need"],
            table_bytes=sum(out[k]["ds"].table_bytes().values()))
    out.update(cam=cam, settings=settings, width=w, height=h)
    return out


def inst_args(ds) -> tuple:
    """(nodes, roots, inst_inv, inst_root): the plain instance arm's
    arguments for a scene on the object-space machinery."""
    return ds.pnodes, ds.proots, ds.inst_inv, ds.inst_blas_root_packet


def as_bits(*cols):
    """The columns with every f32 one viewed as its i32 bits."""
    import torch

    return [c.view(torch.int32) if c.dtype == torch.float32 else c
            for c in cols]


def bits_differ(got, ref):
    """Lanes where any column differs bit for bit."""
    import torch

    bad = torch.zeros_like(got[1], dtype=torch.bool)
    for a_, b_ in zip(as_bits(*got), as_bits(*ref)):
        bad |= a_ != b_
    return bad


def explain_flattened(s5, rec, d, h_obj, h_flat) -> dict:
    """The flattened scene's closest hits against the object-space
    ones on the same rays.  A hit of the object-space walk is lost on
    the flattened tables when its triangle, moved to world space, fails
    the triangle test's |det| >= TRI_DET_EPS: the determinant is not
    invariant under the instance transform (it scales with s^3 between
    the two spaces for a uniform scale s).  Returns the counts of lanes
    whose hit triangle differs, of those explained so, and the largest
    |t| difference where the triangles agree."""
    import torch

    ds = s5["obj"]["ds"]
    scene = s5["obj"]["scene"]
    differ = h_obj[1] != h_flat[1]
    explained = torch.zeros_like(differ)
    A_l = [torch.as_tensor(m[:3, :3], device=d.device)
           for o_ in scene.objects if o_.instances is not None
           for m in o_.instances]
    for i, A in enumerate(A_l):
        lanes = (differ & (h_obj[6] == i)).nonzero().squeeze(1)
        if lanes.numel() == 0:
            continue
        rc = rec["blas"][i]
        at = torch.searchsorted(rc["id"].long(), h_obj[1][lanes].long())
        e1 = rc["e1"][at] @ A.T
        e2 = rc["e2"][at] @ A.T
        det = (e1 * torch.linalg.cross(d[lanes], e2)).sum(dim=1)
        explained[lanes] = det.abs() < 1e-3
    same = ~differ & (h_obj[1] >= 0)
    dt = (h_obj[0][same] - h_flat[0][same]).abs()
    tol = FLAT_T_TOL + FLAT_T_TOL * h_obj[0][same].abs()
    return dict(lanes=int(differ.numel()), hits=int((h_obj[1] >= 0).sum()),
                differ=int(differ.sum()), det_explained=int(explained.sum()),
                unexplained=int((differ & ~explained).sum()),
                same_t_max_abs_diff=float(dt.max()) if dt.numel() else 0.0,
                same_t_within_tol=bool((dt <= tol).all()))


def check_inst(s5, dev) -> dict:
    """Phase 13 on 8192 config-5 lanes from the middle of the blocked
    camera order, on the object-space scene: traverse_packet_slim's
    instance arm (closest hits: t, id, object, normal, instance; any hits
    of shadow rays toward the first light: existence), one shade_extend
    at depth 0 and one shadow_resolve on its outputs, all bitwise against
    their plain versions; the flattened scene's hits against the
    object-space ones (explain_flattened: at most FLAT_UNEXPLAINED_MAX
    lanes differ for another reason, t within FLAT_T_TOL (absolute and
    relative) where the triangles agree); a refit of both snapshots on the card against a
    fresh build at the same transforms, every table bitwise."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models import integrators
    from cpugpupathtracing_tpu_torch.models import scene as scenelib
    from cpugpupathtracing_tpu_torch.ops import megakernel as mk
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
    from cpugpupathtracing_tpu_torch.utils import rng as rnglib

    ds, settings = s5["obj"]["ds"], s5["settings"]
    o, d, pix = middle_lanes(s5["cam"], s5["width"], s5["height"], dev)
    n = CHECK_LANES
    rays = columns(o, d)
    far = torch.full((n,), 1e34, device=dev)
    ikw = ds.inst_kwargs(nrm=False)
    rec = ptf.instance_records(ds.pnodes, ds.pltris, ds.proots,
                               ds.inst_blas_root_packet)
    out = {}

    # B4: closest hits of the camera rays, any hits toward light 0
    *hk, it = tps.traverse_packet_slim(rays[:3], rays[3:], far, ds.pnodes,
                                       ds.pltris, ds.proots, count_depth=False,
                                       count_iters=True, **ikw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp = tps.traverse_packet_slim_reference(rays, far, ds.pltris,
                                            inst=inst_args(ds), records=rec)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    hk = (hk[0], hk[1], hk[2]) + hk[3] + (hk[5],)
    hp = (hp[0], hp[1], hp[2]) + hp[3] + (hp[5],)
    mism = int(bits_differ(hk, hp).sum())
    if mism:
        raise AssertionError(f"traverse_packet_slim instance arm: {mism} "
                             "closest hits differ from the plain version")
    it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
    out["traverse_packet_slim_inst"] = dict(
        **kernel_ms(lambda: tps.traverse_packet_slim(
            rays[:3], rays[3:], far, ds.pnodes, ds.pltris, ds.proots,
            count_depth=False, **ikw), "traverse_kernel"),
        plain_ms=plain_ms, max_abs_err=float((hk[0] - hp[0]).abs().max()),
        iters=it, bound=bound_ms(it, trav_bytes(n, it["ray"], True, False)
                                 + n * 4, 0, shade_ops=0),
        hits=int((hk[1] >= 0).sum()), instance_hits=int((hk[6] >= 0).sum()))
    pos = o + d * hk[0][:, None]
    to_l = ds.mk_lights[0, 0:3][None, :] - pos
    dist = torch.sqrt((to_l * to_l).sum(dim=1))
    to_l = to_l / dist[:, None]
    sq = columns(pos + to_l * 0.001, to_l)
    tmax = dist - ds.mk_lights[0, 3] - 0.002
    act = hk[1] >= 0
    ak = tps.traverse_packet_slim(sq[:3], sq[3:], tmax, ds.pnodes, ds.pltris,
                                  ds.proots, active=act, any_hit=True,
                                  count_depth=False, **ikw)
    ap = tps.traverse_packet_slim_reference(sq, tmax, ds.pltris, active=act,
                                            any_hit=True, inst=inst_args(ds),
                                            records=rec)
    any_mism = int(((ak[1] >= 0) != (ap[1] >= 0)).sum())
    if any_mism:
        raise AssertionError(f"traverse_packet_slim instance arm: {any_mism} "
                             "any hits differ from the plain version")

    # one depth of the per-depth pipeline on the instance arms
    st = rnglib.seed_lanes(pix, 0, salt=RenderConfig().seed)
    one = torch.ones(n, device=dev)
    zero = torch.zeros(n, device=dev)
    kw = dict(integrators.extend_kwargs(ds, settings), **ds.inst_kwargs())
    a = (*ds.tables(), 0, rays, st, (one, one, one), (zero, zero, zero),
         torch.ones(n, dtype=torch.int32, device=dev))
    *se, se_it = mk.shade_extend(*a, count_iters=True, **kw)
    sh_nodes, sh_ltris, skw = integrators.shadow_tables(ds)
    sa = (sh_nodes, sh_ltris, ds.mk_sph, ds.mk_pln, se[5], se[6], se[7],
          se[4], se[3], se[8])
    *sr, sr_it = mk.shadow_resolve(*sa, count_iters=True, **skw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    se_p = shade_plain(mk, a, kw, rec)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sr_p = resolve_plain(mk, sa, skw, rec)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ptf.check_status(dev)

    def flat_cols(x):
        return [c for v in x for c in (v if isinstance(v, tuple) else (v,))]

    se_bad = sum(int(bits_differ((x, x), (y, y)).sum())
                 for x, y in zip(flat_cols(se), flat_cols(se_p)))
    sr_bad = int(bits_differ(tuple(sr), tuple(sr_p)).sum())
    if se_bad or sr_bad:
        raise AssertionError(f"instance arms differ from their plain "
                             f"versions: shade_extend {se_bad} values, "
                             f"shadow_resolve {sr_bad} lanes")
    se_it = dict(zip(ptf.COUNTERS, (int(v) for v in se_it)))
    sr_it = dict(zip(ptf.COUNTERS, (int(v) for v in sr_it)))
    small = sum(v for k, v in ds.table_bytes().items()
                if k.startswith("mk_"))
    out["shade_extend_inst"] = dict(
        **kernel_ms(lambda: mk.shade_extend(*a, **kw),
                    "shade_extend_kernel"),
        plain_ms=(t1 - t0) * 1e3, iters=se_it,
        max_abs_err=float(max((x - y).abs().max() for x, y in zip(
            se[3], se_p[3]))),
        bound=bound_ms(se_it, n * SE_LANE, small))
    out["shadow_resolve_inst"] = dict(
        **kernel_ms(lambda: mk.shadow_resolve(*sa, **skw),
                    "shadow_resolve_kernel"),
        plain_ms=(t2 - t1) * 1e3, iters=sr_it,
        max_abs_err=float(max((x - y).abs().max() for x, y in zip(sr,
                                                                 sr_p))),
        bound=bound_ms(sr_it, n * SR_LANE + sr_it["sray"] * SR_SHADOW,
                       4 * (ds.mk_sph.numel() + ds.mk_pln.numel())))

    # the flattened scene's hits against the object-space ones
    fds = s5["flat"]["ds"]
    hf = tps.traverse_packet_slim(rays[:3], rays[3:], far, fds.pnodes,
                                  fds.pltris, fds.proots, count_depth=False)
    hf = (hf[0], hf[1], hf[2]) + hf[3]
    ex = explain_flattened(s5, rec, d, hk, hf)
    if ex["unexplained"] > FLAT_UNEXPLAINED_MAX or \
            not ex["same_t_within_tol"]:
        raise AssertionError(f"flattened vs object-space hits: {ex}")

    # a refit on the card against a fresh build at the same transforms
    refit_same = {}
    for route in ("flat", "obj"):
        scene, hook = s5[route]["scene"], s5[route]["hook"]
        hook(1, _NoRenderer())
        with environ(CPUGPU_NO_FLATTEN="1" if route == "obj" else None):
            refit = scene.device(dev)
            fresh_scene, *_, fresh_hook = config5(share=scene)
            fresh_hook(1, _NoRenderer())
            fresh = fresh_scene.device(dev)
        torch.cuda.synchronize()
        bad = [name for name, _ in scenelib.TABLE_FIELDS
               if not torch.equal(*as_bits(getattr(refit, name),
                                           getattr(fresh, name)))]
        if bad or refit.proots != fresh.proots:
            raise AssertionError(f"{route}: the refit differs from a fresh "
                                 f"build in {bad}")
        refit_same[route] = True
    say("check_inst", lanes=n, hits=out["traverse_packet_slim_inst"]["hits"],
        instance_hits=out["traverse_packet_slim_inst"]["instance_hits"],
        closest_mismatches=mism, any_active=int(act.sum()),
        any_hits=int((ak[1] >= 0).sum()), any_mismatches=any_mism,
        shade_extend_mismatches=se_bad, shadow_resolve_mismatches=sr_bad,
        shadow_rays=int(((se[4] >> 2) & 1).sum()),
        flattened_vs_objspace=ex, refit_bitwise=refit_same,
        **{f"{k}_{f}": v[f] for k, v in out.items()
           for f in ("ms", "call_ms", "plain_ms")},
        **{f"{k}_bound_ms": v["bound"][0] for k, v in out.items()},
        **{f"{k}_bound_by": v["bound"][1] for k, v in out.items()},
        **{f"{k}_iters": v["iters"] for k, v in out.items()})
    return out


FRAME5_ROUTES = {
    # route: (scene, environment, wrappers (module, name, kernels),
    #         launches and sorts per frame)
    "frame5": ("flat", {}, "pt_frame", dict(pt_frame=2, sorts=1)),
    "frame5_mega": ("flat", {"CPUGPU_NO_PTFRAME": "1"}, "mega",
                    dict(shade_extend=6, shadow_resolve=6, sorts=3)),
    "frame5_inst": ("obj", {"CPUGPU_NO_FLATTEN": "1"}, "mega",
                    dict(shade_extend_inst=6, shadow_resolve_inst=6,
                         sorts=3)),
}


def frame5(s5, phase: str, profile: bool, label: str | None = None):
    """Phases 14-16: config 5 at 1280x720 through Renderer on one route,
    with the hook (new transforms, hence a refit) before every frame: one
    frame timing each launch on the device and one with CUDA events
    around each wrapper call; one frame counting each launch's work and
    holding every SAMPLE_STRIDE-th lane against the plain version
    (state and flags exact; energy bitwise on the instance arms, under
    the megakernel contract on the plain arms); TIMED_FRAMES timed frames with
    every count from 0; the refit's own time over TIMED_FRAMES refits.
    The kernels' arms are ARM's; `label` names the printed lines
    (phase by default).  Returns (main-path entries, counts, a dict of
    the frame time, rate, refit time and the renderer)."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer
    from cpugpupathtracing_tpu_torch.ops import megakernel as mk
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    which, env, wrappers, want = FRAME5_ROUTES[phase]
    label = label or phase
    scene, hook = s5[which]["scene"], s5[which]["hook"]
    settings, w, h = s5["settings"], s5["width"], s5["height"]
    dev = torch.device("cuda")
    depths = settings.max_ray_depth + 1
    if wrappers == "pt_frame":
        module, names, kernels = ptf, ("pt_frame",), "pt_frame_kernel"
    else:
        module, names = mk, MEGA_KERNELS
        kernels = tuple(f"{k}_kernel" for k in MEGA_KERNELS)
    with environ(**env):
        r = Renderer(scene, camera=s5["cam"],
                     config=RenderConfig(width=w, height=h),
                     settings=settings, device=dev)
        frame_no = [2]

        def frame(sync=True):
            hook(frame_no[0], r)
            frame_no[0] += 1
            return r.render_frame(sync=sync)

        frame()  # warm-up
        dev_ms = launch_ms(frame, kernels, expect=sum(
            v for k, v in want.items() if k != "sorts"))
        call_ms = wrapper_ms(module, names, frame)
        launches = []
        entries = {name: getattr(module, name) for name in names}

        def counted(name):
            fn = entries[name]

            def call(*a, **k):
                *out, iters = fn(*a, count_iters=True, **k)
                if name == "pt_frame":
                    rays_, state_ = a[-2], a[-1]
                    sel = torch.arange(0, state_.shape[0], SAMPLE_STRIDE,
                                       device=dev)
                    ci = k.get("carry_in")
                    launches.append(dict(
                        name=name, lanes=state_.shape[0], iters=iters,
                        tables=a[:-2], kw=k,
                        rays=tuple(x[sel] for x in rays_),
                        state=state_[sel],
                        carry_in=None if ci is None else (
                            tuple(x[sel] for x in ci[0]),
                            tuple(x[sel] for x in ci[1]), ci[2][sel]),
                        got=out if k.get("carry_out") else out[:2],
                        sel=sel))
                    return tuple(out)
                n_ = a[12 if name == "shade_extend" else 7].shape[0]
                sel = torch.arange(0, n_, SAMPLE_STRIDE, device=dev)

                def pick(x):
                    return tuple(pick(y) for y in x) if isinstance(
                        x, tuple) else x[sel]
                if name == "shade_extend":
                    args = a[:11] + tuple(pick(x) for x in a[11:])
                    got = (pick(out[3]), pick(out[4]), pick(out[1]))
                else:
                    args = a[:4] + tuple(pick(x) for x in a[4:])
                    got = (pick(tuple(out)),)
                launches.append(dict(name=name, lanes=n_, iters=iters,
                                     args=args, kw=k, got=got))
                return tuple(out)
            return call

        for name in names:
            setattr(module, name, counted(name))
        try:
            frame()
        finally:
            for name in names:
                setattr(module, name, entries[name])
        torch.cuda.synchronize()
        n_launch = sum(v for k, v in want.items() if k != "sorts")
        if not (len(launches) == len(dev_ms) == len(call_ms) == n_launch):
            raise AssertionError(f"{phase}: {len(launches)} launches in a "
                                 f"frame, expected {n_launch}")
        ds = scene.device(dev)
        rec = (ptf.instance_records(ds.pnodes, ds.pltris, ds.proots,
                                    ds.inst_blas_root_packet)
               if ds.machinery else ptf.leaf_records(ds.pltris))
        orec = None if ds.machinery else ptf.leaf_records(ds.poccl_ltris,
                                                          occl=True)
        small = sum(v for k, v in ds.table_bytes().items()
                    if k.startswith("mk_"))
        sr_small = 4 * (ds.mk_sph.numel() + ds.mk_pln.numel())
        main_path = []
        for k, (ln, ms, c_ms) in enumerate(zip(launches, dev_ms, call_ms)):
            it = dict(zip(ptf.COUNTERS, (int(v) for v in ln["iters"])))
            what = f"{phase} launch {k + 1} ({ln['name']}), sampled lanes"
            if ln["name"] == "pt_frame":
                kk = dict(ln["kw"], carry_in=ln["carry_in"])
                ref = plain(ptf, ln["tables"], ln["rays"], ln["state"], **kk)
                got = ln["got"]
                sel = ln["sel"]
                if kk.get("carry_out"):
                    exact = [(ref[1], got[1][sel]), (ref[4], got[4][sel])]
                    e_ref = torch.stack(ref[3], 1)
                    e_got = torch.stack([y[sel] for y in got[3]], 1)
                else:
                    exact = [(ref[1], got[1][sel])]
                    e_ref, e_got = ref[0], got[0][sel]
                b = bound_ms(it, ln["lanes"] * lane_bytes(
                    ln["carry_in"] is not None, bool(kk.get("carry_out"))),
                    small, layouts=launch_layouts(ln["tables"][0], kk),
                    leaves=leaf_kinds(kk))
            elif ln["name"] == "shade_extend":
                ref = shade_plain(mk, ln["args"], ln["kw"], rec)
                exact = [(ref[4], ln["got"][1]), (ref[1], ln["got"][2])]
                e_ref = torch.stack(ref[3], 1)
                e_got = torch.stack(ln["got"][0], 1)
                b = bound_ms(it, ln["lanes"] * SE_LANE, small,
                             layouts=launch_layouts(ln["args"][0], ln["kw"]),
                             leaves=leaf_kinds(ln["kw"]))
            else:
                ref = resolve_plain(mk, ln["args"], ln["kw"],
                                    orec if ln["kw"]["occl"] else rec)
                exact = []
                e_ref = torch.stack(ref, 1)
                e_got = torch.stack(ln["got"][0], 1)
                b = bound_ms(it, ln["lanes"] * SR_LANE
                             + it["sray"] * SR_SHADOW, sr_small,
                             layouts=launch_layouts(ln["args"][0], ln["kw"]),
                             leaves=leaf_kinds(ln["kw"]))
            if any(not torch.equal(x, y) for x, y in exact):
                raise AssertionError(f"{what}: state or flags differ from "
                                     "the plain version")
            mism = int(bits_differ((e_got, e_got), (e_ref, e_ref)).sum())
            if (ds.machinery or ln["name"] == "shadow_resolve") and mism:
                raise AssertionError(f"{what}: {mism} energies differ from "
                                     "the plain version")
            contract(e_ref, e_got, what)
            main_path.append(dict(
                name=ln["name"] + ("_inst" if ds.machinery else ""),
                layout=launch_layouts(
                    (ln["tables"] if ln["name"] == "pt_frame"
                     else ln["args"])[0], ln["kw"])[0],
                launch=k + 1, lanes=ln["lanes"], ms=ms, call_ms=c_ms,
                bound_ms=b[0], bound_by=b[1], **walk_share(ln["name"], it),
                sampled_lanes=int(e_got.shape[0]),
                max_abs_err=float((e_ref - e_got).abs().max()),
                energy_bit_mismatches=mism, iters=it))
        ptf.check_status(dev)

        # the main path: timed frames, the hook before each, counts from 0
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        traced = 0
        for _ in range(TIMED_FRAMES):
            traced = traced + frame(sync=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        expect_counts(got, phase, **{k: v * TIMED_FRAMES
                                     for k, v in want.items()})
        ms_frame = dt * 1e3 / TIMED_FRAMES
        ptf.check_status(dev)

        # the refit alone: the hook, then the snapshot (device events and
        # host time)
        refit_ms, refit_host_ms = [], []
        for _ in range(TIMED_FRAMES):
            hook(frame_no[0], r)
            frame_no[0] += 1
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            th = time.perf_counter()
            ev[0].record()
            scene.device(dev)
            ev[1].record()
            refit_host_ms.append((time.perf_counter() - th) * 1e3)
            torch.cuda.synchronize()
            refit_ms.append(ev[0].elapsed_time(ev[1]))
        if profile:
            profile_frames(r, ms_frame, phase,
                           step=lambda: hook(frame_no[0], r))
    say(label, route=which, width=w, height=h, frames=TIMED_FRAMES,
        depths=depths, ms_per_frame=ms_frame,
        kernel_share=sum(dev_ms) / ms_frame,
        mrays_per_s=int(traced) / dt / 1e6,
        traced_per_frame=int(traced) // TIMED_FRAMES,
        launches_per_frame={k: v / TIMED_FRAMES for k, v in got.items()
                            if v and k != "sorts"},
        sorts_per_frame=got["sorts"] / TIMED_FRAMES,
        refit_ms=sum(refit_ms) / len(refit_ms),
        refit_host_ms=sum(refit_host_ms) / len(refit_host_ms))
    for mp in main_path:
        say(f"{label}_{mp['launch']}_{mp['name']}", **mp)
    return main_path, got, dict(
        ms_per_frame=ms_frame, mrays_per_s=int(traced) / dt / 1e6,
        traced_per_frame=int(traced) // TIMED_FRAMES,
        refit_ms=sum(refit_ms) / len(refit_ms), renderer=r)


def compare_routes5(s5) -> dict:
    """One frame from reset on each config-5 route at the same transforms
    and seed: the two flattened routes' images and traced counts equal;
    the object-space route's image and traced counts against them (see
    explain_flattened for why they may differ).  Prints [compare5]."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    dev = torch.device("cuda")
    out = {}
    for phase, (which, env, _, _) in FRAME5_ROUTES.items():
        scene, hook = s5[which]["scene"], s5[which]["hook"]
        with environ(**env):
            r = Renderer(scene, camera=s5["cam"],
                         config=RenderConfig(width=s5["width"],
                                             height=s5["height"]),
                         settings=s5["settings"], device=dev)
            hook(100, r)
            r.render_frame()
        img = r.image_u32()
        if not (math.isfinite(r.mean_energy) and r.mean_energy > 0.0) or \
                not (img != 0xFF000000).any():
            raise AssertionError(f"{phase}: the frame is black")
        out[phase] = (img, r.stats.traced_rays, r.mean_energy)
    (a, ta, _), (b, tb, _) = out["frame5"], out["frame5_mega"]
    if not ((a == b).all() and ta == tb):
        raise AssertionError("config 5: the flattened per-depth frame "
                             "differs from the whole-frame one")
    c, tc, ec = out["frame5_inst"]
    res = dict(flattened_routes_equal=True, traced_flat=ta,
               traced_objspace=tc, traced_rel_diff=(tc - ta) / ta,
               mean_energy_flat=out["frame5"][2], mean_energy_objspace=ec,
               image_objspace_vs_flat=image_delta(c, a))
    say("compare5", **res)
    return res


def whitted5(s5) -> list:
    """Phase 17: a WHITTED frame (depth 4) of config 5's object-space
    scene through Renderer (trace_whitted), whose scene queries run
    traverse_packet_slim's instance arm: 1 closest-hit and 1 any-hit
    launch per light per depth, each timed and its sampled lanes held
    against the plain version (traverse_main_path), then one frame with
    every count from 0.  Returns (its main-path entries, the counts of
    that frame)."""
    import torch
    from cpugpupathtracing_tpu_torch.config import (RenderConfig,
                                                    RenderMode,
                                                    RenderSettings)
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    dev = torch.device("cuda")
    scene, hook = s5["obj"]["scene"], s5["obj"]["hook"]
    settings = RenderSettings(render_mode=RenderMode.WHITTED,
                              max_ray_depth=4)
    depths = settings.max_ray_depth + 1
    with environ(CPUGPU_NO_FLATTEN="1"):
        ds = scene.device(dev)
        per_depth = 1 + ds.num_lights
        r = Renderer(scene, camera=s5["cam"],
                     config=RenderConfig(width=s5["width"],
                                         height=s5["height"]),
                     settings=settings, device=dev)
        hook(200, r)
        r.render_frame()  # warm-up
        main_path = traverse_main_path(r.render_frame,
                                       "config-5 WHITTED frame", per_depth)
        reset_counts()
        r.render_frame()
        got_counts = counts()
    expect_counts(got_counts, "config-5 WHITTED frame",
                  traverse_packet_slim_inst=depths * per_depth, sorts=depths)
    energy = frame_checks(r, "the config-5 WHITTED frame", s5["height"],
                          s5["width"])
    say("whitted5", width=s5["width"], height=s5["height"], depths=depths,
        launches=got_counts["traverse_packet_slim_inst"],
        sorts=got_counts["sorts"], mean_energy=energy,
        sampled_mismatches=sum(mp["mismatches"] for mp in main_path),
        instance_hits_sampled=sum(mp["instance_hits"] for mp in main_path),
        traverse_ms=sum(mp["ms"] for mp in main_path))
    for mp in main_path:
        say(f"whitted5_d{mp['depth']}_{mp['kind']}", **mp)
    return main_path, got_counts


# ---- the XLA integrator route (count_depth) -------------------------------


def middle_lanes(cam_cfg, width, height, dev):
    """(origin, direction, pixel) of the CHECK_LANES lanes from the middle
    of the width x height frame's blocked camera order."""
    import torch
    from cpugpupathtracing_tpu_torch.models import camera as camlib

    cam = camlib.to_arrays(cam_cfg, dev)
    lo = width * height // 2 - CHECK_LANES // 2
    lane = torch.arange(lo, lo + CHECK_LANES, dtype=torch.int64, device=dev)
    return camlib.blocked_lane_rays(cam, lane, width, height,
                                    *camlib.block_shape(width, height))


def trav_plain(tps, rays, t_init, nodes, ltris, roots, active, any_hit,
               count_depth, inst_kw, layout_kw=None):
    """traverse_packet_slim's plain version on the arguments of a call
    (with count_depth the walk on the call's node layout, layout_kw:
    ents / fused_nn / width; else brute force)."""
    inst = ((nodes, roots, inst_kw["inst_inv"], inst_kw["inst_root"])
            if inst_kw else None)
    return tps.traverse_packet_slim_reference(
        rays, t_init, ltris, active=active, any_hit=any_hit,
        count_depth=count_depth, nodes=nodes, roots=roots, inst=inst,
        **(layout_kw or {}))


def flat_hit(res) -> tuple:
    """A traverse_packet_slim result as flat columns: t, id, object,
    normal x3, bvh_depth (and the instance)."""
    return (res[0], res[1], res[2]) + tuple(res[3]) + tuple(res[4:])


def check_depth(cases) -> dict:
    """Phase [check_depth]: traverse_packet_slim's count_depth arm on the
    8192 check lanes of each case (name, scene, origin, direction): the
    closest hits of the camera rays (even lanes active) and the any hits
    of shadow rays from them toward light 0 (odd lanes that hit
    active) against the walk, bitwise on every output (t, id, object,
    normal, bvh_depth, and the instance on the instance arm).  Returns
    each query's numbers."""
    import torch
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps

    out = {}
    for arm, ds, o, d in cases:
        dev, n = o.device, o.shape[0]
        ikw = ds.inst_kwargs(nrm=False)
        rays = columns(o, d)
        even = torch.arange(n, device=dev) % 2 == 0
        far = torch.full((n,), 1e34, device=dev)
        cam = tps.traverse_packet_slim(rays[:3], rays[3:], far, ds.pnodes,
                                       ds.pltris, ds.proots,
                                       count_depth=False, **ikw)
        pos = o + d * cam[0][:, None]
        to_l = ds.mk_lights[0, 0:3][None, :] - pos
        dist = torch.sqrt((to_l * to_l).sum(dim=1))
        to_l = to_l / dist[:, None]
        for query, qr, t0, act, any_hit in (
                ("closest", rays, far, even, False),
                ("any", columns(pos + to_l * 0.001, to_l),
                 dist - ds.mk_lights[0, 3] - 0.002, ~even & (cam[1] >= 0),
                 True)):
            args = (qr[:3], qr[3:], t0, ds.pnodes, ds.pltris, ds.proots)
            *got, it = tps.traverse_packet_slim(*args, active=act,
                                                any_hit=any_hit,
                                                count_iters=True, **ikw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref = trav_plain(tps, qr, t0, ds.pnodes, ds.pltris, ds.proots,
                             act, any_hit, True, ikw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t1) * 1e3
            ptf.check_status(dev)
            mism = int(bits_differ(flat_hit(got), flat_hit(ref)).sum())
            if mism:
                raise AssertionError(f"count_depth {arm} {query}: {mism} "
                                     "lanes differ from the walk")
            hit = got[1] >= 0
            if not bool((got[4][hit] >= 1).all()):
                raise AssertionError(f"count_depth {arm} {query}: a hit lane "
                                     "has bvh_depth 0")
            it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
            # the depth column (and the instance) one more i32 per lane
            extra = 4 * n * (1 + bool(ikw))
            out[f"{arm}_{query}"] = dict(
                active=int(act.sum()), hits=int(hit.sum()), mismatches=mism,
                depth_mean=float(got[4][act].float().mean()),
                depth_max=int(got[4].max()),
                max_abs_err=float((got[0] - ref[0]).abs().max()),
                **kernel_ms(lambda: tps.traverse_packet_slim(
                    *args, active=act, any_hit=any_hit, **ikw),
                    "traverse_kernel"),
                plain_ms=plain_ms, iters=it,
                bound=bound_ms(it, trav_bytes(n, it["ray"], True, True)
                               + extra, 0, shade_ops=0))
    say("check_depth", lanes=CHECK_LANES, **{
        f"{q}_{k}": v[k] for q, v in out.items()
        for k in ("active", "hits", "mismatches", "depth_mean", "depth_max",
                  "ms", "call_ms", "plain_ms")},
        **{f"{q}_bound_ms": v["bound"][0] for q, v in out.items()},
        **{f"{q}_bound_by": v["bound"][1] for q, v in out.items()})
    return out


def traverse_main_path(frame_fn, what: str, per_depth: int) -> list:
    """One frame of frame_fn() timing each traverse_packet_slim launch
    (device ms and call ms), then one counting each launch's work and
    holding every SAMPLE_STRIDE-th lane against the plain version: a
    count_depth launch against the walk bitwise on every output, another
    closest-hit launch against brute force bitwise, an any-hit launch in
    existence (at once: a frame_fn that refits the scene's tables in place
    must not run between the counted frame and its plain versions).
    Returns the main-path entries in launch order, each with its depth
    (per_depth launches per depth)."""
    import torch
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps

    dev = torch.device("cuda")
    dev_ms = launch_ms(frame_fn, "traverse_kernel")
    call_ms = wrapper_ms(tps, ("traverse_packet_slim",), frame_fn)
    launches = []

    def counted(entry):
        def call(*a, active=None, any_hit=False, count_depth=True, **k):
            *out, iters = entry(*a, active=active, any_hit=any_hit,
                                count_depth=count_depth, count_iters=True,
                                **k)
            n = a[2].shape[0]
            sel = torch.arange(0, n, SAMPLE_STRIDE, device=dev)
            slot = slot_bound(
                entry, a, dict(active=active, any_hit=any_hit,
                               count_depth=count_depth, **k),
                lambda c: trav_bytes(n, c["ray"], True, active is not None))
            launches.append(dict(
                lanes=n, iters=iters, any_hit=any_hit, slot=slot,
                count_depth=count_depth, given_active=active is not None,
                tree=a[3:6], inst={k_: v for k_, v in k.items()
                                   if k_.startswith("inst_")},
                layout={k_: v for k_, v in k.items()
                        if k_ in ("ents", "fused_nn", "width", "occl", "pay",
                                  "occl_rows")},
                rays=tuple(x[sel] for x in a[0] + a[1]), t_init=a[2][sel],
                active=None if active is None else active[sel],
                got=tuple(x[sel] for x in flat_hit(out))))
            return tuple(out)
        return call

    instrument(tps, "traverse_packet_slim", counted, frame_fn)
    if len(launches) != len(call_ms):
        raise AssertionError(f"{what}: {len(launches)} traversal launches, "
                             f"{len(call_ms)} timed")
    main_path = []
    for k, (ln, c_ms) in enumerate(zip(launches, call_ms)):
        nodes, ltris, roots = ln["tree"]
        inst = ln["inst"]
        got = ln["got"]
        ref, p_ms = timed_plain(lambda: flat_hit(trav_plain(
            tps, ln["rays"], ln["t_init"], nodes, ltris, roots, ln["active"],
            ln["any_hit"], ln["count_depth"], inst, ln["layout"])))
        if ln["any_hit"] and not ln["count_depth"]:
            mism = int(((got[1] >= 0) != (ref[1] >= 0)).sum())
        else:
            mism = int(bits_differ(got, ref).sum())
        if mism:
            raise AssertionError(f"{what} launch {k + 1}: {mism} sampled "
                                 "lanes differ from the plain version")
        it = dict(zip(ptf.COUNTERS, (int(v) for v in ln["iters"])))
        extra = 4 * ln["lanes"] * (bool(ln["count_depth"]) + bool(inst))
        b = bound_ms(it, trav_bytes(ln["lanes"], it["ray"], True,
                                    ln["given_active"]) + extra, 0,
                     shade_ops=0,
                     layouts=launch_layouts(nodes, ln["layout"]),
                     leaves=leaf_kinds(ln["layout"], tree_occl=True))
        main_path.append(dict(
            launch=k + 1, depth=k // per_depth,
            layout=launch_layouts(nodes, ln["layout"])[0],
            kind="any" if ln["any_hit"] else "closest",
            count_depth=ln["count_depth"], instance_arm=bool(inst),
            lanes=ln["lanes"], active=it["ray"], ms=None, call_ms=c_ms,
            plain_ms=p_ms, bound_ms=b[0], bound_by=b[1],
            sampled_lanes=int(got[0].shape[0]),
            max_abs_err=float((got[0] - ref[0]).abs().max())
            if not ln["any_hit"] else 0.0, mismatches=mism,
            hits=int((got[1] >= 0).sum()),
            instance_hits=int((got[-1] >= 0).sum()) if inst else 0,
            lane_share=lane_share(it), iters=it,
            bound_slot_ms=ln["slot"][1][0] if ln["slot"] else None,
            node_slot=ln["slot"][0]["node"] if ln["slot"] else None))
    ptf.check_status(dev)
    if len(dev_ms) != len(launches):
        raise AssertionError(f"{what}: {len(dev_ms)} traversal launches "
                             f"timed, {len(launches)} counted")
    for mp, ms_k in zip(main_path, dev_ms):
        mp["ms"] = ms_k
    return main_path


def frame_checks(r, what: str, height: int, width: int) -> float:
    """Raise unless r's image is a lit frame of the right shape with a
    finite, non-zero mean energy; returns the mean energy."""
    img = r.image_u32()
    energy = r.mean_energy
    if not (math.isfinite(energy) and energy > 0.0):
        raise AssertionError(f"{what}: mean energy {energy}")
    if img.shape != (height, width) or not (img != 0xFF000000).any():
        raise AssertionError(f"{what}: the frame is black")
    return energy


def frame_xla(scene, cam_cfg, settings, width, height, profile: bool):
    """Phase [frame_xla]: config 3 at 1920x1080 through Renderer on the
    XLA integrator, with AOVs off (CPUGPU_NO_MEGAKERNEL=1) and with
    track_aovs=True: per frame one closest-hit launch per depth (the
    count_depth arm with AOVs), one any-hit launch of its shadow rays and
    a morton5 sort, no other kernel.  Each run's frame from reset against
    the whole-frame route's at the same seed: traced exact, energy under
    the megakernel contract.  The AOV run holds every SAMPLE_STRIDE-th
    lane of each launch against its plain version; TIMED_FRAMES timed
    frames each.  Returns (main-path entries of the AOV run, its counts,
    the numbers of each run)."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    dev = torch.device("cuda")
    config = RenderConfig(width=width, height=height)
    depths = settings.max_ray_depth + 1
    ref = Renderer(scene, camera=cam_cfg, config=config, settings=settings,
                   device=dev)
    reset_counts()
    ref.render_frame()
    expect_counts(counts(), "whole-frame reference frame", pt_frame=2,
                  sorts=1)
    runs, main_path, aov_counts = {}, [], None
    for run, env, st, want in (
            ("aovs_off", dict(CPUGPU_NO_MEGAKERNEL="1"), settings,
             dict(traverse_packet_slim=2 * depths, sorts=depths)),
            ("aovs_on", {}, settings.replace(track_aovs=True),
             dict(traverse_packet_slim_depth=depths,
                  traverse_packet_slim=depths, sorts=depths))):
        with environ(**env):
            r = Renderer(scene, camera=cam_cfg, config=config, settings=st,
                         device=dev)
            reset_counts()
            r.render_frame()
            expect_counts(counts(), f"XLA route ({run}), first frame",
                          **want)
            flips, dmax, dmean = contract(ref._accumulator[:, :3],
                                          r._accumulator[:, :3],
                                          f"XLA route ({run}) vs whole-frame")
            bitwise = bool(torch.equal(ref._accumulator, r._accumulator))
            if r.stats.traced_rays != ref.stats.traced_rays:
                raise AssertionError(
                    f"XLA route ({run}) traced {r.stats.traced_rays}, the "
                    f"whole-frame route {ref.stats.traced_rays}")
            energy = frame_checks(r, f"XLA route ({run})", height, width)
            if run == "aovs_on":
                main_path = traverse_main_path(r.render_frame,
                                               "XLA route with AOVs", 2)
            ms, traced, rate, got = timed_frames(
                r, f"XLA route ({run}) frames", profile, f"xla-{run}",
                **want)
        runs[run] = dict(ms_per_frame=ms, mrays_per_s=rate / 1e6,
                         traced_per_frame=traced,
                         launches_per_frame={k: v / TIMED_FRAMES
                                             for k, v in got.items()
                                             if v and k != "sorts"},
                         sorts_per_frame=got["sorts"] / TIMED_FRAMES,
                         mean_energy=energy,
                         bitwise_whole_frame=bitwise,
                         flip_share=flips, max_abs_err=dmax, mean_err=dmean)
        if run == "aovs_on":
            aov_counts = got
    for run, v in runs.items():
        say("frame_xla", run=run, width=width, height=height,
            frames=TIMED_FRAMES, traced_equal_whole_frame=True, **v)
    for mp in main_path:
        say(f"xla_l{mp['launch']}_{mp['kind']}", **mp)
    return main_path, aov_counts, runs


def frame_views(scene, cam_cfg, settings, width, height, profile: bool):
    """Phase [frame_views]: config 3 at 1920x1080 in the RAY_DEPTH and
    BVH_DEPTH views through Renderer, after one plain frame: a view frame
    leaves the accumulator bitwise unchanged; RAY_DEPTH launches per
    depth the count_depth arm, the shadow any-hit and a sort, BVH_DEPTH
    one count_depth launch.  On the whole frame's rays (trace_sample):
    ray_depth in [0, max depth + 1], bvh_depth >= 1 on every lane whose
    primary ray hits a mesh, and equal to the AOV run's bvh_depth.
    TIMED_FRAMES timed frames per view.  Returns each view's numbers."""
    import torch
    from cpugpupathtracing_tpu_torch.config import (DebugRenderMode,
                                                    RenderConfig)
    from cpugpupathtracing_tpu_torch.models import camera as camlib
    from cpugpupathtracing_tpu_torch.models import renderer as rendlib
    from cpugpupathtracing_tpu_torch.models import scene as scenelib
    from cpugpupathtracing_tpu_torch.utils import rng as rnglib

    dev = torch.device("cuda")
    depths = settings.max_ray_depth + 1
    config = RenderConfig(width=width, height=height)
    r = rendlib.Renderer(scene, camera=cam_cfg, config=config,
                         settings=settings, device=dev)
    r.render_frame()
    out = {}
    for view, want in (
            (DebugRenderMode.RAY_DEPTH,
             dict(traverse_packet_slim_depth=depths,
                  traverse_packet_slim=depths, sorts=depths)),
            (DebugRenderMode.BVH_DEPTH,
             dict(traverse_packet_slim_depth=1))):
        acc = r._accumulator.clone()
        r.set_debug_mode(view)
        reset_counts()
        r.render_frame()
        expect_counts(counts(), f"{view.name} view frame", **want)
        if not torch.equal(acc, r._accumulator):
            raise AssertionError(f"the {view.name} view changed the "
                                 "accumulator")
        ms, traced, rate, _ = timed_frames(r, f"{view.name} frames", profile,
                                           f"view-{view.name}", **want)
        out[view.name] = dict(ms_per_frame=ms, mrays_per_s=rate / 1e6,
                              traced_per_frame=traced,
                              accumulator_unchanged=True)
    r.set_debug_mode(DebugRenderMode.NONE)

    # per-lane AOV bounds on the whole frame's rays
    ds = scene.device(dev)
    n = width * height
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    cam = camlib.to_arrays(cam_cfg, dev)
    o, d, pix = camlib.blocked_lane_rays(cam, lane, width, height,
                                         *camlib.block_shape(width, height))
    st = rnglib.seed_lanes(pix, 0, salt=config.seed)
    res = {}
    for name, s in (
            ("ray_depth", settings.replace(
                debug_render_mode=DebugRenderMode.RAY_DEPTH)),
            ("bvh_depth", settings.replace(
                debug_render_mode=DebugRenderMode.BVH_DEPTH)),
            ("aovs", settings.replace(track_aovs=True))):
        res[name] = rendlib.trace_sample(ds, s, o, d, st, lane)[1]
    h = scenelib.intersect_scene(ds, o, d, torch.full((n,), 1e34,
                                                      device=dev),
                                 count_depth=False)
    mesh = (h.obj >= 0) & (h.kind == scenelib.PRIM_MESH)
    rd = res["ray_depth"].ray_depth
    bd = res["bvh_depth"].bvh_depth
    checks = dict(
        ray_depth_in_range=bool(((rd >= 0) & (rd <= depths)).all()),
        bvh_depth_hit_lanes_ge1=bool((bd[mesh] >= 1).all()),
        bvh_depth_nonnegative=bool((bd >= 0).all()),
        bvh_depth_equal_aov_run=bool(torch.equal(bd, res["aovs"].bvh_depth)),
        ray_depth_equal_aov_run=bool(torch.equal(rd, res["aovs"].ray_depth)))
    if not all(checks.values()):
        raise AssertionError(f"AOV bounds broken: {checks}")
    for view, v in out.items():
        say("frame_views", view=view, width=width, height=height,
            frames=TIMED_FRAMES, **v)
    say("frame_views", lanes=n, mesh_hit_lanes=int(mesh.sum()),
        ray_depth_histogram=torch.bincount(rd.long(),
                                           minlength=depths + 1).tolist(),
        bvh_depth_mean_hit=float(bd[mesh].float().mean()),
        bvh_depth_max=int(bd.max()), **checks)
    return out


def frame5_aov(s5, profile: bool):
    """Phase [frame5_aov]: config 5's object-space scene at 1280x720 on the
    XLA integrator with track_aovs=True, the hook (new transforms, a
    refit) before every frame: per frame the instance arm's count_depth
    launch and the instance arm's shadow any-hit per depth and a sort;
    one frame holding every SAMPLE_STRIDE-th lane of each launch against
    its plain version (the instance walk for count_depth); TIMED_FRAMES
    timed frames.  Returns (main-path entries, counts, numbers)."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    dev = torch.device("cuda")
    scene, hook = s5["obj"]["scene"], s5["obj"]["hook"]
    settings = s5["settings"].replace(track_aovs=True)
    w, h = s5["width"], s5["height"]
    depths = settings.max_ray_depth + 1
    want = dict(traverse_packet_slim_inst_depth=depths,
                traverse_packet_slim_inst=depths, sorts=depths)
    with environ(CPUGPU_NO_FLATTEN="1"):
        r = Renderer(scene, camera=s5["cam"],
                     config=RenderConfig(width=w, height=h),
                     settings=settings, device=dev)
        frame_no = [300]

        def frame(sync=True):
            hook(frame_no[0], r)
            frame_no[0] += 1
            return r.render_frame(sync=sync)

        reset_counts()
        frame()
        expect_counts(counts(), "config-5 AOV frame", **want)
        main_path = traverse_main_path(frame, "config-5 AOV frame", 2)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        traced = 0
        for _ in range(TIMED_FRAMES):
            traced = traced + frame(sync=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        expect_counts(got, "config-5 AOV frames",
                      **{k: v * TIMED_FRAMES for k, v in want.items()})
        ms = dt * 1e3 / TIMED_FRAMES
        if profile:
            profile_frames(r, ms, "xla-config5-aovs", step=lambda: hook(
                frame_no[0], r))
        r.render_frame()
        energy = frame_checks(r, "config-5 AOV frame", h, w)
    num = dict(ms_per_frame=ms, mrays_per_s=int(traced) / dt / 1e6,
               traced_per_frame=int(traced) // TIMED_FRAMES,
               launches_per_frame={k: v / TIMED_FRAMES for k, v in got.items()
                                   if v and k != "sorts"},
               sorts_per_frame=got["sorts"] / TIMED_FRAMES,
               mean_energy=energy)
    say("frame5_aov", width=w, height=h, frames=TIMED_FRAMES, **num)
    for mp in main_path:
        say(f"frame5_aov_l{mp['launch']}_{mp['kind']}", **mp)
    return main_path, got, num


def meshlight_scene():
    """The CPU tests' mesh-light scene (tests/test_torch_xla.py): the
    golden scene of tests/test_golden.py with its sphere light replaced
    by an emissive icosphere of 80 triangles in its place, a mesh light
    over the 64-row light table."""
    from cpugpupathtracing_tpu_torch.models import materials as matlib
    from cpugpupathtracing_tpu_torch.models import mesh as meshlib
    from cpugpupathtracing_tpu_torch.models.scene import Scene

    s = Scene()
    white = s.add_material(matlib.Material.diffuse((0.9, 0.9, 0.9)))
    blue = s.add_material(matlib.Material.diffuse((0.2, 0.2, 0.8)))
    light = s.add_material(matlib.Material.light((1.0, 0.95, 0.8), 10.0))
    glass = s.add_material(matlib.Material.dielectric(
        (1.0, 1.0, 1.0), 0.0, 1.0, (0.2, 0.8, 0.8), 1.517))
    s.add_mesh("ico", meshlib.icosphere(radius=1.5, subdivisions=2), glass)
    s.add_mesh("cube", meshlib.cube(center=(2.8, -0.5, -1.0), half=0.9), blue)
    s.add_plane("floor", (0.0, -2.0, 0.0), (0.0, 1.0, 0.0), white)
    s.mark_light(s.add_mesh("light", meshlib.icosphere(
        center=(8.0, 9.0, 7.0), radius=4.0, subdivisions=1), light))
    return s


def frame_xla_scene(phase, scene, cam_cfg, settings, width, height, want,
                    profile: bool) -> dict:
    """Phases [frame_meshlight] and [frame_meshless]: a scene no kernel
    route takes, through Renderer: the XLA integrator runs every frame
    (counted) with the launches and sorts of `want`; the frame is lit;
    TIMED_FRAMES timed frames.  Returns the numbers."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models import integrators
    from cpugpupathtracing_tpu_torch.models import scene as scenelib
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    dev = torch.device("cuda")
    ds = scene.device(dev)
    reason = scenelib.megakernel_gate_reason(ds, settings)
    if reason is None:
        raise AssertionError(f"{phase}: a kernel route takes the scene")
    r = Renderer(scene, camera=cam_cfg,
                 config=RenderConfig(width=width, height=height),
                 settings=settings, device=dev)
    calls = []
    entry = integrators.trace_advanced

    def spy(*a, **k):
        calls.append(1)
        return entry(*a, **k)

    integrators.trace_advanced = spy
    try:
        r.render_frame()  # warm-up
        ms, traced, rate, got = timed_frames(r, f"{phase} frames", profile,
                                             phase, **want)
    finally:
        integrators.trace_advanced = entry
    # the warm-up, the timed frames and --profile's two frames
    if len(calls) != 1 + TIMED_FRAMES + 2 * profile:
        raise AssertionError(f"{phase}: trace_advanced ran {len(calls)} "
                             "times")
    energy = frame_checks(r, phase, height, width)
    num = dict(ms_per_frame=ms, mrays_per_s=rate / 1e6,
               traced_per_frame=traced,
               launches_per_frame={k: v / TIMED_FRAMES
                                   for k, v in got.items()
                                   if v and k != "sorts"},
               sorts_per_frame=got["sorts"] / TIMED_FRAMES,
               mean_energy=energy)
    say(phase, width=width, height=height, frames=TIMED_FRAMES,
        gate_reason=f"'{reason}'", **num)
    return num


def check_refill(ds, settings, rays, st, kw, single) -> dict:
    """Phase 4's launch of more lanes than the card keeps resident (its
    persistent threads refill finished paths): the check lanes repeated to
    at least twice the resident threads, as one span and as the split
    schedule's two spans with the carry (integrators.ptframe_split); every
    copy of every output bitwise the single 8192-lane launch's (`single`:
    its energy, state, traced), which is held against the plain version."""
    import torch
    from cpugpupathtracing_tpu_torch.models import integrators
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    depths = settings.max_ray_depth + 1
    split = integrators.ptframe_split(settings)
    resident = ptf.resident_threads(*ds.tables(), rays, st, **kw)
    resident_count = ptf.resident_threads(*ds.tables(), rays, st,
                                          count_iters=True, **kw)
    reps = -(-2 * resident // CHECK_LANES)
    big = tuple(r.repeat(reps) for r in rays)
    st_big = st.repeat(reps)

    def same(a, b):
        a = torch.stack(a, 1) if isinstance(a, tuple) else a
        b = torch.stack(b, 1) if isinstance(b, tuple) else b
        b = b.repeat((reps,) + (1,) * (b.dim() - 1))
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return bool(torch.equal(a, b))

    e_b, s_b, tr_b = ptf.pt_frame(*ds.tables(), big, st_big, depths=depths,
                                  **kw)
    e_k, s_k, tr_k = single
    one_span = (same(e_b, e_k) and same(s_b, s_k)
                and int(tr_b) == reps * int(tr_k))
    c1 = ptf.pt_frame(*ds.tables(), big, st_big, depths=split,
                      carry_out=True, **kw)
    c1s = ptf.pt_frame(*ds.tables(), rays, st, depths=split, carry_out=True,
                       **kw)
    carry = (all(same(a, b) for a, b in zip(c1[:5], c1s[:5]))
             and int(c1[5]) == reps * int(c1s[5]))
    c2 = ptf.pt_frame(*ds.tables(), c1[0], c1[1], depths=depths - split,
                      depth_base=split, carry_in=(c1[2], c1[3], c1[4]), **kw)
    c2s = ptf.pt_frame(*ds.tables(), c1s[0], c1s[1], depths=depths - split,
                       depth_base=split, carry_in=(c1s[2], c1s[3], c1s[4]),
                       **kw)
    span2 = (same(c2[0], c2s[0]) and same(c2[1], c2s[1])
             and int(c2[2]) == reps * int(c2s[2]))
    ptf.check_status(ds.pnodes.device)
    res = dict(lanes=big[0].shape[0], resident=resident,
               resident_count_arm=resident_count, copies=reps,
               one_span_bitwise=one_span, span1_carry_bitwise=carry,
               span2_bitwise=span2, single_span_traced=int(tr_b))
    if not (one_span and carry and span2 and big[0].shape[0] > resident):
        raise AssertionError(f"refilled launch differs: {res}")
    return res


def c2_lanes(phase: str, ds, cam_cfg, width, height) -> dict:
    """The camera lanes of a frame whose closest hit the conservative slab
    margin changed (ROADMAP C2): B4's kernel (pt_device.cuh slab_hit)
    against the plain walk with slab_pad = 1, the slab test before the
    margin, on every camera ray; how many of those gained a hit, lost
    one, or moved."""
    import torch
    from cpugpupathtracing_tpu_torch.models import camera as camlib
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps

    dev = ds.pnodes.device
    cam = camlib.to_arrays(cam_cfg, dev)
    lane = torch.arange(width * height, dtype=torch.int64, device=dev)
    o, d = camlib.lane_rays(cam, lane, width, height)
    rays = columns(o, d)
    kern = ptf.closest_hit(ds.pnodes, ds.pltris, ds.proots, rays)
    old = tps.traverse_walk_reference(
        rays, torch.full_like(rays[0], ptf.RAY_TMAX), ds.pnodes, ds.pltris,
        ds.proots, slab_pad=1.0)
    moved = (kern[0].view(torch.int32) != old[0].view(torch.int32)) | (
        kern[1] != old[1])
    res = dict(lanes=width * height, changed=int(moved.sum()),
               gained_hit=int((moved & (old[1] < 0)).sum()),
               lost_hit=int((moved & (kern[1] < 0)).sum()),
               hits=int((kern[1] >= 0).sum()))
    say(phase, **res)
    return res


def frame_whole(scene, cam_cfg, settings, width, height, small_bytes,
                profile: bool, phase: str = "frame", spp: int = 1):
    """Phase 6: config 3 through Renderer on the whole-frame route: one
    warm-up frame; one frame timing each kernel launch; one frame
    counting each launch's work and holding every SAMPLE_STRIDE-th lane
    of both launches (their real inputs: 2 depths with the carry out,
    then 4 sorted depths with the carry in) against the plain version
    (timed: plain_ms); then timed frames through Renderer.  The pt_frame
    arm is ARM's.  At spp > 1 samples a frame (config 4) every sample's
    two launches, as the Renderer's 1-spp sub-steps make them.  Returns
    (main-path entries, counts, a dict of the frame time, rate and the
    renderer); prints the [<phase>] line and one [<phase>_launch<k>]
    line per launch ([launch<k>] for phase 6)."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    dev = torch.device("cuda")
    r = Renderer(scene, camera=cam_cfg,
                 config=RenderConfig(width=width, height=height,
                                     samples_per_frame=spp),
                 settings=settings, device=dev)
    r.render_frame()  # warm-up
    entry = ptf.pt_frame
    spans_per_frame = 2 * spp

    # one frame timing each launch on the device, one with CUDA events
    # around each wrapper call
    span_ms = launch_ms(r.render_frame, "pt_frame_kernel",
                        expect=spans_per_frame)
    span_call_ms = wrapper_ms(ptf, ("pt_frame",), r.render_frame)

    # one frame counting each launch's work and keeping every
    # SAMPLE_STRIDE-th lane's inputs and energy for the plain version
    spans = []

    def counted(*a, **k):
        *out, iters = entry(*a, count_iters=True, **k)
        rays_, state_ = a[-2], a[-1]
        sel = torch.arange(0, state_.shape[0], SAMPLE_STRIDE, device=dev)
        ci = k.get("carry_in")
        energy_ = torch.stack(out[3], 1) if k.get("carry_out") else out[0]
        spans.append(dict(
            lanes=state_.shape[0], iters=iters, tables=a[:-2],
            rays=tuple(x[sel] for x in rays_), state=state_[sel],
            carry_in=None if ci is None else (
                tuple(x[sel] for x in ci[0]), tuple(x[sel] for x in ci[1]),
                ci[2][sel]),
            energy=energy_[sel], kw=k))
        return tuple(out)

    instrument(ptf, "pt_frame", lambda _: counted, r.render_frame)
    if not (len(spans) == len(span_ms) == len(span_call_ms)
            == spans_per_frame):
        raise AssertionError(f"{len(spans)} launches in a frame, expected "
                             f"{spans_per_frame}")
    main_path = []
    for sp, ms, c_ms in zip(spans, span_ms, span_call_ms):
        k = dict(sp["kw"], carry_in=sp["carry_in"])
        res, p_ms = timed_plain(lambda: plain(ptf, sp["tables"], sp["rays"],
                                              sp["state"], **k))
        e_ref = torch.stack(res[3], 1) if k.get("carry_out") else res[0]
        what = f"{phase} launch {len(main_path) + 1}, sampled lanes"
        s_flips, s_max, s_mean = contract(e_ref, sp["energy"], what)
        it = dict(zip(ptf.COUNTERS, (int(v) for v in sp["iters"])))
        layouts = launch_layouts(sp["tables"][0], k)
        sb_ms, sb_by = bound_ms(
            it, sp["lanes"] * lane_bytes(sp["carry_in"] is not None,
                                         bool(k.get("carry_out"))),
            small_bytes, layouts=layouts, leaves=leaf_kinds(k))
        main_path.append(dict(
            lanes=sp["lanes"], depths=k["depths"],
            depth_base=k.get("depth_base", 0), layouts=layouts, ms=ms,
            call_ms=c_ms, plain_ms=p_ms, bound_ms=sb_ms,
            bound_by=sb_by, lane_share=it["ltrip"] / (32 * it["wtrip"]),
            sampled_lanes=sp["state"].shape[0],
            max_abs_err=s_max, flip_share=s_flips, mean_err=s_mean,
            energy_bit_mismatches=int((sp["energy"].view(torch.int32)
                                       != e_ref.view(torch.int32))
                                      .any(dim=1).sum()),
            iters=it))
    ptf.check_status(dev)

    # the main path: timed frames, every count from 0
    frame_ms, traced, rate, frame_counts = timed_frames(
        r, f"{phase} frames", False, "whole-frame", pt_frame=spans_per_frame,
        sorts=spp)
    ptf.check_status(dev)
    r.total_energy_received = 0.0
    r.num_accumulated = 0
    r.render_frame()
    energy = frame_checks(r, phase, height, width)
    say(phase, width=width, height=height, spp=spp, frames=TIMED_FRAMES,
        ms_per_frame=frame_ms, kernel_share=sum(span_ms) / frame_ms,
        mrays_per_s=rate / 1e6, traced_per_frame=traced,
        launches_per_frame=frame_counts[arm("pt_frame")] / TIMED_FRAMES,
        arm=arm("pt_frame"), mean_energy=energy)
    for k, mp in enumerate(main_path, 1):
        say(f"launch{k}" if phase == "frame" else f"{phase}_launch{k}",
            **mp)
    if profile:
        profile_frames(r, frame_ms, "whole-frame")
    return main_path, frame_counts, dict(ms_per_frame=frame_ms,
                                         mrays_per_s=rate / 1e6, renderer=r)


# The node-table layouts the layout phases run (ops/pt_frame.py LAYOUTS):
# (name, the environment that selects it).  An unset variable takes the
# JAX benchmark's value, so "48" is the port's default.
LAYOUT_RUNS = (
    ("48", {}),
    ("ents", {"CPUGPU_SMEMTREE": "1"}),
    ("64", {"CPUGPU_SMEMTREE": "0"}),
    ("w16", {"CPUGPU_PACKET_TREE": "w16"}),
    ("fused", {"CPUGPU_FUSED": "1"}),
    ("fused_w16", {"CPUGPU_FUSED": "1", "CPUGPU_PACKET_TREE": "w16"}),
)
# without the any-hit tables (CPUGPU_OCCL=0) shadow rays walk the shading
# tables: shadow_resolve's arms over 16-wide and fused rows
SHARED_RUNS = (
    ("w16_shared", {"CPUGPU_PACKET_TREE": "w16", "CPUGPU_OCCL": "0"}),
    ("fused_shared", {"CPUGPU_FUSED": "1", "CPUGPU_OCCL": "0"}),
    ("fused_w16_shared", {"CPUGPU_FUSED": "1", "CPUGPU_PACKET_TREE": "w16",
                          "CPUGPU_OCCL": "0"}),
)
# config 5 (flattened: instances build the side tables, not 48-col rows)
LAYOUT5_RUNS = (
    ("ents", {}),
    ("w16", {"CPUGPU_PACKET_TREE": "w16"}),
    ("fused", {"CPUGPU_FUSED": "1"}),
    ("fused_w16", {"CPUGPU_FUSED": "1", "CPUGPU_PACKET_TREE": "w16"}),
)


@contextlib.contextmanager
def fused_whole_frame():
    """Lift, for the block, the whole-frame gate's refusal of fused tables
    (the JAX gate's rule: a fused scene takes the per-depth route), so
    that the layout phases run pt_frame's fused arms on the whole-frame
    route too; every other reason of the gate stands."""
    from cpugpupathtracing_tpu_torch.models import renderer
    from cpugpupathtracing_tpu_torch.models import scene as scenelib

    orig = renderer.pt_frame_active

    def active(dev, settings):
        return orig(dev, settings) or (
            dev.pfused is not None and scenelib.pt_frame_gate_reason(
                dev, settings) == "fused packet tables")

    renderer.pt_frame_active = active
    try:
        yield
    finally:
        renderer.pt_frame_active = orig


def check_variant(ds, settings, o, d, st, small_bytes, name: str, ref64,
                  whole: bool = True, b4: bool = True,
                  occl_b4: bool = False) -> dict:
    """Phase [check_<name>]: each arm the snapshot's tables select, on the
    8192 check lanes, against its plain version bitwise on every output:
    pt_frame on the whole-frame route's tables (all depths; with `whole`,
    the routes the gate allows), also against the plain 64-col arm's run
    `ref64`; shade_extend at depth 0 on the per-depth route's tables (with
    the leaf-14 payload also against the shading tables' arm) and
    shadow_resolve on its shadow rays; with `b4` traverse_packet_slim
    over the shading tree, or with occl_b4 over the any-hit tree
    (b4_tables) --
    the closest hits of the camera rays (leaf-14 with the payload, also
    against the shading records' hits) and the any hits toward light 0 of
    the lanes that hit, each without count_depth against brute force (any
    hits: existence) and with it against the walk.  Returns each arm's
    numbers by kernel (traverse_<closest|any>[_depth]), each with its
    launch key (ptf.launch_key) and the columns that differ (0)."""
    import torch
    from cpugpupathtracing_tpu_torch.models import integrators
    from cpugpupathtracing_tpu_torch.models import scene as scenelib
    from cpugpupathtracing_tpu_torch.ops import megakernel as mk
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps

    dev, n = st.device, st.shape[0]
    rays = columns(o, d)
    depths = settings.max_ray_depth + 1
    out, bad = {}, {}

    def numbers(kernel, fn, it, lay, leaves, lanes, small, p_ms, err,
                shade_ops=OPS_SHADE, **extra):
        """An arm's entry: its work counts, bound, kernel times and the
        plain version's; `lanes` maps the counts to the lane bytes."""
        it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
        return dict(extra, layouts=lay, max_abs_err=err, plain_ms=p_ms,
                    iters=it, bound=bound_ms(it, lanes(it), small,
                                             shade_ops=shade_ops,
                                             layouts=lay, leaves=leaves),
                    **kernel_ms(fn, kernel))

    def err(a, b):
        return float((torch.stack(tuple(a), 1)
                      - torch.stack(tuple(b), 1)).abs().max())

    # B1: pt_frame
    if whole:
        tables, kw = integrators.frame_args(ds, settings)
        *fk, it = ptf.pt_frame(*tables, rays, st, depths=depths,
                               count_iters=True, **kw)
        fp, p_ms = timed_plain(lambda: plain(ptf, tables, rays, st,
                                             depths=depths, **kw))
        ptf.check_status(dev)
        bad["pt_frame"] = cols_differ(fk, fp)
        bad["pt_frame_vs_64"] = cols_differ(fk, ref64)
        out["pt_frame"] = numbers(
            "pt_frame_kernel", lambda: ptf.pt_frame(
                *tables, rays, st, depths=depths, **kw), it,
            launch_layouts(tables[0], kw), leaf_kinds(kw),
            lambda _: n * lane_bytes(False, False), small_bytes, p_ms,
            float((fk[0] - fp[0]).abs().max()), mismatches=bad["pt_frame"])

    # B2, B3: shade_extend at depth 0, shadow_resolve on its shadow rays
    tables, tkw = integrators.route_tables(ds)
    ekw = dict(integrators.extend_kwargs(ds, settings), **tkw)
    one = torch.ones(n, device=dev)
    zero = torch.zeros(n, device=dev)
    a = (*tables, 0, rays, st, (one, one, one), (zero, zero, zero),
         torch.ones(n, dtype=torch.int32, device=dev))
    *se, it = mk.shade_extend(*a, count_iters=True, **ekw)
    sp, p_ms = timed_plain(lambda: shade_plain(mk, a, ekw))
    bad["shade_extend"] = cols_differ(se, sp)
    if tkw.get("pay") is not None:
        pn, pl, pf, pe = scenelib.packet_tables(ds)
        shading = mk.shade_extend(
            pn, pl, *a[2:], **dict(integrators.extend_kwargs(ds, settings),
                                   fused_nn=pf, width=ds.packet_width,
                                   ents=pe))
        bad["shade_extend_vs_shading"] = cols_differ(se, shading)
    out["shade_extend"] = numbers(
        "shade_extend_kernel", lambda: mk.shade_extend(*a, **ekw), it,
        launch_layouts(tables[0], ekw), leaf_kinds(ekw),
        lambda _: n * SE_LANE, small_bytes, p_ms, err(se[3], sp[3]),
        mismatches=bad["shade_extend"])
    sn, sl, skw = integrators.shadow_tables(ds)
    sa = (sn, sl, ds.mk_sph, ds.mk_pln, se[5], se[6], se[7], se[4], se[3],
          se[8])
    *sr, it = mk.shadow_resolve(*sa, count_iters=True, **skw)
    rp, p_ms = timed_plain(lambda: resolve_plain(mk, sa, skw))
    ptf.check_status(dev)
    bad["shadow_resolve"] = cols_differ(sr, rp)
    out["shadow_resolve"] = numbers(
        "shadow_resolve_kernel", lambda: mk.shadow_resolve(*sa, **skw), it,
        launch_layouts(sn, skw), leaf_kinds(skw),
        lambda c: n * SR_LANE + c["sray"] * SR_SHADOW,
        4 * (ds.mk_sph.numel() + ds.mk_pln.numel()), p_ms, err(sr, rp),
        mismatches=bad["shadow_resolve"])

    # B4: closest and any hits, with and without count_depth
    if b4:
        nodes, ltris, roots, ckw, akw = b4_tables(ds, occl_b4)
        far = torch.full((n,), 1e34, device=dev)
        cam = tps.traverse_packet_slim(rays[:3], rays[3:], far, nodes, ltris,
                                       roots, count_depth=False, **ckw)
        if ckw.get("pay") is not None:
            shade = ptf.closest_hit_reference(ds.pltris, rays)
            bad["traverse_pay_vs_shading"] = int(bits_differ(
                flat_hit(cam)[:6], shade).sum())
        qs = shadow_query(ds, o, d, cam[0], cam[1] >= 0)
        for query, qr, t0, act, kw, any_hit in (
                ("closest", rays, far, None, ckw, False),
                ("any", qs[0], qs[1], qs[2], akw, True)):
            pkw = {k: v for k, v in kw.items() if k != "ents"}
            for depth in (False, True):
                args = (qr[:3], qr[3:], t0, nodes, ltris, roots)
                *got, it = tps.traverse_packet_slim(
                    *args, active=act, any_hit=any_hit, count_depth=depth,
                    count_iters=True, **kw)
                ref, p_ms = timed_plain(
                    lambda: tps.traverse_packet_slim_reference(
                        qr, t0, ltris, active=act, any_hit=any_hit,
                        count_depth=depth, nodes=nodes, roots=roots,
                        ents=kw["ents"], **pkw))
                ptf.check_status(dev)
                if any_hit and not depth:
                    mism = int(((got[1] >= 0) != (ref[1] >= 0)).sum())
                else:
                    mism = int(bits_differ(flat_hit(got), flat_hit(ref)).sum())
                arm_name = f"traverse_{query}{'_depth' * depth}"
                bad[arm_name] = mism
                fin = torch.isfinite(ref[0]) & (ref[1] >= 0)
                out[arm_name] = numbers(
                    "traverse_kernel", lambda: tps.traverse_packet_slim(
                        *args, active=act, any_hit=any_hit, count_depth=depth,
                        **kw), it, launch_layouts(nodes, kw),
                    leaf_kinds(kw, tree_occl=True),
                    lambda c: trav_bytes(n, c["ray"], True, act is not None)
                    + 4 * n * depth, 0, p_ms,
                    0.0 if any_hit or not fin.any() else float(
                        (got[0] - ref[0])[fin].abs().max()), shade_ops=0,
                    key=b4_key(nodes, kw, depth), active=int(it[4]),
                    hits=int((got[1] >= 0).sum()), mismatches=mism,
                    depth_max=int(got[4].max()))
    if any(bad.values()):
        raise AssertionError(f"check {name}: outputs differing from the "
                             f"plain versions bitwise {bad}")
    say(f"check_{name}", lanes=n, **{
        f"{k}_{f}": v[f] for k, v in out.items()
        for f in ("layouts", "ms", "call_ms", "plain_ms", "max_abs_err")},
        **{f"{k}_bound_ms": v["bound"][0] for k, v in out.items()},
        **{f"{k}_key": v["key"] for k, v in out.items() if "key" in v},
        mismatches=bad)
    return out


def b4_frames(scene, cam_cfg, settings, whitted_settings, width, height,
              name: str) -> dict:
    """Phase [b4_<layout>]: the traversal's main paths on config 3 under
    the current flags: one XLA-route frame with AOVs (per depth one
    count_depth closest-hit launch, one any-hit launch and a sort) and one
    WHITTED frame (per depth one closest-hit launch and one any-hit launch
    per light, a sort), each launch timed and every SAMPLE_STRIDE-th lane
    against its plain version (traverse_main_path).  Returns the counts
    and main-path entries of both."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    dev = torch.device("cuda")
    config = RenderConfig(width=width, height=height)
    out = {}
    depths = settings.max_ray_depth + 1
    wdepths = whitted_settings.max_ray_depth + 1
    per_light = 1 + scene.device(dev).num_lights
    for run, st, want, per in (
            ("xla", settings.replace(track_aovs=True),
             dict(traverse_packet_slim_depth=depths,
                  traverse_packet_slim=depths, sorts=depths), 2),
            ("whitted", whitted_settings,
             dict(traverse_packet_slim=wdepths * per_light, sorts=wdepths),
             per_light)):
        r = Renderer(scene, camera=cam_cfg, config=config, settings=st,
                     device=dev)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_frame()
        ms = (time.perf_counter() - t0) * 1e3
        got = counts()
        expect_counts(got, f"{run} frame ({name})", **want)
        path = traverse_main_path(r.render_frame, f"{run} frame ({name})",
                                  per)
        frame_checks(r, f"{run} frame ({name})", height, width)
        out[run] = dict(counts=got, path=path, first_frame_ms=ms)
        say(f"b4_{name}", run=run, launches=sum(
            v for k, v in got.items() if k != "sorts"),
            first_frame_ms=ms, kernel_ms=sum(mp["ms"] for mp in path),
            sampled_mismatches=sum(mp["mismatches"] for mp in path),
            arms=sorted(k for k, v in got.items() if v and k != "sorts"),
            **{f"launch_{k}": [mp[k] for mp in path] for k in (
                "kind", "active", "ms", "bound_ms", "lane_share",
                "bound_slot_ms")})
    return out


def bitwise_path(path, what: str) -> None:
    """Raise unless every sampled main-path lane of `path` equals its
    plain version bit for bit (the layout phases' rule)."""
    bad = [mp for mp in path if mp.get("energy_bit_mismatches", 0)
           or mp.get("mismatches", 0)]
    if bad:
        raise AssertionError(f"{what}: sampled lanes differ from the plain "
                             f"version bitwise in {len(bad)} launches")


def layouts3(scene, cam_cfg, settings, whitted_settings, width, height, o,
             d, st, ref64) -> dict:
    """Phase [layout3]: config 3 at 1920x1080 under every node-table
    layout (LAYOUT_RUNS: the default 48-col rows and side tables, the
    64-col rows with side tables, the plain rows, 16-wide rows, the fused
    table, fused 16-wide rows), each built from the checkout (seconds):
    its arms on the check lanes (check_variant), the whole-frame route
    (frame_whole; fused tables through fused_whole_frame) and the
    per-depth route (frame_mega) with every launch timed, bounded and
    sampled against the plain version, TIMED_FRAMES timed frames each and
    two profiled ones (device-busy share), and the traversal's main paths
    (b4_frames).  Then the per-depth route without the any-hit tables
    (SHARED_RUNS).  Every layout's from-reset frame equals the default's
    bitwise on both routes (image and traced count).  Returns the numbers
    by layout."""
    import torch

    dev = torch.device("cuda")
    out, ref = {}, None
    for name, env in LAYOUT_RUNS + SHARED_RUNS:
        shared = name.endswith("_shared")
        with environ(**env), fused_whole_frame():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ds = scene.device(dev)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            small = sum(v for k, v in ds.table_bytes().items()
                        if k.startswith("mk_"))
            res = dict(build_seconds=build_s, node_rows=ds.pnodes.shape[0],
                       width=ds.packet_width,
                       stack_need=scene.build_info["stack_need"])
            with arms(ds, settings) as keys:
                res["arms"] = keys
                # B4 walks the shading tree, which CPUGPU_OCCL=0 leaves
                # as it is: the shared runs check the other arms only
                res["check"] = check_variant(ds, settings, o, d, st, small,
                                             name, ref64, b4=not shared)
                if not shared:
                    path, got, whole = frame_whole(
                        scene, cam_cfg, settings, width, height, small, False,
                        phase=f"layout3_{name}_whole")
                    whole["busy"] = profile_frames(
                        whole.pop("renderer"), whole["ms_per_frame"],
                        f"whole-frame {name}")
                    res["whole"] = dict(whole, path=path, counts=got)
                    bitwise_path(path, f"layout {name}, whole-frame")
                path, got, mega = frame_mega(
                    scene, cam_cfg, settings, width, height, small, False,
                    phase=f"layout3_{name}_mega")
                with environ(CPUGPU_NO_PTFRAME="1"):
                    mega["busy"] = profile_frames(
                        mega.pop("renderer"), mega["ms_per_frame"],
                        f"per-depth {name}")
                res["mega"] = dict(mega, path=path, counts=got)
                bitwise_path(path, f"layout {name}, per-depth")
                if not shared:
                    res["b4"] = b4_frames(scene, cam_cfg, settings,
                                          whitted_settings, width, height,
                                          name)
        if ref is None:
            ref = {k: mega[k] for k in ("image", "traced", "whole_image",
                                        "whole_traced")}
        for route, key in (("per-depth", "image"), ("whole-frame",
                                                    "whole_image")):
            traced = "traced" if key == "image" else "whole_traced"
            if not (bool((mega[key] == ref[key]).all())
                    and mega[traced] == ref[traced]):
                raise AssertionError(f"layout {name}: the {route} frame "
                                     "differs from the default layout's")
        for k in ("image", "whole_image"):
            mega.pop(k)
        out[name] = res
        out["ref_frames"] = ref
        say("layout3", layout=name, build_seconds=round(build_s, 2),
            node_rows=res["node_rows"], width=res["width"],
            stack_need=res["stack_need"],
            whole_ms_per_frame=res.get("whole", {}).get("ms_per_frame"),
            whole_mrays_per_s=res.get("whole", {}).get("mrays_per_s"),
            whole_busy=res.get("whole", {}).get("busy"),
            mega_ms_per_frame=mega["ms_per_frame"],
            mega_mrays_per_s=mega["mrays_per_s"], mega_busy=mega["busy"],
            traced_per_frame=mega["traced"],
            image_equal_default=True, traced_equal_default=True,
            arms=res["arms"])
    return out


def layouts5(s5, runs=LAYOUT5_RUNS, ref=None, phase: str = "layout5",
             profile: bool = True) -> dict:
    """Phase [layout5]: config 5 flattened at 1280x720, the hook before
    every frame, under `runs` (LAYOUT5_RUNS: the default side tables,
    16-wide rows, the fused table, fused 16-wide rows): the flatten
    decision on the layout's tables (bytes against the budget), the
    routes through frame5 (both, or the per-depth route alone where the
    whole-frame gate refuses the tables; every launch sampled against its
    plain version, timed frames, the refit's ms), a refit against a fresh
    build at the same transforms (every table, the fused and leaf-14
    tables included, bitwise), and one frame from reset per route at the
    same transforms equal to the first run's (image and traced count;
    `ref` keeps them across calls); with `profile` two profiled frames
    per route (the device-busy share).  Returns the numbers by layout."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models import renderer
    from cpugpupathtracing_tpu_torch.models import scene as scenelib
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    dev = torch.device("cuda")
    base = s5["flat"]["scene"]
    out = {}
    ref = {} if ref is None else ref
    for name, env in runs:
        with environ(**env, CPUGPU_NO_FLATTEN=None), fused_whole_frame():
            scene, cam, settings, w, h, hook = config5(share=base)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ds = scene.device(dev)
            torch.cuda.synchronize()
            info = dict(scene.build_info,
                        seconds=time.perf_counter() - t0)
            res = dict(flattened=ds.packet_flattened,
                       width=ds.packet_width,
                       flat_bytes=info["flat_bytes"],
                       budget_bytes=int(info["flatten_budget_mb"] * 1e6),
                       build_seconds=info["seconds"],
                       stack_need=info["stack_need"],
                       node_rows=ds.pnodes.shape[0])
            if not ds.packet_flattened:
                say(phase, layout=name, **res,
                    note="over the flatten budget: the 8-wide object-space "
                    "path, not timed here")
                out[name] = res
                continue
            s5l = dict(flat=dict(scene=scene, hook=hook), cam=cam,
                       settings=settings, width=w, height=h)
            # the routes Renderer takes (fused tables through
            # fused_whole_frame): the per-depth one alone where the gate
            # refuses the whole-frame route
            whole = renderer.pt_frame_active(ds, settings)
            res["gate"] = scenelib.pt_frame_gate_reason(ds, settings)
            with arms(ds, settings) as keys:
                res["arms"] = keys
                for route, rphase in (("whole", "frame5"),
                                      ("mega", "frame5_mega")):
                    if route == "whole" and not whole:
                        continue
                    path, got, fr = frame5(s5l, rphase, False,
                                           label=f"{phase}_{name}_{route}")
                    rr = fr.pop("renderer")
                    fr["busy"] = None
                    with environ(**FRAME5_ROUTES[rphase][1]):
                        if profile:
                            fr["busy"] = profile_frames(
                                rr, fr["ms_per_frame"],
                                f"config 5 {name} {route}",
                                step=lambda: hook(99, rr))
                    res[route] = dict(fr, path=path, counts=got)
                    bitwise_path(path, f"config 5 {name}, {route}")
                # a refit against a fresh build at the same transforms
                fresh, *_ = config5(share=base)
                for ob, oa in zip(fresh.objects, scene.objects):
                    if oa.instances is not None:
                        ob.instances = oa.instances.copy()
                fds = fresh.device(dev)
                cur = scene.device(dev)
                bad = [f for f, _ in scenelib.TABLE_FIELDS
                       + scenelib.VARIANT_FIELDS
                       if (getattr(cur, f) is None) != (getattr(fds, f) is None)
                       or (getattr(cur, f) is not None and not torch.equal(
                           getattr(cur, f).view(torch.int32)
                           if getattr(cur, f).dtype == torch.float32
                           else getattr(cur, f),
                           getattr(fds, f).view(torch.int32)
                           if getattr(fds, f).dtype == torch.float32
                           else getattr(fds, f)))]
                if bad:
                    raise AssertionError(f"config 5 {name}: the refit differs "
                                         f"from a fresh build in {bad}")
                # one frame from reset per route at frame 2's transforms
                for route, renv in (("whole", {}),
                                    ("mega", {"CPUGPU_NO_PTFRAME": "1"})):
                    with environ(**renv):
                        r = Renderer(scene, camera=cam,
                                     config=RenderConfig(width=w, height=h),
                                     settings=settings, device=dev)
                        hook(2, r)
                        r.render_frame()
                    img, tr = r.image_u32(), r.stats.traced_rays
                    if route not in ref:
                        ref[route] = (img, tr)
                    elif not (bool((img == ref[route][0]).all())
                              and tr == ref[route][1]):
                        raise AssertionError(
                            f"config 5 {name}: the {route} frame differs "
                            "from the default layout's")
        out[name] = res
        whole = res.get("whole", {})
        say(phase, layout=name, **{k: v for k, v in res.items()
                                    if k not in ("whole", "mega")},
            whole_ms_per_frame=whole.get("ms_per_frame"),
            whole_mrays_per_s=whole.get("mrays_per_s"),
            whole_busy=whole.get("busy"),
            mega_ms_per_frame=res["mega"]["ms_per_frame"],
            mega_mrays_per_s=res["mega"]["mrays_per_s"],
            mega_busy=res["mega"]["busy"],
            refit_ms=res.get("whole", res["mega"])["refit_ms"],
            refit_bitwise=True,
            image_equal_default=True)
    return out


# The leaf-side and occlusion flags of the leaf phases (the JAX package's
# CPUGPU_LEAF14, CPUGPU_OCCL2 and CPUGPU_OCCL_W16), each over the default
# node layout (48-col rows and side tables)
LEAF_RUNS = (
    ("leaf14", {"CPUGPU_LEAF14": "1"}),
    ("occl2", {"CPUGPU_OCCL2": "1"}),
    ("occl_w16", {"CPUGPU_OCCL_W16": "1"}),
)
# config 5 flattened (its instances keep the any-hit tree 8-wide, so
# CPUGPU_OCCL_W16 builds config 5's default tables)
LEAF5_RUNS = (
    ("leaf14", {"CPUGPU_LEAF14": "1"}),
    ("occl2", {"CPUGPU_OCCL2": "1"}),
)


def flat_cols(x) -> list:
    """Every column of nested tuples of tensors, flattened."""
    if isinstance(x, (tuple, list)):
        return [c for v in x for c in flat_cols(v)]
    return [x.reshape(-1)]


def cols_differ(got, ref) -> int:
    """Columns of two nested outputs that differ bit for bit."""
    import torch

    return sum(not torch.equal(a, b) for a, b in zip(
        as_bits(*flat_cols(got)), as_bits(*flat_cols(ref))))


def b4_tables(ds, occl: bool = False) -> tuple:
    """(nodes, ltris, roots, closest-hit keywords, any-hit keywords) of
    traverse_packet_slim on the snapshot: over the shading tree of
    scene.packet_tables (the tree intersect_scene walks), or with occl
    over the any-hit tree -- the closest hit with the leaf-14 payload
    where there is one (else the t-only query), the any hit without
    it."""
    from cpugpupathtracing_tpu_torch.models import scene as scenelib

    if not occl:
        nodes, ltris, fused_nn, ents = scenelib.packet_tables(ds)
        kw = dict(fused_nn=fused_nn, width=ds.packet_width,
                  ents=None if ds.machinery else ents)
        return nodes, ltris, ds.proots, kw, kw
    nodes, ltris, roots, ents = scenelib.occl_tables(ds)
    ckw = dict(occl=True, pay=ds.poccl_pay, occl_rows=ds.poccl_rows,
               width=ds.poccl_width, ents=ents)
    return nodes, ltris, roots, ckw, dict(ckw, pay=None)


def b4_key(nodes, kw, depth: bool) -> str:
    """The launch key of traverse_packet_slim over (nodes, kw)."""
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    return ptf.launch_key(
        "traverse_packet_slim",
        ptf.table_layout(nodes, kw["ents"], kw.get("fused_nn", 0),
                         kw["width"]), depth=depth,
        leaf=ptf.leaf_arm(kw.get("occl", False), kw.get("pay"),
                          kw.get("occl_rows", 1)))


def shadow_query(ds, o, d, t, hit):
    """Shadow rays toward light 0 from the hit points o + d t of the lanes
    that hit: (ray columns, tmax, active)."""
    import torch

    pos = o + d * torch.where(hit, t, torch.zeros_like(t))[:, None]
    to_l = ds.mk_lights[0, 0:3][None, :] - pos
    dist = torch.sqrt((to_l * to_l).sum(dim=1))
    to_l = to_l / dist[:, None]
    return (columns(pos + to_l * 0.001, to_l),
            dist - ds.mk_lights[0, 3] - 0.002, hit)


def leaf_b4(ds, cam_cfg, width, height, name: str) -> dict:
    """Phase [leaf3_b4_<flag>]: traverse_packet_slim over the any-hit tree
    at full frame: the camera rays of the width x height frame made on
    the card (row-major), their closest hits (the leaf-14 closest hit with the
    payload, else the t-only query; count_depth, the JAX function's
    default) and the any hits toward light 0 of the rays that hit, each
    launch timed and every SAMPLE_STRIDE-th lane against its plain
    version (traverse_main_path: the walk bitwise, brute force in
    existence), with the launch counts of the two arms from 0."""
    import torch
    from cpugpupathtracing_tpu_torch.models import camera as camlib
    from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps

    dev = torch.device("cuda")
    cam = camlib.to_arrays(cam_cfg, dev)
    nodes, ltris, roots, ckw, akw = b4_tables(ds, occl=True)

    def frame_fn():
        lane = torch.arange(width * height, device=dev)
        o, d = camlib.lane_rays(cam, lane, width, height)
        rays = columns(o, d)
        far = torch.full((width * height,), 1e34, device=dev)
        h = tps.traverse_packet_slim(rays[:3], rays[3:], far, nodes, ltris,
                                     roots, **ckw)
        qr, t0, act = shadow_query(ds, o, d, h[0], h[1] >= 0)
        tps.traverse_packet_slim(qr[:3], qr[3:], t0, nodes, ltris, roots,
                                 active=act, any_hit=True, count_depth=False,
                                 **akw)

    frame_fn()  # warm-up
    keys = (b4_key(nodes, ckw, True), b4_key(nodes, akw, False))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame_fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = counts()
    expect_counts(got, f"leaf3 b4 {name}", **{k: 1 for k in keys})
    path = traverse_main_path(frame_fn, f"leaf3 b4 {name}", 2)
    bitwise_path(path, f"leaf3 b4 {name}")
    say(f"leaf3_b4_{name}", lanes=width * height, ms=ms, counts=got,
        kernel_ms=sum(mp["ms"] for mp in path), keys=keys)
    for mp in path:
        say(f"leaf3_b4_{name}_{mp['kind']}", **mp)
    return dict(counts=got, path=path, ms=ms, keys=keys)


def leaf3(scene, cam_cfg, settings, width, height, o, d, st, ref64,
          ref_frames) -> dict:
    """Phase [leaf3]: config 3 at 1920x1080 under CPUGPU_LEAF14,
    CPUGPU_OCCL2 and CPUGPU_OCCL_W16 (LEAF_RUNS), each built from the
    checkout (seconds): its arms on the check lanes (check_variant, B4
    over the any-hit tree), the
    routes its gate allows -- the whole-frame route (OCCL2: pt_frame's
    2-row arm) and the per-depth route (shade_extend's leaf-14 arm,
    shadow_resolve's 2-row and 16-wide arms) -- with every launch timed,
    bounded and sampled against the plain version bitwise and
    LEAF_FRAMES timed frames, and B4's arms over the any-hit tree at full
    frame (leaf_b4).  Each flag's frames from reset equal the default
    layout's (`ref_frames`, phase 20) bitwise: image and traced count.
    Returns the numbers by flag."""
    import torch
    from cpugpupathtracing_tpu_torch.models import scene as scenelib

    dev = torch.device("cuda")
    out = {}
    for name, env in LEAF_RUNS:
        with environ(**env):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ds = scene.device(dev)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            small = sum(v for k, v in ds.table_bytes().items()
                        if k.startswith("mk_"))
            gate = scenelib.pt_frame_gate_reason(ds, settings)
            res = dict(build_seconds=build_s, gate=gate,
                       occl_rows=ds.poccl_rows, occl_width=ds.poccl_width,
                       occl_node_rows=ds.poccl_nodes.shape[0],
                       occl_leaf_rows=ds.poccl_ltris.shape[0],
                       payload=ds.poccl_pay is not None,
                       stack_need=scene.build_info["stack_need"],
                       occl_depth=scene.build_info["occl_depth"])
            with arms(ds, settings) as keys:
                res["arms"] = keys
                res["check"] = check_variant(ds, settings, o, d, st, small,
                                             f"leaf_{name}", ref64,
                                             whole=gate is None, occl_b4=True)
                if gate is None:
                    path, got, whole = frame_whole(
                        scene, cam_cfg, settings, width, height, small, False,
                        phase=f"leaf3_{name}_whole")
                    whole.pop("renderer")
                    res["whole"] = dict(whole, path=path, counts=got)
                    bitwise_path(path, f"leaf {name}, whole-frame")
                path, got, mega = frame_mega(
                    scene, cam_cfg, settings, width, height, small, False,
                    phase=f"leaf3_{name}_mega", whole=gate is None)
                mega.pop("renderer")
                bitwise_path(path, f"leaf {name}, per-depth")
            frames = [("per-depth", mega.pop("image"), mega["traced"],
                       "image", "traced")]
            whole_img = mega.pop("whole_image")
            if gate is None:
                frames.append(("whole-frame", whole_img,
                               mega["whole_traced"], "whole_image",
                               "whole_traced"))
            for route, img, traced, ik, tk in frames:
                if not (bool((img == ref_frames[ik]).all())
                        and traced == ref_frames[tk]):
                    raise AssertionError(f"leaf {name}: the {route} frame "
                                         "differs from the default layout's")
            res["mega"] = dict(mega, path=path, counts=got)
            res["b4"] = leaf_b4(ds, cam_cfg, width, height, name)
        out[name] = res
        say("leaf3", flag=name, build_seconds=round(build_s, 2),
            gate=gate, occl_rows=res["occl_rows"],
            occl_width=res["occl_width"],
            occl_node_rows=res["occl_node_rows"],
            occl_leaf_rows=res["occl_leaf_rows"], occl_depth=res["occl_depth"],
            stack_need=res["stack_need"],
            whole_ms_per_frame=res.get("whole", {}).get("ms_per_frame"),
            whole_mrays_per_s=res.get("whole", {}).get("mrays_per_s"),
            mega_ms_per_frame=res["mega"]["ms_per_frame"],
            mega_mrays_per_s=res["mega"]["mrays_per_s"],
            traced_per_frame=res["mega"]["traced"],
            image_equal_default=True, traced_equal_default=True,
            arms=res["arms"])
    return out


# each kernel's CUDA unit (csrc/) and the TPU kernel it replaces
# (cpugpupathtracing_tpu/ops/, the pallas_call line)
KERNEL_SOURCES = {
    "pt_frame": ("pt_frame.cu", "pt_frame_kernel.py:419"),
    "shade_extend": ("megakernel.cu", "megakernel.py:1713"),
    "shadow_resolve": ("megakernel.cu", "megakernel.py:1847"),
    "traverse_packet_slim": ("traverse.cu", "traverse_packet_slim.py:1485"),
}


def arm_entry(kernel: str, key: str, chk: dict, launches: int, path: list,
              **extra) -> dict:
    """A kernels-line entry of an arm: its check-lane numbers (`chk`, an
    entry of check_variant), its launches on the main path and those
    launches' numbers, and `extra`."""
    unit, line = KERNEL_SOURCES[kernel]
    return dict({
        "name": key,
        "route": "cuda",
        "source": "cpugpupathtracing_tpu_torch/csrc/" + unit,
        "replaces": "cpugpupathtracing_tpu/ops/" + line,
        "launches": launches,
        "max_abs_err": chk["max_abs_err"],
        "ms": chk["ms"],
        "call_ms": chk["call_ms"],
        "plain_ms": chk["plain_ms"],
        "bound_ms": chk["bound"][0],
        "bound_by": chk["bound"][1],
        "library_ms": None,
        "check_lanes": CHECK_LANES,
        "check_mismatches": chk["mismatches"],
        "layouts": chk["layouts"],
        "main_path": [{k: mp[k] for k in mp if k in (
            "launch", "depth", "kind", "run", "lanes", "active", "ms",
            "call_ms", "bound_ms", "bound_by", "sampled_lanes",
            "max_abs_err", "mismatches", "energy_bit_mismatches")}
            for mp in path],
    }, **extra)


def check_summary(chk: dict) -> dict:
    """The few numbers of a check entry that stand beside another arm's."""
    return {"name": chk["key"], "ms": chk["ms"], "call_ms": chk["call_ms"],
            "plain_ms": chk["plain_ms"], "bound_ms": chk["bound"][0],
            "mismatches": chk["mismatches"]}


def leaf_entries(leaf: dict, leaf5: dict) -> list:
    """The kernels line's entries of the leaf arms: per flag of LEAF_RUNS
    the arms it adds (those whose launch key names a leaf arm) --
    pt_frame's 2-row arm (OCCL2), shade_extend's leaf-14 arm (LEAF14),
    shadow_resolve's 2-row (OCCL2) and 16-wide (OCCL_W16) arms, and
    traverse_packet_slim's arms over the any-hit tree (the closest hit
    with count_depth, the any hit without, each with the other arm's
    check beside it) -- each with its check-lane numbers
    (check_leaf_<flag>), its launches on config 3's main paths under the
    flag (the routes' timed frames; B4's full-frame queries) and config
    5's launches of the arm under the flag beside them."""
    out = []
    for name, res in leaf.items():
        chk, b4, r5 = res["check"], res["b4"], leaf5.get(name, {})
        for kernel, route in (("pt_frame", "whole"), ("shade_extend", "mega"),
                              ("shadow_resolve", "mega")):
            key = res["arms"][kernel]
            if kernel not in chk or not ({"pay", "occl", "occl2", "ow16"}
                                         & set(key.split("_"))):
                continue
            path = [mp for mp in res[route]["path"]
                    if kernel == "pt_frame" or mp["name"] == kernel]
            extra = dict(flag=name)
            if route in r5:
                k5 = r5["arms"][kernel]
                extra["config5"] = {"name": k5, "launches":
                                    r5[route]["counts"].get(k5, 0)}
            out.append(arm_entry(kernel, key, chk[kernel],
                                 res[route]["counts"].get(key, 0), path,
                                 **extra))
        # the arm each query's main path launches (leaf_b4): the closest
        # hit with count_depth, the any hit without
        for query, main, other in (("closest", "_depth", ""),
                                   ("any", "", "_depth")):
            c = chk[f"traverse_{query}{main}"]
            out.append(arm_entry(
                "traverse_packet_slim", c["key"], c,
                b4["counts"].get(c["key"], 0),
                [mp for mp in b4["path"] if mp["kind"] == query], flag=name,
                check_other_arm=check_summary(
                    chk[f"traverse_{query}{other}"])))
    return out


def variant_entries(lay3: dict, lay5: dict) -> list:
    """The kernels line's entries of the variant arms: per layout of
    LAYOUT_RUNS but the plain one, pt_frame's, shade_extend's,
    shadow_resolve's (over 16-wide and fused rows from the run without
    the any-hit tables) and the traversal's with and without count_depth
    (the any hit with count_depth beside the latter), each with its
    check-lane numbers (check_<layout>), its launches on config 3's main
    paths in that layout (the whole-frame route's timed frames, the
    per-depth route's, the traversal's XLA and WHITTED frames) and those
    main paths' launches; config 5's launches per layout beside them."""
    out = []
    for name, _ in LAYOUT_RUNS:
        if name == "64":
            continue
        res = lay3[name]
        shadow = lay3.get(f"{name}_shared", res) \
            if name in ("w16", "fused", "fused_w16") else res
        b4 = res["b4"]
        r5 = lay5.get(name, {})
        for kernel, run, route in (("pt_frame", res, "whole"),
                                   ("shade_extend", res, "mega"),
                                   ("shadow_resolve", shadow, "mega")):
            key = run["arms"][kernel]
            extra = ({"config5_launches": r5[route]["counts"].get(key, 0)}
                     if route in r5 else {})
            out.append(arm_entry(
                kernel, key, run["check"][kernel],
                run[route]["counts"].get(key, 0),
                [mp for mp in run[route]["path"]
                 if kernel == "pt_frame" or mp["name"] == kernel], **extra))
        for depth in (False, True):
            chk = res["check"]["traverse_closest" + "_depth" * depth]
            key = res["arms"]["traverse_packet_slim" + "_depth" * depth]
            extra = ({"check_any_hit": check_summary(
                res["check"]["traverse_any_depth"])} if depth else {})
            out.append(arm_entry(
                "traverse_packet_slim", key, chk,
                sum(b4[run]["counts"].get(key, 0) for run in b4),
                [dict(mp, run=run) for run in b4 for mp in b4[run]["path"]
                 if mp["count_depth"] == depth], **extra))
    return out


# the traversal labs (labs/): per lab its kernels-line name, CUDA unit and
# the TPU kernel it replaces (the pallas_call line), and the arm whose
# check-lane numbers head its entry (the JAX function's defaults)
LAB_SOURCES = {
    "L1": ("traverse_lab2", "lab2.cu", "tools/kernel_lab2.py:356"),
    "L2": ("traverse_lab2p", "lab2.cu", "tools/kernel_lab2.py:753"),
    "L3": ("traverse16", "lab3.cu", "tools/kernel_lab3.py:469"),
    "L4": ("traverse_phase", "phase_lab.cu", "tools/phase_lab.py:415"),
    "L6": ("traverse_lab", "kernel_lab.cu", "tools/kernel_lab.py:584"),
    "L7": ("traverse_lab_dual", "kernel_lab.cu", "tools/kernel_lab.py:854"),
}
LAB_DEFAULT = {"L1": "linear baseline", "L2": "pipelined fs+fused",
               "L3": "W16 lab (fs+condpush)", "L4": "phase-split",
               "L6": "base (seq phases)", "L7": "dual-tile"}
# the small tree on which L6's slab="skip" arm is held against its plain
# version (which takes one lockstep step per row of the tree, too many on
# config 3's): an icosphere of subdivisions 1 and a ground quad at 32x32
SKIP_CHECK_SIZE = (32, 32)


def skip_scene():
    """The small tree of SKIP_CHECK_SIZE's check (plain tables)."""
    from cpugpupathtracing_tpu_torch.models import materials as matlib
    from cpugpupathtracing_tpu_torch.models import mesh as meshlib
    from cpugpupathtracing_tpu_torch.models.scene import Scene

    s = Scene()
    m = s.add_material(matlib.Material.diffuse((0.8, 0.8, 0.8)))
    s.add_mesh("ball", meshlib.icosphere(subdivisions=1, radius=2.0), m)
    s.add_mesh("floor", meshlib.ground_quad(half_extent=50.0, y=-2.0), m)
    return s


def check_labs(fan) -> dict:
    """Phase 17e on CHECK_LANES lanes from the middle of config 3's bounce
    fan: every arm of L1-L4, L6 and L7 (labs/bounce_fan.py ARMS) against
    its plain version on the card, bitwise on every output -- t, hit,
    object, L6's depth, the per-tile trip counters and the count launch's
    work and rows read (L1's and L2's warp trips, their schedule's, must
    hold the rays' trips: 32 per warp trip at most) -- and its hits
    against the standalone traversal's
    (closest hits bitwise, L3's any hit in its occlusion bit; fma's
    mismatches counted, leaf skip's none); the L2 invariant that
    parent-pointer frames take the frame stack's per-ray trips exactly;
    per L1, L2, L6 and L7 arm ([check_labs_arm]) its kernels' registers,
    shared memory and spills, and L1's and L2's blocks per SM, lane
    trips, warp trips and lane share beside the lockstep schedule's (32
    consecutive lanes a warp, no refill: the plain version's); the L7
    invariant that a warp's trips are the max of the two L6 (ilv, fixed)
    warps it pairs.  L6's slab="skip" arm, whose plain version takes one
    step per row of the tree, is held against its plain version on a small
    tree (skip_scene's bounce fan of 1024 lanes) and on the check lanes
    against the standalone traversal's hits only.  Returns per arm label
    its numbers: device ms (CHECK_REPS launches with the stream held busy,
    common.busy_ms) and call_ms (CUDA events), plain ms, the check lanes'
    bound."""
    import torch

    from cpugpupathtracing_tpu_torch.labs import bounce_fan as bf
    from cpugpupathtracing_tpu_torch.labs import kernel_lab as kl
    from cpugpupathtracing_tpu_torch.labs import kernel_lab2 as l2
    from cpugpupathtracing_tpu_torch.labs.common import busy_ms
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    n = fan.t_init.numel()
    lo = n // 2 - CHECK_LANES // 2
    sl = slice(lo, lo + CHECK_LANES)
    rays = tuple(c[sl].contiguous() for c in fan.rays)
    t0, act = fan.t_init[sl].contiguous(), fan.active[sl].contiguous()
    small = bf.make_fan(t0.device, *SKIP_CHECK_SIZE, scene=skip_scene())
    out = {}
    for arm in bf.ARMS:
        got = bf.call(fan, arm, rays, t0, act, count_rows=True)
        skip = arm.kw.get("slab") == "skip"
        if skip:
            s_got = bf.call(small, arm, count_rows=True)
            ref, plain_ms = timed_plain(
                lambda arm=arm: bf.plain(small, arm, small.rays,
                                         small.t_init, small.active,
                                         count_rows=True))
            pairs = zip(s_got, ref)
        else:
            ref, plain_ms = timed_plain(
                lambda arm=arm: bf.plain(fan, arm, rays, t0, act,
                                         count_rows=True))
            pairs = zip(got, ref)
        per_ray = arm.kernel in bf.PER_RAY
        if per_ray:  # COUNTS bitwise, the warp trips the schedule's
            pairs = list(zip(got[:-1], ref[:-1])) + [(got[-1][:-1],
                                                      ref[-1][:-1])]
        ptf.check_status(t0.device)
        mism = sum(int((a_ != b_).sum())
                   for a_, b_ in (as_bits(a, b) for a, b in pairs))
        hits = None if arm.hits == "skip" else \
            bf.hit_mismatches(fan, arm, got, lanes=sl)
        if mism or (hits and arm.hits == "equal"):
            raise AssertionError(f"check_labs {arm.label}: {mism} output "
                                 f"words differ from the plain version, "
                                 f"{hits} hits from the standalone traversal")
        if skip:
            sweep_counters(fan, got, act)
            slow_rows = sweep_slow_rows(small, arm)
        lanes = {}
        if per_ray:
            lane, wt, lock = (int(got[3].sum()), int(got[-1][-1]),
                              int(ref[-1][-1]))
            if 32 * wt < lane:
                raise AssertionError(f"check_labs {arm.label}: {wt} warp "
                                     f"trips hold {lane} lane trips")
            lanes = dict(lane_trips=lane, warp_trips=wt,
                         lane_share=lane / (32 * wt),
                         lockstep_warp_trips=lock,
                         lockstep_lane_share=lane / (32 * lock))
        out[arm.label] = dict(lanes,
            key=bf.arm_key(arm), mismatches=mism, hit_mismatches=hits,
            plain_check="small tree" if skip else "check lanes",
            max_abs_err=float(((s_got if skip else got)[0]
                               - ref[0]).abs().max()),
            iters=bf.trips(arm, got)[0],
            counts=dict(zip(bf.cm.COUNTS, (int(v) for v in got[-1]))),
            bound=bf.bound(fan, arm, got[-1], act), plain_ms=plain_ms,
            ms=busy_ms(lambda arm=arm: bf.call(fan, arm, rays, t0, act),
                       CHECK_REPS),
            call_ms=cuda_ms(lambda arm=arm: bf.call(fan, arm, rays, t0, act),
                            CHECK_REPS))

    for arm in bf.ARMS:
        if arm.kernel not in ("L1", "L2", "L6", "L7"):
            continue
        v = out[arm.label]
        names = lab_instances(arm)
        unfused = bf.unfused_ms(arm, torch.tensor(
            [v["counts"][k] for k in bf.cm.COUNTS]))
        v["ptxas"] = {k: ptxas_resources(k) for k in names}
        per_ray = {}
        if arm.kernel in bf.PER_RAY:
            v["blocks_per_sm"] = l2.occupancy(arm.kernel, **arm.kw)
            per_ray = dict(blocks_per_sm=v["blocks_per_sm"], **{
                k: round(v[k], 4) if isinstance(v[k], float) else v[k]
                for k in ("lane_trips", "warp_trips", "lane_share",
                          "lockstep_warp_trips", "lockstep_lane_share")})
        say("check_labs_arm", label=repr(arm.label), lanes=CHECK_LANES,
            ms=round(v["ms"], 4), bound_ms=round(v["bound"][0], 5),
            bound_by=v["bound"][1], unfused_ms=round(unfused, 5),
            ns_per_trip=round(v["ms"] * 1e6 / max(
                v.get("warp_trips", v["iters"]), 1), 3), **per_ray,
            **{f"ptxas_{k}": repr(f"{k}: {r}")
               for k, r in v["ptxas"].items()})
        v["unfused_ms"] = unfused
    for near in ("", "+nearest"):
        fs = out["pipelined fs+fused" + near]["iters"]
        par = out["pipe fs+fused+near+parent" if near
                  else "pipelined fs+fused+parent"]["iters"]
        if fs != par:
            raise AssertionError(f"check_labs: parent frames took {par} "
                                 f"trips, the frame stack {fs}")
    rcp_bad, rcp_tested = kl.rcp_check(t0.device)
    if rcp_bad:
        raise AssertionError(f"check_labs: the sweep's reciprocal differs "
                             f"from 1.0f / x on {rcp_bad} of {rcp_tested} "
                             "inputs")
    # L7: per pair of tiles the sum over its warps of the max of the two
    # L6 (ilv, fixed) warps it pairs, L6's per-warp trips from its plain
    # version (equal to its kernel's per tile above)
    l6 = kl.traverse_lab_reference(rays, t0, fan.nodes, fan.ltris, fan.roots,
                                   active=act, slab="ilv", leaf="ilv",
                                   order="fixed", warp_trips=True)
    dual = bf.call(fan, next(a for a in bf.ARMS if a.kernel == "L7"), rays,
                   t0, act)
    pair_max = bool(torch.equal(dual[4].cpu(),
                                kl.pair_trips(l6[-1], CHECK_LANES).cpu()))
    if not pair_max:
        raise AssertionError("check_labs: L7's trips are not the max of its "
                             "paired L6 warps'")
    # blocks per SM of L6's ilv + fixed arm with its entries from the row
    # and from the shared-memory mirror of config 3's tree
    fixed = dict(slab="ilv", leaf="ilv", order="fixed")
    occupancy = {e: kl.occupancy(fan.nodes.shape[0], entries=e, **fixed)
                 for e in ("vector", "smem")}
    say("check_labs", lanes=CHECK_LANES, active=int(act.sum()),
        arms=len(out), mismatches=0, parent_iters_equal=True,
        rcp_fast_inputs=rcp_tested, rcp_fast_mismatches=rcp_bad,
        sweep_slow_rows=slow_rows,
        pair_max_equal=pair_max, blocks_per_sm=occupancy,
        fma_hit_mismatches=[v["hit_mismatches"] for v in out.values()
                            if v["key"].endswith("_fma")],
        **{f"{k}_ms": round(v["ms"], 4) for k, v in out.items()},
        **{f"{k}_plain_ms": round(v["plain_ms"], 1)
           for k, v in out.items()})
    return out


# the scales of the small tree's first leaf record's edges that take some
# rays' determinants past the sweep's fast reciprocal (|det| >= 2^126;
# 3e19 makes some infinite)
SWEEP_SLOW_SCALES = (1e19, 3e19)


def sweep_slow_rows(small, arm) -> dict:
    """L6's slab-skip arm on the small tree with its first leaf record's
    edges scaled by each of SWEEP_SLOW_SCALES: every output bitwise its
    plain version's, so the rows tested again by tri_test (a determinant
    past rcp_fast's range) are right.  Returns per scale the active rays
    whose determinant against that record is past the range (at least
    one, or the path did not run)."""
    import torch

    from cpugpupathtracing_tpu_torch.labs import bounce_fan as bf

    out = {}
    for scale in SWEEP_SLOW_SCALES:
        lt = small.ltris.clone()
        lt[0, 3:9] *= scale
        case = small._replace(ltris=lt)
        got = bf.call(case, arm, count_rows=True)
        ref = bf.plain(case, arm, case.rays, case.t_init, case.active,
                       count_rows=True)
        mism = sum(int((a_ != b_).sum())
                   for a_, b_ in (as_bits(a, b) for a, b in zip(got, ref)))
        # the kernel's determinant, op by op in f32
        d = [c[case.active] for c in case.rays[3:]]
        e1, e2 = lt[0, 3:6], lt[0, 6:9]
        hx = d[1] * e2[2] - d[2] * e2[1]
        hy = d[2] * e2[0] - d[0] * e2[2]
        hz = d[0] * e2[1] - d[1] * e2[0]
        det = e1[0] * hx + e1[1] * hy + e1[2] * hz
        slow = int((~(det.abs() < 2.0 ** 126)).sum())
        if mism or not slow:
            raise AssertionError(f"check_labs slab skip, record edges x "
                                 f"{scale}: {mism} output words differ from "
                                 f"the plain version ({slow} slow rays)")
        out[f"{scale:g}"] = slow
    return out


def sweep_counters(fan, got, act) -> None:
    """L6's slab="skip" arm on the check lanes of config 3's tree (whose
    plain walk takes a step per row, too many there): its counters
    against those of the row sequence every active lane walks
    (labs/kernel_lab.py sweep_rows) -- depth 0, per tile the sequence's
    steps times the warps with an active lane, the count launch's work
    and rows read."""
    import torch

    from cpugpupathtracing_tpu_torch.labs import common as cm
    from cpugpupathtracing_tpu_torch.labs import kernel_lab as kl

    node_seq, leaf_seq = kl.sweep_rows(fan.nodes, fan.roots)
    steps = len(node_seq) + len(leaf_seq)
    act = act.cpu()
    live = int(act.sum())
    want_iters = cm.tile_sum(cm.warp_any(
        torch.cat([act, torch.zeros(-act.numel() % cm.WARP,
                                    dtype=torch.bool)])).to(torch.int64)
        * steps, act.numel())
    want = [live * len(node_seq), live * len(leaf_seq),
            live * len(leaf_seq) * cm.LEAF_TRIS, len(set(node_seq)),
            len(set(leaf_seq))]
    if bool((got[3] != 0).any()) or not torch.equal(got[4].cpu(), want_iters) \
            or got[-1].tolist() != want:
        raise AssertionError(f"check_labs slab skip: counters {got[-1]} "
                             f"(iters {int(got[4].sum())}) against the row "
                             f"sequence's {want} ({int(want_iters.sum())})")


def fan_plain(fan) -> dict:
    """Every L1 and L2 arm on the whole fan against its plain version on
    the card: t, hit, object, the per-tile iters and leafs and the count
    launch's work and rows read, bitwise; the warp trips, the schedule's,
    hold the rays' trips.  The fan's active rays outnumber the threads the
    card keeps resident many times over (the 8192 check lanes' do not),
    so lanes take new rays while the rest of their warp walks.  Returns
    per arm label the plain version's ms (host clock)."""
    import torch

    from cpugpupathtracing_tpu_torch.labs import bounce_fan as bf
    from cpugpupathtracing_tpu_torch.labs import kernel_lab2 as l2
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    live = int(fan.active.sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, resident = {}, {}
    for arm in (a for a in bf.ARMS if a.kernel in bf.PER_RAY):
        # 128 threads a block (csrc/lab_device.cuh lab::kBlock)
        resident[arm.label] = sms * l2.occupancy(arm.kernel, **arm.kw) * 128
        if live <= 2 * resident[arm.label]:
            raise AssertionError(f"fan_plain {arm.label}: {live} active "
                                 f"rays for {resident[arm.label]} resident "
                                 "threads")
        got = bf.call(fan, arm, count_rows=True)
        ref, out[arm.label] = timed_plain(
            lambda arm=arm: bf.plain(fan, arm, fan.rays, fan.t_init,
                                     fan.active, count_rows=True))
        ptf.check_status(fan.t_init.device)
        pairs = list(zip(got[:-1], ref[:-1])) + [(got[-1][:-1],
                                                  ref[-1][:-1])]
        mism = sum(int((a_ != b_).sum())
                   for a_, b_ in (as_bits(a, b) for a, b in pairs))
        lane, wt = int(got[3].sum()), int(got[-1][-1])
        if mism or 32 * wt < lane:
            raise AssertionError(f"fan_plain {arm.label}: {mism} output "
                                 f"words differ from the plain version; "
                                 f"{wt} warp trips for {lane} lane trips")
    say("fan_plain", arms=len(out), lanes=fan.t_init.numel(), active=live,
        most_resident=max(resident.values()), mismatches=0,
        **{f"{k}_plain_ms": round(v, 1) for k, v in out.items()})
    return out


def labs(fan) -> list:
    """Phase 17f, the labs' main path: the bounce fan at full width
    through every arm, one launch each (labs/bounce_fan.py run): hits
    bitwise against the standalone traversal's, trips, device ms
    (common.busy_ms) and ns per warp trip, and the bound from a count
    launch of the arm made before the launch counts are zeroed (L1's and
    L2's warp trips from it too, their lane trips and lane share, the
    kernels each launch runs and the prep kernel's share of the arm's
    ms, the prep timed alone); and one launch of the standalone
    traversal's closest hit of the fan, the arms' yardstick.  Before the
    counts are zeroed, L1's and L2's arms are held against their plain
    versions on the whole fan (fan_plain).  Fails on any launch of another
    kernel arm, or a second launch of an arm that its timing did not
    make."""
    from cpugpupathtracing_tpu_torch.labs import bounce_fan as bf
    from cpugpupathtracing_tpu_torch.labs import kernel_lab2 as l2
    from cpugpupathtracing_tpu_torch.labs.common import busy_ms

    fan_plain(fan)
    bounds = bf.count_pass(fan)
    ran: dict = {}  # launches by arm label (the dp arm shares a key)

    def counting(call):
        def counted(fan, arm, *a, **k):
            ran[arm.label] = ran.get(arm.label, 0) + 1
            return call(fan, arm, *a, **k)
        return counted

    reset_counts()
    box = {}
    instrument(bf, "call", counting,
               lambda: box.update(rows=bf.run(fan, timed=True,
                                              bounds=bounds)))
    rows = box["rows"]
    by_key: dict = {}
    for arm in (bf.REF,) + bf.ARMS:
        key = bf.arm_key(arm)
        by_key[key] = by_key.get(key, 0) + ran[arm.label]
    expect_counts(counts(), "labs", **by_key)
    # the prep alone (L1's and L2's first kernel, the same for every arm)
    prep_ms = busy_ms(lambda: l2.prep_launch(
        fan.rays[:3], fan.rays[3:], fan.t_init, fan.nodes, fan.roots,
        active=fan.active))
    arms = {a.label: a for a in bf.ARMS}
    for row in rows:
        row["launches"] = ran[row["label"]]
        if row.get("lane_share") is not None:
            row.update(prep_ms=prep_ms, prep_share=prep_ms / row["ms"],
                       kernels=lab_instances(arms[row["label"]]))
        say("labs", **{k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in row.items() if k != "counts"})
    return rows


def lab_entries(chk: dict, rows: list) -> list:
    """The kernels line's entries of the six lab kernels: the check-lane
    numbers of the kernel's default arm (LAB_DEFAULT) at the top, and per
    arm its launches, device ms, ns per warp trip, trips, bound and hits
    on the full fan beside its check-lane numbers."""
    from cpugpupathtracing_tpu_torch.labs import bounce_fan as bf

    main = {r["label"]: r for r in rows}
    b4_ms = main[bf.REF.label]["ms"]
    out = []
    for lab, (name, unit, replaces) in LAB_SOURCES.items():
        labels = [a.label for a in bf.ARMS if a.kernel == lab]
        c = chk[LAB_DEFAULT[lab]]
        out.append({
            "name": name,
            "route": "cuda",
            "source": "cpugpupathtracing_tpu_torch/csrc/" + unit,
            "replaces": replaces,
            "launches": sum(main[lb]["launches"] for lb in labels),
            "max_abs_err": max(chk[lb]["max_abs_err"] for lb in labels),
            "ms": c["ms"],
            "call_ms": c["call_ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound"][0],
            "bound_by": c["bound"][1],
            "library_ms": None,
            "check_lanes": CHECK_LANES,
            "default_arm": LAB_DEFAULT[lab],
            "fan_b4_closest_ms": b4_ms,
            "arms": [{
                "label": lb, "key": main[lb]["key"],
                "launches": main[lb]["launches"], "ms": main[lb]["ms"],
                "ns_per_trip": main[lb]["ns_per_trip"],
                "iters": main[lb]["iters"],
                "leaf_share": main[lb]["leaf_share"],
                **{k: main[lb][k] for k in (
                    "lane_trips", "lane_share", "prep_ms", "prep_share",
                    "kernels") if main[lb].get(k) is not None},
                **{f"check_{k}": chk[lb][k] for k in (
                    "lane_share", "lockstep_lane_share", "blocks_per_sm",
                    "ptxas") if k in chk[lb]},
                "bound_ms": main[lb]["bound_ms"],
                "bound_by": main[lb]["bound_by"],
                "hits_equal": main[lb]["hits_equal"],
                "hit_mismatches": main[lb]["hit_mismatches"],
                "check_ms": chk[lb]["ms"], "check_call_ms": chk[lb]["call_ms"],
                "check_plain_ms": chk[lb]["plain_ms"],
                "check_plain": chk[lb]["plain_check"],
                "check_bound_ms": chk[lb]["bound"][0],
                "check_mismatches": chk[lb]["mismatches"],
                "check_hit_mismatches": chk[lb]["hit_mismatches"]}
                for lb in labels],
        })
    return out


# launches of each lab kernel and probe timed on the check lanes
CHECK_REPS = 5
# the floor probe's check: its trips per lane on the check lanes (the
# plain version steps them all in lockstep); its stage set at the top of
# the kernels line (tools/floor_probe.py's full body)
FLOOR_CHECK_K = 16
FLOOR_DEFAULT = ("ctrl", "loads", "slab", "leaf")


def check_floor(fan) -> dict:
    """Phase 17g: each of L5's stage sets (labs/floor_probe.py) on the
    CHECK_LANES check lanes of the bounce fan at FLOOR_CHECK_K trips
    against its plain version ("warp" layout), bitwise on t and the final
    entry.  Returns per stage set its device ms (common.busy_ms) and
    call_ms, plain ms and bound."""
    from cpugpupathtracing_tpu_torch.labs import floor_probe as fp
    from cpugpupathtracing_tpu_torch.labs.common import busy_ms

    n = fan.t_init.numel()
    lo = n // 2 - CHECK_LANES // 2
    rays = tuple(c[lo:lo + CHECK_LANES].contiguous() for c in fan.rays)
    out = {}
    for stages in fp.STAGE_SETS:
        def call(stages=stages):
            return fp.floor_probe(stages, fan.nodes, fan.ltris, rays,
                                  k_iters=FLOOR_CHECK_K)

        got = call()
        ref, plain_ms = timed_plain(
            lambda stages=stages: fp.floor_probe_reference(
                stages, fan.nodes, fan.ltris, rays, k_iters=FLOOR_CHECK_K))
        mism = sum(int((a_ != b_).sum())
                   for a_, b_ in (as_bits(a, b) for a, b in zip(got, ref)))
        if mism:
            raise AssertionError(f"check_floor {stages}: {mism} output words "
                                 "differ from the plain version")
        v = out[fp.launch_key(stages)] = dict(
            mismatches=mism, max_abs_err=float((got[0] - ref[0]).abs().max()),
            plain_ms=plain_ms,
            bound=fp.bound(stages, CHECK_LANES, FLOOR_CHECK_K),
            unfused_ms=fp.unfused_ms(stages, CHECK_LANES, FLOOR_CHECK_K),
            stack_ms=fp.control_yardstick(stages, CHECK_LANES, FLOOR_CHECK_K),
            ms=busy_ms(call, CHECK_REPS), call_ms=cuda_ms(call, CHECK_REPS))
        name = f"floor_kernel<{fp.stage_bits(stages)}>"
        v["ptxas"] = f"{name}: {ptxas_resources(name)}"
        say("check_floor_set", stages="+".join(stages) or "loop",
            ms=round(v["ms"], 5), bound_ms=round(v["bound"][0], 6),
            bound_by=v["bound"][1], unfused_ms=round(v["unfused_ms"], 6),
            stack_ms=round(v["stack_ms"], 6),
            ns_per_trip=round(fp.ns_per_trip(v["ms"], CHECK_LANES,
                                             FLOOR_CHECK_K), 3),
            ptxas=repr(v["ptxas"]))
    say("check_floor", lanes=CHECK_LANES, k_iters=FLOOR_CHECK_K,
        stage_sets=len(out), mismatches=0,
        **{f"{k}_ms": round(v["ms"], 4) for k, v in out.items()})
    return out


def floor(fan) -> list:
    """Phase 17h, L5's main path: every stage set once on the whole bounce
    fan (2,073,600 lanes) at the JAX probe's K = 2000 trips: device ms
    (common.busy_ms), ns per warp trip and the bound
    (labs/floor_probe.py run).  Fails on any other launch."""
    from cpugpupathtracing_tpu_torch.labs import floor_probe as fp

    reset_counts()
    rows = fp.run(fan.nodes, fan.ltris, fan.rays, timed=True)
    got = counts()
    expect_counts(got, "floor", **{r["key"]: got.get(r["key"], 0)
                                   for r in rows})
    for row, stages in zip(rows, fp.STAGE_SETS):
        row["launches"] = got[row["key"]]
        name = f"floor_kernel<{fp.stage_bits(stages)}>"
        row["ptxas"] = f"{name}: {ptxas_resources(name)}"
        say("floor", **{k: (round(v, 4) if isinstance(v, float) else
                            repr(v) if k == "ptxas" else v)
                        for k, v in row.items()})
    return rows


def floor_entry(chk: dict, rows: list) -> dict:
    """The kernels line's entry of L5: the check-lane numbers of the full
    stage set at the top, per stage set its main-path numbers."""
    from cpugpupathtracing_tpu_torch.labs import floor_probe as fp

    c = chk[fp.launch_key(FLOOR_DEFAULT)]
    return {
        "name": "floor_probe", "route": "cuda",
        "source": "cpugpupathtracing_tpu_torch/csrc/floor_probe.cu",
        "replaces": "tools/floor_probe.py:193",
        "launches": sum(r["launches"] for r in rows),
        "max_abs_err": max(v["max_abs_err"] for v in chk.values()),
        "ms": c["ms"], "call_ms": c["call_ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
        "library_ms": None, "check_lanes": CHECK_LANES,
        "check_k_iters": FLOOR_CHECK_K,
        "default_stages": "+".join(FLOOR_DEFAULT),
        "stage_sets": [dict(
            {k: r[k] for k in ("stages", "key", "lanes", "k_iters",
                               "launches", "ms", "ns_per_trip", "bound_ms",
                               "bound_by", "ptxas")},
            check_ms=chk[r["key"]]["ms"],
            check_plain_ms=chk[r["key"]]["plain_ms"]) for r in rows],
    }


def launch_probe(ds3) -> dict:
    """Phase 24, L8 (labs/launch_probe.py): trivial and trivial2 against
    x * 2 and x * 4 bitwise, then every case of the JAX driver -- the
    trivial kernel once and twice chained on 1024 f32, PyTorch's x * 2
    beside them, B4 on the 12-triangle cube at 1024 rays and on config 3
    (ds3, its plain-table snapshot) at 1, 4, 16 and 64 tiles -- with its
    host ms per synchronised call, its device ms per call (common.busy_ms),
    the profiler's ms per launch of its kernel (None where the profiler saw
    none) and call_ms (CUDA events); then the kernel's launch shape and
    trivial / trivial2 against x * 2 / two chained x * 2 timed in turns
    ([launch_shape]: both ratios).  Fails on a launch the cases do not
    make."""
    import torch

    from cpugpupathtracing_tpu_torch.labs import common as cm
    from cpugpupathtracing_tpu_torch.labs import launch_probe as lp
    from cpugpupathtracing_tpu_torch.utils.build import source_path

    dev = torch.device("cuda")
    x = torch.randn(lp.N, device=dev)
    exact = torch.equal(lp.trivial(x), x * 2) and \
        torch.equal(lp.trivial2(x), x * 4)
    if not exact:
        raise AssertionError("launch: trivial / trivial2 differ from x * 2 / "
                             "x * 4")
    plain = timed_plain(lambda: lp.scale2_reference(x))[1]
    cases = lp.cases(dev, ds3=ds3)
    # launches per call of each case's function, by launch key
    per_call = {"trivial": {"trivial": 1}, "trivial2": {"trivial2": 2}}
    reset_counts()
    ran: dict = {}
    rows, timed = [], []
    for label, kernel, lanes, fn in cases:
        calls = [0]

        def counted(fn=fn, calls=calls):
            calls[0] += 1
            return fn()
        rows.append(dict(label=label, lanes=lanes,
                         host_ms=lp.host_ms(counted),
                         call_ms=cuda_ms(counted, lp.REPS)))
        timed.append((kernel, counted, calls,
                      per_call.get(label, {} if "library" in label
                                   else {"traverse_packet_slim": 1})))
    # device ms per call (CUDA events with the stream held busy), and the
    # profiler's ms per launch beside it where it still records: after
    # many sessions in one process it misses launches, then sees none
    for r, (kernel, counted, _, _) in zip(rows, timed):
        r["ms"] = cm.busy_ms(counted, lp.REPS)
        r["profiler_ms"] = cm.profiled_ms(counted, kernel, lp.REPS)
    for _, _, calls, keys in timed:
        for k, v in keys.items():
            ran[k] = ran.get(k, 0) + v * calls[0]
    expect_counts(counts(), "launch", **ran)
    for row in rows:
        say("launch", **{k: (round(v, 5) if isinstance(v, float) else v)
                         for k, v in row.items()})
    # the kernel's launch shape (probes.cu kScaleBlock threads a block, one
    # float4 each), and trivial / trivial2 against x * 2 and two chained
    # x * 2, timed in turns (interleaved_ms)
    with open(source_path("csrc", "probes.cu")) as f:
        block = int(re.search(r"constexpr int kScaleBlock = (\d+);",
                              f.read()).group(1))
    t1, x2, t2, x4 = interleaved_ms((lambda: lp.trivial(x), lambda: x * 2,
                                     lambda: lp.trivial2(x),
                                     lambda: (x * 2) * 2))
    turns = dict(block=block, grid=-(-lp.N // (4 * block)), trivial_ms=t1,
                 x2_ms=x2, ratio=t1 / x2, trivial2_ms=t2, x2_twice_ms=x4,
                 ratio2=t2 / x4)
    say("launch_shape", **turns)
    return dict(rows=rows, launches=ran, plain_ms=plain, exact=exact,
                turns=turns)


# interleaved_ms: rounds of device timings per function, and launches per
# timing (common.busy_ms)
INTERLEAVE_ROUNDS, INTERLEAVE_REPS = 7, 20


def interleaved_ms(fns) -> list:
    """The median device ms per call of each fn (common.busy_ms over
    INTERLEAVE_REPS calls), timed in turn for INTERLEAVE_ROUNDS rounds, so
    that the functions share the card's state (clocks, caches)."""
    from cpugpupathtracing_tpu_torch.labs import common as cm

    times = [[] for _ in fns]
    for _ in range(INTERLEAVE_ROUNDS):
        for k, fn in enumerate(fns):
            times[k].append(cm.busy_ms(fn, INTERLEAVE_REPS))
    return [sorted(t)[len(t) // 2] for t in times]


def smem_phase() -> dict:
    """Phase 25, L9 (labs/smem_probe.py run): every size, OK exactly
    when its bytes are at or below the device's opt-in shared memory per
    block and the right word read, FAIL (refused) above it; then a small
    table's launch.  Per launched size its device ms and bound, and the
    kernel's and torch.take's device ms on the same table and index timed
    in turn (interleaved_ms); the plain version's host ms on config 3's
    entry mirror; and L8's trivial kernel against x * 2, timed in turn."""
    import torch

    from cpugpupathtracing_tpu_torch.labs import launch_probe as lp
    from cpugpupathtracing_tpu_torch.labs import smem_probe as sp

    dev = torch.device("cuda")
    optin = sp.optin_bytes(dev)
    reset_counts()
    rows = sp.run(dev, timed=True)
    launched = counts()
    if set(launched) - {"smem_probe", "sorts"}:
        raise AssertionError(f"smem: launched {launched}")
    for r in rows:
        if r["ok"] != (r["bytes"] <= optin):
            raise AssertionError(f"smem: {r['label']} ({r['bytes']} B) "
                                 f"{'OK' if r['ok'] else 'FAIL'} against "
                                 f"the {optin} B limit")
    # per launched size the kernel and torch.take on the same table and
    # index, interleaved round by round (medians)
    for r in rows:
        if r["ok"]:
            tab = torch.arange(r["words"], dtype=torch.int32, device=dev)
            idx = torch.full((1,), (r["words"] - 4) // 8, dtype=torch.int32,
                             device=dev)
            flat = idx.long() * 8 + 3
            r["ms_interleaved"], r["take_ms"] = interleaved_ms(
                (lambda: sp.smem_probe(tab, idx, two_d=r["two_d"]),
                 lambda: torch.take(tab, flat)))
        say("smem", **{k: (round(v, 5) if isinstance(v, float) else v)
                       for k, v in r.items()})
    mirror = next(r for r in rows if r["label"] == "config 3 entry mirror")
    tab = torch.arange(mirror["words"], dtype=torch.int32, device=dev)
    idx = torch.full((1,), (mirror["words"] - 4) // 8, dtype=torch.int32,
                     device=dev)
    plain = timed_plain(lambda: sp.smem_probe_reference(tab, idx))[1]
    call = cuda_ms(lambda: sp.smem_probe(tab, idx), 5)
    # L8's trivial kernel against x * 2, interleaved round by round
    x = torch.randn(lp.N, device=dev)
    l8 = interleaved_ms((lambda: lp.trivial(x), lambda: x * 2))
    say("smem_l8_retime", trivial_ms=l8[0], x2_ms=l8[1],
        ratio=l8[0] / l8[1], rounds=INTERLEAVE_ROUNDS, reps=INTERLEAVE_REPS)
    return dict(rows=rows, optin=optin, launches=launched["smem_probe"],
                mirror=mirror, library_ms=mirror["take_ms"], plain_ms=plain,
                call_ms=call, l8_retime=dict(trivial_ms=l8[0], x2_ms=l8[1]))


def probe_entries(launch: dict, smem: dict) -> list:
    """The kernels line's entries of L8 and L9."""
    from cpugpupathtracing_tpu_torch.labs import launch_probe as lp

    rows = {r["label"]: r for r in launch["rows"]}
    triv = rows["trivial"]
    m = smem["mirror"]
    return [{
        "name": "trivial", "route": "cuda",
        "source": "cpugpupathtracing_tpu_torch/csrc/probes.cu",
        "replaces": "tools/profile_tpu2.py:41, :53, :59",
        "launches": launch["launches"]["trivial"]
        + launch["launches"]["trivial2"],
        "max_abs_err": 0.0 if launch["exact"] else None,
        "ms": triv["ms"], "call_ms": triv["call_ms"],
        "host_ms": triv["host_ms"], "plain_ms": launch["plain_ms"],
        "bound_ms": 2 * 4 * lp.N / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": rows["x * 2 (library)"]["ms"],
        "cases": launch["rows"], "turns": launch["turns"],
    }, {
        "name": "smem_probe", "route": "cuda",
        "source": "cpugpupathtracing_tpu_torch/csrc/probes.cu",
        "replaces": "tools/smem_probe.py:53",
        "launches": smem["launches"], "max_abs_err": 0.0,
        "ms": m["ms"], "call_ms": smem["call_ms"],
        "plain_ms": smem["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": "bytes", "library_ms": smem["library_ms"],
        "words": m["words"], "optin_bytes": smem["optin"],
        "sizes": smem["rows"],
    }]


def brute_modes(scene, cam_cfg, settings, width, height,
                profile: bool) -> dict:
    """Phases [frame_brute] and [frame_comparison]: config 3 at 1920x1080
    in the BRUTE_FORCE and COMPARISON modes through Renderer.  A
    BRUTE_FORCE frame (trace_brute) makes one closest-hit launch of
    traverse_packet_slim and one morton5 sort per depth; a COMPARISON
    frame one closest-hit launch per depth for its left half
    (trace_brute) and a closest and a shadow any-hit launch per depth for
    its right half (trace_advanced), without sorts.  Every launch of one
    frame holds every SAMPLE_STRIDE-th lane against its plain version
    (traverse_main_path), then TIMED_FRAMES timed frames with every count
    from 0.  [compare_halves]: the first frame of each mode and one
    ADVANCED frame on the XLA route (CPUGPU_NO_MEGAKERNEL=1), all from a
    fresh Renderer: the COMPARISON frame's left width // 2 columns equal
    the BRUTE_FORCE frame's and its right columns the XLA frame's,
    bitwise.  Returns {run: (main-path entries, counts, numbers)}."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig, RenderMode
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    dev = torch.device("cuda")
    config = RenderConfig(width=width, height=height)
    depths = settings.max_ray_depth + 1
    runs = {"brute": (RenderMode.BRUTE_FORCE,
                      dict(traverse_packet_slim=depths, sorts=depths)),
            "comparison": (RenderMode.COMPARISON,
                           dict(traverse_packet_slim=3 * depths))}
    out, first = {}, {}
    for run, (mode, want) in runs.items():
        r = Renderer(scene, camera=cam_cfg, config=config,
                     settings=settings.replace(render_mode=mode), device=dev)
        reset_counts()
        r.render_frame()
        expect_counts(counts(), f"{run} frame from reset", **want)
        first[run] = r._accumulator.clone()
        energy = frame_checks(r, run, height, width)
        main_path = traverse_main_path(r.render_frame, f"{run} frame", 1)
        for mp in main_path:
            k = mp["launch"] - 1
            if run == "comparison":  # the left half's launches first
                mp["half"] = "left" if k < depths else "right"
                mp["depth"] = k if k < depths else (k - depths) // 2
        ms, traced, rate, got = timed_frames(r, f"{run} frames", profile,
                                             run, **want)
        ptf.check_status(dev)
        info = dict(ms_per_frame=ms, mrays_per_s=rate / 1e6,
                    traced_per_frame=traced,
                    b4_launches_per_frame=got[arm("traverse_packet_slim")]
                    / TIMED_FRAMES,
                    sorts_per_frame=got["sorts"] / TIMED_FRAMES,
                    mean_energy=energy)
        say(f"frame_{run}", width=width, height=height,
            frames=TIMED_FRAMES, **info,
            b4_ms_per_frame=sum(mp["ms"] for mp in main_path))
        for mp in main_path:
            say(f"{run}_l{mp['launch']}_{mp['kind']}", **mp)
        out[run] = (main_path, got, info)

    with environ(CPUGPU_NO_MEGAKERNEL="1"):
        rx = Renderer(scene, camera=cam_cfg, config=config,
                      settings=settings, device=dev)
        rx.render_frame()
    half = width // 2

    def cols(acc, lo, hi):
        return acc.reshape(height, width, 4)[:, lo:hi]

    diff = {}
    for side, lo, hi, ref in (("left", 0, half, first["brute"]),
                              ("right", half, width, rx._accumulator)):
        a, b = cols(first["comparison"], lo, hi), cols(ref, lo, hi)
        diff[side] = int((a.view(torch.int32) != b.view(torch.int32))
                         .any(dim=2).sum())
    say("compare_halves", left_differs_from_brute=diff["left"],
        right_differs_from_xla=diff["right"], half=half)
    if diff["left"] or diff["right"]:
        raise AssertionError(f"COMPARISON halves differ from the whole "
                             f"frames: {diff}")
    return out


def frame2(dev, profile: bool) -> dict:
    """Phases [scene2], [frame2] and [frame2_mega]: config 2 (the
    icosphere fallback, NAIVE_SPLIT on both meshes, one sphere light;
    ADVANCED, depth 5) at 1280x720 through Renderer on the whole-frame
    route (pt_frame) and the per-depth route (shade_extend +
    shadow_resolve per depth): phase 6's and 7's checks, each sampled
    launch's energy bitwise against its plain version, and the per-depth
    frame from reset equal to the whole-frame one.  Returns the
    whole-frame and per-depth main paths and counts."""
    import torch
    from cpugpupathtracing_tpu_torch import benchscenes

    scene, cam, settings, width, height, _ = \
        benchscenes.config2_path_tracer_midpoint()
    t0 = time.perf_counter()
    ds = scene.device(dev)
    torch.cuda.synchronize()
    tb = ds.table_bytes()
    say("scene2", seconds=round(time.perf_counter() - t0, 2),
        build_options=",".join(o.build_option.name for o in scene.objects
                               if o.mesh is not None),
        triangles=ds.num_triangles, node_rows=ds.pnodes.shape[0],
        leaf_rows=ds.pltris.shape[0], occl_node_rows=ds.poccl_nodes.shape[0],
        table_bytes=sum(tb.values()))
    small = sum(v for k, v in tb.items() if k.startswith("mk_"))
    whole, whole_counts, _ = frame_whole(scene, cam, settings, width, height,
                                         small, profile, phase="frame2")
    mega, mega_counts, _ = frame_mega(scene, cam, settings, width, height,
                                      small, profile, phase="frame2_mega")
    for k, mp in enumerate(whole + mega, 1):
        if mp["energy_bit_mismatches"]:
            raise AssertionError(f"config 2 launch {k}: "
                                 f"{mp['energy_bit_mismatches']} sampled "
                                 "lanes differ from the plain version")
    return dict(whole=whole, whole_counts=whole_counts, mega=mega,
                mega_counts=mega_counts)


def substeps4(scene, cam_cfg, settings, width, height, spp: int) -> dict:
    """Phase [substeps4]: config 4 (config 3's scene at spp samples a
    frame) through Renderer, one frame from reset as spp 1-spp sub-steps
    and one unrolled (CPUGPU_SPP_UNROLL=1): the same launches (2 pt_frame
    and 1 sort a sample), the same traced count, the mean radiance
    within 1e-5; then render_pipelined over TIMED_FRAMES frames with
    every count from 0 (no host sync between its frames)."""
    import numpy as np
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    dev = torch.device("cuda")
    config = RenderConfig(width=width, height=height, samples_per_frame=spp)
    runs = {}
    for run, unroll in (("substeps", "0"), ("unrolled", "1")):
        with environ(CPUGPU_SPP_UNROLL=unroll):
            r = Renderer(scene, camera=cam_cfg, config=config,
                         settings=settings, device=dev)
            if r._spp_substeps(spp) != (unroll == "0"):
                raise AssertionError(f"config 4 {run}: wrong sub-step rule")
            reset_counts()
            r.render_frame()
            expect_counts(counts(), f"config 4 {run} frame", pt_frame=2 * spp,
                          sorts=spp)
            runs[run] = (r, r.stats.traced_rays, r.radiance())
    (r, tr_s, img_s), (_, tr_u, img_u) = runs["substeps"], runs["unrolled"]
    diff = np.abs(img_s - img_u)
    over = int((diff > 1e-5 + 1e-5 * np.abs(img_u)).sum())
    if tr_s != tr_u or over:
        raise AssertionError(f"config 4: sub-steps traced {tr_s}, unrolled "
                             f"{tr_u}; {over} radiance values past 1e-5")
    torch.cuda.synchronize()
    reset_counts()
    total = r.render_pipelined(TIMED_FRAMES)
    got = counts()
    expect_counts(got, "config 4 render_pipelined",
                  pt_frame=2 * spp * TIMED_FRAMES, sorts=spp * TIMED_FRAMES)
    ptf.check_status(dev)
    info = dict(spp=spp, traced_per_frame=tr_s, traced_equal=True,
                radiance_max_abs_diff=float(diff.max()),
                radiance_bitwise=bool((diff == 0).all()),
                pipelined_frames=TIMED_FRAMES,
                pipelined_ms_per_frame=r.stats.frame_time_ms,
                pipelined_mrays_per_s=total / TIMED_FRAMES
                / r.stats.frame_time_ms / 1e3,
                pt_frame_launches_per_frame=got[arm("pt_frame")]
                / TIMED_FRAMES, mean_energy=r.mean_energy)
    say("substeps4", width=width, height=height, **info)
    return dict(info, counts=got)


def material_edit(scene, cam_cfg, settings, width, height) -> dict:
    """Phase [edit3]: one material edit (the ground's white to a green
    diffuse) between two config-3 frames through Renderer.set_material:
    the accumulator resets, the next frame runs on a new snapshot (2
    pt_frame launches and 1 sort, as every frame), and its accumulator
    and image equal, bitwise, those of a fresh Renderer on a scene built
    with the new material (one frame, reset, one frame).  The scenes
    share config 3's meshes and trees, so only snapshots are built; the
    new snapshot's build is timed."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models import materials as matlib
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    dev = torch.device("cuda")
    config = RenderConfig(width=width, height=height)
    green = matlib.Material.diffuse((0.6, 0.8, 0.6))

    r = Renderer(shared_config3(scene), camera=cam_cfg, config=config,
                 settings=settings, device=dev)
    r.render_frame()
    old = r.scene.device(dev)
    r.set_material(1, green)
    if r.num_accumulated != 0:
        raise AssertionError("a material edit did not reset")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = r.scene.device(dev)
    torch.cuda.synchronize()
    snapshot_s = time.perf_counter() - t0
    if new is old or torch.equal(new.mk_mats, old.mk_mats):
        raise AssertionError("the edit did not make a new snapshot")
    reset_counts()
    r.render_frame()
    expect_counts(counts(), "frame after the edit", pt_frame=2, sorts=1)
    edited = shared_config3(scene)
    edited.set_material(1, green)
    f = Renderer(edited, camera=cam_cfg, config=config, settings=settings,
                 device=dev)
    f.render_frame()
    f.reset()
    f.render_frame()
    same = (torch.equal(r._accumulator, f._accumulator)
            and bool((r.image_u32() == f.image_u32()).all())
            and r.stats.traced_rays == f.stats.traced_rays)
    info = dict(snapshot_s=snapshot_s, bitwise_fresh=same,
                traced=r.stats.traced_rays,
                mean_energy=frame_checks(r, "edit3", height, width))
    say("edit3", width=width, height=height, **info)
    if not same:
        raise AssertionError("the edited frame differs from a fresh "
                             "renderer's")
    return info


# the stats-panel keys of the JAX package's Renderer.metrics
METRIC_KEYS = {"fps", "frame_time_ms", "traced_rays", "total_traced_rays",
               "mrays_per_s", "accumulated_frames", "mean_energy", "paused",
               "objects"}
# the per-frame lines of cli --stats-json
STATS_KEYS = {"frame", "fps", "frame_ms", "traced_rays", "accumulated",
              "mean_energy"}


def shared_config3(scene, base=None):
    """A new config-3 Scene (own materials, so edits stay its own) that
    shares `scene`'s meshes and trees: only its snapshot is built."""
    from cpugpupathtracing_tpu_torch import benchscenes

    s = base if base is not None else benchscenes.config3_sah_dielectrics()[0]
    for ob, oa in zip(s.objects, scene.objects):
        ob.mesh, ob.blas = oa.mesh, oa.blas
    return s


def run_cli(args: list, what: str) -> tuple:
    """`python -m cpugpupathtracing_tpu_torch.cli` in a new process from the
    checkout's root: (its --stats-json lines, its scene-build seconds,
    wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cpugpupathtracing_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    m = re.search(r"scene ready in ([0-9.]+) s", proc.stderr)
    if m is None or any(set(ln) != STATS_KEYS for ln in lines):
        raise AssertionError(f"{what}: unexpected output\n{proc.stdout}"
                             f"{proc.stderr[-2000:]}")
    return lines, float(m.group(1)), wall


def http(viewer, path: str, payload=None):
    """GET (payload None) or POST a JSON payload to the viewer: (status,
    body bytes)."""
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{viewer.port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def frontends(scene, cam_cfg, settings, width, height, dev) -> dict:
    """Phase [frontends]: the port's front ends on config 3 at width x
    height.  The CLI (`python -m cpugpupathtracing_tpu_torch.cli --scene
    reference`, 3 frames, --stats-json, --checkpoint) twice in new
    processes: the second resumes (accumulated 4-6), the PNG decodes to
    the frame's size, and the saved accumulator equals, bitwise, an
    in-process Renderer's after 6 frames (2 pt_frame launches and 1 sort
    a frame); the scene build, the first frame (the kernels' load) and a
    steady frame timed apart.  The CLI in WHITTED mode on config 1's
    scene at 800x600 in process: 1 whitted_frame launch a frame.  A
    LiveViewer over the config-3 Renderer: GET /frame.png and
    /stats.json, POST /input (the camera moves, the accumulator resets)
    and /control set_material (the next frame equals a fresh renderer's
    on the edited scene, bitwise), serve_frames(3), and publish's ms.
    validate_frame passes on config 3 and raises FloatingPointError on
    the scene with a NaN albedo on the ground, the renderer's state
    unchanged; profile() writes a non-empty trace; metrics() has the JAX
    package's keys."""
    import numpy as np
    import torch
    from cpugpupathtracing_tpu_torch import cli
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models import materials as matlib
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer
    from cpugpupathtracing_tpu_torch.utils import image as imagelib
    from cpugpupathtracing_tpu_torch.utils.build import BUILD_ROOT
    from cpugpupathtracing_tpu_torch.viewer import LiveViewer

    out_dir = os.path.join(BUILD_ROOT, "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    ck = os.path.join(out_dir, "frontends.npz")
    png = os.path.join(out_dir, "frontends.png")
    for path in (ck, png):
        if os.path.exists(path):
            os.remove(path)
    flags = ["--scene", "reference", "--width", str(width), "--height",
             str(height), "--device", str(dev)]
    runs = []
    for k in range(2):
        lines, scene_s, wall = run_cli(
            flags + ["--frames", "3", "--stats-json", "--checkpoint", ck,
                     "--out", png], f"cli run {k + 1}")
        acc = [ln["accumulated"] for ln in lines]
        if acc != [3 * k + 1, 3 * k + 2, 3 * k + 3]:
            raise AssertionError(f"cli run {k + 1}: accumulated {acc}")
        runs.append(dict(wall_s=wall, scene_s=scene_s,
                         first_frame_ms=lines[0]["frame_ms"],
                         steady_frame_ms=lines[-1]["frame_ms"],
                         traced=[ln["traced_rays"] for ln in lines]))
    img = imagelib.read_png(png)
    if img.shape != (height, width, 4):
        raise AssertionError(f"cli PNG {img.shape}")
    with np.load(ck, allow_pickle=False) as data:
        saved = torch.from_numpy(data["accumulator"]).to(dev)
        saved_n = int(data["num_accumulated"])
    args = cli.parse_args(flags)
    s3, camera, config, settings3 = cli.frame_setup(args)
    if (camera, config, settings3) != (cam_cfg, RenderConfig(
            width=width, height=height), settings):
        raise AssertionError("cli --scene reference is not config 3")
    r = Renderer(shared_config3(scene, s3), camera=camera, config=config,
                 settings=settings3, device=dev)
    reset_counts()
    r.render(6)
    expect_counts(counts(), "six config-3 frames", pt_frame=12, sorts=6)
    resumed = saved_n == 6 and torch.equal(saved, r._accumulator)
    if not resumed:
        raise AssertionError("the CLI's resumed accumulator differs from "
                             "six in-process frames")

    # the CLI in WHITTED mode on config 1's scene, in process
    reset_counts()
    cli.main(["--scene", "whitted", "--mode", "whitted", "--width", "800",
              "--height", "600", "--frames", "2", "--device", str(dev),
              "--out", os.path.join(out_dir, "frontends_whitted.png")])
    expect_counts(counts(), "cli --mode whitted", whitted_frame=2)

    # the viewer over the config-3 renderer
    viewer = LiveViewer(r, port=0)
    viewer.start()
    try:
        r.render_frame()
        r.metrics()  # the scene tree's binary BVH, built once
        publish_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            viewer.publish()
            publish_ms.append((time.perf_counter() - t0) * 1e3)
        code, body = http(viewer, "/frame.png")
        png_bytes = len(body)
        with open(os.path.join(out_dir, "viewer.png"), "wb") as f:
            f.write(body)
        shot = imagelib.read_png(os.path.join(out_dir, "viewer.png"))
        code2, body2 = http(viewer, "/stats.json")
        stats = json.loads(body2)
        if code != 200 or shot.shape != (height, width, 4) or code2 != 200 \
                or not METRIC_KEYS <= set(stats) \
                or stats["accumulated_frames"] != 7:
            raise AssertionError(f"viewer GET: {code} {shot.shape} {code2} "
                                 f"{sorted(stats)}")
        z0 = r.camera.pos[2]
        code, body = http(viewer, "/input", {"key": "w", "dt": 0.1})
        moved = r.camera.pos[2] < z0 and r.num_accumulated == 0
        code2, body2 = http(viewer, "/control", {"set_material": {
            "index": 1, "albedo": [0.6, 0.8, 0.6]}})
        if code != 200 or code2 != 200 or not moved:
            raise AssertionError(f"viewer POST: {code} {body} {code2} "
                                 f"{body2}, moved {moved}")
        r.render_frame()
        edited = shared_config3(scene)
        edited.set_material(1, matlib.Material.diffuse((0.6, 0.8, 0.6)))
        f = Renderer(edited, camera=r.camera, config=config,
                     settings=settings3, device=dev)
        for _ in range(r._sample_counter - 1):
            f.render_frame()
        f.reset()
        f.render_frame()
        if not (torch.equal(r._accumulator, f._accumulator)
                and (r.image_u32() == f.image_u32()).all()):
            raise AssertionError("the viewer's edited frame differs from a "
                                 "fresh renderer's")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        viewer.serve_frames(3)
        serve_ms = (time.perf_counter() - t0) * 1e3 / 3
        expect_counts(counts(), "serve_frames(3)", pt_frame=6, sorts=3)
    finally:
        viewer.close()

    # validate_frame, clean and with a NaN albedo on the ground
    r.validate_frame()
    r.scene.set_material(1, matlib.Material.diffuse((math.nan, 0.8, 0.6)))
    before = (r._accumulator.clone(), r._pixels.clone(), r.num_accumulated,
              r._sample_counter, r.total_energy_received,
              r.stats.traced_rays)
    try:
        r.validate_frame()
    except FloatingPointError as e:
        raised = str(e)
    else:
        raise AssertionError("validate_frame passed a NaN albedo")
    after = (r._accumulator, r._pixels, r.num_accumulated,
             r._sample_counter, r.total_energy_received, r.stats.traced_rays)
    if not (torch.equal(before[0], after[0])
            and torch.equal(before[1], after[1])
            and before[2:] == after[2:]):
        raise AssertionError("validate_frame changed the state of a bad "
                             "frame")
    r.scene.set_material(1, matlib.Material.diffuse((0.6, 0.8, 0.6)))

    # profile and metrics
    prof_dir = os.path.join(out_dir, "profile")
    for name in os.listdir(prof_dir) if os.path.isdir(prof_dir) else ():
        os.remove(os.path.join(prof_dir, name))
    with r.profile(prof_dir):
        r.render_frame()
    traces = [os.path.getsize(os.path.join(prof_dir, n))
              for n in os.listdir(prof_dir)]
    metrics = r.metrics()
    if len(traces) != 1 or not traces[0] or set(metrics) != METRIC_KEYS:
        raise AssertionError(f"profile traces {traces}, metrics "
                             f"{sorted(metrics)}")
    info = dict(cli=runs, resumed_bitwise=resumed, publish_ms=publish_ms,
                serve_ms_per_frame=serve_ms, viewer_png_bytes=png_bytes,
                validate_nan=raised[:80], trace_bytes=traces[0],
                mrays_per_s=metrics["mrays_per_s"])
    say("frontends", width=width, height=height, **info)
    return info


def sharded(scene, cam_cfg, settings, width, height, dev) -> dict:
    """Phase [sharded]: maybe_initialize_distributed at world size 1
    through NCCL (a file:// rendezvous under build/), then
    render_frame_sharded on config 3 at width x height in both modes: each
    frame from zeros equals the Renderer's frame from reset bitwise
    (accumulator and pixels, gathered; traced), with 2 pt_frame launches
    and 1 sort a frame.  render_rank and trace_rank for d = 2 and 4, every
    rank in this process: the pixels-mode slices put together are the
    frame, and 2 frames of 2 spp the Renderer's (1-spp sub-steps); the
    samples-mode sum in rank order is a d-spp unrolled frame; bitwise.
    The ms a frame of the sharded call (both modes) and of the Renderer,
    in turns."""
    import torch
    import torch.distributed as dist
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models import camera as camlib
    from cpugpupathtracing_tpu_torch.models.renderer import (
        Renderer,
        accumulate,
    )
    from cpugpupathtracing_tpu_torch.parallel import distributed, sharding
    from cpugpupathtracing_tpu_torch.utils.build import BUILD_ROOT

    rdv = os.path.join(BUILD_ROOT, "chip_smoke", "rendezvous")
    os.makedirs(os.path.dirname(rdv), exist_ok=True)
    if os.path.exists(rdv):
        os.remove(rdv)
    t0 = time.perf_counter()
    with environ(CPUGPU_DISTRIBUTED="1"):
        multi = distributed.maybe_initialize_distributed(
            f"file://{rdv}", 1, 0, device=str(dev))
    init_s = time.perf_counter() - t0
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if multi or not dist.is_initialized() or dist.get_backend() != backend:
        raise AssertionError(f"no one-rank {backend} process group")
    try:
        mesh = sharding.make_mesh(1, device=dev)
        config = RenderConfig(width=width, height=height)
        n = width * height
        ds = scene.device(dev)
        cam = camlib.to_arrays(cam_cfg, dev)
        ref = Renderer(scene, camera=cam_cfg, config=config,
                       settings=settings, device=dev)
        ref.render_frame()
        got = {}
        for mode in sharding.SHARD_MODES:
            acc = torch.zeros(sharding.accumulator_shape(width, height, 1,
                                                         mode),
                              dtype=torch.float32, device=dev)
            torch.cuda.synchronize()
            reset_counts()
            acc, pix, traced, _ = sharding.render_frame_sharded(
                ds, cam, acc, 0, settings, width, height, 1, config.seed,
                mesh, mode)
            expect_counts(counts(), f"sharded {mode} frame", pt_frame=2,
                          sorts=1)
            same = (int(traced) == ref.stats.traced_rays
                    and (sharding.gather_frame(acc, width, height, mode)
                         == ref._accumulator.cpu().numpy()).all()
                    and (sharding.gather_frame(pix, width, height, mode)
                         == ref._pixels.cpu().numpy()).all())
            if not same:
                raise AssertionError(f"sharded {mode} frame differs from "
                                     "the Renderer's")
            got[f"{mode}_bitwise"] = True

        def rank_frames(spp, frames, d):
            """render_rank for every rank of d: the accumulator put
            together row-major and the traced count of the last frame."""
            accs = [torch.zeros((n // d, 4), device=dev) for _ in range(d)]
            for f in range(frames):
                tr = 0
                for r in range(d):
                    accs[r], _, t, _ = sharding.render_rank(
                        ds, cam, accs[r], f * spp, settings, width, height,
                        spp, config.seed, r, d)
                    tr += int(t)
            return (sharding.gather_frame(torch.cat(accs), width, height,
                                          "pixels"), tr)

        ref2 = Renderer(scene, camera=cam_cfg,
                        config=config.replace(samples_per_frame=2),
                        settings=settings, device=dev)
        ref2.render_frame()
        ref2.render_frame()
        # every rank of d in this process
        for d in (2, 4):
            acc, tr = rank_frames(1, 1, d)
            ok_p = ((acc == ref._accumulator.cpu().numpy()).all()
                    and tr == ref.stats.traced_rays)
            acc, tr = rank_frames(2, 2, d)
            ok_p = bool(ok_p and (acc == ref2._accumulator.cpu().numpy()).all()
                        and tr == ref2.stats.traced_rays)
            with environ(CPUGPU_SPP_UNROLL="1"):
                unrolled = Renderer(scene, camera=cam_cfg,
                                    config=config.replace(
                                        samples_per_frame=d),
                                    settings=settings, device=dev)
                unrolled.render_frame()
            parts = [sharding.trace_rank(ds, cam, settings, width, height, 1,
                                         config.seed, 0, r, d, "samples")
                     for r in range(d)]
            acc, pix, _ = accumulate(
                torch.zeros((n, 4), device=dev),
                sharding.ordered_sum([e for e, _ in parts]), d, settings)
            ok_s = (torch.equal(acc, unrolled._accumulator)
                    and torch.equal(pix, unrolled._pixels)
                    and sum(int(t) for _, t in parts)
                    == unrolled.stats.traced_rays)
            if not (ok_p and ok_s):
                raise AssertionError(f"d = {d}: pixels bitwise {ok_p}, "
                                     f"samples bitwise {ok_s}")
            got[f"d{d}_bitwise"] = True

        # ms a frame in turns: sharded pixels, Renderer, sharded samples
        accs = {m: torch.zeros(sharding.accumulator_shape(width, height, 1,
                                                          m),
                               dtype=torch.float32, device=dev)
                for m in sharding.SHARD_MODES}
        times = {"pixels": [], "renderer": [], "samples": []}
        for k in range(TIMED_FRAMES):
            for what in times:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if what == "renderer":
                    ref.render_frame()
                else:
                    accs[what], _, tr, _ = sharding.render_frame_sharded(
                        ds, cam, accs[what], 1 + k, settings, width, height,
                        1, config.seed, mesh, what)
                    int(tr)
                torch.cuda.synchronize()
                times[what].append((time.perf_counter() - t0) * 1e3)
    finally:
        dist.destroy_process_group()
    info = dict(init_s=init_s, **got,
                **{f"{k}_ms": v for k, v in times.items()})
    say("sharded", width=width, height=height, **info)
    return info


# bench.py's keys (bench.py:304-325; :171-185 under --devices)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA = {"config", "pct_of_kernel_floor", "frame_ms", "rays_per_frame",
               "resolution", "frames_timed", "scene_build_s", "first_frame_s",
               "compiled_parity_ok", "compiled_parity_instanced_ok",
               "compiled_parity_whitted_ok", "compiled_parity_ptframe_ok",
               "device", "bench_flags"}
BENCH_DEVICES_EXTRA = {"config", "devices", "shard_mode", "frames_timed",
                       "frame_ms", "bench_flags"}
GATE_FIELD = {"parity": "compiled_parity_ok",
              "instanced": "compiled_parity_instanced_ok",
              "whitted": "compiled_parity_whitted_ok",
              "ptframe": "compiled_parity_ptframe_ok"}
# (phase, arguments, config, the gates that apply (None: the --devices
# line, which has none), the kernel the timed frames launch, its launches
# a frame, frames launched: the timed ones, and under --devices the first)
BENCH_RUNS = (
    ("bench_config3", ["--config", "3", "1920", "1080", "16"], 3,
     ("parity", "instanced", "ptframe"), "pt_frame", 2, 16),
    ("bench_config1", ["--config", "1", "800", "600", "64"], 1,
     ("parity", "instanced", "whitted"), "whitted_frame", 1, 64),
    ("bench_config5", ["--config", "5", "1280", "720", "8"], 5,
     ("parity", "instanced", "ptframe"), "pt_frame", 2, 8),
    ("bench_devices1", ["--config", "3", "--devices", "1", "1920", "1080",
                        "8"], 3, None, "pt_frame", 2, 9),
)


# one new process runs the lines in turn through bench_torch.main, as
# `python bench_torch.py <arguments>` runs one: the interpreter's start and
# the card's initialisation are paid once, not once a line.  The garbage a
# line leaves is collected before the next, which would otherwise pay for
# it in its timed frames (config 5 third: 12.5 ms a frame without, 6.7
# with, one run each on an H100)
BENCH_BODY = (
    "import gc, json, sys, time\n"
    "import bench_torch\n"
    "for args in json.loads(sys.argv[1]):\n"
    "    gc.collect()\n"
    "    t0 = time.perf_counter()\n"
    "    bench_torch.main(args)\n"
    "    print('BENCH_WALL', time.perf_counter() - t0, file=sys.stderr,\n"
    "          flush=True)\n"
)


def bench() -> None:
    """Phase [bench]: bench_torch.py, the port's bench.py, in one new
    process from the checkout's root, bench_torch.main once a line: config
    3 at 1920x1080 (16 frames), config 1 at 800x600 (64), config 5 at
    1280x720 (8) and config 3 under --devices 1 (8).  The process exits 0
    and prints one line a run with bench.py's keys, value > 0,
    pct_of_kernel_floor null, every gate that applies true and the others
    null, the card's name in `device`; each run's BENCH_DETAIL line on
    stderr (unrounded figures, the gates' dicts) counts only the config's
    frame kernel in the timed frames, launches a frame times frames.
    Prints each run's line, its detail and its seconds in the process,
    then the process's seconds."""
    import torch

    card = torch.cuda.get_device_name(0)
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", BENCH_BODY,
         json.dumps([run[1] for run in BENCH_RUNS])],
        capture_output=True, text=True, timeout=400, cwd=root)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench: exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    err = proc.stderr.splitlines()
    dets = [ln for ln in err if ln.startswith("BENCH_DETAIL ")]
    walls = [float(ln.split()[1]) for ln in err if ln.startswith("BENCH_WALL ")]
    if not len(lines) == len(dets) == len(walls) == len(BENCH_RUNS):
        raise AssertionError(f"bench: unexpected output\n{proc.stdout}"
                             f"{proc.stderr[-2000:]}")
    for run, line, det, run_s in zip(BENCH_RUNS, lines, dets, walls):
        phase, _, config, gates, kernel, per_frame, frames = run
        rec = json.loads(line)
        det = json.loads(det.split(" ", 1)[1])
        extra = rec["extra"]
        want = BENCH_EXTRA if gates is not None else BENCH_DEVICES_EXTRA
        if set(rec) != BENCH_KEYS or set(extra) != want:
            raise AssertionError(f"{phase}: keys {sorted(rec)} / "
                                 f"{sorted(extra)}")
        if not rec["value"] > 0 or extra["config"] != config:
            raise AssertionError(f"{phase}: {rec}")
        if gates is not None:
            got = {g: extra[f] for g, f in GATE_FIELD.items()}
            if got != {g: (True if g in gates else None) for g in GATE_FIELD}:
                raise AssertionError(f"{phase}: gates {got}, expected "
                                     f"{gates} true")
            if extra["pct_of_kernel_floor"] is not None \
                    or card not in extra["device"]:
                raise AssertionError(f"{phase}: {extra}")
        ran = det["launches"]
        if (any(not k.startswith(kernel) for k in ran)
                or sum(ran.values()) != per_frame * frames):
            raise AssertionError(f"{phase}: launched {ran}, expected "
                                 f"{per_frame * frames} of {kernel}")
        say(phase, run_s=round(run_s, 1), line=line)
        say(f"{phase}_detail", **det)
    say("bench", process_s=round(wall, 1), runs_s=round(sum(walls), 1))


def route_entry(name: str, kernel: str, source: str, replaces: str,
                launches: int, path: list, keys: tuple) -> dict:
    """A kernels-line entry for one kernel's launches on a route added in
    phases 11c-11g: per launch of one frame its ms (device), call_ms and
    bound, averaged over the frame's launches; plain_ms, the plain
    version's time on the sampled lanes of a launch, averaged likewise;
    max_abs_err, the largest over the sampled lanes; bound_by of the
    launch with the largest bound; and every launch (main_path)."""
    k = len(path)
    top = max(path, key=lambda mp: mp["bound_ms"])
    return {
        "name": name,
        "route": "cuda",
        "source": f"cpugpupathtracing_tpu_torch/csrc/{source}",
        "replaces": f"cpugpupathtracing_tpu/ops/{replaces}",
        "launches": launches,
        "max_abs_err": max(mp["max_abs_err"] for mp in path),
        "ms": sum(mp["ms"] for mp in path) / k,
        "call_ms": sum(mp["call_ms"] for mp in path) / k,
        "plain_ms": sum(mp["plain_ms"] for mp in path) / k,
        "bound_ms": sum(mp["bound_ms"] for mp in path) / k,
        "bound_by": top["bound_by"],
        "library_ms": None,
        "kernel": kernel,
        "plain_lanes": path[0]["sampled_lanes"],
        "main_path": [{key: mp[key] for key in keys if key in mp}
                      for mp in path],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cpugpupathtracing_tpu_torch import benchscenes
    from cpugpupathtracing_tpu_torch.config import CameraConfig, RenderConfig
    from cpugpupathtracing_tpu_torch.models import camera as camlib
    from cpugpupathtracing_tpu_torch.models import integrators
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.utils import rng as rnglib

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi()
    print(smi, flush=True)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build
    ptf.build()
    ptxas = ptxas_lines(ptf.build_log)
    say("build", seconds=round(ptf.build_seconds, 2),
        units=",".join(f"csrc/{u}" for u, _ in ptf._UNITS))
    for ln in ptxas:
        print("  ptxas:", ln, flush=True)
    # L6's arms that are two instruction orders of one walk: which of them
    # compiled to the same machine code
    say("sass", lab_ablate_kernel_identical=sass_twins(
        os.path.join(ptf.build_dir, "libkernel_lab.so"),
        "lab_ablate_kernel"))

    # phases 3-17: the plain 64-col arms (CPUGPU_SMEMTREE=0); the node-
    # table layouts, the default among them, follow in phases 20-21
    plain_tables = contextlib.ExitStack()
    plain_tables.enter_context(environ(CPUGPU_SMEMTREE="0"))

    # 3. scene
    scene, cam_cfg, settings, width, height, _ = \
        benchscenes.config3_sah_dielectrics()
    t0 = time.perf_counter()
    ds = scene.device(dev)
    torch.cuda.synchronize()
    tb = ds.table_bytes()
    say("scene", seconds=round(time.perf_counter() - t0, 2),
        node_rows=ds.pnodes.shape[0], leaf_rows=ds.pltris.shape[0],
        occl_node_rows=ds.poccl_nodes.shape[0],
        occl_leaf_rows=ds.poccl_ltris.shape[0],
        table_bytes=sum(tb.values()),
        **{f"{k}_bytes": v for k, v in tb.items() if k.startswith("p")})
    small_bytes = sum(v for k, v in tb.items() if k.startswith("mk_"))

    # 4. kernel vs plain on 8192 lanes of the blocked camera order
    o, d, pix = middle_lanes(cam_cfg, width, height, dev)
    st = rnglib.seed_lanes(pix, 0, salt=RenderConfig().seed)
    rays = columns(o, d)
    kw = integrators.frame_kwargs(ds, settings)
    depths = settings.max_ray_depth + 1

    *out_k, it_k = ptf.pt_frame(*ds.tables(), rays, st, depths=depths,
                                count_iters=True, **kw)
    e_k, s_k, tr_k = out_k
    it_k = dict(zip(ptf.COUNTERS, (int(v) for v in it_k)))
    idx = torch.arange(CHECK_LANES, dtype=torch.int32, device=dev)
    s_sp, res_sp = integrators.trace_advanced_frame(ds, settings, o, d, st,
                                                    idx=idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e_p, s_p, tr_p = plain(ptf, ds.tables(), rays, st, depths=depths, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ptf.check_status(dev)
    split_same = bool(torch.equal(e_k, res_sp.energy)) and \
        int(tr_k) == int(res_sp.traced_rays)
    if not split_same:
        raise AssertionError("split-span kernel run differs from the single "
                             "span")
    if int(tr_k) != int(tr_p):
        raise AssertionError(f"traced: kernel {int(tr_k)} vs plain "
                             f"{int(tr_p)}")
    flips, dmax, dmean = contract(e_p, e_k, "kernel vs plain")
    hk = ptf.closest_hit(ds.pnodes, ds.pltris, ds.proots, rays)
    hp = ptf.closest_hit_reference(ds.pltris, rays)
    # t, triangle id, object and flat normal, compared as bits
    bad = torch.zeros_like(hk[1], dtype=torch.bool)
    for a_, b_ in zip(hk, hp):
        bad |= a_.view(torch.int32) != b_.view(torch.int32)
    mism = int(bad.sum())
    if mism:
        raise AssertionError(f"{mism} closest hits differ from brute force")
    pt_ms = kernel_ms(lambda: ptf.pt_frame(*ds.tables(), rays, st,
                                           depths=depths, **kw),
                      "pt_frame_kernel")
    b_ms, b_by = bound_ms(it_k, CHECK_LANES * lane_bytes(False, False),
                          small_bytes)
    refill = check_refill(ds, settings, rays, st, kw, (e_k, s_k, tr_k))
    say("check_refill", **refill)
    say("check", lanes=CHECK_LANES, depths=depths, traced_kernel=int(tr_k),
        traced_plain=int(tr_p), traced_split=int(res_sp.traced_rays),
        split_bitwise=split_same, flip_share=flips, max_abs_err=dmax,
        mean_err=dmean, hit_mismatches=mism,
        hits=int((hk[1] >= 0).sum()), state_equal_share=float(
            (s_k == s_p).float().mean()),
        iters=it_k, kernel_ms=pt_ms["ms"], call_ms=pt_ms["call_ms"],
        plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by)

    # the camera lanes whose hit the conservative slab margin changed
    c2_lanes("c2_config3", ds, cam_cfg, width, height)

    # 5. the per-depth kernels and route on the same lanes
    mega = check_mega(ds, settings, o, d, st, (e_k, s_k, int(tr_k)),
                      small_bytes)

    # 6. frame (whole-frame route)
    profile = "--profile" in sys.argv[1:]
    main_path, frame_counts, _ = frame_whole(
        scene, cam_cfg, settings, width, height, small_bytes, profile)

    # 7. frame_mega (per-depth route)
    mega_path, mega_counts, _ = frame_mega(
        scene, cam_cfg, settings, width, height, small_bytes, profile)

    # 8. traverse_packet_slim on the config-3 check lanes
    trav = check_traverse(ds, o, d)

    # 9. whitted_frame on 8192 config-1 lanes
    scene1, cam1, settings1, width1, height1, _ = benchscenes.config1_whitted()
    ds1 = scene1.device(dev)
    cam1_a = camlib.to_arrays(cam1, dev)
    lo1 = width1 * height1 // 2 - CHECK_LANES // 2
    lane1 = torch.arange(lo1, lo1 + CHECK_LANES, dtype=torch.int64,
                         device=dev)
    bs1 = camlib.block_shape(width1, height1)
    if bs1 is not None:
        o1, d1, pix1 = camlib.blocked_lane_rays(cam1_a, lane1, width1,
                                                height1, *bs1)
    else:
        (o1, d1), pix1 = camlib.lane_rays(cam1_a, lane1, width1,
                                          height1), lane1
    st1 = rnglib.seed_lanes(pix1, 0, salt=RenderConfig().seed)
    whit = check_whitted(ds1, settings1, o1, d1, st1)

    # 10. frame_whitted (config 1, whole-frame Whitted kernel)
    whit_path, whit_counts = frame_whitted(scene1, cam1, settings1, width1,
                                           height1, profile)

    # 11. frame_whitted_mesh (WHITTED on config 3's scene, trace_whitted)
    mesh_path, mesh_counts = frame_whitted_mesh(
        scene, cam_cfg, settings1, width, height, profile)

    # 11a-b. the XLA integrator on config 3: AOVs off and on, the views
    xla_path, xla_counts, _ = frame_xla(scene, cam_cfg, settings, width,
                                        height, profile)
    frame_views(scene, cam_cfg, settings, width, height, profile)

    # 11c-g. the BRUTE_FORCE and COMPARISON modes on config 3 (B4 on every
    # scene query), config 2 on both ADVANCED routes, config 4's
    # sub-steps, and a live material edit on config 3
    brute = brute_modes(scene, cam_cfg, settings, width, height, profile)
    cfg2 = frame2(dev, profile)
    scene4, cam4, settings4, width4, height4, _ = \
        benchscenes.config4_variance_reduction(CONFIG4_SPP)
    for ob, oa in zip(scene4.objects, scene.objects):
        ob.mesh, ob.blas = oa.mesh, oa.blas  # config 3's trees
    path4, counts4, _ = frame_whole(scene4, cam4, settings4, width4, height4,
                                    small_bytes, profile, phase="frame4",
                                    spp=CONFIG4_SPP)
    sub4 = substeps4(scene4, cam4, settings4, width4, height4, CONFIG4_SPP)
    material_edit(scene, cam_cfg, settings, width, height)

    # 11g-h. the front ends (the CLI in new processes with its checkpoint,
    # the viewer, validate_frame, profile, metrics) and render_frame_sharded
    # on config 3 (NCCL at one rank; d = 2 and 4 rank by rank)
    frontends(scene, cam_cfg, settings, width, height, dev)
    sharded(scene, cam_cfg, settings, width, height, dev)

    # 11i. the XLA walks: configs 2-4 on the packet route; config 3 on the
    # wide, skip and binary walks (check lanes against brute force, one
    # 1080p frame each), config 5 refit on the wide and skip walks, one
    # BVH_DEPTH frame on the binary walk
    walks(scene, cam_cfg, settings, width, height, dev, scene4)

    # 12-17. config 5: the scene (flattened and object-space), the
    # instance arms on 8192 lanes and the refit, the three routes, the
    # routes' frames compared, one WHITTED frame on the instance arm
    s5 = scene5(dev)
    c2_lanes("c2_config5", s5["flat"]["ds"], s5["cam"], s5["width"],
             s5["height"])
    inst = check_inst(s5, dev)
    paths5, counts5 = {}, {}
    for phase in FRAME5_ROUTES:
        paths5[phase], counts5[phase], _ = frame5(s5, phase, profile)
    compare_routes5(s5)
    whit5_path, whit5_counts = whitted5(s5)

    # 17a-b. B4's count_depth arm on the check lanes of config 3 and of
    # config 5's object-space scene; config 5 on the XLA route with AOVs
    o5, d5, _ = middle_lanes(s5["cam"], s5["width"], s5["height"], dev)
    depth_chk = check_depth([("plain", ds, o, d),
                             ("inst", s5["obj"]["ds"], o5, d5)])
    aov5_path, aov5_counts, _ = frame5_aov(s5, profile)

    # 17c-d. scenes no kernel route takes: a mesh light over the light
    # table (the tests' scene at 1920x1080) and config 1 in ADVANCED mode
    depths = settings.max_ray_depth + 1
    frame_xla_scene(
        "frame_meshlight", meshlight_scene(),
        CameraConfig(pos=(0.05, 0.5, 7.0), aspect=width / height), settings,
        width, height, dict(traverse_packet_slim=2 * depths, sorts=depths),
        profile)
    frame_xla_scene("frame_meshless", scene1, cam1, settings, width1,
                    height1, {}, profile)

    # 17e-f. the traversal labs L1-L4, L6 and L7 on config 3's bounce fan:
    # every arm on the check lanes against its plain version, then the fan
    # at full width, one launch per arm
    from cpugpupathtracing_tpu_torch.labs import bounce_fan
    fan = bounce_fan.make_fan(dev, width, height, scene=scene)
    say("lab_fan", **fan.info)
    lab_chk = check_labs(fan)
    lab_rows = labs(fan)
    # 17g-h. the floor probe L5 on the fan's lanes (check lanes, then the
    # whole fan at K = 2000)
    floor_chk = check_floor(fan)
    floor_rows = floor(fan)
    del fan
    plain_tables.close()

    # 20-21. the node-table layouts on config 3 (both routes, the check
    # lanes, the traversal's main paths) and on config 5 flattened
    lay3 = layouts3(scene, cam_cfg, settings, settings1, width, height, o, d,
                    st, (e_k, s_k, tr_k))
    ref5: dict = {}
    lay5 = layouts5(s5, LAYOUT5_RUNS, ref5)

    # 22-23. the leaf-side and occlusion flags on config 3 (the check
    # lanes, the routes the gate allows, B4 over the any-hit tree) and on
    # config 5 flattened
    with frame_count(LEAF_FRAMES):
        leaf = leaf3(scene, cam_cfg, settings, width, height, o, d, st,
                     (e_k, s_k, tr_k), lay3["ref_frames"])
        leaf5 = layouts5(s5, LEAF5_RUNS, ref5, phase="leaf5", profile=False)

    # 24-25. the launch and shared-memory probes L8, L9 (their ms are
    # busy_ms; the profiler's beside them, None where it saw no launch)
    launch_res = launch_probe(ds)
    smem_res = smem_phase()

    # 26. bench_torch.py in a new process: configs 3, 1, 5 and --devices 1,
    # each line with bench.py's keys and every gate that applies true
    bench()

    # 18. kernels line, one clock per field: ms (device time per launch,
    # launch_ms), call_ms (CUDA events around the wrapper calls,
    # wrapper_ms and cuda_ms), plain_ms, bound_ms and
    # max_abs_err of each kernel's 8192-lane check (check_lanes;
    # traverse_packet_slim's closest-hit query); per main-path launch
    # (main_path) its lanes, ms, bound and the error of its sampled lanes;
    # launches from each kernel's main path (the timed frames of its route)
    kernels = [{
        "name": "pt_frame",
        "route": "cuda",
        "source": "cpugpupathtracing_tpu_torch/csrc/pt_frame.cu",
        "replaces": "cpugpupathtracing_tpu/ops/pt_frame_kernel.py:419",
        "launches": frame_counts["pt_frame"],
        "max_abs_err": dmax,
        "ms": pt_ms["ms"],
        "call_ms": pt_ms["call_ms"],
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "check_lanes": CHECK_LANES,
        "check_refill": refill,
        "main_path": [{key: mp[key] for key in (
            "lanes", "depths", "ms", "call_ms", "bound_ms", "bound_by",
            "lane_share",
            "sampled_lanes", "max_abs_err")} for mp in main_path],
    }]
    for name, line in (("shade_extend", 1713), ("shadow_resolve", 1847)):
        m = mega[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "cpugpupathtracing_tpu_torch/csrc/megakernel.cu",
            "replaces": f"cpugpupathtracing_tpu/ops/megakernel.py:{line}",
            "launches": mega_counts[name],
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"],
            "call_ms": m["call_ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound"][0],
            "bound_by": m["bound"][1],
            "library_ms": None,
            "check_lanes": CHECK_LANES,
            "main_path": [{key: mp[key] for key in (
                "depth", "lanes", "live", "lane_share", "longest", "ms",
                "call_ms", "bound_ms", "bound_by", "sampled_lanes",
                "max_abs_err")} for mp in mega_path if mp["name"] == name],
        })
    tq = trav["closest"]
    kernels.append({
        "name": "traverse_packet_slim",
        "route": "cuda",
        "source": "cpugpupathtracing_tpu_torch/csrc/traverse.cu",
        "replaces": "cpugpupathtracing_tpu/ops/traverse_packet_slim.py:1485",
        "launches": mesh_counts["traverse_packet_slim"],
        "max_abs_err": tq["max_abs_err"],
        "ms": tq["ms"],
        "call_ms": tq["call_ms"],
        "plain_ms": tq["plain_ms"],
        "bound_ms": tq["bound"][0],
        "bound_by": tq["bound"][1],
        "library_ms": None,
        "check_lanes": CHECK_LANES,
        "check_any_hit": {q: {k: v[k] for k in ("ms", "call_ms", "plain_ms",
                                                "mismatches")}
                          | {"bound_ms": v["bound"][0]}
                          for q, v in trav.items() if q != "closest"},
        "main_path": [{key: mp[key] for key in (
            "depth", "kind", "lanes", "active", "ms", "call_ms", "bound_ms",
            "bound_by", "sampled_lanes", "max_abs_err")} for mp in mesh_path],
    })
    kernels.append({
        "name": "whitted_frame",
        "route": "cuda",
        "source": "cpugpupathtracing_tpu_torch/csrc/whitted.cu",
        "replaces": "cpugpupathtracing_tpu/ops/whitted_kernel.py:364",
        "launches": whit_counts["whitted_frame"],
        "max_abs_err": whit["max_abs_err"],
        "ms": whit["ms"],
        "call_ms": whit["call_ms"],
        "plain_ms": whit["plain_ms"],
        "bound_ms": whit["bound"][0],
        "bound_by": whit["bound"][1],
        "library_ms": None,
        "check_lanes": CHECK_LANES,
        "check_masks": whit["masks"],
        "main_path": [{key: mp[key] for key in (
            "lanes", "depths", "ms", "call_ms", "bound_ms", "bound_by",
            "checked_lanes", "max_abs_err", "per_depth", "all_miss_ms",
            "glue_launches_per_frame", "waves")} for mp in whit_path],
    })
    # the instance arms: their 8192-lane check on config 5's object-space
    # scene, launches from config 5's object-space route (B4: from the
    # config-5 WHITTED frame)
    for name, src, line in (
            ("shade_extend_inst", "megakernel.cu", "megakernel.py:1713"),
            ("shadow_resolve_inst", "megakernel.cu", "megakernel.py:1847"),
            ("traverse_packet_slim_inst", "traverse.cu",
             "traverse_packet_slim.py:1485")):
        m = inst[name]
        if name == "traverse_packet_slim_inst":
            launches = whit5_counts["traverse_packet_slim_inst"]
            path = [{key: mp[key] for key in (
                "depth", "kind", "lanes", "active", "ms", "call_ms",
                "bound_ms", "bound_by", "sampled_lanes", "mismatches")}
                for mp in whit5_path]
        else:
            launches = counts5["frame5_inst"][name]
            path = [{key: mp[key] for key in (
                "launch", "lanes", "live", "lane_share", "longest", "ms",
                "call_ms", "bound_ms", "bound_by", "sampled_lanes",
                "max_abs_err")}
                for mp in paths5["frame5_inst"] if mp["name"] == name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"cpugpupathtracing_tpu_torch/csrc/{src}",
            "replaces": f"cpugpupathtracing_tpu/ops/{line}",
            "launches": launches,
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"],
            "call_ms": m["call_ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound"][0],
            "bound_by": m["bound"][1],
            "library_ms": None,
            "check_lanes": CHECK_LANES,
            "main_path": path,
        })
    # B4's count_depth arms: their check lanes (check_depth), launches
    # and sampled main-path lanes from config 3 (plain arm) and config 5
    # (instance arm) on the XLA route with AOVs
    for name, arm, launches, path in (
            ("traverse_packet_slim_depth", "plain",
             xla_counts["traverse_packet_slim_depth"], xla_path),
            ("traverse_packet_slim_inst_depth", "inst",
             aov5_counts["traverse_packet_slim_inst_depth"], aov5_path)):
        m = depth_chk[f"{arm}_closest"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "cpugpupathtracing_tpu_torch/csrc/traverse.cu",
            "replaces": "cpugpupathtracing_tpu/ops/traverse_packet_slim.py"
                        ":1485",
            "launches": launches,
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"],
            "call_ms": m["call_ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound"][0],
            "bound_by": m["bound"][1],
            "library_ms": None,
            "check_lanes": CHECK_LANES,
            "check_any_hit": {k: depth_chk[f"{arm}_any"][k] for k in (
                "ms", "call_ms", "plain_ms", "mismatches")}
            | {"bound_ms": depth_chk[f"{arm}_any"]["bound"][0]},
            "main_path": [{key: mp[key] for key in (
                "launch", "lanes", "active", "ms", "call_ms", "bound_ms",
                "bound_by", "sampled_lanes", "max_abs_err", "mismatches")}
                for mp in path if mp["count_depth"]],
        })
    # the routes of phases 11c-e (plain arms: their counts' keys are the
    # wrappers' names): B4 in the BRUTE_FORCE and COMPARISON frames,
    # B1-B3 on config 2, B1 on config 4 (its sub-stepped frames)
    b4_keys = ("launch", "depth", "half", "kind", "lanes", "active", "ms",
               "call_ms", "plain_ms", "bound_ms", "bound_by",
               "sampled_lanes", "max_abs_err", "mismatches", "lane_share")
    for run in ("brute", "comparison"):
        path, got, _ = brute[run]
        kernels.append(route_entry(
            f"traverse_packet_slim_{run}", "traverse_packet_slim",
            "traverse.cu", "traverse_packet_slim.py:1485",
            got["traverse_packet_slim"], path, b4_keys))
    b1_keys = ("lanes", "depths", "ms", "call_ms", "plain_ms", "bound_ms",
               "bound_by", "lane_share", "sampled_lanes", "max_abs_err",
               "energy_bit_mismatches")
    mega_keys = ("depth", "lanes", "live", "lane_share", "longest", "ms",
                 "call_ms", "plain_ms", "bound_ms", "bound_by",
                 "sampled_lanes", "max_abs_err", "energy_bit_mismatches")
    kernels.append(route_entry(
        "pt_frame_config2", "pt_frame", "pt_frame.cu",
        "pt_frame_kernel.py:419", cfg2["whole_counts"]["pt_frame"],
        cfg2["whole"], b1_keys))
    for name, line in (("shade_extend", 1713), ("shadow_resolve", 1847)):
        kernels.append(route_entry(
            f"{name}_config2", name, "megakernel.cu",
            f"megakernel.py:{line}", cfg2["mega_counts"][name],
            [mp for mp in cfg2["mega"] if mp["name"] == name], mega_keys))
    kernels.append(route_entry(
        "pt_frame_config4", "pt_frame", "pt_frame.cu",
        "pt_frame_kernel.py:419", counts4["pt_frame"], path4, b1_keys)
        | {"pipelined": {k: sub4[k] for k in (
            "pipelined_frames", "pipelined_ms_per_frame",
            "pipelined_mrays_per_s", "pt_frame_launches_per_frame")}})
    kernels += variant_entries(lay3, lay5)
    kernels += leaf_entries(leaf, leaf5)
    kernels += lab_entries(lab_chk, lab_rows)
    kernels.append(floor_entry(floor_chk, floor_rows))
    kernels += probe_entries(launch_res, smem_res)
    print(json.dumps({"kernels": kernels}), flush=True)
    # 19. last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
