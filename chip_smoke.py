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
in ADVANCED mode -- and holds every CUDA kernel of those paths against
its plain PyTorch version on the card.  Phases, one line each; any
failure raises and exits non-zero:

  1. device      the card's name and power limit (nvidia-smi)
  2. build       nvcc build of the kernels from the checkout, one nvcc per
                 unit in parallel (seconds, ptxas per kernel)
  3. scene       the JAX-free config-3 scene build (seconds, table bytes)
  4. check       8192 lanes from the middle of the 1920x1080 blocked camera
                 order through pt_frame (single span, split span) and its
                 plain version on the card; closest hits (t, id, object,
                 normal) of the kernel's own traversal against brute force
  5. check_mega  the same lanes: one shade_extend at depth 0 and one
                 shadow_resolve on its outputs against their plain
                 versions (flags and traced exact, energy under the
                 megakernel contract); trace_advanced_mega with and without
                 lane identities against trace_advanced_frame, bitwise
  6. frame       whole-frame route: one warm-up frame; one frame timing
                 each kernel launch; one frame counting each launch's work
                 and holding every 256th lane of both launches (their real
                 inputs: 2 depths with the carry out, then 4 sorted depths
                 with the carry in) against the plain version; then timed
                 frames through Renderer
  7. frame_mega  the same on the per-depth route (6 + 6 launches and 3
                 sorts per frame), then one frame from reset on each route
                 with the same seed: images and traced counts equal
  8. check_traverse  8192 config-3 lanes: traverse_packet_slim's closest
                 hits of camera rays and any hits of shadow rays toward
                 both lights (half of the lanes inactive) against its
                 plain version, bitwise (any hits: existence)
  9. check_whitted  8192 config-1 lanes through whitted_frame against its
                 plain version (bitwise) and against trace_whitted (state
                 and traced exact, energy under the contract)
 10. frame_whitted  config 1 at 800x600 through Renderer: 1 launch per
                 frame, every 256th lane of it against the plain version,
                 then one frame from reset on trace_whitted
                 (CPUGPU_NO_WHITTED_KERNEL=1): traced equal, image within
                 the golden tolerance
 11. frame_whitted_mesh  WHITTED on config 3's scene at 1920x1080, depth
                 4, through Renderer (trace_whitted): 5 closest-hit and 10
                 any-hit launches and 5 morton5 sorts per frame, every
                 256th lane of each launch against the plain version
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
                 launch
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
 20. layout3      config 3 at 1920x1080 under every node-table layout:
                 the default (CPUGPU_SMEMTREE=48: 48-col rows and the entry
                 side tables), CPUGPU_SMEMTREE=1 (64-col rows with them),
                 CPUGPU_SMEMTREE=0 (plain rows), CPUGPU_PACKET_TREE=w16,
                 CPUGPU_FUSED=1 and both; each built from the checkout
                 (seconds), its arms on the check lanes ([check_<layout>]:
                 pt_frame bitwise against the plain 64-col arm, every arm
                 against its plain version, count_depth against the walk),
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
 18. the {"kernels": [...]} line: per kernel its check's numbers, and per
     main-path launch its lanes, ms, bound and sampled error; the
     instance arms, the count_depth arms and the variant arms as entries
     of their own (`*_inst`, `*_depth`, `*_<layout>`)
 19. the last line {"ok": true, "device": {...}}

Phases 3-17 run the plain 64-col arms (CPUGPU_SMEMTREE=0 for their
scenes); the port's default tables (the JAX benchmark's) are the "48"
layout of phase 20.

--profile adds, after phases 6, 7, 10, 11, 11a-b, 14-16 and 17b-d, a
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
import re
import subprocess
import sys
import time

CHECK_LANES = 8192
TIMED_FRAMES = 5
# profiling sessions launch_ms makes before it gives up on seeing a launch
PROFILE_ATTEMPTS = 3
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
# per-lane bytes of whitted_frame: 6 ray columns and the state in;
# energy, state and traced out
WHITTED_LANE = 6 * 4 + 8 + 3 * 4 + 8 + 4
# f32 operations of the Whitted body (csrc/whitted.cuh), counted per
# object of the scene: a sphere test 27 (sphere_t and the closest-hit
# compares), a plane test 18; the occluder tests of a shadow ray 26 and
# 17; per live depth 150 for shading and the Fresnel continuation and 28
# per light for its direction; per shadow ray 9 for the light's add
W_OPS_DEPTH, W_OPS_LIGHT, W_OPS_SHADOW = 150, 28, 9
W_OPS_SPH, W_OPS_PLN, W_OPS_OCC_SPH, W_OPS_OCC_PLN = 27, 18, 26, 17


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


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
                      r"([A-Za-z]+(?:_[A-Za-z]+)*_kernel)(?:I((?:Lb[01]E)+)E|E)",
                      ln)
        if m:
            name, frame = m.group(1), ""
            if m.group(2) is not None:  # the kInst (, kDepth) arguments
                name += "<" + ",".join(
                    "true" if b == "1" else "false"
                    for b in re.findall(r"Lb([01])E", m.group(2))) + ">"
        elif "spill" in ln:
            frame = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {frame}")
            name = None
    return out


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


def launch_ms(fn, kernels, reps: int = 1) -> list:
    """Device milliseconds of every launch of the CUDA kernels named in
    `kernels` (a name or a tuple of names of functions in csrc/) while
    fn() runs reps times, in launch order (torch.profiler).  Unlike CUDA
    events around a call, this leaves out the time the device waits for
    the host to enqueue the launch.  Every `ms` of the kernels line is
    this clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernels = (kernels,) if isinstance(kernels, str) else kernels
    for attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and any(k in e.name for k in kernels)),
                     key=lambda e: e.time_range.start)
        if evs:
            return [(e.time_range.end - e.time_range.start) / 1e3
                    for e in evs]
        # a profiling session now and then records no device activity
        # at all (seen after --profile's tables); the next one does
        say("profiler_retry", kernels=",".join(kernels), attempt=attempt + 1,
            device_events=sum(1 for e in prof.events()
                              if e.device_type == DeviceType.CUDA))
    raise AssertionError(f"the profiler saw no launch of {kernels}")


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
             shade_ops: int = OPS_SHADE, layouts=("64", "64")):
    """Least time of one launch's work on this run's data: the larger of
    bytes over HBM bandwidth and f32 operations over the f32 peak.  The
    bytes are each lane's input read once and output written once
    (lane_bytes_total), the small scene tables once, and once each table
    row the launch read (the distinct rows of count_iters), not whole
    tables.  iters: a kernel's count_iters counters by name
    (ptf.COUNTERS); shade_ops: operations per closest-hit ray beyond its
    walk (0 for a bare traversal); layouts: the closest-hit and the
    shadow tree's node layout (ROW_COSTS; launch_layouts)."""
    c = iters
    (nb, nops), (sb, sops) = ROW_COSTS[layouts[0]], ROW_COSTS[layouts[1]]
    ops = (nops * c["node"] + sops * c["snode"]
           + OPS_TRI * LEAF_TRIS * c["leaf"]
           + OPS_TRI * OCCL_TRIS * c["sleaf"] + shade_ops * c["ray"])
    rows = (nb * c["node_rows"] + sb * c["snode_rows"]
            + LEAF_ROW_BYTES * c["leaf_rows"]
            + OCCL_ROW_BYTES * c["sleaf_rows"])
    t_bytes = (lane_bytes_total + rows + small_bytes) / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


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


def trav_bytes(lanes: int, live: int, t_init: bool, active: bool) -> int:
    """Lane bytes a traverse_packet_slim launch must move: outputs and the
    given t_init / active columns on every lane, ray columns on the `live`
    (active) lanes only."""
    return lanes * (TRAV_OUT + 4 * t_init + 4 * active) + live * TRAV_RAY


def whitted_bound(iters: dict, lanes: int, ds):
    """Least time of a whitted_frame launch's work on this run's data:
    the operations of its live depths and shadow rays (count_iters' `ray`
    and `sray`, every occluder test of a shadow ray counted) over the f32
    peak, against its lanes' bytes and the small tables over HBM
    bandwidth."""
    per_depth = (W_OPS_DEPTH + W_OPS_SPH * ds.num_sph + W_OPS_PLN * ds.num_pln
                 + W_OPS_LIGHT * ds.num_lights)
    per_shadow = (W_OPS_SHADOW + W_OPS_OCC_SPH * ds.num_sph
                  + W_OPS_OCC_PLN * ds.num_pln)
    ops = per_depth * iters["ray"] + per_shadow * iters["sray"]
    small = 4 * sum(t.numel() for t in (ds.mk_mats, ds.mk_lights, ds.mk_sph,
                                         ds.mk_pln, ds.mk_sph_mat,
                                         ds.mk_pln_mat, ds.mk_objmat))
    t_bytes = (lanes * WHITTED_LANE + small) / PEAK_BYTES_PER_S
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

    key, layout = ptf.launch_key, ptf.table_layout
    tables, kw = integrators.frame_args(ds, settings)
    ch = layout(tables[0], kw["ents"], kw["fused_nn"], kw["width"])
    sh = layout(kw["sh_nodes"], kw["sh_ents"]) if kw.get("occl") else ch
    tables, tkw = integrators.route_tables(ds)
    lay = layout(tables[0], tkw["ents"], tkw["fused_nn"], tkw["width"])
    sn, _, skw = integrators.shadow_tables(ds)
    slay = layout(sn, skw.get("ents"), skw.get("fused_nn", 0),
                  skw.get("width", 8))
    return dict(pt_frame=key("pt_frame", ptf.arm_key(ch, sh)),
                shade_extend=key("shade_extend", lay),
                shadow_resolve=key("shadow_resolve", slay),
                traverse_packet_slim=key("traverse_packet_slim", lay),
                traverse_packet_slim_depth=key("traverse_packet_slim", lay,
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
    return ptf.pt_frame_reference(tables[1], *tables[2:], rays, state,
                                  **{k: v for k, v in kw.items() if k in keys})


def shade_plain(mk, a, kw, records=None):
    """shade_extend's plain version on the arguments of a shade_extend
    call (a: ten tables, depth, rays, state, throughput, energy,
    flags), its instance arm when kw has the instance tables."""
    keys = ("num_lights", "num_sph", "num_pln", "nee", "rr", "cosine",
            "ref_pdf", "light_tri_meta")
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
               profile: bool, phase: str = "frame_mega"):
    """Phase 7: config 3 through Renderer on the per-depth route
    (CPUGPU_NO_PTFRAME=1, restored afterwards); the kernels' arms are
    ARM's.  Returns (the main-path entries of every launch of one frame,
    the timed frames' counts, and a dict of the frame time, rate, the
    per-depth renderer and the from-reset images and traced counts of
    both routes), and prints the [<phase>] line."""
    import os

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
                           tuple(f"{name}_kernel" for name in MEGA_KERNELS))
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
        orec = mk.occl_records(scene.device(dev).poccl_ltris)
        sr_small = 4 * (scene.device(dev).mk_sph.numel()
                        + scene.device(dev).mk_pln.numel())
        for k, (ln, ms, c_ms) in enumerate(zip(launches, dev_ms, call_ms)):
            it = dict(zip(ptf.COUNTERS, (int(v) for v in ln["iters"])))
            what = f"per-depth launch {k + 1} ({ln['name']}), sampled lanes"
            if ln["name"] == "shade_extend":
                ref = shade_plain(mk, ln["args"], ln["kw"], rec)
                if not torch.equal(ref[4], ln["got"][1]):
                    raise AssertionError(f"{what}: flags differ")
                e_ref, e_got = ref[3], ln["got"][0]
                b = bound_ms(it, ln["lanes"] * SE_LANE, small_bytes,
                             layouts=launch_layouts(ln["args"][0], ln["kw"]))
            else:
                e_ref = resolve_plain(mk, ln["args"], ln["kw"],
                                      orec if ln["kw"]["occl"] else rec)
                e_got = ln["got"][0]
                b = bound_ms(it, ln["lanes"] * SR_LANE
                             + it["sray"] * SR_SHADOW, sr_small,
                             layouts=launch_layouts(ln["args"][0], ln["kw"]))
            flips, err, mean = contract(torch.stack(e_ref, 1),
                                        torch.stack(e_got, 1), what)
            main_path.append(dict(
                name=ln["name"], depth=k // 2,
                layout=launch_layouts(ln["args"][0], ln["kw"])[0],
                lanes=ln["lanes"], ms=ms,
                call_ms=c_ms, bound_ms=b[0], bound_by=b[1],
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
    r_whole = Renderer(scene, camera=cam_cfg, config=config,
                       settings=settings, device=dev)
    before = counts().get(arm("pt_frame"), 0)
    r_whole.render_frame()
    if counts().get(arm("pt_frame"), 0) != before + 2:
        raise AssertionError("the whole-frame route did not take pt_frame")
    img = r_mega.image_u32()
    same_image = bool((img == r_whole.image_u32()).all())
    same_traced = r_mega.stats.traced_rays == r_whole.stats.traced_rays
    if not (same_image and same_traced):
        raise AssertionError("the per-depth route's frame differs from the "
                             "whole-frame route's")
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
        whole_image=r_whole.image_u32(),
        whole_traced=r_whole.stats.traced_rays)


def check_traverse(ds, o, d) -> dict:
    """Phase 8 on the check lanes of config 3: traverse_packet_slim's
    closest hits of the camera rays (even lanes active) and its any hits
    of shadow rays from the camera hits toward each light (odd lanes that
    hit active) against the plain version on the card -- closest hits
    bitwise on every lane (t, id, object, normal; inactive lanes t_init
    and -1), any hits in existence.  Returns each query's numbers."""
    import torch
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps

    dev, n = o.device, o.shape[0]
    rays = columns(o, d)
    even = torch.arange(n, device=dev) % 2 == 0
    far = torch.full((n,), 1e34, device=dev)
    rec = ptf.leaf_records(ds.pltris)
    cam = tps.traverse_packet_slim_reference(rays, far, ds.pltris,
                                             records=rec)
    pos = o + d * cam[0][:, None]
    queries = [("closest", rays, far, even, False)]
    for li in range(ds.num_lights):
        to_l = ds.mk_lights[li, 0:3][None, :] - pos
        dist = torch.sqrt((to_l * to_l).sum(dim=1))
        to_l = to_l / dist[:, None]
        queries.append((
            f"any_light{li}", columns(pos + to_l * 0.001, to_l),
            dist - ds.mk_lights[li, 3] - 0.002, ~even & (cam[1] >= 0), True))
    out = {}
    for name, qr, t0, act, any_hit in queries:
        args = (qr[:3], qr[3:], t0, ds.pnodes, ds.pltris, ds.proots)
        *got, it = tps.traverse_packet_slim(*args, active=act, any_hit=any_hit,
                                            count_depth=False,
                                            count_iters=True)
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
        out[name] = dict(
            active=int(act.sum()), hits=int((got[1] >= 0).sum()),
            mismatches=mism,
            max_abs_err=float((got[0] - ref[0]).abs().max()) if not any_hit
            else 0.0,
            **kernel_ms(lambda: tps.traverse_packet_slim(
                *args, active=act, any_hit=any_hit, count_depth=False),
                "traverse_kernel"),
            plain_ms=plain_ms, iters=it,
            bound=bound_ms(it, trav_bytes(n, it["ray"], True, True), 0,
                           shade_ops=0))
    say("check_traverse", lanes=n, **{
        f"{q}_{k}": v[k] for q, v in out.items()
        for k in ("active", "hits", "mismatches", "ms", "call_ms",
                  "plain_ms")},
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


def check_whitted(ds, settings, o, d, st) -> dict:
    """Phase 9 on 8192 config-1 lanes: whitted_frame against its plain
    version (energy, state and traced bitwise) and against trace_whitted
    (state and traced exact, energy under the Whitted contract)."""
    import torch
    from cpugpupathtracing_tpu_torch.models import whitted
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import whitted_kernel as wk

    n = st.shape[0]
    depths = settings.max_ray_depth + 1
    a, kw = whitted_args(ds, columns(o, d), st)
    *out_k, it = wk.whitted_frame(*a, num_mats=ds.num_mats, depths=depths,
                                  count_iters=True, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = wk.whitted_frame_reference(*a, depths=depths, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = [torch.equal(x, y) for x, y in zip(out_k, out_p)]
    if not all(same):
        raise AssertionError(f"whitted_frame differs from its plain version "
                             f"(energy, state, traced equal: {same})")
    s_t, res = whitted.trace_whitted(ds, settings, o, d, st)
    ptf.check_status(st.device)
    if not (torch.equal(s_t, out_k[1])
            and int(res.traced_rays) == int(out_k[2])):
        raise AssertionError("whitted_frame's state or traced differ from "
                             "trace_whitted's")
    flips, dmax = whitted_contract(res.energy, out_k[0],
                                   "whitted_frame vs trace_whitted")
    it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
    out = dict(**kernel_ms(lambda: wk.whitted_frame(
        *a, num_mats=ds.num_mats, depths=depths, **kw), "whitted_kernel"),
        plain_ms=plain_ms, iters=it, bound=whitted_bound(it, n, ds),
        max_abs_err=float((out_k[0] - out_p[0]).abs().max()),
        trace_max_abs_err=dmax, trace_flip_share=flips,
        trace_bitwise=torch.equal(res.energy, out_k[0]))
    say("check_whitted", lanes=n, depths=depths, traced=int(out_k[2]),
        plain_bitwise=True, state_equal_trace_whitted=True,
        traced_equal_trace_whitted=True,
        **{k: out[k] for k in ("max_abs_err", "trace_max_abs_err",
                               "trace_flip_share", "trace_bitwise", "ms",
                               "call_ms", "plain_ms", "iters")},
        bound_ms=out["bound"][0], bound_by=out["bound"][1])
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
    kernel.  Returns (main-path entries, counts)."""
    import os

    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
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
    call_ms = wrapper_ms(wk, ("whitted_frame",), r.render_frame)
    launches = []

    def counted(entry):
        def call(*a, **k):
            *out, iters = entry(*a, count_iters=True, **k)
            st = a[8]
            sel = torch.arange(0, st.shape[0], SAMPLE_STRIDE, device=dev)
            launches.append(dict(
                lanes=st.shape[0], iters=iters, kw=k,
                args=a[:7] + (tuple(x[sel] for x in a[7]), st[sel]),
                got=tuple(x[sel] for x in out[:2])))
            return tuple(out)
        return call

    instrument(wk, "whitted_frame", counted, r.render_frame)
    if not len(launches) == len(dev_ms) == len(call_ms) == 1:
        raise AssertionError(f"{len(launches)} whitted_frame launches in a "
                             "frame, expected 1")
    ln = launches[0]
    kw = {k: v for k, v in ln["kw"].items() if k != "num_mats"}
    ref = wk.whitted_frame_reference(*ln["args"], **kw)
    if not all(torch.equal(x, y) for x, y in zip(ref[:2], ln["got"])):
        raise AssertionError("whitted_frame's sampled lanes differ from the "
                             "plain version")
    it = dict(zip(ptf.COUNTERS, (int(v) for v in ln["iters"])))
    b = whitted_bound(it, ln["lanes"], ds)
    main_path = [dict(lanes=ln["lanes"], depths=kw["depths"], ms=dev_ms[0],
                      call_ms=call_ms[0], bound_ms=b[0], bound_by=b[1],
                      sampled_lanes=int(ref[1].shape[0]),
                      max_abs_err=float((ref[0] - ln["got"][0]).abs().max()),
                      iters=it)]
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


# ---- config 5: TLAS instancing --------------------------------------------

@contextlib.contextmanager
def environ(**kv):
    """Set (a value) or unset (None) environment variables for the block,
    then restore them."""
    import os

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
    for k in ("flat", "obj"):
        say("scene5", route=k, seconds=round(out[k]["seconds"], 2),
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
        dev_ms = launch_ms(frame, kernels)
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
        orec = None if ds.machinery else mk.occl_records(ds.poccl_ltris)
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
                    small, layouts=launch_layouts(ln["tables"][0], kk))
            elif ln["name"] == "shade_extend":
                ref = shade_plain(mk, ln["args"], ln["kw"], rec)
                exact = [(ref[4], ln["got"][1]), (ref[1], ln["got"][2])]
                e_ref = torch.stack(ref[3], 1)
                e_got = torch.stack(ln["got"][0], 1)
                b = bound_ms(it, ln["lanes"] * SE_LANE, small,
                             layouts=launch_layouts(ln["args"][0], ln["kw"]))
            else:
                ref = resolve_plain(mk, ln["args"], ln["kw"],
                                    orec if ln["kw"]["occl"] else rec)
                exact = []
                e_ref = torch.stack(ref, 1)
                e_got = torch.stack(ln["got"][0], 1)
                b = bound_ms(it, ln["lanes"] * SR_LANE
                             + it["sray"] * SR_SHADOW, sr_small,
                             layouts=launch_layouts(ln["args"][0], ln["kw"]))
            if any(not torch.equal(x, y) for x, y in exact):
                raise AssertionError(f"{what}: state or flags differ from "
                                     "the plain version")
            mism = int(bits_differ((e_got, e_got), (e_ref, e_ref)).sum())
            if ds.machinery and mism:
                raise AssertionError(f"{what}: {mism} energies differ from "
                                     "the plain version")
            contract(e_ref, e_got, what)
            main_path.append(dict(
                name=ln["name"] + ("_inst" if ds.machinery else ""),
                layout=launch_layouts(
                    (ln["tables"] if ln["name"] == "pt_frame"
                     else ln["args"])[0], ln["kw"])[0],
                launch=k + 1, lanes=ln["lanes"], ms=ms, call_ms=c_ms,
                bound_ms=b[0], bound_by=b[1],
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
    existence.  Returns the main-path entries in launch order, each with
    its depth (per_depth launches per depth)."""
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
            launches.append(dict(
                lanes=n, iters=iters, any_hit=any_hit,
                count_depth=count_depth, given_active=active is not None,
                tree=a[3:6], inst={k_: v for k_, v in k.items()
                                   if k_.startswith("inst_")},
                layout={k_: v for k_, v in k.items()
                        if k_ in ("ents", "fused_nn", "width")},
                rays=tuple(x[sel] for x in a[0] + a[1]), t_init=a[2][sel],
                active=None if active is None else active[sel],
                got=tuple(x[sel] for x in flat_hit(out))))
            return tuple(out)
        return call

    instrument(tps, "traverse_packet_slim", counted, frame_fn)
    if not len(launches) == len(dev_ms) == len(call_ms):
        raise AssertionError(f"{what}: {len(launches)} traversal launches, "
                             f"{len(dev_ms)} timed")
    main_path = []
    for k, (ln, ms_k, c_ms) in enumerate(zip(launches, dev_ms, call_ms)):
        nodes, ltris, roots = ln["tree"]
        inst = ln["inst"]
        got = ln["got"]
        ref = flat_hit(trav_plain(tps, ln["rays"], ln["t_init"], nodes,
                                  ltris, roots, ln["active"], ln["any_hit"],
                                  ln["count_depth"], inst, ln["layout"]))
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
                     layouts=launch_layouts(nodes, ln["layout"]))
        main_path.append(dict(
            launch=k + 1, depth=k // per_depth,
            layout=launch_layouts(nodes, ln["layout"])[0],
            kind="any" if ln["any_hit"] else "closest",
            count_depth=ln["count_depth"], instance_arm=bool(inst),
            lanes=ln["lanes"], active=it["ray"], ms=ms_k, call_ms=c_ms,
            bound_ms=b[0], bound_by=b[1], sampled_lanes=int(got[0].shape[0]),
            max_abs_err=float((got[0] - ref[0]).abs().max())
            if not ln["any_hit"] else 0.0, mismatches=mism,
            hits=int((got[1] >= 0).sum()),
            instance_hits=int((got[-1] >= 0).sum()) if inst else 0,
            iters=it))
    ptf.check_status(dev)
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


def frame_whole(scene, cam_cfg, settings, width, height, small_bytes,
                profile: bool, phase: str = "frame"):
    """Phase 6: config 3 through Renderer on the whole-frame route: one
    warm-up frame; one frame timing each kernel launch; one frame
    counting each launch's work and holding every SAMPLE_STRIDE-th lane
    of both launches (their real inputs: 2 depths with the carry out,
    then 4 sorted depths with the carry in) against the plain version;
    then timed frames through Renderer.  The pt_frame arm is ARM's.
    Returns (main-path entries, counts, a dict of the frame time, rate
    and the renderer); prints the [<phase>] line and one
    [<phase>_launch<k>] line per launch ([launch<k>] for phase 6)."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

    dev = torch.device("cuda")
    r = Renderer(scene, camera=cam_cfg,
                 config=RenderConfig(width=width, height=height),
                 settings=settings, device=dev)
    r.render_frame()  # warm-up
    entry = ptf.pt_frame

    # one frame timing each launch on the device, one with CUDA events
    # around each wrapper call
    span_ms = launch_ms(r.render_frame, "pt_frame_kernel")
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
    if not len(spans) == len(span_ms) == len(span_call_ms) == 2:
        raise AssertionError(f"{len(spans)} launches in a frame, expected 2")
    main_path = []
    for sp, ms, c_ms in zip(spans, span_ms, span_call_ms):
        k = dict(sp["kw"], carry_in=sp["carry_in"])
        res = plain(ptf, sp["tables"], sp["rays"], sp["state"], **k)
        e_ref = torch.stack(res[3], 1) if k.get("carry_out") else res[0]
        what = f"{phase} launch {len(main_path) + 1}, sampled lanes"
        s_flips, s_max, s_mean = contract(e_ref, sp["energy"], what)
        it = dict(zip(ptf.COUNTERS, (int(v) for v in sp["iters"])))
        layouts = launch_layouts(sp["tables"][0], k)
        sb_ms, sb_by = bound_ms(
            it, sp["lanes"] * lane_bytes(sp["carry_in"] is not None,
                                         bool(k.get("carry_out"))),
            small_bytes, layouts=layouts)
        main_path.append(dict(
            lanes=sp["lanes"], depths=k["depths"],
            depth_base=k.get("depth_base", 0), layouts=layouts, ms=ms,
            call_ms=c_ms, bound_ms=sb_ms,
            bound_by=sb_by, sampled_lanes=sp["state"].shape[0],
            max_abs_err=s_max, flip_share=s_flips, mean_err=s_mean,
            energy_bit_mismatches=int((sp["energy"].view(torch.int32)
                                       != e_ref.view(torch.int32))
                                      .any(dim=1).sum()),
            iters=it))
    ptf.check_status(dev)

    # the main path: timed frames, every count from 0
    frame_ms, traced, rate, frame_counts = timed_frames(
        r, f"{phase} frames", False, "whole-frame", pt_frame=2, sorts=1)
    ptf.check_status(dev)
    r.total_energy_received = 0.0
    r.num_accumulated = 0
    r.render_frame()
    energy = frame_checks(r, phase, height, width)
    say(phase, width=width, height=height, frames=TIMED_FRAMES,
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


def check_variant(ds, settings, o, d, st, small_bytes, name: str,
                  ref64) -> dict:
    """Phase [check_<layout>]: each arm of the snapshot's layout on the
    8192 check lanes -- pt_frame on the whole-frame route's tables (all
    depths), shade_extend at depth 0 and shadow_resolve on its outputs on
    the per-depth route's, and traverse_packet_slim's closest hits of the
    camera rays (even lanes) and any hits toward light 0 (odd lanes that
    hit) with count_depth -- against their plain versions (the walk for
    count_depth: bitwise on every output; closest hits without it against
    brute force, bitwise), pt_frame also against the plain 64-col arm's
    run `ref64` (energy, state, traced) bitwise.  Returns each arm's
    numbers by kernel."""
    import torch
    from cpugpupathtracing_tpu_torch.models import integrators
    from cpugpupathtracing_tpu_torch.ops import megakernel as mk
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps

    dev, n = st.device, st.shape[0]
    rays = columns(o, d)
    depths = settings.max_ray_depth + 1
    out = {}

    def timed_plain(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def energy_bits(a, b):
        return int((a.reshape(a.shape[0], -1).view(torch.int32)
                    != b.reshape(b.shape[0], -1).view(torch.int32))
                   .any(dim=1).sum())

    # B1: pt_frame
    tables, kw = integrators.frame_args(ds, settings)
    *fk, it = ptf.pt_frame(*tables, rays, st, depths=depths,
                           count_iters=True, **kw)
    fp, p_ms = timed_plain(lambda: plain(ptf, tables, rays, st,
                                         depths=depths, **kw))
    ptf.check_status(dev)
    if int(fk[2]) != int(fp[2]):
        raise AssertionError(f"pt_frame {name}: traced {int(fk[2])}, plain "
                             f"{int(fp[2])}")
    if not (torch.equal(fk[0], ref64[0]) and torch.equal(fk[1], ref64[1])
            and int(fk[2]) == int(ref64[2])):
        raise AssertionError(f"pt_frame {name}: differs from the 64-col arm")
    _, err, _ = contract(fp[0], fk[0], f"pt_frame {name} vs plain")
    it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
    lay = launch_layouts(tables[0], kw)
    out["pt_frame"] = dict(
        layouts=lay, max_abs_err=err, plain_ms=p_ms, iters=it,
        energy_bit_mismatches=energy_bits(fk[0], fp[0]),
        state_mismatches=int((fk[1] != fp[1]).sum()),
        bound=bound_ms(it, n * lane_bytes(False, False), small_bytes,
                       layouts=lay),
        **kernel_ms(lambda: ptf.pt_frame(*tables, rays, st, depths=depths,
                                         **kw), "pt_frame_kernel"))

    # B2, B3: shade_extend at depth 0, shadow_resolve on its shadow rays
    tables, tkw = integrators.route_tables(ds)
    ekw = dict(integrators.extend_kwargs(ds, settings), **tkw)
    one = torch.ones(n, device=dev)
    zero = torch.zeros(n, device=dev)
    a = (*tables, 0, rays, st, (one, one, one), (zero, zero, zero),
         torch.ones(n, dtype=torch.int32, device=dev))
    *se, it = mk.shade_extend(*a, count_iters=True, **ekw)
    sp, p_ms = timed_plain(lambda: shade_plain(mk, a, ekw))
    if not (torch.equal(se[4], sp[4]) and torch.equal(se[1], sp[1])):
        raise AssertionError(f"shade_extend {name}: flags or state differ "
                             "from the plain version")
    _, err, _ = contract(torch.stack(sp[3], 1), torch.stack(se[3], 1),
                         f"shade_extend {name} vs plain")
    it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
    lay = launch_layouts(tables[0], ekw)
    out["shade_extend"] = dict(
        layouts=lay, max_abs_err=err, plain_ms=p_ms, iters=it,
        energy_bit_mismatches=energy_bits(torch.stack(se[3], 1),
                                          torch.stack(sp[3], 1)),
        bound=bound_ms(it, n * SE_LANE, small_bytes, layouts=lay),
        **kernel_ms(lambda: mk.shade_extend(*a, **ekw),
                    "shade_extend_kernel"))
    sn, sl, skw = integrators.shadow_tables(ds)
    sa = (sn, sl, ds.mk_sph, ds.mk_pln, se[5], se[6], se[7], se[4], se[3],
          se[8])
    *sr, it = mk.shadow_resolve(*sa, count_iters=True, **skw)
    rp, p_ms = timed_plain(lambda: resolve_plain(mk, sa, skw))
    ptf.check_status(dev)
    _, err, _ = contract(torch.stack(rp, 1), torch.stack(sr, 1),
                         f"shadow_resolve {name} vs plain")
    it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
    lay = launch_layouts(sn, skw)
    out["shadow_resolve"] = dict(
        layouts=lay, max_abs_err=err, plain_ms=p_ms, iters=it,
        energy_bit_mismatches=energy_bits(torch.stack(sr, 1),
                                          torch.stack(rp, 1)),
        bound=bound_ms(it, n * SR_LANE + it["sray"] * SR_SHADOW,
                       4 * (ds.mk_sph.numel() + ds.mk_pln.numel()),
                       layouts=lay),
        **kernel_ms(lambda: mk.shadow_resolve(*sa, **skw),
                    "shadow_resolve_kernel"))

    # B4: closest and any hits, count_depth against the walk
    nodes, ltris, fused_nn, ents = tables[0], tables[1], tkw["fused_nn"], \
        tkw["ents"]
    lkw = dict(fused_nn=fused_nn, width=tkw["width"], ents=ents)
    even = torch.arange(n, device=dev) % 2 == 0
    far = torch.full((n,), 1e34, device=dev)
    cam = tps.traverse_packet_slim(rays[:3], rays[3:], far, nodes, ltris,
                                   ds.proots, count_depth=False, **lkw)
    brute = tps.traverse_packet_slim_reference(rays, far, ltris)
    b_mism = int(bits_differ(flat_hit(cam), flat_hit(brute)).sum())
    if b_mism:
        raise AssertionError(f"traverse {name}: {b_mism} closest hits differ "
                             "from brute force")
    *_, it = tps.traverse_packet_slim(rays[:3], rays[3:], far, nodes, ltris,
                                      ds.proots, count_depth=False,
                                      count_iters=True, **lkw)
    _, p_ms = timed_plain(lambda: tps.traverse_packet_slim_reference(
        rays, far, ltris))
    it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
    lay = launch_layouts(nodes, lkw)
    out["traverse"] = dict(
        layouts=lay, hits=int((cam[1] >= 0).sum()), mismatches=b_mism,
        max_abs_err=float((cam[0] - brute[0]).abs().max()), plain_ms=p_ms,
        iters=it, bound=bound_ms(it, trav_bytes(n, it["ray"], True, False),
                                 0, shade_ops=0, layouts=lay),
        **kernel_ms(lambda: tps.traverse_packet_slim(
            rays[:3], rays[3:], far, nodes, ltris, ds.proots,
            count_depth=False, **lkw), "traverse_kernel"))
    pos = o + d * cam[0][:, None]
    to_l = ds.mk_lights[0, 0:3][None, :] - pos
    dist = torch.sqrt((to_l * to_l).sum(dim=1))
    to_l = to_l / dist[:, None]
    for query, qr, t0, act, any_hit in (
            ("closest", rays, far, even, False),
            ("any", columns(pos + to_l * 0.001, to_l),
             dist - ds.mk_lights[0, 3] - 0.002, ~even & (cam[1] >= 0), True)):
        args = (qr[:3], qr[3:], t0, nodes, ltris, ds.proots)
        *got, it = tps.traverse_packet_slim(*args, active=act,
                                            any_hit=any_hit,
                                            count_iters=True, **lkw)
        ref, p_ms = timed_plain(lambda: trav_plain(
            tps, qr, t0, nodes, ltris, ds.proots, act, any_hit, True, {},
            lkw))
        ptf.check_status(dev)
        mism = int(bits_differ(flat_hit(got), flat_hit(ref)).sum())
        if mism:
            raise AssertionError(f"traverse {name} {query}: {mism} lanes "
                                 "differ from the walk")
        it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
        fin = torch.isfinite(ref[0])  # lanes whose camera ray missed: inf
        out[f"traverse_{query}"] = dict(
            layouts=lay, active=int(act.sum()), hits=int((got[1] >= 0).sum()),
            mismatches=mism, brute_force_mismatches=b_mism,
            depth_max=int(got[4].max()),
            max_abs_err=float((got[0] - ref[0])[fin].abs().max()),
            plain_ms=p_ms, iters=it,
            bound=bound_ms(it, trav_bytes(n, it["ray"], True, True) + 4 * n,
                           0, shade_ops=0, layouts=lay),
            **kernel_ms(lambda: tps.traverse_packet_slim(
                *args, active=act, any_hit=any_hit, **lkw),
                "traverse_kernel"))
    bad = {k: v["energy_bit_mismatches"] for k, v in out.items()
           if v.get("energy_bit_mismatches", 0)}
    if bad or out["pt_frame"]["state_mismatches"]:
        raise AssertionError(
            f"check {name}: lanes whose energy differs from the plain "
            f"version bitwise {bad}, pt_frame states differing "
            f"{out['pt_frame']['state_mismatches']}")
    say(f"check_{name}", lanes=n, **{
        f"{k}_{f}": v[f] for k, v in out.items()
        for f in ("layouts", "ms", "call_ms", "plain_ms", "max_abs_err")},
        **{f"{k}_bound_ms": v["bound"][0] for k, v in out.items()},
        **{f"{k}_energy_bit_mismatches": v["energy_bit_mismatches"]
           for k, v in out.items() if "energy_bit_mismatches" in v},
        pt_frame_equal_64=True)
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
            arms=sorted(k for k, v in got.items() if v and k != "sorts"))
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
                res["check"] = check_variant(ds, settings, o, d, st, small,
                                             name, ref64)
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


def layouts5(s5) -> dict:
    """Phase [layout5]: config 5 flattened at 1280x720, the hook before
    every frame, under LAYOUT5_RUNS (the default side tables, 16-wide
    rows, the fused table, fused 16-wide rows): the flatten decision on
    the layout's tables (bytes against the budget), both routes through
    frame5 (every launch sampled against its plain version, timed frames,
    the refit's ms), a refit against a fresh build at the same transforms
    (every table, the fused table included, bitwise), and one frame from
    reset per route at the same transforms equal to the default layout's
    (image and traced count).  Returns the numbers by layout."""
    import torch
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models import scene as scenelib
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    dev = torch.device("cuda")
    base = s5["flat"]["scene"]
    out, ref = {}, {}
    for name, env in LAYOUT5_RUNS:
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
                say("layout5", layout=name, **res,
                    note="over the flatten budget: the 8-wide object-space "
                    "path, not timed here")
                out[name] = res
                continue
            s5l = dict(flat=dict(scene=scene, hook=hook), cam=cam,
                       settings=settings, width=w, height=h)
            with arms(ds, settings) as keys:
                res["arms"] = keys
                for route, phase in (("whole", "frame5"),
                                     ("mega", "frame5_mega")):
                    path, got, fr = frame5(s5l, phase, False,
                                           label=f"layout5_{name}_{route}")
                    rr = fr.pop("renderer")
                    with environ(**FRAME5_ROUTES[phase][1]):
                        fr["busy"] = profile_frames(
                            rr, fr["ms_per_frame"], f"config 5 {name} {route}",
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
        say("layout5", layout=name, **{k: v for k, v in res.items()
                                        if k not in ("whole", "mega")},
            whole_ms_per_frame=res["whole"]["ms_per_frame"],
            whole_mrays_per_s=res["whole"]["mrays_per_s"],
            whole_busy=res["whole"]["busy"],
            mega_ms_per_frame=res["mega"]["ms_per_frame"],
            mega_mrays_per_s=res["mega"]["mrays_per_s"],
            mega_busy=res["mega"]["busy"],
            refit_ms=res["whole"]["refit_ms"], refit_bitwise=True,
            image_equal_default=True)
    return out


def variant_entries(lay3: dict, lay5: dict) -> list:
    """The kernels line's entries of the variant arms: per layout of
    LAYOUT_RUNS but the plain one, pt_frame's, shade_extend's,
    shadow_resolve's (over 16-wide and fused rows from the run without
    the any-hit tables) and the traversal's with and without count_depth,
    each with its check-lane numbers (check_<layout>), its launches on
    config 3's main paths in that layout (the whole-frame route's timed
    frames, the per-depth route's, the traversal's XLA and WHITTED
    frames) and those main paths' launches; config 5's launches per
    layout beside them."""
    src = "cpugpupathtracing_tpu_torch/csrc/"
    rep = "cpugpupathtracing_tpu/ops/"
    out = []
    for name, _ in LAYOUT_RUNS:
        if name == "64":
            continue
        res = lay3[name]
        shadow = lay3.get(f"{name}_shared", res) \
            if name in ("w16", "fused", "fused_w16") else res
        b4 = res["b4"]

        def b4_launches(key):
            return sum(b4[run]["counts"].get(key, 0) for run in b4)

        def b4_path(depth):
            return [dict(mp, run=run) for run in b4 for mp in b4[run]["path"]
                    if mp["count_depth"] == depth]

        rows = (
            ("pt_frame", res["arms"]["pt_frame"], res["check"]["pt_frame"],
             "pt_frame.cu", "pt_frame_kernel.py:419",
             res["whole"]["counts"].get(res["arms"]["pt_frame"], 0),
             res["whole"]["path"]),
            ("shade_extend", res["arms"]["shade_extend"],
             res["check"]["shade_extend"], "megakernel.cu",
             "megakernel.py:1713",
             res["mega"]["counts"].get(res["arms"]["shade_extend"], 0),
             [mp for mp in res["mega"]["path"]
              if mp["name"] == "shade_extend"]),
            ("shadow_resolve", shadow["arms"]["shadow_resolve"],
             shadow["check"]["shadow_resolve"], "megakernel.cu",
             "megakernel.py:1847",
             shadow["mega"]["counts"].get(shadow["arms"]["shadow_resolve"], 0),
             [mp for mp in shadow["mega"]["path"]
              if mp["name"] == "shadow_resolve"]),
            ("traverse_packet_slim", res["arms"]["traverse_packet_slim"],
             res["check"]["traverse"], "traverse.cu",
             "traverse_packet_slim.py:1485",
             b4_launches(res["arms"]["traverse_packet_slim"]),
             b4_path(False)),
            ("traverse_packet_slim", res["arms"]["traverse_packet_slim_depth"],
             res["check"]["traverse_closest"], "traverse.cu",
             "traverse_packet_slim.py:1485",
             b4_launches(res["arms"]["traverse_packet_slim_depth"]),
             b4_path(True)),
        )
        for kernel, key, chk, unit, line, launches, path in rows:
            entry = {
                "name": key,
                "route": "cuda",
                "source": src + unit,
                "replaces": rep + line,
                "launches": launches,
                "max_abs_err": chk["max_abs_err"],
                "ms": chk["ms"],
                "call_ms": chk["call_ms"],
                "plain_ms": chk["plain_ms"],
                "bound_ms": chk["bound"][0],
                "bound_by": chk["bound"][1],
                "library_ms": None,
                "check_lanes": CHECK_LANES,
                "layouts": chk["layouts"],
                "main_path": [{k: mp[k] for k in mp if k in (
                    "launch", "depth", "kind", "run", "lanes", "ms",
                    "call_ms", "bound_ms", "bound_by", "sampled_lanes",
                    "max_abs_err", "mismatches", "energy_bit_mismatches")}
                    for mp in path],
            }
            if "energy_bit_mismatches" in chk:
                entry["check_energy_bit_mismatches"] = \
                    chk["energy_bit_mismatches"]
            if key.endswith("_depth"):
                entry["check_any_hit"] = {
                    k: res["check"]["traverse_any"][k]
                    for k in ("ms", "call_ms", "plain_ms", "mismatches")} | {
                    "bound_ms": res["check"]["traverse_any"]["bound"][0]}
            r5 = lay5.get(name, {})
            route = "whole" if kernel == "pt_frame" else "mega"
            if route in r5 and kernel != "traverse_packet_slim":
                entry["config5_launches"] = r5[route]["counts"].get(key, 0)
            out.append(entry)
    return out


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
    say("check", lanes=CHECK_LANES, depths=depths, traced_kernel=int(tr_k),
        traced_plain=int(tr_p), traced_split=int(res_sp.traced_rays),
        split_bitwise=split_same, flip_share=flips, max_abs_err=dmax,
        mean_err=dmean, hit_mismatches=mism,
        hits=int((hk[1] >= 0).sum()), state_equal_share=float(
            (s_k == s_p).float().mean()),
        iters=it_k, kernel_ms=pt_ms["ms"], call_ms=pt_ms["call_ms"],
        plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by)

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

    # 12-17. config 5: the scene (flattened and object-space), the
    # instance arms on 8192 lanes and the refit, the three routes, the
    # routes' frames compared, one WHITTED frame on the instance arm
    s5 = scene5(dev)
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
    plain_tables.close()

    # 20-21. the node-table layouts on config 3 (both routes, the check
    # lanes, the traversal's main paths) and on config 5 flattened
    lay3 = layouts3(scene, cam_cfg, settings, settings1, width, height, o, d,
                    st, (e_k, s_k, tr_k))
    lay5 = layouts5(s5)

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
        "main_path": [{key: mp[key] for key in (
            "lanes", "depths", "ms", "call_ms", "bound_ms", "bound_by",
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
                "depth", "lanes", "ms", "call_ms", "bound_ms", "bound_by",
                "sampled_lanes", "max_abs_err")}
                for mp in mega_path if mp["name"] == name],
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
        "main_path": [{key: mp[key] for key in (
            "lanes", "depths", "ms", "call_ms", "bound_ms", "bound_by",
            "sampled_lanes", "max_abs_err")} for mp in whit_path],
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
                "launch", "lanes", "ms", "call_ms", "bound_ms", "bound_by",
                "sampled_lanes", "max_abs_err")}
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
    kernels += variant_entries(lay3, lay5)
    print(json.dumps({"kernels": kernels}), flush=True)
    # 19. last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
