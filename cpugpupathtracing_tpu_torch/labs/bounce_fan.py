"""The config-3 bounce-fan lab: every arm of the traversal labs L1-L4,
L6 and L7 on the frame's dominant ray population, held against the
standalone traversal's hits.

    python -m cpugpupathtracing_tpu_torch.labs.bounce_fan
    python -m cpugpupathtracing_tpu_torch.labs.bounce_fan --device cpu \\
        --width 96 --height 54

The port of the JAX package's tools/profile_lab2.py, tools/phase_lab.py
(main), tools/profile_lab3.py and tools/profile_lab.py.  Config 3
(models/scene.py make_reference_scene: the glass dragon stand-in, a
ground quad, two sphere lights) is built with the plain 64-col tables
(CPUGPU_SMEMTREE=0; the labs read the entries at cols 48..55); the camera
sits at (0, 0, 8) with aspect 16/9, its rays in 8x128 pixel blocks
(row-major where the image is not tiled by them).  The standalone
traversal (ops/traverse_packet_slim.py) finds the closest hit of every
primary ray; from each mesh hit a cosine-weighted bounce ray leaves the
hit point nudged along its direction (RNG seed_lanes(pixel, 0, salt=7)),
and the lanes whose primary ray hit a mesh are the active lanes of the
fan.  The standalone traversal's closest hits of the fan are the
reference, its any hits the occlusion reference; on the card its device
ms on the fan heads the arms as their yardstick (REF).

Arms (ARMS), one launch each on the same fan: profile_lab2.py's 13
variants of L1 (traverse_lab2) and L2 (traverse_lab2p, over the fused
table), phase_lab's phase-split and drain2 arms of L4 (traverse_phase;
its fs+condpush baseline is L1's "framestack+condpush" arm), L3's
closest hit, nearest-first closest hit and any hit (traverse16 over
scene_tables16 of each mesh's full-sweep SAH build, leaves of 8),
profile_lab.py's variants of L6 (traverse_lab: its r2-r6 sets, the
default arm also over its "dp" table, CPUGPU_PACKET_TREE=dp, which is
not the fan's full-sweep tree -- Fan.info says whether the two are
bitwise the same) with one arm more for each option value they leave
out (packed, smem entries, unroll 4, leaf skip, slab skip), and its
dual-tile run of L7 (traverse_lab_dual).  Per arm: the hits bitwise
against the reference on every active lane (L3's ids mapped to global
ids by the object's triangle offset; its any hit's occlusion bit against
the reference any hit; the dp arm's against the standalone traversal's
over the dp table) -- a mismatch fails the run, but for fma's, which are
counted, and leaf skip's, which has none --, the total warp trips (L6,
L7: loop iterations; L1, L2: their count launch's, whose warps refill
finished rays), the leaf-trip share (L1, L2: of the rays' trips), L1's
and L2's lane share (the rays' trips over 32 per warp trip), the device
ms of the launch
(common.busy_ms; "not measured" on the CPU), ns per warp trip, and the
bound: the larger of the bytes the launch must move (each lane's
t_init, active flag and outputs, an active lane's ray, each distinct row
read once: 224 B an 8-wide node row, 448 B a 16-wide one, 512 B a leaf
row; slab skip reads a node row's 32 B of entries, the smem arm its 192
B of bounds and the whole entry mirror once) over 3.35 TB/s and its f32
operations (26 per slab test, 55 per triangle test) over 67 TFLOP/s,
both from a count launch of the arm; beside it the operations at the
unfused f32 issue rate (the kernels are built with --fmad=false).

On the CPU every arm runs its plain version.  The last line of the
output is a JSON object with the arms' numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import NamedTuple

import torch

from cpugpupathtracing_tpu_torch.config import CameraConfig
from cpugpupathtracing_tpu_torch.labs import common as cm
from cpugpupathtracing_tpu_torch.labs import kernel_lab as l6
from cpugpupathtracing_tpu_torch.labs import kernel_lab2 as l2
from cpugpupathtracing_tpu_torch.labs import kernel_lab3 as l3
from cpugpupathtracing_tpu_torch.labs import phase_lab as pl
from cpugpupathtracing_tpu_torch.models import camera as camlib
from cpugpupathtracing_tpu_torch.models import scene as scenelib
from cpugpupathtracing_tpu_torch.ops import sampling
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from cpugpupathtracing_tpu_torch.utils import rng as rnglib
from cpugpupathtracing_tpu_torch.utils.device import resolve_device
from cpugpupathtracing_tpu_torch.utils.vecmath import RAY_NUDGE, RAY_TMAX

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores
# and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# f32 operations of a slab test and a triangle test (csrc/pt_device.cuh)
OPS_SLAB, OPS_TRI = 26, 55
# bytes a walk loads from a row: an 8-wide node row's 12 float4 of bounds
# and 2 of entries, a 16-wide one's 24 and 4, a leaf row's 8 records
NODE_ROW_BYTES, WIDE_ROW_BYTES, LEAF_ROW_BYTES = 224, 448, 512
ENTRY_BYTES = 32  # a node row's 8 i32 child entries
# per lane: t_init and the active flag in, t, hit and obj out; per active
# lane its six ray columns in
LANE_BYTES, RAY_BYTES = 4 + 4 + 12, 24
SALT = 7


class Arm(NamedTuple):
    group: str    # "lab2" (profile_lab2.py), "phase" (phase_lab), "lab3",
    # "lab" (profile_lab.py)
    label: str    # the JAX driver's name of the arm
    kernel: str   # "L1", "L2", "L3", "L4", "L6", "L7"
    kw: dict      # the wrapper's schedule flags
    # the hits against the standalone traversal's: "equal" (a mismatch
    # fails the run), "report" (counted: fma's planes are not B4's),
    # "skip" (no hits: leaf="skip" is for timing)
    hits: str = "equal"
    table: str = "plain"  # "plain" (the fan's) or "dp" (Fan.dp)


ARMS = (
    Arm("lab2", "linear baseline", "L1", {}),
    Arm("lab2", "framestack", "L1", dict(frame_stack=True)),
    Arm("lab2", "framestack+condpush", "L1",
        dict(frame_stack=True, cond_push=True)),
    Arm("lab2", "framestack+fused", "L1", dict(frame_stack=True, fused=True)),
    Arm("lab2", "framestack+fused+gate", "L1",
        dict(frame_stack=True, fused=True, gate_leaf=True)),
    Arm("lab2", "fs+fused+gate+condpush", "L1",
        dict(frame_stack=True, fused=True, gate_leaf=True, cond_push=True)),
    Arm("lab2", "fused only", "L1", dict(fused=True)),
    Arm("lab2", "gate only", "L1", dict(gate_leaf=True)),
    Arm("lab2", "pipelined linear+fused", "L2", dict(frame_stack=False)),
    Arm("lab2", "pipelined fs+fused", "L2", dict(frame_stack=True)),
    Arm("lab2", "pipelined fs+fused+nearest", "L2",
        dict(frame_stack=True, nearest=True)),
    Arm("lab2", "pipelined fs+fused+parent", "L2",
        dict(frame_stack=True, parent=True)),
    Arm("lab2", "pipe fs+fused+near+parent", "L2",
        dict(frame_stack=True, nearest=True, parent=True)),
    Arm("phase", "phase-split", "L4", {}),
    Arm("phase", "phase-split drain2", "L4", dict(drain2=True)),
    Arm("lab3", "W16 lab (fs+condpush)", "L3", {}),
    Arm("lab3", "W16 lab nearest", "L3", dict(nearest=True)),
    Arm("lab3", "W16 lab any hit", "L3", dict(any_hit=True)),
    # L6, tools/profile_lab.py's variants (its r2-r6 sets and the default
    # one's dp table), then one arm for each option value they leave out
    Arm("lab", "base (seq phases)", "L6", {}),
    Arm("lab", "base (seq phases) [dp]", "L6", {}, table="dp"),
    Arm("lab", "slab ilv", "L6", dict(slab="ilv")),
    Arm("lab", "leaf ilv", "L6", dict(leaf="ilv")),
    Arm("lab", "slab+leaf ilv", "L6", dict(slab="ilv", leaf="ilv")),
    Arm("lab", "slab+leaf ilv + unroll2", "L6",
        dict(slab="ilv", leaf="ilv", unroll=2)),
    Arm("lab", "ilv + fixed order", "L6",
        dict(slab="ilv", leaf="ilv", order="fixed")),
    Arm("lab", "ilv + packedmask", "L6",
        dict(slab="ilv", leaf="ilv", ctrl="packedmask")),
    Arm("lab", "ilv + fixed + fma", "L6",
        dict(slab="ilv", leaf="ilv", order="fixed", fma=True), hits="report"),
    Arm("lab", "ilv + framestack", "L6",
        dict(slab="ilv", leaf="ilv", ctrl="framestack")),
    Arm("lab", "ilv + fixed + fused", "L6",
        dict(slab="ilv", leaf="ilv", order="fixed", decode="fused")),
    Arm("lab", "ilv + framestack + fused", "L6",
        dict(slab="ilv", leaf="ilv", ctrl="framestack", decode="fused")),
    Arm("lab", "ilv + packed", "L6",
        dict(slab="ilv", leaf="ilv", ctrl="packed")),
    Arm("lab", "ilv + fixed + smem entries", "L6",
        dict(slab="ilv", leaf="ilv", order="fixed", entries="smem")),
    Arm("lab", "ilv + unroll4", "L6", dict(slab="ilv", leaf="ilv", unroll=4)),
    Arm("lab", "leaf skip (slab ilv, fixed)", "L6",
        dict(slab="ilv", leaf="skip", order="fixed"), hits="skip"),
    Arm("lab", "slab skip (leaf ilv, fixed)", "L6",
        dict(slab="skip", leaf="ilv", order="fixed")),
    # L7, profile_lab.py's dual-tile run
    Arm("lab", "dual-tile", "L7", {}),
)
# the yardstick beside the arms: the standalone traversal's closest hit
# of the same fan (the reference hits)
REF = Arm("ref", "B4 closest (traverse_packet_slim)", "B4", {})
# the CUDA kernel of each lab and of the yardstick (csrc/), as the
# profiler names it
KERNELS = {"L1": "lab_frame_kernel", "L2": "lab_pipe_kernel",
           "L3": "lab_wide_kernel", "L4": "lab_phase_kernel",
           "L6": "lab_ablate_kernel", "L7": "lab_dual_kernel",
           "B4": "traverse_kernel"}


class Fan(NamedTuple):
    rays: tuple          # six (N,) f32 columns of the bounce rays
    t_init: torch.Tensor
    active: torch.Tensor  # (N,) bool: the primary ray hit a mesh
    ref: tuple           # the standalone traversal's (t, tri, obj)
    ref_any: torch.Tensor  # its any hit's occlusion bit
    nodes: torch.Tensor  # (B, 64) closest-hit node rows
    ltris: torch.Tensor
    roots: tuple
    fused: torch.Tensor  # fuse_tables(nodes, ltris), B node rows
    wide: torch.Tensor   # scene_tables16 of the meshes
    wide_nn: int
    wide_roots: tuple
    tri_off: dict        # object index -> its first global triangle id
    info: dict
    # tools/profile_lab.py's "dp" table (CPUGPU_PACKET_TREE=dp: the
    # SAH-cost DP collapse of each mesh's SAH_SPLIT_INTERVALS build):
    # (nodes, ltris, roots, the standalone traversal's closest hits on it)
    dp: tuple


@contextlib.contextmanager
def plain_tables(tree=None):
    """The plain 64-col tables (CPUGPU_SMEMTREE=0), of the closest-hit
    tree mode `tree` (CPUGPU_PACKET_TREE) where given."""
    env = dict(CPUGPU_SMEMTREE="0")
    if tree is not None:
        env["CPUGPU_PACKET_TREE"] = tree
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def make_fan(device="cuda", width: int = 1920, height: int = 1080,
             scene=None) -> Fan:
    """The config-3 bounce fan at width x height (module docstring); on
    `scene` instead of config 3's where given (with its plain tables)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with plain_tables():
        scene = scene if scene is not None else \
            scenelib.make_reference_scene()
        ds = scene.device(dev)
    build_s = time.perf_counter() - t0
    cam = camlib.to_arrays(CameraConfig(pos=(0.0, 0.0, 8.0), aspect=16 / 9),
                           dev)
    lane = torch.arange(width * height, dtype=torch.int64, device=dev)
    if width % 128 == 0 and height % 8 == 0:
        o, d, pix = camlib.blocked_lane_rays(cam, lane, width, height, 8, 128)
    else:
        (o, d), pix = camlib.lane_rays(cam, lane, width, height), lane
    t_init = torch.full((lane.numel(),), RAY_TMAX, dtype=torch.float32,
                        device=dev)
    nodes, ltris, roots = ds.pnodes, ds.pltris, tuple(ds.proots)
    t, tri, _, nrm, _ = tps.traverse_packet_slim(
        o, d, t_init, nodes, ltris, roots, count_depth=False)
    state = rnglib.seed_lanes(pix, 0, salt=SALT)
    pos = o + d * t[:, None]
    _, bd = sampling.cosine_weighted(state, nrm)
    bd = torch.stack(bd, dim=1)
    hit = tri >= 0
    bo = torch.where(hit[:, None], pos + bd * RAY_NUDGE, o)
    bdir = torch.where(hit[:, None], bd, d)
    rays = cm.columns(bo, bdir)
    ref = tps.traverse_packet_slim(rays[:3], rays[3:], t_init, nodes, ltris,
                                   roots, active=hit, count_depth=False)
    ref_any = tps.traverse_packet_slim(rays[:3], rays[3:], t_init, nodes,
                                       ltris, roots, active=hit,
                                       any_hit=True, count_depth=False)[1]
    fused, _ = l6.fuse_tables(nodes, ltris)
    t2 = time.perf_counter()
    with plain_tables("dp"):
        dps = scene.device(dev)
    dp_s = time.perf_counter() - t2
    dp = (dps.pnodes, dps.pltris, tuple(dps.proots))
    dp_ref = tps.traverse_packet_slim(rays[:3], rays[3:], t_init, *dp,
                                      active=hit, count_depth=False)[:3]
    dp += (dp_ref,)
    objs, tri_off, off = [], {}, 0
    for oi, obj in enumerate(scene.objects):
        if obj.kind == scenelib.PRIM_MESH:
            b = obj.blas[1].b  # the full-sweep SAH build, leaves of 8
            objs.append((b, oi))
            tri_off[oi] = off
            off += b.num_triangles
    t1 = time.perf_counter()
    wide, wide_nn, wide_roots = l3.scene_tables16(objs, dev)
    wide_s = time.perf_counter() - t1
    info = dict(
        scene_seconds=round(build_s, 2), lanes=lane.numel(),
        active=int(hit.sum()), node_rows=nodes.shape[0],
        leaf_rows=ltris.shape[0],
        depth=cm.tree_depth(nodes, roots, slice(48, 56)),
        wide_node_rows=wide_nn, wide_leaf_rows=wide.shape[0] - wide_nn,
        wide_depth=cm.tree_depth(wide, wide_roots, slice(96, 112), wide_nn),
        wide_seconds=round(wide_s, 2), roots=len(roots),
        dp_seconds=round(dp_s, 2), dp_node_rows=dp[0].shape[0],
        dp_leaf_rows=dp[1].shape[0],
        dp_tables_equal=_same_tables((nodes, ltris, roots), dp[:3]),
        dp_hits_equal=all(torch.equal(a.view(torch.int32), b.view(
            torch.int32)) for a, b in zip(ref[:3], dp_ref)))
    return Fan(rays, t_init, hit, ref[:3], ref_any >= 0, nodes, ltris, roots,
               fused, wide, wide_nn, wide_roots, tri_off, info, dp)


def _same_tables(a, b) -> bool:
    """Whether two (nodes, ltris, roots) are bitwise the same."""
    return a[2] == b[2] and all(
        x.shape == y.shape and torch.equal(x.view(torch.int32),
                                           y.view(torch.int32))
        for x, y in zip(a[:2], b[:2]))


def arm_key(arm: Arm) -> str:
    """The arm's launch key (ops/pt_frame.py launches)."""
    if arm.kernel == "B4":
        return "traverse_packet_slim"
    if arm.kernel == "L7":
        return l6.DUAL_KEY
    return {"L1": l2.lab2_key, "L2": l2.lab2p_key, "L3": l3.launch_key,
            "L6": l6.launch_key,
            "L4": pl.launch_key}[arm.kernel](**arm.kw)


def call(fan: Fan, arm: Arm, rays=None, t_init=None, active=None,
         count_rows: bool = False):
    """The arm's wrapper on the fan (or on the given lanes of it)."""
    rays = fan.rays if rays is None else rays
    t_init = fan.t_init if t_init is None else t_init
    active = fan.active if active is None else active
    o, d = rays[:3], rays[3:]
    if arm.kernel == "B4":
        return tps.traverse_packet_slim(o, d, t_init, fan.nodes, fan.ltris,
                                        fan.roots, active=active,
                                        count_depth=False)
    kw = dict(arm.kw, active=active, count_rows=count_rows)
    if arm.kernel in ("L6", "L7"):
        nodes, ltris, roots = tables(fan, arm)
        if arm.kernel == "L7":
            return l6.traverse_lab_dual(o, d, t_init, nodes, ltris, roots,
                                        **kw)
        if arm.kw.get("decode") == "fused":
            return l6.traverse_lab(o, d, t_init, fan.fused, None, roots,
                                   nn=nodes.shape[0], **kw)
        return l6.traverse_lab(o, d, t_init, nodes, ltris, roots, **kw)
    if arm.kernel == "L1":
        fused = kw.get("fused", False)
        return l2.traverse_lab2(o, d, t_init, fan.fused if fused
                                else fan.nodes, fan.ltris, fan.roots,
                                nn=fan.nodes.shape[0] if fused else 0, **kw)
    if arm.kernel == "L2":
        return l2.traverse_lab2p(o, d, t_init, fan.fused, None, fan.roots,
                                 nn=fan.nodes.shape[0], **kw)
    if arm.kernel == "L3":
        return l3.traverse16(o, d, t_init, fan.wide, fan.wide_roots,
                             nn=fan.wide_nn, count_iters=True, **kw)
    return pl.traverse_phase(o, d, t_init, fan.nodes, fan.ltris, fan.roots,
                             **kw)


def plain(fan: Fan, arm: Arm, rays, t_init, active, count_rows=False):
    """The arm's plain version on the given lanes (any device)."""
    o_kw = dict(active=active, count_rows=count_rows)
    kw = arm.kw
    if arm.kernel in ("L6", "L7"):
        nodes, ltris, roots = tables(fan, arm)
        if arm.kernel == "L7":
            return l6.traverse_lab_dual_reference(rays, t_init, nodes, ltris,
                                                  roots, **o_kw)
        if kw.get("decode") == "fused":
            return l6.traverse_lab_reference(rays, t_init, fan.fused, None,
                                             roots, nn=nodes.shape[0],
                                             **o_kw, **kw)
        return l6.traverse_lab_reference(rays, t_init, nodes, ltris, roots,
                                         **o_kw, **kw)
    if arm.kernel == "L1":
        fused = kw.get("fused", False)
        return l2.traverse_lab2_reference(
            rays, t_init, fan.fused if fused else fan.nodes, fan.ltris,
            fan.roots, nn=fan.nodes.shape[0] if fused else 0,
            frame_stack=kw.get("frame_stack", False), fused=fused, **o_kw)
    if arm.kernel == "L2":
        return l2.traverse_lab2p_reference(
            rays, t_init, fan.fused, fan.roots, nn=fan.nodes.shape[0],
            frame_stack=kw.get("frame_stack", True),
            nearest=kw.get("nearest", False), parent=kw.get("parent", False),
            **o_kw)
    if arm.kernel == "L3":
        return l3.traverse16_reference(
            rays, t_init, fan.wide, fan.wide_roots, nn=fan.wide_nn,
            any_hit=kw.get("any_hit", False), count_iters=True,
            nearest=kw.get("nearest", False), **o_kw)
    return pl.traverse_phase_reference(rays, t_init, fan.nodes, fan.ltris,
                                       fan.roots,
                                       drain2=kw.get("drain2", False), **o_kw)


def tables(fan: Fan, arm: Arm) -> tuple:
    """(nodes, ltris, roots) of the 64-col tables the arm walks."""
    if arm.table == "dp":
        return fan.dp[:3]
    return fan.nodes, fan.ltris, fan.roots


def hit_mismatches(fan: Fan, arm: Arm, out, lanes=None) -> int:
    """Active lanes whose hit differs from the reference: t (bits), id
    and object of a closest hit (L3's ids made global), the occlusion bit
    of an any hit.  `lanes` selects the fan's lanes the output covers."""
    sel = (lambda x: x) if lanes is None else (lambda x: x[lanes])
    act = sel(fan.active)
    t, tri, obj = out[:3]
    if arm.kw.get("any_hit"):
        bad = (tri >= 0) != sel(fan.ref_any)
        return int((bad & act).sum())
    if arm.kernel == "L3":
        off = torch.zeros(max(fan.tri_off) + 1, dtype=tri.dtype,
                          device=tri.device)
        for oi, o in fan.tri_off.items():
            off[oi] = o
        tri = torch.where(tri >= 0, tri + off[obj.clamp(min=0).long()], tri)
    rt, rtri, robj = (sel(x) for x in (fan.dp[3] if arm.table == "dp"
                                       else fan.ref))
    bad = (t.view(torch.int32) != rt.view(torch.int32)) | (tri != rtri) | \
        (obj != robj)
    return int((bad & act).sum())


# the labs whose counters are per ray (kernel_lab2.py): their warps refill
# finished rays, and their count launches add the launch's warp trips
PER_RAY = ("L1", "L2")


def trips(arm: Arm, out) -> tuple:
    """(trips, leaf trips or None) of an arm's output: L1's and L2's the
    trips in which a ray held an entry and those in which it tested a
    leaf row, summed over the rays; the other labs' their warps' trips
    and leaf trips; L6's and L7's trips are their loop iterations (L6
    unrolled: one per `unroll` steps), with no leaf count."""
    if arm.kernel in ("L6", "L7"):
        return int(out[4].sum()), None
    leafs = None if arm.kernel == "L3" else int(out[4].sum())
    return int(out[3].sum()), leafs


def warp_trips(arm: Arm, out, counts=None):
    """The warp trips of an arm's launch: L1's and L2's from its count
    launch's COUNTS (kernel_lab2.COUNTS; None without them), the other
    labs' trips (trips())."""
    if arm.kernel in PER_RAY:
        return None if counts is None else int(counts[-1])
    return trips(arm, out)[0]


def bound(fan: Fan, arm: Arm, counts, active=None) -> tuple:
    """(ms, "bytes" | "operations"): the least time of the arm's launch
    on the fan's lanes (or on the lanes of `active`, an active mask),
    from its count launch's COUNTS (module docstring)."""
    c = dict(zip(cm.COUNTS, (int(v) for v in counts)))
    wide = arm.kernel == "L3"
    active = fan.active if active is None else active
    lanes, live = active.numel(), int(active.sum())
    row = WIDE_ROW_BYTES if wide else NODE_ROW_BYTES
    extra = 0
    if arm.kw.get("slab") == "skip":  # the entries alone, no bounds
        row = ENTRY_BYTES
    elif arm.kw.get("entries") == "smem":  # the bounds; the mirror once
        row -= ENTRY_BYTES
        extra = ENTRY_BYTES * tables(fan, arm)[0].shape[0]
    b = (lanes * LANE_BYTES + live * RAY_BYTES + 4 * len(fan.roots) + extra
         + row * c["node_rows"] + LEAF_ROW_BYTES * c["leaf_rows"])
    if arm.kernel in ("L6", "L7"):
        b += 4 * lanes  # the depth column
    t_b, t_o = b / PEAK_BYTES_PER_S, operations(arm, counts) / PEAK_F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b > t_o else "operations")


def operations(arm: Arm, counts) -> int:
    """The f32 operations of the arm's launch from its COUNTS: 26 per slab
    test (none under slab skip), 55 per triangle test."""
    c = dict(zip(cm.COUNTS, (int(v) for v in counts)))
    slabs = 0 if arm.kw.get("slab") == "skip" else c["node"]
    return (OPS_SLAB * (16 if arm.kernel == "L3" else 8) * slabs
            + OPS_TRI * c["tri"])


def unfused_ms(arm: Arm, counts) -> float:
    """The arm's operations at the unfused f32 issue rate
    (common.UNFUSED_F32_OPS_PER_S, --fmad=false): about twice an
    operations bound's time."""
    return operations(arm, counts) / cm.UNFUSED_F32_OPS_PER_S * 1e3


def count_pass(fan: Fan, arms=ARMS) -> dict:
    """Each arm's count launch: its COUNTS and bound, by label."""
    out = {}
    for arm in arms:
        res = call(fan, arm, count_rows=True)
        out[arm.label] = dict(counts=[int(v) for v in res[-1]],
                              bound=bound(fan, arm, res[-1]),
                              unfused_ms=unfused_ms(arm, res[-1]))
    return out


def run(fan: Fan, arms=ARMS, timed: bool = False, bounds=None) -> list:
    """One launch of the yardstick REF and of each arm on the fan, timed
    where `timed` (device ms, common.busy_ms; on the CPU none): each arm's
    hits against the reference (Arm.hits: raises on a mismatch, counts
    it, or none), its trips, ns per warp trip, and its bound from
    `bounds` (count_pass) where given."""
    outs = {}

    def launch(arm):
        def fn():
            outs[arm.label] = call(fan, arm)
        return fn

    todo = (REF,) + tuple(arms)
    ms = [cm.busy_ms(launch(a)) if timed else launch(a)() for a in todo]
    rows = [dict(group=REF.group, label=REF.label, key=arm_key(REF),
                 ms=ms[0])]
    for arm, arm_ms in zip(arms, ms[1:]):
        out = outs[arm.label]
        bad = None if arm.hits == "skip" else hit_mismatches(fan, arm, out)
        if bad and arm.hits == "equal":
            raise AssertionError(f"{arm.label}: {bad} active lanes' hits "
                                 "differ from the standalone traversal's")
        it, lf = trips(arm, out)
        wt = warp_trips(arm, out, None if bounds is None
                        else bounds[arm.label]["counts"])
        lane = arm.kernel in PER_RAY
        row = dict(group=arm.group, label=arm.label, key=arm_key(arm),
                   iters=wt, leaf_share=None if lf is None else lf / it,
                   lane_trips=it if lane else None,
                   lane_share=it / (32 * wt) if lane and wt else None,
                   ms=arm_ms,
                   ns_per_trip=None if arm_ms is None or not wt
                   else arm_ms * 1e6 / wt,
                   hits_equal=None if bad is None else bad == 0,
                   hit_mismatches=bad)
        if bounds is not None:
            b = bounds[arm.label]
            row.update(bound_ms=b["bound"][0], bound_by=b["bound"][1],
                       unfused_ms=b["unfused_ms"],
                       counts=dict(zip(cm.COUNTS, b["counts"])))
        rows.append(row)
    return rows


def fmt(row: dict) -> str:
    ms = "not measured" if row["ms"] is None else f"{row['ms']:.3f} ms"
    if row["group"] == REF.group:
        return f"{row['label']:28s} {ms}"
    ns = "" if row["ns_per_trip"] is None else \
        f"  {row['ns_per_trip']:.3f} ns/trip"
    lf = "" if row["leaf_share"] is None else \
        f"  {100 * row['leaf_share']:5.1f}% leaf"
    bd = "" if "bound_ms" not in row else \
        f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}; unfused " \
        f"{row['unfused_ms']:.4f})"
    hits = {None: "no hits (timing only)", True: "hits OK"}.get(
        row["hits_equal"], f"{row['hit_mismatches']} hits differ")
    wt = "" if row["iters"] is None else f"{row['iters']:9d} trips"
    ls = "" if row["lane_share"] is None else \
        f"  lanes {100 * row['lane_share']:5.1f}%"
    return f"{row['label']:28s} {wt}{lf}{ls}  {ms}{ns}{bd}  {hits}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    fan = make_fan(dev, args.width, args.height)
    print("fan: " + " ".join(f"{k}={v}" for k, v in fan.info.items()),
          flush=True)
    bounds = count_pass(fan)
    rows = run(fan, timed=on_card, bounds=bounds)
    for row in rows:
        print(fmt(row), flush=True)
    print(json.dumps(dict(device=str(dev), fan=fan.info, arms=rows)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
