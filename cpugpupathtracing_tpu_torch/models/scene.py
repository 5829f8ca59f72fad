"""Scene model: host-side object list and the device tables the
path-tracing kernel reads.

The port of the non-instanced part of the JAX package's
`Scene._build_device` (models/scene.py there), for scenes of meshes,
spheres and planes.  Every mesh object gets two slim 8-wide trees over a
full-sweep SAH binary build (SAH_SPLIT_PRIMITIVES, leaf <= 8):
  * the closest-hit tables `pnodes`/`pltris`: the SAH-cost DP collapse
    at leaf_max 8, shading-complete leaf records (bvh8.to_slim);
  * the any-hit tables `poccl_nodes`/`poccl_ltris`: the same collapse
    at leaf_max 14, bare 14-record leaf rows (bvh8.to_slim_occl).
Objects are concatenated into one table per kind, with one root per
object (`proots`, `poccl_roots`).  These are the tables the JAX package
builds under its benchmark flags (CPUGPU_PACKET_TREE=sweep_dp,
CPUGPU_OCCL=1), bitwise.  A scene without meshes (benchmark config 1)
gets empty trees and no roots.

The small scene tables (materials, lights, spheres, planes, object ->
material) keep the column layouts of the JAX package's
ops/megakernel.py, listed at `_mk_tables`.

`intersect_scene` and `hit_surface` are the nearest hit over every object
(the mesh trees through ops/traverse_packet_slim.py, then the analytic
spheres and planes) and its surface, as the Whitted integrator
(models/whitted.py) uses them.  The route gates of the kernels live here
too, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from cpugpupathtracing_tpu_torch.config import BuildOption
from cpugpupathtracing_tpu_torch.models import bvh as bvhlib
from cpugpupathtracing_tpu_torch.models import bvh8 as bvh8lib
from cpugpupathtracing_tpu_torch.models import materials as matlib
from cpugpupathtracing_tpu_torch.models.mesh import Mesh
from cpugpupathtracing_tpu_torch.ops import intersect
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from cpugpupathtracing_tpu_torch.ops.pt_frame import PT_STACK
from cpugpupathtracing_tpu_torch.utils.device import resolve_device
from cpugpupathtracing_tpu_torch.utils.log import except_error, log_warn
from cpugpupathtracing_tpu_torch.utils.vecmath import normalize

PRIM_MESH, PRIM_SPHERE, PRIM_PLANE = 0, 1, 2

# mesh lights: the kernels sample a light triangle from a table of at
# most this many rows (the JAX package's MESH_LIGHT_UNROLL_MAX default);
# a scene with more keeps no table and the gates refuse it
MESH_LIGHT_MAX_TRIS = 64
# the 8-bit-per-axis morton key of the split-span wavefront sort
MORTON_BITS = 8
# analytic sphere / plane tests run as a per-object loop up to this many
# objects and in the batched (N, S) form beyond (bitwise the same hits);
# the Whitted kernel's gate takes scenes of at most this many analytic
# objects and materials (the JAX package's limit, kept for parity)
ANALYTIC_UNROLL_MAX = 16

# (name, dtype) of every tensor field of DeviceScene, in order
TABLE_FIELDS = (
    ("pnodes", torch.float32),        # (BP, 64) slim closest-hit nodes
    ("pltris", torch.float32),        # (NL, 128) 8 x 16-col leaf records
    ("poccl_nodes", torch.float32),   # (BO, 64) slim any-hit nodes
    ("poccl_ltris", torch.float32),   # (NO, 128) 14 x 9-col leaf records
    ("mk_mats", torch.float32),       # (M, 14) material columns
    ("mk_lights", torch.float32),     # (L, 10) light columns
    ("mk_light_tris", torch.float32),  # (LT, 12) [v0, v1, v2, normal]
    ("mk_sph", torch.float32),        # (max(S,1), 6) center, r^2, mat, is_light
    ("mk_pln", torch.float32),        # (max(P,1), 7) point, normal, mat
    ("mk_objmat", torch.int32),       # (O,) object -> material
    ("mk_sph_mat", torch.int32),      # (max(S,1),) sphere material
    ("mk_pln_mat", torch.int32),      # (max(P,1),) plane material
    ("sph_obj", torch.int32),         # (S,) sphere -> object
    ("pln_obj", torch.int32),         # (P,) plane -> object
    ("world_lo", torch.float32),      # (3,) scene AABB low corner
    ("world_inv_extent", torch.float32),  # (3,) 1 / AABB extent
)
META_FIELDS = ("proots", "poccl_roots", "light_tri_meta", "num_lights",
               "num_sph", "num_pln", "has_mesh_lights")


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """Immutable device snapshot of a Scene: the tables of TABLE_FIELDS
    plus static metadata (roots, light-triangle ranges, counts)."""

    pnodes: torch.Tensor
    pltris: torch.Tensor
    poccl_nodes: torch.Tensor
    poccl_ltris: torch.Tensor
    mk_mats: torch.Tensor
    mk_lights: torch.Tensor
    mk_light_tris: torch.Tensor
    mk_sph: torch.Tensor
    mk_pln: torch.Tensor
    mk_objmat: torch.Tensor
    mk_sph_mat: torch.Tensor
    mk_pln_mat: torch.Tensor
    sph_obj: torch.Tensor
    pln_obj: torch.Tensor
    world_lo: torch.Tensor
    world_inv_extent: torch.Tensor
    proots: tuple
    poccl_roots: tuple
    # per-light (start, count) into mk_light_tris; (0, 0) for spheres
    light_tri_meta: tuple
    num_lights: int
    num_sph: int
    num_pln: int
    # any light is a mesh (its triangles are in light_tri_meta only when
    # they fit MESH_LIGHT_MAX_TRIS)
    has_mesh_lights: bool = False

    @property
    def device(self) -> torch.device:
        return self.pnodes.device

    @property
    def num_mats(self) -> int:
        return int(self.mk_mats.shape[0])

    @property
    def num_objs(self) -> int:
        return int(self.mk_objmat.shape[0])

    def tables(self) -> tuple:
        """The ten scene tables of pt_frame's positional arguments."""
        return (self.pnodes, self.pltris, self.mk_mats, self.mk_lights,
                self.mk_light_tris, self.mk_sph, self.mk_pln,
                self.mk_sph_mat, self.mk_pln_mat, self.mk_objmat)

    def table_bytes(self) -> dict:
        return {name: int(getattr(self, name).numel()
                          * getattr(self, name).element_size())
                for name, _ in TABLE_FIELDS}

    def to_numpy(self) -> tuple[dict, dict]:
        """(arrays, meta): the inverse of scene_from_numpy."""
        arrays = {name: getattr(self, name).cpu().numpy()
                  for name, _ in TABLE_FIELDS}
        meta = {name: getattr(self, name) for name in META_FIELDS}
        return arrays, meta


def scene_from_numpy(arrays: dict, meta: dict, device="cuda") -> DeviceScene:
    """DeviceScene from numpy tables named like TABLE_FIELDS (e.g. the
    leaves of a JAX package DeviceScene, np.asarray(getattr(dev, name)))
    and the static `meta` of META_FIELDS.  Used by the tests to hand both
    packages the same tables.  A missing any-hit tree (None: the JAX
    package builds none for a scene without meshes) becomes an empty
    one."""
    dev = resolve_device(device)
    empty = {"poccl_nodes": (0, 64), "poccl_ltris": (0, 128)}

    def table(name):
        a = arrays[name]
        if a is None and name in empty:
            a = np.zeros(empty[name], np.float32)
        return np.array(a, order="C")

    tensors = {
        name: torch.from_numpy(table(name)).to(device=dev, dtype=dtype)
        for name, dtype in TABLE_FIELDS
    }
    return DeviceScene(
        **tensors,
        proots=tuple(int(r) for r in meta["proots"]),
        poccl_roots=tuple(int(r) for r in meta["poccl_roots"]),
        light_tri_meta=tuple(
            (int(s), int(c)) for s, c in meta["light_tri_meta"]),
        num_lights=int(meta["num_lights"]),
        num_sph=int(meta["num_sph"]),
        num_pln=int(meta["num_pln"]),
        has_mesh_lights=bool(meta.get("has_mesh_lights", False)),
    )


@dataclasses.dataclass
class SceneObject:
    name: str
    mat_index: int
    kind: int  # PRIM_*
    mesh: Mesh | None = None
    sphere: tuple | None = None  # (center xyz, radius)
    plane: tuple | None = None   # (point xyz, normal xyz)


class Scene:
    """Mutable host scene; `device(device)` returns a cached immutable
    snapshot (rebuilt after any edit)."""

    def __init__(self):
        self.objects: list[SceneObject] = []
        self.materials: list[matlib.Material] = []
        self.light_indices: list[int] = []
        self._device: DeviceScene | None = None

    # -- construction (Source/Main.cpp:779-819 equivalents) --

    def add_material(self, material: matlib.Material) -> int:
        self.materials.append(material)
        self._device = None
        return len(self.materials) - 1

    def add_mesh(self, name: str, mesh: Mesh, mat_index: int) -> int:
        """Add a triangle mesh.  Its device trees are always built with
        the full-sweep SAH (BuildOption.SAH_SPLIT_PRIMITIVES); hits are
        exact for any valid tree."""
        self.objects.append(SceneObject(name, mat_index, PRIM_MESH, mesh=mesh))
        self._device = None
        return len(self.objects) - 1

    def add_sphere(self, name: str, center, radius: float, mat_index: int) -> int:
        self.objects.append(
            SceneObject(name, mat_index, PRIM_SPHERE, sphere=(tuple(center), radius))
        )
        self._device = None
        return len(self.objects) - 1

    def add_plane(self, name: str, point, normal, mat_index: int) -> int:
        self.objects.append(
            SceneObject(name, mat_index, PRIM_PLANE, plane=(tuple(point), tuple(normal)))
        )
        self._device = None
        return len(self.objects) - 1

    def mark_light(self, obj_index: int) -> None:
        """data.light_source_indices (Source/Main.cpp:816-819)."""
        self.light_indices.append(obj_index)
        self._device = None

    # -- device snapshot --

    def device(self, device="cuda") -> DeviceScene:
        dev = resolve_device(device)
        if self._device is None or self._device.device != dev:
            self._device = self.build_device(dev)
        return self._device

    def build_device(self, device="cuda") -> DeviceScene:
        dev = resolve_device(device)
        f32, i32 = np.float32, np.int32
        pnodes_l, ptris_l, proots = [], [], []
        onodes_l, oltris_l, oroots = [], [], []
        pnode_off = pleaf_off = onode_off = oleaf_off = 0
        pdepth = odepth = 0
        tri_off = 0
        tris9_l, tnrm_l = [], []
        mesh_tri_range: dict[int, tuple[int, int, float]] = {}
        mesh_bvh: dict[int, bvhlib.BVH] = {}
        wlo = np.full(3, np.inf, f32)
        whi = np.full(3, -np.inf, f32)
        sph = {k: [] for k in ("center", "radius", "obj")}
        pln = {k: [] for k in ("point", "normal", "obj")}

        for oi, obj in enumerate(self.objects):
            if obj.kind == PRIM_MESH:
                m = obj.mesh
                b = bvhlib.build(m.positions, m.normals, m.indices,
                                 BuildOption.SAH_SPLIT_PRIMITIVES,
                                 max_leaf_size=8)
                tris9_l.append(_pack_tris(b.tri_v0, b.tri_v1, b.tri_v2))
                tnrm_l.append(b.tri_normal)
                mesh_tri_range[oi] = (tri_off, b.num_triangles, b.total_area)
                mesh_bvh[oi] = b
                wlo = np.minimum(wlo, b.nodes_min[0])
                whi = np.maximum(whi, b.nodes_max[0])

                # closest-hit tables: object index stamped and triangle
                # ids made global in the leaf records, entries rebased
                pw = bvh8lib.to_slim(bvh8lib.collapse_sah(b, leaf_max=8),
                                     b.tri_normal)
                lt = pw.ltris.copy()
                ltv = lt.view(i32)
                for krec in range(8):
                    ltv[:, 16 * krec + 12] = oi
                    tidc = ltv[:, 16 * krec + 13]
                    tidc[tidc >= 0] += tri_off
                prow = pw.nodes.copy()
                pcidx = prow[:, 48:56].view(i32)
                pccnt = prow[:, 56:64].view(i32)
                pcidx[pccnt == 0] += pnode_off
                pcidx[pccnt > 0] -= pleaf_off  # leaf enc -(row+1)
                pnodes_l.append(prow)
                ptris_l.append(lt)
                proots.append(pnode_off)
                pnode_off += pw.num_nodes
                pleaf_off += pw.num_leaf_rows
                pdepth = max(pdepth, pw.max_depth)

                # any-hit tables over the same binary build
                po = bvh8lib.to_slim_occl(
                    bvh8lib.collapse_sah(b, leaf_max=bvh8lib.OCCL_TRIS))
                orow = po.nodes.copy()
                ocidx = orow[:, 48:56].view(i32)
                occnt = orow[:, 56:64].view(i32)
                ocidx[occnt == 0] += onode_off
                ocidx[occnt > 0] -= oleaf_off
                onodes_l.append(orow)
                oltris_l.append(po.ltris)
                oroots.append(onode_off)
                onode_off += po.num_nodes
                oleaf_off += po.num_leaf_rows
                odepth = max(odepth, po.max_depth)
                tri_off += b.num_triangles
            elif obj.kind == PRIM_SPHERE:
                c, r = obj.sphere
                sph["center"].append(c)
                sph["radius"].append(r)
                sph["obj"].append(oi)
                ca = np.asarray(c, f32)
                wlo = np.minimum(wlo, ca - r)
                whi = np.maximum(whi, ca + r)
            elif obj.kind == PRIM_PLANE:
                p, n = obj.plane
                pln["point"].append(p)
                pln["normal"].append(n)
                pln["obj"].append(oi)

        # the kernel's per-ray stack holds at most 7 pending siblings per
        # level plus the extra roots; refuse a tree that could overflow it
        for kind, depth, roots in (("closest-hit", pdepth, proots),
                                   ("any-hit", odepth, oroots)):
            need = 7 * (depth + 1) + 1 + max(len(roots), 1)
            if need > PT_STACK:
                except_error(
                    "Scene", "{} tree needs a {}-entry traversal stack, "
                    "more than the kernel's {}", kind, need, PT_STACK)

        if not np.isfinite(wlo).all():
            wlo = np.zeros(3, f32)
            whi = np.ones(3, f32)
        wext = np.maximum(whi - wlo, 1e-6).astype(f32)

        mk, light_tri_meta, has_mesh_lights = self._mk_tables(
            sph, pln, mesh_tri_range, mesh_bvh, tris9_l, tnrm_l)

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        def rows(parts, width):  # empty trees for a scene without meshes
            return np.concatenate(parts) if parts else np.zeros((0, width), f32)

        arrays = dict(
            pnodes=rows(pnodes_l, 64),
            pltris=rows(ptris_l, 128),
            poccl_nodes=rows(onodes_l, 64),
            poccl_ltris=rows(oltris_l, 128),
            sph_obj=np.asarray(sph["obj"], i32),
            pln_obj=np.asarray(pln["obj"], i32),
            world_lo=wlo.astype(f32),
            world_inv_extent=(1.0 / wext).astype(f32),
            **mk,
        )
        return DeviceScene(
            **{name: t(arrays[name], dtype) for name, dtype in TABLE_FIELDS},
            proots=tuple(proots),
            poccl_roots=tuple(oroots),
            light_tri_meta=tuple(light_tri_meta),
            num_lights=len(self.light_indices),
            num_sph=len(sph["center"]),
            num_pln=len(pln["point"]),
            has_mesh_lights=has_mesh_lights,
        )

    def _mk_tables(self, sph, pln, mesh_tri_range, mesh_bvh, tris9_l,
                   tnrm_l):
        """The small scene tables, in the JAX package's megakernel column
        layouts:
          mk_mats   (M, 14): albedo 0..2, specular 3, refractivity 4,
                    absorption 5..7, ior 8, emissive 9..11, intensity 12,
                    is_light 13
          mk_lights (L, 10): center 0..2, radius 3, area 4 (half sphere
                    2 pi r^2; mesh: total_area / 2), emission 5..7
                    (emissive * intensity), 8 unused, is_sphere 9
          mk_sph    (S, 6): center 0..2, radius^2 3, material 4, is_light 5
          mk_pln    (P, 7): point 0..2, normal 3..5, material 6
          mk_light_tris (LT, 12): v0, v1, v2, flat normal per light
                    triangle, light_tri_meta (start, count) per light,
                    (0, 0) for every light when the mesh lights' triangles
                    exceed MESH_LIGHT_MAX_TRIS (the gates then refuse the
                    scene), and whether any light is a mesh."""
        f32, i32 = np.float32, np.int32
        M = len(self.materials)
        mk_mats = np.zeros((max(M, 1), 14), f32)
        for mi, m in enumerate(self.materials):
            mk_mats[mi, 0:3] = m.albedo
            mk_mats[mi, 3] = m.specular
            mk_mats[mi, 4] = m.refractivity
            mk_mats[mi, 5:8] = m.absorption
            mk_mats[mi, 8] = m.ior
            mk_mats[mi, 9:12] = m.emissive
            mk_mats[mi, 12] = m.intensity
            mk_mats[mi, 13] = 1.0 if m.is_light else 0.0

        # lights (GetRandomLightSourceForSample, Source/Main.cpp:351-394)
        L = len(self.light_indices)
        mk_lights = np.zeros((max(L, 1), 10), f32)
        l_tri = []  # (global tri start, count) per light
        for li, oi in enumerate(self.light_indices):
            obj = self.objects[oi]
            lm = self.materials[obj.mat_index]
            if obj.kind == PRIM_SPHERE:
                radius = f32(obj.sphere[1])
                mk_lights[li, 0:3] = obj.sphere[0]
                mk_lights[li, 3] = radius
                mk_lights[li, 4] = f32(2.0 * 3.14159265) * radius ** 2
                mk_lights[li, 9] = 1.0
                l_tri.append((0, 0))
            elif obj.kind == PRIM_MESH:
                start, count, area = mesh_tri_range[oi]
                l_tri.append((start, count))
                # crude mesh-light area (Main.cpp:367); the center column
                # holds the area-weighted surface centroid
                mk_lights[li, 4] = f32(area / 2.0)
                b = mesh_bvh[oi]
                w_t = bvhlib.triangle_areas(b.tri_v0, b.tri_v1, b.tri_v2)
                cent = (b.tri_v0 + b.tri_v1 + b.tri_v2) / 3.0
                mk_lights[li, 0:3] = (cent * w_t[:, None]).sum(0) / max(
                    w_t.sum(), 1e-20)
            else:
                except_error(
                    "Scene",
                    "light source '{}' must be a sphere or mesh (Main.cpp:383)",
                    obj.name,
                )
            mk_lights[li, 5:8] = np.asarray(lm.emissive, f32) * f32(lm.intensity)

        # mesh-light NEE rows: one packed (12,) row per light triangle
        # [v0, v1, v2, flat normal] in per-light order; v1/v2 rebuilt from
        # the (v0, e1, e2) rows in f32
        lt_total = sum(c for _, c in l_tri)
        mk_light_tris = np.zeros((max(lt_total, 1), 12), f32)
        light_tri_meta = [(0, 0)] * L
        if lt_total and lt_total <= MESH_LIGHT_MAX_TRIS:
            tris9_h = np.concatenate(tris9_l).astype(f32)
            tnrm_h = np.concatenate(tnrm_l).astype(f32)
            cur = 0
            light_tri_meta = []
            for g0, c in l_tri:
                light_tri_meta.append((cur, c))
                rows = tris9_h[g0 : g0 + c]
                mk_light_tris[cur : cur + c, 0:3] = rows[:, 0:3]
                mk_light_tris[cur : cur + c, 3:6] = rows[:, 0:3] + rows[:, 3:6]
                mk_light_tris[cur : cur + c, 6:9] = rows[:, 0:3] + rows[:, 6:9]
                mk_light_tris[cur : cur + c, 9:12] = tnrm_h[g0 : g0 + c]
                cur += c

        S_ = len(sph["center"])
        mk_sph = np.zeros((max(S_, 1), 6), f32)
        for si in range(S_):
            mk_sph[si, 0:3] = sph["center"][si]
            mk_sph[si, 3] = f32(sph["radius"][si]) * f32(sph["radius"][si])
            mk_sph[si, 4] = self.objects[sph["obj"][si]].mat_index
            mk_sph[si, 5] = 1.0 if sph["obj"][si] in self.light_indices else 0.0
        P_ = len(pln["point"])
        mk_pln = np.zeros((max(P_, 1), 7), f32)
        for pi in range(P_):
            mk_pln[pi, 0:3] = pln["point"][pi]
            mk_pln[pi, 3:6] = pln["normal"][pi]
            mk_pln[pi, 6] = self.objects[pln["obj"][pi]].mat_index
        mk = dict(
            mk_mats=mk_mats,
            mk_lights=mk_lights,
            mk_light_tris=mk_light_tris,
            mk_sph=mk_sph,
            mk_pln=mk_pln,
            mk_objmat=np.asarray([o.mat_index for o in self.objects], i32),
            mk_sph_mat=np.asarray(
                [self.objects[o].mat_index for o in sph["obj"]] or [0], i32),
            mk_pln_mat=np.asarray(
                [self.objects[o].mat_index for o in pln["obj"]] or [0], i32),
        )
        return mk, light_tri_meta, lt_total > 0


def _pack_tris(v0, v1, v2) -> np.ndarray:
    """(T, 9) f32 rows [v0, e1, e2]."""
    out = np.empty((len(v0), 9), np.float32)
    out[:, 0:3] = v0
    out[:, 3:6] = np.asarray(v1) - np.asarray(v0)
    out[:, 6:9] = np.asarray(v2) - np.asarray(v0)
    return out


def reorder_key(dev: DeviceScene, origin, direction, act,
                bits: int = MORTON_BITS):
    """Ray-coherence sort key (the JAX package's scene.reorder_key):
    active-first | direction octant | origin morton at `bits` (5 or 8)
    bits per axis over the scene AABB.  (1 - act) sits at bit 3*bits + 3
    (active_bit), the octant at bits 3*bits .. 3*bits + 2.
    origin/direction (N, 3) f32, act (N,) int; returns (N,) int64."""
    q = ((origin - dev.world_lo) * dev.world_inv_extent * float(1 << bits))
    # bounded before the cast (an out-of-range float -> int is undefined);
    # the truncated value then clips exactly as the JAX key's does
    q = torch.clamp(q, -1.0, float(1 << bits)).to(torch.int32)
    q = torch.clamp(q.to(torch.int64), 0, (1 << bits) - 1)

    if bits <= 5:
        def spread(v):
            v = (v | (v << 8)) & 0x0300F
            v = (v | (v << 4)) & 0x030C3
            v = (v | (v << 2)) & 0x09249
            return v
    else:
        def spread(v):
            v = (v | (v << 16)) & 0x030000FF
            v = (v | (v << 8)) & 0x0300F00F
            v = (v | (v << 4)) & 0x030C30C3
            v = (v | (v << 2)) & 0x09249249
            return v

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    neg = (direction < 0).to(torch.int64)
    octant = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)
    act = act.to(torch.int64)
    return ((1 - act) << (3 * bits + 3)) | (octant << (3 * bits)) | morton


def active_bit(mode: str) -> int:
    """Bit of the sort key that holds (1 - active) for a sort_wavefront
    mode ("morton5": trace_whitted's and sorted_shadow_resolve's 5-bit
    key)."""
    return {"compact": 0, "morton5": 18, "morton8": 27}[mode]


# ---- route gates (the JAX package's scene.py:1915-2141) ----------------------
#
# The environment is read at every call: the port has no trace cache.
# The JAX gates' arms for the leaf-14, fused and 16-wide tables and the
# TLAS have no counterpart here (one thread per ray over the one 8-wide
# tree of a non-instanced scene), nor has the ADVANCED gates' budget of
# 16 analytic primitives (a TPU compile-time limit of unrolled tests).
# Where the JAX package asks for the TPU backend, the port asks for a
# scene on the card.


def packet_path_active(dev: DeviceScene) -> bool:
    """True when the scene's meshes are traced by the kernel of
    ops/traverse_packet_slim.py on the card -- where the JAX package runs
    its packet kernel, and where trace_whitted sorts the wavefront."""
    return bool(dev.proots) and dev.device.type == "cuda"


def whitted_kernel_active(dev: DeviceScene, settings) -> bool:
    """True when WHITTED mode runs the whole-frame Whitted kernel
    (ops/whitted_kernel.py) instead of the per-depth trace_whitted: an
    all-analytic scene (no mesh, no mesh light) within the JAX gate's
    limits of ANALYTIC_UNROLL_MAX objects and materials, 8 lights and
    depth 32, AOVs off, on the card.  CPUGPU_FORCE_WHITTED_KERNEL=1 takes
    it for a scene on the CPU too (the wrapper's plain version);
    CPUGPU_NO_WHITTED_KERNEL=1 opts out (A/B runs)."""
    return bool(
        (dev.device.type == "cuda"
         or os.environ.get("CPUGPU_FORCE_WHITTED_KERNEL") == "1")
        and os.environ.get("CPUGPU_NO_WHITTED_KERNEL") != "1"
        and not dev.proots
        and not dev.has_mesh_lights
        and dev.num_sph + dev.num_pln <= ANALYTIC_UNROLL_MAX
        and dev.num_lights <= 8
        and dev.num_mats <= ANALYTIC_UNROLL_MAX
        and settings.max_ray_depth <= 32
        and not settings.aovs_active
    )

_logged_reasons: set = set()


def _log_once(reason: str, what: str) -> None:
    if reason not in _logged_reasons:
        _logged_reasons.add(reason)
        log_warn("scene", "{}: {}", what, reason)


def megakernel_gate_reason(dev: DeviceScene, settings) -> str | None:
    """Why the per-depth pipeline (models/integrators.trace_advanced_mega)
    cannot run, or None when it can.  Where the JAX package then falls
    back to its XLA integrator, the port has no route yet."""
    if os.environ.get("CPUGPU_NO_MEGAKERNEL") == "1":
        return "CPUGPU_NO_MEGAKERNEL=1"
    if not dev.proots:
        return "no mesh object (the kernels walk a BVH)"
    if dev.has_mesh_lights and not any(c for _, c in dev.light_tri_meta):
        return (f"mesh lights over the {MESH_LIGHT_MAX_TRIS}-triangle "
                "light table")
    if settings.aovs_active:
        return "AOV tracking active"
    return None


def megakernel_active(dev: DeviceScene, settings) -> bool:
    """True when the per-depth pipeline can run; logs each distinct
    reason it cannot once."""
    reason = megakernel_gate_reason(dev, settings)
    if reason is not None:
        _log_once(reason, "per-depth pipeline unavailable")
    return reason is None


def ptframe_split(settings) -> int:
    """Depths of the split-span schedule's first span:
    CPUGPU_PTFRAME_SPLIT, else 2 when a path has more than three depths,
    else 0 (no split)."""
    env = os.environ.get("CPUGPU_PTFRAME_SPLIT")
    if env:
        return int(env)
    return 2 if settings.max_ray_depth + 1 > 3 else 0


def ptframe_max_nodes(split_on: bool) -> int:
    """Largest closest-hit tree (node rows) the whole-frame kernel takes:
    CPUGPU_PTFRAME_MAX_NODES, else 32768 with the split-span schedule
    and 2048 without (unsorted fans must stay cheap)."""
    env = os.environ.get("CPUGPU_PTFRAME_MAX_NODES")
    return int(env or ("32768" if split_on else "2048"))


def pt_frame_gate_reason(dev: DeviceScene, settings) -> str | None:
    """Why ADVANCED mode must leave the whole-frame kernel
    (integrators.trace_advanced_frame) for the per-depth pipeline, or
    None when it can run.  CPUGPU_NO_PTFRAME=1 opts out (A/B runs);
    CPUGPU_FORCE_PTFRAME=1 lifts the tree-size bound."""
    if os.environ.get("CPUGPU_NO_PTFRAME") == "1":
        return "CPUGPU_NO_PTFRAME=1"
    reason = megakernel_gate_reason(dev, settings)
    if reason is not None:
        return reason
    if settings.max_ray_depth > 32:
        return "max_ray_depth > 32"
    split_on = ptframe_split(settings) > 0
    max_nodes = ptframe_max_nodes(split_on)
    rows = int(dev.pnodes.shape[0])
    if rows > max_nodes and os.environ.get("CPUGPU_FORCE_PTFRAME") != "1":
        return (f"{rows}-row tree > {'split' if split_on else 'unsorted'}"
                f"-fan budget {max_nodes}")
    return None


def pt_frame_active(dev: DeviceScene, settings) -> bool:
    """True when ADVANCED mode runs the whole-frame kernel; logs each
    distinct reason of its own (not the per-depth gate's) once."""
    reason = pt_frame_gate_reason(dev, settings)
    if reason is not None and megakernel_gate_reason(dev, settings) is None:
        _log_once(reason, "whole-frame kernel unavailable, using the "
                          "per-depth pipeline")
    return reason is None


# ---- scene intersection (the JAX package's scene.py:2144-2373) --------------


class Hit(NamedTuple):
    """Nearest hit per lane: t, object index (-1 = miss), PRIM_* kind,
    primitive index (original triangle id, sphere or plane index) and the
    mesh hit's flat normal (3 (N,) columns)."""

    t: torch.Tensor
    obj: torch.Tensor
    kind: torch.Tensor
    prim: torch.Tensor
    normal: tuple | None


def _analytic_arm(origin, direction, t, obj, kind, prim, points, params,
                  objs, test, prim_kind):
    """Nearest analytic primitive of one kind closer than t: a strict <
    per-object loop (ties keep the lowest index) up to ANALYTIC_UNROLL_MAX
    objects, the batched (N, S) first-min form beyond; bitwise the same
    hits either way."""
    count = points.shape[0]
    if count == 0:
        return t, obj, kind, prim
    if count <= ANALYTIC_UNROLL_MAX:
        best = torch.full_like(t, float("inf"))
        bj = torch.zeros_like(obj)
        for j in range(count):
            valid, tj = test(origin, direction, points[j], params[j])
            closer = valid & (tj < t) & (tj < best)
            best = torch.where(closer, tj, best)
            bj = torch.where(closer, torch.full_like(bj, j), bj)
    else:
        valid, ts = test(origin[:, None, :], direction[:, None, :],
                         points[None], params[None])
        ts = torch.where(valid & (ts < t[:, None]), ts,
                         torch.full_like(ts, float("inf")))
        bj = torch.argmin(ts, dim=1).to(obj.dtype)  # the first minimum
        best = torch.gather(ts, 1, bj[:, None].long())[:, 0]
    closer = torch.isfinite(best)
    return (torch.where(closer, best, t),
            torch.where(closer, objs[bj.long()], obj),
            torch.where(closer, torch.full_like(kind, prim_kind), kind),
            torch.where(closer, bj, prim))


def intersect_scene(dev: DeviceScene, origin, direction, t_init, *,
                    any_hit: bool = False, active=None,
                    count_depth: bool = False) -> Hit:
    """Nearest hit closer than t_init across every object
    (IntersectScene, Source/Main.cpp:299-316): the mesh trees through
    ops/traverse_packet_slim (closest or any hit; `active` masks lanes
    out of the traversal), then the analytic spheres and planes.  Rows of
    lanes that are not active are unspecified.  With any_hit, `obj >= 0`
    says whether anything lies closer than t_init (the analytic loop's
    nearest hit and an any-hit agree on existence).

    origin/direction: (N, 3) tensors or 3-tuples of (N,) columns.  The
    JAX function's BVH depth count (count_depth, the debug AOVs) waits
    for ROADMAP.md A9 and raises; instanced scenes (A8) do not exist in
    the port yet."""
    if count_depth:
        raise NotImplementedError(
            "intersect_scene: count_depth (the BVH_DEPTH AOV) is not ported; "
            "see ROADMAP.md A9")
    if isinstance(origin, tuple):
        o_c, d_c = origin, direction
        origin = torch.stack(origin, dim=1)
        direction = torch.stack(direction, dim=1)
    else:
        o_c = tuple(origin[:, k].contiguous() for k in range(3))
        d_c = tuple(direction[:, k].contiguous() for k in range(3))
    n = origin.shape[0]
    i32 = torch.int32
    t = t_init
    obj = torch.full((n,), -1, dtype=i32, device=origin.device)
    kind = torch.full_like(obj, PRIM_MESH)
    prim = torch.full_like(obj, -1)
    normal = None
    if dev.proots:
        t, tri, mobj, normal = tps.traverse_packet_slim(
            o_c, d_c, t_init, dev.pnodes, dev.pltris, dev.proots,
            active=active, any_hit=any_hit)
        mesh_hit = tri >= 0
        obj = torch.where(mesh_hit, mobj, obj)
        prim = torch.where(mesh_hit, tri, prim)
    t, obj, kind, prim = _analytic_arm(
        origin, direction, t, obj, kind, prim, dev.mk_sph[:dev.num_sph, 0:3],
        dev.mk_sph[:dev.num_sph, 3], dev.sph_obj, intersect.intersect_sphere,
        PRIM_SPHERE)
    t, obj, kind, prim = _analytic_arm(
        origin, direction, t, obj, kind, prim, dev.mk_pln[:dev.num_pln, 0:3],
        dev.mk_pln[:dev.num_pln, 3:6], dev.pln_obj, intersect.intersect_plane,
        PRIM_PLANE)
    return Hit(t=t, obj=obj, kind=kind, prim=prim, normal=normal)


def hit_surface(dev: DeviceScene, hit: Hit, origin, direction):
    """GetRayHitResult (Source/Main.cpp:325-338): hit position, geometric
    normal (the flat triangle normal of a mesh hit) and material index
    per lane; origin/direction (N, 3).  Lanes that missed get clamped
    garbage the caller masks."""
    pos = origin + direction * hit.t[:, None]
    pc = torch.clamp(hit.prim, min=0).long()
    zero = torch.zeros_like(pos)
    n_mesh = zero if hit.normal is None else torch.stack(hit.normal, dim=1)
    n_sph = n_pln = zero
    if dev.num_sph:
        centers = dev.mk_sph[:dev.num_sph, 0:3]
        n_sph = normalize(pos - centers[torch.clamp(pc, max=dev.num_sph - 1)])
    if dev.num_pln:
        n_pln = dev.mk_pln[:dev.num_pln, 3:6][
            torch.clamp(pc, max=dev.num_pln - 1)]
    normal = torch.where((hit.kind == PRIM_SPHERE)[:, None], n_sph,
                         torch.where((hit.kind == PRIM_PLANE)[:, None], n_pln,
                                     n_mesh))
    mat_idx = dev.mk_objmat[torch.clamp(hit.obj, min=0).long()]
    return pos, normal, mat_idx


def make_reference_scene(dragon_mesh: Mesh | None = None) -> Scene:
    """The reference's hard-coded default scene (Source/Main.cpp:777-819):
    glass dragon, 2000x2000 ground quad at y=-3, and two emissive spheres
    r=5 intensity 10.  The dragon mesh defaults to the ~92k-tri
    procedural stand-in (DragonAttenuation.bin is absent)."""
    from cpugpupathtracing_tpu_torch.models import mesh as meshlib

    s = Scene()
    s.add_material(matlib.Material.diffuse((0.2, 0.2, 0.8)))            # 0: blue
    s.add_material(matlib.Material.diffuse((1.0, 1.0, 1.0)))            # 1: white
    s.add_material(matlib.Material.light((1.0, 0.95, 0.8), 10.0))       # 2: warm light
    s.add_material(
        matlib.Material.dielectric((1.0, 1.0, 1.0), 0.0, 1.0, (0.2, 0.8, 0.8), 1.517)
    )                                                                    # 3: glass
    dm = dragon_mesh if dragon_mesh is not None else meshlib.dragon_standin()
    s.add_mesh("Dragon", dm, 3)
    s.add_mesh("Ground", meshlib.ground_quad(), 1)
    i0 = s.add_sphere("Spherical light0", (10.0, 10.0, 10.0), 5.0, 2)
    s.mark_light(i0)
    i1 = s.add_sphere("Spherical light1", (-10.0, 10.0, -10.0), 5.0, 2)
    s.mark_light(i1)
    return s
