"""Scene model: host-side object list and the device tables the
path-tracing kernels read.

The port of the JAX package's `Scene._build_device` and `_refit_device`
(models/scene.py there), for scenes of meshes, instanced meshes, spheres
and planes.  Every mesh gets a slim closest-hit tree `pnodes`/`pltris`
(shading-complete leaf records, bvh8.to_slim) and, with CPUGPU_OCCL, an
any-hit tree `poccl_nodes`/`poccl_ltris` (the SAH-cost DP collapse at
leaf_max 14 of a full-sweep SAH binary build, bare 14-record leaf rows,
bvh8.to_slim_occl).  Objects are concatenated into one table per kind,
with one root per object (`proots`, `poccl_roots`).

The node tables follow the JAX package's variables, read from the
environment whenever a scene is built (config.packet_flags), and are
bitwise the JAX package's under the same values:
  * CPUGPU_PACKET_TREE: how the closest-hit tree is built -- fat, dp,
    sweep, sweep_dp (8-wide (B, 64) rows) or w16 (16-wide (B, 128) rows,
    kept only when no instance needs the object-space machinery; such a
    scene falls back to sweep_dp);
  * CPUGPU_OCCL=1: the any-hit tables;
  * CPUGPU_OCCL2=1 (implies CPUGPU_OCCL): any-hit leaves of two rows, up
    to 28 records (`poccl_rows` 2); CPUGPU_OCCL_W16=1 (implies it too):
    a 16-wide any-hit tree ((BO, 128) rows, `poccl_width` 16) where no
    mesh is instanced; CPUGPU_LEAF14=1 (builds the any-hit tables): the
    leaf-14 payload rows `poccl_pay` (bvh8.occl_payload; on a flattened
    scene repacked from the shading records like the geometry), over
    which the per-depth route's closest hits walk the any-hit tree.  The
    any-hit tables are kept only where the JAX kernels' shadow stack
    holds them (as in the JAX package), and the JAX package's conflicts
    of these flags raise (config.packet_flags);
  * CPUGPU_FUSED=1: `pfused`, one (BP + NL, 128) node|leaf table whose
    leaf entries are nn + leaf row (not on the object-space machinery);
  * CPUGPU_SMEMTREE=1|48 (with CPUGPU_SMEMTREE_MIN_NODES): the entry side
    tables `pents`/`poccl_ents` (8-wide, not fused, not on the
    machinery; `poccl_ents` of an 8-wide any-hit tree only), and in mode
    48, on scenes without instances and under
    the JAX condition CPUGPU_FRAMESTACK=1, CPUGPU_ROWX=1, the 48-col
    bounds-only rows `pnodes48`/`poccl_nodes48`.  A tree under the
    minimum (`smem_small`) hands them to the whole-frame kernel only.
An unset variable takes the JAX package's benchmark value
(bench_flags_default.json): CPUGPU_PACKET_TREE=sweep_dp, CPUGPU_OCCL=1,
CPUGPU_SMEMTREE=48, CPUGPU_FRAMESTACK=1 -- so by default the port builds
and walks the tables the JAX benchmark does (the 48-col rows and side
tables on config 3).  CPUGPU_SMEMTREE=0 gives the plain 64-col tables.
`packet_tables` / `occl_tables` pick what each kernel walks, as in the
JAX package.  A scene without meshes (benchmark config 1) gets empty
trees and no roots.

Instanced meshes (one BLAS, many object-to-world transforms) sit under a
TLAS whose root is the last root.  When the world-space copies of their
BLASes fit CPUGPU_FLATTEN_BUDGET_MB (default 64) and CPUGPU_NO_FLATTEN
is not 1, the scene is flattened: each instance gets its own world-space
copy of the tables and the kernels run their plain arms.  Otherwise the
object-space machinery runs: the TLAS's instance entries carry the
instance id, the kernels move the ray by `inst_inv` into the instance's
space, and shadow rays keep the shading tables.  A transform edit
(`set_instance_transform`) refits the snapshot in place on its device;
the live edits (`set_material`, `set_sphere`, `set_plane`, `rebuild_bvh`,
which sets a mesh's build option) drop it, and the next `device()` builds
a new one.  `object_stats` reports each object, a mesh with its own
binary BVH under its build option (`own_bvh`, the reference's BVH panel).

The small scene tables (materials, lights, spheres, planes, object ->
material) keep the column layouts of the JAX package's
ops/megakernel.py, listed at `_mk_tables`.

`intersect_scene` and `hit_surface` are the nearest hit over every object
(the mesh trees through ops/traverse_packet_slim.py, then the analytic
spheres and planes) and its surface, as the Whitted integrator
(models/whitted.py) and the XLA integrator (models/integrators.py
trace_advanced) use them; the tables of the latter's light sampling
(`tris9`, `tri_normal`, `light_*`) are here too.  The route gates of the kernels live here
too, as in the JAX package.

`Scene(traversal=...)` picks the walk of intersect_scene as the JAX
package's argument does: "packet" (the default) the kernels over the slim
tables above; "wide", "skip" or "binary" (use_wide=False) an XLA walk
(ops/traverse_wide.py, ops/traverse_skip.py, ops/traverse.py) in PyTorch
over its own tables (WALK_FIELDS, made from each mesh's own BVH,
own_bvh), which no kernel route takes.  A walk snapshot builds no packet
table and a packet snapshot no walk table.  A "packet" scene whose tree
the kernels' stack cannot hold raises (the JAX package falls back to
"wide" there; the port takes a walk only when the caller asks for one).
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from cpugpupathtracing_tpu_torch.config import BuildOption, packet_flags
from cpugpupathtracing_tpu_torch.models import bvh as bvhlib
from cpugpupathtracing_tpu_torch.models import bvh8 as bvh8lib
from cpugpupathtracing_tpu_torch.models import materials as matlib
from cpugpupathtracing_tpu_torch.models.mesh import Mesh
from cpugpupathtracing_tpu_torch.ops import intersect
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import traverse as trav
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from cpugpupathtracing_tpu_torch.ops import traverse_skip as tsk
from cpugpupathtracing_tpu_torch.ops import traverse_wide as tw
from cpugpupathtracing_tpu_torch.ops.gathers import select_rows
from cpugpupathtracing_tpu_torch.ops.pt_frame import PT_STACK, PT_STACK_W16
from cpugpupathtracing_tpu_torch.utils.device import resolve_device
from cpugpupathtracing_tpu_torch.utils.log import except_error, log_warn
from cpugpupathtracing_tpu_torch.utils.vecmath import normalize, sqrt

PRIM_MESH, PRIM_SPHERE, PRIM_PLANE = 0, 1, 2

# mesh lights: the kernels sample a light triangle from a table of at
# most this many rows (the JAX package's MESH_LIGHT_UNROLL_MAX default);
# a scene with more keeps no table and the gates refuse it
MESH_LIGHT_MAX_TRIS = 64
# the 8-bit-per-axis morton key of the split-span wavefront sort
MORTON_BITS = 8
# the Whitted kernel's gate takes scenes of at most this many analytic
# objects and materials (the JAX package's limit, kept for parity)
ANALYTIC_UNROLL_MAX = 16
# leaf bound of an object's own binary BVH (object_stats), the JAX
# package's DEVICE_MAX_LEAF: the tree the reference's BVH panel shows
DEVICE_MAX_LEAF = 4
# the JAX kernels' shadow-walk stacks: frames of its frame-stack schedule
# (CPUGPU_FRAMESTACK, forced at width 16) and slots of the linear one
# (its traverse_packet_slim FSTACK_FRAMES, STACK).  JAX keeps the any-hit
# tables only where its shadow walk's stack holds them; the port copies
# the rule so that its tables are JAX's, and refuses on its own what its
# kernels' stacks (PT_STACK, PT_STACK_W16) cannot hold.
JAX_FSTACK_FRAMES = 24
JAX_SLOT_STACK = 64

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
    ("inst_inv", torch.float32),      # (I, 12) world -> object, 3x4 rows
    ("inst_nrm", torch.float32),      # (I, 9) normal matrix inv(M)^T
    ("inst_blas_root_packet", torch.int32),  # (I,) slim row of the BLAS root
    ("inst_obj", torch.int32),        # (I,) owning object
    # the XLA integrator's tables (models/integrators.trace_advanced), in
    # the JAX package's names: every mesh's triangles once, in global
    # original order and in object space (an instanced mesh's too, so a
    # refit leaves them as they are), and one row per light
    ("tris9", torch.float32),         # (T, 9) [v0, e1, e2]
    ("tri_normal", torch.float32),    # (T, 3) flat normal
    ("light_obj", torch.int32),       # (L,) light -> object
    ("light_is_sphere", torch.bool),  # (L,)
    ("light_sph_center", torch.float32),  # (L, 3) center (mesh: centroid)
    ("light_sph_radius", torch.float32),  # (L,) radius (mesh: 0)
    ("light_sph_radius_sq", torch.float32),  # (L,)
    ("light_tri_start", torch.int32),  # (L,) first triangle in tris9
    ("light_tri_count", torch.int32),  # (L,) triangles (sphere: 0)
    ("light_half_area", torch.float32),  # (L,) mesh total_area / 2
)
# the node-table variants, None when the scene's flags build none
# (the JAX package's names)
VARIANT_FIELDS = (
    ("pents", torch.int32),          # (BP + V, 8) closest-hit entries
    ("pnodes48", torch.float32),     # (BP, 48) bounds, NaN empty slots
    ("poccl_ents", torch.int32),     # (BO + V, 8) any-hit entries
    ("poccl_nodes48", torch.float32),  # (BO, 48)
    ("pfused", torch.float32),       # (BP + NL, 128) node|leaf rows
    ("poccl_pay", torch.float32),    # (NO, 128) leaf-14 payload rows
)
# the tables of the XLA walks (ops/traverse*.py), None where the snapshot's
# walk does not read them (the JAX package's names; a "packet" snapshot
# builds none of them)
WALK_FIELDS = (
    ("tri_obj", torch.int32),         # (T,) owning object (every walk)
    ("nodes8", torch.float32),        # (B, 8) binary nodes ("binary")
    ("tri_perm", torch.int32),        # (T,) leaf order -> global tri
    ("wnodes", torch.float32),        # (B8, 64) 8-wide rows ("wide")
    ("wtris9", torch.float32),        # (TW, 9) leaf order
    ("wleaf_id", torch.int32),        # (TW,) leaf order -> original id
    ("inst_blas_root", torch.int32),  # (I,) wide row of the BLAS root
    ("snodes12", torch.float32),      # (BS, 12) threaded rows ("skip")
    ("stris9", torch.float32),        # (T, 9) leaf order
    ("sleaf_id", torch.int32),        # (T,) leaf order -> original id
    ("inst_blas_root_skip", torch.int32),  # (I,) skip row of the BLAS root
)
META_FIELDS = ("proots", "poccl_roots", "light_tri_meta", "num_lights",
               "num_sph", "num_pln", "has_mesh_lights", "num_instances",
               "packet_flattened", "pfused_nn", "packet_width",
               "smem_small", "poccl_width", "poccl_rows")
# the walk's metadata (scene_from_numpy: "packet" and no roots when absent)
WALK_META = ("traversal", "use_wide", "roots", "wroots", "wstack_depth",
             "sroot")
# the walks a snapshot can resolve to (Scene's traversal argument)
TRAVERSALS = ("packet", "wide", "skip", "binary")


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """Device snapshot of a Scene: the tables of TABLE_FIELDS plus static
    metadata (roots, light-triangle ranges, counts).  A transform-only
    edit of an instanced scene refits the snapshot in place
    (Scene.device); every other edit builds a new one."""

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
    inst_inv: torch.Tensor
    inst_nrm: torch.Tensor
    inst_blas_root_packet: torch.Tensor
    inst_obj: torch.Tensor
    tris9: torch.Tensor
    tri_normal: torch.Tensor
    light_obj: torch.Tensor
    light_is_sphere: torch.Tensor
    light_sph_center: torch.Tensor
    light_sph_radius: torch.Tensor
    light_sph_radius_sq: torch.Tensor
    light_tri_start: torch.Tensor
    light_tri_count: torch.Tensor
    light_half_area: torch.Tensor
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
    num_instances: int = 0
    # instanced BLASes replicated into world space (the kernels' plain
    # arms run); False with instances = the object-space TLAS machinery
    packet_flattened: bool = False
    # the node-table variants (VARIANT_FIELDS) and their metadata: node
    # rows of pfused (0 without it), the closest-hit arity (8: (BP, 64)
    # rows, 16: (BP, 128)), and whether the side tables go to the
    # whole-frame kernel only (a tree under CPUGPU_SMEMTREE_MIN_NODES)
    pents: torch.Tensor | None = None
    pnodes48: torch.Tensor | None = None
    poccl_ents: torch.Tensor | None = None
    poccl_nodes48: torch.Tensor | None = None
    pfused: torch.Tensor | None = None
    pfused_nn: int = 0
    packet_width: int = 8
    smem_small: bool = False
    # the any-hit tree's leaf payload rows (CPUGPU_LEAF14), its arity (8:
    # (BO, 64) rows, 16: (BO, 128)) and rows per leaf (2: CPUGPU_OCCL2)
    poccl_pay: torch.Tensor | None = None
    poccl_width: int = 8
    poccl_rows: int = 1
    # the walk of intersect_scene (TRAVERSALS): "packet" the kernels over
    # the tables above; "wide", "skip" or "binary" an XLA walk over its
    # tables of WALK_FIELDS (the packet tables then empty, proots none),
    # with its roots (binary), wroots and wstack_depth (wide) or sroot
    # (skip); use_wide as the JAX package's (False: the binary walk)
    traversal: str = "packet"
    use_wide: bool = True
    tri_obj: torch.Tensor | None = None
    nodes8: torch.Tensor | None = None
    tri_perm: torch.Tensor | None = None
    wnodes: torch.Tensor | None = None
    wtris9: torch.Tensor | None = None
    wleaf_id: torch.Tensor | None = None
    inst_blas_root: torch.Tensor | None = None
    snodes12: torch.Tensor | None = None
    stris9: torch.Tensor | None = None
    sleaf_id: torch.Tensor | None = None
    inst_blas_root_skip: torch.Tensor | None = None
    roots: tuple = ()
    wroots: tuple = ()
    wstack_depth: int = 48
    sroot: int = -1
    # what a refit needs (Scene._refit_device); None for a snapshot made
    # from numpy tables
    refit: dict | None = dataclasses.field(default=None, compare=False,
                                           repr=False)
    # the XLA walk's CUDA graphs (ops/traverse.py run_walk): they read
    # this snapshot's tables, and die with it (a new one after replace)
    walk_graphs: dict = dataclasses.field(
        default_factory=trav.graph_cache, init=False, compare=False,
        repr=False)

    @property
    def device(self) -> torch.device:
        return self.pnodes.device

    @property
    def num_mats(self) -> int:
        return int(self.mk_mats.shape[0])

    @property
    def num_objs(self) -> int:
        return int(self.mk_objmat.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.tris9.shape[0])

    @property
    def machinery(self) -> bool:
        """True when the kernels run the object-space instance arms."""
        return self.num_instances > 0 and not self.packet_flattened

    def tables(self) -> tuple:
        """The ten scene tables of pt_frame's positional arguments."""
        return (self.pnodes, self.pltris, self.mk_mats, self.mk_lights,
                self.mk_light_tris, self.mk_sph, self.mk_pln,
                self.mk_sph_mat, self.mk_pln_mat, self.mk_objmat)

    def inst_kwargs(self, nrm: bool = True) -> dict:
        """The instance arguments of the kernel wrappers: inst_inv,
        inst_root (and inst_nrm) on the object-space machinery, none
        otherwise."""
        if not self.machinery:
            return {}
        kw = dict(inst_inv=self.inst_inv, inst_root=self.inst_blas_root_packet)
        if nrm:
            kw["inst_nrm"] = self.inst_nrm
        return kw

    @property
    def node_table(self) -> torch.Tensor:
        """The node rows the snapshot's walk reads: pnodes, or the XLA
        walk's nodes8 / wnodes / snodes12 (the empty pnodes of a scene
        without meshes)."""
        t = {"packet": self.pnodes, "binary": self.nodes8,
             "wide": self.wnodes, "skip": self.snodes12}[self.traversal]
        return self.pnodes if t is None else t  # no mesh: no walk table

    def table_bytes(self) -> dict:
        return {name: int(getattr(self, name).numel()
                          * getattr(self, name).element_size())
                for name, _ in TABLE_FIELDS + VARIANT_FIELDS + WALK_FIELDS
                if getattr(self, name) is not None}

    def to_numpy(self) -> tuple[dict, dict]:
        """(arrays, meta): the inverse of scene_from_numpy."""
        arrays = {name: None if getattr(self, name) is None
                  else getattr(self, name).cpu().numpy()
                  for name, _ in TABLE_FIELDS + VARIANT_FIELDS + WALK_FIELDS}
        meta = {name: getattr(self, name) for name in META_FIELDS + WALK_META}
        return arrays, meta


def scene_from_numpy(arrays: dict, meta: dict, device="cuda") -> DeviceScene:
    """DeviceScene from numpy tables named like TABLE_FIELDS (e.g. the
    leaves of a JAX package DeviceScene, np.asarray(getattr(dev, name)))
    and the static `meta` of META_FIELDS; the variant tables of
    VARIANT_FIELDS and the walk tables of WALK_FIELDS are carried where
    given (None or absent: not built), with the walk's metadata
    (traversal "packet" when absent).  Used by the tests to hand both
    packages the same tables.  A missing
    any-hit tree (None: the JAX package builds none for a scene without
    meshes, nor for one on the object-space instance machinery) becomes
    an empty one, missing instance tables empty ones."""
    dev = resolve_device(device)
    empty = {"poccl_nodes": (0, 64), "poccl_ltris": (0, 128),
             "inst_inv": (0, 12), "inst_nrm": (0, 9),
             "inst_blas_root_packet": (0,), "inst_obj": (0,)}

    def table(name, dtype):
        a = arrays.get(name)
        if a is None and name in empty:
            a = np.zeros(empty[name], np.float32 if dtype == torch.float32
                         else np.int32)
        return np.array(a, order="C")

    tensors = {
        name: torch.from_numpy(table(name, dtype)).to(device=dev, dtype=dtype)
        for name, dtype in TABLE_FIELDS
    }
    for name, dtype in VARIANT_FIELDS + WALK_FIELDS:
        a = arrays.get(name)
        tensors[name] = None if a is None else torch.from_numpy(
            np.array(a, order="C")).to(device=dev, dtype=dtype)
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
        num_instances=int(meta.get("num_instances", 0)),
        packet_flattened=bool(meta.get("packet_flattened", False)),
        pfused_nn=int(meta.get("pfused_nn", 0)),
        packet_width=int(meta.get("packet_width", 8)),
        smem_small=bool(meta.get("smem_small", False)),
        poccl_width=int(meta.get("poccl_width", 8)),
        poccl_rows=int(meta.get("poccl_rows", 1)),
        traversal=str(meta.get("traversal", "packet")),
        use_wide=bool(meta.get("use_wide", True)),
        roots=tuple(int(r) for r in meta.get("roots", ())),
        wroots=tuple(int(r) for r in meta.get("wroots", ())),
        wstack_depth=int(meta.get("wstack_depth", 48)),
        sroot=int(meta.get("sroot", -1)),
    )


@dataclasses.dataclass
class SceneObject:
    name: str
    mat_index: int
    kind: int  # PRIM_*
    mesh: Mesh | None = None
    sphere: tuple | None = None  # (center xyz, radius)
    plane: tuple | None = None   # (point xyz, normal xyz)
    # instanced mesh: (I, 4, 4) object-to-world transforms; one BLAS is
    # built and referenced from the TLAS once per instance
    instances: np.ndarray | None = None
    # the mesh's build heuristic (BVH::Rebuild's option): the closest-hit
    # tree of modes fat and dp and the object's own BVH (object_stats)
    build_option: BuildOption = BuildOption.SAH_SPLIT_INTERVALS
    # (mesh, _Blas) of the mesh, kept across snapshots (_blas)
    blas: tuple | None = None
    # (mesh, build_option, BVH): the object's own binary BVH at
    # DEVICE_MAX_LEAF, built when object_stats or an XLA walk first asks
    # (own_bvh)
    own: tuple | None = None
    # (own BVH, BVH8): its 8-wide collapse, the wide walk's tree (_wide_tree)
    wide: tuple | None = None


class _Blas(NamedTuple):
    """The trees of one mesh: its full-sweep SAH binary build (leaf <= 8),
    the slim closest-hit tree of each CPUGPU_PACKET_TREE mode built so
    far (`pw`, filled by _packet_tree; modes fat and dp keyed with the
    build option too) and the any-hit trees of each leaf
    size and arity built so far (`po`, filled by _occl_tree)."""

    b: bvhlib.BVH
    pw: dict
    po: dict


class _Occl(NamedTuple):
    """One any-hit tree of a mesh: the collapse, its slim tables, and its
    leaf-14 payload rows (8-wide 1-row leaves; built when first asked)."""

    wo: bvh8lib.BVH8
    po: bvh8lib.BVH8Slim
    pay: np.ndarray | None


def _blas(obj: SceneObject) -> _Blas:
    """The object's trees, built once per mesh (full-sweep SAH binary
    build, leaf <= 8)."""
    if obj.blas is None or obj.blas[0] is not obj.mesh:
        m = obj.mesh
        b = bvhlib.build(m.positions, m.normals, m.indices,
                         BuildOption.SAH_SPLIT_PRIMITIVES, max_leaf_size=8)
        obj.blas = (obj.mesh, _Blas(b, {}, {}))
    return obj.blas[1]


def _occl_tree(obj: SceneObject, rows: int = 1, width: int = 8,
               pay: bool = False) -> _Occl:
    """The object's any-hit tree (the JAX package's _build_occl_cache):
    the SAH-cost DP collapse at leaf_max 14 * rows and arity `width` of
    the full-sweep build, bare 14-record leaf rows, `rows` per leaf
    (bvh8.to_slim_occl), and with pay the leaf-14 payload rows
    (bvh8.occl_payload), cached per (rows, width)."""
    t = _blas(obj)
    key = (rows, width)
    if key not in t.po:
        wo = bvh8lib.collapse_sah(t.b, leaf_max=bvh8lib.OCCL_TRIS * rows,
                                  width=width)
        t.po[key] = _Occl(wo, bvh8lib.to_slim_occl(wo, rows_per_leaf=rows),
                          None)
    if pay and t.po[key].pay is None:
        t.po[key] = t.po[key]._replace(
            pay=bvh8lib.occl_payload(t.po[key].wo, t.b.tri_normal))
    return t.po[key]


def _packet_tree(obj: SceneObject, mode: str) -> bvh8lib.BVH8Slim:
    """The object's slim closest-hit tree in CPUGPU_PACKET_TREE mode
    `mode` (the JAX package's _build_wide_cache), cached per mode and,
    for the modes fat and dp that rebuild with the object's build option,
    per option."""
    t = _blas(obj)
    heuristic = obj.build_option
    key = (mode, heuristic) if mode in ("fat", "dp") else mode
    if key not in t.pw:
        b = t.b
        if mode == "fat":
            # fat leaves: a slim leaf is one row, so under-filled SAH
            # leaves would waste most of a leaf visit
            pb = b.rebuild(heuristic, max_leaf_size=8, leaf_stop=8)
            w = bvh8lib.collapse(pb, leaf_max=8)
        elif mode == "dp":
            pb = b.rebuild(heuristic, max_leaf_size=8)
            w = bvh8lib.collapse_sah(pb, leaf_max=8)
        elif mode == "sweep":
            pb = b.rebuild(BuildOption.SAH_SPLIT_PRIMITIVES, max_leaf_size=8,
                           leaf_stop=8)
            w = bvh8lib.collapse(pb, leaf_max=8)
        else:  # sweep_dp, w16: the full-sweep build b itself
            pb = b
            w = bvh8lib.collapse_sah(b, leaf_max=8,
                                     width=16 if mode == "w16" else 8)
        t.pw[key] = bvh8lib.to_slim(w, pb.tri_normal)
    return t.pw[key]


def own_bvh(obj: SceneObject) -> bvhlib.BVH:
    """The mesh object's own binary BVH, the tree the reference's BVH
    panel reports (the JAX package's SceneObject.bvh): built under the
    object's build option with leaves of at most DEVICE_MAX_LEAF, when
    first asked and again after rebuild_bvh; no kernel walks it, the XLA
    walks' tables are made from it."""
    if (obj.own is None or obj.own[0] is not obj.mesh
            or obj.own[1] != obj.build_option):
        m = obj.mesh
        obj.own = (m, obj.build_option, bvhlib.build(
            m.positions, m.normals, m.indices, obj.build_option,
            max_leaf_size=DEVICE_MAX_LEAF))
    return obj.own[2]


def _wide_tree(obj: SceneObject) -> bvh8lib.BVH8:
    """The wide walk's tree of a mesh object: the greedy 8-wide collapse
    of own_bvh at leaf_max 4 (the JAX package's bvh8.collapse default,
    the LEAF_MAX triangles traverse8 tests per leaf step), cached per own
    BVH."""
    b = own_bvh(obj)
    if obj.wide is None or obj.wide[0] is not b:
        obj.wide = (b, bvh8lib.collapse(b, leaf_max=tw.LEAF_MAX))
    return obj.wide[1]


class Scene:
    """Mutable host scene; `device(device)` returns a cached snapshot,
    rebuilt after any edit but an instance transform, after which it is
    refit.

    traversal (the JAX package's argument): "packet" (the kernels over the
    slim tables; the default), "wide" (the 8-wide ordered stack walk),
    "skip" (the stackless threaded walk) or "binary" (the walk shaped like
    the reference's, whose bvh_depth is its payload.bvh_depth);
    use_wide=False forces "binary".  The last three are XLA walks
    (ops/traverse*.py) in PyTorch, on the card or the CPU; no kernel route
    takes their snapshots.  As in the JAX package a scene without meshes
    resolves to "binary"; a "packet" scene whose tree the kernels' stack
    cannot hold raises and names Scene(traversal="wide").  Instanced
    meshes need the wide or skip walk.  (The JAX package's intersect_scene
    walks its wide tree for Scene(traversal="binary"), since it tests
    use_wide first; here "binary" walks the binary tree however asked.)"""

    def __init__(self, use_wide: bool = True, traversal: str = "packet"):
        if traversal not in TRAVERSALS:
            except_error("Scene", "unknown traversal '{}' (one of {})",
                         traversal, ", ".join(TRAVERSALS))
        self.use_wide = use_wide
        self.traversal = traversal if use_wide else "binary"
        self.objects: list[SceneObject] = []
        self.materials: list[matlib.Material] = []
        self.light_indices: list[int] = []
        self._device: DeviceScene | None = None
        self._flags = None  # the packet_flags the snapshot was built under
        self._transforms_dirty = False
        # what the last build_device decided: flat_bytes against
        # flatten_budget_mb, flattened, tlas_rows / tlas_depth, and the
        # traversal stack each tree needs (stack_need)
        self.build_info: dict = {}

    # -- construction (Source/Main.cpp:779-819 equivalents) --

    def add_material(self, material: matlib.Material) -> int:
        self.materials.append(material)
        self._device = None
        return len(self.materials) - 1

    def add_mesh(self, name: str, mesh: Mesh, mat_index: int,
                 build_option: BuildOption = BuildOption.SAH_SPLIT_INTERVALS
                 ) -> int:
        """Add a triangle mesh.  Its any-hit tree is always built with the
        full-sweep SAH (BuildOption.SAH_SPLIT_PRIMITIVES), its closest-hit
        tree as CPUGPU_PACKET_TREE says (_packet_tree: modes fat and dp
        with `build_option`); hits are exact for any valid tree."""
        self.objects.append(SceneObject(name, mat_index, PRIM_MESH, mesh=mesh,
                                        build_option=BuildOption(build_option)))
        self._device = None
        return len(self.objects) - 1

    def add_instanced_mesh(self, name: str, mesh: Mesh, mat_index: int,
                           transforms,
                           build_option: BuildOption =
                           BuildOption.SAH_SPLIT_INTERVALS) -> int:
        """One BLAS, many placements: `transforms` is (I, 4, 4) object-to-
        world matrices, gathered under a TLAS.  An instanced mesh cannot
        be a light."""
        self.objects.append(SceneObject(
            name, mat_index, PRIM_MESH, mesh=mesh,
            instances=np.asarray(transforms, np.float32).reshape(-1, 4, 4),
            build_option=BuildOption(build_option)))
        self._device = None
        return len(self.objects) - 1

    def set_instance_transform(self, obj_index: int, instance_index: int,
                               transform) -> None:
        """Move one instance (animation): the next snapshot refits the
        TLAS, the instance tables, the world bounds and, on a flattened
        scene, the world-space copies of the BLAS; no tree is rebuilt."""
        obj = self.objects[obj_index]
        if obj.instances is None:
            except_error("Scene", "object {} has no instances", obj.name)
        obj.instances[instance_index] = np.asarray(transform, np.float32)
        self._transforms_dirty = True

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

    # -- live edits (the ImGui panel's; the caller resets the accumulator).
    # Each drops the snapshot, so the next device() builds new tables:
    # nothing is written into a table a queued frame or a cache (the
    # whole-frame route's packed small tables) may still hold.

    def set_material(self, index: int, material: matlib.Material) -> None:
        self.materials[index] = material
        self._device = None

    def set_sphere(self, obj_index: int, center, radius: float) -> None:
        """Live sphere editor (the scene-tree drag widgets,
        Source/Primitives.cpp:385-398)."""
        obj = self.objects[obj_index]
        if obj.kind != PRIM_SPHERE:
            except_error("Scene", "set_sphere on non-sphere object {}", obj.name)
        obj.sphere = (tuple(center), float(radius))
        self._device = None

    def set_plane(self, obj_index: int, point, normal) -> None:
        """Live plane editor (Source/Primitives.cpp:400-415)."""
        obj = self.objects[obj_index]
        if obj.kind != PRIM_PLANE:
            except_error("Scene", "set_plane on non-plane object {}", obj.name)
        obj.plane = (tuple(point), tuple(normal))
        self._device = None

    def rebuild_bvh(self, obj_index: int, build_option: BuildOption) -> None:
        """BVH::Rebuild from the UI (Source/BVH.cpp:47-59, :182-185): the
        object's build option becomes `build_option`, which the next
        snapshot's closest-hit tree takes under modes fat and dp and
        object_stats reports."""
        obj = self.objects[obj_index]
        if obj.kind != PRIM_MESH:
            except_error("Scene", "rebuild_bvh on non-mesh object {}", obj.name)
        obj.build_option = BuildOption(build_option)
        self._device = None

    def object_stats(self) -> list[dict]:
        """The reference scene tree's per-object readout
        (Source/BVH.cpp:149-186: node count, max depth and total node area
        per BVH; Source/Main.cpp:859-933: every object with its primitive
        kind and material), as the JAX package's Scene.object_stats gives
        it.  A mesh reports its own binary BVH (own_bvh): node count, max
        depth, triangles, build option and the summed half-area of its
        nodes (GetAABBVolume, Source/Primitives.cpp:280-284)."""
        kinds = {PRIM_MESH: "mesh", PRIM_SPHERE: "sphere",
                 PRIM_PLANE: "plane"}
        out = []
        for i, obj in enumerate(self.objects):
            rec = {
                "index": i,
                "name": obj.name,
                "kind": kinds.get(obj.kind, str(obj.kind)),
                "material": obj.mat_index,
                "is_light": i in self.light_indices,
            }
            if obj.kind == PRIM_SPHERE and obj.sphere is not None:
                rec["center"] = list(obj.sphere[0])
                rec["radius"] = obj.sphere[1]
            if obj.kind == PRIM_PLANE and obj.plane is not None:
                rec["point"] = list(obj.plane[0])
                rec["normal"] = list(obj.plane[1])
            if obj.kind == PRIM_MESH:
                b = own_bvh(obj)
                rec["bvh"] = {
                    "node_count": int(b.nodes_min.shape[0]),
                    "max_depth": int(b.max_depth),
                    "triangles": int(b.tri_indices.shape[0]),
                    "build_option": BuildOption(obj.build_option).name,
                    "total_node_area": float(
                        np.sum(bvhlib._half_area(b.nodes_min, b.nodes_max))
                    ),
                }
                if obj.instances is not None:
                    rec["instances"] = int(obj.instances.shape[0])
            out.append(rec)
        return out

    # -- device snapshot --

    def device(self, device="cuda") -> DeviceScene:
        """The snapshot on `device`, built anew when there is none on that
        device or the node-table flags (config.packet_flags) changed since
        it was built, refit when only instance transforms changed."""
        dev = resolve_device(device)
        flags = packet_flags()
        if (self._device is None or self._device.device != dev
                or self._flags != flags):
            self._device = self.build_device(dev)
            self._flags = flags
            self._transforms_dirty = False
        elif self._transforms_dirty:
            self._refit_device(self._device)
            self._transforms_dirty = False
        return self._device

    def _refit_device(self, dev: DeviceScene) -> None:
        """Refit the snapshot in place to the current instance transforms
        (the JAX package's Scene._refit_device): the TLAS rows, inst_inv,
        inst_nrm and the world bounds, and on a flattened scene the
        world-space BLAS copies and the occlusion rows repacked from
        them.  The host work (inverses, instance boxes, the TLAS rows) is
        O(instances); its result goes to the device in one copy from
        pinned memory, and the device work is queued behind the frames
        already queued, without a host synchronisation.  Raises when the
        TLAS topology would change."""
        rf = dev.refit
        if rf is None:
            except_error("Scene", "this snapshot cannot be refit")
        pack, _, _ = _transform_pack(self.objects, rf)
        _apply_transforms(dev, rf, _upload(pack, dev.device))

    def build_device(self, device="cuda") -> DeviceScene:
        """A new snapshot on `device` (build_info says what it decided)."""
        has_mesh = any(o.kind == PRIM_MESH for o in self.objects)
        # the walk the snapshot resolves to (the JAX package's rule):
        # use_wide=False, or a scene without meshes, gives "binary"
        use_wide = self.use_wide and has_mesh
        traversal = self.traversal if use_wide else "binary"
        if traversal == "binary" and any(o.instances is not None
                                         for o in self.objects):
            except_error("Scene", "instanced meshes require use_wide=True "
                         "and the wide or skip walk")
        return self._build(resolve_device(device), traversal, use_wide)

    def _build(self, dev: torch.device, traversal: str,
               use_wide: bool) -> DeviceScene:
        f32, i32 = np.float32, np.int32
        has_instances = any(o.instances is not None for o in self.objects)
        has_mesh = any(o.kind == PRIM_MESH for o in self.objects)
        packet = traversal == "packet"
        flags = packet_flags()
        mode = flags.tree
        # the packet tables come from each mesh's full-sweep build, the XLA
        # walks' from its own BVH; both hold the triangles in original
        # order and the same root box
        bvhs = {oi: _blas(o).b if packet else own_bvh(o)
                for oi, o in enumerate(self.objects) if o.kind == PRIM_MESH}

        # the flatten decision (the JAX package's packet-path rule):
        # instanced BLASes are copied into world space when the copies
        # fit CPUGPU_FLATTEN_BUDGET_MB (read per build) and
        # CPUGPU_NO_FLATTEN != 1; else the object-space machinery runs
        flatten = False
        flat_bytes = 0
        budget = float(os.environ.get("CPUGPU_FLATTEN_BUDGET_MB") or "64")
        if has_instances and packet:
            flat_bytes = sum(
                len(o.instances) * (_packet_tree(o, mode).nodes.nbytes
                                    + _packet_tree(o, mode).ltris.nbytes)
                for o in self.objects if o.instances is not None)
            flatten = (flat_bytes <= budget * 1e6
                       and os.environ.get("CPUGPU_NO_FLATTEN") != "1")
            if not flatten and flat_bytes > budget * 1e6:
                log_warn("Scene", "flattened instance tables {:.0f} MB exceed "
                         "the {:.0f} MB budget; using the object-space TLAS "
                         "machinery", flat_bytes / 1e6, budget)
            if mode == "w16" and not flatten:
                # the object-space instance machinery walks 8-wide trees
                log_warn("Scene", "CPUGPU_PACKET_TREE=w16 does not support "
                         "the object-space instance machinery; building "
                         "sweep_dp 8-wide packet tables")
                mode = "sweep_dp"
        width = 16 if mode == "w16" else 8
        ncol = 8 * width
        # the any-hit tables (CPUGPU_OCCL, CPUGPU_LEAF14): for non-instanced
        # and flattened scenes; the object-space machinery keeps shadow
        # rays on the shading tables.  Leaves of orows rows (CPUGPU_OCCL2);
        # one arity for the whole table, 16 (CPUGPU_OCCL_W16) only where no
        # mesh is instanced; the leaf-14 payload rows with CPUGPU_LEAF14
        build_occl = (packet and (flags.occl or flags.leaf14)
                      and (not has_instances or flatten))
        orows = 2 if flags.occl2 else 1
        owidth = 16 if flags.occl_w16 and not has_instances else 8
        leaf14 = flags.leaf14

        pnodes_l, ptris_l, proots = [], [], []
        onodes_l, oltris_l, oroots, opay_l = [], [], [], []
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
        inst_obj_l, inst_root_l, inst_objs = [], [], []
        flat_meta, p_flat_roots = [], []
        oflat_meta, o_flat_roots, operm_l = [], [], []

        for oi, obj in enumerate(self.objects):
            if obj.kind == PRIM_MESH:
                b = bvhs[oi]
                inst = obj.instances
                tris9_l.append(trav.pack_tris(b.tri_v0, b.tri_v1, b.tri_v2))
                tnrm_l.append(b.tri_normal)
                mesh_bvh[oi] = b
                if inst is None:
                    mesh_tri_range[oi] = (tri_off, b.num_triangles,
                                          b.total_area)
                    wlo = np.minimum(wlo, b.nodes_min[0])
                    whi = np.maximum(whi, b.nodes_max[0])
                elif oi in self.light_indices:
                    except_error("Scene", "instanced mesh '{}' cannot be a "
                                 "light", obj.name)
                if inst is not None:
                    inst_objs.append((oi, b.nodes_min[0].copy(),
                                      b.nodes_max[0].copy()))
                    inst_obj_l.extend([oi] * len(inst))
                if not packet:
                    tri_off += b.num_triangles
                    continue
                pw = _packet_tree(obj, mode)

                # closest-hit tables: object index stamped and triangle
                # ids made global in the leaf records (shared by every
                # instance of the object), entries rebased
                lt = pw.ltris.copy()
                ltv = lt.view(i32)
                for krec in range(8):
                    ltv[:, 16 * krec + 12] = oi
                    tidc = ltv[:, 16 * krec + 13]
                    tidc[tidc >= 0] += tri_off
                copies = len(inst) if inst is not None and flatten else 1
                first = len(inst_obj_l) - (0 if inst is None else len(inst))
                if inst is not None and flatten:
                    flat_meta.append(dict(
                        first=first, count=len(inst),
                        node_base=pnode_off, ltris_base=pleaf_off,
                        src_bounds=pw.nodes[:, :6 * width].copy(),
                        src_ltris=lt))
                blas_root = pnode_off
                for _ in range(copies):
                    pnodes_l.append(_rebase(pw.nodes, pnode_off, pleaf_off))
                    ptris_l.append(lt)
                    if inst is None:
                        proots.append(pnode_off)
                    elif flatten:
                        p_flat_roots.append(pnode_off)
                    pnode_off += pw.num_nodes
                    pleaf_off += pw.num_leaf_rows
                pdepth = max(pdepth, pw.max_depth)

                if build_occl:
                    # any-hit tables over the same binary build; on a
                    # flattened scene their leaf rows (and payload rows)
                    # are repacked from the shading records
                    # (_occl_repack), so operm maps every occlusion record
                    # to a shading record
                    oc = _occl_tree(obj, orows, owidth, leaf14)
                    po = oc.po
                    seg = (_occl_seg(lt, oc.wo, b.num_triangles, tri_off,
                                     orows) if flatten else None)
                    if inst is not None:
                        oflat_meta.append(dict(
                            first=first, count=len(inst),
                            node_base=onode_off,
                            src_bounds=po.nodes[:, :48].copy()))
                    opay = oc.pay
                    if leaf14 and inst is None:
                        # object index stamped and ids made global, as in
                        # the shading records
                        opay = oc.pay.copy()
                        pv = opay.view(i32)
                        for krec in range(bvh8lib.OCCL_TRIS):
                            pv[:, bvh8lib.OCCL_STRIDE * krec + 3] = oi
                            idc = pv[:, bvh8lib.OCCL_STRIDE * krec + 4]
                            idc[idc >= 0] += tri_off
                    for k in range(copies):
                        # leaf entries hold the leaf index (row / orows)
                        onodes_l.append(_rebase(po.nodes, onode_off,
                                                oleaf_off // orows))
                        oltris_l.append(po.ltris)
                        if leaf14:
                            opay_l.append(opay)
                        if inst is None:
                            oroots.append(onode_off)
                            base = pleaf_off - pw.num_leaf_rows
                        else:
                            o_flat_roots.append(onode_off)
                            base = (flat_meta[-1]["ltris_base"]
                                    + k * pw.num_leaf_rows)
                        if flatten:
                            operm_l.append(seg + 8 * base)
                        onode_off += po.num_nodes
                        oleaf_off += po.num_leaf_rows
                    odepth = max(odepth, po.max_depth)

                if inst is not None:
                    # every instance names its BLAS's first copy (the JAX
                    # package's p_blas_root_this)
                    inst_root_l.extend([p_flat_roots[-len(inst)] if flatten
                                        else blas_root] * len(inst))
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

        num_instances = len(inst_obj_l)
        refit = None
        tlas_depth = 0
        if num_instances:
            # the TLAS over the instances' world boxes, after every BLAS;
            # its root is the last closest-hit (and any-hit) root
            refit = dict(inst_objs=inst_objs, num_instances=num_instances,
                         static_lo=wlo.copy(),
                         static_hi=whi.copy(), flatten=flatten, width=width,
                         p_tlas_off=pnode_off if packet else None,
                         p_flat_roots=p_flat_roots,
                         o_tlas_off=onode_off if build_occl else None,
                         o_flat_roots=o_flat_roots, w_tlas_off=None,
                         s_tlas_off=None)
            _, tlas_rows, tlas_depth = _transform_pack(self.objects, refit)
            refit["tlas_count"] = len(tlas_rows)
            if packet:
                # the TLAS rows' entries now (the side tables read them);
                # their bounds come with the transforms (_apply_transforms)
                pnodes_l.append(_slim_tlas_rows(
                    tlas_rows, pnode_off, p_flat_roots if flatten else None,
                    width))
                proots.append(pnode_off)
                pnode_off += len(tlas_rows)
            if build_occl:
                onodes_l.append(_slim_tlas_rows(tlas_rows, onode_off,
                                                o_flat_roots))
                oroots.append(onode_off)
                onode_off += len(tlas_rows)

        if build_occl and oroots:
            # the JAX package keeps the any-hit tables only where its
            # shadow walk's stack holds the tree (its frame stack, forced
            # at width 16, or its slot stack); else shadow rays keep the
            # shading tables
            if flags.framestack or owidth == 16:
                o_need = (tlas_depth + odepth + 2
                          + (len(oroots) - 1 + owidth - 1) // owidth + 1)
                o_bound = JAX_FSTACK_FRAMES
            else:
                o_need = 7 * (tlas_depth + odepth + 1) + 1 + len(oroots)
                o_bound = JAX_SLOT_STACK
            if o_need > o_bound:
                log_warn("Scene", "occlusion-table stack bound exceeded "
                         "(need {} > {}); shadow rays keep the shading "
                         "tables", o_need, o_bound)
                build_occl = False
                onodes_l, oltris_l, oroots, opay_l = [], [], [], []
                operm_l, oflat_meta, odepth = [], [], 0
                if refit is not None:
                    refit["o_tlas_off"] = None
        if not build_occl:
            owidth, orows = 8, 1

        # the kernels' per-ray stack holds at most width - 1 pending
        # siblings per level of the TLAS and the deepest tree below it, the
        # RESTORE marker of an instance and the extra roots; refuse a tree
        # that could overflow it (the 8-wide walks' PT_STACK, the 16-wide
        # walks' PT_STACK_W16).  The JAX package falls back to its wide
        # walk there; here a walk in PyTorch is taken only when asked for
        # (ROADMAP condition 14)
        stack_need = {}
        if packet:
            for kind, depth, roots, w in (
                    ("closest-hit", pdepth, proots, width),
                    ("any-hit", odepth, oroots, owidth)):
                need = ((w - 1) * (tlas_depth + depth + 1) + 1
                        + max(len(roots), 1))
                bound = PT_STACK if w == 8 else PT_STACK_W16
                stack_need[kind] = need
                if need > bound:
                    except_error(
                        "Scene", "{} tree needs a {}-entry traversal stack, "
                        "more than the kernel's {}; Scene(traversal=\"wide\") "
                        "walks it in PyTorch instead", kind, need, bound)

        # the XLA walk's tables (binary, wide or skip), the TLAS rows at
        # the end, filled by _apply_transforms as a refit fills them
        walk, walk_meta = {}, {}
        if not packet and has_mesh:
            walk, walk_meta = _walk_tables(self.objects, traversal,
                                           num_instances, tlas_depth, refit)

        self.build_info = dict(
            flat_bytes=flat_bytes, flatten_budget_mb=budget,
            flattened=flatten, tlas_rows=refit["tlas_count"] if refit else 0,
            tlas_depth=tlas_depth, stack_need=stack_need, packet_tree=mode,
            packet_width=width, tree_depth=pdepth, occl_depth=odepth,
            traversal=traversal, use_wide=use_wide,
            wstack_depth=walk_meta.get("wstack_depth"))
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
            pnodes=rows(pnodes_l, ncol),
            pltris=rows(ptris_l, 128),
            poccl_nodes=rows(onodes_l, 8 * owidth),
            poccl_ltris=rows(oltris_l, 128),
            sph_obj=np.asarray(sph["obj"], i32),
            pln_obj=np.asarray(pln["obj"], i32),
            world_lo=wlo.astype(f32),
            world_inv_extent=(1.0 / wext).astype(f32),
            inst_inv=np.zeros((num_instances, 12), f32),
            inst_nrm=np.zeros((num_instances, 9), f32),
            inst_blas_root_packet=np.asarray(inst_root_l, i32),
            inst_obj=np.asarray(inst_obj_l, i32),
            tris9=rows(tris9_l, 9),
            tri_normal=rows(tnrm_l, 3),
            **mk,
        )
        if num_instances:
            for fm in flat_meta:
                fm["src_bounds"] = t(fm.pop("src_bounds"), torch.float32)
                fm["src_ltris"] = t(fm.pop("src_ltris"), torch.float32)
            for ofm in oflat_meta:
                ofm["src_bounds"] = t(ofm.pop("src_bounds"), torch.float32)
            refit.update(flat_meta=flat_meta, oflat_meta=oflat_meta,
                         operm=(t(np.concatenate(operm_l), torch.int64)
                                if flatten and build_occl else None))
        ds = DeviceScene(
            **{name: t(arrays[name], dtype) for name, dtype in TABLE_FIELDS},
            **{name: t(walk[name], dtype) for name, dtype in WALK_FIELDS
               if name in walk},
            **walk_meta,
            proots=tuple(proots),
            poccl_roots=tuple(oroots),
            light_tri_meta=tuple(light_tri_meta),
            num_lights=len(self.light_indices),
            num_sph=len(sph["center"]),
            num_pln=len(pln["point"]),
            has_mesh_lights=has_mesh_lights,
            num_instances=num_instances,
            packet_flattened=flatten,
            packet_width=width,
            poccl_pay=(t(rows(opay_l, 128), torch.float32)
                       if build_occl and leaf14 else None),
            poccl_width=owidth,
            poccl_rows=orows,
            traversal=traversal,
            use_wide=use_wide,
            refit=refit,
        )
        if num_instances:
            # the transforms' part of the tables, by the refit's own code:
            # a refit to the same transforms gives the same bits
            pack, _, _ = _transform_pack(self.objects, refit)
            _apply_transforms(ds, refit, _upload(pack, dev))
        if flags.fused and proots and (num_instances == 0 or flatten):
            ds = dataclasses.replace(
                ds, pfused=fuse_packet_tables(ds.pnodes, ds.pltris),
                pfused_nn=int(ds.pnodes.shape[0]))
        return _side_tables(ds, flags, arrays["pnodes"],
                            arrays["poccl_nodes"])

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
                    scene), and whether any light is a mesh;
        and the XLA integrator's light tables (the JAX package's light_*
        fields): per light its object, whether it is a sphere, center and
        radius (a mesh light's centroid and 0), radius^2, a mesh light's
        triangle range in tris9 and half total area (0 for a sphere)."""
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
        l_is_sph = mk_lights[:L, 9] > 0.5
        l_radius = mk_lights[:L, 3].copy()
        mk = dict(
            light_obj=np.asarray(self.light_indices, i32).reshape(L),
            light_is_sphere=l_is_sph,
            light_sph_center=mk_lights[:L, 0:3].copy(),
            light_sph_radius=l_radius,
            light_sph_radius_sq=l_radius * l_radius,
            light_tri_start=np.asarray([s0 for s0, _ in l_tri],
                                       i32).reshape(L),
            light_tri_count=np.asarray([c for _, c in l_tri], i32).reshape(L),
            light_half_area=np.where(l_is_sph, f32(0.0),
                                     mk_lights[:L, 4]).astype(f32),
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


def _walk_tables(objects, traversal: str, num_instances: int,
                 tlas_depth: int, refit: dict | None) -> tuple[dict, dict]:
    """The tables and metadata of an XLA walk over the meshes, each from
    its own BVH (own_bvh), as the JAX package's build lays them out:
      binary: nodes8 (every mesh's rows, left_first made global) and
              tri_perm, one root per mesh without instances (:1147-1160);
      wide:   wnodes (8-wide rows of _wide_tree, interior entries made
              global and leaf starts rebased into the concatenated
              wtris9), wtris9, wleaf_id, one root per mesh without
              instances and the TLAS root last, inst_blas_root, and
              wstack_depth = min(64, 7 (depth + TLAS depth + 2) + roots)
              (:1285-1320, :1514-1520);
      skip:   snodes12 (each mesh threaded to the next world mesh's root,
              the last to the TLAS or NEXT_DONE, an instanced BLAS to
              NEXT_RETURN; the TLAS rows last), stris9 and sleaf_id in
              leaf order, sroot, inst_blas_root_skip (:1405-1480);
    and tri_obj.  The TLAS rows are left zero: _apply_transforms writes
    them with the transforms (refit gets their offsets)."""
    i32 = np.int32
    meshes = [(oi, o) for oi, o in enumerate(objects) if o.kind == PRIM_MESH]
    own = [own_bvh(o) for _, o in meshes]
    tobj = [np.full(b.num_triangles, oi, i32) for (oi, _), b in zip(meshes, own)]
    tri_offs = np.cumsum([0] + [b.num_triangles for b in own]).tolist()
    node_offs = np.cumsum([0] + [b.num_nodes for b in own]).tolist()
    arrays = dict(tri_obj=np.concatenate(tobj))
    meta = {}
    if traversal == "binary":
        nodes, perms, roots = [], [], []
        for k, ((_, o), b) in enumerate(zip(meshes, own)):
            lf = b.left_first.astype(i32).copy()
            leaf = b.prim_count > 0
            lf[leaf] += tri_offs[k]
            lf[~leaf] += node_offs[k]
            nodes.append(trav.pack_nodes(b.nodes_min, b.nodes_max, lf,
                                         b.prim_count))
            perms.append(b.tri_indices.astype(i32) + tri_offs[k])
            if o.instances is None:
                roots.append(node_offs[k])
        arrays.update(nodes8=np.concatenate(nodes),
                      tri_perm=np.concatenate(perms))
        meta["roots"] = tuple(roots)
    elif traversal == "wide":
        rows, tris, leaf_id, roots, inst_root = [], [], [], [], []
        off = tri_at = depth = 0
        for k, (_, o) in enumerate(meshes):
            w = _wide_tree(o)
            r = w.nodes.copy()
            cidx = r[:, 48:56].view(i32)
            ccnt = r[:, 56:64].view(i32)
            cidx[ccnt == 0] += off
            cidx[ccnt > 0] += tri_at
            rows.append(r)
            tris.append(w.tris9)
            leaf_id.append(w.leaf_tri_id + tri_offs[k])
            if o.instances is None:
                roots.append(off)
            else:
                inst_root += [off] * len(o.instances)
            off += w.num_nodes
            tri_at += len(w.tris9)
            depth = max(depth, w.max_depth)
        if num_instances:
            refit["w_tlas_off"] = off
            rows.append(np.zeros((refit["tlas_count"], 64), np.float32))
            roots.append(off)
        arrays.update(wnodes=np.concatenate(rows), wtris9=np.concatenate(tris),
                      wleaf_id=np.concatenate(leaf_id),
                      inst_blas_root=np.asarray(inst_root, i32))
        meta.update(wroots=tuple(roots), wstack_depth=min(
            64, 7 * (depth + tlas_depth + 2) + max(len(roots), 1)))
    else:  # skip
        tlas_off = node_offs[-1]
        world = [node_offs[k] for k, (_, o) in enumerate(meshes)
                 if o.instances is None]
        tail = tlas_off if num_instances else tsk.NEXT_DONE
        rows, tris, leaf_id, inst_root = [], [], [], []
        widx = 0
        for k, ((_, o), b) in enumerate(zip(meshes, own)):
            if o.instances is None:
                widx += 1
                end_next = world[widx] if widx < len(world) else tail
            else:
                end_next = tsk.NEXT_RETURN
                inst_root += [node_offs[k]] * len(o.instances)
            rows.append(tsk.pack_skip_nodes(b, tri_offs[k], node_offs[k],
                                            end_next))
            perm = b.tri_indices
            tris.append(trav.pack_tris(b.tri_v0[perm], b.tri_v1[perm],
                                       b.tri_v2[perm]))
            leaf_id.append(perm.astype(i32) + tri_offs[k])
        if num_instances:
            # a binary tree over the instances: 2 I - 1 rows
            refit["s_tlas_off"] = tlas_off
            rows.append(np.zeros((2 * num_instances - 1, 12), np.float32))
        arrays.update(snodes12=np.concatenate(rows),
                      stris9=np.concatenate(tris),
                      sleaf_id=np.concatenate(leaf_id),
                      inst_blas_root_skip=np.asarray(inst_root, i32))
        meta["sroot"] = int(world[0] if world else
                            (tlas_off if num_instances else -1))
    return arrays, meta


def _rebase(rows: np.ndarray, node_off: int, leaf_off: int) -> np.ndarray:
    """A copy of slim node rows (8- or 16-wide) with interior entries
    moved by node_off rows and leaf entries -(row + 1) by leaf_off rows."""
    out = rows.copy()
    w = rows.shape[1] // 8
    cidx = out[:, 6 * w:7 * w].view(np.int32)
    ccnt = out[:, 7 * w:8 * w].view(np.int32)
    cidx[ccnt == 0] += node_off
    cidx[ccnt > 0] -= leaf_off
    return out


def _occl_seg(lt: np.ndarray, wo: bvh8lib.BVH8, num_tris: int,
              tri_off: int, rows: int = 1) -> np.ndarray:
    """Per occlusion record of one object (14 per leaf row, `rows` rows
    per leaf, leaf order of bvh8.to_slim_occl) the index row * 8 + slot
    of a shading record of the same triangle in the object's leaf rows
    `lt` (ids global from tri_off); padding records take the record of
    local triangle 0.  The gather of _occl_repack (the JAX package's
    _build_occl_cache rec_tid and operm)."""
    i32 = np.int32
    w, per = wo.width, bvh8lib.OCCL_TRIS
    cidx = wo.nodes[:, 6 * w:7 * w].view(i32)
    ccnt = wo.nodes[:, 7 * w:8 * w].view(i32)
    is_leaf = ccnt > 0
    starts, counts = cidx[is_leaf], ccnt[is_leaf]
    # record k of a leaf sits in its row k // 14 at slot k % 14
    rec_tid = np.full((max(len(starts), 1), rows * per), -1, i32)
    for leaf, (st, c) in enumerate(zip(starts, counts)):
        rec_tid[leaf, :c] = wo.leaf_tri_id[st:st + c]
    ltv = lt.view(i32)
    gids = np.stack([ltv[:, 16 * k + 13] for k in range(8)], axis=1)
    valid = gids >= 0
    recpos = (np.arange(lt.shape[0], dtype=i32)[:, None] * 8
              + np.arange(8, dtype=i32)[None, :])
    local_map = np.zeros(num_tris, i32)
    local_map[gids[valid] - tri_off] = recpos[valid]
    return np.where(rec_tid >= 0, local_map[np.maximum(rec_tid, 0)],
                    local_map[0]).astype(np.int64).reshape(-1)


# ---- instances: TLAS rows, transforms, world-space copies ----------------
#
# The JAX package's scene.py:392-731 and the refit of :921-1033, for the
# 8-wide slim tables.  The TLAS is built on the host (a handful of rows);
# the world-space copies of a flattened scene are made on the scene's
# device in the JAX package's explicit per-component arithmetic, so that
# the floats equal op-by-op JAX bitwise and a refit equals a fresh build.

# TLAS leaf children carry this count and the instance id as their index
# (the JAX package's ops/traverse_wide.py CCNT_INSTANCE)
CCNT_INSTANCE = -2


def _build_tlas_rows(imin: np.ndarray, imax: np.ndarray):
    """8-ary TLAS over instance world AABBs: (rows (K, 64) with local
    interior child indices and CCNT_INSTANCE leaves, depth)."""
    num = len(imin)
    centers = (imin + imax) * 0.5
    rows: list[np.ndarray] = []

    def split8(ids: np.ndarray) -> list[np.ndarray]:
        groups = [ids]
        while len(groups) < 8:
            gi = max(range(len(groups)), key=lambda g: len(groups[g]))
            if len(groups[gi]) <= 1:
                break
            g = groups.pop(gi)
            c = centers[g]
            axis = int(np.argmax(c.max(0) - c.min(0)))
            order = np.argsort(c[:, axis], kind="stable")
            h = len(g) // 2
            groups.append(g[order[:h]])
            groups.append(g[order[h:]])
        return groups

    def build(ids: np.ndarray, depth: int) -> tuple[int, int]:
        row_idx = len(rows)
        rows.append(np.zeros(64, np.float32))
        groups = [g for g in split8(ids) if len(g)]
        bmin = np.full((8, 3), 1e30, np.float32)
        bmax = np.full((8, 3), -1e30, np.float32)
        cidx = np.zeros(8, np.int32)
        ccnt = np.full(8, -1, np.int32)
        max_d = depth
        for k, g in enumerate(groups):
            bmin[k] = imin[g].min(0)
            bmax[k] = imax[g].max(0)
            if len(g) == 1:
                cidx[k] = int(g[0])
                ccnt[k] = CCNT_INSTANCE
            else:
                child, d = build(g, depth + 1)
                cidx[k] = child
                ccnt[k] = 0
                max_d = max(max_d, d)
        row = rows[row_idx]
        row[0:48] = np.concatenate([bmin, bmax], axis=1).reshape(-1)
        row[48:56] = cidx.view(np.float32)
        row[56:64] = ccnt.view(np.float32)
        return row_idx, max_d

    _, depth = build(np.arange(num), 1)
    return np.stack(rows), depth


def _widen_slim_rows(rows: np.ndarray) -> np.ndarray:
    """8-wide slim node rows (bounds 0..47, entries 48..55) in the 16-wide
    (B, 128) layout (bounds 0..95, entries 96..111, counts 112..127): pad
    slots 8..15 get inverted boxes and SLIM_EMPTY entries (the JAX
    package's _widen_slim_rows, which splices the 8-wide TLAS over the
    16-wide flattened tables)."""
    out = np.zeros((len(rows), 128), np.float32)
    out[:, :48] = rows[:, :48]
    out[:, 48:96] = np.tile(
        np.array([1e30, 1e30, 1e30, -1e30, -1e30, -1e30], np.float32), 8)
    oi = out.view(np.int32)
    oi[:, 96:104] = rows[:, 48:56].view(np.int32)
    oi[:, 104:112] = bvh8lib.SLIM_EMPTY
    oi[:, 112:128] = -1
    return out


def _slim_tlas_rows(tlas_rows: np.ndarray, p_off: int, inst_roots=None,
                    width: int = 8):
    """TLAS rows in the slim encoding at row p_off: interior children ->
    global row, empty -> SLIM_EMPTY, instance children -> SLIM_EMPTY + 1 +
    instance id (the object-space machinery) or, with `inst_roots`, the
    root row of the instance's world-space BLAS copy (flattened); at
    width 16 widened to (K, 128) rows (_widen_slim_rows)."""
    rows = tlas_rows.copy()
    cidx = rows[:, 48:56].view(np.int32)
    ccnt = rows[:, 56:64].view(np.int32)
    inst = ccnt == CCNT_INSTANCE
    if inst_roots is None:
        cidx[inst] = bvh8lib.SLIM_EMPTY + 1 + cidx[inst]
    else:
        cidx[inst] = np.asarray(inst_roots, np.int32)[cidx[inst]]
    cidx[ccnt == 0] += p_off
    cidx[ccnt == -1] = bvh8lib.SLIM_EMPTY
    ccnt[:] = -1  # the kernels never read counts
    return _widen_slim_rows(rows) if width == 16 else rows


def _instance_world_aabb(nmin, nmax, m4):
    """Transform an AABB's 8 corners by the 4x4 object-to-world matrix."""
    xs = [nmin[0], nmax[0]]
    ys = [nmin[1], nmax[1]]
    zs = [nmin[2], nmax[2]]
    pts = np.array([[x, y, z, 1.0] for x in xs for y in ys for z in zs],
                   np.float32)
    world = pts @ m4.T
    return (world[:, :3].min(0).astype(np.float32),
            world[:, :3].max(0).astype(np.float32))


def _transform_pack(objects, rf: dict):
    """The host part of a refit from the current instance transforms:
    (words, tlas_rows, tlas_depth), words one f32 array of inst_inv
    (I, 12), inst_nrm (I, 9), the linear parts A (I, 9) and translations
    b (I, 3) of the transforms, the slim TLAS rows (K, 8 * width), those
    of the any-hit TLAS (K, 64, when the scene has any-hit tables),
    the XLA walks' TLAS rows (wide (K, 64), skip (2 I - 1, 12); each where
    the snapshot has that table), world_lo and world_inv_extent -- the
    layout _apply_transforms reads.  Raises when a refit (rf with
    tlas_count) would change the TLAS topology."""
    f32 = np.float32
    inv_l, nrm_l, a_l, b_l, imin_l, imax_l = [], [], [], [], [], []
    for oi, bmin, bmax in rf["inst_objs"]:
        for m4 in objects[oi].instances:
            m = np.asarray(m4, f32)
            inv = np.linalg.inv(np.asarray(m4, np.float64))
            inv_l.append(inv[:3, :].astype(f32).reshape(12))
            nrm_l.append(inv[:3, :3].T.astype(f32).reshape(9))
            a_l.append(m[:3, :3].reshape(9))
            b_l.append(m[:3, 3])
            amin, amax = _instance_world_aabb(bmin, bmax, m)
            imin_l.append(amin)
            imax_l.append(amax)
    imin, imax = np.stack(imin_l), np.stack(imax_l)
    tlas_rows, depth = _build_tlas_rows(imin, imax)
    if "tlas_count" in rf and (len(tlas_rows) != rf["tlas_count"]
                               or len(imin) != rf["num_instances"]):
        except_error("Scene", "TLAS topology changed across refit ({} -> {} "
                     "rows, {} -> {} instances)", rf["tlas_count"],
                     len(tlas_rows), rf["num_instances"], len(imin))
    flat = rf["flatten"]
    parts = [np.stack(inv_l), np.stack(nrm_l), np.stack(a_l), np.stack(b_l)]
    if rf["p_tlas_off"] is not None:
        parts.append(_slim_tlas_rows(tlas_rows, rf["p_tlas_off"],
                                     rf["p_flat_roots"] if flat else None,
                                     rf["width"]))
    if rf["o_tlas_off"] is not None:
        parts.append(_slim_tlas_rows(tlas_rows, rf["o_tlas_off"],
                                     rf["o_flat_roots"]))
    if rf["w_tlas_off"] is not None:
        # the wide walk's TLAS rows: interior entries made global
        wrow = tlas_rows.copy()
        wrow[:, 48:56].view(np.int32)[
            wrow[:, 56:64].view(np.int32) == 0] += rf["w_tlas_off"]
        parts.append(wrow)
    if rf["s_tlas_off"] is not None:
        parts.append(tsk.pack_skip_tlas(imin, imax, np.arange(len(imin)),
                                        tsk.NEXT_DONE, rf["s_tlas_off"]))
    wlo = np.minimum(rf["static_lo"], imin.min(0))
    whi = np.maximum(rf["static_hi"], imax.max(0))
    wext = np.maximum(whi - wlo, 1e-6).astype(f32)
    parts += [wlo.astype(f32), (1.0 / wext).astype(f32)]
    words = np.concatenate([np.ascontiguousarray(p, f32).reshape(-1)
                            for p in parts])
    return words, tlas_rows, depth


def _upload(words: np.ndarray, dev: torch.device) -> torch.Tensor:
    """words on `dev`: on the card one asynchronous copy from pinned
    memory (no host synchronisation; the pinned block is recycled only
    after the copy has run)."""
    host = torch.from_numpy(words)
    if dev.type != "cuda":
        return host.to(dev)
    return host.pin_memory().to(dev, non_blocking=True)


def _lin(m, v, t=None):
    """(I, ..., 3) = m (I, 3, 3) applied to the 3-vectors v (..., 3) of
    every instance (+ t (I, 3)): each output component x in the JAX
    package's explicit order ((m[x, 0] v0 + m[x, 1] v1) + m[x, 2] v2) + t[x]
    -- never matmul, whose reductions differ in the last bit.  The three
    components come out of one broadcast product per column of m."""
    shape = (m.shape[0],) + (1,) * (v.dim() - 1) + (3,)
    acc = (m[:, :, 0].reshape(shape) * v[None, ..., 0:1]
           + m[:, :, 1].reshape(shape) * v[None, ..., 1:2]
           + m[:, :, 2].reshape(shape) * v[None, ..., 2:3])
    if t is not None:
        acc = acc + t.reshape(shape)
    return acc


def world_boxes(src_bounds, A, b):
    """(I * B, 6W) world child boxes of (B, 6W) object-space slim node
    bounds (W = 8 or 16 slots) under every instance: center' = A c + b,
    extent' = |A| e, so boxes only grow (conservative culling, the JAX
    package's _flatten_tables and _flatten_splice_occl)."""
    B, cols = src_bounds.shape
    bx = src_bounds.reshape(B, cols // 6, 6)
    mn, mx = bx[..., 0:3], bx[..., 3:6]
    c = (mn + mx) * 0.5
    e = (mx - mn) * 0.5
    cw = _lin(A, c, b)
    ew = _lin(torch.abs(A), e)
    return torch.cat([cw - ew, cw + ew], dim=-1).reshape(-1, cols)


def flatten_tables(src_bounds, src_ltris, A, b, nrm):
    """World-space copies of one instanced BLAS (the JAX package's
    _flatten_tables): ((I * B, 6W) world child boxes,
    (I * Lr, 128) world leaf records).  Records transform exactly (v0
    affine, e1 / e2 linear); the flat normal becomes the normalised
    nrm (I, 3, 3) image, as the object-space machinery's shading
    epilogue computes it per hit; the id columns are copied."""
    I, Lr = A.shape[0], src_ltris.shape[0]
    r = src_ltris.reshape(Lr, 8, 16)
    # v0, e1, e2 of every record at once; v0 alone takes the translation
    tri = _lin(A, r[..., 0:9].reshape(Lr, 8, 3, 3))
    tri[..., 0, :] += b.reshape(I, 1, 1, 3)
    nw = _lin(nrm, r[..., 9:12])
    nl = sqrt(nw[..., 0:1] * nw[..., 0:1] + nw[..., 1:2] * nw[..., 1:2]
              + nw[..., 2:3] * nw[..., 2:3])
    nw = torch.where(nl > 0.0, nw / torch.clamp(nl, min=1e-30), nw)
    ids = r[None, ..., 12:16].expand(I, Lr, 8, 4)
    recs = torch.cat([tri.reshape(I, Lr, 8, 9), nw, ids],
                     dim=-1).reshape(I * Lr, 128)
    return world_boxes(src_bounds, A, b), recs


def _occl_repack(pltris, perm, with_pay: bool = False):
    """Occlusion leaf rows gathered from the (world-space) shading records
    (the JAX package's _occl_repack): perm (NO * 14,) record indices
    row * 8 + slot; each row takes the [v0, e1, e2] of its 14 records,
    so the any-hit floats are the shading floats bit for bit.  With
    with_pay also the leaf-14 payload rows, [normal, obj, id, 0 x 4] of
    the same records: (geometry, payload).  The gather runs on the int32
    bits (some id columns are NaN payloads as f32)."""
    rec = pltris.view(torch.int32).reshape(-1, 16)[perm]
    no = perm.shape[0] // bvh8lib.OCCL_TRIS
    zeros2 = torch.zeros_like(rec[:no, :2])
    geo = torch.cat([rec[:, :9].reshape(no, 126), zeros2],
                    dim=1).view(torch.float32)
    if not with_pay:
        return geo
    pay9 = torch.cat([rec[:, 9:14], torch.zeros_like(rec[:, :4])], dim=1)
    return geo, torch.cat([pay9.reshape(no, 126), zeros2],
                          dim=1).view(torch.float32)


def _apply_transforms(ds: DeviceScene, rf: dict, words: torch.Tensor) -> None:
    """Write the transforms' part of the tables in place from the words
    of _transform_pack on the scene's device: the TLAS rows, on a
    flattened scene the world-space BLAS copies and the repacked
    occlusion rows (with the leaf-14 payload rows), the fused table
    (rebuilt from the new rows, as the JAX package's refit does), the
    TLAS rows' entries in the side tables, inst_inv, inst_nrm and the
    world bounds.  The BLAS rows' entries never
    move, but the TLAS assigns its child slots by the instances' world
    positions, so a move can permute them; the JAX package's refit leaves
    pents as built, and a refit here must equal a fresh build.  48-col
    rows exist only without instances."""
    I, K = ds.num_instances, rf["tlas_count"]
    ncol = 8 * rf["width"]
    # (name, offset into its table, rows, columns) of each TLAS part
    tlas = [(name, rf[key], rows, cols) for name, key, rows, cols in (
        ("pnodes", "p_tlas_off", K, ncol), ("poccl_nodes", "o_tlas_off", K, 64),
        ("wnodes", "w_tlas_off", K, 64),
        ("snodes12", "s_tlas_off", 2 * I - 1, 12)) if rf[key] is not None]
    parts = list(words.split([12 * I, 9 * I, 9 * I, 3 * I]
                             + [r * c for _, _, r, c in tlas] + [3, 3]))
    inv, nrm, A, b = parts[:4]
    wlo, wie = parts[-2:]
    A, b, nrm3 = A.view(I, 3, 3), b.view(I, 3), nrm.view(I, 3, 3)
    for (name, o, r, c), rows in zip(tlas, parts[4:-2]):
        getattr(ds, name)[o:o + r].copy_(rows.view(r, c))
    o = rf["p_tlas_off"]
    if ds.pents is not None:  # 8-wide only
        ds.pents[o:o + K].copy_(ds.pnodes[o:o + K, 48:56].view(torch.int32))
    for fm in rf["flat_meta"]:
        sl = slice(fm["first"], fm["first"] + fm["count"])
        bounds, recs = flatten_tables(fm["src_bounds"], fm["src_ltris"],
                                      A[sl], b[sl], nrm3[sl])
        nb, lb = fm["node_base"], fm["ltris_base"]
        ds.pnodes[nb:nb + bounds.shape[0], :bounds.shape[1]] = bounds
        ds.pltris[lb:lb + recs.shape[0]] = recs
    if rf["o_tlas_off"] is not None:
        o = rf["o_tlas_off"]
        if ds.poccl_ents is not None:
            ds.poccl_ents[o:o + K].copy_(
                ds.poccl_nodes[o:o + K, 48:56].view(torch.int32))
        for ofm in rf["oflat_meta"]:
            sl = slice(ofm["first"], ofm["first"] + ofm["count"])
            bounds = world_boxes(ofm["src_bounds"], A[sl], b[sl])
            nb = ofm["node_base"]
            ds.poccl_nodes[nb:nb + bounds.shape[0], :48] = bounds
        if rf["operm"] is not None and ds.poccl_pay is None:
            ds.poccl_ltris.copy_(_occl_repack(ds.pltris, rf["operm"]))
        elif rf["operm"] is not None:  # and the leaf-14 payload rows
            geo, pay = _occl_repack(ds.pltris, rf["operm"], with_pay=True)
            ds.poccl_ltris.copy_(geo)
            ds.poccl_pay.copy_(pay)
    if ds.pfused is not None:
        ds.pfused.copy_(fuse_packet_tables(ds.pnodes, ds.pltris))
    ds.inst_inv.copy_(inv.view(I, 12))
    ds.inst_nrm.copy_(nrm.view(I, 9))
    ds.world_lo.copy_(wlo)
    ds.world_inv_extent.copy_(wie)


def fuse_packet_tables(pnodes: torch.Tensor,
                       pltris: torch.Tensor) -> torch.Tensor:
    """The fused node|leaf table (CPUGPU_FUSED, the JAX package's
    _fuse_packet_tables) on the tables' device: node rows padded to 128
    cols (16-wide rows already are), leaf entries -(lrow + 1) re-encoded
    as nn + lrow -- the row of the leaf in this table -- and the leaf
    rows appended; SLIM_EMPTY and the interior entries stay."""
    nn, w = pnodes.shape[0], pnodes.shape[1] // 8
    ci = pnodes[:, 6 * w:7 * w].contiguous().view(torch.int32)
    ci = torch.where(ci < 0, nn + (-ci - 1), ci)
    parts = [pnodes[:, :6 * w], ci.view(torch.float32),
             pnodes[:, 7 * w:8 * w]]
    if 8 * w < 128:
        parts.append(torch.zeros((nn, 128 - 8 * w), dtype=pnodes.dtype,
                                 device=pnodes.device))
    return torch.cat([torch.cat(parts, dim=1), pltris], dim=0)


def _side_tables(ds: DeviceScene, flags, pnodes: np.ndarray,
                 onodes: np.ndarray) -> DeviceScene:
    """CPUGPU_SMEMTREE=1|48 (the JAX package's _build_smem_side_tables):
    the entry side tables of the 8-wide split tables (bvh8.slim_side_
    tables, from the host rows `pnodes` / `onodes`, whose entries are the
    device rows'), and in mode 48 on a scene without instances, under the
    JAX condition CPUGPU_FRAMESTACK=1 and CPUGPU_ROWX=1, the 48-col
    bounds-only rows (bvh8.slim_bounds48).  None for 16-wide or fused
    tables and on the object-space machinery; the any-hit tree's only at
    width 8 (CPUGPU_OCCL_W16: the JAX package builds no poccl_ents for a
    16-wide any-hit tree, and under CPUGPU_SMEMTREE=48 its build then
    fails on the 48-col any-hit rows; the port builds none of them); a
    tree of fewer than CPUGPU_SMEMTREE_MIN_NODES rows is marked
    smem_small (packet_tables hands its side tables to the whole-frame
    kernel only)."""
    if (flags.smemtree not in ("1", "48") or not ds.proots
            or ds.packet_width != 8 or ds.pfused is not None
            or ds.machinery):
        return ds
    dev = ds.device

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev,
                                                            dtype=dtype)

    upd = dict(smem_small=pnodes.shape[0] < flags.smem_min_nodes,
               pents=t(bvh8lib.slim_side_tables(pnodes, ds.proots)[0],
                       torch.int32))
    occl8 = bool(ds.poccl_roots) and ds.poccl_width == 8
    if occl8:
        upd["poccl_ents"] = t(bvh8lib.slim_side_tables(
            onodes, ds.poccl_roots)[0], torch.int32)
    if (flags.smemtree == "48" and flags.framestack and flags.rowx == 1
            and ds.num_instances == 0):
        upd["pnodes48"] = t(bvh8lib.slim_bounds48(pnodes), torch.float32)
        if occl8:
            upd["poccl_nodes48"] = t(bvh8lib.slim_bounds48(onodes),
                                     torch.float32)
    return dataclasses.replace(ds, **upd)


def packet_tables(dev: DeviceScene, whole_frame: bool = False) -> tuple:
    """(nodes, ltris, fused_nn, ents) of the closest-hit walks (the JAX
    package's packet_tables): the fused table when the scene built one
    (ltris then holds the leaf records the plain versions read), the
    48-col rows with the side table when built (CPUGPU_SMEMTREE=48), the
    64-col (or 16-wide) rows with the side table or none otherwise.  A
    small tree (smem_small) gives its side tables to whole-frame callers
    only."""
    if dev.pfused is not None:
        return dev.pfused, dev.pltris, dev.pfused_nn, None
    if dev.smem_small and not whole_frame:
        return dev.pnodes, dev.pltris, 0, None
    if dev.pnodes48 is not None:
        return dev.pnodes48, dev.pltris, 0, dev.pents
    return dev.pnodes, dev.pltris, 0, dev.pents


def occl_tables(dev: DeviceScene, whole_frame: bool = False):
    """(nodes, ltris, roots, ents) of the any-hit tree (the JAX package's
    occl_tables), or None when shadow rays walk the shading tables (no
    any-hit tables: CPUGPU_OCCL off, the object-space machinery, or no
    mesh).  The 48-col rows when built; the same small-tree policy as
    packet_tables."""
    if not dev.poccl_roots:
        return None
    if dev.smem_small and not whole_frame:
        return dev.poccl_nodes, dev.poccl_ltris, dev.poccl_roots, None
    nodes = (dev.poccl_nodes48 if dev.poccl_nodes48 is not None
             else dev.poccl_nodes)
    return nodes, dev.poccl_ltris, dev.poccl_roots, dev.poccl_ents


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
# The JAX gates' arms for the leaf-14 and 16-wide occlusion tables have
# no counterpart here yet (the port builds neither), nor has the ADVANCED
# gates' budget of 16 analytic primitives (a TPU compile-time limit of
# unrolled tests).
# Where the JAX package asks for the TPU backend, the port asks for a
# scene on the card.  A snapshot on an XLA walk ("wide", "skip",
# "binary") takes no kernel route, as in the JAX package.


def packet_path_active(dev: DeviceScene) -> bool:
    """True when the scene's meshes are traced by the kernel of
    ops/traverse_packet_slim.py on the card -- where the JAX package runs
    its packet kernel, and where trace_whitted sorts the wavefront."""
    return (dev.traversal == "packet" and bool(dev.proots)
            and dev.device.type == "cuda")


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
        and dev.num_triangles == 0
        and dev.num_instances == 0
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
    cannot run, or None when it can; ADVANCED mode then takes the XLA
    integrator (integrators.trace_advanced), as in the JAX package."""
    if os.environ.get("CPUGPU_NO_MEGAKERNEL") == "1":
        return "CPUGPU_NO_MEGAKERNEL=1"
    if dev.num_triangles == 0:
        return "no mesh object (the kernels walk a BVH)"
    if dev.traversal != "packet":
        return f"{dev.traversal} traversal (an XLA walk, not the kernels')"
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
    None when it can run.  As in the JAX package the fused tables go to
    the per-depth pipeline (pt_frame has a fused arm all the same, which
    trace_advanced_frame runs when called directly), and the tree-size
    bound counts the closest-hit node rows (`pnodes`; the 48-col rows
    have as many).  CPUGPU_NO_PTFRAME=1 opts out (A/B runs);
    CPUGPU_FORCE_PTFRAME=1 lifts the tree-size bound."""
    if os.environ.get("CPUGPU_NO_PTFRAME") == "1":
        return "CPUGPU_NO_PTFRAME=1"
    reason = megakernel_gate_reason(dev, settings)
    if reason is not None:
        return reason
    if dev.machinery:
        return "TLAS instance machinery (flattened scenes qualify)"
    if dev.poccl_pay is not None:
        return "leaf-14 closest-hit tables (CPUGPU_LEAF14)"
    if dev.pfused is not None:
        return "fused packet tables"
    if dev.poccl_width != 8:
        return "16-wide occlusion tables (CPUGPU_OCCL_W16 lab)"
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
    """Nearest hit per lane, in the JAX package's field order: t, object
    index (-1 = miss), PRIM_* kind, primitive index (original triangle
    id, sphere or plane index), bvh_depth (the traversal's count_depth;
    0 without it), the instance id (-1 = a world-space hit) and the mesh
    hit's flat normal (3 (N,) columns; in the instance's object space when
    inst >= 0)."""

    t: torch.Tensor
    obj: torch.Tensor
    kind: torch.Tensor
    prim: torch.Tensor
    bvh_depth: torch.Tensor
    inst: torch.Tensor
    normal: tuple | None


def _analytic_arm(origin, direction, t, obj, kind, prim, points, params,
                  objs, test, prim_kind):
    """Nearest analytic primitive of one kind closer than t: a strict <
    per-object loop, ties keep the lowest index (the JAX package's
    batched form beyond ANALYTIC_UNROLL_MAX objects, kept there for TPU
    compile time, gives the same hits and is not ported)."""
    count = points.shape[0]
    if count == 0:
        return t, obj, kind, prim
    best = torch.full_like(t, float("inf"))
    bj = torch.zeros_like(obj)
    for j in range(count):
        valid, tj = test(origin, direction, points[j], params[j])
        closer = valid & (tj < t) & (tj < best)
        best = torch.where(closer, tj, best)
        bj = torch.where(closer, torch.full_like(bj, j), bj)
    closer = torch.isfinite(best)
    return (torch.where(closer, best, t),
            torch.where(closer, objs[bj.long()], obj),
            torch.where(closer, torch.full_like(kind, prim_kind), kind),
            torch.where(closer, bj, prim))


def intersect_scene(dev: DeviceScene, origin, direction, t_init, *,
                    any_hit: bool = False, active=None,
                    count_depth: bool = True) -> Hit:
    """Nearest hit closer than t_init across every object
    (IntersectScene, Source/Main.cpp:299-316): the mesh trees through
    ops/traverse_packet_slim (closest or any hit; `active` masks lanes
    out of the traversal), then the analytic spheres and planes.  Rows of
    lanes that are not active are unspecified.

    A snapshot on an XLA walk takes it instead, "skip", then "wide", then
    "binary" as the JAX package dispatches (ops/traverse_skip,
    traverse_wide, traverse): the object of a hit from tri_obj, or from
    inst_obj where the walk reports an instance; bvh_depth is the walk's
    count, whatever count_depth says (the JAX walks always count), and
    the hit carries no normal (hit_surface takes tri_normal).  With any_hit, `obj >= 0`
    says whether anything lies closer than t_init (the analytic loop's
    nearest hit and an any-hit agree on existence).

    On a scene on the object-space instance machinery the traversal
    runs the kernel's instance arm (inst_inv, inst_blas_root_packet) and
    `inst` holds the instance of each mesh hit; a flattened scene's
    tables are world-space already and `inst` stays -1.

    count_depth (the default, as in the JAX function) has the traversal
    count each lane's bvh_depth (traverse_packet_slim); a caller that
    reads no count passes False, which also keeps the CPU plain version
    on its brute-force path.  Lanes without a mesh tree get 0.

    origin/direction: (N, 3) tensors or 3-tuples of (N,) columns."""
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
    inst = torch.full_like(obj, -1)
    depth = torch.zeros_like(obj)
    normal = None
    walk = None
    if dev.traversal == "skip" and dev.sroot >= 0:
        walk = tsk.traverse_skip(
            origin, direction, t_init, dev.snodes12, dev.stris9, dev.sleaf_id,
            dev.sroot, active=active, any_hit=any_hit,
            graphs=dev.walk_graphs,
            **_walk_instances(dev, dev.inst_blas_root_skip))
    elif dev.traversal == "wide" and dev.wroots:
        walk = tw.traverse8(
            origin, direction, t_init, dev.wnodes, dev.wtris9, dev.wleaf_id,
            dev.wroots, active=active, any_hit=any_hit,
            stack_depth=dev.wstack_depth, graphs=dev.walk_graphs,
            **_walk_instances(dev, dev.inst_blas_root))
    elif dev.traversal == "binary" and dev.roots:
        t, tri, depth = trav.traverse(
            origin, direction, t_init, dev.nodes8, dev.tri_perm, dev.tris9,
            dev.roots, active=active, any_hit=any_hit,
            graphs=dev.walk_graphs)
        mesh_hit = tri >= 0
        obj = torch.where(mesh_hit, select_rows(dev.tri_obj, tri), obj)
        prim = torch.where(mesh_hit, tri, prim)
    if walk is not None:
        t, tri, depth, hit_iid = walk
        mesh_hit = tri >= 0
        inst = torch.where(mesh_hit, hit_iid, inst)
        tobj = select_rows(dev.tri_obj, tri)
        if dev.num_instances:
            tobj = torch.where(hit_iid >= 0,
                               select_rows(dev.inst_obj, hit_iid), tobj)
        obj = torch.where(mesh_hit, tobj, obj)
        prim = torch.where(mesh_hit, tri, prim)
    if dev.traversal == "packet" and dev.proots:
        nodes, ltris, fused_nn, ents = packet_tables(dev)
        res = tps.traverse_packet_slim(
            o_c, d_c, t_init, nodes, ltris, dev.proots,
            active=active, any_hit=any_hit, count_depth=count_depth,
            fused_nn=fused_nn, width=dev.packet_width, ents=ents,
            **dev.inst_kwargs(nrm=False))
        t, tri, mobj, normal, depth = res[:5]
        mesh_hit = tri >= 0
        obj = torch.where(mesh_hit, mobj, obj)
        prim = torch.where(mesh_hit, tri, prim)
        if dev.machinery:
            inst = torch.where(mesh_hit, res[5], inst)
    t, obj, kind, prim = _analytic_arm(
        origin, direction, t, obj, kind, prim, dev.mk_sph[:dev.num_sph, 0:3],
        dev.mk_sph[:dev.num_sph, 3], dev.sph_obj, intersect.intersect_sphere,
        PRIM_SPHERE)
    t, obj, kind, prim = _analytic_arm(
        origin, direction, t, obj, kind, prim, dev.mk_pln[:dev.num_pln, 0:3],
        dev.mk_pln[:dev.num_pln, 3:6], dev.pln_obj, intersect.intersect_plane,
        PRIM_PLANE)
    return Hit(t=t, obj=obj, kind=kind, prim=prim, bvh_depth=depth,
               inst=inst, normal=normal)


def _walk_instances(dev: DeviceScene, blas_root) -> dict:
    """The instance arguments of an XLA walk (inst_inv and the walk's
    BLAS roots), none without instances."""
    if not dev.num_instances:
        return {}
    return dict(inst_inv=dev.inst_inv, inst_blas_root=blas_root)


def hit_surface(dev: DeviceScene, hit: Hit, origin, direction):
    """GetRayHitResult (Source/Main.cpp:325-338): hit position, geometric
    normal (the flat triangle normal of a mesh hit: the walk's, else
    tri_normal[prim]; of an instance hit normalize(inst_nrm @ n_object))
    and material index per lane; origin/direction (N, 3).  Lanes that
    missed get clamped garbage the caller masks."""
    pos = origin + direction * hit.t[:, None]
    pc = torch.clamp(hit.prim, min=0)
    zero = torch.zeros_like(pos)
    if hit.normal is not None:
        n_mesh = torch.stack(hit.normal, dim=1)
    elif dev.num_triangles:
        n_mesh = select_rows(dev.tri_normal, pc)
    else:
        n_mesh = zero
    if dev.num_instances:
        # the JAX package's explicit arithmetic, which the shade_extend
        # kernel's epilogue repeats, so the two agree bitwise
        n_mesh = torch.stack(ptf.instance_normal(
            dev.inst_nrm, hit.inst, n_mesh[:, 0], n_mesh[:, 1],
            n_mesh[:, 2]), dim=1)
    n_sph = n_pln = zero
    if dev.num_sph:
        n_sph = normalize(pos - select_rows(dev.mk_sph[:dev.num_sph, 0:3], pc))
    if dev.num_pln:
        n_pln = select_rows(dev.mk_pln[:dev.num_pln, 3:6], pc)
    normal = torch.where((hit.kind == PRIM_SPHERE)[:, None], n_sph,
                         torch.where((hit.kind == PRIM_PLANE)[:, None], n_pln,
                                     n_mesh))
    mat_idx = select_rows(dev.mk_objmat, hit.obj)
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
