"""Host-side BVH build, device-flat node arrays.

A copy of the JAX package's models/bvh.py (the port imports nothing of
that package) without its numpy builder: the port builds every tree with
the native C++ builder (native/bvh_builder.cc, the same source as the
JAX package's), so the trees are bitwise the same.

The reference's binary BVH (Source/BVH.cpp) with the same node
semantics: a node is {aabb_min, aabb_max, left_first, prim_count};
prim_count > 0 marks a leaf whose primitives are tri_indices[left_first :
left_first + prim_count]; interior nodes store the left-child index, and
the right child is left+1 (Include/BVH.h:29-34).

Build options (Include/BVH.h:10-16):
  * NAIVE_SPLIT -- longest-axis midpoint, leaf <= 2 tris
    (Source/BVH.cpp:208-224).
  * SAH_SPLIT_INTERVALS -- 8 uniform candidate positions x 3 axes; cost =
    count x half-surface-area, in float32 as the reference computes it
    (Source/BVH.cpp:225-259).
  * SAH_SPLIT_PRIMITIVES -- candidate positions at every triangle centroid,
    by a sorted full sweep with prefix/suffix bounds (the reference's
    version is dead code, Source/BVH.cpp:279-293).

`max_leaf_size` optionally forces median splits of oversized leaves: the
device tables hold a bounded number of triangles per leaf row.  Any valid
BVH returns identical hits; this only reshapes the tree.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cpugpupathtracing_tpu_torch.config import BuildOption

_F32 = np.float32


def _half_area(bmin: np.ndarray, bmax: np.ndarray) -> np.float32:
    """GetAABBVolume (Source/Primitives.cpp:280-284): xy + yz + zx, f32."""
    e = (bmax - bmin).astype(_F32)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def triangle_areas(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Heron's formula per GetTriangleArea (Source/Primitives.cpp:270-278)."""
    a = np.linalg.norm(v1 - v0, axis=-1)
    b = np.linalg.norm(v2 - v0, axis=-1)
    c = np.linalg.norm(v2 - v1, axis=-1)
    s = (a + b + c) / 2.0
    return np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 0.0))


@dataclasses.dataclass
class BVH:
    """Flat BVH over the triangles of one mesh."""

    # triangle data, original order
    tri_v0: np.ndarray      # (T, 3) f32
    tri_v1: np.ndarray      # (T, 3) f32
    tri_v2: np.ndarray      # (T, 3) f32
    tri_normal: np.ndarray  # (T, 3) f32 -- flat v0.normal per triangle
    # flat nodes
    nodes_min: np.ndarray   # (B, 3) f32
    nodes_max: np.ndarray   # (B, 3) f32
    left_first: np.ndarray  # (B,) i32
    prim_count: np.ndarray  # (B,) i32
    tri_indices: np.ndarray  # (T,) i32 permutation
    max_depth: int
    total_area: float
    build_option: BuildOption
    max_leaf_size: int | None = None

    @property
    def num_triangles(self) -> int:
        return len(self.tri_v0)

    @property
    def num_nodes(self) -> int:
        return len(self.left_first)

    def get_triangle(self, index: int):
        """BVH::GetTriangle (Source/BVH.cpp:129-132)."""
        return self.tri_v0[index], self.tri_v1[index], self.tri_v2[index]

    def rebuild(
        self,
        build_option: BuildOption,
        max_leaf_size: int | None = None,
        leaf_stop: int | None = None,
    ) -> "BVH":
        """BVH::Rebuild (Source/BVH.cpp:47-59): rebuild over the same
        triangles with a different heuristic. Returns a new BVH (buffers
        are swapped between frames instead of mutated under tracing --
        the reference mutates in place and races its render threads)."""
        return _build_from_triangles(
            self.tri_v0, self.tri_v1, self.tri_v2, self.tri_normal,
            build_option, max_leaf_size, leaf_stop,
        )


def build(
    positions: np.ndarray,
    normals: np.ndarray,
    indices: np.ndarray,
    build_option: BuildOption = BuildOption.SAH_SPLIT_INTERVALS,
    max_leaf_size: int | None = None,
    leaf_stop: int | None = None,
) -> BVH:
    """BVH::Build (Source/BVH.cpp:11-45): flatten the indexed mesh to a
    triangle soup, then subdivide."""
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    pos = np.asarray(positions, _F32)
    nrm = np.asarray(normals, _F32)
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    tri_normal = nrm[idx[:, 0]]  # flat v0.normal (Source/Primitives.cpp:148-151)
    return _build_from_triangles(
        v0, v1, v2, tri_normal, build_option, max_leaf_size, leaf_stop
    )


def _build_from_triangles(
    v0, v1, v2, tri_normal, build_option, max_leaf_size, leaf_stop=None
) -> BVH:
    t = len(v0)
    if t == 0:
        raise ValueError("cannot build BVH over zero triangles")
    total_area = float(triangle_areas(v0, v1, v2).sum())

    from cpugpupathtracing_tpu_torch import native

    tri9 = np.concatenate(
        [np.asarray(v0, _F32), np.asarray(v1, _F32), np.asarray(v2, _F32)], axis=1
    )
    nmin, nmax, left_first, prim_count, perm, max_depth = native.native_bvh_build(
        tri9, int(build_option), max_leaf_size, leaf_stop
    )
    return BVH(
        tri_v0=np.ascontiguousarray(v0, _F32),
        tri_v1=np.ascontiguousarray(v1, _F32),
        tri_v2=np.ascontiguousarray(v2, _F32),
        tri_normal=np.ascontiguousarray(tri_normal, _F32),
        nodes_min=nmin,
        nodes_max=nmax,
        left_first=left_first,
        prim_count=prim_count,
        tri_indices=perm,
        max_depth=max_depth,
        total_area=total_area,
        build_option=build_option,
        max_leaf_size=max_leaf_size,
    )
