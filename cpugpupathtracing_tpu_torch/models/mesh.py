"""Host-side mesh representation and procedural generators.

The reference's Mesh is {vertices: [pos, normal], indices: u32}
(Include/Primitives.h:14-27). Here a mesh is SoA numpy: positions (V,3),
normals (V,3), indices (I,) u32 -- flattened to device triangle arrays by
the scene builder.

Procedural generators provide test fixtures (the reference uses a
12-triangle Cube.gltf, Assets/Models/Cube) and a high-poly stand-in for
the glass-dragon benchmark scene: the reference's DragonAttenuation.bin
buffer is not present in the mounted assets, so `dragon_standin()`
generates a ~91k-triangle trefoil torus-knot at matching workload scale.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray    # (V, 3) float32
    indices: np.ndarray    # (I,)  uint32, I % 3 == 0

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, np.float32)
        self.normals = np.ascontiguousarray(self.normals, np.float32)
        self.indices = np.ascontiguousarray(self.indices, np.uint32)
        if self.positions.shape != self.normals.shape:
            raise ValueError("positions/normals shape mismatch")
        if len(self.indices) % 3 != 0:
            raise ValueError("index count not divisible by 3")

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3

    def triangles(self):
        """Gather (T,3,3) triangle vertex positions and (T,3,3) normals."""
        idx = self.indices.reshape(-1, 3)
        return self.positions[idx], self.normals[idx]

    def concat(self, other: "Mesh") -> "Mesh":
        return Mesh(
            np.concatenate([self.positions, other.positions]),
            np.concatenate([self.normals, other.normals]),
            np.concatenate([self.indices, other.indices + len(self.positions)]),
        )


def quad(p0, p1, p2, p3, normal) -> Mesh:
    """Two-triangle quad with indices (0,1,2),(2,3,0), the reference's
    ground-plane construction (Source/Main.cpp:789-800)."""
    pos = np.array([p0, p1, p2, p3], np.float32)
    nrm = np.tile(np.asarray(normal, np.float32), (4, 1))
    return Mesh(pos, nrm, np.array([0, 1, 2, 2, 3, 0], np.uint32))


def ground_quad(half_extent: float = 1000.0, y: float = -3.0) -> Mesh:
    """The reference's hard-coded ground (Source/Main.cpp:789-800)."""
    e, n = half_extent, (0.0, 1.0, 0.0)
    return quad((-e, y, e), (-e, y, -e), (e, y, -e), (e, y, e), n)


def cube(center=(0.0, 0.0, 0.0), half: float = 1.0) -> Mesh:
    """12-triangle axis-aligned cube with per-face flat normals."""
    c = np.asarray(center, np.float32)
    faces = [
        ((1, 0, 0), [(1, -1, -1), (1, 1, -1), (1, 1, 1), (1, -1, 1)]),
        ((-1, 0, 0), [(-1, -1, 1), (-1, 1, 1), (-1, 1, -1), (-1, -1, -1)]),
        ((0, 1, 0), [(-1, 1, -1), (-1, 1, 1), (1, 1, 1), (1, 1, -1)]),
        ((0, -1, 0), [(-1, -1, 1), (-1, -1, -1), (1, -1, -1), (1, -1, 1)]),
        ((0, 0, 1), [(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]),
        ((0, 0, -1), [(1, -1, -1), (-1, -1, -1), (-1, 1, -1), (1, 1, -1)]),
    ]
    pos, nrm, idx = [], [], []
    for normal, verts in faces:
        base = len(pos)
        for v in verts:
            pos.append(c + half * np.asarray(v, np.float32))
            nrm.append(np.asarray(normal, np.float32))
        idx += [base, base + 1, base + 2, base + 2, base + 3, base]
    return Mesh(np.asarray(pos), np.asarray(nrm), np.asarray(idx, np.uint32))


def icosphere(center=(0.0, 0.0, 0.0), radius: float = 1.0, subdivisions: int = 2) -> Mesh:
    """Subdivided icosahedron with flat per-face normals (matching the
    reference's flat TriangleNormal shading, Source/Primitives.cpp:148-151:
    normals interpolate nothing, so shared vertices are fine but we emit
    the face normal at v0)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
            (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
            (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        cache: dict[tuple[int, int], int] = {}
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (vlist[a] + vlist[b]) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for a, b, c_ in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c_), midpoint(c_, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c_, ca, bc), (ab, bc, ca)]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    pos = verts[faces.reshape(-1)] * radius + np.asarray(center, np.float64)
    tri = pos.reshape(-1, 3, 3)
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    nrm = np.repeat(fn, 3, axis=0)
    idx = np.arange(len(pos), dtype=np.uint32)
    return Mesh(pos.astype(np.float32), nrm.astype(np.float32), idx)


def torus_knot(
    p: int = 2,
    q: int = 3,
    segments: int = 256,
    sides: int = 180,
    scale: float = 2.0,
    tube_radius: float = 0.55,
    center=(0.0, 0.0, 0.0),
) -> Mesh:
    """(p,q) torus knot tube; defaults give 2*256*180 = 92,160 triangles,
    matching the ~91k-triangle dragon workload of the reference benchmark
    scene (BASELINE.md). Flat per-face normals at every vertex."""
    t = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    r = np.cos(q * t) + 2.0
    curve = np.stack(
        [r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], axis=1
    ) * (scale / 3.0)

    # Frenet-like frame along the curve
    nxt = np.roll(curve, -1, axis=0)
    tangent = nxt - curve
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    side = np.cross(tangent, up)
    side /= np.maximum(np.linalg.norm(side, axis=1, keepdims=True), 1e-9)
    upv = np.cross(side, tangent)

    theta = np.linspace(0.0, 2.0 * np.pi, sides, endpoint=False)
    ring = (
        np.cos(theta)[None, :, None] * side[:, None, :]
        + np.sin(theta)[None, :, None] * upv[:, None, :]
    )
    pts = curve[:, None, :] + tube_radius * ring  # (segments, sides, 3)
    pts = pts + np.asarray(center, np.float64)

    s_idx = np.arange(segments)
    t_idx = np.arange(sides)
    s1 = (s_idx + 1) % segments
    t1 = (t_idx + 1) % sides
    # vertex grid index helper
    vid = lambda s, t_: (s[:, None] * sides + t_[None, :]).ravel()
    a = vid(s_idx, t_idx)
    b = vid(s1, t_idx)
    c = vid(s1, t1)
    d = vid(s_idx, t1)
    idx = np.empty(segments * sides * 6, np.uint32)
    idx[0::6], idx[1::6], idx[2::6] = a, b, c
    idx[3::6], idx[4::6], idx[5::6] = c, d, a

    flat_pos = pts.reshape(-1, 3)
    # expand to unshared vertices so flat face normals are exact
    tri_pos = flat_pos[idx].reshape(-1, 3, 3)
    fn = np.cross(tri_pos[:, 1] - tri_pos[:, 0], tri_pos[:, 2] - tri_pos[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    pos_out = tri_pos.reshape(-1, 3)
    nrm_out = np.repeat(fn, 3, axis=0)
    return Mesh(
        pos_out.astype(np.float32),
        nrm_out.astype(np.float32),
        np.arange(len(pos_out), dtype=np.uint32),
    )


def dragon_standin() -> Mesh:
    """~92k-triangle stand-in for the missing DragonAttenuation.bin,
    scaled/positioned like the dragon in the reference view (camera at
    (0,0,8) looking -z, Source/Main.cpp:777)."""
    return torus_knot(center=(0.0, 0.0, 0.0))
