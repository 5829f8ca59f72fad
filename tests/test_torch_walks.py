"""The port's XLA walks (cpugpupathtracing_tpu_torch ops/traverse.py,
ops/traverse_wide.py, ops/traverse_skip.py), their packers, their
scenes' tables and intersect_scene / hit_surface over them
(models/scene.py), and ops/gathers.py, against the JAX package on the
CPU, on the golden scene (icosphere, cube, floor plane, sphere light)
and on tests/test_instances.py's 4-instance scene, with camera rays,
inactive lanes and short t_init made from a numpy seed.  One module
fixture runs JAX intersect_scene op by op per case, closest and (one
case a walk) any hit, and keeps the output of the walk it called.

Tolerances:
  * the walks against the JAX walks run op by op (jax.disable_jit(); the
    only reduction that XLA's CPU compiler fuses into FMAs there, the
    instance arm's einsum, the port computes as the same FMA chain), on
    the JAX snapshots' own tables, closest and any hit:
    with the JAX function's exact slab test (slab_pad=1) every output
    (t, triangle id, bvh_depth, hit instance) bitwise on every lane;
    with the port's slab margin (ROADMAP condition 12) the lanes that
    differ from JAX are the lanes where the margin changed the walk, and
    on them the closest hit (t, id, instance) equals brute force and an
    any hit's existence brute force's;
  * the check cadence changes no output: bitwise;
  * the port's own build: its walk tables, instance tables and world
    bounds bitwise the JAX package's; intersect_scene and hit_surface
    every field bitwise (t, object, kind, primitive, instance, position,
    normal, material), bvh_depth bitwise but on the margin's lanes;
  * the BVH_DEPTH view on a "wide" scene: its pixels bitwise the JAX
    package's heatmap (op by op) of its wide walk's bvh_depth;
  * the packers and select_rows: bitwise."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.config import BuildOption as JBuildOption
from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
from cpugpupathtracing_tpu.models import bvh as jbvh
from cpugpupathtracing_tpu.models import camera as jcam
from cpugpupathtracing_tpu.models import integrators as jint
from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu.ops import gathers as jgathers
from cpugpupathtracing_tpu.ops import traverse as jtrav
from cpugpupathtracing_tpu.ops import traverse_skip as jskip
from cpugpupathtracing_tpu.ops import traverse_wide as jwide
from cpugpupathtracing_tpu.utils import vecmath as jvec
from cpugpupathtracing_tpu_torch.config import (
    BuildOption,
    CameraConfig,
    DebugRenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import bvh as tbvh
from cpugpupathtracing_tpu_torch.models import camera as tcam
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import renderer as trenderer
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.ops import gathers as tgathers
from cpugpupathtracing_tpu_torch.ops import intersect as tint
from cpugpupathtracing_tpu_torch.ops import traverse as ttrav
from cpugpupathtracing_tpu_torch.ops import traverse_skip as tskip
from cpugpupathtracing_tpu_torch.ops import traverse_wide as twide

from tests.test_instances import TRANSFORMS
from tests.test_torch_scene import REPO, golden_scene

W, H = 32, 16
N = W * H
CAMERA = (0.05, 0.3, 4.5)
WALKS = ("binary", "wide", "skip")
CASES = [("binary", False), ("wide", False), ("skip", False), ("wide", True),
         ("skip", True)]
IDS = [f"{w}-{'inst' if i else 'plain'}" for w, i in CASES]
# the cases whose any hit runs too: every walk once (the instanced wide
# and skip scenes walk their plain leaves inside the instances)
ANY_CASES = (("binary", False), ("wide", True), ("skip", True))
QUERIES = [pytest.param(w, i, a, id=f"{x}-{'any' if a else 'closest'}")
           for (w, i), x in zip(CASES, IDS)
           for a in (False, True) if not a or (w, i) in ANY_CASES]
# the walk tables a snapshot of each walk carries (beside tri_obj)
OWN = {"binary": ("nodes8", "tri_perm"),
       "wide": ("wnodes", "wtris9", "wleaf_id", "inst_blas_root"),
       "skip": ("snodes12", "stris9", "sleaf_id", "inst_blas_root_skip")}
META = {"binary": ("roots",), "wide": ("wroots", "wstack_depth"),
        "skip": ("sroot",)}
# tables both packages build for every snapshot (the packet tables and
# the kernels' small tables aside)
SHARED = ("tris9", "tri_normal", "inst_inv", "inst_nrm", "inst_obj",
          "sph_obj", "pln_obj", "world_lo", "world_inv_extent", "light_obj",
          "light_is_sphere", "light_sph_center", "light_sph_radius",
          "light_tri_start", "light_tri_count", "light_half_area")


def scene(S, mat, mesh, walk, instanced=False):
    """The golden scene (icosphere, cube, floor plane, sphere light), or
    tests/test_instances.py's four instanced icospheres over a floor
    plane with a sphere light, on `walk` ("binary" through
    use_wide=False, the JAX package's way to its binary walk)."""
    if not instanced:
        s = golden_scene(S, mat, mesh)
    else:
        s = S.Scene()
        grey = s.add_material(mat.Material.diffuse((0.5, 0.5, 0.5)))
        s.add_instanced_mesh("spheres", mesh.icosphere(subdivisions=2),
                             grey, TRANSFORMS)
        s.add_plane("floor", (0.0, -4.0, 0.0), (0.0, 1.0, 0.0), grey)
        s.mark_light(s.add_sphere("light", (6.0, 9.0, 6.0), 2.0,
                                  s.add_material(mat.Material.light(
                                      (1.0, 0.95, 0.8), 10.0))))
    s.use_wide = walk != "binary"
    s.traversal = walk
    return s


def _t(a):
    return torch.from_numpy(np.array(a))


def camera_rays(instanced):
    """The 32x16 camera's rays (row-major) at CAMERA, or, for the
    instanced scene, at (0.3, 1.0, 4) to see all four spheres."""
    pos = (0.3, 1.0, 4.0) if instanced else CAMERA
    cam = jcam.to_arrays(JCameraConfig(pos=pos, aspect=W / H))
    o, d = jcam.lane_rays(cam, jnp.arange(N, dtype=jnp.uint32), W, H)
    return np.array(o), np.array(d)


def _rays(instanced, seed=7):
    """camera_rays with 16 lanes along -z (a zero direction component),
    20% of the lanes inactive and 30% with a short t_init."""
    o, d = camera_rays(instanced)
    rng = np.random.default_rng(seed)
    o[:16] = np.stack([np.linspace(-2.0, 3.5, 16), np.full(16, 0.2),
                       np.full(16, 8.0)], axis=1)
    d[:16] = [0.0, 0.0, -1.0]
    t0 = np.where(rng.uniform(size=N) < 0.7, 1e34,
                  rng.uniform(1.0, 10.0, N)).astype(np.float32)
    act = rng.uniform(size=N) < 0.8
    return o, d, t0, act


def port_walk(jdev, walk, rays, any_hit, **kw):
    """The port's walk on the JAX snapshot's tables."""
    o, d, t0, act = (_t(a) for a in rays)
    inst = jdev.num_instances > 0
    if walk == "binary":
        out = ttrav.traverse(o, d, t0, _t(jdev.nodes8), _t(jdev.tri_perm),
                             _t(jdev.tris9), jdev.roots, active=act,
                             any_hit=any_hit, **kw)
    elif walk == "wide":
        out = twide.traverse8(
            o, d, t0, _t(jdev.wnodes), _t(jdev.wtris9), _t(jdev.wleaf_id),
            jdev.wroots, active=act, any_hit=any_hit,
            stack_depth=jdev.wstack_depth,
            inst_inv=_t(jdev.inst_inv) if inst else None,
            inst_blas_root=_t(jdev.inst_blas_root) if inst else None, **kw)
    else:
        out = tskip.traverse_skip(
            o, d, t0, _t(jdev.snodes12), _t(jdev.stris9), _t(jdev.sleaf_id),
            jdev.sroot, active=act, any_hit=any_hit,
            inst_inv=_t(jdev.inst_inv) if inst else None,
            inst_blas_root=_t(jdev.inst_blas_root_skip) if inst else None,
            **kw)
    return [x.numpy() for x in out]


def _capture(mp, mod, name, seen):
    """Record the outputs of every call of mod.name in `seen`."""
    fn = getattr(mod, name)

    def wrapped(*a, **k):
        r = fn(*a, **k)
        seen.append([np.asarray(x) for x in r])
        return r

    mp.setattr(mod, name, wrapped)


@pytest.fixture(scope="module")
def jax_runs():
    """Per case the JAX snapshot, the rays, and JAX intersect_scene op by
    op, closest hit (with hit_surface) and, in ANY_CASES, any hit, each
    with the output of the walk it called (captured)."""
    mp = pytest.MonkeyPatch()
    walks = []
    for mod, name in ((jtrav, "traverse"), (jwide, "traverse8"),
                      (jskip, "traverse_skip")):
        _capture(mp, mod, name, walks)
    out = {}
    try:
        for walk, inst in CASES:
            jdev = scene(jscene, jmat, jmesh, walk, inst).device()
            rays = _rays(inst)
            o, d, t0, act = (jnp.asarray(a) for a in rays)
            res = {}
            for any_hit in (False, True)[:2 if (walk, inst) in ANY_CASES
                                         else 1]:
                with jax.disable_jit():
                    h = jscene.intersect_scene(jdev, o, d, t0,
                                               any_hit=any_hit, active=act)
                    fields = dict(t=h.t, obj=h.obj, kind=h.kind, prim=h.prim,
                                  bvh_depth=h.bvh_depth, inst=h.inst)
                    if not any_hit:
                        fields.update(zip(("pos", "normal", "mat"),
                                          jscene.hit_surface(jdev, h, o, d)))
                res[any_hit] = (walks[-1], {k: np.asarray(v)
                                            for k, v in fields.items()})
            out[walk, inst] = (jdev, rays, res)
    finally:
        mp.undo()
    assert len(walks) == len(QUERIES)
    return out


def _bits(a):
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.astype(b.dtype).tobytes() == b.tobytes()


def brute(jdev, rays):
    """Closest hits by brute force: (t, original id, instance); every
    instance's rays moved into its object space with the walks' own
    arithmetic (traverse.object_ray), the nearest strictly closer hit
    kept, so ties go to the lowest id, then the lowest instance."""
    o, d, t0, _ = (_t(a) for a in rays)
    tris = _t(jdev.tris9)
    v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    if not jdev.num_instances:
        t, i = tint.brute_force_nearest_triangle(o, d, v0, e1, e2, t0)
        return t.numpy(), i.numpy(), np.full(N, -1)
    t, tri = t0.clone(), torch.full((N,), -1, dtype=torch.int64)
    iid = tri.clone()
    for k in range(jdev.num_instances):
        ok, dk, _ = ttrav.object_ray(_t(jdev.inst_inv), torch.full(
            (N,), k, dtype=torch.int32), o, d)
        tk, ik = tint.brute_force_nearest_triangle(ok, dk, v0, e1, e2, t)
        closer = ik >= 0
        t = torch.where(closer, tk, t)
        tri = torch.where(closer, ik, tri)
        iid = torch.where(closer, k, iid)
    return t.numpy(), tri.numpy(), iid.numpy()


@pytest.mark.parametrize("walk,instanced,any_hit", QUERIES)
def test_walk_vs_jax(jax_runs, walk, instanced, any_hit):
    """Exact slab: every output bitwise JAX's.  The port's margin: the
    lanes that differ are the margin's lanes, where the closest hit
    equals brute force (any hit: its existence)."""
    jdev, rays, res = jax_runs[walk, instanced]
    want = res[any_hit][0]
    exact = port_walk(jdev, walk, rays, any_hit, slab_pad=1.0)
    assert len(exact) == len(want) == (3 if walk == "binary" else 4)
    for k, (a, b) in enumerate(zip(exact, want)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), k
    act = rays[3]
    hits = exact[1] >= 0
    assert hits[act].sum() > 20 and not hits[~act].any()
    if instanced:
        assert (exact[3][hits] >= 0).all() and len(set(exact[3][hits])) == 4

    got = port_walk(jdev, walk, rays, any_hit)
    differ = np.zeros(N, bool)
    for a, b in zip(got, want):
        differ |= _bits(a) != _bits(b)
    bt, bi, bii = brute(jdev, rays)
    if any_hit:
        assert ((got[1] >= 0) == (act & (bi >= 0))).all()
    else:
        on = differ & act
        assert np.array_equal(_bits(got[0][on]), _bits(bt[on]))
        assert np.array_equal(got[1][on], bi[on])
        if instanced:
            assert np.array_equal(got[3][on], bii[on])


@pytest.mark.parametrize("walk,instanced", CASES, ids=IDS)
def test_check_cadence_and_compaction(jax_runs, walk, instanced):
    """Asking for live lanes every step, every 8 or every 3 (the steps
    between two checks on the lanes live at the first): bitwise the same
    outputs; one host synchronisation a check."""
    jdev, rays, _ = jax_runs[walk, instanced]
    runs = []
    for every in (1, 8, 3):
        ttrav.reset_stats()
        runs.append(port_walk(jdev, walk, rays, False, check_every=every))
        st = dict(ttrav.stats)
        # the walk stops only at a check that finds no live lane
        assert st["calls"] == 1 and st["steps"] % every == 0
        assert st["syncs"] == st["steps"] // every + 1
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("walk,inst", CASES, ids=IDS)
def test_tables_vs_jax(jax_runs, walk, inst):
    """The port's snapshot carries its walk's tables, bitwise the JAX
    package's, with the walk's metadata, and no packet table."""
    jdev = jax_runs[walk, inst][0]
    tdev = scene(tscene, tmat, tmesh, walk, inst).build_device("cpu")
    assert tdev.traversal == jdev.traversal == walk
    assert tdev.use_wide == jdev.use_wide == (walk != "binary")
    for name in OWN[walk] + ("tri_obj",) + SHARED:
        assert _same(getattr(tdev, name).numpy(), getattr(jdev, name)), name
    for name in META[walk]:
        assert getattr(tdev, name) == getattr(jdev, name), name
    for name, _ in tscene.WALK_FIELDS:
        if name not in OWN[walk] + ("tri_obj",):
            assert getattr(tdev, name) is None, name
    assert not tdev.proots and tdev.pnodes.shape[0] == 0
    assert tdev.pltris.shape[0] == 0 and tdev.poccl_nodes.shape[0] == 0
    assert all(getattr(tdev, n) is None for n, _ in tscene.VARIANT_FIELDS)
    assert tdev.node_table is getattr(tdev, OWN[walk][0])


def _margin_lanes(tdev, walk, rays, any_hit):
    """Lanes whose walk the slab margin changed: the port's walk at
    SLAB_PAD and at 1 (the JAX test) differ in some output."""
    class _Tables:  # the port snapshot's tables as port_walk reads them
        def __getattr__(self, name):
            v = getattr(tdev, name)
            return v.numpy() if isinstance(v, torch.Tensor) else v
    a = port_walk(_Tables(), walk, rays, any_hit)
    b = port_walk(_Tables(), walk, rays, any_hit, slab_pad=1.0)
    out = np.zeros(N, bool)
    for x, y in zip(a, b):
        out |= _bits(x) != _bits(y)
    return out


@pytest.mark.parametrize("walk,inst,any_hit", QUERIES)
def test_intersect_scene_vs_jax(jax_runs, walk, inst, any_hit):
    """intersect_scene (and for closest hits hit_surface) on the port's
    own build against JAX's on the same walk, op by op, with inactive
    lanes and short t_init: every field bitwise, bvh_depth but on the
    margin's lanes; the mesh normal from tri_normal (the walks return
    none), instance hits transformed."""
    jdev, rays, res = jax_runs[walk, inst]
    want = res[any_hit][1]
    tdev = scene(tscene, tmat, tmesh, walk, inst).build_device("cpu")
    o, d, t0, act = (_t(a) for a in rays)
    h = tscene.intersect_scene(tdev, o, d, t0, any_hit=any_hit, active=act)
    assert h.normal is None
    got = dict(t=h.t, obj=h.obj, kind=h.kind, prim=h.prim,
               bvh_depth=h.bvh_depth, inst=h.inst)
    if not any_hit:
        got.update(zip(("pos", "normal", "mat"),
                       tscene.hit_surface(tdev, h, o, d)))
    assert set(got) == set(want)
    for k, v in got.items():
        if k != "bvh_depth":
            assert _same(v.numpy(), want[k]), k
    differ = got["bvh_depth"].numpy() != want["bvh_depth"]
    assert not (differ & ~_margin_lanes(tdev, walk, rays, any_hit)).any()
    mesh = (want["obj"] >= 0) & (want["kind"] == tscene.PRIM_MESH)
    assert mesh.sum() > 30 and (got["bvh_depth"].numpy()[mesh] >= 1).all()
    if inst:
        hits = want["inst"][mesh]
        assert (hits >= 0).all() and len(set(hits.tolist())) == 4
        if not any_hit:  # the world image of the object-space normal
            n = got["normal"].numpy()[mesh]
            assert np.abs(np.linalg.norm(n, axis=1) - 1).max() < 1e-5


def test_bvh_depth_view_wide_vs_jax():
    """render_frame in the BVH_DEPTH view on a "wide" scene: its pixels
    bitwise the JAX package's heatmap of bvh_depth / 30 (op by op) of
    its wide walk; the accumulator unchanged, one traced ray a pixel."""
    jdev = scene(jscene, jmat, jmesh, "wide").device()
    o, d = camera_rays(False)
    with jax.disable_jit():
        depth = jscene.intersect_scene(
            jdev, jnp.asarray(o), jnp.asarray(d),
            jnp.full((N,), 1e34, jnp.float32)).bvh_depth
    tdev = scene(tscene, tmat, tmesh, "wide").build_device("cpu")
    settings = RenderSettings(debug_render_mode=DebugRenderMode.BVH_DEPTH)
    cam = tcam.to_arrays(CameraConfig(pos=CAMERA, aspect=W / H), "cpu")
    acc = torch.full((N, 4), 0.25)
    out, pixels, traced, _ = trenderer.render_frame(
        tdev, cam, acc, 0, torch.arange(N), settings, W, H, 1, 0x1CE)
    assert out is acc and int(traced) == N
    with jax.disable_jit():
        heat = jvec.lerp(jint._GREEN, jint._RED, (
            depth.astype(jnp.float32) / 30.0)[:, None])
        ref = jvec.vec4_to_uint(jnp.concatenate(
            [heat, jnp.ones((N, 1), jnp.float32)], axis=1))
    assert np.array_equal(pixels.numpy(), np.asarray(ref).astype(np.int64))
    assert len(set(pixels.tolist())) > 4


def test_argmin_keeps_the_first_index():
    """torch.argmin, like jnp.argmin, returns the first of equal minima
    (the binary walk's leaf chunk resolves an exact tie in t by it),
    also where every entry is inf."""
    inf = np.float32(np.inf)
    rows = np.array([[3, 1, 1, 2], [inf, inf, inf, inf], [5, 5, 5, 5],
                     [2, 7, 2, 1e-3]], np.float32)
    got = torch.argmin(_t(rows), dim=1).numpy()
    want = np.asarray(jnp.argmin(jnp.asarray(rows), axis=1))
    assert got.tolist() == want.tolist() == [1, 0, 0, 3]


def test_binary_walk_tie_hits_first_in_leaf():
    """Two coincident triangles in one leaf chunk: the binary walk
    reports the first of them in leaf order (argmin's first index, as in
    the JAX walk)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    pos = np.concatenate([v, v])
    idx = np.arange(6, dtype=np.int32)
    nrm = np.tile([0, 0, 1], (6, 1)).astype(np.float32)
    b = tbvh.build(pos, nrm, idx, BuildOption.SAH_SPLIT_INTERVALS,
                   max_leaf_size=4)
    assert b.num_nodes == 1
    nodes = ttrav.pack_nodes(b.nodes_min, b.nodes_max, b.left_first,
                             b.prim_count)
    tris = ttrav.pack_tris(b.tri_v0, b.tri_v1, b.tri_v2)
    t, tri, depth = ttrav.traverse(
        _t([[0.0, -0.2, 3.0]]).float(), _t([[0.0, 0.0, -1.0]]).float(),
        torch.full((1,), 1e34), _t(nodes), _t(b.tri_indices), _t(tris),
        (0,))
    assert int(tri[0]) == int(b.tri_indices[0]) and float(t[0]) == 3.0
    assert int(depth[0]) == 0


def test_packers_vs_jax(rng_np):
    """pack_nodes, pack_tris, pack_skip_nodes (chained, last, instanced
    ends) and pack_skip_tlas (1, 2, 4 and 13 instances, equal centers
    included) bitwise the JAX package's."""
    m = tmesh.icosphere(subdivisions=2)
    jm = jmesh.icosphere(subdivisions=2)
    tb = tbvh.build(m.positions, m.normals, m.indices,
                    BuildOption.SAH_SPLIT_INTERVALS, max_leaf_size=4)
    jb = jbvh.build(jm.positions, jm.normals, jm.indices,
                    JBuildOption.SAH_SPLIT_INTERVALS, max_leaf_size=4)
    lf = tb.left_first + 7
    pairs = [
        (ttrav.pack_nodes(tb.nodes_min, tb.nodes_max, lf, tb.prim_count),
         jtrav.pack_nodes(jb.nodes_min, jb.nodes_max, jb.left_first + 7,
                          jb.prim_count)),
        (ttrav.pack_tris(tb.tri_v0, tb.tri_v1, tb.tri_v2),
         jtrav.pack_tris(jb.tri_v0, jb.tri_v1, jb.tri_v2)),
    ]
    for tri_off, node_off, end in ((0, 0, jskip.NEXT_DONE),
                                   (11, 40, 97), (5, 3, jskip.NEXT_RETURN)):
        pairs.append((tskip.pack_skip_nodes(tb, tri_off, node_off, end),
                      jskip.pack_skip_nodes(jb, tri_off, node_off, end)))
    for num in (1, 2, 4, 13):
        lo = rng_np.normal(size=(num, 3)).astype(np.float32)
        lo[num // 2:] = lo[0]  # equal centers: the stable order decides
        hi = lo + rng_np.uniform(0.1, 2.0, (num, 3)).astype(np.float32)
        ids = np.arange(num)
        pairs.append((tskip.pack_skip_tlas(lo, hi, ids, jskip.NEXT_DONE, 9),
                      jskip.pack_skip_tlas(lo, hi, ids, jskip.NEXT_DONE, 9)))
    for got, want in pairs:
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert len(pairs[-1][0]) == 2 * 13 - 1


@pytest.mark.parametrize("k", [1, 4, 40])
def test_select_rows_vs_jax(k, rng_np):
    """select_rows against the JAX select chains (K <= 32) and gather
    (K = 40): 1-, 2- and 3-D tables, indices out of range both ways."""
    idx = rng_np.integers(-3, k + 3, 512).astype(np.int32)
    for shape in ((k,), (k, 3), (k, 2, 2)):
        table = rng_np.normal(size=shape).astype(np.float32)
        got = tgathers.select_rows(_t(table), _t(idx)).numpy()
        with jax.disable_jit():
            want = np.asarray(jgathers.select_rows(jnp.asarray(table),
                                                   jnp.asarray(idx)))
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    ints = np.arange(k, dtype=np.int32) * 3
    assert np.array_equal(tgathers.select_rows(_t(ints), _t(idx)).numpy(),
                          np.asarray(jgathers.select_rows(ints, idx)))


def test_select_rows_empty_table_raises():
    with pytest.raises(ValueError):
        tgathers.select_rows(torch.zeros((0, 3)), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        jgathers.select_rows(jnp.zeros((0, 3)), jnp.zeros(4, jnp.int32))


def test_walk_modules_import_no_jax(tmp_path):
    """The walks' modules (and the scene that dispatches to them) load
    neither jax nor the JAX package."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import cpugpupathtracing_tpu_torch.ops.gathers\n"
        "import cpugpupathtracing_tpu_torch.ops.traverse\n"
        "import cpugpupathtracing_tpu_torch.ops.traverse_wide\n"
        "import cpugpupathtracing_tpu_torch.ops.traverse_skip\n"
        "import cpugpupathtracing_tpu_torch.models.scene\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cpugpupathtracing_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
