"""The port's standalone traversal (cpugpupathtracing_tpu_torch
ops/traverse_packet_slim.py) and the scene queries over it
(models/scene.py intersect_scene / hit_surface) against the JAX
package's intersect_scene / hit_surface on the CPU (its XLA traversal),
on tests/test_megakernel.py's scene -- icosphere, floor quad, mirror
sphere, back wall plane, two sphere lights -- with the scene tables
handed over through scene_from_numpy.

Tolerance: bitwise.  Closest hits on every active lane: t, original
triangle id (prim), object, kind, hit position, and the normal and
material index of every lane that hit; any hits: whether there is one.
The JAX side runs op by op (jax.disable_jit()): under jit XLA's CPU
compiler contracts the triangle test's multiply-adds into FMAs, which
moves t by an ULP.  Random rays from a numpy seed, half of them with a
finite t_init and half of them inactive."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps

from tests.test_torch_scene import jax_tables, megakernel_scene

N = 256


@pytest.fixture(scope="module")
def queries():
    """Both packages' scenes and N random queries: origins in the scene's
    box, unit directions, t_init 1e34 or in [1, 15), active or not."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jscene, "PACKET_TREE", "sweep_dp")
    mp.setattr(jscene, "PACKET_OCCL", True)
    try:
        jdev = megakernel_scene(jscene, jmat, jmesh).device()
    finally:
        mp.undo()
    tdev = tscene.scene_from_numpy(*jax_tables(jdev), "cpu")
    rng = np.random.default_rng(5)
    o = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.where(rng.uniform(size=N) < 0.5, 1e34,
                  rng.uniform(1, 15, N)).astype(np.float32)
    act = rng.uniform(size=N) < 0.5
    return jdev, tdev, o, d, t0, act


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_intersect_scene_vs_jax(queries, any_hit):
    jdev, tdev, o, d, t0, act = queries
    with jax.disable_jit():
        jh = jscene.intersect_scene(
            jdev, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0),
            any_hit=any_hit, active=jnp.asarray(act), count_depth=False)
        jpos, jnrm, jmat_ = jscene.hit_surface(jdev, jh, jnp.asarray(o),
                                               jnp.asarray(d))
    th = tscene.intersect_scene(tdev, torch.from_numpy(o),
                                torch.from_numpy(d), torch.from_numpy(t0),
                                any_hit=any_hit,
                                active=torch.from_numpy(act))
    jobj = np.asarray(jh.obj)[act]
    tobj = th.obj.numpy()[act]
    hits = jobj >= 0
    assert 0.2 < hits.mean() < 0.9  # both hits and misses, mesh and not
    assert ((np.asarray(jh.kind)[act] == jscene.PRIM_MESH) & hits).any()
    np.testing.assert_array_equal(tobj >= 0, hits)
    if any_hit:
        return
    np.testing.assert_array_equal(tobj, jobj)
    for name in ("t", "kind", "prim"):
        np.testing.assert_array_equal(getattr(th, name).numpy()[act],
                                      np.asarray(getattr(jh, name))[act])
    tpos, tnrm, tmat_ = tscene.hit_surface(tdev, th, torch.from_numpy(o),
                                           torch.from_numpy(d))
    np.testing.assert_array_equal(tpos.numpy()[act], np.asarray(jpos)[act])
    hit_lanes = act & (np.asarray(jh.obj) >= 0)
    assert tnrm.numpy()[hit_lanes].tobytes() == \
        np.asarray(jnrm)[hit_lanes].tobytes()
    np.testing.assert_array_equal(tmat_.numpy()[hit_lanes],
                                  np.asarray(jmat_)[hit_lanes])


def _cols(o, d):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                 for a in (o, d) for k in range(3))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_kernel_body_host_build_vs_plain(queries, any_hit):
    """Extra check: the CUDA kernel's traversal (csrc/pt_device.cuh
    traverse_lane) built with g++ against the plain version: closest hits
    bitwise on every lane (dead lanes: t_init, ids -1, zero normal); any
    hits in existence, on a real record of the scene closer than t_init."""
    _, tdev, o, d, t0, act = queries
    rays = _cols(o, d)
    t_init, active = torch.from_numpy(t0), torch.from_numpy(act)
    ref = tps.traverse_packet_slim(rays[:3], rays[3:], t_init, tdev.pnodes,
                                   tdev.pltris, tdev.proots, active=active,
                                   any_hit=any_hit)
    host = tps.traverse_packet_slim_host(
        rays[:3], rays[3:], t_init, tdev.pnodes, tdev.pltris, tdev.proots,
        active=active, any_hit=any_hit)
    dead = ~active
    assert torch.equal(host[0][dead], t_init[dead])
    assert (host[1][dead] == -1).all() and (host[2][dead] == -1).all()
    if not any_hit:
        for a, b in zip(ref[:3] + ref[3], host[:3] + host[3]):
            assert a.numpy().tobytes() == b.numpy().tobytes()
        return
    assert torch.equal(host[1] >= 0, ref[1] >= 0)
    found = host[1] >= 0
    assert found.any() and (host[0][found] < t_init[found]).all()
    rec = ptf.leaf_records(tdev.pltris)
    ids = rec["id"].long()
    at = torch.searchsorted(ids, host[1][found].long())
    assert torch.equal(rec["obj"][at], host[2][found])


def test_wrapper_refusals(queries):
    """The JAX function's checks of the leaf-14 payload (pay without occl,
    or with 2-row leaves, or on the instance arm) raise as there; fused
    and 16-wide layouts are ported, and a table of the wrong width for them
    raises as in the JAX wrapper; the BVH depth count does not: it is
    the JAX function's default, in the wrapper and in intersect_scene
    (bvh_depth, JAX's 5th output and Hit field).  The instance arm takes
    both of its tables, of the kernel's types."""
    _, tdev, o, d, t0, act = queries
    rays = _cols(o, d)
    args = (rays[:3], rays[3:], torch.from_numpy(t0), tdev.pnodes,
            tdev.pltris, tdev.proots)
    pay = torch.zeros(1, 128)
    with pytest.raises(ValueError, match="rides the leaf-14 occl tables"):
        tps.traverse_packet_slim(*args, pay=pay)
    with pytest.raises(ValueError, match="no payload rows"):
        tps.traverse_packet_slim(*args, occl=True, pay=pay, occl_rows=2)
    with pytest.raises(ValueError, match="non-instanced split-table"):
        tps.traverse_packet_slim(*args, occl=True, pay=pay,
                                 inst_inv=torch.zeros(1, 12),
                                 inst_root=torch.zeros(1, dtype=torch.int32))
    for kw in (dict(fused_nn=3), dict(width=16)):
        with pytest.raises(ValueError, match="expects 128 cols"):
            tps.traverse_packet_slim(*args, **kw)
    for kw, item in ((dict(inst_inv=torch.zeros(1, 12)), "inst_root"),
                     (dict(inst_inv=torch.zeros(1, 12),
                           inst_root=torch.zeros(1)), "inst_root")):
        with pytest.raises(ValueError, match=item):
            tps.traverse_packet_slim(*args, **kw)
    counted = tps.traverse_packet_slim(*args)
    bare = tps.traverse_packet_slim(*args, count_depth=False)
    assert len(counted) == len(bare) == 5
    assert not bare[4].any() and (counted[4][counted[1] >= 0] >= 1).all()
    h = tscene.intersect_scene(tdev, torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(t0),
                               active=torch.from_numpy(act))
    assert tscene.Hit._fields.index("bvh_depth") == 4
    mesh = torch.from_numpy(act) & (h.obj >= 0) & (h.kind == tscene.PRIM_MESH)
    assert mesh.any() and (h.bvh_depth[mesh] >= 1).all()
    assert (h.bvh_depth >= 0).all()


def test_batched_analytic_form_vs_jax(rng_np):
    """Over ANALYTIC_UNROLL_MAX spheres and planes the JAX package's
    analytic tests take their batched first-min form; the port's
    per-object loop (its only form) gives the same hits bitwise (op by
    op JAX)."""
    def scene(S, mat):
        s = S.Scene()
        white = s.add_material(mat.Material.diffuse((0.8, 0.8, 0.8)))
        for k in range(18):
            s.add_sphere(f"s{k}", (k % 6 - 2.5, k // 6 - 1.0, -3.0 - k % 4),
                         0.3 + 0.05 * (k % 3), white)
            s.add_plane(f"p{k}", (0.0, -2.0 - 0.1 * k, 0.0),
                        (0.0, 1.0, 0.01 * k), white)
        return s

    jdev = scene(jscene, jmat).device()
    tdev = scene(tscene, tmat).build_device("cpu")
    n = 512
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 4.0
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d[:4] = 0.0  # degenerate directions
    t0 = np.full(n, 1e34, np.float32)
    with jax.disable_jit():
        jh = jscene.intersect_scene(jdev, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t0), count_depth=False)
    looped = tscene.intersect_scene(tdev, torch.from_numpy(o),
                                    torch.from_numpy(d), torch.from_numpy(t0))
    assert tdev.num_sph > tscene.ANALYTIC_UNROLL_MAX
    assert (np.asarray(jh.kind) == jscene.PRIM_SPHERE).any()
    assert (np.asarray(jh.kind) == jscene.PRIM_PLANE).any()
    for name in ("t", "obj", "kind", "prim"):
        ref = np.asarray(getattr(jh, name))
        np.testing.assert_array_equal(getattr(looped, name).numpy(), ref)
