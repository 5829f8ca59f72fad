"""TLAS instancing in the port (cpugpupathtracing_tpu_torch): the
instanced scene build, its refit, the instance arm of intersect_scene /
hit_surface, the instance arms of traverse_packet_slim, shade_extend and
shadow_resolve (plain versions and the g++ build of the kernel bodies),
and the object-space per-depth route, against the JAX package on the same
seeded inputs.

Scenes: tests/test_golden.py's `_instanced_scene` (3 icospheres, a floor
plane, a sphere light), tests/test_packet_instances.py's (3 icospheres
and a floor quad) and tests/test_flatten.py's (3 anisotropically scaled
icospheres), all under the benchmark's tree flags
(CPUGPU_PACKET_TREE=sweep_dp, CPUGPU_OCCL=1, CPUGPU_SMEMTREE=48,
CPUGPU_FRAMESTACK=1, patched on the JAX modules).

Tolerances, per test:
  * scene tables: bitwise against JAX Scene.device() built op by op
    (jax.disable_jit(): under jit XLA's CPU compiler contracts the
    flatten arithmetic's multiply-adds into FMAs); a refit bitwise
    against a fresh build;
  * hits against JAX's wide traversal (the object-space TLAS path of its
    XLA integrator, which orders the transform arithmetic differently):
    at most 8 of the lanes differ in the hit triangle, t within 1e-5
    (absolute and relative) elsewhere (tests/test_packet_instances.py);
  * against one interpret-mode run of the JAX Pallas kernel: the same
    bound (its walk keeps the first of two hits at exactly the same t);
  * plain version against the g++ build of the kernel bodies: hits
    bitwise; shade_extend flags and RNG state bitwise (the host build's
    glibc sin/cos/exp differ from torch's by ULPs);
  * rendering: the per-depth route on the object-space machinery against
    the flattened route under the megakernel contract, against JAX
    trace_advanced within 2e-4 (tests/test_packet_instances.py), and the
    `instanced_flattened` golden within tests/test_torch_renderer.py's
    image tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.models import integrators as jint
from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu.ops import traverse_packet_slim as jtps
from cpugpupathtracing_tpu.utils import rng as jrng
from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import camera as tcam
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.models.renderer import Renderer
from cpugpupathtracing_tpu_torch.ops import megakernel as tmk
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from cpugpupathtracing_tpu_torch.utils import rng as trng

from tests.test_torch_renderer import EQUAL_SHARE_MIN, GOLDENS, MAX_MAX, \
    MEAN_MAX
from tests.test_torch_scene import jax_tables, patch_bench_flags

# the JAX package's bound for two instance traversals (hit triangle may
# differ on this many lanes; t within T_TOL absolute and relative)
PRIM_DIFF_MAX, T_TOL = 8, 1e-5


def contract(ref, got):
    """The megakernel contract (tests/test_megakernel.py's _check) on
    (N, 3) energies: < 3% of lanes beyond 3e-6 + 3e-5 |e|, every
    difference < 0.02, means within 1e-4."""
    diff = (ref - got).abs()
    flips = (diff > 3e-6 + 3e-5 * ref.abs()).any(dim=1).float().mean()
    assert float(flips) < 0.03
    assert float(diff.max()) < 0.02
    assert abs(float(ref.mean()) - float(got.mean())) < 1e-4


def golden_instanced(S, mat, mesh, tf=None):
    """tests/test_golden.py's _instanced_scene, with either package."""
    s = S.Scene()
    white = s.add_material(mat.Material.diffuse((0.9, 0.9, 0.9)))
    glass = s.add_material(mat.Material.dielectric(
        (1.0, 1.0, 1.0), 0.0, 1.0, (0.2, 0.8, 0.8), 1.517))
    light = s.add_material(mat.Material.light((1.0, 0.95, 0.8), 10.0))
    if tf is None:
        tf = np.zeros((3, 4, 4), np.float32)
        for i in range(3):
            ang = 2.1 * i
            c, sn = np.cos(ang), np.sin(ang)
            sc = 0.8 + 0.2 * i
            tf[i] = [[c * sc, 0, sn * sc, -2.5 + 2.5 * i], [0, sc, 0, 0.0],
                     [-sn * sc, 0, c * sc, 0.0], [0, 0, 0, 1]]
    s.add_instanced_mesh("icos", mesh.icosphere(radius=1.0, subdivisions=2),
                         glass, tf)
    s.add_plane("floor", (0.0, -2.0, 0.0), (0.0, 1.0, 0.0), white)
    li = s.add_sphere("light", (8.0, 9.0, 7.0), 4.0, light)
    s.mark_light(li)
    return s


def _packet_tf():
    out = np.zeros((3, 4, 4), np.float32)
    for i in range(3):
        ang = 2.1 * i + 0.4
        c, s = np.cos(ang), np.sin(ang)
        sc = 0.6 + 0.2 * i
        out[i] = [[c * sc, 0, s * sc, 2.2 * (i - 1)], [0, sc, 0, 0.3 * i],
                  [-s * sc, 0, c * sc, 0.5], [0, 0, 0, 1]]
    return out


def packet_instanced(S, mat, mesh, light=False):
    """tests/test_packet_instances.py's _instanced_scene (with the light
    of its render test)."""
    s = S.Scene()
    white = s.add_material(mat.Material.diffuse((0.8, 0.8, 0.8)))
    s.add_instanced_mesh("balls", mesh.icosphere(subdivisions=2), white,
                         _packet_tf())
    s.add_mesh("floor", mesh.ground_quad(half_extent=20.0, y=-2.0), white)
    if light:
        li = s.add_sphere("light", (6.0, 8.0, 6.0), 2.0, s.add_material(
            mat.Material.light((1.0, 1.0, 1.0), 20.0)))
        s.mark_light(li)
    return s


def _flatten_tf(tx=0.0, scale=1.0, yaw=0.0, ty=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c * scale, 0, s * scale, tx],
                     [0, scale * 1.2, 0, ty],
                     [-s * scale, 0, c * scale, 0], [0, 0, 0, 1]], np.float32)


FLATTEN_TF = [_flatten_tf(), _flatten_tf(3.0, 0.5, 0.7),
              _flatten_tf(-3.0, 1.5, -1.2, 1.0)]


def flatten_scene(S, mat, mesh, transforms=FLATTEN_TF):
    """tests/test_flatten.py's _scene."""
    s = S.Scene()
    grey = s.add_material(mat.Material.diffuse((0.5, 0.5, 0.5)))
    s.add_instanced_mesh("b", mesh.icosphere(subdivisions=2), grey,
                         transforms)
    return s


SCENES = {"golden": golden_instanced, "packet": packet_instanced,
          "flatten": flatten_scene}


@pytest.fixture(scope="module")
def jax_builds():
    """JAX Scene.device() of every scene, flattened and object-space,
    built op by op under the benchmark's tree flags."""
    mp = pytest.MonkeyPatch()
    patch_bench_flags(mp)
    out = {}
    try:
        for name, make in SCENES.items():
            for flat in (True, False):
                if flat:
                    mp.delenv("CPUGPU_NO_FLATTEN", raising=False)
                else:
                    mp.setenv("CPUGPU_NO_FLATTEN", "1")
                with jax.disable_jit():
                    out[name, flat] = make(jscene, jmat, jmesh).device()
    finally:
        mp.undo()
    return out


def _port(make, flat, monkeypatch, **kw):
    if flat:
        monkeypatch.delenv("CPUGPU_NO_FLATTEN", raising=False)
    else:
        monkeypatch.setenv("CPUGPU_NO_FLATTEN", "1")
    return make(tscene, tmat, tmesh, **kw).build_device("cpu")


def _bits(t):
    return t.numpy().tobytes()


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "objspace"])
@pytest.mark.parametrize("name", list(SCENES))
def test_instanced_build_bitwise(jax_builds, monkeypatch, name, flat):
    """Every table (the world-space copies, TLAS rows, occlusion rows
    repacked from the shading records, inst_*, world bounds) and the
    metadata of the port's build equal JAX's bitwise; scene_from_numpy
    carries the JAX snapshot's instance state across."""
    jdev = jax_builds[name, flat]
    tdev = _port(SCENES[name], flat, monkeypatch)
    arrays, meta = jax_tables(jdev)
    assert tdev.packet_flattened == flat == jdev.packet_flattened
    assert tdev.machinery == (not flat)
    for field, dtype in tscene.TABLE_FIELDS + tscene.VARIANT_FIELDS:
        ref = arrays[field]
        got = getattr(tdev, field)
        if ref is None:  # the object-space machinery builds no any-hit
            # tree; no scene here builds a variant table it does not need
            assert got is None or (not flat and got.numel() == 0), field
            continue
        assert got.dtype == dtype and tuple(got.shape) == ref.shape, field
        assert _bits(got) == ref.tobytes(), field
    for field in tscene.META_FIELDS:
        assert getattr(tdev, field) == meta[field], field
    back = tscene.scene_from_numpy(arrays, meta, "cpu")
    for field, _ in tscene.TABLE_FIELDS:
        assert _bits(getattr(back, field)) == _bits(getattr(tdev, field))
    assert back.num_instances == 3 and back.machinery == (not flat)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "objspace"])
def test_refit_equals_fresh_build(monkeypatch, flat):
    """A transform edit refits the snapshot in place; its tables then
    equal a fresh build at the same transforms bitwise
    (tests/test_flatten.py:121-133).  A refit that would change the
    TLAS topology raises."""
    target = _flatten_tf(3.0, 0.5, 0.7)
    s = flatten_scene(tscene, tmat, tmesh, [_flatten_tf(), _flatten_tf(1.0)])
    monkeypatch.setenv("CPUGPU_NO_FLATTEN", "0" if flat else "1")
    dev = s.device("cpu")
    s.set_instance_transform(0, 1, target)
    assert s.device("cpu") is dev  # refit, not rebuilt
    fresh = flatten_scene(tscene, tmat, tmesh,
                          [_flatten_tf(), target]).build_device("cpu")
    assert fresh.packet_flattened == flat
    for field, _ in tscene.TABLE_FIELDS:
        assert _bits(getattr(dev, field)) == _bits(getattr(fresh, field)), \
            field
    s.objects[0].instances = np.concatenate(
        [s.objects[0].instances] * 5)  # 10 instances: another TLAS shape
    s.set_instance_transform(0, 0, target)
    with pytest.raises(RuntimeError, match="topology"):
        s.device("cpu")


def test_budget_fallback_keeps_machinery(monkeypatch):
    """Over CPUGPU_FLATTEN_BUDGET_MB the object-space machinery runs
    (tests/test_flatten.py:166), and it resolves instance ids; the
    gates send it to the per-depth route."""
    monkeypatch.setenv("CPUGPU_FLATTEN_BUDGET_MB", "0.01")
    dev = flatten_scene(tscene, tmat, tmesh).build_device("cpu")
    assert not dev.packet_flattened and dev.machinery
    o = torch.tensor([[3.0, 0.0, 8.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    h = tscene.intersect_scene(dev, o, d, torch.full((1,), 1e34))
    assert int(h.obj[0]) >= 0 and int(h.inst[0]) == 1
    adv = RenderSettings()
    assert "machinery" in tscene.pt_frame_gate_reason(dev, adv)
    assert tscene.megakernel_gate_reason(dev, adv) is None
    whit = RenderSettings(render_mode=RenderMode.WHITTED)
    monkeypatch.setenv("CPUGPU_FORCE_WHITTED_KERNEL", "1")
    assert not tscene.whitted_kernel_active(dev, whit)


def _rays(n, seed, spread=6.0):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    aim = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def test_flattened_normals_are_world(monkeypatch):
    """A flattened scene's hits carry no instance and unit world normals
    (tests/test_flatten.py:180), equal to the object-space scene's
    normalize(inst_nrm @ n) within 1e-6 where both hit the same
    triangle."""
    o, d = _rays(256, 3)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t0 = torch.full((256,), 1e34)
    out = {}
    for flat in (True, False):
        dev = _port(flatten_scene, flat, monkeypatch)
        h = tscene.intersect_scene(dev, o, d, t0)
        out[flat] = (h, tscene.hit_surface(dev, h, o, d)[1])
    (hf, nf), (ho, no) = out[True], out[False]
    m = hf.obj >= 0
    assert int(m.sum()) > 50 and bool((hf.inst == -1).all())
    assert float((nf[m].norm(dim=1) - 1).abs().max()) < 1e-4
    same = m & (hf.prim == ho.prim)
    assert int(same.sum()) >= int(m.sum()) - PRIM_DIFF_MAX
    assert bool((ho.inst[same] >= 0).all())
    assert float((nf[same] - no[same]).abs().max()) < 1e-6


@pytest.fixture(scope="module")
def packet_queries():
    """tests/test_packet_instances.py's scene on the object-space
    machinery in both packages (the port's from its own build), and JAX's
    hits of 2048 random rays on its wide traversal (any hit too)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jscene, "PACKET_TREE", "sweep_dp")
    mp.setattr(jscene, "PACKET_OCCL", True)
    mp.setenv("CPUGPU_NO_FLATTEN", "1")
    try:
        js = packet_instanced(jscene, jmat, jmesh)
        js.traversal = "wide"
        jdev = js.device()
        tdev = packet_instanced(tscene, tmat, tmesh).build_device("cpu")
    finally:
        mp.undo()
    n = 2048
    o, d = _rays(n, 11, spread=4.0)
    o[:, 2] += 6.0
    o[:64, 1] = 0.3  # some rays along an axis
    d[:64] = [0.0, 0.0, -1.0]
    t0 = np.full(n, 1e34, np.float32)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jh = jscene.intersect_scene(jdev, jo, jd, jnp.asarray(t0))
    jpos, jnrm, jmat_ = jscene.hit_surface(jdev, jh, jo, jd)
    jany = jscene.intersect_scene(jdev, jo, jd, jnp.asarray(t0),
                                  any_hit=True)
    ref = {k: np.asarray(v) for k, v in dict(
        t=jh.t, prim=jh.prim, obj=jh.obj, inst=jh.inst, normal=jnrm,
        mat=jmat_, any=jany.obj).items()}
    return jdev, tdev, o, d, t0, ref


def test_intersect_scene_objspace_vs_jax(packet_queries):
    """intersect_scene / hit_surface on the object-space machinery
    (traverse_packet_slim's instance arm) against JAX intersect_scene /
    hit_surface on its wide path."""
    _, tdev, o, d, t0, ref = packet_queries
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    h = tscene.intersect_scene(tdev, ot, dt, torch.from_numpy(t0))
    _, nrm, mat = tscene.hit_surface(tdev, h, ot, dt)
    same = h.prim.numpy() == ref["prim"]
    assert int((~same).sum()) <= PRIM_DIFF_MAX
    assert int((ref["inst"] >= 0).sum()) > 50
    for name, got in (("obj", h.obj), ("inst", h.inst), ("mat", mat)):
        np.testing.assert_array_equal(got.numpy()[same], ref[name][same],
                                      err_msg=name)
    np.testing.assert_allclose(h.t.numpy()[same], ref["t"][same],
                               rtol=T_TOL, atol=T_TOL)
    hit = same & (ref["obj"] >= 0)
    np.testing.assert_allclose(nrm.numpy()[hit], ref["normal"][hit],
                               rtol=0, atol=1e-5)
    a = tscene.intersect_scene(tdev, ot, dt, torch.from_numpy(t0),
                               any_hit=True)
    assert int(((a.obj.numpy() >= 0) != (ref["any"] >= 0)).sum()) <= \
        PRIM_DIFF_MAX


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_instance_arm_host_build_vs_plain(packet_queries, any_hit):
    """The g++ build of the kernel's instance walk (traverse_lane<true>)
    against the plain version, bitwise (any hits: existence), with a
    finite t_init and inactive lanes on some."""
    _, tdev, o, d, t0, _ = packet_queries
    n = o.shape[0]
    rng = np.random.default_rng(7)
    t_init = torch.from_numpy(np.where(rng.uniform(size=n) < 0.5, 1e34,
                                       rng.uniform(2, 12, n)).astype(
                                           np.float32))
    act = torch.from_numpy(rng.uniform(size=n) < 0.8)
    args = ((torch.from_numpy(o), torch.from_numpy(d), t_init, tdev.pnodes,
             tdev.pltris, tdev.proots))
    kw = dict(active=act, any_hit=any_hit, count_depth=False,
              **tdev.inst_kwargs(nrm=False))
    ref = tps.traverse_packet_slim(*args, **kw)
    host = tps.traverse_packet_slim_host(*args, **kw)
    assert len(ref) == len(host) == 6
    if any_hit:
        assert torch.equal(ref[1] >= 0, host[1] >= 0)
        return
    for a_, b_ in zip((ref[0], ref[1], ref[2], *ref[3], ref[5]),
                      (host[0], host[1], host[2], *host[3], host[5])):
        assert torch.equal(a_.view(torch.int32) if a_.is_floating_point()
                           else a_, b_.view(torch.int32)
                           if b_.is_floating_point() else b_)
    assert int((host[5] >= 0).sum()) > 40


def test_instance_arm_vs_jax_kernel(packet_queries):
    """The plain version of traverse_packet_slim's instance arm against
    one interpret-mode run of the JAX Pallas kernel with inst_inv /
    inst_root, on 1024 lanes of the JAX snapshot's tables
    (scene_from_numpy)."""
    jdev, _, o, d, t0, _ = packet_queries
    n = 1024
    jm = jdev
    tdev = tscene.scene_from_numpy(*jax_tables(jm), "cpu")
    assert tdev.machinery
    jo = tuple(jnp.asarray(o[:n, k]) for k in range(3))
    jd = tuple(jnp.asarray(d[:n, k]) for k in range(3))
    t, tri, obj, nrm, _, iid = jtps.traverse_packet_slim(
        jo, jd, jnp.asarray(t0[:n]), jm.pnodes, jm.pltris, jm.proots,
        interpret=True, inst_inv=jm.inst_inv,
        inst_root=jm.inst_blas_root_packet)
    rays = tuple(torch.from_numpy(np.ascontiguousarray(o[:n, k]))
                 for k in range(3)) + tuple(
        torch.from_numpy(np.ascontiguousarray(d[:n, k])) for k in range(3))
    got = tps.traverse_packet_slim(rays[:3], rays[3:],
                                   torch.from_numpy(t0[:n]), tdev.pnodes,
                                   tdev.pltris, tdev.proots,
                                   count_depth=False,
                                   **tdev.inst_kwargs(nrm=False))
    same = got[1].numpy() == np.asarray(tri)
    assert int((~same).sum()) <= PRIM_DIFF_MAX
    assert int((got[5].numpy() >= 0).sum()) > 50
    np.testing.assert_array_equal(got[5].numpy()[same], np.asarray(iid)[same])
    np.testing.assert_array_equal(got[2].numpy()[same], np.asarray(obj)[same])
    np.testing.assert_allclose(got[0].numpy()[same], np.asarray(t)[same],
                               rtol=T_TOL, atol=T_TOL)
    for k in range(3):
        np.testing.assert_allclose(got[3][k].numpy()[same],
                                   np.asarray(nrm[k])[same], atol=1e-6)


@pytest.fixture(scope="module")
def render_inputs():
    """The lit packet scene, both representations, and 1024 camera rays
    (tests/test_packet_instances.py:105-131)."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for flat in (True, False):
            if flat:
                mp.delenv("CPUGPU_NO_FLATTEN", raising=False)
            else:
                mp.setenv("CPUGPU_NO_FLATTEN", "1")
            out[flat] = packet_instanced(tscene, tmat, tmesh,
                                         light=True).build_device("cpu")
    finally:
        mp.undo()
    cam = tcam.to_arrays(CameraConfig(pos=(0.0, 0.5, 7.0)), "cpu")
    n = 1024
    lane = torch.arange(n)
    o, d, _ = tcam.blocked_lane_rays(cam, lane, 128, n // 128, 8, 128)
    state = trng.seed_lanes(lane, 0, salt=5)
    return out, o, d, state


def test_mega_objspace_vs_flattened(render_inputs):
    """trace_advanced_mega on the object-space machinery (the instance
    arms of shade_extend and shadow_resolve, shadow rays on the shading
    tables) against the flattened route (the plain arms over world-space
    copies): traced equal, energy under the megakernel contract."""
    devs, o, d, state = render_inputs
    settings = RenderSettings(max_ray_depth=3)
    lane = torch.arange(o.shape[0], dtype=torch.int32)
    before = dict(ptf.launches)
    res = {flat: tint.trace_advanced_mega(dev, settings, o, d, state.clone(),
                                          idx=lane)
           for flat, dev in devs.items()}
    assert ptf.launches == before  # CPU tensors: the plain versions
    assert int(res[True][1].traced_rays) == int(res[False][1].traced_rays)
    contract(res[True][1].energy, res[False][1].energy)
    assert torch.equal(res[True][0], res[False][0])


def test_mega_objspace_vs_jax_trace_advanced(render_inputs):
    """trace_advanced_mega on the object-space machinery against the JAX
    package's trace_advanced (its XLA integrator over the wide instance
    traversal) on the same rays and seeds: traced equal, energy within
    2e-4 (tests/test_packet_instances.py:105-131)."""
    devs, o, d, state = render_inputs
    mp = pytest.MonkeyPatch()
    mp.setattr(jscene, "PACKET_TREE", "sweep_dp")
    mp.setattr(jscene, "PACKET_OCCL", True)
    try:
        js = packet_instanced(jscene, jmat, jmesh, light=True)
        js.traversal = "wide"
        jdev = js.device()
    finally:
        mp.undo()
    n = o.shape[0]
    jstate = jrng.seed_lanes(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0),
                             salt=5)
    assert np.array_equal(np.asarray(jstate).astype(np.int64), state.numpy())
    settings = RenderSettings(max_ray_depth=3)
    from cpugpupathtracing_tpu.config import RenderSettings as JSettings
    _, jres = jint.trace_advanced(
        jdev, JSettings(max_ray_depth=3), jnp.asarray(o.numpy()),
        jnp.asarray(d.numpy()), jstate, idx=jnp.arange(n, dtype=jnp.int32))
    _, res = tint.trace_advanced_mega(devs[False], settings, o, d,
                                      state.clone(),
                                      idx=torch.arange(n, dtype=torch.int32))
    assert int(res.traced_rays) == int(jres.traced_rays)
    np.testing.assert_allclose(res.energy.numpy(), np.asarray(jres.energy),
                               rtol=2e-4, atol=2e-4)


def test_instance_arms_host_build_vs_plain(render_inputs):
    """One depth of shade_extend and one shadow_resolve through the g++
    build of the kernels' instance arms against their plain versions:
    flags, RNG state and the occluded bit bitwise."""
    devs, o, d, state = render_inputs
    dev = devs[False]
    n = o.shape[0]
    rays = tuple(o[:, k].contiguous() for k in range(3)) + tuple(
        d[:, k].contiguous() for k in range(3))
    one, zero = torch.ones(n), torch.zeros(n)
    kw = dict(tint.extend_kwargs(dev, RenderSettings()), **dev.inst_kwargs())
    a = (*dev.tables(), 0, rays, state, (one, one, one), (zero, zero, zero),
         torch.ones(n, dtype=torch.int32))
    ref = tmk.shade_extend(*a, **kw)
    host = tmk.shade_extend_host(*a, **kw)
    assert torch.equal(ref[4], host[4]) and torch.equal(ref[1], host[1])
    assert int(((ref[4] >> 2) & 1).sum()) > 100
    nodes, ltris, skw = tint.shadow_tables(dev)
    sa = (nodes, ltris, dev.mk_sph, dev.mk_pln, ref[5], ref[6], ref[7],
          ref[4], (zero, zero, zero), tuple(torch.ones(n) for _ in range(3)))
    e_ref = tmk.shadow_resolve(*sa, **skw)
    e_host = tmk.shadow_resolve_host(*sa, **skw)
    for x, y in zip(e_ref, e_host):
        assert torch.equal(x, y)
    assert 0 < int((e_ref[0] == 0).sum()) < n  # some shadow rays occluded


def test_golden_instanced_flattened():
    """The `instanced_flattened` golden (tests/test_golden.py:106-117)
    through the port's Renderer on the CPU: the flattened scene's
    whole-frame route, within tests/test_torch_renderer.py's tolerance."""
    r = Renderer(golden_instanced(tscene, tmat, tmesh),
                 camera=CameraConfig(pos=(0.0, 0.5, 8.0)),
                 config=RenderConfig(width=96, height=54, seed=0x9E3779B9),
                 settings=RenderSettings(render_mode=RenderMode.ADVANCED),
                 device="cpu")
    assert r.scene.device("cpu").packet_flattened
    r.render(2)
    got = r.image_u32()
    ref = np.load(GOLDENS)["instanced_flattened"]
    assert got.shape == ref.shape and got.dtype == ref.dtype
    delta = np.abs(got.view(np.uint8).astype(np.int64)
                   - ref.view(np.uint8).astype(np.int64))
    assert (delta == 0).mean() >= EQUAL_SHARE_MIN, (delta == 0).mean()
    assert delta.mean() <= MEAN_MAX, delta.mean()
    assert delta.max() <= MAX_MAX, delta.max()


def test_instance_records_split_world_and_blas(packet_queries):
    """The plain instance arm's host walk: the floor's records stay in
    world space, every instance reaches the one BLAS through one TLAS
    box, and the BLAS's records are the icosphere's."""
    _, tdev, *_ = packet_queries
    rec = ptf.instance_records(tdev.pnodes, tdev.pltris, tdev.proots,
                               tdev.inst_blas_root_packet)
    assert rec["world"]["id"].numel() == 2  # the floor quad's triangles
    assert sorted(rec["boxes"]) == [0, 1, 2]
    assert all(len(b) == 1 for b in rec["boxes"].values())
    assert all(r["id"].numel() == 320 for r in rec["blas"])


def test_det_epsilon_splits_the_instance_routes(monkeypatch):
    """The triangle test's |det| >= 1e-3 is not invariant under an
    instance transform (ROADMAP.md C7): a small icosphere instance
    (scale 0.2) is hit in object space, where the determinant is the
    world one / 0.2^3, and missed by the same rays over its flattened
    world-space copy; every lane that differs is one whose object-space
    hit triangle has a world-space |det| below the epsilon."""
    tf = np.eye(4, dtype=np.float32)[None] * np.float32(1.0)
    tf[0, :3, :3] *= 0.2
    tf[0, 3, 3] = 1.0

    def scene(S, mat, mesh):
        s = S.Scene()
        grey = s.add_material(mat.Material.diffuse((0.5, 0.5, 0.5)))
        s.add_instanced_mesh("ico", mesh.icosphere(subdivisions=3), grey, tf)
        return s

    n = 512
    rng = np.random.default_rng(2)
    aim = rng.uniform(-0.15, 0.15, (n, 3)).astype(np.float32)
    o = np.tile(np.array([[0.0, 0.0, 3.0]], np.float32), (n, 1))
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))
    t0 = torch.full((n,), 1e34)
    hits = {}
    for flat in (True, False):
        dev = _port(scene, flat, monkeypatch)
        hits[flat] = tscene.intersect_scene(dev, ot, dt, t0)
    obj_space, flat_ = hits[False], hits[True]
    assert int((obj_space.obj >= 0).sum()) > 100
    differ = obj_space.prim != flat_.prim
    assert int(differ.sum()) > 20
    # the world-space determinant of each lost hit's triangle
    dev = _port(scene, False, monkeypatch)
    rec = ptf.leaf_records(dev.pltris)
    at = torch.searchsorted(rec["id"].long(), obj_space.prim[differ].long())
    A = torch.from_numpy(tf[0, :3, :3])
    e1, e2 = rec["e1"][at] @ A.T, rec["e2"][at] @ A.T
    det = (e1 * torch.linalg.cross(dt[differ], e2)).sum(dim=1)
    assert bool((det.abs() < 1e-3).all())
