"""The port's WHITTED render mode (cpugpupathtracing_tpu_torch
models/whitted.py, ops/whitted_kernel.py, the Whitted gate and route of
models/scene.py and models/renderer.py) against the JAX package, with
the scene tables handed over through scene_from_numpy.

Tolerances:
  * RNG state and traced counts: exact everywhere.
  * trace_whitted against JAX trace_whitted run op by op
    (jax.disable_jit()): energy bitwise too.  Against jitted JAX, whose
    CPU compiler contracts multiply-adds into FMAs, and between the
    whole-frame kernel and trace_whitted in the JAX package: the contract
    of tests/test_whitted_kernel.py (< 1% of lanes beyond
    3e-6 + 3e-5 |e|, every difference < 0.05: last-ULP energy plus the
    rare shadow ray grazing an occluder's silhouette).
  * The port's two routes (whitted_frame's plain version, trace_whitted)
    on the CPU: bitwise.
  * Frames against the `whitted` golden: the tolerance of
    tests/test_torch_renderer.py (>= 99.5% of 8-bit channels equal, mean
    |delta| <= 0.05, max |delta| <= 32).
The mesh scene's camera sits at y = 0.5: rays of the middle row of a
camera at y = 0 run exactly along edges of the icosphere, where the JAX
package's XLA traversal resolves exact ties in t in visit order, not as
the brute-force oracle does (ROADMAP.md C5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
from cpugpupathtracing_tpu.config import DebugRenderMode as JDebugRenderMode
from cpugpupathtracing_tpu.config import RenderMode as JRenderMode
from cpugpupathtracing_tpu.config import RenderSettings as JRenderSettings
from cpugpupathtracing_tpu.models import camera as jcam
from cpugpupathtracing_tpu.models import integrators as jint
from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu.models import whitted as jw
from cpugpupathtracing_tpu.ops import whitted_kernel as jwk
from cpugpupathtracing_tpu.utils import rng as jrng
from cpugpupathtracing_tpu_torch import benchscenes
from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    DebugRenderMode,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.models import renderer as trenderer
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.models import whitted as tw
from cpugpupathtracing_tpu_torch.ops import whitted_kernel as twk

from tests.test_torch_renderer import EQUAL_SHARE_MIN, MAX_MAX, MEAN_MAX
from tests.test_torch_scene import jax_tables, megakernel_scene

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "frames.npz")
DEPTH = 4  # config 1's max_ray_depth
MESH_DEPTH = 2  # the mesh scene's: op-by-op JAX traversal is slow
JSETTINGS = JRenderSettings(render_mode=JRenderMode.WHITTED,
                            max_ray_depth=DEPTH)
SETTINGS = RenderSettings(render_mode=RenderMode.WHITTED,
                          max_ray_depth=DEPTH)


def _rays(w, h, pos):
    """Row-major camera rays and seeds (tests/test_whitted_kernel.py's
    _trace) as numpy arrays."""
    cam = jcam.to_arrays(JCameraConfig(pos=pos, aspect=w / h))
    lane = jnp.arange(w * h, dtype=jnp.uint32)
    o, d = jcam.lane_rays(cam, lane, w, h)
    st = jrng.seed_lanes(lane, jnp.uint32(0), salt=0x1CE)
    return np.array(o), np.array(d), np.array(st)


def _contract(ref, got):
    """tests/test_whitted_kernel.py's energy contract."""
    diff = np.abs(ref - got)
    flips = (diff > 3e-6 + 3e-5 * np.abs(ref)).any(axis=1)
    assert flips.mean() < 0.01, f"{flips.sum()} lanes beyond boundary flips"
    assert diff.max() < 0.05, f"flip magnitude {diff.max():.4f}"


def _port(jdev):
    return tscene.scene_from_numpy(*jax_tables(jdev), "cpu")


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def config1():
    """Config 1's scene in both packages, 32x16 rays of config 1's
    camera, and JAX trace_whitted's result op by op and jitted (depth
    4).  Both scenes trace 512 lanes: op-by-op JAX compiles each
    primitive once per shape, so the second scene reuses the first's."""
    jdev = jw.make_whitted_scene().device()
    o, d, st = _rays(32, 16, (0.0, 0.5, 8.0))
    with jax.disable_jit():
        eager = jw.trace_whitted(jdev, JSETTINGS, o, d, st)
    jitted = jw.trace_whitted(jdev, JSETTINGS, o, d, st)
    return jdev, _port(jdev), (o, d, st), eager, jitted, DEPTH


@pytest.fixture(scope="module")
def mesh_scene():
    """tests/test_megakernel.py's scene (icosphere, floor quad, mirror
    sphere, back wall, two sphere lights) under the benchmark's tree
    flags, 32x16 rays, and JAX trace_whitted op by op and jitted (depth
    2)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jscene, "PACKET_TREE", "sweep_dp")
    mp.setattr(jscene, "PACKET_OCCL", True)
    try:
        jdev = megakernel_scene(jscene, jmat, jmesh).device()
    finally:
        mp.undo()
    o, d, st = _rays(32, 16, (0.0, 0.5, 6.0))
    js = JSETTINGS.replace(max_ray_depth=MESH_DEPTH)
    with jax.disable_jit():
        eager = jw.trace_whitted(jdev, js, o, d, st)
    jitted = jw.trace_whitted(jdev, js, o, d, st)
    return jdev, _port(jdev), (o, d, st), eager, jitted, MESH_DEPTH


def _trace_port(tdev, rays, depth, sort, monkeypatch):
    o, d, st = rays
    idx = torch.arange(o.shape[0]) if sort else None
    if sort:  # sort on the CPU as on the card
        monkeypatch.setattr(tw, "packet_path_active",
                            lambda dev: bool(dev.proots))
    return tw.trace_whitted(
        tdev, SETTINGS.replace(max_ray_depth=depth), _t(o), _t(d),
        _t(st, torch.int64), idx=idx)


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("case", ["config1", "mesh_scene"])
def test_trace_whitted_vs_jax(case, sort, request, monkeypatch):
    """trace_whitted against JAX trace_whitted: state and traced exact,
    energy bitwise against op-by-op JAX and within the contract against
    jitted JAX; with lane identities the port sorts (morton5 after every
    depth on the mesh scene) and the result is the same."""
    jdev, tdev, rays, eager, jitted, depth = request.getfixturevalue(case)
    before = tint.sorts
    state, res = _trace_port(tdev, rays, depth, sort, monkeypatch)
    sorted_depths = tint.sorts - before
    assert sorted_depths == (depth + 1 if sort and case == "mesh_scene"
                             else 0)
    for js, jr in (eager, jitted):
        assert int(res.traced_rays) == int(jr.traced_rays)
        np.testing.assert_array_equal(state.numpy(),
                                      np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(res.energy.numpy(),
                                  np.asarray(eager[1].energy))
    _contract(np.asarray(jitted[1].energy), res.energy.numpy())
    assert float(res.energy.sum()) > 0.0


def test_whitted_frame_plain_vs_jax_kernel(config1):
    """whitted_frame's plain version against one interpret-mode run of
    the JAX Pallas kernel (512 lanes: one grid step): state and traced
    exact, energy under the contract; and bitwise equal to the port's
    trace_whitted."""
    jdev, tdev, (o, d, st), eager, *_ = config1
    cols = tuple(np.ascontiguousarray(o[:, k]) for k in range(3)) + tuple(
        np.ascontiguousarray(d[:, k]) for k in range(3))
    kw = dict(num_mats=tdev.num_mats, num_lights=tdev.num_lights,
              num_sph=tdev.num_sph, num_pln=tdev.num_pln, depths=DEPTH + 1)
    r_en, r_st, r_tr = jwk.whitted_frame(
        jdev.mk_mats, jdev.mk_lights, jdev.mk_sph, jdev.mk_pln,
        jdev.mk_sph_mat, jdev.mk_pln_mat, jdev.mk_objmat, cols, st,
        interpret=True, **kw)
    g_en, g_st, g_tr = twk.whitted_frame(
        tdev.mk_mats, tdev.mk_lights, tdev.mk_sph, tdev.mk_pln,
        tdev.mk_sph_mat, tdev.mk_pln_mat, tdev.mk_objmat,
        tuple(_t(c) for c in cols), _t(st, torch.int64), **kw)
    assert int(g_tr) == int(r_tr) == int(eager[1].traced_rays)
    np.testing.assert_array_equal(g_st.numpy(),
                                  np.asarray(r_st).astype(np.int64))
    _contract(np.asarray(r_en), g_en.numpy())
    np.testing.assert_array_equal(g_en.numpy(), np.asarray(eager[1].energy))


def test_kernel_body_host_build(config1):
    """Extra check: the CUDA kernel's per-lane body (csrc/whitted.cuh)
    built with g++ against the plain version on config 1's rays: state
    and traced exact, energy within 1e-6 relative (glibc's expf and
    torch's exp differ by an ULP on a few lanes leaving the glass
    sphere; on the card kernel and plain version agree bitwise)."""
    _, tdev, (o, d, st), *_ = config1
    rays = tuple(_t(np.ascontiguousarray(o[:, k])) for k in range(3)) + \
        tuple(_t(np.ascontiguousarray(d[:, k])) for k in range(3))
    args = (tdev.mk_mats, tdev.mk_lights, tdev.mk_sph, tdev.mk_pln,
            tdev.mk_sph_mat, tdev.mk_pln_mat, tdev.mk_objmat, rays,
            _t(st, torch.int64))
    kw = dict(num_lights=tdev.num_lights, num_sph=tdev.num_sph,
              num_pln=tdev.num_pln, depths=DEPTH + 1)
    host = twk.whitted_frame_host(*args, **kw)
    plain = twk.whitted_frame_reference(*args, **kw)
    assert torch.equal(host[1], plain[1]) and int(host[2]) == int(plain[2])
    torch.testing.assert_close(host[0], plain[0], rtol=1e-6, atol=0.0)


def test_routes_and_gate(config1, monkeypatch):
    """On config 1 trace_sample takes the whole-frame kernel when the gate
    allows (CPUGPU_FORCE_WHITTED_KERNEL=1 on the CPU), else
    trace_whitted; the two give bitwise the same result here."""
    _, tdev, (o, d, st), eager, *_ = config1
    calls = []
    for name in ("trace_whitted", "trace_whitted_kernel"):
        fn = getattr(tw, name)
        monkeypatch.setattr(tw, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    args = (tdev, SETTINGS, _t(o), _t(d), _t(st, torch.int64),
            torch.arange(o.shape[0]))
    s_trace, r_trace = trenderer.trace_sample(*args)
    monkeypatch.setenv("CPUGPU_FORCE_WHITTED_KERNEL", "1")
    s_kernel, r_kernel = trenderer.trace_sample(*args)
    assert calls == ["trace_whitted", "trace_whitted_kernel"]
    assert torch.equal(s_trace, s_kernel)
    assert torch.equal(r_trace.energy, r_kernel.energy)
    assert int(r_trace.traced_rays) == int(r_kernel.traced_rays) == \
        int(eager[1].traced_rays)


@pytest.mark.parametrize("force", ["", "force", "no-kernel"])
def test_whitted_gate_vs_jax(config1, mesh_scene, monkeypatch, force):
    """scene.whitted_kernel_active against the JAX gate on the same
    scenes and settings (the environment read at every call)."""
    if force == "force":
        monkeypatch.setenv("CPUGPU_FORCE_WHITTED_KERNEL", "1")
    elif force == "no-kernel":
        monkeypatch.setenv("CPUGPU_FORCE_WHITTED_KERNEL", "1")
        monkeypatch.setenv("CPUGPU_NO_WHITTED_KERNEL", "1")
    many = jw.make_whitted_scene()
    tmany = tw.make_whitted_scene()
    for k in range(12):  # 7 + 12 analytic objects: over the budget of 16
        many.add_sphere(f"s{k}", (k, 3.0, -4.0), 0.3, 0)
        tmany.add_sphere(f"s{k}", (k, 3.0, -4.0), 0.3, 0)
    scenes = [(config1[0], config1[1]), (mesh_scene[0], mesh_scene[1]),
              (many.device(), tmany.build_device("cpu"))]
    variants = [dict(), dict(max_ray_depth=33), dict(track_aovs=True)]
    seen = set()
    for jdev, tdev in scenes:
        for v in variants:
            js = JSETTINGS.replace(**v)
            ts = SETTINGS.replace(**v)
            want = jscene.whitted_kernel_active(jdev, js)
            assert tscene.whitted_kernel_active(tdev, ts) == want
            seen.add(want)
    assert seen == ({True, False} if force == "force" else {False})


def test_meshless_scene_build_and_refusals(config1):
    """Config 1 (no mesh) builds: the port's tables equal JAX
    Scene.device()'s bitwise (empty trees, no roots), scene_from_numpy
    carries the JAX scene across and round-trips the port's own, and the
    ADVANCED gates refuse the scene by reason."""
    jdev, tport, (o, d, st), *_ = config1
    tdev = tw.make_whitted_scene().build_device("cpu")
    assert tdev.proots == () and tdev.poccl_roots == ()
    assert tuple(tdev.pnodes.shape) == (0, 64)
    assert tuple(tdev.poccl_ltris.shape) == (0, 128)
    arrays, meta = jax_tables(jdev)
    assert arrays["poccl_nodes"] is None  # JAX builds no any-hit tree
    for name, dtype in tscene.TABLE_FIELDS:
        got = getattr(tdev, name)
        assert got.dtype == dtype, name
        assert got.numpy().tobytes() == getattr(tport, name).numpy().tobytes()
        if arrays[name] is not None:
            assert got.numpy().tobytes() == arrays[name].tobytes(), name
    for name in tscene.META_FIELDS:
        assert getattr(tdev, name) == meta[name], name
    back = tscene.scene_from_numpy(*tdev.to_numpy(), "cpu")
    for name, _ in tscene.TABLE_FIELDS:
        assert torch.equal(getattr(back, name), getattr(tdev, name)), name
    adv = RenderSettings(render_mode=RenderMode.ADVANCED)
    assert "no mesh" in tscene.megakernel_gate_reason(tdev, adv)
    assert "no mesh" in tscene.pt_frame_gate_reason(tdev, adv)
    # the kernel routes refuse it; trace_sample takes the XLA integrator
    _, res = trenderer.trace_sample(tdev, adv, _t(o), _t(d),
                                    _t(st, torch.int64), None)
    assert torch.isfinite(res.energy).all() and float(res.energy.sum()) > 0
    assert not res.bvh_depth.any()


def test_debug_views_and_aovs_raise(config1, mesh_scene):
    """The Whitted views and AOVs: config 1's RAY_DEPTH view against JAX
    trace_whitted op by op (energy, the heatmap, and ray_depth bitwise;
    state and traced exact); on the mesh scene AOVs leave the energy
    bitwise unchanged, ray_depth lies in [0, depth + 1], bvh_depth >= 1
    on every lane with a mesh hit, and the BVH_DEPTH view's green
    channel dominates."""
    jdev, tdev, (o, d, st), *_ = config1
    js = JSETTINGS.replace(debug_render_mode=JDebugRenderMode.RAY_DEPTH)
    with jax.disable_jit():
        j_st, j_res = jw.trace_whitted(jdev, js, o, d, st)
    s_t, res = tw.trace_whitted(
        tdev, SETTINGS.replace(debug_render_mode=DebugRenderMode.RAY_DEPTH),
        _t(o), _t(d), _t(st, torch.int64))
    np.testing.assert_array_equal(res.energy.numpy(), np.asarray(j_res.energy))
    np.testing.assert_array_equal(res.ray_depth.numpy(),
                                  np.asarray(j_res.ray_depth))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(j_st).astype(np.int64))
    assert int(res.traced_rays) == int(j_res.traced_rays)
    assert len(set(res.ray_depth.tolist())) > 2

    _, tdev, rays, _, _, depth = mesh_scene
    o, d, st = (_t(a) for a in rays)
    st = st.to(torch.int64)
    base = SETTINGS.replace(max_ray_depth=depth)
    _, plain = tw.trace_whitted(tdev, base, o, d, st)
    _, aov = tw.trace_whitted(tdev, base.replace(track_aovs=True), o, d, st)
    assert torch.equal(plain.energy, aov.energy)
    assert int(aov.ray_depth.min()) >= 0
    assert int(aov.ray_depth.max()) <= depth + 1
    h = tscene.intersect_scene(tdev, o, d, torch.full((o.shape[0],), 1e34),
                               count_depth=False)
    mesh = (h.obj >= 0) & (h.kind == tscene.PRIM_MESH)
    assert mesh.any() and (aov.bvh_depth[mesh] >= 1).all()
    _, view = tw.trace_whitted(
        tdev, base.replace(debug_render_mode=DebugRenderMode.BVH_DEPTH), o,
        d, st)
    assert torch.equal(view.bvh_depth, aov.bvh_depth)
    assert int(view.traced_rays) == o.shape[0]
    assert float(view.energy[:, 1].mean()) > float(view.energy[:, 0].mean())


def test_sort_wavefront_morton5_vs_jax(mesh_scene, rng_np):
    """sort_wavefront's morton5 mode on a Whitted carry (no is_specular)
    against the JAX package's AOV-free sort, bitwise."""
    jdev, tdev, *_ = mesh_scene
    n = 1024
    o = rng_np.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    tp = rng_np.uniform(size=(n, 3)).astype(np.float32)
    en = rng_np.uniform(size=(n, 3)).astype(np.float32)
    act = rng_np.integers(0, 2, n).astype(np.int32)
    st = rng_np.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lane = rng_np.permutation(n).astype(np.int32)
    jc = dict(throughput=jnp.asarray(tp), energy=jnp.asarray(en),
              active=jnp.asarray(act), ray_ox=o[:, 0], ray_oy=o[:, 1],
              ray_oz=o[:, 2], ray_dx=d[:, 0], ray_dy=d[:, 1],
              ray_dz=d[:, 2], state=jnp.asarray(st),
              traced=jnp.zeros((), jnp.int32), lane=jnp.asarray(lane))
    ref = jint.sort_wavefront(jdev, jc, jnp.arange(n, dtype=jnp.int32),
                              aovs=False)
    tc = dict(ray=tuple(_t(np.ascontiguousarray(a[:, k]))
                        for a in (o, d) for k in range(3)),
              state=_t(st.astype(np.int64)),
              tp=tuple(_t(np.ascontiguousarray(tp[:, k])) for k in range(3)),
              en=tuple(_t(np.ascontiguousarray(en[:, k])) for k in range(3)),
              active=_t(act), lane=_t(lane))
    got = tint.sort_wavefront(tdev, tc, "morton5")
    assert "spec" not in got
    for k, name in enumerate(("ray_ox", "ray_oy", "ray_oz", "ray_dx",
                              "ray_dy", "ray_dz")):
        np.testing.assert_array_equal(got["ray"][k].numpy(),
                                      np.asarray(ref[name]))
    np.testing.assert_array_equal(torch.stack(got["tp"], 1).numpy(),
                                  np.asarray(ref["throughput"]))
    np.testing.assert_array_equal(torch.stack(got["en"], 1).numpy(),
                                  np.asarray(ref["energy"]))
    np.testing.assert_array_equal(got["state"].numpy(),
                                  np.asarray(ref["state"]).astype(np.int64))
    np.testing.assert_array_equal(got["active"].numpy(),
                                  np.asarray(ref["active"]))
    np.testing.assert_array_equal(got["lane"].numpy(), np.asarray(ref["lane"]))
    back = tint.restore_lane_order(got["lane"], [torch.stack(got["en"], 1)])
    assert torch.equal(back[0][torch.from_numpy(lane).long()],
                       torch.from_numpy(en))


@pytest.mark.parametrize("route", ["kernel", "trace"])
def test_golden_whitted(route, monkeypatch):
    """Config 1 through Renderer on either route against the `whitted`
    golden (tests/test_golden.py: 96x54, camera (0, 0.5, 8), depth 4, two
    frames)."""
    monkeypatch.setenv("CPUGPU_FORCE_WHITTED_KERNEL",
                       "1" if route == "kernel" else "0")
    scene, _, settings, *_ = benchscenes.config1_whitted()
    launched = []
    fn = tw.trace_whitted_kernel if route == "kernel" else tw.trace_whitted
    monkeypatch.setattr(tw, fn.__name__, lambda *a, **k: (
        launched.append(1), fn(*a, **k))[1])
    r = trenderer.Renderer(scene, camera=CameraConfig(pos=(0.0, 0.5, 8.0)),
                           config=RenderConfig(width=96, height=54),
                           settings=settings, device="cpu")
    r.render(2)
    assert len(launched) == 2
    got = r.image_u32()
    ref = np.load(GOLDENS)["whitted"]
    assert got.shape == ref.shape and got.dtype == ref.dtype
    delta = np.abs(got.view(np.uint8).astype(np.int64)
                   - ref.view(np.uint8).astype(np.int64))
    assert (delta == 0).mean() >= EQUAL_SHARE_MIN, (delta == 0).mean()
    assert delta.mean() <= MEAN_MAX, delta.mean()
    assert delta.max() <= MAX_MAX, delta.max()
    assert r.num_accumulated == 2 and r.stats.traced_rays > 96 * 54
