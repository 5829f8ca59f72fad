"""The port's XLA integrator route (cpugpupathtracing_tpu_torch
models/integrators.trace_advanced, sample_light, the AOVs and debug
views, models/renderer.trace_sample's fallback and render_frame's debug
bypass) and traverse_packet_slim's count_depth arm, against the JAX
package on the CPU, with the scene tables handed over through
scene_from_numpy.  JAX on the CPU takes its XLA walk
(traverse_wide.traverse8), so no Pallas kernel runs here.

Tolerances:
  * trace_advanced against JAX trace_advanced run op by op
    (jax.disable_jit()), with the two packages sharing one
    implementation of the transcendentals (shared_transcendentals: the
    JAX functions' cos, sin, exp and rsqrt evaluated by torch): energy,
    RNG state, traced count and ray_depth bitwise.  torch's and XLA's f32
    sin / cos / exp / rsqrt differ in the last ULP on a few percent of
    arguments (neither is correctly rounded), so with XLA's own
    transcendentals the energy is held to the megakernel contract
    (tests/test_megakernel.py's _check) and everything else stays exact.
  * next_u32_range, the sampling functions and sample_light: bitwise
    (the last three with the shared transcendentals).
  * bvh_depth: bitwise between the plain version (the PyTorch walk) and
    the g++ build of the kernel body (csrc/pt_host_check.cc), plain and
    instance arm, closest and any hit; the walk's hit columns bitwise the
    brute-force plain version's (any hits: existence).  Against JAX only
    its own tests' sanity bounds (tests/test_packet.py:56-58,
    tests/test_reorder.py:70-72): every lane with a mesh hit has
    bvh_depth >= 1 and none is negative.  The kernel counts node rows at
    which a child passed the push test, JAX's XLA walk counts descents
    (ops/traverse_wide.py:308): different numbers of a visit-order
    dependent quantity (tests/test_packet.py:354-355).
  * frames through Renderer on the XLA route (CPUGPU_NO_MEGAKERNEL=1)
    against the `advanced` and `advanced_nonee_uniform` goldens: the
    tolerance of tests/test_torch_renderer.py.
The camera sits at (0.05, 0.5, 7): rays exactly in the icosphere's
planes of symmetry cross its edges at exact ties in t, which the JAX
package's XLA walk resolves in visit order and the port like the
brute-force oracle (ROADMAP.md C5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
from cpugpupathtracing_tpu.config import DebugRenderMode as JDebugRenderMode
from cpugpupathtracing_tpu.config import RenderSettings as JRenderSettings
from cpugpupathtracing_tpu.models import camera as jcam
from cpugpupathtracing_tpu.models import integrators as jint
from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.models import renderer as jrenderer
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu.ops import sampling as jsam
from cpugpupathtracing_tpu.utils import rng as jrng
from cpugpupathtracing_tpu.utils import vecmath as jvec
from cpugpupathtracing_tpu_torch import benchscenes
from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    DebugRenderMode,
    RenderConfig,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import camera as tcam
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import renderer as trenderer
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.ops import sampling as tsam
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from cpugpupathtracing_tpu_torch.utils import rng as trng
from cpugpupathtracing_tpu_torch.utils.vecmath import vec4_to_uint

from tests.test_megakernel import _check
from tests.test_torch_instances import packet_instanced
from tests.test_torch_renderer import (
    CASES as GOLDEN_CASES,
    EQUAL_SHARE_MIN,
    GOLDENS,
    MAX_MAX,
    MEAN_MAX,
)
from tests.test_torch_scene import golden_scene, jax_tables

W, H = 32, 16
N = W * H
DEPTH = 2
CAMERA = (0.05, 0.5, 7.0)
SALT = 0x1CE
# the cases of trace_advanced held against op-by-op JAX: scene, settings
CASES = {
    "nee_aovs": ("golden", dict(max_ray_depth=DEPTH, track_aovs=True)),
    "nonee_uniform": ("golden", dict(max_ray_depth=DEPTH,
                                     next_event_estimation=False,
                                     cosine_weighted_diffuse=False)),
    "meshlight": ("meshlight", dict(max_ray_depth=1)),
}
# the case held against JAX with its own transcendentals
OWN = dict(CASES["nee_aovs"][1], max_ray_depth=1)


def meshlight_scene(S, mat, mesh):
    """The golden scene with its sphere light replaced by an emissive
    icosphere of 80 triangles in its place: a mesh light over the
    64-row light table, so no kernel route takes the scene."""
    s = S.Scene()
    white = s.add_material(mat.Material.diffuse((0.9, 0.9, 0.9)))
    blue = s.add_material(mat.Material.diffuse((0.2, 0.2, 0.8)))
    light = s.add_material(mat.Material.light((1.0, 0.95, 0.8), 10.0))
    glass = s.add_material(mat.Material.dielectric(
        (1.0, 1.0, 1.0), 0.0, 1.0, (0.2, 0.8, 0.8), 1.517))
    s.add_mesh("ico", mesh.icosphere(radius=1.5, subdivisions=2), glass)
    s.add_mesh("cube", mesh.cube(center=(2.8, -0.5, -1.0), half=0.9), blue)
    s.add_plane("floor", (0.0, -2.0, 0.0), (0.0, 1.0, 0.0), white)
    s.mark_light(s.add_mesh("light", mesh.icosphere(
        center=(8.0, 9.0, 7.0), radius=4.0, subdivisions=1), light))
    return s


SCENES = {"golden": golden_scene, "meshlight": meshlight_scene}


def _jsettings(kw):
    kw = dict(kw)
    if "debug_render_mode" in kw:
        kw["debug_render_mode"] = JDebugRenderMode(kw["debug_render_mode"])
    return JRenderSettings(**kw)


def _tsettings(kw):
    kw = dict(kw)
    if "debug_render_mode" in kw:
        kw["debug_render_mode"] = DebugRenderMode(kw["debug_render_mode"])
    return RenderSettings(**kw)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


class _Proxy:
    """A module stand-in: the given attributes, the rest from `base`."""

    def __init__(self, base, **override):
        self._base = base
        self.__dict__.update(override)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _by_torch(fn):
    return lambda x: jnp.asarray(fn(torch.from_numpy(np.asarray(x))).numpy())


def shared_transcendentals(mp):
    """Make the JAX functions on the integrator's path evaluate cos, sin
    (ops/sampling.py), exp (models/integrators.py) and rsqrt
    (utils/vecmath.py) with torch, the port's implementation; op by op,
    every other operation stays JAX's."""
    mp.setattr(jsam, "jnp", _Proxy(jnp, cos=_by_torch(torch.cos),
                                   sin=_by_torch(torch.sin)))
    mp.setattr(jint, "jnp", _Proxy(jnp, exp=_by_torch(torch.exp)))
    mp.setattr(jvec, "jax", _Proxy(jax, lax=_Proxy(
        jax.lax, rsqrt=_by_torch(torch.rsqrt))))


def _rays():
    cam = jcam.to_arrays(JCameraConfig(pos=CAMERA, aspect=W / H))
    lane = jnp.arange(N, dtype=jnp.uint32)
    o, d = jcam.lane_rays(cam, lane, W, H)
    st = jrng.seed_lanes(lane, jnp.uint32(0), salt=SALT)
    return np.array(o), np.array(d), np.array(st)


@pytest.fixture(scope="module")
def xla():
    """Both packages' golden and mesh-light scenes (the JAX ones under
    the benchmark's tree flags), the rays, and JAX trace_advanced op by
    op for every case of CASES with the shared transcendentals, and for
    OWN with XLA's own."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jscene, "PACKET_TREE", "sweep_dp")
    mp.setattr(jscene, "PACKET_OCCL", True)
    try:
        jdevs = {k: make(jscene, jmat, jmesh).device()
                 for k, make in SCENES.items()}
        rays = _rays()
        with jax.disable_jit():
            own = jint.trace_advanced(jdevs["golden"], _jsettings(OWN),
                                      *rays)
        shared_transcendentals(mp)
        with jax.disable_jit():
            shared = {name: jint.trace_advanced(jdevs[sc], _jsettings(kw),
                                                *rays)
                      for name, (sc, kw) in CASES.items()}
    finally:
        mp.undo()
    tdevs = {k: tscene.scene_from_numpy(*jax_tables(v), "cpu")
             for k, v in jdevs.items()}
    return jdevs, tdevs, rays, shared, own


def _port_trace(tdev, kw, rays, sort, monkeypatch):
    o, d, st = rays
    idx = None
    if sort:  # sort on the CPU as on the card
        monkeypatch.setattr(tint, "packet_path_active",
                            lambda dev: bool(dev.proots))
        idx = torch.arange(N)
    return tint.trace_advanced(tdev, _tsettings(kw), _t(o), _t(d),
                               _t(st, torch.int64), idx=idx)


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("case", list(CASES))
def test_trace_advanced_vs_jax(xla, case, sort, monkeypatch):
    """trace_advanced against JAX trace_advanced op by op (shared
    transcendentals): energy, state, traced and ray_depth bitwise, with
    and without the wavefront sort (morton5 after every depth)."""
    jdevs, tdevs, rays, shared, _ = xla
    scene, kw = CASES[case]
    before = tint.sorts
    state, res = _port_trace(tdevs[scene], kw, rays, sort, monkeypatch)
    assert tint.sorts - before == (kw["max_ray_depth"] + 1 if sort else 0)
    j_state, j_res = shared[case]
    np.testing.assert_array_equal(res.energy.numpy(), np.asarray(j_res.energy))
    np.testing.assert_array_equal(state.numpy(),
                                  np.asarray(j_state).astype(np.int64))
    assert int(res.traced_rays) == int(j_res.traced_rays)
    np.testing.assert_array_equal(res.ray_depth.numpy(),
                                  np.asarray(j_res.ray_depth))
    assert float(res.energy.sum()) > 0.0
    if case == "nee_aovs":
        assert len(set(res.ray_depth.tolist())) > 2
        assert (res.bvh_depth >= 0).all() and res.bvh_depth.any()
    else:
        assert not res.ray_depth.any() and not res.bvh_depth.any()


def test_trace_advanced_vs_jax_own_transcendentals(xla):
    """With XLA's own sin / cos / exp / rsqrt: state, traced and the
    unsorted lanes' control flow exact, energy under the megakernel
    contract (the ULP differences move a few NEE contributions)."""
    _, tdevs, rays, _, own = xla
    state, res = _port_trace(tdevs["golden"], OWN, rays, False, None)
    j_state, j_res = own
    np.testing.assert_array_equal(state.numpy(),
                                  np.asarray(j_state).astype(np.int64))
    np.testing.assert_array_equal(res.ray_depth.numpy(),
                                  np.asarray(j_res.ray_depth))
    _check(j_res, res, True)


def test_aovs_and_bvh_depth_bounds(xla):
    """AOVs leave the energy, state and traced count bitwise unchanged;
    ray_depth lies in [0, depth + 1]; bvh_depth is >= 1 on every lane
    whose primary ray hits a mesh and never negative -- the bounds the
    JAX package's own bvh_depth meets too (its XLA walk's count)."""
    jdevs, tdevs, (o, d, st), shared, _ = xla
    kw = dict(CASES["nee_aovs"][1], track_aovs=False)
    plain = tint.trace_advanced(tdevs["golden"], _tsettings(kw), _t(o), _t(d),
                                _t(st, torch.int64))
    aov = tint.trace_advanced(tdevs["golden"],
                              _tsettings(dict(kw, track_aovs=True)), _t(o),
                              _t(d), _t(st, torch.int64))
    assert torch.equal(plain[0], aov[0])
    assert torch.equal(plain[1].energy, aov[1].energy)
    assert int(plain[1].traced_rays) == int(aov[1].traced_rays)
    assert 0 <= int(aov[1].ray_depth.min())
    assert int(aov[1].ray_depth.max()) <= DEPTH + 1
    h = tscene.intersect_scene(tdevs["golden"], _t(o), _t(d),
                               torch.full((N,), 1e34), count_depth=False)
    mesh = ((h.obj >= 0) & (h.kind == tscene.PRIM_MESH)).numpy()
    bvh = aov[1].bvh_depth.numpy()
    assert mesh.any() and (bvh[mesh] >= 1).all() and (bvh >= 0).all()
    with jax.disable_jit():
        jh = jscene.intersect_scene(jdevs["golden"], jnp.asarray(o),
                                    jnp.asarray(d),
                                    jnp.full((N,), 1e34, jnp.float32))
    jd = np.asarray(jh.bvh_depth)
    assert (jd[mesh] >= 1).all() and (jd >= 0).all()


def test_next_u32_range_vs_jax(rng_np):
    """next_u32_range bitwise, with scalar and per-lane bounds, a span of
    all u32 (lo = 0, hi = 2**32 - 1) and an empty one (hi = lo - 1)."""
    n = 4096
    st = rng_np.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng_np.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    span = rng_np.integers(0, 100, n).astype(np.uint32)
    hi = (lo.astype(np.uint64) + span - 1).astype(np.uint32)
    for a, b in ((0, 5), (0, 0xFFFFFFFF), (7, 7), (lo, hi)):
        js, jv = jrng.next_u32_range(jnp.asarray(st), a, b)
        ta = _t(a, torch.int64) if isinstance(a, np.ndarray) else a
        tb = _t(b, torch.int64) if isinstance(b, np.ndarray) else b
        ts, tv = trng.next_u32_range(_t(st, torch.int64), ta, tb)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv).astype(np.int64))


SAMPLERS = ("uniform_hemisphere", "cosine_weighted", "refract",
            "random_point_triangle", "random_point_sphere_facing")


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampling_vs_jax(name, rng_np, monkeypatch):
    """The sampling functions against JAX's ops/sampling.py op by op
    (shared transcendentals): state and every component bitwise."""
    shared_transcendentals(monkeypatch)
    n = 2048
    st = rng_np.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)

    def vec(scale=1.0, unit=False):
        v = (rng_np.normal(size=(n, 3)) * scale).astype(np.float32)
        if unit:
            v /= np.linalg.norm(v, axis=1, keepdims=True)
        return v

    if name in ("uniform_hemisphere", "cosine_weighted"):
        args = (vec(unit=True),)
        if name == "cosine_weighted":
            args[0][:4] = 0.0  # the normalize_safe fallback
    elif name == "refract":
        eta = rng_np.uniform(0.6, 1.6, n).astype(np.float32)
        cosi = rng_np.uniform(0.0, 1.0, n).astype(np.float32)
        k = rng_np.uniform(-0.2, 1.0, n).astype(np.float32)
        args = (vec(unit=True), vec(unit=True), eta, cosi, k)
    elif name == "random_point_triangle":
        args = (vec(3.0), vec(3.0), vec(3.0))
    else:
        args = (vec(5.0), rng_np.uniform(0.1, 4.0, n).astype(np.float32),
                vec(5.0))
    jargs = tuple(jnp.asarray(a) for a in args)

    def cols(a):
        return tuple(_t(np.ascontiguousarray(a[:, k])) for k in range(3)) \
            if a.ndim == 2 else _t(a)

    with jax.disable_jit():
        if name == "refract":
            ref = getattr(jsam, name)(*jargs)
        else:
            j_state, ref = getattr(jsam, name)(jnp.asarray(st), *jargs)
    if name == "refract":
        got = getattr(tsam, name)(*(cols(a) for a in args))
    else:
        t_state, got = getattr(tsam, name)(_t(st, torch.int64),
                                           *(cols(a) for a in args))
        np.testing.assert_array_equal(t_state.numpy(),
                                      np.asarray(j_state).astype(np.int64))
    np.testing.assert_array_equal(torch.stack(got, dim=1).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("scene", list(SCENES))
def test_sample_light_vs_jax(xla, scene, rng_np, monkeypatch):
    """sample_light against JAX's op by op (shared transcendentals),
    bitwise: state and every LightSample column, on sphere lights and on
    the mesh light over the light table (its triangles drawn from
    tris9)."""
    shared_transcendentals(monkeypatch)
    jdevs, tdevs, *_ = xla
    n = 2048
    pos = rng_np.uniform(-3, 3, (n, 3)).astype(np.float32)
    st = rng_np.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    with jax.disable_jit():
        j_state, ref = jint.sample_light(jdevs[scene], jnp.asarray(st),
                                         jnp.asarray(pos))
    t_state, got = tint.sample_light(tdevs[scene], _t(st, torch.int64),
                                     _t(pos))
    assert tdevs[scene].has_mesh_lights == (scene == "meshlight")
    np.testing.assert_array_equal(t_state.numpy(),
                                  np.asarray(j_state).astype(np.int64))
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


@pytest.fixture(scope="module")
def walk_scenes():
    """The golden scene and tests/test_packet_instances.py's instanced
    scene on the object-space machinery (port builds), and 2048 random
    queries aimed into the scene: t_init 1e34 or finite, 70% of lanes
    active, some rays along an axis."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CPUGPU_NO_FLATTEN", "1")
    try:
        devs = {"plain": golden_scene(tscene, tmat, tmesh).build_device("cpu"),
                "instance": packet_instanced(tscene, tmat, tmesh)
                .build_device("cpu")}
    finally:
        mp.undo()
    assert devs["instance"].machinery
    rng = np.random.default_rng(11)
    n = 2048
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 2] += 3.0
    d = (rng.normal(size=(n, 3)) * 2.0 - o).astype(np.float32)  # inward
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:32] = [0.0, 0.0, -1.0]
    rays = tuple(_t(np.ascontiguousarray(a[:, k])) for a in (o, d)
                 for k in range(3))
    t0 = _t(np.where(rng.uniform(size=n) < 0.5, 1e34,
                     rng.uniform(1, 15, n)).astype(np.float32))
    act = _t(rng.uniform(size=n) < 0.7)
    return devs, rays, t0, act


def _walk_args(walk_scenes, arm):
    devs, rays, t0, act = walk_scenes
    dev = devs[arm]
    return dev, (rays[:3], rays[3:], t0, dev.pnodes, dev.pltris,
                 dev.proots), dict(active=act, **dev.inst_kwargs(nrm=False))


def _flat(res):
    return (res[0], res[1], res[2], *res[3], *res[4:])


def _bits(cols):
    return [c.view(torch.int32) if c.dtype == torch.float32 else c
            for c in cols]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("arm", ["plain", "instance"])
def test_depth_walk_vs_host_build(walk_scenes, arm, any_hit):
    """The count_depth plain version (the walk) against the g++ build of
    the kernel body, bitwise on every output: t, id, object, normal,
    bvh_depth and, on the instance arm, the instance; dead lanes get 0."""
    _, args, kw = _walk_args(walk_scenes, arm)
    walk = tps.traverse_packet_slim(*args, any_hit=any_hit, **kw)
    host = tps.traverse_packet_slim_host(*args, any_hit=any_hit, **kw)
    assert len(walk) == len(host) == (6 if arm == "instance" else 5)
    for a, b in zip(_bits(_flat(walk)), _bits(_flat(host))):
        assert torch.equal(a, b)
    assert not walk[4][~kw["active"]].any()
    assert int((walk[4] >= 1).sum()) > 200 and int(walk[4].max()) > 1


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("arm", ["plain", "instance"])
def test_depth_walk_vs_brute_force(walk_scenes, arm, any_hit):
    """The walk's hits against the brute-force plain version: closest
    hits bitwise (t, id, object, normal, instance), any hits in
    existence; bvh_depth >= 1 on every lane with a hit."""
    dev, args, kw = _walk_args(walk_scenes, arm)
    walk = tps.traverse_packet_slim(*args, any_hit=any_hit, **kw)
    brute = tps.traverse_packet_slim(*args, any_hit=any_hit,
                                     count_depth=False, **kw)
    hit = walk[1] >= 0
    assert int(hit.sum()) > 200 and (walk[4][hit] >= 1).all()
    if any_hit:
        assert torch.equal(hit, brute[1] >= 0)
        return
    for k, (a, b) in enumerate(zip(_bits(_flat(walk)), _bits(_flat(brute)))):
        if k != 6:  # bvh_depth: 0 in the brute-force version
            assert torch.equal(a, b), k
    if arm == "instance":
        assert int((walk[5] >= 0).sum()) > 50


def test_sort_wavefront_aov_fold_vs_jax(xla, rng_np):
    """sort_wavefront with the AOV columns against the JAX package's
    one-word fold (morton5), bitwise: final_depth back in 8 bits,
    bvh_depth0 in 22 (counts over 2**22 included), active, is_specular
    and every other column."""
    jdevs, tdevs, *_ = xla
    n = 1024
    o = rng_np.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    tp = rng_np.uniform(size=(n, 3)).astype(np.float32)
    en = rng_np.uniform(size=(n, 3)).astype(np.float32)
    act = rng_np.integers(0, 2, n).astype(np.int32)
    spec = rng_np.integers(0, 2, n).astype(np.int32)
    fd = rng_np.integers(0, 7, n).astype(np.int32)
    bvh = rng_np.integers(0, 60, n).astype(np.int32)
    bvh[:16] += 1 << 22
    st = rng_np.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lane = rng_np.permutation(n).astype(np.int32)
    jc = dict(throughput=jnp.asarray(tp), energy=jnp.asarray(en),
              active=jnp.asarray(act), is_specular=jnp.asarray(spec),
              ray_ox=o[:, 0], ray_oy=o[:, 1], ray_oz=o[:, 2], ray_dx=d[:, 0],
              ray_dy=d[:, 1], ray_dz=d[:, 2], state=jnp.asarray(st),
              traced=jnp.zeros((), jnp.int32), lane=jnp.asarray(lane),
              final_depth=jnp.asarray(fd), bvh_depth0=jnp.asarray(bvh))
    ref = jint.sort_wavefront(jdevs["golden"], jc,
                              jnp.arange(n, dtype=jnp.int32), aovs=True)
    tc = dict(ray=tuple(_t(np.ascontiguousarray(a[:, k]))
                        for a in (o, d) for k in range(3)),
              state=_t(st.astype(np.int64)),
              tp=tuple(_t(np.ascontiguousarray(tp[:, k])) for k in range(3)),
              en=tuple(_t(np.ascontiguousarray(en[:, k])) for k in range(3)),
              active=_t(act), spec=_t(spec), lane=_t(lane),
              final_depth=_t(fd), bvh_depth0=_t(bvh))
    got = tint.sort_wavefront(tdevs["golden"], tc, "morton5")
    for k, name in enumerate(("ray_ox", "ray_oy", "ray_oz", "ray_dx",
                              "ray_dy", "ray_dz")):
        np.testing.assert_array_equal(got["ray"][k].numpy(),
                                      np.asarray(ref[name]))
    np.testing.assert_array_equal(torch.stack(got["en"], 1).numpy(),
                                  np.asarray(ref["energy"]))
    np.testing.assert_array_equal(got["state"].numpy(),
                                  np.asarray(ref["state"]).astype(np.int64))
    for mine, theirs in (("active", "active"), ("spec", "is_specular"),
                         ("lane", "lane"), ("final_depth", "final_depth"),
                         ("bvh_depth0", "bvh_depth0")):
        np.testing.assert_array_equal(got[mine].numpy(),
                                      np.asarray(ref[theirs]), err_msg=mine)
    assert (got["bvh_depth0"] < 1 << 22).all()


def _xla_renderer(settings, monkeypatch, frames, width=96, height=54):
    monkeypatch.setenv("CPUGPU_NO_MEGAKERNEL", "1")
    calls = []
    xla_fn = tint.trace_advanced
    monkeypatch.setattr(tint, "trace_advanced",
                        lambda *a, **k: calls.append(1) or xla_fn(*a, **k))
    r = trenderer.Renderer(
        golden_scene(tscene, tmat, tmesh),
        camera=CameraConfig(pos=(0.0, 0.5, 7.0)),
        config=RenderConfig(width=width, height=height, seed=0x12345678),
        settings=settings, device="cpu")
    r.render(frames)
    assert len(calls) == frames
    return r


@pytest.mark.parametrize("name", list(GOLDEN_CASES))
def test_golden_xla_route(name, monkeypatch):
    """Renderer on the XLA route (CPUGPU_NO_MEGAKERNEL=1) against the
    JAX package's goldens, which its XLA integrator rendered."""
    r = _xla_renderer(GOLDEN_CASES[name], monkeypatch, 3)
    ref = np.load(GOLDENS)[name]
    got = r.image_u32()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    delta = np.abs(got.view(np.uint8).astype(np.int64)
                   - ref.view(np.uint8).astype(np.int64))
    assert (delta == 0).mean() >= EQUAL_SHARE_MIN, (delta == 0).mean()
    assert delta.mean() <= MEAN_MAX, delta.mean()
    assert delta.max() <= MAX_MAX, delta.max()
    assert r.num_accumulated == 3 and r.stats.traced_rays > 96 * 54


def test_ray_depth_view_image_vs_jax(xla):
    """render_frame in the RAY_DEPTH view: its pixels are, bitwise, the
    JAX package's heatmap (integrators.py:713-719, op by op) of the
    ray_depth JAX trace_advanced returned, packed; the accumulator comes
    back unchanged."""
    _, tdevs, _, shared, _ = xla
    settings = _tsettings(dict(CASES["nee_aovs"][1], debug_render_mode=1))
    cam = tcam.to_arrays(CameraConfig(pos=CAMERA, aspect=W / H), "cpu")
    acc = torch.full((N, 4), 0.25)
    out, pixels, traced, _ = trenderer.render_frame(
        tdevs["golden"], cam, acc, 0, torch.arange(N), settings, W, H, 1,
        SALT)
    assert out is acc
    j_res = shared["nee_aovs"][1]
    with jax.disable_jit():
        heat = jvec.lerp(jint._GREEN, jint._RED, (
            j_res.ray_depth.astype(jnp.float32)
            / jnp.float32(DEPTH))[:, None])
        ref = jvec.vec4_to_uint(jnp.concatenate(
            [heat, jnp.ones((N, 1), jnp.float32)], axis=1))
    np.testing.assert_array_equal(pixels.numpy(),
                                  np.asarray(ref).astype(np.int64))
    assert int(traced) == int(j_res.traced_rays)
    assert len(set(pixels.tolist())) > 2


def test_debug_bypass_and_bvh_view(monkeypatch):
    """A debug view leaves the accumulator bitwise unchanged and does not
    reset it (set_debug_mode); the BVH_DEPTH heatmap's green channel
    dominates (tests/test_renderer.py:133-144) and it traces one ray per
    pixel; back in the plain view the frames accumulate again."""
    r = _xla_renderer(RenderSettings(max_ray_depth=DEPTH), monkeypatch, 2,
                      width=W, height=H)
    acc = r._accumulator.clone()
    for mode in (DebugRenderMode.BVH_DEPTH, DebugRenderMode.RAY_DEPTH):
        r.set_debug_mode(mode)
        r.render_frame()
        assert torch.equal(r._accumulator, acc)
        assert r.num_accumulated >= 2
        img = vec4_to_uint(r._accumulator / 2.0)  # unchanged plain image
        assert (img != r._pixels).any()
        if mode == DebugRenderMode.BVH_DEPTH:
            assert r.stats.traced_rays == N
            rgba = r._pixels.numpy().astype(np.uint32).view(np.uint8)
            rgba = rgba.reshape(-1, 4)
            assert rgba[:, 1].mean() > rgba[:, 0].mean()
            assert rgba[:, 1].mean() > rgba[:, 2].mean()
    r.set_debug_mode(DebugRenderMode.NONE)
    r.render_frame()
    assert not torch.equal(r._accumulator, acc)


ROUTE_CASES = {
    "aovs": ("golden", dict(track_aovs=True), {}),
    "ray_depth_view": ("golden", dict(debug_render_mode=1), {}),
    "bvh_depth_view": ("golden", dict(debug_render_mode=2), {}),
    "no_megakernel": ("golden", {}, {"CPUGPU_NO_MEGAKERNEL": "1"}),
    "meshlight": ("meshlight", {}, {}),
    "kernel": ("golden", {}, {}),
    "no_ptframe": ("golden", {}, {"CPUGPU_NO_PTFRAME": "1"}),
}
ROUTES = ("trace_advanced_frame", "trace_advanced_mega", "trace_advanced")


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_trace_sample_routes_vs_jax(xla, case, monkeypatch):
    """trace_sample takes the XLA integrator exactly where the JAX
    package's does (with its packet path forced on, as off the TPU):
    AOVs, debug views, CPUGPU_NO_MEGAKERNEL and mesh lights over the
    light table; the kernel routes elsewhere."""
    jdevs, tdevs, *_ = xla
    scene, kw, env = ROUTE_CASES[case]
    monkeypatch.setenv("CPUGPU_TPU_FORCE_PACKET", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    picked = []
    for mod in (jint, tint):
        for name in ROUTES:
            monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: (
                picked.append(_n), (None, None))[1])
    zeros = np.zeros((8, 3), np.float32)
    jrenderer.trace_sample(jdevs[scene], _jsettings(kw), zeros, zeros,
                           zeros[:, 0], None)
    trenderer.trace_sample(tdevs[scene], _tsettings(kw), _t(zeros),
                           _t(zeros), _t(zeros[:, 0]), None)
    assert picked[0] == picked[1], picked
    want_xla = case not in ("kernel", "no_ptframe")
    assert (picked[1] == "trace_advanced") == want_xla


def test_meshless_scene_takes_xla_route():
    """Config 1 (spheres and a plane, no mesh) in ADVANCED mode: the
    kernel gates refuse it and trace_sample takes trace_advanced, which
    renders a finite, lit frame; its bvh_depth is 0 everywhere."""
    scene, cam, _, *_ = benchscenes.config1_whitted()
    tdev = scene.build_device("cpu")
    settings = RenderSettings(max_ray_depth=DEPTH, track_aovs=True)
    ca = tcam.to_arrays(CameraConfig(pos=(0.0, 0.5, 8.0), aspect=W / H),
                        "cpu")
    o, d = tcam.lane_rays(ca, torch.arange(N), W, H)
    st = trng.seed_lanes(torch.arange(N), 0, salt=SALT)
    calls = []
    xla_fn = tint.trace_advanced
    mp = pytest.MonkeyPatch()
    mp.setattr(tint, "trace_advanced",
               lambda *a, **k: calls.append(1) or xla_fn(*a, **k))
    try:
        _, res = trenderer.trace_sample(tdev, settings, o, d, st, None)
    finally:
        mp.undo()
    assert calls == [1]
    assert torch.isfinite(res.energy).all() and float(res.energy.sum()) > 0
    assert not res.bvh_depth.any() and res.ray_depth.max() > 0


def test_config5_refit_keeps_xla_tables():
    """Config 5's object-space scene after its per-frame hook (new
    transforms, so a refit in place): every table, the XLA route's
    tris9, tri_normal and light_* included, equals a fresh build at the
    same transforms bitwise, and the tris9 rows stay in object space."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CPUGPU_NO_FLATTEN", "1")
    try:
        scene, *_, hook = benchscenes.config5_tlas_animated()
        dev = scene.device("cpu")
        tris = dev.tris9.clone()

        class _R:
            def reset(self):
                pass

        hook(0, _R())
        assert scene.device("cpu") is dev  # refit, not rebuilt
        fresh_scene, *_ = benchscenes.config5_tlas_animated()
        for obj, src in zip(fresh_scene.objects, scene.objects):
            obj.mesh, obj.blas = src.mesh, src.blas  # share the trees
            if src.instances is not None:
                obj.instances = src.instances.copy()
        fresh = fresh_scene.build_device("cpu")
    finally:
        mp.undo()
    assert dev.machinery and fresh.machinery
    for name, _ in tscene.TABLE_FIELDS:
        assert getattr(dev, name).numpy().tobytes() == \
            getattr(fresh, name).numpy().tobytes(), name
    assert torch.equal(dev.tris9, tris)
    assert dev.light_is_sphere.tolist() == [True, True]

