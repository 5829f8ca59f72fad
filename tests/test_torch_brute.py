"""The port's BRUTE_FORCE and COMPARISON modes
(cpugpupathtracing_tpu_torch models/integrators.trace_brute,
models/renderer.trace_sample / trace_comparison / render_frame) against
the JAX package on the CPU, with the scene tables handed over through
scene_from_numpy.  JAX on the CPU takes its XLA walk, so no Pallas
kernel runs here.

Tolerances:
  * trace_brute against JAX trace_brute run op by op (jax.disable_jit())
    with the shared transcendentals of tests/test_torch_xla.py (torch's
    cos, sin, exp and rsqrt in the JAX functions): energy, RNG state,
    traced count and final_depth bitwise, with and without AOVs and
    with and without the morton5 wavefront sort (forced on the CPU as on
    the card; JAX on the CPU never sorts, and the sort is invisible).
    bvh_depth0 is a count of the walk's own visits, which differs from
    JAX's XLA walk's descents (tests/test_torch_xla.py): it is held
    bitwise against the port's own primary-ray query and to JAX's bounds
    (>= 1 on every lane whose primary ray hits a mesh, never negative).
  * Frames through Renderer(device="cpu") against the `bruteforce` and
    `comparison` goldens (tests/goldens/frames.npz): the tolerance of
    tests/test_torch_renderer.py.  Measured on the CPU: 'bruteforce' all
    channels equal (no shadow rays); 'comparison' 99.976% of channels
    equal, mean 0.0013, max 18 (the right half's NEE rays, as
    'advanced').
The camera sits at (0.05, 0.5, 7), off the icosphere's planes of
symmetry (ROADMAP.md condition 5)."""

import jax
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.config import RenderSettings as JRenderSettings
from cpugpupathtracing_tpu.models import integrators as jint
from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    DebugRenderMode,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import camera as tcam
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import renderer as trenderer
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.models.renderer import Renderer
from cpugpupathtracing_tpu_torch.utils import rng as trng

from tests.test_torch_renderer import (
    EQUAL_SHARE_MIN,
    GOLDENS,
    MAX_MAX,
    MEAN_MAX,
)
from tests.test_torch_scene import golden_scene, jax_tables
from tests.test_torch_xla import N, _rays, _t, shared_transcendentals

DEPTH = 2
AOV = dict(max_ray_depth=DEPTH, track_aovs=True)


@pytest.fixture(scope="module")
def brute():
    """Both packages' golden scene (the JAX one under the benchmark's tree
    flags), tests/test_torch_xla.py's 512 camera rays, and JAX
    trace_brute op by op with AOVs under the shared transcendentals."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jscene, "PACKET_TREE", "sweep_dp")
    mp.setattr(jscene, "PACKET_OCCL", True)
    try:
        jdev = golden_scene(jscene, jmat, jmesh).device()
        rays = _rays()
        shared_transcendentals(mp)
        with jax.disable_jit():
            ref = jint.trace_brute(jdev, JRenderSettings(**AOV), *rays)
    finally:
        mp.undo()
    tdev = tscene.scene_from_numpy(*jax_tables(jdev), "cpu")
    return tdev, rays, ref


def _port_brute(tdev, rays, aovs, sort, monkeypatch):
    o, d, st = rays
    idx = None
    if sort:  # sort on the CPU as on the card
        monkeypatch.setattr(tint, "packet_path_active",
                            lambda dev: bool(dev.proots))
        idx = torch.arange(N)
    settings = RenderSettings(max_ray_depth=DEPTH, track_aovs=aovs)
    return tint.trace_brute(tdev, settings, _t(o), _t(d),
                            _t(st, torch.int64), idx=idx)


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("aovs", [False, True], ids=["plain", "aovs"])
def test_trace_brute_vs_jax(brute, aovs, sort, monkeypatch):
    """trace_brute against JAX trace_brute op by op (shared
    transcendentals): energy, state, traced bitwise, and with AOVs
    final_depth; bvh_depth0 equals the port's own primary query's count
    and meets JAX's bounds.  Sorted: one morton5 sort per depth."""
    tdev, rays, (j_state, j_res) = brute
    before = tint.sorts
    state, res = _port_brute(tdev, rays, aovs, sort, monkeypatch)
    assert tint.sorts - before == (DEPTH + 1 if sort else 0)
    np.testing.assert_array_equal(res.energy.numpy(),
                                  np.asarray(j_res.energy))
    np.testing.assert_array_equal(state.numpy(),
                                  np.asarray(j_state).astype(np.int64))
    assert int(res.traced_rays) == int(j_res.traced_rays)
    assert float(res.energy.sum()) > 0.0
    if not aovs:
        assert not res.ray_depth.any() and not res.bvh_depth.any()
        return
    np.testing.assert_array_equal(res.ray_depth.numpy(),
                                  np.asarray(j_res.ray_depth))
    assert len(set(res.ray_depth.tolist())) > 2
    o, d, _ = rays
    h = tscene.intersect_scene(tdev, _t(o), _t(d), torch.full((N,), 1e34))
    np.testing.assert_array_equal(res.bvh_depth.numpy(), h.bvh_depth.numpy())
    mesh = ((h.obj >= 0) & (h.kind == tscene.PRIM_MESH)).numpy()
    jd = np.asarray(j_res.bvh_depth)
    for bvh in (res.bvh_depth.numpy(), jd):
        assert mesh.any() and (bvh[mesh] >= 1).all() and (bvh >= 0).all()


def test_trace_brute_paths_end(brute):
    """A lane is traced at most once per depth, a primary miss carries no
    energy, and every lane, live or dead, makes the same four draws per
    depth (lobe, Fresnel, two for the hemisphere direction), so its RNG
    state is its seed stepped 4 (depth + 1) times."""
    tdev, (o, d, st), _ = brute
    settings = RenderSettings(max_ray_depth=DEPTH, track_aovs=True)
    state, res = tint.trace_brute(tdev, settings, _t(o), _t(d),
                                  _t(st, torch.int64))
    assert int(res.traced_rays) <= N * (DEPTH + 1)
    missed = (res.ray_depth == 0).numpy()
    assert missed.any()
    assert not res.energy.numpy()[missed].any()
    s = _t(st, torch.int64)
    for _ in range(4 * (DEPTH + 1)):
        s = trng.xs32(s)
    assert torch.equal(state, s)


def test_trace_sample_routes_brute(brute, monkeypatch):
    """trace_sample sends BRUTE_FORCE to trace_brute (BVH_DEPTH to its
    primary-ray heatmap) and refuses COMPARISON, which render_frame
    splits."""
    tdev, (o, d, st), _ = brute
    calls = []
    real = tint.trace_brute
    monkeypatch.setattr(tint, "trace_brute",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    args = (_t(o), _t(d), _t(st, torch.int64), None)
    brute_settings = RenderSettings(render_mode=RenderMode.BRUTE_FORCE,
                                    max_ray_depth=1)
    trenderer.trace_sample(tdev, brute_settings, *args)
    assert calls == [1]
    _, view = trenderer.trace_sample(tdev, brute_settings.replace(
        debug_render_mode=DebugRenderMode.BVH_DEPTH), *args)
    assert int(view.traced_rays) == N and view.bvh_depth.any()
    with pytest.raises(ValueError):
        trenderer.trace_sample(tdev, brute_settings.replace(
            render_mode=RenderMode.COMPARISON), *args)


def test_comparison_halves(brute):
    """trace_comparison: the left width // 2 columns are trace_brute's,
    the right width - width // 2 trace_advanced's, on the same row-major
    rays and states, without lane identities; traced is their sum.  An
    odd width puts the extra column on the right."""
    tdev, (o, d, st), _ = brute
    w, h = 31, 16
    o, d, st = (_t(a[: w * h]) for a in (o, d, st))
    st = st.to(torch.int64)
    settings = RenderSettings(render_mode=RenderMode.COMPARISON,
                              max_ray_depth=1)
    energy, traced = trenderer.trace_comparison(tdev, settings, o, d, st,
                                                w, h)
    half = w // 2
    def cols(x, sl):
        rest = tuple(x.shape[1:])
        return x.reshape((h, w) + rest)[:, sl].reshape((-1,) + rest)

    for sl, fn in ((slice(0, half), tint.trace_brute),
                   (slice(half, w), tint.trace_advanced)):
        _, res = fn(tdev, settings, cols(o, sl), cols(d, sl), cols(st, sl))
        assert torch.equal(cols(energy, sl), res.energy)
        traced = traced - res.traced_rays
    assert int(traced) == 0


def test_comparison_keeps_row_major(monkeypatch):
    """COMPARISON never takes the pixel-block ray order, even at a size
    with blocks (64x32): its halves are contiguous columns."""
    def refuse(*a, **k):
        raise AssertionError("COMPARISON asked for blocked rays")

    monkeypatch.setattr(tcam, "blocked_lane_rays", refuse)
    assert tcam.block_shape(64, 32) is not None
    r = Renderer(golden_scene(tscene, tmat, tmesh),
                 camera=CameraConfig(pos=(0.05, 0.5, 7.0), aspect=2.0),
                 config=RenderConfig(width=64, height=32),
                 settings=RenderSettings(render_mode=RenderMode.COMPARISON,
                                         max_ray_depth=1),
                 device="cpu")
    r.render_frame()
    assert r.num_accumulated == 1 and r.stats.traced_rays > 64 * 32


@pytest.mark.parametrize("name,mode", [
    ("bruteforce", RenderMode.BRUTE_FORCE),
    ("comparison", RenderMode.COMPARISON)], ids=["bruteforce", "comparison"])
def test_golden_frames(name, mode):
    """3 progressive frames of the golden scene at 96x54 against the JAX
    package's golden frame (tolerance in the module docstring)."""
    r = Renderer(golden_scene(tscene, tmat, tmesh),
                 camera=CameraConfig(pos=(0.0, 0.5, 7.0)),
                 config=RenderConfig(width=96, height=54, seed=0x12345678),
                 settings=RenderSettings(render_mode=mode), device="cpu")
    r.render(3)
    got = r.image_u32()
    ref = np.load(GOLDENS)[name]
    assert got.shape == ref.shape and got.dtype == ref.dtype
    delta = np.abs(got.view(np.uint8).astype(np.int64)
                   - ref.view(np.uint8).astype(np.int64))
    assert (delta == 0).mean() >= EQUAL_SHARE_MIN, (delta == 0).mean()
    assert delta.mean() <= MEAN_MAX, delta.mean()
    assert delta.max() <= MAX_MAX, delta.max()
    if mode == RenderMode.BRUTE_FORCE:
        assert (delta == 0).all()
    assert r.num_accumulated == 3
    assert r.stats.traced_rays > 96 * 54
    assert np.isfinite(r.mean_energy) and r.mean_energy > 0.0
