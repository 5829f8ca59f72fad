"""Multi-spp frames of the port (cpugpupathtracing_tpu_torch
models/renderer.py Renderer._spp_substeps, _dispatch_frame,
render_pipelined) against its own unrolled frames, as the JAX package's
tests/test_spp_substeps.py holds the JAX renderer: the same RNG streams,
so traced counts are exact, and the radiance differs from the unrolled
frame only by the accumulator's float add order (within 1e-5).  Plus the
sub-step rule (debug views and COMPARISON stay unrolled; the variable
is read at each call), render_pipelined against render_frame, and pause.
The scene is tests/test_spp_substeps.py's (a cube, a floor plane, a
sphere light) at 64x32, which takes the pixel-block ray order."""

import numpy as np
import pytest

from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    DebugRenderMode,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import materials as matlib
from cpugpupathtracing_tpu_torch.models import mesh as meshlib
from cpugpupathtracing_tpu_torch.models.renderer import Renderer
from cpugpupathtracing_tpu_torch.models.scene import Scene


def _scene() -> Scene:
    s = Scene()
    grey = s.add_material(matlib.Material.diffuse((0.5, 0.5, 0.5)))
    light = s.add_material(matlib.Material.light((1.0, 1.0, 1.0), 10.0))
    s.add_mesh("cube", meshlib.cube(half=1.5), grey)
    s.add_plane("floor", (0.0, -3.0, 0.0), (0.0, 1.0, 0.0), grey)
    li = s.add_sphere("light", (8.0, 9.0, 7.0), 4.0, light)
    s.mark_light(li)
    return s


def _renderer(spp=4, width=64, height=32, **settings):
    return Renderer(_scene(), camera=CameraConfig(),
                    config=RenderConfig(width=width, height=height,
                                        samples_per_frame=spp),
                    settings=RenderSettings(**settings), device="cpu")


@pytest.mark.parametrize("mode", [RenderMode.ADVANCED,
                                  RenderMode.BRUTE_FORCE],
                         ids=["advanced", "brute_force"])
def test_substeps_match_unrolled(mode, monkeypatch):
    """Two 4-spp frames as 1-spp sub-steps and unrolled
    (CPUGPU_SPP_UNROLL=1): each frame's traced count exact, the mean
    radiance within 1e-5, 8 samples accumulated either way."""
    out = {}
    for unroll in (False, True):
        if unroll:
            monkeypatch.setenv("CPUGPU_SPP_UNROLL", "1")
        else:
            monkeypatch.delenv("CPUGPU_SPP_UNROLL", raising=False)
        r = _renderer(render_mode=mode, max_ray_depth=3)
        assert r._spp_substeps(4) is not unroll
        r.render_frame()
        traced = r.stats.traced_rays
        r.render_frame()
        out[unroll] = (r, r.radiance(), traced)
    (r_sub, img_sub, tr_sub), (r_un, img_un, tr_un) = out[False], out[True]
    assert r_sub.num_accumulated == r_un.num_accumulated == 8
    assert r_sub._sample_counter == r_un._sample_counter == 8
    assert tr_sub == tr_un > 64 * 32 * 4
    assert r_sub.stats.traced_rays == r_un.stats.traced_rays
    np.testing.assert_allclose(img_sub, img_un, atol=1e-5, rtol=1e-5)
    assert img_sub.max() > 0.0


def test_substep_rule(monkeypatch):
    """Sub-steps need spp > 1, no debug view and a mode other than
    COMPARISON; CPUGPU_SPP_UNROLL=1 turns them off at the next call."""
    monkeypatch.delenv("CPUGPU_SPP_UNROLL", raising=False)
    r = _renderer()
    assert r._spp_substeps(4) and not r._spp_substeps(1)
    monkeypatch.setenv("CPUGPU_SPP_UNROLL", "1")
    assert not r._spp_substeps(4)
    monkeypatch.setenv("CPUGPU_SPP_UNROLL", "0")
    assert r._spp_substeps(4)
    for kw in (dict(debug_render_mode=DebugRenderMode.RAY_DEPTH),
               dict(debug_render_mode=DebugRenderMode.BVH_DEPTH),
               dict(render_mode=RenderMode.COMPARISON)):
        r.settings = RenderSettings(**kw)
        assert not r._spp_substeps(4), kw
    r.settings = RenderSettings(render_mode=RenderMode.WHITTED)
    assert r._spp_substeps(4)


@pytest.mark.parametrize("kw", [
    dict(debug_render_mode=DebugRenderMode.RAY_DEPTH),
    dict(render_mode=RenderMode.COMPARISON)], ids=["ray_depth", "comparison"])
def test_unrolled_modes_keep_pixels(kw, monkeypatch):
    """A debug view and COMPARISON keep one 4-spp frame: the pixels equal
    those of CPUGPU_SPP_UNROLL=1, bitwise."""
    images = []
    for unroll in ("0", "1"):
        monkeypatch.setenv("CPUGPU_SPP_UNROLL", unroll)
        r = _renderer(width=32, height=16, max_ray_depth=2, **kw)
        r.render_frame()
        images.append(r.image_u32())
        assert r._sample_counter == 4
    np.testing.assert_array_equal(images[0], images[1])


def test_render_pipelined_equals_frames(monkeypatch):
    """render_pipelined(3) at 2 spp (sub-steps) leaves the image, the
    accumulator and the traced total of three render_frame calls, and
    syncs the host once, after every frame is queued."""
    monkeypatch.delenv("CPUGPU_SPP_UNROLL", raising=False)
    a = _renderer(spp=2, width=32, height=16, max_ray_depth=2)
    traced = 0
    for _ in range(3):
        a.render_frame()
        traced += a.stats.traced_rays
    b = _renderer(spp=2, width=32, height=16, max_ray_depth=2)
    events = []
    dispatch, finish = b._dispatch_frame, b._finish
    monkeypatch.setattr(b, "_dispatch_frame",
                        lambda spp: events.append("d") or dispatch(spp))
    monkeypatch.setattr(b, "_finish", lambda: events.append("f") or finish())
    assert b.render_pipelined(3) == traced
    assert events == ["d", "d", "d", "f"]
    np.testing.assert_array_equal(a.image_u32(), b.image_u32())
    assert bool((a._accumulator == b._accumulator).all())
    assert b.num_accumulated == 6 and b.stats.traced_rays == traced // 3
    assert b.stats.total_traced_rays == traced
    assert b.mean_energy == pytest.approx(a.mean_energy, rel=1e-6)


def test_pause_skips_frames():
    """While paused render_frame and render_pipelined queue nothing; the
    toggle resets the accumulator (Main.cpp:851-854)."""
    r = _renderer(spp=1, width=32, height=16, max_ray_depth=1)
    r.render_frame()
    r.set_paused(True)
    assert r.num_accumulated == 0
    assert r.render_frame() is None and r.render_pipelined(2) == 0
    assert r.num_accumulated == 0 and r._sample_counter == 1
    r.set_paused(False)
    r.render_pipelined(2)
    assert r.num_accumulated == 2 and r._sample_counter == 3
