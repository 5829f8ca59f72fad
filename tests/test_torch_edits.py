"""The port's live edits and image output (cpugpupathtracing_tpu_torch
models/scene.py set_material / set_sphere / set_plane / rebuild_bvh /
object_stats, models/renderer.py's edit methods, image_rgba8, radiance,
save_png, utils/image.py), against the JAX package where it has the same
function.

  * After each edit a frame equals, bitwise (accumulator and pixels), the
    frame of a fresh Renderer on a scene built with the edit, at the same
    sample counter and accumulated frames: the edit reaches the next
    snapshot, which is a new one (no table of the old snapshot is
    written).  rebuild_bvh under CPUGPU_PACKET_TREE=fat gives the
    closest-hit tables of a scene built with the new option.
  * The accumulator resets exactly where the JAX package's Renderer
    resets it, edit by edit.
  * object_stats equals the JAX package's (golden, config 2, instanced
    scenes, and after rebuild_bvh); save_png writes the JAX package's
    utils/image.write_png bytes, and read_png reads them back.
Scene: tests/test_golden.py's at 32x16 with the camera at (0.05, 0.5, 7)
(off the icosphere's planes of symmetry, ROADMAP.md condition 5)."""

import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu import benchscenes as jbench
from cpugpupathtracing_tpu.config import BuildOption as JBuildOption
from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
from cpugpupathtracing_tpu.config import DebugRenderMode as JDebugRenderMode
from cpugpupathtracing_tpu.config import RenderConfig as JRenderConfig
from cpugpupathtracing_tpu.config import RenderMode as JRenderMode
from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.models import renderer as jrenderer
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu.utils import image as jimage
from cpugpupathtracing_tpu_torch import benchscenes as tbench
from cpugpupathtracing_tpu_torch.config import (
    BuildOption,
    CameraConfig,
    DebugRenderMode,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.models.renderer import Renderer
from cpugpupathtracing_tpu_torch.utils import image as timage

from tests.test_torch_instances import packet_instanced
from tests.test_torch_scene import golden_scene

CAMERA = CameraConfig(pos=(0.05, 0.5, 7.0), aspect=2.0)
CONFIG = RenderConfig(width=32, height=16)
SETTINGS = RenderSettings(max_ray_depth=3)
# golden_scene's objects: 0 icosphere (glass), 1 cube, 2 floor plane,
# 3 sphere light; materials: 0 white, 1 blue, 2 light, 3 glass
SCENE_EDITS = {
    "material": ("set_material", lambda m, B: (0, m.Material.diffuse(
        (0.3, 0.9, 0.3), specular=0.2))),
    "sphere": ("set_sphere", lambda m, B: (3, (6.0, 8.0, 7.0), 3.5)),
    "plane": ("set_plane", lambda m, B: (2, (0.0, -1.5, 0.0),
                                         (0.0, 1.0, 0.0))),
    "rebuild": ("rebuild_bvh", lambda m, B: (0, B.NAIVE_SPLIT)),
}


def _renderer(scene):
    return Renderer(scene, camera=CAMERA, config=CONFIG, settings=SETTINGS,
                    device="cpu")


@pytest.mark.parametrize("edit", list(SCENE_EDITS))
def test_edit_equals_fresh_renderer(edit, monkeypatch):
    """One frame, the edit through Renderer, one frame: accumulator,
    pixels and counters equal a fresh Renderer's on the edited scene
    (one frame, the same reset, one frame), bitwise.  The edit makes a
    new snapshot and leaves the old one's tables as they were."""
    monkeypatch.setenv("CPUGPU_PACKET_TREE", "fat")
    method, args = SCENE_EDITS[edit]
    r = _renderer(golden_scene(tscene, tmat, tmesh))
    r.render_frame()
    old = r.scene.device("cpu")
    old_tables = {k: v.numpy().tobytes() for k, v in vars(old).items()
                  if isinstance(v, torch.Tensor)}
    getattr(r, method)(*args(tmat, BuildOption))
    reset = r.num_accumulated == 0
    assert reset == (edit != "rebuild")
    r.render_frame()
    new = r.scene.device("cpu")
    assert new is not old
    for k, v in old_tables.items():
        assert getattr(old, k).numpy().tobytes() == v, k

    edited = golden_scene(tscene, tmat, tmesh)
    getattr(edited, method)(*args(tmat, BuildOption))
    f = _renderer(edited)
    f.render_frame()
    if reset:
        f.reset()
    f.render_frame()
    assert r.num_accumulated == f.num_accumulated == (1 if reset else 2)
    assert r._sample_counter == f._sample_counter == 2
    assert bool((r._accumulator == f._accumulator).all())
    np.testing.assert_array_equal(r.image_u32(), f.image_u32())
    assert r.stats.traced_rays == f.stats.traced_rays
    if edit == "rebuild":
        fresh = golden_scene(tscene, tmat, tmesh)
        fresh.objects[0].build_option = BuildOption.NAIVE_SPLIT
        assert new.pnodes.numpy().tobytes() == \
            fresh.build_device("cpu").pnodes.numpy().tobytes()
        assert new.pnodes.numpy().tobytes() != old.pnodes.numpy().tobytes()


# (name, the edit on a Renderer of either package: r, its config module
# and its materials module)
RESET_EDITS = {
    "move_camera": lambda r, c, m: r.move_camera((0.0, 0.0, -0.5)),
    "set_camera": lambda r, c, m: r.set_camera(c.CameraConfig(pos=(1, 0, 8))),
    "settings_toggle": lambda r, c, m: r.set_settings(
        r.settings.replace(max_ray_depth=2, russian_roulette=False)),
    "settings_mode": lambda r, c, m: r.set_settings(
        r.settings.replace(render_mode=c.RenderMode.BRUTE_FORCE)),
    "render_mode_same": lambda r, c, m: r.set_render_mode(
        c.RenderMode.ADVANCED),
    "render_mode": lambda r, c, m: r.set_render_mode(c.RenderMode.COMPARISON),
    "debug_mode": lambda r, c, m: r.set_debug_mode(
        c.DebugRenderMode.BVH_DEPTH),
    "material": lambda r, c, m: r.set_material(1, m.Material.diffuse(
        (0.5, 0.5, 0.5))),
    "rebuild": lambda r, c, m: r.rebuild_bvh(1, c.BuildOption.NAIVE_SPLIT),
    "sphere": lambda r, c, m: r.set_sphere(3, (8.0, 9.0, 6.0), 4.0),
    "plane": lambda r, c, m: r.set_plane(2, (0.0, -2.5, 0.0), (0, 1, 0)),
    "pause": lambda r, c, m: r.set_paused(True),
    "pause_same": lambda r, c, m: r.set_paused(False),
}


class _JaxConfig:
    CameraConfig = JCameraConfig
    RenderMode = JRenderMode
    DebugRenderMode = JDebugRenderMode
    BuildOption = JBuildOption


class _PortConfig:
    CameraConfig = CameraConfig
    RenderMode = RenderMode
    DebugRenderMode = DebugRenderMode
    BuildOption = BuildOption


def test_reset_policy_vs_jax():
    """Each edit resets the accumulator exactly where the JAX package's
    Renderer does (camera, material, sphere, plane, a render-mode change
    and the pause toggle; not settings toggles, the debug view, a BVH
    rebuild, or a toggle to the state it is in)."""
    expect_reset = {"move_camera", "set_camera", "settings_mode",
                    "render_mode", "material", "sphere", "plane", "pause"}
    for name, edit in RESET_EDITS.items():
        j = jrenderer.Renderer(golden_scene(jscene, jmat, jmesh),
                               config=JRenderConfig(width=8, height=4))
        t = Renderer(golden_scene(tscene, tmat, tmesh),
                     config=RenderConfig(width=8, height=4), device="cpu")
        for r, c, m in ((j, _JaxConfig, jmat), (t, _PortConfig, tmat)):
            r.num_accumulated = 5
            r.total_energy_received = 1.0
            edit(r, c, m)
        assert j.num_accumulated == t.num_accumulated, name
        assert (t.num_accumulated == 0) == (name in expect_reset), name
        assert t.total_energy_received == j.total_energy_received, name
        assert int(t.settings.render_mode) == int(j.settings.render_mode)
        assert t.camera.pos == tuple(j.camera.pos), name
        assert t.pause_rendering == j.pause_rendering, name


def _stats_scenes(S, mat, mesh, bench):
    golden = golden_scene(S, mat, mesh)
    rebuilt = golden_scene(S, mat, mesh)
    rebuilt.rebuild_bvh(0, 2)
    rebuilt.rebuild_bvh(1, 0)
    return {"golden": golden, "rebuilt": rebuilt,
            "config2": bench.config2_path_tracer_midpoint()[0],
            "instanced": packet_instanced(S, mat, mesh, light=True)}


def test_object_stats_vs_jax():
    """object_stats equals the JAX package's, every field: the golden
    scene, the same after rebuild_bvh (SAH_SPLIT_PRIMITIVES, NAIVE_SPLIT),
    config 2 (NAIVE_SPLIT) and an instanced mesh."""
    jscenes = _stats_scenes(jscene, jmat, jmesh, jbench)
    tscenes = _stats_scenes(tscene, tmat, tmesh, tbench)
    for name, t in tscenes.items():
        got, ref = t.object_stats(), jscenes[name].object_stats()
        assert got == ref, name
        assert any("bvh" in rec for rec in got)


def test_images_vs_jax(tmp_path):
    """image_rgba8 unpacks image_u32 as the JAX package's packed_to_rgba8;
    save_png writes the bytes of its write_png; read_png reads them back;
    radiance is the accumulator over its sample count."""
    r = _renderer(golden_scene(tscene, tmat, tmesh))
    r.render(2)
    rgba = r.image_rgba8()
    assert rgba.dtype == np.uint8 and rgba.shape == (16, 32, 4)
    np.testing.assert_array_equal(rgba, jimage.packed_to_rgba8(r.image_u32()))
    r.save_png(str(tmp_path / "port.png"))
    jimage.write_png(str(tmp_path / "jax.png"), rgba)
    data = (tmp_path / "port.png").read_bytes()
    assert data == (tmp_path / "jax.png").read_bytes()
    assert data == timage.png_bytes(rgba)
    np.testing.assert_array_equal(timage.read_png(str(tmp_path / "port.png")),
                                  rgba)
    acc = r._accumulator.numpy()
    np.testing.assert_array_equal(
        r.radiance(), (acc[:, :3] / acc[:, 3:4]).reshape(16, 32, 3))
    assert r.radiance().max() > 0.0
    with pytest.raises(ValueError):
        timage.png_bytes(rgba.astype(np.float32))
