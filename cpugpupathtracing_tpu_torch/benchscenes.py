"""The five benchmark configurations (the JAX package's benchscenes.py).

Each returns (scene, camera, settings, default_width, default_height,
per_frame_hook), where per_frame_hook(frame_idx, renderer) makes any
per-frame scene edit (config 5 moves its instances every frame).
Config 1 is WHITTED, configs 2-5 ADVANCED: config 2 a small glTF mesh
under the midpoint build, config 3 the main path, config 4 config 3 at
the caller's spp, config 5 a TLAS of six instanced dragons.

Config 2 reads the reference's duck (Assets/Models/Duck/Duck.gltf under
the reference checkout that CPUGPU_REFERENCE_DIR names, else under
./reference); where it is absent it takes icosphere(1.5, 3), as the JAX
package does without the asset.
"""

from __future__ import annotations

import os

import numpy as np

from cpugpupathtracing_tpu_torch.config import (
    BuildOption,
    CameraConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import gltf as gltflib
from cpugpupathtracing_tpu_torch.models import materials as matlib
from cpugpupathtracing_tpu_torch.models import mesh as meshlib
from cpugpupathtracing_tpu_torch.models.scene import (
    Scene,
    make_reference_scene,
)
from cpugpupathtracing_tpu_torch.models.whitted import make_whitted_scene

DUCK = os.path.join(os.environ.get("CPUGPU_REFERENCE_DIR", "reference"),
                    "Assets", "Models", "Duck", "Duck.gltf")


def config1_whitted():
    """Whitted raytracer: spheres + plane, shadow rays, point lights, 800x600."""
    return (
        make_whitted_scene(),
        CameraConfig(pos=(0.0, 0.5, 8.0), aspect=800 / 600),
        RenderSettings(render_mode=RenderMode.WHITTED, max_ray_depth=4),
        800, 600, None,
    )


def config2_path_tracer_midpoint():
    """Path tracer with accumulation, midpoint-split BVH, small glTF mesh."""
    s = Scene()
    white = s.add_material(matlib.Material.diffuse((0.85, 0.85, 0.85)))
    shiny = s.add_material(matlib.Material.diffuse((0.9, 0.7, 0.3), specular=0.35))
    light = s.add_material(matlib.Material.light((1.0, 0.95, 0.8), 10.0))
    try:
        duck = gltflib.load(DUCK, apply_transforms=True)
        c = (duck.positions.max(0) + duck.positions.min(0)) / 2
        duck = meshlib.Mesh(
            (duck.positions - c) * 2.5, duck.normals, duck.indices
        )
    except Exception:
        duck = meshlib.icosphere(radius=1.5, subdivisions=3)
    s.add_mesh("duck", duck, shiny, BuildOption.NAIVE_SPLIT)
    s.add_mesh("ground", meshlib.ground_quad(y=-2.0), white, BuildOption.NAIVE_SPLIT)
    li = s.add_sphere("light", (10.0, 10.0, 10.0), 5.0, light)
    s.mark_light(li)
    return (
        s,
        CameraConfig(pos=(0.0, 0.5, 7.0)),
        RenderSettings(render_mode=RenderMode.ADVANCED),
        1280, 720, None,
    )


def config3_sah_dielectrics():
    """Binned-SAH BVH + dielectrics with Beer absorption: glass dragon, 1080p."""
    return (
        make_reference_scene(),
        CameraConfig(pos=(0.0, 0.0, 8.0), aspect=16 / 9),
        RenderSettings(render_mode=RenderMode.ADVANCED),
        1920, 1080, None,
    )


def config4_variance_reduction(spp: int = 4):
    """NEE + cosine importance sampling + Russian roulette at 4-64 spp:
    config 3's scene; the caller sets RenderConfig.samples_per_frame."""
    scene, cam, settings, w, h, _ = config3_sah_dielectrics()
    return scene, cam, settings, w, h, None


def _ring_transforms(k: int, radius: float, t: float) -> np.ndarray:
    out = np.zeros((k, 4, 4), np.float32)
    for i in range(k):
        ang = 2 * np.pi * i / k + 0.35 * t
        c, s = np.cos(ang), np.sin(ang)
        scale = 0.55
        out[i] = [
            [c * scale, 0, s * scale, radius * np.cos(ang)],
            [0, scale, 0, 0.8 * np.sin(t + i)],
            [-s * scale, 0, c * scale, radius * np.sin(ang)],
            [0, 0, 0, 1],
        ]
    return out


def config5_tlas_animated(num_instances: int = 6):
    """TLAS over instanced BLASes with transforms + per-frame TLAS refit
    (animated multi-dragon ring)."""
    s = Scene()
    white = s.add_material(matlib.Material.diffuse((1.0, 1.0, 1.0)))
    glass = s.add_material(
        matlib.Material.dielectric((1.0, 1.0, 1.0), 0.0, 1.0, (0.2, 0.8, 0.8), 1.517)
    )
    light = s.add_material(matlib.Material.light((1.0, 0.95, 0.8), 10.0))
    dragon = meshlib.dragon_standin()
    obj = s.add_instanced_mesh(
        "dragons", dragon, glass, _ring_transforms(num_instances, 4.5, 0.0)
    )
    s.add_mesh("ground", meshlib.ground_quad(), white)
    l0 = s.add_sphere("light0", (10.0, 10.0, 10.0), 5.0, light)
    s.mark_light(l0)
    l1 = s.add_sphere("light1", (-10.0, 10.0, -10.0), 5.0, light)
    s.mark_light(l1)

    def hook(frame: int, renderer) -> None:
        # animate: new transforms, refit on the next frame's snapshot
        # (no tree is rebuilt, scene.set_instance_transform); moving
        # geometry invalidates the accumulator like a camera move
        t = 0.12 * (frame + 1)
        for i, m in enumerate(_ring_transforms(num_instances, 4.5, t)):
            s.set_instance_transform(obj, i, m)
        renderer.reset()

    return (
        s,
        CameraConfig(pos=(0.0, 1.5, 12.0), aspect=16 / 9),
        RenderSettings(render_mode=RenderMode.ADVANCED),
        1280, 720, hook,
    )


CONFIGS = {
    1: ("whitted_800x600", config1_whitted),
    2: ("pathtracer_midpoint_gltf", config2_path_tracer_midpoint),
    3: ("sah_dielectrics_dragon_1080p", config3_sah_dielectrics),
    4: ("variance_reduction_spp", config4_variance_reduction),
    5: ("tlas_animated_instances", config5_tlas_animated),
}
