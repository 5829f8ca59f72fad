"""Benchmark configurations (the JAX package's benchscenes.py).

Each returns (scene, camera, settings, default_width, default_height,
per_frame_hook).  The port carries config 1 (WHITTED), config 3
(ADVANCED, the main path) and config 5 (ADVANCED over a TLAS of six
instanced dragons, refit every frame); configs 2 and 4 wait for the
midpoint and binned builds they exercise.
"""

from __future__ import annotations

import numpy as np

from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import materials as matlib
from cpugpupathtracing_tpu_torch.models import mesh as meshlib
from cpugpupathtracing_tpu_torch.models.scene import (
    Scene,
    make_reference_scene,
)
from cpugpupathtracing_tpu_torch.models.whitted import make_whitted_scene


def config1_whitted():
    """Whitted raytracer: spheres + plane, shadow rays, point lights, 800x600."""
    return (
        make_whitted_scene(),
        CameraConfig(pos=(0.0, 0.5, 8.0), aspect=800 / 600),
        RenderSettings(render_mode=RenderMode.WHITTED, max_ray_depth=4),
        800, 600, None,
    )


def config3_sah_dielectrics():
    """Binned-SAH BVH + dielectrics with Beer absorption: glass dragon, 1080p."""
    return (
        make_reference_scene(),
        CameraConfig(pos=(0.0, 0.0, 8.0), aspect=16 / 9),
        RenderSettings(render_mode=RenderMode.ADVANCED),
        1920, 1080, None,
    )


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
