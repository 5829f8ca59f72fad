"""Benchmark configurations (the JAX package's benchscenes.py).

Each returns (scene, camera, settings, default_width, default_height,
per_frame_hook).  The port carries config 1 (WHITTED) and config 3
(ADVANCED, the main path); configs 2, 4 and 5 wait for the midpoint and
binned builds and the instancing they exercise.
"""

from __future__ import annotations

from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models.scene import make_reference_scene
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
