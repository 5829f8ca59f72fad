"""Benchmark configurations (the JAX package's benchscenes.py).

Each returns (scene, camera, settings, default_width, default_height,
per_frame_hook).  This slice of the port carries config 3, the main
path; the other configurations wait for the render modes and the
instancing they exercise.
"""

from __future__ import annotations

from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models.scene import make_reference_scene


def config3_sah_dielectrics():
    """Binned-SAH BVH + dielectrics with Beer absorption: glass dragon, 1080p."""
    return (
        make_reference_scene(),
        CameraConfig(pos=(0.0, 0.0, 8.0), aspect=16 / 9),
        RenderSettings(render_mode=RenderMode.ADVANCED),
        1920, 1080, None,
    )
