"""The port's frame driver (cpugpupathtracing_tpu_torch/models/renderer.py)
against the JAX package's golden frames (tests/goldens/frames.npz): the
golden scene at 96x54, seed 0x12345678, 3 progressive frames.  96x54 has
no block shape, so this covers the row-major camera branch (config 3's
1920x1080 takes the blocked one, tests/test_torch_camera.py).

Tolerance, per 8-bit channel: >= 99.5% of channels equal, mean |delta|
<= 0.05 and max |delta| <= 32.  The JAX goldens were rendered under jit,
where XLA contracts multiply-adds into FMAs and evaluates sin/cos/exp
with its own polynomials; the port rounds every product and uses torch's
transcendentals.  Those ULPs flip a few NEE shadow rays that graze an
occluder's silhouette, and one flipped light sample moves its pixel by
up to ~0.25 of radiance, i.e. ~20 levels after the 3-frame average.
Measured on the CPU: 'advanced' 99.957% of channels equal, max 18;
'advanced_nonee_uniform' (no shadow rays) all channels equal."""

import os

import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.models.renderer import Renderer, trace_sample

from tests.test_torch_scene import golden_scene

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "frames.npz")
CASES = {  # tests/test_golden.py's CASES of the ADVANCED mode
    "advanced": RenderSettings(render_mode=RenderMode.ADVANCED),
    "advanced_nonee_uniform": RenderSettings(
        render_mode=RenderMode.ADVANCED, next_event_estimation=False,
        cosine_weighted_diffuse=False),
}
EQUAL_SHARE_MIN, MEAN_MAX, MAX_MAX = 0.995, 0.05, 32


def _render(settings, frames=3):
    r = Renderer(golden_scene(tscene, tmat, tmesh),
                 camera=CameraConfig(pos=(0.0, 0.5, 7.0)),
                 config=RenderConfig(width=96, height=54, seed=0x12345678),
                 settings=settings, device="cpu")
    r.render(frames)
    return r


@pytest.mark.parametrize("name", list(CASES))
def test_golden_frames(name):
    r = _render(CASES[name])
    got = r.image_u32()
    ref = np.load(GOLDENS)[name]
    assert got.shape == ref.shape and got.dtype == ref.dtype
    a = got.view(np.uint8).astype(np.int64)
    b = ref.view(np.uint8).astype(np.int64)
    delta = np.abs(a - b)
    assert (delta == 0).mean() >= EQUAL_SHARE_MIN, (delta == 0).mean()
    assert delta.mean() <= MEAN_MAX, delta.mean()
    assert delta.max() <= MAX_MAX, delta.max()
    assert r.num_accumulated == 3
    assert r.stats.traced_rays > 96 * 54
    assert np.isfinite(r.mean_energy) and r.mean_energy > 0.0


def test_reset_and_unsupported_modes():
    """reset() zeroes the accumulator and its counters.  Every render
    mode has a Renderer; the one mode with no single-integrator trace,
    COMPARISON (render_frame splits it), is refused by trace_sample."""
    r = _render(CASES["advanced"], frames=1)
    r.reset()
    assert r.num_accumulated == 0 and r.mean_energy == 0.0
    assert float(r._accumulator.abs().sum()) == 0.0
    for mode in RenderMode:
        Renderer(golden_scene(tscene, tmat, tmesh),
                 settings=RenderSettings(render_mode=mode), device="cpu")
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        trace_sample(r.scene.device("cpu"),
                     RenderSettings(render_mode=RenderMode.COMPARISON), o, o,
                     torch.ones(4, dtype=torch.int64), None)


def test_renderer_keeps_camera_arrays():
    """The camera's device arrays are made once per camera, not per
    frame: on the card each upload from pageable memory would wait for
    the stream."""
    r = _render(CASES["advanced"], frames=1)
    first = r._camera_arrays()
    r.render_frame()
    assert r._camera_arrays() is first
    r.camera = CameraConfig(pos=(0.0, 0.5, 6.0))
    moved = r._camera_arrays()
    assert moved is not first and float(moved.pos[2]) == 6.0
