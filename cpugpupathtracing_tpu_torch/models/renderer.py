"""Progressive renderer: the frame driver (the JAX package's
models/renderer.py, ADVANCED and WHITTED modes).

One frame: camera rays in pixel-block order (coherent rays for the
kernels; RNG streams key on the true pixel index, so the image does not
depend on the order), per-lane seeds, the trace through the route the
JAX package's gates choose (`trace_sample`: for ADVANCED the whole-frame
kernel with the split-span schedule, else the per-depth pipeline, else
the XLA integrator trace_advanced; for WHITTED the whole-frame Whitted
kernel, else the per-depth trace_whitted), the return to row-major
order, the accumulation into a device framebuffer and the RGBA8 pack.
A debug view (RAY_DEPTH, BVH_DEPTH) bypasses the accumulation as the
reference does: the pixels show the current frame and the accumulator
is left alone.  The Renderer keeps the reference's accumulator policy (a
camera move resets it; settings toggles and debug-view changes do not)
and the stats panel's counters (Source/Main.cpp:691-755, :841-857).

The BRUTE_FORCE and COMPARISON modes (ROADMAP.md A17) and the checkpoint
wait for later slices of the port and raise here.  The JAX package's
one-time fallback when a kernel fails to compile is not ported: a failed
build or launch raises.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    DebugRenderMode,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import camera as camlib
from cpugpupathtracing_tpu_torch.models import integrators, whitted
from cpugpupathtracing_tpu_torch.models.scene import (
    DeviceScene,
    Scene,
    megakernel_active,
    pt_frame_active,
    whitted_kernel_active,
)
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.utils import rng as rnglib
from cpugpupathtracing_tpu_torch.utils.device import resolve_device
from cpugpupathtracing_tpu_torch.utils.vecmath import fdiv, vec4_to_uint


def _check_supported(settings: RenderSettings) -> None:
    if settings.render_mode not in (RenderMode.ADVANCED, RenderMode.WHITTED):
        raise NotImplementedError(
            f"render mode {settings.render_mode.name} is not ported yet "
            "(ROADMAP.md A17)")


def trace_sample(dev: DeviceScene, settings: RenderSettings, origin,
                 direction, state, idx):
    """One sample over prepared rays, on the route of the JAX package's
    trace_sample.  ADVANCED without a debug view: the whole-frame kernel
    when pt_frame_active, else the per-depth pipeline when
    megakernel_active; else (AOVs or a debug view, mesh lights over the
    light table, a scene without meshes, CPUGPU_NO_MEGAKERNEL=1) the XLA
    integrator trace_advanced.  WHITTED: the whole-frame Whitted kernel
    when whitted_kernel_active, else trace_whitted.  The JAX package's
    chunking of big batches (trace_chunked) leaves results bitwise
    unchanged and is not ported."""
    plain_view = settings.debug_render_mode == DebugRenderMode.NONE
    if settings.render_mode == RenderMode.WHITTED:
        fn = (whitted.trace_whitted_kernel
              if whitted_kernel_active(dev, settings)
              else whitted.trace_whitted)
    elif pt_frame_active(dev, settings) and plain_view:
        fn = integrators.trace_advanced_frame
    elif megakernel_active(dev, settings) and plain_view:
        fn = integrators.trace_advanced_mega
    else:
        fn = integrators.trace_advanced
    return fn(dev, settings, origin, direction, state, idx=idx)


def render_frame(dev: DeviceScene, cam: camlib.CameraArrays, accumulator,
                 sample_base: int, lane, settings: RenderSettings,
                 width: int, height: int, spp: int, seed: int):
    """One progressive frame of spp samples per pixel, accumulated; in a
    debug view the pixels show this frame's sample / spp and the
    accumulator comes back unchanged (Main.cpp:738-746).

    accumulator: (H*W, 4) f32 running sum; lane: (H*W,) int64 0..H*W-1.
    Returns (accumulator', pixels (H*W,) int64 holding u32 0xAABBGGRR,
    traced rays () int64, energy_sum () f32)."""
    _check_supported(settings)
    n = width * height
    bs = camlib.block_shape(width, height)
    if bs is not None:
        bh, bw = bs
        origin, direction, pix = camlib.blocked_lane_rays(
            cam, lane, width, height, bh, bw)
    else:
        origin, direction = camlib.lane_rays(cam, lane, width, height)
        pix = lane
    frame_energy = torch.zeros((n, 3), dtype=torch.float32,
                               device=lane.device)
    traced = torch.zeros((), dtype=torch.int64, device=lane.device)
    # lane identities for wavefront sorting; CPUGPU_NO_SORT=1 drops them
    # (A/B runs), which sends a big tree to the unsorted per-depth route
    idx = None if os.environ.get("CPUGPU_NO_SORT") == "1" else lane
    for s in range(spp):
        stream = (sample_base + s) & 0xFFFFFFFF
        state = rnglib.seed_lanes(pix, stream, salt=seed & 0xFFFFFFFF)
        _, res = trace_sample(dev, settings, origin, direction, state, idx)
        frame_energy = frame_energy + res.energy
        traced = traced + res.traced_rays
    if bs is not None:
        frame_energy = camlib.unblock_image(frame_energy, width, height,
                                            bh, bw)
    energy_sum = torch.sum(frame_energy) * 0.001
    sample = torch.cat([frame_energy,
                        torch.full((n, 1), float(spp), dtype=torch.float32,
                                   device=lane.device)], dim=1)
    if settings.debug_render_mode == DebugRenderMode.NONE:
        accumulator = accumulator + sample
        num = accumulator[:, 3:4]
        pixels = vec4_to_uint(accumulator / torch.clamp(num, min=1.0))
    else:
        pixels = vec4_to_uint(fdiv(sample, float(spp)))
    return accumulator, pixels, traced, energy_sum


class Statistics:
    """Stats panel counters (Source/Main.cpp:218-226, :841-857)."""

    def __init__(self):
        self.traced_rays = 0          # last frame
        self.total_traced_rays = 0
        self.frame_time_ms = 0.0
        self.fps = 0.0

    def reset(self):
        self.traced_rays = 0


class Renderer:
    """Progressive renderer (ADVANCED or WHITTED) on one device (default: the
    card; pass device="cpu" to run the plain PyTorch versions)."""

    def __init__(self, scene: Scene, camera: CameraConfig | None = None,
                 config: RenderConfig | None = None,
                 settings: RenderSettings | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.scene = scene
        self.camera = camera or CameraConfig()
        self.config = config or RenderConfig()
        self.settings = settings or RenderSettings()
        _check_supported(self.settings)
        self.stats = Statistics()
        self.num_accumulated = 0
        self.total_energy_received = 0.0  # float64 host accumulation
        self._sample_counter = 0
        n = self.config.width * self.config.height
        self._accumulator = torch.zeros((n, 4), dtype=torch.float32,
                                        device=self.device)
        self._pixels = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._lane = torch.arange(n, dtype=torch.int64, device=self.device)
        # the camera's device arrays, made again only when the camera
        # changes: an upload from pageable memory would synchronise the
        # host with the stream every frame
        self._cam: tuple | None = None

    def _camera_arrays(self) -> camlib.CameraArrays:
        if self._cam is None or self._cam[0] != self.camera:
            self._cam = (self.camera,
                         camlib.to_arrays(self.camera, self.device))
        return self._cam[1]

    def render_frame(self, sync: bool = True):
        """Trace one progressive frame.  sync=False skips the host sync
        and returns the traced-ray count as a device scalar (stats stay
        stale)."""
        t0 = time.perf_counter()
        spp = self.config.samples_per_frame
        acc, pixels, traced, esum = render_frame(
            self.scene.device(self.device),
            self._camera_arrays(),
            self._accumulator, self._sample_counter, self._lane,
            self.settings, self.config.width, self.config.height, spp,
            self.config.seed)
        self._accumulator, self._pixels = acc, pixels
        self._sample_counter += spp
        self.num_accumulated += spp
        if not sync:
            return traced
        self.stats.traced_rays = int(traced)
        self.stats.total_traced_rays += self.stats.traced_rays
        self.total_energy_received += float(esum)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ptf.check_status(self.device)
        dt = time.perf_counter() - t0
        self.stats.frame_time_ms = dt * 1000.0
        self.stats.fps = 1.0 / dt if dt > 0 else 0.0
        return None

    def render(self, frames: int) -> None:
        for _ in range(frames):
            self.render_frame()

    def image_u32(self) -> np.ndarray:
        """(H, W) packed 0xAABBGGRR framebuffer."""
        return self._pixels.cpu().numpy().astype(np.uint32).reshape(
            self.config.height, self.config.width)

    @property
    def mean_energy(self) -> float:
        """total_energy_received / num_accumulated (Main.cpp:848)."""
        if self.num_accumulated == 0:
            return 0.0
        return self.total_energy_received / self.num_accumulated

    def set_debug_mode(self, mode: DebugRenderMode) -> None:
        """Switch the debug view; it does not reset the accumulator
        (Main.cpp:888-905)."""
        self.settings = self.settings.replace(debug_render_mode=mode)

    def reset(self) -> None:
        """ResetAccumulator (Main.cpp:238-243)."""
        self.num_accumulated = 0
        self.total_energy_received = 0.0
        self._accumulator = torch.zeros_like(self._accumulator)
