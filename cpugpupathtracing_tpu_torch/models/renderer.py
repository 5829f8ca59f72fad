"""Progressive renderer: the frame driver (the JAX package's
models/renderer.py, all four render modes).

One frame: camera rays in pixel-block order (coherent rays for the
kernels; RNG streams key on the true pixel index, so the image does not
depend on the order), per-lane seeds, the trace through the route the
JAX package's gates choose (`trace_sample`: for ADVANCED the whole-frame
kernel with the split-span schedule, else the per-depth pipeline, else
the XLA integrator trace_advanced; for BRUTE_FORCE trace_brute; for
WHITTED the whole-frame Whitted kernel, else the per-depth
trace_whitted), the return to row-major order, the accumulation into a
device framebuffer and the RGBA8 pack.  COMPARISON keeps row-major rays
and splits the screen (Main.cpp:719-725): the left width // 2 columns
through trace_brute, the rest through trace_advanced, neither sorted.
A debug view (RAY_DEPTH, BVH_DEPTH) bypasses the accumulation as the
reference does: the pixels show the current frame and the accumulator
is left alone.

The Renderer owns the live state (camera, settings, materials, BVH
build options, pause) with the reference's accumulator policy: a camera
move, a material, sphere or plane edit, a render-mode change and the
pause toggle reset it (Main.cpp:292-296, :263-265, :876-877, :851-854;
Source/Primitives.cpp:385-415); settings toggles, debug-view changes and
a BVH rebuild do not.  A multi-spp frame runs as 1-spp sub-steps
(`Renderer._spp_substeps`), `render_pipelined` queues frames without a
host sync between them, and the stats panel's counters follow
Source/Main.cpp:691-755, :841-857.  Output: the packed framebuffer, RGBA8,
the mean radiance and PNG files (utils/image.py).

The checkpoint is not ported.  The JAX package's one-time fallback when
a kernel fails to compile is not ported either: a failed build or launch
raises.
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
from cpugpupathtracing_tpu_torch.models.materials import Material
from cpugpupathtracing_tpu_torch.models.scene import (
    DeviceScene,
    Scene,
    megakernel_active,
    pt_frame_active,
    whitted_kernel_active,
)
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.utils import image as imagelib
from cpugpupathtracing_tpu_torch.utils import rng as rnglib
from cpugpupathtracing_tpu_torch.utils.device import resolve_device
from cpugpupathtracing_tpu_torch.utils.vecmath import fdiv, vec4_to_uint


def trace_sample(dev: DeviceScene, settings: RenderSettings, origin,
                 direction, state, idx):
    """One sample over prepared rays, on the route of the JAX package's
    trace_sample.  ADVANCED without a debug view: the whole-frame kernel
    when pt_frame_active, else the per-depth pipeline when
    megakernel_active; else (AOVs or a debug view, mesh lights over the
    light table, a scene without meshes, CPUGPU_NO_MEGAKERNEL=1) the XLA
    integrator trace_advanced.  BRUTE_FORCE: trace_brute.  WHITTED: the
    whole-frame Whitted kernel when whitted_kernel_active, else
    trace_whitted.  COMPARISON splits the frame and is render_frame's.
    The JAX package's chunking of big batches (trace_chunked) leaves
    results bitwise unchanged and is not ported."""
    plain_view = settings.debug_render_mode == DebugRenderMode.NONE
    if settings.render_mode == RenderMode.BRUTE_FORCE:
        fn = integrators.trace_brute
    elif settings.render_mode == RenderMode.WHITTED:
        fn = (whitted.trace_whitted_kernel
              if whitted_kernel_active(dev, settings)
              else whitted.trace_whitted)
    elif settings.render_mode != RenderMode.ADVANCED:
        raise ValueError(f"render mode {settings.render_mode!r} has no "
                         "single-integrator trace")
    elif pt_frame_active(dev, settings) and plain_view:
        fn = integrators.trace_advanced_frame
    elif megakernel_active(dev, settings) and plain_view:
        fn = integrators.trace_advanced_mega
    else:
        fn = integrators.trace_advanced
    return fn(dev, settings, origin, direction, state, idx=idx)


def trace_comparison(dev: DeviceScene, settings: RenderSettings, origin,
                     direction, state, width: int, height: int):
    """The COMPARISON split screen (Main.cpp:719-725) over row-major rays:
    the left width // 2 columns through trace_brute, the right
    width - width // 2 through trace_advanced (the XLA integrator), each
    half a dense batch without lane identities, so neither sorts.
    Returns ((H*W, 3) energy in row-major order, traced summed)."""
    half = width // 2
    o2 = origin.reshape(height, width, 3)
    d2 = direction.reshape(height, width, 3)
    s2 = state.reshape(height, width)
    _, res_l = integrators.trace_brute(
        dev, settings, o2[:, :half].reshape(-1, 3),
        d2[:, :half].reshape(-1, 3), s2[:, :half].reshape(-1))
    _, res_r = integrators.trace_advanced(
        dev, settings, o2[:, half:].reshape(-1, 3),
        d2[:, half:].reshape(-1, 3), s2[:, half:].reshape(-1))
    energy = torch.cat([res_l.energy.reshape(height, half, 3),
                        res_r.energy.reshape(height, width - half, 3)],
                       dim=1).reshape(-1, 3)
    return energy, res_l.traced_rays + res_r.traced_rays


def render_frame(dev: DeviceScene, cam: camlib.CameraArrays, accumulator,
                 sample_base: int, lane, settings: RenderSettings,
                 width: int, height: int, spp: int, seed: int):
    """One progressive frame of spp samples per pixel, accumulated; in a
    debug view the pixels show this frame's sample / spp and the
    accumulator comes back unchanged (Main.cpp:738-746).

    accumulator: (H*W, 4) f32 running sum; lane: (H*W,) int64 0..H*W-1.
    Returns (accumulator', pixels (H*W,) int64 holding u32 0xAABBGGRR,
    traced rays () int64, energy_sum () f32)."""
    n = width * height
    comparison = settings.render_mode == RenderMode.COMPARISON
    # COMPARISON keeps row-major rays: its halves are contiguous columns
    bs = None if comparison else camlib.block_shape(width, height)
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
        if comparison:
            energy, tr = trace_comparison(dev, settings, origin, direction,
                                          state, width, height)
        else:
            _, res = trace_sample(dev, settings, origin, direction, state,
                                  idx)
            energy, tr = res.energy, res.traced_rays
        frame_energy = frame_energy + energy
        traced = traced + tr
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
    """Progressive renderer (any render mode) on one device (default: the
    card; pass device="cpu" to run the plain PyTorch versions), with the
    live edits of the reference's panel."""

    def __init__(self, scene: Scene, camera: CameraConfig | None = None,
                 config: RenderConfig | None = None,
                 settings: RenderSettings | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.scene = scene
        self.camera = camera or CameraConfig()
        self.config = config or RenderConfig()
        self.settings = settings or RenderSettings()
        self.pause_rendering = False
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

    # ---- frame loop ----

    def _spp_substeps(self, spp: int) -> bool:
        """True when a frame of spp > 1 samples runs as spp 1-spp
        sub-steps (the JAX package's rule): no debug view (its pixels
        show the whole frame's samples / spp, which a sub-step would
        narrow to the last sample), not COMPARISON (the same), and
        CPUGPU_SPP_UNROLL is not "1" (read at each call).  Sub-steps
        change only the order of the accumulator's float adds: every
        sample's RNG streams key on the global sample counter either way,
        and the traced counts are the same."""
        return (spp > 1
                and self.settings.debug_render_mode == DebugRenderMode.NONE
                and self.settings.render_mode != RenderMode.COMPARISON
                and os.environ.get("CPUGPU_SPP_UNROLL") != "1")

    def _dispatch_frame(self, spp: int):
        """Queue one progressive frame of spp samples, as one render_frame
        of spp samples or as spp sub-steps of one sample each at
        sample_base = the sample counter; no host sync.  Returns (traced,
        energy sum) as device scalars summed over the sub-steps."""
        sub = 1 if self._spp_substeps(spp) else spp
        traced_t = esum_t = None
        ds = self.scene.device(self.device)
        cam = self._camera_arrays()
        for _ in range(spp // sub):
            acc, pixels, traced, esum = render_frame(
                ds, cam, self._accumulator, self._sample_counter, self._lane,
                self.settings, self.config.width, self.config.height, sub,
                self.config.seed)
            self._accumulator, self._pixels = acc, pixels
            self._sample_counter += sub
            self.num_accumulated += sub
            traced_t = traced if traced_t is None else traced_t + traced
            esum_t = esum if esum_t is None else esum_t + esum
        return traced_t, esum_t

    def _finish(self) -> None:
        """Wait for the queued frames and raise on a kernel's error."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ptf.check_status(self.device)

    def render_frame(self, sync: bool = True):
        """Trace one progressive frame (Render(), Main.cpp:691-755); a
        no-op while paused (Main.cpp:693-696).  sync=False skips the host
        sync and returns the traced-ray count as a device scalar (stats
        stay stale)."""
        if self.pause_rendering:
            return None
        t0 = time.perf_counter()
        traced, esum = self._dispatch_frame(self.config.samples_per_frame)
        if not sync:
            return traced
        self.stats.traced_rays = int(traced)
        self.stats.total_traced_rays += self.stats.traced_rays
        self.total_energy_received += float(esum)
        self._finish()
        dt = time.perf_counter() - t0
        self.stats.frame_time_ms = dt * 1000.0
        self.stats.fps = 1.0 / dt if dt > 0 else 0.0
        return None

    def render(self, frames: int) -> None:
        for _ in range(frames):
            self.render_frame()

    def render_pipelined(self, frames: int) -> int:
        """Queue `frames` progressive frames without a host sync between
        them (no int(), float() or synchronize until the last is queued),
        then sync once.  The traced counts and energy sums add up on the
        device.  Returns the total traced rays; the stats hold the span's
        averages per frame.  A no-op while paused."""
        if self.pause_rendering or frames <= 0:
            return 0
        t0 = time.perf_counter()
        spp = self.config.samples_per_frame
        traced_t = esum_t = None
        for _ in range(frames):
            traced, esum = self._dispatch_frame(spp)
            traced_t = traced if traced_t is None else traced_t + traced
            esum_t = esum if esum_t is None else esum_t + esum
        self._finish()
        dt = time.perf_counter() - t0
        total = int(traced_t)
        self.stats.traced_rays = total // frames
        self.stats.total_traced_rays += total
        self.total_energy_received += float(esum_t)
        self.stats.frame_time_ms = dt * 1000.0 / frames
        self.stats.fps = frames / dt if dt > 0 else 0.0
        return total

    # ---- output ----

    def image_u32(self) -> np.ndarray:
        """(H, W) packed 0xAABBGGRR framebuffer."""
        return self._pixels.cpu().numpy().astype(np.uint32).reshape(
            self.config.height, self.config.width)

    def image_rgba8(self) -> np.ndarray:
        """(H, W, 4) uint8 framebuffer."""
        return imagelib.packed_to_rgba8(self.image_u32())

    def radiance(self) -> np.ndarray:
        """(H, W, 3) f32 mean radiance, accumulator / max(samples, 1)."""
        acc = self._accumulator.cpu().numpy()
        num = np.maximum(acc[:, 3:4], 1.0)
        return (acc[:, :3] / num).reshape(self.config.height,
                                          self.config.width, 3)

    def save_png(self, path: str) -> None:
        imagelib.write_png(path, self.image_rgba8())

    @property
    def mean_energy(self) -> float:
        """total_energy_received / num_accumulated (Main.cpp:848)."""
        if self.num_accumulated == 0:
            return 0.0
        return self.total_energy_received / self.num_accumulated

    # ---- invalidation (ResetAccumulator, Main.cpp:238-243) ----

    def reset(self) -> None:
        self.num_accumulated = 0
        self.total_energy_received = 0.0
        self._accumulator = torch.zeros_like(self._accumulator)

    # ---- live edits, with the reference's reset policy ----

    def move_camera(self, delta_pos) -> None:
        """WASD-style translation; any movement resets (Main.cpp:292-296)."""
        p = self.camera.pos
        self.camera = self.camera.replace(
            pos=(p[0] + delta_pos[0], p[1] + delta_pos[1], p[2] + delta_pos[2]))
        self.reset()

    def set_camera(self, camera: CameraConfig) -> None:
        self.camera = camera
        self.reset()

    def set_settings(self, settings: RenderSettings) -> None:
        """Settings toggles do not reset (the reference's quirk); a
        render-mode change does (Main.cpp:876-877)."""
        mode_changed = settings.render_mode != self.settings.render_mode
        self.settings = settings
        if mode_changed:
            self.reset()

    def set_render_mode(self, mode: RenderMode) -> None:
        self.set_settings(self.settings.replace(render_mode=mode))

    def set_debug_mode(self, mode: DebugRenderMode) -> None:
        """Switch the debug view; it does not reset the accumulator
        (Main.cpp:888-905)."""
        self.settings = self.settings.replace(debug_render_mode=mode)

    def set_material(self, index: int, material: Material) -> None:
        """A material edit resets (Main.cpp:263-265)."""
        self.scene.set_material(index, material)
        self.reset()

    def rebuild_bvh(self, obj_index: int, build_option) -> None:
        """The panel's rebuild (Source/BVH.cpp:182-185): the next frame's
        snapshot carries the object's tree under the new option; no
        reset."""
        self.scene.rebuild_bvh(obj_index, build_option)

    def set_sphere(self, obj_index: int, center, radius: float) -> None:
        """A sphere edit resets, like the scene-tree widgets
        (Source/Primitives.cpp:385-398)."""
        self.scene.set_sphere(obj_index, center, radius)
        self.reset()

    def set_plane(self, obj_index: int, point, normal) -> None:
        """A plane edit resets (Source/Primitives.cpp:400-415)."""
        self.scene.set_plane(obj_index, point, normal)
        self.reset()

    def set_paused(self, paused: bool) -> None:
        """The pause checkbox resets on a toggle (Main.cpp:851-854)."""
        if paused != self.pause_rendering:
            self.pause_rendering = paused
            self.reset()
