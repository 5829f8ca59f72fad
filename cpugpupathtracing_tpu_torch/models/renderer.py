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
(`spp_substeps`), `render_pipelined` queues frames without a
host sync between them, and the stats panel's counters follow
Source/Main.cpp:691-755, :841-857, and `metrics` serves them as a dict.
Output: the packed framebuffer, RGBA8, the mean radiance and PNG files
(utils/image.py).  `profile` traces frames with torch.profiler,
`validate_frame` renders a frame that raises at its first non-finite
value without committing it, and `save_checkpoint` / `load_checkpoint`
round-trip the progressive state (accumulator, accumulated frames,
sample counter, energy total) through .npz under a fingerprint of the
scene, camera, config and render mode.

The JAX package's one-time fallback when a kernel fails to compile is
not ported: a failed build or launch raises.
"""

from __future__ import annotations

import hashlib
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
from cpugpupathtracing_tpu_torch.utils.log import log_info, log_warn
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


def frame_rays(cam: camlib.CameraArrays, lane, width: int, height: int,
               settings: RenderSettings):
    """Camera rays for `lane` (any subset of the frame's lanes): in
    pixel-block order when the resolution tiles into blocks (coherent rays
    for the kernels), else row-major, and row-major in COMPARISON, whose
    halves are contiguous columns.  Returns (origin, direction, pixel
    index, block shape or None); the pixel index keys the RNG streams, so
    no image depends on the order."""
    comparison = settings.render_mode == RenderMode.COMPARISON
    bs = None if comparison else camlib.block_shape(width, height)
    if bs is not None:
        origin, direction, pix = camlib.blocked_lane_rays(
            cam, lane, width, height, *bs)
    else:
        origin, direction = camlib.lane_rays(cam, lane, width, height)
        pix = lane
    return origin, direction, pix, bs


def trace_streams(dev: DeviceScene, settings: RenderSettings, origin,
                  direction, pix, idx, streams, seed: int, width: int,
                  height: int):
    """One sample per RNG stream over prepared rays, summed in stream
    order from zeros: ((N, 3) energy in the rays' order, traced () int64).
    idx: lane identities for the wavefront sort (0..N-1) or None."""
    energy = torch.zeros((pix.shape[0], 3), dtype=torch.float32,
                         device=pix.device)
    traced = torch.zeros((), dtype=torch.int64, device=pix.device)
    for stream in streams:
        state = rnglib.seed_lanes(pix, stream & 0xFFFFFFFF,
                                  salt=seed & 0xFFFFFFFF)
        if settings.render_mode == RenderMode.COMPARISON:
            e, tr = trace_comparison(dev, settings, origin, direction,
                                     state, width, height)
        else:
            _, res = trace_sample(dev, settings, origin, direction, state,
                                  idx)
            e, tr = res.energy, res.traced_rays
        energy = energy + e
        traced = traced + tr
    return energy, traced


def sort_ids(lane):
    """The lane identities trace_sample sorts by, or None under
    CPUGPU_NO_SORT=1 (A/B runs; a big tree then takes the unsorted
    per-depth route)."""
    return None if os.environ.get("CPUGPU_NO_SORT") == "1" else lane


def accumulate(accumulator, frame_energy, spp: int,
               settings: RenderSettings):
    """Add one frame's (N, 3) energy of spp samples a lane to the
    accumulator and pack the pixels; in a debug view the pixels show this
    frame's energy / spp and the accumulator comes back unchanged
    (Main.cpp:738-746).  Returns (accumulator', pixels (N,) int64 holding
    u32 0xAABBGGRR, energy_sum () f32)."""
    energy_sum = torch.sum(frame_energy) * 0.001
    sample = torch.cat([frame_energy,
                        torch.full((frame_energy.shape[0], 1), float(spp),
                                   dtype=torch.float32,
                                   device=frame_energy.device)], dim=1)
    if settings.debug_render_mode == DebugRenderMode.NONE:
        accumulator = accumulator + sample
        num = accumulator[:, 3:4]
        pixels = vec4_to_uint(accumulator / torch.clamp(num, min=1.0))
    else:
        pixels = vec4_to_uint(fdiv(sample, float(spp)))
    return accumulator, pixels, energy_sum


def trace_frame(dev: DeviceScene, cam: camlib.CameraArrays, lane,
                settings: RenderSettings, width: int, height: int, spp: int,
                seed: int, sample_base: int):
    """spp samples of every lane at streams sample_base .. + spp - 1:
    ((H*W, 3) energy in row-major order, traced () int64)."""
    origin, direction, pix, bs = frame_rays(cam, lane, width, height,
                                            settings)
    energy, traced = trace_streams(
        dev, settings, origin, direction, pix, sort_ids(lane),
        range(sample_base, sample_base + spp), seed, width, height)
    if bs is not None:
        energy = camlib.unblock_image(energy, width, height, *bs)
    return energy, traced


def render_frame(dev: DeviceScene, cam: camlib.CameraArrays, accumulator,
                 sample_base: int, lane, settings: RenderSettings,
                 width: int, height: int, spp: int, seed: int):
    """One progressive frame of spp samples per pixel, accumulated
    (trace_frame, then accumulate).

    accumulator: (H*W, 4) f32 running sum; lane: (H*W,) int64 0..H*W-1.
    Returns (accumulator', pixels (H*W,) int64 holding u32 0xAABBGGRR,
    traced rays () int64, energy_sum () f32)."""
    energy, traced = trace_frame(dev, cam, lane, settings, width, height,
                                 spp, seed, sample_base)
    accumulator, pixels, energy_sum = accumulate(accumulator, energy, spp,
                                                 settings)
    return accumulator, pixels, traced, energy_sum


def spp_substeps(spp: int, settings: RenderSettings) -> bool:
    """True when a frame of spp > 1 samples runs as spp 1-spp sub-steps
    (the JAX package's rule): no debug view (its pixels show the whole
    frame's samples / spp, which a sub-step would narrow to the last
    sample), not COMPARISON (the same), and CPUGPU_SPP_UNROLL is not "1"
    (read at each call).  Sub-steps change only the order of the
    accumulator's float adds: every sample's RNG streams key on the
    global sample counter either way, and the traced counts are the
    same."""
    return (spp > 1
            and settings.debug_render_mode == DebugRenderMode.NONE
            and settings.render_mode != RenderMode.COMPARISON
            and os.environ.get("CPUGPU_SPP_UNROLL") != "1")


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
        return spp_substeps(spp, self.settings)

    def _frame_state(self, spp: int, keep_energy: bool = False):
        """Queue one progressive frame of spp samples from the committed
        state, as one render_frame of spp samples or as spp sub-steps of
        one sample each at sample_base = the sample counter, and store
        nothing; no host sync.  Returns (accumulator', pixels, traced,
        energy sum, energies): traced and the energy sum are device
        scalars summed over the sub-steps; energies lists each sub-step's
        (H*W, 3) row-major energy when keep_energy, else it is empty."""
        sub = 1 if spp_substeps(spp, self.settings) else spp
        ds = self.scene.device(self.device)
        cam = self._camera_arrays()
        acc, pixels = self._accumulator, self._pixels
        counter = self._sample_counter
        traced_t = esum_t = None
        energies = []
        for _ in range(spp // sub):
            energy, traced = trace_frame(
                ds, cam, self._lane, self.settings, self.config.width,
                self.config.height, sub, self.config.seed, counter)
            acc, pixels, esum = accumulate(acc, energy, sub, self.settings)
            if keep_energy:
                energies.append(energy)
            counter += sub
            traced_t = traced if traced_t is None else traced_t + traced
            esum_t = esum if esum_t is None else esum_t + esum
        return acc, pixels, traced_t, esum_t, energies

    def _commit(self, acc, pixels, spp: int) -> None:
        self._accumulator, self._pixels = acc, pixels
        self._sample_counter += spp
        self.num_accumulated += spp

    def _dispatch_frame(self, spp: int):
        """Queue one progressive frame of spp samples and commit it (the
        accumulator, the pixels and the counters); no host sync.  Returns
        (traced, energy sum) as device scalars summed over the
        sub-steps."""
        acc, pixels, traced, esum, _ = self._frame_state(spp)
        self._commit(acc, pixels, spp)
        return traced, esum

    def _finish(self) -> None:
        """Wait for the queued frames and raise on a kernel's error."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ptf.check_status(self.device)

    def _frame_stats(self, traced, esum, t0: float) -> None:
        """Sync one rendered frame into the stats panel's counters."""
        self.stats.traced_rays = int(traced)
        self.stats.total_traced_rays += self.stats.traced_rays
        self.total_energy_received += float(esum)
        self._finish()
        dt = time.perf_counter() - t0
        self.stats.frame_time_ms = dt * 1000.0
        self.stats.fps = 1.0 / dt if dt > 0 else 0.0

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
        self._frame_stats(traced, esum, t0)
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

    def metrics(self) -> dict:
        """Every stats-panel number (Main.cpp:841-857) as a dict, with
        the derived Mrays/s and the scene tree's per-object readout
        (Source/BVH.cpp:149-186), under the JAX package's keys."""
        dt_s = self.stats.frame_time_ms / 1000.0
        return {
            "fps": self.stats.fps,
            "frame_time_ms": self.stats.frame_time_ms,
            "traced_rays": self.stats.traced_rays,
            "total_traced_rays": self.stats.total_traced_rays,
            "mrays_per_s": (self.stats.traced_rays / dt_s / 1e6
                            if dt_s > 0 else 0.0),
            "accumulated_frames": self.num_accumulated,
            "mean_energy": self.mean_energy,
            "paused": self.pause_rendering,
            "objects": self.scene.object_stats(),
        }

    def profile(self, log_dir: str):
        """Context manager that traces the frames rendered inside it with
        torch.profiler (host activity, and the card's when the renderer
        runs there) and writes a Chrome trace into log_dir
        (<host>_<pid>.<ns>.pt.trace.json) on exit."""
        from torch.profiler import (
            ProfilerActivity,
            profile,
            tensorboard_trace_handler,
        )

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(log_dir))

    def validate_frame(self) -> None:
        """Render one frame (every sub-step) and raise FloatingPointError
        at its first non-finite value, the port's stand-in for the JAX
        package's debug_nans frame.  Every sub-step's energy and the new
        accumulator are checked with torch.isfinite before anything is
        stored; on a bad frame the accumulator, the counters, the energy
        total and the stats stay as they were.  A no-op while paused."""
        if self.pause_rendering:
            return
        t0 = time.perf_counter()
        spp = self.config.samples_per_frame
        acc, pixels, traced, esum, energies = self._frame_state(
            spp, keep_energy=True)
        width = self.config.width
        for what, arr in [(f"sub-step {k} energy", e)
                          for k, e in enumerate(energies)] + [
                              ("accumulator", acc)]:
            bad = ~torch.isfinite(arr).all(dim=1)
            if bool(bad.any()):
                lane = int(torch.nonzero(bad)[0, 0])
                raise FloatingPointError(
                    f"validate_frame: non-finite {what} at lane {lane} "
                    f"(pixel x={lane % width}, y={lane // width}): "
                    f"{arr[lane].tolist()}")
        self._commit(acc, pixels, spp)
        self._frame_stats(traced, esum, t0)

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

    # ---- checkpoint / resume ----

    def _fingerprint(self) -> str:
        """Checkpoint validity key: scene geometry and materials, camera,
        config and render mode (the JAX package's policy).  Settings
        toggles (max depth, NEE, cosine, RR) are left out: in the
        reference they do not reset the live accumulator (Main.cpp:859-877),
        so they must not invalidate a saved one either.  The port hashes
        its own tables -- the node rows of the snapshot's walk (pnodes, or
        an XLA walk's nodes8 / wnodes / snodes12), tris9, and the albedo
        (mk_mats columns 0:3) and emission (9:12) -- so a checkpoint of
        one package does not load in the other."""
        h = hashlib.sha256()
        dev = self.scene.device(self.device)
        for arr in (dev.node_table, dev.tris9, dev.mk_mats[:, 0:3],
                    dev.mk_mats[:, 9:12]):
            h.update(arr.contiguous().cpu().numpy().tobytes())
        h.update(repr((self.camera, self.config,
                       self.settings.render_mode)).encode())
        return h.hexdigest()[:16]

    def save_checkpoint(self, path: str) -> None:
        """Write the progressive state (.npz, the JAX package's keys:
        accumulator, num_accumulated, sample_counter, total_energy,
        fingerprint)."""
        np.savez_compressed(
            path,
            accumulator=self._accumulator.cpu().numpy(),
            num_accumulated=self.num_accumulated,
            sample_counter=self._sample_counter,
            total_energy=self.total_energy_received,
            fingerprint=self._fingerprint(),
        )
        log_info("Renderer", "checkpoint saved to {} ({} frames)", path,
                 self.num_accumulated)

    def load_checkpoint(self, path: str) -> bool:
        """Resume accumulation from save_checkpoint's file onto the
        renderer's device; returns False, and resets, when the
        fingerprint differs."""
        data = np.load(path, allow_pickle=False)
        if str(data["fingerprint"]) != self._fingerprint():
            log_warn("Renderer", "checkpoint fingerprint mismatch; "
                     "starting fresh")
            self.reset()
            return False
        self._accumulator = torch.from_numpy(
            np.ascontiguousarray(data["accumulator"], np.float32)).to(
                self.device)
        self.num_accumulated = int(data["num_accumulated"])
        self._sample_counter = int(data["sample_counter"])
        self.total_energy_received = float(data["total_energy"])
        log_info("Renderer", "resumed at {} accumulated frames",
                 self.num_accumulated)
        return True
