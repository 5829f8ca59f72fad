"""Configuration dataclasses and enums.

Every runtime-tweakable knob of the reference's ImGui panel
(reference: Source/Main.cpp:838-933) is a field here: max ray depth, the
NEE / cosine-weighted / Russian-roulette toggles (Source/Main.cpp:228-235),
render mode and debug render mode (Source/Main.cpp:172-196), and the BVH
build option (Include/BVH.h:10-16).
"""

from __future__ import annotations

import dataclasses
import enum


class RenderMode(enum.IntEnum):
    """Reference: Source/Main.cpp:172-183."""

    COMPARISON = 0     # split screen: left brute-force, right advanced
    BRUTE_FORCE = 1
    ADVANCED = 2       # NEE + RR + cosine-weighted importance sampling
    WHITTED = 3        # Whitted-style raytracer (reference README.md:41-52 history)


class DebugRenderMode(enum.IntEnum):
    """Reference: Source/Main.cpp:185-196."""

    NONE = 0
    RAY_DEPTH = 1      # green->red heatmap of path depth / max depth
    BVH_DEPTH = 2      # green->red heatmap of interior-node visits / 30


class BuildOption(enum.IntEnum):
    """BVH build heuristics. Reference: Include/BVH.h:10-16.

    SAH_SPLIT_PRIMITIVES in the reference is dead code (its cheapest-cost
    accumulator is never updated, Source/BVH.cpp:279-293, so it always
    degenerates to a single root leaf); here it is implemented correctly.
    """

    NAIVE_SPLIT = 0
    SAH_SPLIT_INTERVALS = 1
    SAH_SPLIT_PRIMITIVES = 2


class DiffusePdfMode(enum.IntEnum):
    """Which hemisphere-pdf constants the 'advanced' integrator uses.

    The reference swaps the pdf constants between its two diffuse-sampling
    branches (Source/Main.cpp:553-564): the cosine-weighted branch divides
    by the *uniform* pdf 1/(2 pi) and the uniform branch divides by the
    *cosine* pdf cos(theta)/pi.  REFERENCE reproduces that behavior exactly
    (required for image parity with the reference); CORRECT uses the
    mathematically right pdf for each branch.
    """

    REFERENCE = 0
    CORRECT = 1


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Live render settings. Reference: Source/Main.cpp:228-235.

    Frozen (hashable) so it can be a static jit argument; the Renderer
    resets the accumulator whenever settings change, mirroring the
    reference's ImGui reset-on-change behavior (Source/Main.cpp:859-908).
    """

    max_ray_depth: int = 5
    next_event_estimation: bool = True
    cosine_weighted_diffuse: bool = True
    russian_roulette: bool = True
    render_mode: RenderMode = RenderMode.ADVANCED
    debug_render_mode: DebugRenderMode = DebugRenderMode.NONE
    diffuse_pdf_mode: DiffusePdfMode = DiffusePdfMode.REFERENCE
    # populate TraceResult.ray_depth / bvh_depth outside the debug render
    # modes (costs one extra sort payload per depth and the kernel's
    # depth accumulation on the packet fast path; debug modes force it)
    track_aovs: bool = False

    @property
    def aovs_active(self) -> bool:
        return self.track_aovs or self.debug_render_mode != DebugRenderMode.NONE

    def replace(self, **kwargs) -> "RenderSettings":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera as an explicit screen plane.

    Matches the reference camera exactly (Source/Main.cpp:94-170): the
    screen plane sits at distance deg2rad(fov_deg) along view_dir, with
    corners at center +- (aspect, 1, 0) -- an axis-aligned plane, so this
    camera translates but does not rotate, exactly like the reference.
    """

    pos: tuple[float, float, float] = (0.0, 0.0, 8.0)
    view_dir: tuple[float, float, float] = (0.0, 0.0, -1.0)
    fov_deg: float = 60.0
    aspect: float = 16.0 / 9.0

    def replace(self, **kwargs) -> "CameraConfig":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level frame configuration (reference hard-codes 1280x720,
    Source/Main.cpp:760-761; here it is configurable)."""

    width: int = 1280
    height: int = 720
    samples_per_frame: int = 1
    seed: int = 0x12345678  # reference RNG seed, Include/Random.h:4

    def replace(self, **kwargs) -> "RenderConfig":
        return dataclasses.replace(self, **kwargs)
