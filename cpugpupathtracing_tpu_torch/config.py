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
import os


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


# The node-table variables of the JAX package (its models/scene.py and
# ops/traverse_packet_slim.py), read by models/scene.py whenever a scene
# is built.  A variable that is unset takes the value of the JAX
# package's benchmark flags (bench_flags_default.json, which its bench.py
# applies), kept here as constants: the port's default tables are those
# of the JAX benchmark.
PACKET_FLAG_DEFAULTS = {
    "CPUGPU_PACKET_TREE": "sweep_dp",
    "CPUGPU_OCCL": "1",
    "CPUGPU_SMEMTREE": "48",
    "CPUGPU_FRAMESTACK": "1",
}
PACKET_TREE_MODES = ("fat", "dp", "sweep", "sweep_dp", "w16")


@dataclasses.dataclass(frozen=True)
class PacketFlags:
    """The node-table choices of one scene build.

    tree: how each mesh's closest-hit tree is built (CPUGPU_PACKET_TREE;
      "" means fat, as in the JAX package): fat / sweep = greedy collapse
      of a fat-leaf binary build (the object's heuristic / full-sweep
      SAH), dp / sweep_dp = SAH-cost DP collapse, w16 = full-sweep SAH and
      a 16-wide DP collapse, kept only on scenes without the object-space
      instance machinery.
    occl: occlusion any-hit tables beside the shading tables (CPUGPU_OCCL).
    fused: one node|leaf table (CPUGPU_FUSED).
    smemtree: "1" = entry side tables, "48" = side tables and 48-col
      bounds-only rows, else off (CPUGPU_SMEMTREE).
    smem_min_nodes: trees of fewer node rows hand the side tables to the
      whole-frame kernel only (CPUGPU_SMEMTREE_MIN_NODES).
    framestack, rowx: the JAX package's TPU schedule flags
      (CPUGPU_FRAMESTACK, CPUGPU_ROWX), read only for its condition on
      the 48-col rows; the port has no schedule they select."""

    tree: str = "sweep_dp"
    occl: bool = True
    fused: bool = False
    smemtree: str = "48"
    smem_min_nodes: int = 2048
    framestack: bool = True
    rowx: int = 1


def packet_flags() -> PacketFlags:
    """The PacketFlags of the environment as it is now."""
    def env(name):
        v = os.environ.get(name)
        return PACKET_FLAG_DEFAULTS.get(name, "") if v is None else v

    tree = env("CPUGPU_PACKET_TREE") or "fat"
    if tree not in PACKET_TREE_MODES:
        raise ValueError(f"unknown CPUGPU_PACKET_TREE '{tree}' (one of "
                         f"{', '.join(PACKET_TREE_MODES)})")
    return PacketFlags(
        tree=tree,
        occl=env("CPUGPU_OCCL") == "1",
        fused=env("CPUGPU_FUSED") == "1",
        smemtree=env("CPUGPU_SMEMTREE"),
        smem_min_nodes=int(env("CPUGPU_SMEMTREE_MIN_NODES") or "2048"),
        framestack=env("CPUGPU_FRAMESTACK") == "1",
        rowx=int(env("CPUGPU_ROWX") or "1"),
    )
