"""Multi-GPU rendering over torch.distributed (the JAX package's
parallel/sharding.py), one process per card.

The reference's only parallelism is data-parallel pixel tiles on a
shared-memory thread pool with a per-frame barrier
(Source/ThreadPool.cpp:135-179, Source/Main.cpp:753-754).  Two
decompositions of a frame over d ranks, as in the JAX package:

  * pixels: rank r traces the contiguous slice [r n/d, (r+1) n/d) of the
    frame's lanes in the order render_frame traces them (pixel blocks when
    the resolution tiles, else row-major) and keeps its accumulator and
    pixels as that slice, in that order.  No collective runs but the sum
    of the traced counts until the host gathers the image (gather_frame,
    which puts the slices together in rank order and unblocks them).  The
    RNG keys on the true pixel index, the sort on the slice's own lane
    identities (0 .. n/d - 1), and a frame of spp > 1 runs as the
    Renderer's 1-spp sub-steps (renderer.spp_substeps), so the gathered
    accumulator and pixels equal one card's Renderer frames bitwise.
  * samples: every rank traces the whole frame at its own RNG streams
    (sample_base + r spp + s); the ranks' energies are gathered and summed
    in rank order from zeros (not all_reduce, whose order is not fixed),
    and every rank keeps the whole row-major accumulator, spp d samples a
    frame.  At spp = 1 this equals bitwise one card's frame of d spp
    traced unrolled (CPUGPU_SPP_UNROLL=1); at spp > 1 the float adds
    group by rank and the image differs from it by rounding.

The scene tables are replicated: each rank builds its own snapshot.
`trace_rank` and `render_rank` are one rank's work without a collective,
so rank r of d can run for every r in one process (the tests;
chip_smoke.py on one card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cpugpupathtracing_tpu_torch.config import RenderMode, RenderSettings
from cpugpupathtracing_tpu_torch.models import camera as camlib
from cpugpupathtracing_tpu_torch.models.renderer import (
    accumulate,
    frame_rays,
    sort_ids,
    spp_substeps,
    trace_streams,
)
from cpugpupathtracing_tpu_torch.models.scene import DeviceScene
from cpugpupathtracing_tpu_torch.parallel import distributed
from cpugpupathtracing_tpu_torch.parallel.distributed import RankMesh

SHARD_MODES = ("pixels", "samples")


def make_mesh(n_devices: int | None = None, device="cuda") -> RankMesh:
    """The process group as a mesh (distributed.global_mesh); n_devices,
    when given, must be the group's size."""
    mesh = distributed.global_mesh(device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"asked for {n_devices} devices; the process group "
                         f"has {mesh.size} (one card per process)")
    return mesh


def check_frame(width: int, height: int, world: int,
                settings: RenderSettings, shard_mode: str) -> None:
    """The JAX package's refusals: a pixel count the ranks do not divide,
    COMPARISON (a single-card split-screen view) and an unknown mode."""
    if shard_mode not in SHARD_MODES:
        raise ValueError(f"unknown shard_mode {shard_mode!r}")
    if (width * height) % world != 0:
        raise ValueError(f"pixel count {width * height} not divisible by "
                         f"{world} devices")
    if settings.render_mode == RenderMode.COMPARISON:
        raise ValueError("COMPARISON is a single-card split-screen view; "
                         "render it with Renderer")


def accumulator_shape(width: int, height: int, world: int,
                      shard_mode: str) -> tuple:
    """One rank's accumulator: its (n/d, 4) lane slice in pixels mode,
    the whole (n, 4) frame in samples mode."""
    n = width * height
    return (n // world if shard_mode == "pixels" else n, 4)


def trace_rank(dev: DeviceScene, cam: camlib.CameraArrays,
               settings: RenderSettings, width: int, height: int, spp: int,
               seed: int, sample_base: int, rank: int, world: int,
               shard_mode: str = "pixels"):
    """Rank `rank` of `world`'s samples of one frame, without a
    collective: (energy, traced () int64).  Pixels mode: the (n/d, 3)
    energy of the rank's lane slice in its traced order, spp samples at
    streams sample_base + s.  Samples mode: the (n, 3) row-major energy
    of the whole frame, spp samples at streams sample_base + rank spp + s."""
    check_frame(width, height, world, settings, shard_mode)
    n = width * height
    device = dev.device
    if shard_mode == "pixels":
        m = n // world
        lane = torch.arange(rank * m, (rank + 1) * m, dtype=torch.int64,
                            device=device)
        # the sort's lane identities index the slice: 0 .. m - 1
        idx = sort_ids(lane - rank * m)
        base = sample_base
    else:
        lane = torch.arange(n, dtype=torch.int64, device=device)
        idx = sort_ids(lane)
        base = sample_base + rank * spp
    origin, direction, pix, bs = frame_rays(cam, lane, width, height,
                                            settings)
    energy, traced = trace_streams(dev, settings, origin, direction, pix,
                                   idx, range(base, base + spp), seed, width,
                                   height)
    if shard_mode == "samples" and bs is not None:
        energy = camlib.unblock_image(energy, width, height, *bs)
    return energy, traced


def render_rank(dev: DeviceScene, cam: camlib.CameraArrays, accumulator,
                sample_base: int, settings: RenderSettings, width: int,
                height: int, spp: int, seed: int, rank: int, world: int):
    """Rank `rank` of `world`'s pixels-mode frame, without a collective:
    its (n/d, 4) accumulator slice plus spp samples, in the Renderer's
    sub-steps.  Returns (accumulator', pixels, traced, energy_sum), the
    last two this rank's own, summed over the sub-steps."""
    sub = 1 if spp_substeps(spp, settings) else spp
    traced = energy_sum = None
    for base in range(sample_base, sample_base + spp, sub):
        energy, tr = trace_rank(dev, cam, settings, width, height, sub,
                                seed, base, rank, world, "pixels")
        accumulator, pixels, es = accumulate(accumulator, energy, sub,
                                             settings)
        traced = tr if traced is None else traced + tr
        energy_sum = es if energy_sum is None else energy_sum + es
    return accumulator, pixels, traced, energy_sum


def ordered_sum(parts) -> torch.Tensor:
    """zeros + parts[0] + parts[1] + ..., in list order: the samples
    mode's sum of the ranks' energies, in the order render_frame adds a
    frame's samples."""
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def render_frame_sharded(dev: DeviceScene, cam: camlib.CameraArrays,
                         accumulator, sample_base: int,
                         settings: RenderSettings, width: int, height: int,
                         spp: int, seed: int, mesh: RankMesh,
                         shard_mode: str = "pixels"):
    """One progressive frame over the process group, run on every rank.

    accumulator: this rank's (accumulator_shape) f32 running sum on its
    card.  Returns (accumulator', pixels int64 holding u32 0xAABBGGRR,
    traced () int64 summed over the ranks, energy_sum () f32): in pixels
    mode the accumulator and pixels are the rank's lane slice in its
    traced order and energy_sum is the rank's own; in samples mode they
    are the whole frame, row-major, on every rank (spp * d samples a
    frame), and energy_sum is the frame's.  gather_frame puts either
    together.  Collectives run whenever a process group is up, also at
    one rank."""
    d = mesh.size
    check_frame(width, height, d, settings, shard_mode)
    if d > 1 and not dist.is_initialized():
        raise RuntimeError(f"a mesh of {d} ranks needs a process group "
                           "(maybe_initialize_distributed)")
    grouped = dist.is_initialized()
    if shard_mode == "pixels":
        acc, pixels, traced, energy_sum = render_rank(
            dev, cam, accumulator, sample_base, settings, width, height,
            spp, seed, mesh.rank, d)
        if grouped:
            dist.all_reduce(traced)
        return acc, pixels, traced, energy_sum
    energy, traced = trace_rank(dev, cam, settings, width, height, spp, seed,
                                sample_base, mesh.rank, d, shard_mode)
    parts = [energy]
    if grouped:
        dist.all_reduce(traced)
        energy = energy.contiguous()
        parts = [torch.empty_like(energy) for _ in range(d)]
        dist.all_gather(parts, energy)
    acc, pixels, energy_sum = accumulate(accumulator, ordered_sum(parts),
                                         spp * d, settings)
    return acc, pixels, traced, energy_sum


def gather_frame(x: torch.Tensor, width: int, height: int,
                 shard_mode: str) -> np.ndarray:
    """The whole frame of a per-rank accumulator or pixels array, row-major,
    as numpy on every rank.  Pixels mode: the ranks' slices all-gathered
    in rank order (distributed.gather_image_to_host), then unblocked when
    the resolution tiles into pixel blocks (a resolution that does not
    tile was traced row-major).  Samples mode: every rank holds the whole
    frame already."""
    if shard_mode not in SHARD_MODES:
        raise ValueError(f"unknown shard_mode {shard_mode!r}")
    if shard_mode == "samples":
        return x.cpu().numpy()
    whole = distributed.gather_image_to_host(x)
    bs = camlib.block_shape(width, height)
    if bs is None:
        return whole
    return camlib.unblock_image(torch.from_numpy(whole), width, height,
                                *bs).numpy()
