"""TracePathAdvanced (Source/Main.cpp:396-579) over a frame of rays,
through the whole-frame path-tracing kernel (ops/pt_frame.py).

The port of the JAX package's `integrators.trace_advanced_frame` with the
split-span schedule: depths [0, K) in one launch with the carry out, ONE
wavefront sort of the carry by the morton8 coherence key, depths [K, end)
in a second launch with the carry in, and the restore of lane order.
Sorting permutes whole lanes and every lane's RNG stream is its own, so
the per-lane result equals the single span bitwise (tests pin it).  K is
2 when a path has more than three depths, as in the JAX package.

Only the ADVANCED mode without AOVs is ported in this slice; NEE, cosine
sampling, Russian roulette and the diffuse-pdf mode are all honoured.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cpugpupathtracing_tpu_torch.config import DiffusePdfMode, RenderSettings
from cpugpupathtracing_tpu_torch.models.scene import (
    MORTON_BITS,
    DeviceScene,
    reorder_key,
)
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

# bit of the morton8 key that holds (1 - active) (scene.reorder_key)
ACTIVE_BIT = 3 * MORTON_BITS + 3
# is_specular rides bit 30 of the lane id through the sort
SPEC_BIT = 30
# depths of the first span (the JAX package's measured K = 2)
SPLIT = 2


class TraceResult(NamedTuple):
    energy: torch.Tensor       # (N, 3) f32 radiance estimate per lane
    traced_rays: torch.Tensor  # () int64: scene + shadow traversals


def frame_kwargs(dev: DeviceScene, settings: RenderSettings) -> dict:
    """The static keyword arguments of pt_frame for this scene/settings."""
    return dict(
        roots=dev.proots,
        num_mats=dev.num_mats,
        num_lights=dev.num_lights,
        num_sph=dev.num_sph,
        num_pln=dev.num_pln,
        num_objs=dev.num_objs,
        nee=settings.next_event_estimation and dev.num_lights > 0,
        rr=settings.russian_roulette,
        cosine=settings.cosine_weighted_diffuse,
        ref_pdf=settings.diffuse_pdf_mode == DiffusePdfMode.REFERENCE,
        sh_nodes=dev.poccl_nodes,
        sh_ltris=dev.poccl_ltris,
        sh_roots=dev.poccl_roots,
        occl=True,
        light_tri_meta=dev.light_tri_meta,
    )


def sort_wavefront(dev: DeviceScene, c: dict) -> dict:
    """Permute every per-lane carry column by the morton8 coherence key
    of the carry's next ray (the AOV-free branch of the JAX package's
    sort_wavefront): active lanes first, then direction octant, then
    origin morton.  `active` rides the key, `is_specular` bit 30 of
    `lane`; the sort is stable, like lax.sort."""
    act = c["active"].to(torch.int64)
    key = reorder_key(dev, torch.stack(c["ray"][0:3], dim=1),
                      torch.stack(c["ray"][3:6], dim=1), act)
    key_s, perm = torch.sort(key, stable=True)
    lane = (c["lane"] | (c["spec"] << SPEC_BIT))[perm]
    return dict(
        ray=tuple(r[perm] for r in c["ray"]),
        state=c["state"][perm],
        tp=tuple(x[perm] for x in c["tp"]),
        en=tuple(x[perm] for x in c["en"]),
        active=(1 - ((key_s >> ACTIVE_BIT) & 1)).to(torch.int32),
        spec=lane >> SPEC_BIT,
        lane=lane & ((1 << SPEC_BIT) - 1),
    )


def restore_lane_order(lane: torch.Tensor, cols):
    """Undo wavefront sorting: scatter each column back to its lane id."""
    out = []
    for v in cols:
        r = torch.empty_like(v)
        r[lane.long()] = v
        out.append(r)
    return out


def trace_advanced_frame(dev: DeviceScene, settings: RenderSettings, origin,
                         direction, state, idx=None):
    """TracePathAdvanced of rays origin/direction (N, 3) f32 with RNG
    state (N,) (int64 carrying u32) through pt_frame.  `idx` (N,) are the
    lanes' identities: with them, and more than three depths, the
    split-span schedule runs (2 depths, then the rest); without them one
    span.  Returns (state', TraceResult); state' is that of the last span,
    in lane order."""
    kw = frame_kwargs(dev, settings)
    tables = dev.tables()
    rays = tuple(origin[:, k].contiguous() for k in range(3)) + tuple(
        direction[:, k].contiguous() for k in range(3))
    depths = settings.max_ray_depth + 1
    split = SPLIT if depths > 3 else 0
    if idx is None or not split:
        energy, st, traced = ptf.pt_frame(*tables, rays, state,
                                          depths=depths, **kw)
        return st, TraceResult(energy, traced)

    rays2, st2, tp2, en2, fl2, tr1 = ptf.pt_frame(
        *tables, rays, state, depths=split, carry_out=True, **kw)
    c = sort_wavefront(dev, dict(
        ray=rays2, state=st2, tp=tp2, en=en2, active=fl2 & 1,
        spec=((fl2 >> 1) & 1).to(torch.int32), lane=idx.to(torch.int32)))
    energy3, st3, tr2 = ptf.pt_frame(
        *tables, c["ray"], c["state"], depths=depths - split,
        depth_base=split,
        carry_in=(c["tp"], c["en"], (c["active"] | (c["spec"] << 1))),
        **kw)
    cols = restore_lane_order(
        c["lane"], [energy3[:, 0], energy3[:, 1], energy3[:, 2], st3])
    energy = torch.stack(cols[:3], dim=1)
    return cols[3], TraceResult(energy, tr1 + tr2)
