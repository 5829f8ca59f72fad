"""TracePathAdvanced (Source/Main.cpp:396-579) over a frame of rays, on
either of the JAX package's two kernel routes:

* `trace_advanced_frame`, the whole-frame kernel (ops/pt_frame.py) with
  the split-span schedule: depths [0, K) in one launch with the carry
  out, ONE wavefront sort of the carry by the morton8 coherence key,
  depths [K, end) in a second launch with the carry in, and the restore
  of lane order.  K is CPUGPU_PTFRAME_SPLIT, else 2 when a path has
  more than three depths, as in the JAX package.
* `trace_advanced_mega`, the per-depth pipeline (ops/megakernel.py):
  per depth one `shade_extend` and one `shadow_resolve` launch, with
  wavefront sorts between the first depths (compact after depth 0,
  morton8 after later ones).

Sorting permutes whole lanes and every lane's RNG stream is its own, so
the per-lane energy, state and traced counts of every schedule and of
both routes are bitwise equal (tests pin it).  The gates that choose a
route are in models/scene.py; models/renderer.trace_sample applies them.

Only the ADVANCED mode without AOVs is ported; NEE, cosine sampling,
Russian roulette and the diffuse-pdf mode are all honoured.  The
wavefront sort, the lane-order restore and the material and dielectric
helpers serve the Whitted integrator (models/whitted.py) too.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from cpugpupathtracing_tpu_torch.config import DiffusePdfMode, RenderSettings
from cpugpupathtracing_tpu_torch.models.scene import (
    DeviceScene,
    active_bit,
    ptframe_max_nodes,
    ptframe_split,
    reorder_key,
)
from cpugpupathtracing_tpu_torch.ops import megakernel as mk
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import sampling
from cpugpupathtracing_tpu_torch.utils.vecmath import dot3, normalize, sqrt

# is_specular rides bit 30 of the lane id through the sort
SPEC_BIT = 30
# wavefront sorts run since import (sort_wavefront), counted like the
# kernels' launches so that chip_smoke.py can check the sorts per frame
sorts = 0


class TraceResult(NamedTuple):
    energy: torch.Tensor       # (N, 3) f32 radiance estimate per lane
    traced_rays: torch.Tensor  # () int64: scene + shadow traversals


def extend_kwargs(dev: DeviceScene, settings: RenderSettings) -> dict:
    """The keyword arguments of shade_extend for this scene/settings,
    without the instance tables (DeviceScene.inst_kwargs)."""
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
        light_tri_meta=dev.light_tri_meta,
    )


def frame_kwargs(dev: DeviceScene, settings: RenderSettings) -> dict:
    """The static keyword arguments of pt_frame for this scene/settings."""
    return dict(
        extend_kwargs(dev, settings),
        sh_nodes=dev.poccl_nodes,
        sh_ltris=dev.poccl_ltris,
        sh_roots=dev.poccl_roots,
        occl=True,
    )


def shadow_tables(dev: DeviceScene) -> tuple:
    """(nodes, ltris, keyword arguments) of shadow_resolve: the occlusion
    tables, or on the object-space instance machinery the shading tables
    with the instance tables (the JAX package's instanced arm, which
    builds no occlusion tables)."""
    kw = dict(num_sph=dev.num_sph, num_pln=dev.num_pln)
    if dev.machinery:
        return dev.pnodes, dev.pltris, dict(
            kw, roots=dev.proots, occl=False, **dev.inst_kwargs(nrm=False))
    return dev.poccl_nodes, dev.poccl_ltris, dict(kw, roots=dev.poccl_roots,
                                                   occl=True)


def shadow_kwargs(dev: DeviceScene) -> dict:
    """The keyword arguments of shadow_resolve after its positional
    (nodes, ltris, sph, pln), the tables of shadow_tables."""
    return shadow_tables(dev)[2]


def sort_wavefront(dev: DeviceScene, c: dict, mode: str = "morton8") -> dict:
    """Permute every per-lane carry column by the coherence key of the
    carry's next ray (the AOV-free branch of the JAX package's
    sort_wavefront): "compact" keys on (1 - active) alone, so live lanes
    keep their incoming (camera-blocked) order; "morton5" / "morton8" key
    on active first, then direction octant, then origin morton at 5 / 8
    bits per axis.  The carry holds ray (6 columns), state, tp and en (3
    columns each), active, lane and, on the path tracer's carry, spec
    (the Whitted carry has none).  `active` rides the key, `spec` bit 30
    of `lane`; the sort is stable, like lax.sort."""
    global sorts
    act = c["active"].to(torch.int64)
    if mode == "compact":
        key = 1 - act
    elif mode in ("morton5", "morton8"):
        key = reorder_key(dev, torch.stack(c["ray"][0:3], dim=1),
                          torch.stack(c["ray"][3:6], dim=1), act,
                          bits=5 if mode == "morton5" else 8)
    else:
        raise ValueError(f"sort mode {mode!r} is not ported")
    key_s, perm = torch.sort(key, stable=True)
    sorts += 1
    has_spec = "spec" in c
    lane = c["lane"] | (c["spec"] << SPEC_BIT) if has_spec else c["lane"]
    lane = lane[perm]
    out = dict(
        ray=tuple(r[perm] for r in c["ray"]),
        state=c["state"][perm],
        tp=tuple(x[perm] for x in c["tp"]),
        en=tuple(x[perm] for x in c["en"]),
        active=(1 - ((key_s >> active_bit(mode)) & 1)).to(torch.int32),
        lane=lane,
    )
    if has_spec:
        out.update(spec=lane >> SPEC_BIT, lane=lane & ((1 << SPEC_BIT) - 1))
    return out


def restore_lane_order(lane: torch.Tensor, cols):
    """Undo wavefront sorting: scatter each column ((N,) or (N, k)) back
    to its lane id."""
    out = []
    for v in cols:
        r = torch.empty_like(v)
        r[lane.long()] = v
        out.append(r)
    return out


def _gather_material(dev: DeviceScene, mat_idx) -> dict:
    """Material rows of mat_idx (N,) (GetRayHitResult's
    data.materials[mat_index], Source/Main.cpp:336), from the mk_mats
    columns, under the JAX package's names."""
    m = dev.mk_mats[mat_idx.long()]
    return dict(albedo=m[:, 0:3], specular=m[:, 3], refractivity=m[:, 4],
                absorption=m[:, 5:8], ior=m[:, 8], emissive=m[:, 9:12],
                intensity=m[:, 12], is_light=m[:, 13] > 0.5)


def _dielectric(ray_d, normal, mat):
    """Shared dielectric ingredients (Source/Main.cpp:488-519 and
    :621-653): (tir, inside, refract_dir, Fresnel reflectance) for rays
    and normals (N, 3), in the JAX package's association."""
    cosi_raw = torch.clamp(dot3(normal, ray_d), -1.0, 1.0)
    outside = cosi_raw < 0.0  # reference: inside=false when cosi<0
    inside = ~outside
    cosi = torch.abs(cosi_raw)
    one = torch.ones_like(cosi)
    etai = torch.where(outside, one, mat["ior"])
    etat = torch.where(outside, mat["ior"], one)
    n_ref = torch.where(outside[:, None], normal, -normal)
    eta = etai / etat
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    # the JAX package's sampling.refract: normalize(d eta + (eta cosi -
    # sqrt(max(k, 0))) n)
    coef = eta * cosi - sqrt(torch.clamp(k, min=0.0))
    refract_dir = normalize(ray_d * eta[:, None] + coef[:, None] * n_ref)
    angle_in = dot3(ray_d, normal)
    angle_out = dot3(refract_dir, normal)
    fr = sampling.fresnel(angle_in, angle_out, etai, etat)
    return tir, inside, refract_dir, torch.where(tir, one, fr)


def sorted_shadow_resolve(dev: DeviceScene, so, sd, stmax, flags, en,
                          contrib):
    """shadow_resolve over the shadow rays sorted by their own coherence
    key (reorder_key at 5 bits: sneed first, direction octant, origin
    morton; the JAX package's opt-in depth-0 shadow sort,
    CPUGPU_SHADOW_SORT=1).  The kernel runs on zero energy, so its output
    is each lane's NEE delta (0 + contrib, exact); the sort's permutation
    -- the sorted slot column -- returns the delta to lane order, and the
    same en + delta add as the unsorted kernel follows."""
    sneed = (flags >> 2) & 1
    key = reorder_key(dev, torch.stack(so, dim=1), torch.stack(sd, dim=1),
                      sneed, bits=5)
    key_s, slots = torch.sort(key, stable=True)
    sneed_s = (1 - ((key_s >> active_bit("morton5")) & 1)).to(torch.int32)
    zero = torch.zeros_like(en[0])
    sh_nodes, sh_ltris, sh_kw = shadow_tables(dev)
    delta = mk.shadow_resolve(
        sh_nodes, sh_ltris, dev.mk_sph, dev.mk_pln,
        tuple(c[slots] for c in so), tuple(c[slots] for c in sd),
        stmax[slots], sneed_s << 2, (zero, zero, zero),
        tuple(c[slots] for c in contrib), **sh_kw)
    out = []
    for e, dl in zip(en, delta):
        back = torch.empty_like(dl)
        back[slots] = dl
        out.append(e + back)
    return tuple(out)


def trace_advanced_mega(dev: DeviceScene, settings: RenderSettings, origin,
                        direction, state, idx=None):
    """TracePathAdvanced of rays origin/direction (N, 3) f32 with RNG
    state (N,) (int64 carrying u32) through the per-depth pipeline (the
    JAX package's trace_advanced_mega).  Per depth d: flags = active |
    spec << 1, traced += live lanes, shade_extend at depth d, traced +=
    shadow rays, shadow_resolve over the occlusion tables -- on the
    object-space instance machinery both kernels run their instance arms
    and shadow rays walk the shading tables (shadow_tables).  With lane identities `idx` (N,) the carry is
    sorted after depth d < min(CPUGPU_SORT_DEPTHS or 3, max depth) --
    compact after depth 0, morton8 later -- and energy and state return
    to lane order at the end; CPUGPU_SHADOW_SORT=1 also sorts the depth-0
    shadow rays (sorted_shadow_resolve).  Without `idx` nothing is
    sorted.  Both kernels launch every depth, max_ray_depth + 1 times
    each; the host never synchronises.  Returns (state', TraceResult)."""
    n = origin.shape[0]
    dv = origin.device
    kw = dict(extend_kwargs(dev, settings), **dev.inst_kwargs())
    nee = kw["nee"]
    tables = dev.tables()
    sh_nodes, sh_ltris, sh_kw = shadow_tables(dev)
    do_sort = idx is not None
    shadow_sort = do_sort and os.environ.get("CPUGPU_SHADOW_SORT") == "1"
    sort_depths = min(int(os.environ.get("CPUGPU_SORT_DEPTHS") or "3"),
                      settings.max_ray_depth)
    one = torch.ones(n, dtype=torch.float32, device=dv)
    zero = torch.zeros(n, dtype=torch.float32, device=dv)
    c = dict(
        ray=tuple(origin[:, k].contiguous() for k in range(3))
        + tuple(direction[:, k].contiguous() for k in range(3)),
        state=state, tp=(one, one, one), en=(zero, zero, zero),
        active=torch.ones(n, dtype=torch.int32, device=dv),
        spec=torch.zeros(n, dtype=torch.int32, device=dv))
    if do_sort:
        c["lane"] = idx.to(torch.int32)
    traced = torch.zeros((), dtype=torch.int64, device=dv)
    for d in range(settings.max_ray_depth + 1):
        flags = c["active"] | (c["spec"] << 1)
        traced = traced + c["active"].sum(dtype=torch.int64)
        rays, st, tp, en, fl, so, sd, stmax, contrib = mk.shade_extend(
            *tables, d, c["ray"], c["state"], c["tp"], c["en"], flags, **kw)
        if nee:
            traced = traced + ((fl >> 2) & 1).sum(dtype=torch.int64)
            if shadow_sort and d == 0:
                en = sorted_shadow_resolve(dev, so, sd, stmax, fl, en,
                                           contrib)
            else:
                en = mk.shadow_resolve(
                    sh_nodes, sh_ltris, dev.mk_sph, dev.mk_pln,
                    so, sd, stmax, fl, en, contrib, **sh_kw)
        c = dict(c, ray=rays, state=st, tp=tp, en=en, active=fl & 1,
                 spec=(fl >> 1) & 1)
        if do_sort and d < sort_depths:
            c = sort_wavefront(dev, c, "compact" if d == 0 else "morton8")
    cols = list(c["en"]) + [c["state"]]
    if do_sort:
        cols = restore_lane_order(c["lane"], cols)
    return cols[3], TraceResult(torch.stack(cols[:3], dim=1), traced)


def trace_advanced_frame(dev: DeviceScene, settings: RenderSettings, origin,
                         direction, state, idx=None):
    """TracePathAdvanced of rays origin/direction (N, 3) f32 with RNG
    state (N,) (int64 carrying u32) through pt_frame.  With lane
    identities `idx` (N,) and a split 0 < K < depths
    (scene.ptframe_split) the split-span schedule runs; without them one
    span -- unless the tree exceeds the unsorted budget
    (CPUGPU_PTFRAME_MAX_NODES, default 2048 rows) while the split is on:
    the gate admitted the tree on the split schedule's economics, so the
    frame goes to trace_advanced_mega(idx=None) instead, as in the JAX
    package.  Returns (state', TraceResult); state' is that of the last
    span, in lane order."""
    kw = frame_kwargs(dev, settings)
    tables = dev.tables()
    rays = tuple(origin[:, k].contiguous() for k in range(3)) + tuple(
        direction[:, k].contiguous() for k in range(3))
    depths = settings.max_ray_depth + 1
    split = ptframe_split(settings)
    split_on = 0 < split < depths
    if (idx is None and split_on
            and int(dev.pnodes.shape[0]) > ptframe_max_nodes(False)):
        return trace_advanced_mega(dev, settings, origin, direction, state)
    if idx is None or not split_on:
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
