"""TracePathAdvanced (Source/Main.cpp:396-579) and TracePath (:581-689)
over a frame of rays, on the JAX package's two kernel routes and its XLA
integrators:

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

* `trace_advanced`, the XLA integrator: per depth a scene query
  (models/scene.intersect_scene, whose mesh arm launches the
  traverse_packet_slim kernel, counting BVH depth when AOVs are on), the
  shading in PyTorch, and the NEE shadow query, with a morton5 wavefront
  sort after every depth on the card.  It is the route of the AOVs and
  the debug views (RAY_DEPTH, BVH_DEPTH), of mesh lights over the light
  table, of scenes without meshes and of CPUGPU_NO_MEGAKERNEL=1.
* `trace_brute`, TracePath (Source/Main.cpp:581-689): the BRUTE_FORCE
  mode and the left half of COMPARISON, per depth one closest-hit scene
  query through the same traverse_packet_slim kernel, no NEE, uniform
  hemisphere bounces, with the XLA integrator's morton5 sort.

Sorting permutes whole lanes and every lane's RNG stream is its own, so
the per-lane energy, state and traced counts of every schedule and of
both kernel routes are bitwise equal (tests pin it).  The gates that
choose a route are in models/scene.py; models/renderer.trace_sample
applies them.  NEE, cosine sampling, Russian roulette and the
diffuse-pdf mode are honoured on every route.  The wavefront sort, the
lane-order restore and the material, dielectric and BVH-view helpers
serve the Whitted integrator (models/whitted.py) too.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from cpugpupathtracing_tpu_torch.config import (
    DebugRenderMode,
    DiffusePdfMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models.scene import (
    DeviceScene,
    active_bit,
    hit_surface,
    intersect_scene,
    occl_tables,
    packet_path_active,
    packet_tables,
    ptframe_max_nodes,
    ptframe_split,
    reorder_key,
)
from cpugpupathtracing_tpu_torch.ops import megakernel as mk
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import sampling
from cpugpupathtracing_tpu_torch.ops.gathers import select_rows
from cpugpupathtracing_tpu_torch.utils import rng as rnglib
from cpugpupathtracing_tpu_torch.utils.vecmath import (
    INV_PI,
    PI,
    RAY_NUDGE,
    RAY_TMAX,
    TWO_PI,
    dot3,
    fdiv,
    length,
)

# is_specular rides bit 30 of the lane id through the sort
SPEC_BIT = 30
# wavefront sorts run since import (sort_wavefront), counted like the
# kernels' launches so that chip_smoke.py can check the sorts per frame
sorts = 0
# the debug heatmaps' end colours (lerp(GREEN, RED, t), Main.cpp:408-412)
_GREEN = (0.0, 1.0, 0.0)
_RED = (1.0, 0.0, 0.0)


class TraceResult(NamedTuple):
    energy: torch.Tensor       # (N, 3) f32 radiance estimate per lane
    traced_rays: torch.Tensor  # () int64: scene + shadow traversals
    ray_depth: torch.Tensor    # (N,) i32 final path depth (AOV)
    bvh_depth: torch.Tensor    # (N,) i32 primary ray's BVH depth (AOV)


def kernel_result(energy: torch.Tensor, traced) -> TraceResult:
    """The TraceResult of a kernel route, which tracks no AOVs: zero
    ray_depth and bvh_depth, as in the JAX package."""
    zero = torch.zeros(energy.shape[0], dtype=torch.int32,
                       device=energy.device)
    return TraceResult(energy, traced, zero, zero)


class LightSample(NamedTuple):
    """LightSample (Source/Main.cpp:340-349) over lanes: (N, 3) pos,
    to_light, normal, emission; (N,) distance, area."""

    pos: torch.Tensor
    to_light: torch.Tensor
    distance: torch.Tensor
    normal: torch.Tensor
    emission: torch.Tensor
    area: torch.Tensor


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
    """The static keyword arguments of pt_frame over dev.tables() of an
    8-wide scene, without layout keywords (the plain arm): the any-hit
    tables' 64-col rows as the shadow tree when the scene has them.
    frame_args gives the whole-frame route's tables and keywords."""
    kw = extend_kwargs(dev, settings)
    if dev.poccl_roots:
        kw.update(sh_nodes=dev.poccl_nodes, sh_ltris=dev.poccl_ltris,
                  sh_roots=dev.poccl_roots, occl=True,
                  occl_rows=dev.poccl_rows)
    return kw


def route_tables(dev: DeviceScene, whole_frame: bool = False) -> tuple:
    """(the ten tables of the kernels' positional arguments, the node
    layout keywords fused_nn / width / ents) that a route hands its
    closest-hit kernel: the tables of scene.packet_tables, as the JAX
    package's routes pass them (no side table on the object-space
    machinery).  With the leaf-14 payload rows (CPUGPU_LEAF14; the
    per-depth route only, whose gate takes them) the any-hit tree and
    `pay`, as the JAX package's trace_advanced_mega takes them: its
    48-col rows and side table when built, none for a small tree."""
    if dev.poccl_pay is not None and not whole_frame:
        nodes, ents = dev.poccl_nodes, dev.poccl_ents
        if dev.smem_small:
            ents = None
        elif dev.poccl_nodes48 is not None:
            nodes = dev.poccl_nodes48
        return (nodes, dev.poccl_ltris) + dev.tables()[2:], dict(
            fused_nn=0, width=8, ents=ents, pay=dev.poccl_pay,
            roots=dev.poccl_roots)
    nodes, ltris, fused_nn, ents = packet_tables(dev, whole_frame)
    return (nodes, ltris) + dev.tables()[2:], dict(
        fused_nn=fused_nn, width=dev.packet_width,
        ents=None if dev.machinery else ents)


def frame_args(dev: DeviceScene, settings: RenderSettings) -> tuple:
    """(tables, keyword arguments) of the whole-frame route's pt_frame
    launches: route_tables(whole_frame=True), and the any-hit tree of
    scene.occl_tables(whole_frame=True) with its side table as the shadow
    tree when the scene has one (the JAX package's
    trace_advanced_frame)."""
    tables, kw = route_tables(dev, whole_frame=True)
    kw.update(extend_kwargs(dev, settings))
    occl = occl_tables(dev, whole_frame=True)
    if occl is not None:
        sh_nodes, sh_ltris, sh_roots, sh_ents = occl
        kw.update(sh_nodes=sh_nodes, sh_ltris=sh_ltris, sh_roots=sh_roots,
                  sh_ents=sh_ents, occl=True, occl_rows=dev.poccl_rows)
    return tables, kw


def shadow_tables(dev: DeviceScene) -> tuple:
    """(nodes, ltris, keyword arguments) of the per-depth route's
    shadow_resolve: the any-hit tables of scene.occl_tables (with their
    side table), or the shading tables in their route layout
    (route_tables) -- on the object-space instance machinery with the
    instance tables (the JAX package's instanced arm, which builds no
    any-hit tables).  The any-hit tree's arity and rows per leaf ride
    along (CPUGPU_OCCL_W16, CPUGPU_OCCL2)."""
    kw = dict(num_sph=dev.num_sph, num_pln=dev.num_pln)
    occl = occl_tables(dev)
    if occl is None:
        tables, tkw = route_tables(dev)
        return tables[0], tables[1], dict(
            kw, **tkw, roots=dev.proots, occl=False,
            **dev.inst_kwargs(nrm=False))
    nodes, ltris, roots, ents = occl
    return nodes, ltris, dict(kw, roots=roots, occl=True, ents=ents,
                              width=dev.poccl_width,
                              occl_rows=dev.poccl_rows)


def shadow_kwargs(dev: DeviceScene) -> dict:
    """The keyword arguments of shadow_resolve after its positional
    (nodes, ltris, sph, pln), the tables of shadow_tables."""
    return shadow_tables(dev)[2]


def sort_wavefront(dev: DeviceScene, c: dict, mode: str = "morton8") -> dict:
    """Permute every per-lane carry column by the coherence key of the
    carry's next ray (the JAX package's sort_wavefront): "compact" keys
    on (1 - active) alone, so live lanes keep their incoming
    (camera-blocked) order; "morton5" / "morton8" key on active first,
    then direction octant, then origin morton at 5 / 8 bits per axis.
    The carry holds ray (6 columns), state, tp and en (3 columns each),
    active, lane and, on the path tracer's carry, spec (the Whitted carry
    has none); with AOVs also final_depth and bvh_depth0, which come back
    masked to 8 and 22 bits as the JAX package's one-word fold returns
    them.  `active` rides the key, `spec` bit 30 of `lane`; the sort is
    stable, like lax.sort."""
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
    if "final_depth" in c:
        out.update(final_depth=c["final_depth"][perm] & 0xFF,
                   bvh_depth0=c["bvh_depth0"][perm] & 0x3FFFFF)
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
    m = select_rows(dev.mk_mats, mat_idx)
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
    refract_dir = torch.stack(sampling.refract(
        ray_d.unbind(1), n_ref.unbind(1), eta, cosi, k), dim=1)
    angle_in = dot3(ray_d, normal)
    angle_out = dot3(refract_dir, normal)
    fr = sampling.fresnel(angle_in, angle_out, etai, etat)
    return tir, inside, refract_dir, torch.where(tir, one, fr)


def _cols(v: torch.Tensor) -> tuple:
    return tuple(v.unbind(1))


def sample_light(dev: DeviceScene, state, pos):
    """GetRandomLightSourceForSample (Source/Main.cpp:351-394), the JAX
    package's sample_light: pick one of the L lights uniformly, sample a
    point on it (the hemisphere of a sphere that faces pos; a uniform
    triangle of a mesh light, whatever the light table's budget) and
    return (state', LightSample).  Both branches are evaluated and
    lane-selected; a scene without mesh lights draws the mesh branch's 3
    values all the same, so the RNG stream layout does not depend on the
    scene.  pos (N, 3); state (N,) int64 carrying u32."""
    state, li = rnglib.next_u32_range(state, 0, dev.num_lights - 1)
    li = li.long()
    is_sph = dev.light_is_sphere[li]
    center = dev.light_sph_center[li]
    radius = dev.light_sph_radius[li]
    state, p_sph = sampling.random_point_sphere_facing(
        state, _cols(center), radius, _cols(pos))
    p_sph = torch.stack(p_sph, dim=1)
    n_sph = (p_sph - center) / torch.clamp(radius[:, None], min=1e-20)
    area_sph = TWO_PI * dev.light_sph_radius_sq[li]
    if dev.has_mesh_lights and dev.num_triangles > 0:
        start = dev.light_tri_start[li].to(torch.int64)
        count = dev.light_tri_count[li].to(torch.int64)
        state, ti = rnglib.next_u32_range(state, start, start + count - 1)
        ti = torch.clamp(ti, 0, max(dev.num_triangles - 1, 0))
        row = dev.tris9[ti]
        v0 = row[:, 0:3]
        v1 = v0 + row[:, 3:6]
        v2 = v0 + row[:, 6:9]
        state, p_tri = sampling.random_point_triangle(
            state, _cols(v0), _cols(v1), _cols(v2))
        sph = is_sph[:, None]
        lpos = torch.where(sph, p_sph, torch.stack(p_tri, dim=1))
        lnormal = torch.where(sph, n_sph, dev.tri_normal[ti])
        area = torch.where(is_sph, area_sph, dev.light_half_area[li])
    else:
        # the mesh branch's draws: one u32 and two floats
        state = rnglib.xs32(rnglib.xs32(rnglib.xs32(state)))
        lpos, lnormal, area = p_sph, n_sph, area_sph
    lmat = _gather_material(dev, dev.mk_objmat[dev.light_obj[li].long()])
    emission = lmat["emissive"] * lmat["intensity"][:, None]
    to_light = lpos - pos
    distance = length(to_light)
    to_light = to_light / torch.clamp(distance[:, None], min=1e-20)
    return state, LightSample(lpos, to_light, distance, lnormal, emission,
                              area)


def _diffuse_bounce(state, normal, settings: RenderSettings):
    """Diffuse direction and its (NdotR / pdf) weight in either sampling
    mode and pdf convention (Source/Main.cpp:548-568): (state', dir (N, 3),
    weight)."""
    n = _cols(normal)
    ref = settings.diffuse_pdf_mode == DiffusePdfMode.REFERENCE
    if settings.cosine_weighted_diffuse:
        state, d = sampling.cosine_weighted(state, n)
        d = torch.stack(d, dim=1)
        ndotr = dot3(d, normal)
        # the reference's swapped constant under REFERENCE
        weight = (fdiv(ndotr, 1.0 / TWO_PI) if ref
                  else ndotr / fdiv(torch.clamp(ndotr, min=1e-6), PI))
    else:
        state, d = sampling.uniform_hemisphere(state, n)
        d = torch.stack(d, dim=1)
        ndotr = dot3(d, normal)
        weight = (ndotr / fdiv(torch.clamp(ndotr, min=1e-6), PI) if ref
                  else fdiv(ndotr, 1.0 / TWO_PI))
    return state, d, weight


def heatmap(value: torch.Tensor, scale: float) -> torch.Tensor:
    """The debug views' lerp(green, red, value / scale) per lane, (N, 3)
    f32 (Vec3Lerp, a + t (b - a)), with the colours as Python scalars
    (no host-to-device copy)."""
    t = fdiv(value.to(torch.float32), scale)
    return torch.stack([g + t * (r - g) for g, r in zip(_GREEN, _RED)],
                       dim=1)


def debug_bvh_result(dev: DeviceScene, origin, direction, state):
    """The BVH_DEPTH view's short-circuit (Main.cpp:408-412; the JAX
    package's _debug_bvh_result): one primary query counting BVH depth,
    and the heatmap of bvh_depth / 30 as energy.  Returns (state
    unchanged, TraceResult with traced = N)."""
    n = origin.shape[0]
    hit = intersect_scene(dev, origin, direction,
                          torch.full((n,), RAY_TMAX, dtype=torch.float32,
                                     device=origin.device))
    return state, TraceResult(
        heatmap(hit.bvh_depth, 30.0),
        torch.full((), n, dtype=torch.int64, device=origin.device),
        torch.zeros(n, dtype=torch.int32, device=origin.device),
        hit.bvh_depth)


def trace_advanced(dev: DeviceScene, settings: RenderSettings, origin,
                   direction, state, idx=None):
    """TracePathAdvanced of rays origin/direction (N, 3) f32 with RNG
    state (N,) (int64 carrying u32) on the XLA integrator (the JAX
    package's trace_advanced): per depth one closest-hit scene query
    (count_depth when AOVs are on), the light-hit emission with the NEE
    double-count guard, NEE through sample_light and an any-hit shadow
    query, Russian roulette, lobe selection, dielectric / Fresnel / Beer
    and the bounce, over (N, 3) tensors in the JAX function's order of
    operations.  With AOVs it tracks each lane's final depth and its
    primary ray's bvh_depth; the RAY_DEPTH view then overwrites the energy
    with the heatmap of final depth / max depth, and BVH_DEPTH takes
    debug_bvh_result instead.  With lane identities `idx` (N,), depth + 1
    <= 255 and the meshes traced on the card (scene.packet_path_active)
    the carry is sorted by the morton5 key after every depth and returns
    to lane order at the end.  Returns (state', TraceResult)."""
    if settings.debug_render_mode == DebugRenderMode.BVH_DEPTH:
        return debug_bvh_result(dev, origin, direction, state)
    n = origin.shape[0]
    dv = origin.device
    f32, i32 = torch.float32, torch.int32
    nee = settings.next_event_estimation and dev.num_lights > 0
    aovs = settings.aovs_active
    do_sort = (idx is not None and settings.max_ray_depth + 1 <= 0xFF
               and packet_path_active(dev))
    one = torch.ones(n, dtype=f32, device=dv)
    zero = torch.zeros(n, dtype=f32, device=dv)
    c = dict(
        ray=_cols(origin.contiguous()) + _cols(direction.contiguous()),
        state=state, tp=(one, one, one), en=(zero, zero, zero),
        active=torch.ones(n, dtype=i32, device=dv),
        spec=torch.zeros(n, dtype=i32, device=dv))
    if aovs:
        c["final_depth"] = torch.zeros(n, dtype=i32, device=dv)
        c["bvh_depth0"] = torch.zeros(n, dtype=i32, device=dv)
    if do_sort:
        c["lane"] = idx.to(i32)
    traced = torch.zeros((), dtype=torch.int64, device=dv)
    t_max = torch.full((n,), RAY_TMAX, dtype=f32, device=dv)

    for depth in range(settings.max_ray_depth + 1):
        state = c["state"]
        active = c["active"] != 0
        is_specular = c["spec"] != 0
        throughput = torch.stack(c["tp"], dim=1)
        energy = torch.stack(c["en"], dim=1)
        ro_c, rd_c = c["ray"][0:3], c["ray"][3:6]
        ray_o = torch.stack(ro_c, dim=1)
        ray_d = torch.stack(rd_c, dim=1)
        final_depth = c.get("final_depth")

        traced = traced + active.sum(dtype=torch.int64)
        hit = intersect_scene(dev, ro_c, rd_c, t_max, active=active,
                              count_depth=aovs)
        if aovs:
            bvh_depth0 = hit.bvh_depth if depth == 0 else c["bvh_depth0"]

        miss = active & (hit.obj < 0)
        if aovs:
            final_depth = torch.where(miss, depth, final_depth)
        active = active & ~miss

        pos, normal, mat_idx = hit_surface(dev, hit, ray_o, ray_d)
        mat = _gather_material(dev, mat_idx)
        fzero = torch.zeros_like(pos)

        # light hit: emission only for primary / specular rays under NEE
        # (Main.cpp:424-431)
        hit_light = active & mat["is_light"]
        add_emission = (hit_light & ((depth == 0) | is_specular)
                        if settings.next_event_estimation else hit_light)
        energy = energy + torch.where(
            add_emission[:, None],
            throughput * mat["emissive"] * mat["intensity"][:, None], fzero)
        if aovs:
            final_depth = torch.where(hit_light, depth, final_depth)
        active = active & ~hit_light

        brdf_diffuse = mat["albedo"] * INV_PI
        diffuse_weight = torch.clamp(
            1.0 - mat["specular"] - mat["refractivity"], min=0.0)

        # next-event estimation (Main.cpp:439-465)
        if nee:
            do_nee = active & (diffuse_weight > 0.001)
            state, ls = sample_light(dev, state, pos)
            ndotl = dot3(normal, ls.to_light)
            nldotl = dot3(ls.normal, -ls.to_light)
            shadow_needed = do_nee & (ndotl > 0.0) & (nldotl > 0.0)
            traced = traced + shadow_needed.sum(dtype=torch.int64)
            sh = intersect_scene(
                dev, _cols(pos + ls.to_light * RAY_NUDGE),
                _cols(ls.to_light), ls.distance - 2.0 * RAY_NUDGE,
                any_hit=True, active=shadow_needed, count_depth=False)
            solid_angle = (nldotl * ls.area) / torch.clamp(
                ls.distance * ls.distance, min=1e-20)
            contrib = (throughput * (ndotl * solid_angle)[:, None]
                       * brdf_diffuse * ls.emission
                       * float(dev.num_lights) * diffuse_weight[:, None])
            energy = energy + torch.where(
                (shadow_needed & (sh.obj < 0))[:, None], contrib, fzero)

        # Russian roulette (Main.cpp:468-475)
        if settings.russian_roulette:
            survival = sampling.survival_probability_rr(*_cols(mat["albedo"]))
            state, r_rr = rnglib.next_f32(state)
            die = active & (survival < r_rr)
            if aovs:
                final_depth = torch.where(die, depth, final_depth)
            active = active & ~die
            throughput = torch.where(active[:, None],
                                     throughput / survival[:, None],
                                     throughput)

        # lobe selection (Main.cpp:478-570)
        state, r_lobe = rnglib.next_f32(state)
        sel_spec = active & (r_lobe < mat["specular"])
        sel_diel = active & ~sel_spec & (
            r_lobe < mat["specular"] + mat["refractivity"])
        sel_diff = active & ~sel_spec & ~sel_diel

        spec_dir = ray_d - 2.0 * normal * dot3(ray_d, normal)[:, None]
        tir, inside, refract_dir, fr = _dielectric(ray_d, normal, mat)
        state, r_fr = rnglib.next_f32(state)
        choose_refract = r_fr > fr
        state, diff_dir, diff_weight = _diffuse_bounce(state, normal,
                                                       settings)
        # Beer's-law absorption on medium exit (Main.cpp:524-532)
        beer = torch.exp(-mat["absorption"] * hit.t[:, None])

        diel_bounce = sel_diel & ~tir
        diel_refract = diel_bounce & choose_refract
        diel_reflect = diel_bounce & ~choose_refract

        new_dir = torch.where((sel_spec | diel_reflect)[:, None], spec_dir,
                              ray_d)
        new_dir = torch.where(diel_refract[:, None], refract_dir, new_dir)
        new_dir = torch.where(sel_diff[:, None], diff_dir, new_dir)

        tp_mult = torch.where((sel_spec | diel_reflect | diel_refract)[:, None],
                              mat["albedo"], torch.ones_like(pos))
        tp_mult = torch.where((diel_refract & inside)[:, None],
                              mat["albedo"] * beer, tp_mult)
        # throughput *= (NdotR / pdf) * brdf_diffuse (Main.cpp:568)
        tp_mult = torch.where(sel_diff[:, None],
                              diff_weight[:, None] * brdf_diffuse, tp_mult)
        throughput = throughput * tp_mult

        # TIR lanes (sel_diel & tir) keep their ray and stay active,
        # re-tracing the same segment: the reference's fallthrough
        bounced = (sel_spec | diel_bounce | sel_diff)[:, None]
        is_specular = torch.where(sel_spec | diel_bounce, True, is_specular)
        is_specular = torch.where(sel_diff, False, is_specular)
        new_o = torch.where(bounced, pos + new_dir * RAY_NUDGE, ray_o)
        new_d = torch.where(bounced, new_dir, ray_d)
        nc = dict(
            ray=_cols(new_o) + _cols(new_d), state=state,
            tp=_cols(throughput), en=_cols(energy),
            active=active.to(i32), spec=is_specular.to(i32))
        if aovs:
            nc.update(final_depth=final_depth, bvh_depth0=bvh_depth0)
        if do_sort:
            nc = sort_wavefront(dev, dict(nc, lane=c["lane"]), "morton5")
        c = nc

    cols = list(c["en"]) + [c["state"]]
    if aovs:
        cols += [torch.where(c["active"] != 0, settings.max_ray_depth + 1,
                             c["final_depth"]), c["bvh_depth0"]]
    else:
        cols += [torch.zeros(n, dtype=i32, device=dv)] * 2
    if do_sort:
        cols = restore_lane_order(c["lane"], cols)
    energy = torch.stack(cols[:3], dim=1)
    if settings.debug_render_mode == DebugRenderMode.RAY_DEPTH:
        # the energy is overwritten (Main.cpp:575-576)
        energy = heatmap(cols[4], float(settings.max_ray_depth))
    return cols[3], TraceResult(energy, traced, cols[4], cols[5])


def trace_brute(dev: DeviceScene, settings: RenderSettings, origin,
                direction, state, idx=None):
    """TracePath (Source/Main.cpp:581-689), brute-force path tracing, of
    rays origin/direction (N, 3) f32 with RNG state (N,) (int64 carrying
    u32): the JAX package's trace_brute, the recursion in throughput form
    over max_ray_depth + 1 depths.  Per depth one closest-hit scene query
    (the kernel's count_depth arm with AOVs), the light hit's emission
    (always: no NEE here), then on every lane -- dead lanes too, so the
    RNG streams match the JAX function's lane for lane -- the lobe,
    Fresnel and uniform-hemisphere draws; a dielectric's total internal
    reflection ends the path, Beer absorption weighs the refracted ray
    inside the medium, and the diffuse weight is 2 albedo cos (2 pi *
    albedo / pi * cos, Main.cpp:679-685).  BVH_DEPTH takes
    debug_bvh_result.  With lane identities `idx` (N,), depth + 1 <= 255
    and the meshes traced on the card (scene.packet_path_active) the
    carry is sorted by the morton5 key after every depth and returns to
    lane order at the end.  Returns (state', TraceResult)."""
    if settings.debug_render_mode == DebugRenderMode.BVH_DEPTH:
        return debug_bvh_result(dev, origin, direction, state)
    n = origin.shape[0]
    dv = origin.device
    f32, i32 = torch.float32, torch.int32
    aovs = settings.aovs_active
    do_sort = (idx is not None and settings.max_ray_depth + 1 <= 0xFF
               and packet_path_active(dev))
    one = torch.ones(n, dtype=f32, device=dv)
    zero = torch.zeros(n, dtype=f32, device=dv)
    c = dict(
        ray=_cols(origin.contiguous()) + _cols(direction.contiguous()),
        state=state, tp=(one, one, one), en=(zero, zero, zero),
        active=torch.ones(n, dtype=i32, device=dv))
    if aovs:
        c["final_depth"] = torch.zeros(n, dtype=i32, device=dv)
        c["bvh_depth0"] = torch.zeros(n, dtype=i32, device=dv)
    if do_sort:
        c["lane"] = idx.to(i32)
    traced = torch.zeros((), dtype=torch.int64, device=dv)
    t_max = torch.full((n,), RAY_TMAX, dtype=f32, device=dv)

    for depth in range(settings.max_ray_depth + 1):
        state = c["state"]
        active = c["active"] != 0
        throughput = torch.stack(c["tp"], dim=1)
        energy = torch.stack(c["en"], dim=1)
        ro_c, rd_c = c["ray"][0:3], c["ray"][3:6]
        ray_o = torch.stack(ro_c, dim=1)
        ray_d = torch.stack(rd_c, dim=1)
        final_depth = c.get("final_depth")

        traced = traced + active.sum(dtype=torch.int64)
        hit = intersect_scene(dev, ro_c, rd_c, t_max, active=active,
                              count_depth=aovs)
        if aovs:
            bvh_depth0 = hit.bvh_depth if depth == 0 else c["bvh_depth0"]

        miss = active & (hit.obj < 0)
        if aovs:
            final_depth = torch.where(miss, depth, final_depth)
        active = active & ~miss

        pos, normal, mat_idx = hit_surface(dev, hit, ray_o, ray_d)
        mat = _gather_material(dev, mat_idx)
        fzero = torch.zeros_like(pos)

        # a light hit returns its emission (Main.cpp:606-609)
        hit_light = active & mat["is_light"]
        energy = energy + torch.where(
            hit_light[:, None],
            throughput * mat["emissive"] * mat["intensity"][:, None], fzero)
        if aovs:
            final_depth = torch.where(hit_light, depth, final_depth)
        active = active & ~hit_light

        state, r_lobe = rnglib.next_f32(state)
        sel_spec = active & (r_lobe < mat["specular"])
        sel_diel = active & ~sel_spec & (
            r_lobe < mat["specular"] + mat["refractivity"])
        sel_diff = active & ~sel_spec & ~sel_diel

        spec_dir = ray_d - 2.0 * normal * dot3(ray_d, normal)[:, None]
        tir, inside, refract_dir, fr = _dielectric(ray_d, normal, mat)
        state, r_fr = rnglib.next_f32(state)
        choose_refract = r_fr > fr
        # brute force samples the hemisphere uniformly (Main.cpp:679)
        state, diff_dir = sampling.uniform_hemisphere(state, _cols(normal))
        diff_dir = torch.stack(diff_dir, dim=1)
        cosi = dot3(diff_dir, normal)
        beer = torch.exp(-mat["absorption"] * hit.t[:, None])

        # TIR ends the path (k < 0 leaves the colour black, Main.cpp:645)
        diel_dead = sel_diel & tir
        if aovs:
            final_depth = torch.where(diel_dead, depth, final_depth)
        diel_refract = sel_diel & ~tir & choose_refract
        diel_reflect = sel_diel & ~tir & ~choose_refract

        new_dir = torch.where((sel_spec | diel_reflect)[:, None], spec_dir,
                              ray_d)
        new_dir = torch.where(diel_refract[:, None], refract_dir, new_dir)
        new_dir = torch.where(sel_diff[:, None], diff_dir, new_dir)

        tp_mult = torch.where((sel_spec | diel_reflect | diel_refract)[:, None],
                              mat["albedo"], torch.ones_like(pos))
        tp_mult = torch.where((diel_refract & inside)[:, None],
                              mat["albedo"] * beer, tp_mult)
        tp_mult = torch.where(sel_diff[:, None],
                              2.0 * mat["albedo"] * cosi[:, None], tp_mult)
        throughput = throughput * tp_mult

        active = active & ~diel_dead
        bounced = (sel_spec | diel_refract | diel_reflect | sel_diff)[:, None]
        new_o = torch.where(bounced, pos + new_dir * RAY_NUDGE, ray_o)
        new_d = torch.where(bounced, new_dir, ray_d)
        nc = dict(ray=_cols(new_o) + _cols(new_d), state=state,
                  tp=_cols(throughput), en=_cols(energy),
                  active=active.to(i32))
        if aovs:
            nc.update(final_depth=final_depth, bvh_depth0=bvh_depth0)
        if do_sort:
            nc = sort_wavefront(dev, dict(nc, lane=c["lane"]), "morton5")
        c = nc

    cols = list(c["en"]) + [c["state"]]
    if aovs:
        cols += [torch.where(c["active"] != 0, settings.max_ray_depth + 1,
                             c["final_depth"]), c["bvh_depth0"]]
    else:
        cols += [torch.zeros(n, dtype=i32, device=dv)] * 2
    if do_sort:
        cols = restore_lane_order(c["lane"], cols)
    return cols[3], TraceResult(torch.stack(cols[:3], dim=1), traced,
                                cols[4], cols[5])


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
    tables, tkw = route_tables(dev)
    kw = dict(extend_kwargs(dev, settings), **tkw, **dev.inst_kwargs())
    nee = kw["nee"]
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
    return cols[3], kernel_result(torch.stack(cols[:3], dim=1), traced)


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
    tables, kw = frame_args(dev, settings)
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
        return st, kernel_result(energy, traced)

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
    return cols[3], kernel_result(energy, tr1 + tr2)
