"""Whitted-style raytracer (the JAX package's models/whitted.py).

The reference's previous project phase (README.md:41-52): direct
illumination of diffuse surfaces from point lights with distance
attenuation, hard shadows via shadow rays, recursive pure-specular
reflection, and dielectrics with Fresnel; depth-capped.  Per vertex:

  energy += throughput * diffuse_weight * albedo
            * sum_over_lights( vis * max(N.L, 0) * intensity / d^2 )

with each scene light a point light at its center (mesh lights at their
area-weighted surface centroid, radius 0).  The ray then continues as a
dielectric (stochastic Fresnel choice between refraction and reflection)
when refractivity > 0, else as a mirror when specular > 0, else ends;
Beer's-law absorption applies on medium exit.

Two routes, chosen by models/renderer.trace_sample as in the JAX package:
* `trace_whitted`, the per-depth wavefront over models/scene's
  intersect_scene: per depth one closest-hit query and one any-hit
  shadow query per light (the mesh arm of each launches the
  traverse_packet_slim kernel), with a morton5 wavefront sort after
  every depth on the card.  It tracks the AOVs (final depth, the primary
  ray's BVH depth) and draws the debug views: RAY_DEPTH overwrites the
  energy with its heatmap, BVH_DEPTH takes integrators.debug_bvh_result;
* `trace_whitted_kernel`, the whole frame in one whitted_frame launch
  (ops/whitted_kernel.py) on all-analytic scenes without AOVs
  (scene.whitted_kernel_active).
RNG state and traced counts of the two are equal; energy meets the
megakernel contract.
"""

from __future__ import annotations

import torch

from cpugpupathtracing_tpu_torch.config import DebugRenderMode, RenderSettings
from cpugpupathtracing_tpu_torch.models.integrators import (
    TraceResult,
    _dielectric,
    _gather_material,
    debug_bvh_result,
    heatmap,
    kernel_result,
    restore_lane_order,
    sort_wavefront,
)
from cpugpupathtracing_tpu_torch.models.scene import (
    DeviceScene,
    hit_surface,
    intersect_scene,
    packet_path_active,
)
from cpugpupathtracing_tpu_torch.ops import whitted_kernel as wk
from cpugpupathtracing_tpu_torch.utils import rng as rnglib
from cpugpupathtracing_tpu_torch.utils.vecmath import (
    RAY_NUDGE,
    RAY_TMAX,
    dot3,
    length,
)

def trace_whitted(dev: DeviceScene, settings: RenderSettings, origin,
                  direction, state, idx=None):
    """Whitted trace of rays origin/direction (N, 3) f32 with RNG state
    (N,) (int64 carrying u32), depth by depth, one shadow query per light
    (the JAX package's batched form for more than 4 lights, kept there
    for TPU compile time, gives the same image and is not ported).  Every
    lane steps its RNG once per depth, dead or alive.  With AOVs it
    tracks each lane's final depth and its primary ray's bvh_depth; the
    RAY_DEPTH view overwrites the energy with the heatmap of final depth
    / max depth, BVH_DEPTH takes debug_bvh_result.  With lane identities
    `idx` (N,), depth + 1 <= 255 and the meshes traced on the card
    (scene.packet_path_active) the carry is sorted by the morton5 key
    after every depth and returns to lane order at the end.  Returns
    (state', TraceResult)."""
    if settings.debug_render_mode == DebugRenderMode.BVH_DEPTH:
        return debug_bvh_result(dev, origin, direction, state)
    n = origin.shape[0]
    dv = origin.device
    f32 = torch.float32
    aovs = settings.aovs_active
    do_sort = (idx is not None and settings.max_ray_depth + 1 <= 0xFF
               and packet_path_active(dev))
    one = torch.ones(n, dtype=f32, device=dv)
    zero = torch.zeros(n, dtype=f32, device=dv)
    c = dict(
        ray=tuple(origin[:, k].contiguous() for k in range(3))
        + tuple(direction[:, k].contiguous() for k in range(3)),
        state=state, tp=(one, one, one), en=(zero, zero, zero),
        active=torch.ones(n, dtype=torch.int32, device=dv))
    if aovs:
        c["final_depth"] = torch.zeros(n, dtype=torch.int32, device=dv)
        c["bvh_depth0"] = torch.zeros(n, dtype=torch.int32, device=dv)
    if do_sort:
        c["lane"] = idx.to(torch.int32)
    traced = torch.zeros((), dtype=torch.int64, device=dv)
    L = dev.num_lights
    l_center = dev.mk_lights[:L, 0:3]
    l_radius = dev.mk_lights[:L, 3]
    l_emission = dev.mk_lights[:L, 5:8]  # emissive * intensity

    for depth in range(settings.max_ray_depth + 1):
        state = c["state"]
        active = c["active"] != 0
        throughput = torch.stack(c["tp"], dim=1)
        energy = torch.stack(c["en"], dim=1)
        ray_o = torch.stack(c["ray"][0:3], dim=1)
        ray_d = torch.stack(c["ray"][3:6], dim=1)
        final_depth = c.get("final_depth")

        traced = traced + active.sum(dtype=torch.int64)
        hit = intersect_scene(dev, c["ray"][0:3], c["ray"][3:6],
                              torch.full_like(one, RAY_TMAX), active=active,
                              count_depth=aovs)
        if aovs:
            bvh_depth0 = hit.bvh_depth if depth == 0 else c["bvh_depth0"]
            final_depth = torch.where(active & (hit.obj < 0), depth,
                                      final_depth)
        active = active & (hit.obj >= 0)

        pos, normal, mat_idx = hit_surface(dev, hit, ray_o, ray_d)
        mat = _gather_material(dev, mat_idx)
        fzero = torch.zeros_like(pos)

        hit_light = active & mat["is_light"]
        energy = energy + torch.where(
            hit_light[:, None],
            throughput * mat["emissive"] * mat["intensity"][:, None], fzero)
        if aovs:
            final_depth = torch.where(hit_light, depth, final_depth)
        active = active & ~hit_light

        diffuse_weight = torch.clamp(
            1.0 - mat["specular"] - mat["refractivity"], min=0.0)

        # direct lighting: every light a point light, hard shadows
        direct = fzero
        for li in range(L):
            to_l = l_center[li][None, :] - pos
            dist = length(to_l)
            to_l = to_l / torch.clamp(dist[:, None], min=1e-20)
            ndotl = dot3(normal, to_l)
            want = active & (diffuse_weight > 0.0) & (ndotl > 0.0)
            traced = traced + want.sum(dtype=torch.int64)
            # the shadow ray stops at the light sphere's surface so the
            # light does not occlude itself (mesh lights have radius 0)
            sh = intersect_scene(
                dev, tuple((pos[:, k] + to_l[:, k] * RAY_NUDGE).contiguous()
                           for k in range(3)),
                tuple(to_l[:, k].contiguous() for k in range(3)),
                dist - l_radius[li] - 2.0 * RAY_NUDGE, any_hit=True,
                active=want, count_depth=False)
            atten = 1.0 / torch.clamp(dist * dist, min=1e-20)
            direct = direct + torch.where(
                (want & (sh.obj < 0))[:, None],
                (ndotl * atten)[:, None] * l_emission[li][None, :], fzero)
        energy = energy + torch.where(
            active[:, None],
            throughput * diffuse_weight[:, None] * mat["albedo"] * direct,
            fzero)

        # continuation: dielectric first, else mirror, else the path ends
        tir, inside, refract_dir, fr = _dielectric(ray_d, normal, mat)
        state, r_fr = rnglib.next_f32(state)
        choose_refract = r_fr > fr
        spec_dir = ray_d - 2.0 * normal * dot3(ray_d, normal)[:, None]
        beer = torch.exp(-mat["absorption"] * hit.t[:, None])

        has_refr = mat["refractivity"] > 0.0
        cont_diel = active & has_refr & ~tir
        diel_refract = cont_diel & choose_refract
        diel_reflect = cont_diel & ~choose_refract
        cont_spec = active & ~has_refr & (mat["specular"] > 0.0)
        tir_reflect = active & has_refr & tir  # TIR on a refractive surface
        die = active & ~cont_diel & ~cont_spec & ~tir_reflect

        new_dir = torch.where((cont_spec | diel_reflect | tir_reflect)[:, None],
                              spec_dir, ray_d)
        new_dir = torch.where(diel_refract[:, None], refract_dir, new_dir)

        refr_alb = mat["refractivity"][:, None] * mat["albedo"]
        tp_mult = torch.where(
            (diel_refract | diel_reflect | tir_reflect)[:, None], refr_alb,
            torch.ones_like(pos))
        tp_mult = torch.where((diel_refract & inside)[:, None],
                              refr_alb * beer, tp_mult)
        tp_mult = torch.where(cont_spec[:, None],
                              mat["specular"][:, None] * mat["albedo"],
                              tp_mult)
        throughput = throughput * tp_mult

        if aovs:
            final_depth = torch.where(die, depth, final_depth)
        active = active & ~die
        bounced = (cont_spec | diel_refract | diel_reflect
                   | tir_reflect)[:, None]
        new_o = torch.where(bounced, pos + new_dir * RAY_NUDGE, ray_o)
        new_d = torch.where(bounced, new_dir, ray_d)
        nc = dict(
            ray=tuple(new_o[:, k].contiguous() for k in range(3))
            + tuple(new_d[:, k].contiguous() for k in range(3)),
            state=state,
            tp=tuple(throughput[:, k].contiguous() for k in range(3)),
            en=tuple(energy[:, k].contiguous() for k in range(3)),
            active=active.to(torch.int32))
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
        cols += [torch.zeros(n, dtype=torch.int32, device=dv)] * 2
    if do_sort:
        cols = restore_lane_order(c["lane"], cols)
    energy = torch.stack(cols[:3], dim=1)
    if settings.debug_render_mode == DebugRenderMode.RAY_DEPTH:
        energy = heatmap(cols[4], float(settings.max_ray_depth))
    return cols[3], TraceResult(energy, traced, cols[4], cols[5])


def trace_whitted_kernel(dev: DeviceScene, settings: RenderSettings, origin,
                         direction, state, idx=None):
    """trace_whitted through the whole-frame whitted_frame kernel (one
    launch for every depth; scene.whitted_kernel_active gates it).  RNG
    state and traced equal trace_whitted's; energy within the megakernel
    contract.  `idx` is unused: analytic scenes are not sorted."""
    del idx
    energy, state, traced = wk.whitted_frame_rows(
        dev.mk_mats, dev.mk_lights, dev.mk_sph, dev.mk_pln, dev.mk_sph_mat,
        dev.mk_pln_mat, dev.mk_objmat, origin, direction, state,
        num_mats=dev.num_mats,
        num_lights=dev.num_lights, num_sph=dev.num_sph,
        num_pln=dev.num_pln, depths=settings.max_ray_depth + 1)
    return state, kernel_result(energy, traced)


def make_whitted_scene():
    """Benchmark config 1 (BASELINE.md): spheres + plane, point lights,
    hard shadows."""
    from cpugpupathtracing_tpu_torch.models import materials as matlib
    from cpugpupathtracing_tpu_torch.models.scene import Scene

    s = Scene()
    red = s.add_material(matlib.Material.diffuse((0.8, 0.2, 0.2)))
    green = s.add_material(matlib.Material.diffuse((0.2, 0.8, 0.2)))
    mirror = s.add_material(matlib.Material.diffuse((0.95, 0.95, 0.95),
                                                    specular=1.0))
    glass = s.add_material(matlib.Material.dielectric(
        (1.0, 1.0, 1.0), 0.0, 1.0, (0.1, 0.1, 0.1), 1.5))
    white = s.add_material(matlib.Material.diffuse((0.9, 0.9, 0.9)))
    light = s.add_material(matlib.Material.light((1.0, 1.0, 1.0), 150.0))

    s.add_sphere("Red sphere", (-2.5, 0.0, 0.0), 1.0, red)
    s.add_sphere("Green sphere", (0.0, 0.0, -1.5), 1.0, green)
    s.add_sphere("Mirror sphere", (2.5, 0.0, 0.0), 1.0, mirror)
    s.add_sphere("Glass sphere", (0.8, -0.2, 1.5), 0.8, glass)
    s.add_plane("Floor", (0.0, -1.2, 0.0), (0.0, 1.0, 0.0), white)
    s.mark_light(s.add_sphere("Point light0", (6.0, 8.0, 4.0), 0.2, light))
    s.mark_light(s.add_sphere("Point light1", (-5.0, 6.0, -3.0), 0.2, light))
    return s
