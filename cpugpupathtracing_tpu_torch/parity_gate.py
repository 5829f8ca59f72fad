"""Compiled parity gates: the hand-written kernels against oracles, on the
card (the JAX package's tools/tpu_parity_gate.py).

The CPU tests hold each kernel's plain PyTorch version against JAX; these
gates re-prove, in the same process and on the same build that a bench
times, that the CUDA kernels agree with an oracle:

  * check_parity: traverse_packet_slim (closest and any hit) over the
    scene's packet tables against brute force over the triangle soup,
    and its any hit over the occlusion tables where the scene has them;
  * check_parity_instanced: intersect_scene on six instanced icospheres
    (B4's instance arm, or its plain arm over the flattened records)
    against a per-instance brute force;
  * check_parity_whitted: the whole-frame Whitted kernel against the
    per-depth trace_whitted;
  * check_parity_ptframe: the whole-frame kernel pt_frame against the
    per-depth pipeline (shade_extend + shadow_resolve).

Names, seeds, sizes, oracles and limits are the JAX gates'.  Each takes
`device` (the card by default; on CPU tensors the wrappers run their
plain versions), returns a dict with "ok" and raises AssertionError on a
failure.  bench_torch.py runs them before it prints its line.
Standalone, on the card:

    python -m cpugpupathtracing_tpu_torch.parity_gate
"""

from __future__ import annotations

import numpy as np
import torch

from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import camera as camlib
from cpugpupathtracing_tpu_torch.models import integrators
from cpugpupathtracing_tpu_torch.models import materials as matlib
from cpugpupathtracing_tpu_torch.models import mesh as meshlib
from cpugpupathtracing_tpu_torch.models import whitted
from cpugpupathtracing_tpu_torch.models.scene import (
    Scene,
    intersect_scene,
    make_reference_scene,
    occl_tables,
    packet_tables,
    pt_frame_gate_reason,
)
from cpugpupathtracing_tpu_torch.ops import intersect
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from cpugpupathtracing_tpu_torch.utils import rng as rnglib
from cpugpupathtracing_tpu_torch.utils.device import resolve_device
from cpugpupathtracing_tpu_torch.utils.vecmath import RAY_TMAX


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def _brute(o, d, v0, e1, e2, t_init, chunk: int):
    """brute_force_nearest_triangle over ray chunks: (t, index) as numpy."""
    bts, bidxs = [], []
    for s in range(0, o.shape[0], chunk):
        bt, bidx = intersect.brute_force_nearest_triangle(
            o[s:s + chunk], d[s:s + chunk], v0, e1, e2, t_init[s:s + chunk])
        bts.append(_host(bt))
        bidxs.append(_host(bidx))
    return np.concatenate(bts), np.concatenate(bidxs)


def _max_rel(t, ref, mask) -> float:
    rel = np.abs(t[mask] - ref[mask]) / np.maximum(np.abs(ref[mask]), 1e-20)
    return float(rel.max()) if mask.any() else 0.0


def _require(ok, message: str) -> None:
    """Raise AssertionError(message) unless ok (an explicit raise: a gate
    must fail under python -O too)."""
    if not ok:
        raise AssertionError(message)


def gate_rays(n_rays: int, seed: int, device):
    """check_parity's mixed ray set, in the JAX gate's numpy draw order:
    n_rays // 2 camera primaries of 1920x1080 at distinct random pixels,
    then random scene rays (origins ~ N(0, 6), aimed at N(0, 2)).
    Returns (origin, direction) (n_rays, 3) f32 on `device`."""
    rng = np.random.default_rng(seed)
    cam = camlib.to_arrays(CameraConfig(), device)
    lane = torch.as_tensor(
        rng.choice(1920 * 1080, n_rays // 2, replace=False).astype(np.int64),
        device=device)
    o1, d1 = camlib.lane_rays(cam, lane, 1920, 1080)
    m = n_rays - n_rays // 2
    o2 = torch.as_tensor(
        rng.normal(size=(m, 3)).astype(np.float32) * 6, device=device)
    aim = torch.as_tensor(
        rng.normal(size=(m, 3)).astype(np.float32) * 2, device=device)
    d2 = aim - o2
    d2 = d2 / torch.linalg.norm(d2, dim=1, keepdim=True)
    return torch.cat([o1, o2]), torch.cat([d1, d2])


def check_parity(n_rays: int = 2048, chunk: int = 512, seed: int = 5,
                 scene: Scene | None = None, device="cuda") -> dict:
    """traverse_packet_slim over the packet tables the renderer routes
    through (scene.packet_tables) against brute force over every triangle
    of the scene (DeviceScene.tris9, in global triangle order): hit ids
    exact, t within 1e-5 relative, any-hit existence exact, bvh_depth >= 1
    on hits.  Where the scene builds any-hit tables (occl_tables) their
    any hit is checked the same way, and under CPUGPU_LEAF14 the closest
    hits over them must be bitwise the shading tables'.  `scene` defaults
    to config 3's (make_reference_scene)."""
    dv = resolve_device(device)
    scene = scene if scene is not None else make_reference_scene()
    dev = scene.device(dv)
    p_nodes, p_ltris, p_fused_nn, p_ents = packet_tables(dev)
    tris = dev.tris9
    v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]

    o, d = gate_rays(n_rays, seed, dv)
    t0 = torch.full((n_rays,), RAY_TMAX, dtype=torch.float32, device=dv)

    t, hit, obj, normal, depth = tps.traverse_packet_slim(
        o, d, t0, p_nodes, p_ltris, dev.proots, fused_nn=p_fused_nn,
        width=dev.packet_width, ents=p_ents)
    _, hit_any, _, _, _ = tps.traverse_packet_slim(
        o, d, t0, p_nodes, p_ltris, dev.proots, any_hit=True,
        fused_nn=p_fused_nn, width=dev.packet_width, ents=p_ents)
    bt, bidx = _brute(o, d, v0, e1, e2, t0, chunk)

    hit_np = _host(hit)
    t_np = _host(t)
    mism = int((hit_np != bidx).sum())
    hm = bidx >= 0
    max_rel = _max_rel(t_np, bt, hm)
    any_mism = int(((_host(hit_any) >= 0) != hm).sum())
    _require(mism == 0,
             f"{mism}/{n_rays} kernel hit ids differ from the oracle")
    _require(max_rel < 1e-5, f"kernel t deviates rel {max_rel:.2e}")
    _require(any_mism == 0, f"{any_mism} any-hit occlusion mismatches")
    _require(not hm.any() or int(_host(depth)[hm].min()) >= 1,
             "bvh_depth is zero on hits")
    res = {"ok": True, "checked": int(n_rays), "backend": str(dv),
           "max_t_rel": max_rel}

    occ = occl_tables(dev)
    if occ is not None:
        onodes, oltris, oroots, oents = occ
        _, ohit, *_ = tps.traverse_packet_slim(
            o, d, t0, onodes, oltris, oroots, any_hit=True, occl=True,
            ents=oents, width=dev.poccl_width, occl_rows=dev.poccl_rows)
        o_mism = int(((_host(ohit) >= 0) != hm).sum())
        _require(o_mism == 0,
                 f"{o_mism} occl-table any-hit occlusion mismatches")
        res["occl_any_hit_checked"] = True
        if dev.poccl_pay is not None:
            lt, lhit, lobj, lnrm, _ = tps.traverse_packet_slim(
                o, d, t0, onodes, oltris, oroots, occl=True,
                pay=dev.poccl_pay)
            l_mism = int((_host(lhit) != hit_np).sum())
            _require(l_mism == 0, f"{l_mism} leaf-14 closest-hit ids differ "
                     "from the shading tables")
            np.testing.assert_array_equal(_host(lt)[hm], t_np[hm],
                                          err_msg="leaf-14 t")
            np.testing.assert_array_equal(_host(lobj)[hm], _host(obj)[hm],
                                          err_msg="leaf-14 obj")
            for c in range(3):
                np.testing.assert_array_equal(
                    _host(lnrm[c])[hm], _host(normal[c])[hm],
                    err_msg=f"leaf-14 normal[{c}]")
            res["leaf14_checked"] = True
    return res


def _ring_of_spheres() -> tuple:
    """Six scaled, rotated instances of icosphere(subdivisions=3):
    (scene, (6, 4, 4) transforms)."""
    s = Scene()
    white = s.add_material(matlib.Material.diffuse((0.8, 0.8, 0.8)))
    mesh = meshlib.icosphere(subdivisions=3)  # 1280 triangles
    mats = []
    for i in range(6):
        ang = 2 * np.pi * i / 6
        c, sn = np.cos(ang), np.sin(ang)
        scale = 0.6 + 0.15 * i
        mats.append(np.array([
            [c * scale, 0, sn * scale, 3.0 * c],
            [0, scale, 0, 0.4 * i - 1.0],
            [-sn * scale, 0, c * scale, 3.0 * sn],
            [0, 0, 0, 1],
        ], np.float32))
    s.add_instanced_mesh("spheres", mesh, white, np.stack(mats))
    return s, mats


def check_parity_instanced(n_rays: int = 2048, chunk: int = 512,
                           seed: int = 9, device="cuda") -> dict:
    """intersect_scene on six instanced icospheres against brute force:
    on a flattened scene (the default) over its world-space leaf records,
    on the object-space machinery (CPUGPU_NO_FLATTEN=1, B4's instance arm)
    per instance in object space, nearest across instances.  Triangle and
    instance ids exact, world t within 1e-5 relative, and more than a
    tenth of the rays hit."""
    dv = resolve_device(device)
    rng = np.random.default_rng(seed)
    s, mats = _ring_of_spheres()
    dev = s.device(dv)

    o_np = rng.normal(size=(n_rays, 3)).astype(np.float32) * 5
    aim = rng.normal(size=(n_rays, 3)).astype(np.float32) * 2
    d_np = aim - o_np
    d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
    o = torch.as_tensor(o_np, device=dv)
    d = torch.as_tensor(d_np, device=dv)
    t0 = torch.full((n_rays,), RAY_TMAX, dtype=torch.float32, device=dv)

    hit = intersect_scene(dev, o, d, t0)
    k_t, k_tri, k_iid = _host(hit.t), _host(hit.prim), _host(hit.inst)

    best_t = np.full(n_rays, np.float32(RAY_TMAX))
    best_tri = np.full(n_rays, -1, np.int32)
    best_iid = np.full(n_rays, -1, np.int32)

    def nearest(oo, dd, v0, e1, e2, ids, iid):
        for st in range(0, n_rays, chunk):
            sl = slice(st, st + chunk)
            bt, bidx = intersect.brute_force_nearest_triangle(
                oo[sl], dd[sl], v0, e1, e2,
                torch.as_tensor(best_t[sl], device=dv))
            bt, bidx = _host(bt), _host(bidx)
            better = bidx >= 0
            best_t[sl] = np.where(better, bt, best_t[sl])
            best_tri[sl] = np.where(better, ids[np.maximum(bidx, 0)],
                                    best_tri[sl])
            best_iid[sl] = np.where(better, iid, best_iid[sl])

    if dev.packet_flattened:
        # the kernel walks world-space leaf records: the oracle is brute
        # force over those records (16 cols each, the id in col 13), in id
        # order so that a tie keeps the lowest id, as the kernel does
        rec = dev.pltris.reshape(-1, 16)
        ids = rec[:, 13].view(torch.int32)
        rec = rec[ids >= 0]
        rec = rec[torch.argsort(rec[:, 13].view(torch.int32).to(torch.int64),
                                stable=True)]
        nearest(o, d, rec[:, 0:3], rec[:, 3:6], rec[:, 6:9],
                _host(rec[:, 13].view(torch.int32)), -1)
    else:
        mesh = s.objects[0].mesh
        tri = mesh.positions[mesh.indices.reshape(-1, 3).astype(np.int64)]
        v0 = torch.as_tensor(tri[:, 0], device=dv)
        e1 = torch.as_tensor(tri[:, 1] - tri[:, 0], device=dv)
        e2 = torch.as_tensor(tri[:, 2] - tri[:, 0], device=dv)
        ids = np.arange(tri.shape[0], dtype=np.int32)
        for iid, m in enumerate(mats):
            inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
            oo = o_np @ inv[:3, :3].T + inv[:3, 3]
            dd = d_np @ inv[:3, :3].T  # unnormalised: t stays the world t
            nearest(torch.as_tensor(oo, device=dv),
                    torch.as_tensor(dd, device=dv), v0, e1, e2, ids, iid)

    mism = int(((k_tri != best_tri) | (k_iid != best_iid)).sum())
    hm = best_tri >= 0
    max_rel = _max_rel(k_t, best_t, hm)
    _require(mism == 0,
             f"{mism}/{n_rays} instanced hits differ from the oracle")
    _require(max_rel < 1e-5, f"instanced t deviates rel {max_rel:.2e}")
    _require(hm.sum() > n_rays // 10,
             "degenerate instanced gate: too few hits")
    return {"ok": True, "checked": int(n_rays), "hits": int(hm.sum()),
            "backend": str(dv), "flattened": bool(dev.packet_flattened),
            "max_t_rel": max_rel}


def _energy_contract(ref, got, flip_share: float) -> dict:
    """The megakernel contract of the two energy gates: traced and RNG
    state exact; energy within 3e-6 + 3e-5 |ref| on all but a share of
    lanes below flip_share (occlusion flips at silhouettes), and no lane
    off by 0.05 or more."""
    (st_ref, r), (st_got, g) = ref, got
    _require(int(r.traced_rays) == int(g.traced_rays), "traced mismatch")
    _require(torch.equal(st_ref, st_got), "rng state")
    ea, em = _host(r.energy), _host(g.energy)
    diff = np.abs(ea - em)
    flips = (diff > 3e-6 + 3e-5 * np.abs(ea)).any(axis=1)
    _require(flips.mean() < flip_share,
             f"{int(flips.sum())} lanes beyond boundary flips")
    _require(diff.max() < 0.05, f"flip magnitude {diff.max():.4f}")
    return {"flip_lanes": int(flips.sum()),
            "max_energy_diff": float(diff.max())}


def _frame_lanes(cam_cfg: CameraConfig, w: int, h: int, seed: int, dv):
    n = w * h
    cam = camlib.to_arrays(cam_cfg, dv)
    lane = torch.arange(n, dtype=torch.int64, device=dv)
    o, d = camlib.lane_rays(cam, lane, w, h)
    return o, d, rnglib.seed_lanes(lane, 0, salt=seed)


def check_parity_whitted(w: int = 64, h: int = 32, seed: int = 0x1CE,
                         device="cuda") -> dict:
    """The whole-frame Whitted kernel (trace_whitted_kernel) against the
    per-depth trace_whitted on config 1's scene: traced and RNG state
    exact, fewer than 1% of lanes beyond the energy contract, every lane
    within 0.05."""
    dv = resolve_device(device)
    dev = whitted.make_whitted_scene().device(dv)
    settings = RenderSettings(render_mode=RenderMode.WHITTED)
    o, d, state = _frame_lanes(
        CameraConfig(pos=(0.0, 0.5, 8.0), aspect=w / h), w, h, seed, dv)
    ref = whitted.trace_whitted(dev, settings, o, d, state, idx=None)
    got = whitted.trace_whitted_kernel(dev, settings, o, d, state, idx=None)
    return {"ok": True, "checked": w * h, "backend": str(dv),
            **_energy_contract(ref, got, 0.01)}


def check_parity_ptframe(w: int = 64, h: int = 32, seed: int = 0x9E7,
                         device="cuda") -> dict:
    """The whole-frame kernel (trace_advanced_frame, pt_frame) against the
    per-depth pipeline (trace_advanced_mega) on an icosphere, a ground
    quad and a sphere light, a scene the whole-frame gate admits: traced
    and RNG state exact, fewer than 3% of lanes beyond the energy
    contract, every lane within 0.05."""
    dv = resolve_device(device)
    s = Scene()
    white = s.add_material(matlib.Material.diffuse((0.85, 0.85, 0.85)))
    shiny = s.add_material(
        matlib.Material.diffuse((0.9, 0.7, 0.3), specular=0.35))
    light = s.add_material(matlib.Material.light((1.0, 0.95, 0.8), 10.0))
    s.add_mesh("ball", meshlib.icosphere(radius=1.5, subdivisions=2), shiny)
    s.add_mesh("ground", meshlib.ground_quad(y=-2.0), white)
    li = s.add_sphere("light", (10.0, 10.0, 10.0), 5.0, light)
    s.mark_light(li)
    dev = s.device(dv)
    settings = RenderSettings()
    reason = pt_frame_gate_reason(dev, settings)
    _require(reason is None, f"pt-frame gate unexpectedly closed: {reason}")
    o, d, state = _frame_lanes(
        CameraConfig(pos=(0.0, 0.5, 7.0), aspect=w / h), w, h, seed, dv)
    ref = integrators.trace_advanced_mega(dev, settings, o, d, state)
    got = integrators.trace_advanced_frame(dev, settings, o, d, state)
    return {"ok": True, "checked": w * h, "backend": str(dv),
            **_energy_contract(ref, got, 0.03)}


if __name__ == "__main__":
    print(f"parity gate OK: {check_parity()}")
    print(f"instanced parity gate OK: {check_parity_instanced()}")
    print(f"whitted kernel parity gate OK: {check_parity_whitted()}")
    print(f"whole-frame kernel parity gate OK: {check_parity_ptframe()}")
