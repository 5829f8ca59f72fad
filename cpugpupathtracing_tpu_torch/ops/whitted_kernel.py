"""`whitted_frame`: the whole Whitted trace of a batch of rays over an
all-analytic scene (spheres, planes, point lights; benchmark config 1) in
one launch -- every depth's sphere / plane closest hit, light-hit
emission, per-light hard shadows and the dielectric / mirror
continuation.

It replaces the JAX package's Pallas kernel ops/whitted_kernel.py
(`_whitted_kernel`, launched by `whitted_frame`).  On CUDA tensors the
wrapper launches the hand-written kernel of csrc/whitted.cu (per-lane
body in csrc/whitted.cuh), built by ops/pt_frame.py's `build`.  On CPU
tensors it runs `whitted_frame_reference`, the kernel's body
lane-vectorised in PyTorch; nothing falls back from one to the other.

Both versions follow the JAX kernel op for op: every lane steps its RNG
state once per depth, dead or alive (as models/whitted.trace_whitted
does), so states, traced counts and energies agree bitwise between them.
Against trace_whitted itself state and traced are exact and energy meets
the megakernel contract (the two are shaped differently; the JAX
package's tests/test_whitted_kernel.py pins the same).  The TPU kernel's
padding to 8192-lane blocks has no counterpart: one thread per lane.
RNG states are u32 values carried in int64 tensors (utils/rng.py).
"""

from __future__ import annotations

import torch

from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import sampling
from cpugpupathtracing_tpu_torch.utils.rng import u2f, xs32
from cpugpupathtracing_tpu_torch.utils.vecmath import RAY_NUDGE, RAY_TMAX, sqrt


def whitted_frame(
    mats, lights, sph, pln, sphmat, plnmat, objmat, rays, state,
    *, num_mats, num_lights, num_sph, num_pln, depths, count_iters=False,
):
    """Whitted trace of rays (6-tuple of (N,) f32) with RNG state (N,)
    (int64 carrying u32) over the small scene tables of
    models/scene.DeviceScene (mk_mats, mk_lights, mk_sph, mk_pln,
    mk_sph_mat, mk_pln_mat, mk_objmat).  Returns (energy (N, 3) f32,
    state' (N,), traced () int64); with count_iters=True (CUDA only) also
    ops/pt_frame.py's ten work counters, of which `ray` (live depths) and
    `sray` (shadow rays) count."""
    del num_mats  # read from the table shape
    tables = (mats, lights, sph, pln, sphmat, plnmat, objmat)
    dev = state.device
    kw = dict(num_lights=num_lights, num_sph=num_sph, num_pln=num_pln,
              depths=depths)
    if dev.type == "cpu":
        if count_iters:
            raise ValueError("count_iters needs the CUDA kernel")
        return whitted_frame_reference(*tables, rays, state, **kw)
    if dev.type != "cuda":
        raise ValueError(f"whitted_frame runs on cuda or cpu tensors, not {dev}")
    out = launch(ptf.build().whitted_launch, dev, tables, rays, state,
                 count_iters=count_iters, **kw)
    ptf.count_launch("whitted_frame")
    return out


def whitted_frame_host(mats, lights, sph, pln, sphmat, plnmat, objmat, rays,
                       state, *, num_lights, num_sph, num_pln, depths,
                       count_iters=False, **_):
    """`whitted_frame` through the g++ build of the kernel body, on CPU
    tensors: a test of the device code without a card."""
    return launch(ptf.build_host().whitted_host, torch.device("cpu"),
                  (mats, lights, sph, pln, sphmat, plnmat, objmat), rays,
                  state, num_lights=num_lights, num_sph=num_sph,
                  num_pln=num_pln, depths=depths, count_iters=count_iters)


def launch(entry, dev, tables, rays, state, *, num_lights, num_sph, num_pln,
           depths, count_iters=False):
    """One launch of the Whitted entry; the launch walks no tree and reads
    no light triangles (a cached zero table stands in)."""
    mats, lights, sph, pln, sphmat, plnmat, objmat = tables
    n = state.shape[0]
    ptf._check("state", state, torch.int64, dev, (n,))
    small = (mats, lights, ptf.dummy_tables(dev)[2], sph, pln, sphmat,
             plnmat, objmat)
    a = ptf.launch_args(dev, None, None, None, None, small, rays, n=n,
                        roots=(), sh_roots=(), num_sph=num_sph,
                        num_pln=num_pln, num_lights=num_lights,
                        depths=depths)
    a.state = state.data_ptr()
    en = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3)]
    st = torch.empty(n, dtype=torch.int64, device=dev)
    tr = torch.empty(n, dtype=torch.int32, device=dev)
    for c in range(3):
        a.en_out[c] = en[c].data_ptr()
    a.state_out, a.tr_out = st.data_ptr(), tr.data_ptr()
    if count_iters:
        counted = ptf.count_rows(a, dev, {})
    ptf.run_launch(entry, a, "whitted_frame")
    out = (torch.stack(en, dim=1), st, tr.sum(dtype=torch.int64))
    if count_iters:
        return out + (ptf.counters(*counted),)
    return out


def whitted_frame_reference(mats, lights, sph, pln, sphmat, plnmat, objmat,
                            rays, state, *, num_lights, num_sph, num_pln,
                            depths):
    """The plain version of `whitted_frame` (same returns): the depth loop
    of _whitted_kernel over every lane, masked like the Pallas kernel's
    vector code."""
    n = state.shape[0]
    dev = state.device
    ox, oy, oz, dx, dy, dz = rays
    st = state
    one = torch.ones(n, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(one)
    tpx = tpy = tpz = one
    enx = eny = enz = zero
    act = torch.ones(n, dtype=torch.bool, device=dev)
    tr = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(depths):
        tr = tr + act
        t, kind = ptf._analytic_tests(
            sph, pln, num_sph, num_pln, ox, oy, oz, dx, dy, dz,
            torch.full_like(one, RAY_TMAX),
            torch.zeros(n, dtype=torch.int32, device=dev))
        act = act & (kind > 0)

        # hit surface (models/scene.hit_surface, analytic arms)
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        nx = ny = nz = zero
        mat_idx = objmat[0].expand(n)
        for s in range(num_sph):
            is_s = kind == 1 + s
            c = sph[s]
            vx, vy, vz = px - c[0], py - c[1], pz - c[2]
            l_s = sqrt(vx * vx + vy * vy + vz * vz)
            nx = torch.where(is_s, vx / l_s, nx)
            ny = torch.where(is_s, vy / l_s, ny)
            nz = torch.where(is_s, vz / l_s, nz)
            mat_idx = torch.where(is_s, sphmat[s], mat_idx)
        for q in range(num_pln):
            is_p = kind == 1 + num_sph + q
            nx = torch.where(is_p, pln[q, 3], nx)
            ny = torch.where(is_p, pln[q, 4], ny)
            nz = torch.where(is_p, pln[q, 5], nz)
            mat_idx = torch.where(is_p, plnmat[q], mat_idx)
        in_mat = (mat_idx >= 0) & (mat_idx < mats.shape[0])
        m = mats[torch.where(in_mat, mat_idx, 0).long()]  # (n, 14)
        alb_r, alb_g, alb_b = m[:, 0], m[:, 1], m[:, 2]
        m_spec, m_refr, m_ior = m[:, 3], m[:, 4], m[:, 8]

        # light hit: emission, then the path ends
        hit_light = act & (m[:, 13] > 0.5)
        inten = m[:, 12]
        enx = enx + torch.where(hit_light, tpx * m[:, 9] * inten, zero)
        eny = eny + torch.where(hit_light, tpy * m[:, 10] * inten, zero)
        enz = enz + torch.where(hit_light, tpz * m[:, 11] * inten, zero)
        act = act & ~hit_light

        # direct lighting: point lights in order, hard shadows
        dw = torch.clamp(1.0 - m_spec - m_refr, min=0.0)
        dir_r = dir_g = dir_b = zero
        for li in range(num_lights):
            L = lights[li]
            tlx, tly, tlz = L[0] - px, L[1] - py, L[2] - pz
            dist = sqrt(tlx * tlx + tly * tly + tlz * tlz)
            d_d = torch.clamp(dist, min=1e-20)
            tlx, tly, tlz = tlx / d_d, tly / d_d, tlz / d_d
            ndotl = nx * tlx + ny * tly + nz * tlz
            want = act & (dw > 0.0) & (ndotl > 0.0)
            tr = tr + want
            stmax = dist - L[3] - 2.0 * RAY_NUDGE
            occ = ptf._analytic_occluded(
                sph, pln, num_sph, num_pln,
                (px + tlx * RAY_NUDGE, py + tly * RAY_NUDGE,
                 pz + tlz * RAY_NUDGE), (tlx, tly, tlz), stmax)
            vis = want & ~occ
            atten = 1.0 / torch.clamp(dist * dist, min=1e-20)
            dir_r = dir_r + torch.where(vis, (ndotl * atten) * L[5], zero)
            dir_g = dir_g + torch.where(vis, (ndotl * atten) * L[6], zero)
            dir_b = dir_b + torch.where(vis, (ndotl * atten) * L[7], zero)
        enx = enx + torch.where(act, tpx * dw * alb_r * dir_r, zero)
        eny = eny + torch.where(act, tpy * dw * alb_g * dir_g, zero)
        enz = enz + torch.where(act, tpz * dw * alb_b * dir_b, zero)

        # continuation: dielectric first, else mirror, else the path ends
        ddn = dx * nx + dy * ny + dz * nz
        rfx, rfy, rfz = sampling.reflect((dx, dy, dz), (nx, ny, nz), ddn)
        cosi_raw = torch.clamp(ddn, -1.0, 1.0)
        outside = cosi_raw < 0.0
        inside = ~outside
        cosi = torch.abs(cosi_raw)
        etai = torch.where(outside, one, m_ior)
        etat = torch.where(outside, m_ior, one)
        nrx = torch.where(outside, nx, -nx)
        nry = torch.where(outside, ny, -ny)
        nrz = torch.where(outside, nz, -nz)
        eta = etai / etat
        kk = 1.0 - eta * eta * (1.0 - cosi * cosi)
        tir = kk < 0.0
        coef = eta * cosi - sqrt(torch.clamp(kk, min=0.0))
        rx = dx * eta + coef * nrx
        ry = dy * eta + coef * nry
        rz = dz * eta + coef * nrz
        l_r = sqrt(rx * rx + ry * ry + rz * rz)
        rx, ry, rz = rx / l_r, ry / l_r, rz / l_r
        angle_out = rx * nx + ry * ny + rz * nz
        fr = torch.where(tir, one,
                         sampling.fresnel(ddn, angle_out, etai, etat))
        st = xs32(st)
        choose_refract = u2f(st) > fr

        has_refr = m_refr > 0.0
        cont_diel = act & has_refr & ~tir
        diel_refract = cont_diel & choose_refract
        diel_reflect = cont_diel & ~choose_refract
        cont_spec = act & ~has_refr & (m_spec > 0.0)
        tir_reflect = act & has_refr & tir
        die = act & ~cont_diel & ~cont_spec & ~tir_reflect

        refl = cont_spec | diel_reflect | tir_reflect
        ndx = torch.where(diel_refract, rx, torch.where(refl, rfx, dx))
        ndy = torch.where(diel_refract, ry, torch.where(refl, rfy, dy))
        ndz = torch.where(diel_refract, rz, torch.where(refl, rfz, dz))

        diel_any = diel_refract | diel_reflect | tir_reflect
        ref_in = diel_refract & inside
        tms = []
        for alb, ab in ((alb_r, m[:, 5]), (alb_g, m[:, 6]), (alb_b, m[:, 7])):
            tm = torch.where(diel_any, m_refr * alb, one)
            tm = torch.where(ref_in, m_refr * alb * torch.exp(-ab * t), tm)
            tms.append(torch.where(cont_spec, m_spec * alb, tm))
        tpx, tpy, tpz = tpx * tms[0], tpy * tms[1], tpz * tms[2]

        act = act & ~die
        bounced = refl | diel_refract
        ox = torch.where(bounced, px + ndx * RAY_NUDGE, ox)
        oy = torch.where(bounced, py + ndy * RAY_NUDGE, oy)
        oz = torch.where(bounced, pz + ndz * RAY_NUDGE, oz)
        dx, dy, dz = (torch.where(bounced, ndx, dx),
                      torch.where(bounced, ndy, dy),
                      torch.where(bounced, ndz, dz))
    return torch.stack([enx, eny, enz], dim=1), st, tr.sum()
