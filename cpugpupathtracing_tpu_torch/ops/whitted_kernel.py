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
Two entries: `whitted_frame` takes six ray columns (the JAX function's
form), `whitted_frame_rows` the renderer's (N, 3) origin and direction
as they are; on the card the kernel reads either in place and writes the
(N, 3) energy and the traced total itself, so a call is one launch.

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

import ctypes

import torch

from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import sampling
from cpugpupathtracing_tpu_torch.utils.device import resolve_device
from cpugpupathtracing_tpu_torch.utils.rng import u2f, xs32
from cpugpupathtracing_tpu_torch.utils.vecmath import RAY_NUDGE, RAY_TMAX, sqrt


class _WhittedIO(ctypes.Structure):
    """The ray and traced layout of a launch; mirrors struct
    pt::WhittedIO of csrc/whitted.cuh."""

    _fields_ = [("o_stride", ctypes.c_longlong),
                ("d_stride", ctypes.c_longlong),
                ("traced", ctypes.c_void_p),
                ("scratch", ctypes.c_void_p)]


# per device and stream: add_traced's scratch word (csrc/whitted.cu),
# zeroed once; every launch leaves it zero
_scratch: dict = {}


def whitted_io(traced, o_stride: int, d_stride: int) -> _WhittedIO:
    """The WhittedIO of a launch writing its traced total into `traced`
    (a () int64 tensor) with the given lane strides of the origin and
    direction inputs."""
    dev = traced.device
    key = (str(dev), torch.cuda.current_stream(dev).cuda_stream
           if dev.type == "cuda" else 0)
    if key not in _scratch:
        _scratch[key] = torch.zeros(1, dtype=torch.int64, device=dev)
    io = _WhittedIO()
    io.o_stride, io.d_stride = o_stride, d_stride
    io.traced = traced.data_ptr()
    io.scratch = _scratch[key].data_ptr()
    return io


# the builds whose WhittedIO layout was held against _WhittedIO
_checked: set = set()


def _entries(lib):
    """`lib` (a build's entries) once its struct pt::WhittedIO has
    _WhittedIO's size and offsets (whitted_io_layout); raises otherwise."""
    if id(lib) not in _checked:
        got = (ctypes.c_longlong * 3)()
        lib.whitted_io_layout(ctypes.addressof(got))
        want = (ctypes.sizeof(_WhittedIO), _WhittedIO.traced.offset,
                _WhittedIO.scratch.offset)
        if tuple(got) != want:
            raise RuntimeError(f"WhittedIO layout {tuple(got)} (size, "
                               f"traced, scratch) differs from the ctypes "
                               f"mirror's {want}")
        _checked.add(id(lib))
    return lib


def whitted_frame(
    mats, lights, sph, pln, sphmat, plnmat, objmat, rays, state,
    *, num_mats, num_lights, num_sph, num_pln, depths, count_iters=False,
):
    """Whitted trace of rays (6-tuple of (N,) f32 columns) with RNG state
    (N,) (int64 carrying u32) over the small scene tables of
    models/scene.DeviceScene (mk_mats, mk_lights, mk_sph, mk_pln,
    mk_sph_mat, mk_pln_mat, mk_objmat).  Returns (energy (N, 3) f32,
    state' (N,), traced () int64); with count_iters=True (CUDA only) also
    ops/pt_frame.py's fourteen work counters, of which `ray` (live
    depths), `sray` (shadow rays), `wtrip` / `ltrip` (per depth, the warps
    with a live path and their live paths) and `longest` (the most live
    depths of one path) count."""
    del num_mats  # read from the table shape
    return _frame((mats, lights, sph, pln, sphmat, plnmat, objmat), rays,
                  None, state, num_lights=num_lights, num_sph=num_sph,
                  num_pln=num_pln, depths=depths, count_iters=count_iters)


def whitted_frame_rows(
    mats, lights, sph, pln, sphmat, plnmat, objmat, origin, direction, state,
    *, num_mats, num_lights, num_sph, num_pln, depths, count_iters=False,
):
    """`whitted_frame` on rays given as (N, 3) f32 origin and direction
    (each row-major with any row stride: the camera's origin, one row
    expanded over every lane, is read as it is); the same returns.  On
    the card the kernel reads them in place, so the launch is the only
    device operation of the call."""
    del num_mats  # read from the table shape
    return _frame((mats, lights, sph, pln, sphmat, plnmat, objmat), None,
                  (origin, direction), state, num_lights=num_lights,
                  num_sph=num_sph, num_pln=num_pln, depths=depths,
                  count_iters=count_iters)


def _frame(tables, rays, rows, state, *, count_iters, **kw):
    dev = state.device
    if dev.type == "cpu":
        if count_iters:
            raise ValueError("count_iters needs the CUDA kernel")
        if rays is None:
            rays = _columns(*rows)
        return whitted_frame_reference(*tables, rays, state, **kw)
    if dev.type != "cuda":
        raise ValueError(f"whitted_frame runs on cuda or cpu tensors, not {dev}")
    out = launch(_entries(ptf.build()).whitted_launch, dev, tables, rays,
                 state, rows=rows, count_iters=count_iters, **kw)
    ptf.count_launch("whitted_frame")
    return out


def _columns(origin, direction) -> tuple:
    return tuple(origin[:, k] for k in range(3)) + tuple(
        direction[:, k] for k in range(3))


def whitted_frame_host(mats, lights, sph, pln, sphmat, plnmat, objmat, rays,
                       state, *, num_lights, num_sph, num_pln, depths,
                       count_iters=False, rows=None, **_):
    """`whitted_frame` (or with `rows` = (origin, direction) and rays None,
    `whitted_frame_rows`) through the g++ build of the kernel body, on
    CPU tensors: a test of the device code without a card."""
    return launch(_entries(ptf.build_host()).whitted_host,
                  torch.device("cpu"),
                  (mats, lights, sph, pln, sphmat, plnmat, objmat), rays,
                  state, rows=rows, num_lights=num_lights, num_sph=num_sph,
                  num_pln=num_pln, depths=depths, count_iters=count_iters)


def _row_ptrs(name, x, dev, n) -> tuple:
    """The three component pointers and the lane stride of an (n, 3) f32
    row-major input."""
    if (x.device != dev or x.dtype != torch.float32 or x.dim() != 2
            or tuple(x.shape) != (n, 3) or (n > 0 and x.stride(1) != 1)):
        raise ValueError(f"{name}: need an (n, 3) f32 tensor on {dev} with "
                         f"unit column stride, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()} on "
                         f"{x.device}")
    return tuple(x.data_ptr() + 4 * k for k in range(3)), x.stride(0)


def launch(entry, dev, tables, rays, state, *, num_lights, num_sph, num_pln,
           depths, rows=None, count_iters=False):
    """One launch of the Whitted entry on 6 ray columns `rays`, or on
    `rows` = (origin, direction) (N, 3); the launch walks no tree and
    reads no light triangles (a cached zero table stands in).  It writes
    the (N, 3) energy, the state and the traced total itself."""
    mats, lights, sph, pln, sphmat, plnmat, objmat = tables
    n = state.shape[0]
    ptf._check("state", state, torch.int64, dev, (n,))
    small = (mats, lights, ptf.dummy_tables(dev)[2], sph, pln, sphmat,
             plnmat, objmat)
    a = ptf.launch_args(dev, None, None, None, None, small, rays, n=n,
                        roots=(), sh_roots=(), num_sph=num_sph,
                        num_pln=num_pln, num_lights=num_lights,
                        depths=depths)
    if rows is None:
        strides = (1, 1)
    else:
        (o_ptrs, o_stride), (d_ptrs, d_stride) = (
            _row_ptrs("origin", rows[0], dev, n),
            _row_ptrs("direction", rows[1], dev, n))
        for c in range(3):
            a.ray[c], a.ray[3 + c] = o_ptrs[c], d_ptrs[c]
        strides = (o_stride, d_stride)
    a.state = state.data_ptr()
    energy = torch.empty((n, 3), dtype=torch.float32, device=dev)
    st = torch.empty(n, dtype=torch.int64, device=dev)
    traced = torch.empty((), dtype=torch.int64, device=dev)
    if n == 0:
        return energy, st, traced.zero_()
    for c in range(3):
        a.en_out[c] = energy.data_ptr() + 4 * c
    a.state_out = st.data_ptr()
    io = whitted_io(traced, *strides)
    if count_iters:
        counted = ptf.count_rows(a, dev, {})
    rc = entry(ctypes.addressof(a), ctypes.addressof(io))
    if rc != 0:
        raise RuntimeError(f"whitted_frame launch failed (error {rc})")
    out = (energy, st, traced)
    if count_iters:
        return out + (ptf.counters(*counted),)
    return out


def resident_threads(dev, count_iters: bool = False) -> int:
    """The threads the card keeps resident for whitted_frame's kernel arm
    (its count arm with count_iters) on config-sized tables: the card's
    SMs x its blocks per SM x 128.  A query: nothing is launched."""
    dev = resolve_device(dev)
    mats, lights, ltri, sph, pln, sphmat, plnmat, objmat = \
        ptf.dummy_tables(dev)
    a = ptf.launch_args(dev, None, None, None, None,
                        (mats, lights, ltri, sph, pln, sphmat, plnmat,
                         objmat), None, n=1, roots=(), sh_roots=())
    if count_iters:
        iters = torch.zeros(ptf.NUM_COUNTERS, dtype=torch.int64, device=dev)
        a.iters = iters.data_ptr()
    io = _WhittedIO()
    got = _entries(ptf.build()).whitted_resident(ctypes.addressof(a),
                                                 ctypes.addressof(io))
    if got < 0:
        raise RuntimeError(f"whitted_resident failed (error {-got})")
    return got


def whitted_frame_reference(mats, lights, sph, pln, sphmat, plnmat, objmat,
                            rays, state, *, num_lights, num_sph, num_pln,
                            depths):
    """The plain version of `whitted_frame` (same returns): the depth loop
    of _whitted_kernel over every lane, masked like the Pallas kernel's
    vector code."""
    tables = (mats, lights, sph, pln, sphmat, plnmat, objmat)
    c = whitted_carry(rays, state)
    for _ in range(depths):
        c = whitted_depth(tables, c, num_lights=num_lights, num_sph=num_sph,
                          num_pln=num_pln)
    return torch.stack(c["en"], dim=1), c["st"], c["tr"].sum()


def whitted_carry(rays, state) -> dict:
    """The carry of fresh paths between the plain version's depths: rays
    (o, d: 3 columns each), throughput, energy, the live mask, RNG state
    and the rays each lane traced."""
    n = state.shape[0]
    dev = state.device
    one = torch.ones(n, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(one)
    return dict(o=tuple(rays[:3]), d=tuple(rays[3:]), tp=(one,) * 3,
                en=(zero,) * 3, act=torch.ones(n, dtype=torch.bool, device=dev),
                st=state, tr=torch.zeros(n, dtype=torch.int64, device=dev))


def whitted_depth(tables, c: dict, *, num_lights, num_sph, num_pln) -> dict:
    """One depth of the plain version on the carry c (whitted_carry):
    the next carry."""
    mats, lights, sph, pln, sphmat, plnmat, objmat = tables
    (ox, oy, oz), (dx, dy, dz) = c["o"], c["d"]
    (tpx, tpy, tpz), (enx, eny, enz) = c["tp"], c["en"]
    act, st, tr = c["act"], c["st"], c["tr"]
    n = st.shape[0]
    dev = st.device
    one = torch.ones(n, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(one)
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
        ctr = sph[s]
        vx, vy, vz = px - ctr[0], py - ctr[1], pz - ctr[2]
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
    return dict(o=(ox, oy, oz), d=(dx, dy, dz), tp=(tpx, tpy, tpz),
                en=(enx, eny, enz), act=act, st=st, tr=tr)
