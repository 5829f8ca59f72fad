"""The per-depth kernels of the ADVANCED path tracer: `shade_extend` (one
depth of closest hit + shading) and `shadow_resolve` (the NEE shadow
any-hit + energy add), which models/integrators.py's
`trace_advanced_mega` launches once each per depth.

They replace the JAX package's Pallas kernels of ops/megakernel.py
(`_shade_extend_kernel` launched by `shade_extend`, `_shadow_resolve_kernel`
launched by `shadow_resolve`), with their instance arms.  On CUDA tensors
the wrappers launch the hand-written kernels of csrc/megakernel.cu (per-lane
bodies in csrc/pt_device.cuh, shared with pt_frame), built by
ops/pt_frame.py's `build`.  On CPU tensors they run the plain versions
`shade_extend_reference` and `shadow_resolve_reference`; nothing falls
back from one to the other.

Per-lane rules (both versions):
  * shade_extend: a lane whose flags say not active passes its columns
    through, writes flags & 3 and zero shadow columns, and keeps its RNG
    state (the TPU kernel keeps stepping the state of a dead lane in a
    live 1024-lane tile; energy and traced counts are unaffected).  A
    live lane writes its next ray and carry, flags | sneed << 2, and its
    shadow ray: origin, direction, tmax and contribution, all zero unless
    sneed.
  * shadow_resolve: a lane with sneed adds its contribution when neither
    the any-hit tree nor the analytic occluders block the shadow ray;
    every other lane copies its energy.

Instance arm (inst_inv / inst_nrm / inst_root given: a scene on the
object-space TLAS machinery of models/scene.py): both walks run the TLAS
instance machinery of ops/traverse_packet_slim.py, and shade_extend turns
an instance hit's object-space normal into normalize(inst_nrm @ n) before
shading.  The plain versions then take their hits from
pt_frame.closest_hit_instances_reference; the kernels equal them bitwise.

Node-table variants (the JAX kernels' arms): `ents` (the entry side
table, with 64- or 48-col rows), `width=16` and `fused_nn` (the fused
node|leaf table) launch the kernels' variant arm, counted per layout in
ops/pt_frame.py `launches` (launch_key) as every arm is; the plain
versions are brute force, which no layout changes.  As in the JAX
package a side table given with the instance arm is dropped (16-wide and
fused tables raise there).

Leaf arms (the JAX kernels' CPUGPU_LEAF14 and CPUGPU_OCCL2 arms):
shade_extend with `pay` walks the occlusion tree (8-wide, 64- or 48-col
rows, with or without its side table) for the closest hit, with the
leaf-14 payload rows giving each record's normal, object and id; its
plain version is brute force over those records (pt_frame.leaf_records
with pay).  shadow_resolve with `occl_rows=2` walks occlusion leaves of
two rows, and over 16-wide occlusion rows (`width=16`, occl;
CPUGPU_OCCL_W16) its variant arm; their plain version is brute force
over every occlusion row.  Each is counted apart (pt_frame.leaf_arm).
"""

from __future__ import annotations

import torch

from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops.intersect import (
    brute_force_nearest_triangle,
)

_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64


def _cols(name, cols, count, dtype, dev, n):
    if len(cols) != count:
        raise ValueError(f"{name}: need {count} columns, got {len(cols)}")
    for c, x in enumerate(cols):
        ptf._check(f"{name}[{c}]", x, dtype, dev, (n,))


# ---- shade_extend ------------------------------------------------------------


def shade_extend(
    nodes, ltris, mats, lights, ltri, sph, pln, sphmat, plnmat, objmat,
    depth, rays, state, throughput, energy, flags,
    *, roots, num_mats, num_lights, num_sph, num_pln, num_objs,
    nee, rr, cosine, ref_pdf, light_tri_meta=(), count_iters=False,
    inst_inv=None, inst_nrm=None, inst_root=None, pay=None, fused_nn=0,
    width=8, ents=None,
):
    """One depth (`depth`, the absolute depth: the NEE double-count guard
    adds emission at depth 0) of the wavefront, minus the shadow resolve.

    rays: 6 (N,) f32 columns; state (N,) int64 carrying u32; throughput,
    energy: 3 (N,) f32 columns each; flags (N,) i32, bit 0 active, bit 1
    is_specular.  Returns (rays', state', throughput', energy', flags'
    (bit 2 = shadow needed), shadow origin (3), shadow direction (3),
    shadow tmax, contribution (3)), the JAX function's tuple; with
    count_iters=True (CUDA only) also pt_frame's fourteen work counters
    (ops/pt_frame.py COUNTERS; the shadow ones 0).  inst_inv (I, 12),
    inst_nrm (I, 9), inst_root (I,): the instance arm; ents, fused_nn,
    width: the node-table variants; pay (NO, 128): the leaf-14 payload
    rows of an occlusion tree (nodes, ltris) (module docstring)."""
    del num_mats, num_objs  # read from the table shapes
    nee = nee and num_lights > 0
    tables = (mats, lights, ltri, sph, pln, sphmat, plnmat, objmat)
    dev = state.device
    inst = ptf.check_instances(dev, inst_inv, inst_root, inst_nrm)
    if pay is not None and (inst is not None or fused_nn or width != 8):
        raise ValueError(
            "shade_extend: leaf-14 tables (bvh8.to_slim_occl + "
            "occl_payload) require the plain non-instanced 8-wide "
            "split-table kernel")
    ents = ptf.resolve_tables("shade_extend", nodes, ents, fused_nn, width,
                              instanced=inst is not None)
    if inst is not None and inst_nrm is None:
        raise ValueError("shade_extend: the instance arm needs inst_nrm")
    if pay is not None:
        ptf.check_pay("shade_extend", pay, ltris, dev)
    if dev.type == "cpu":
        if count_iters:
            raise ValueError("count_iters needs the CUDA kernel")
        return shade_extend_reference(
            ltris, *tables, depth, rays, state, throughput, energy, flags,
            num_lights=num_lights, num_sph=num_sph, num_pln=num_pln, nee=nee,
            rr=rr, cosine=cosine, ref_pdf=ref_pdf,
            light_tri_meta=light_tri_meta,
            records=None if pay is None else ptf.leaf_records(
                ltris, occl=True, pay=pay),
            inst=None if inst is None else (nodes, roots, *inst))
    if dev.type != "cuda":
        raise ValueError(f"shade_extend runs on cuda or cpu tensors, not {dev}")
    out = _shade_extend_launch(
        ptf.build().mk_shade_extend_launch, dev, nodes, ltris, tables,
        int(depth), rays, state, throughput, energy, flags, roots=roots,
        num_lights=num_lights, num_sph=num_sph, num_pln=num_pln, nee=nee,
        rr=rr, cosine=cosine, ref_pdf=ref_pdf, light_tri_meta=light_tri_meta,
        count_iters=count_iters, inst=inst, ents=ents, fused_nn=fused_nn,
        width=width, pay=pay)
    ptf.count_launch("shade_extend",
                     ptf.table_layout(nodes, ents, fused_nn, width),
                     inst=inst is not None, leaf=ptf.leaf_arm(pay=pay))
    return out


def shade_extend_host(
    nodes, ltris, mats, lights, ltri, sph, pln, sphmat, plnmat, objmat,
    depth, rays, state, throughput, energy, flags, *, roots, num_lights,
    num_sph, num_pln, nee, rr, cosine, ref_pdf, light_tri_meta=(),
    count_iters=False, inst_inv=None, inst_nrm=None, inst_root=None,
    ents=None, fused_nn=0, width=8, pay=None, **_,
):
    """`shade_extend` through the g++ build of the kernel body, on CPU
    tensors: a test of the device code without a card."""
    dev = torch.device("cpu")
    inst = ptf.check_instances(dev, inst_inv, inst_root, inst_nrm)
    if pay is not None:
        ptf.check_pay("shade_extend", pay, ltris, dev)
    return _shade_extend_launch(
        ptf.build_host().mk_shade_extend_host, dev, nodes,
        ltris, (mats, lights, ltri, sph, pln, sphmat, plnmat, objmat),
        int(depth), rays, state, throughput, energy, flags, roots=roots,
        num_lights=num_lights, num_sph=num_sph, num_pln=num_pln,
        nee=nee and num_lights > 0, rr=rr, cosine=cosine, ref_pdf=ref_pdf,
        light_tri_meta=light_tri_meta, count_iters=count_iters, inst=inst,
        ents=ptf.resolve_tables("shade_extend", nodes, ents, fused_nn, width,
                                instanced=inst is not None),
        fused_nn=fused_nn, width=width, pay=pay)


def _shade_extend_launch(entry, dev, nodes, ltris, tables, depth, rays, state,
                         throughput, energy, flags, *, roots, num_lights,
                         num_sph, num_pln, nee, rr, cosine, ref_pdf,
                         light_tri_meta, count_iters, inst=None, ents=None,
                         fused_nn=0, width=8, pay=None):
    n = state.shape[0]
    ptf._check("state", state, _I64, dev, (n,))
    _cols("throughput", throughput, 3, _F32, dev, n)
    _cols("energy", energy, 3, _F32, dev, n)
    ptf._check("flags", flags, _I32, dev, (n,))
    a = ptf.launch_args(
        dev, nodes, ltris, nodes, ltris, tables, rays, n=n, roots=roots,
        sh_roots=roots, light_tri_meta=light_tri_meta, num_sph=num_sph,
        num_pln=num_pln, num_lights=num_lights, nee=nee, rr=rr,
        cosine=cosine, ref_pdf=ref_pdf, depth_base=depth, inst=inst,
        ents=ents, sh_ents=ents, fused_nn=fused_nn, width=width,
        tree_occl=pay is not None, pay=pay)
    a.state, a.flags_in = state.data_ptr(), flags.data_ptr()
    for c in range(3):
        a.tp_in[c] = throughput[c].data_ptr()
        a.en_in[c] = energy[c].data_ptr()

    def col(dtype=_F32):
        return torch.empty(n, dtype=dtype, device=dev)

    rays_o = tuple(col() for _ in range(6))
    st_o, fl_o = col(_I64), col(_I32)
    tp_o = tuple(col() for _ in range(3))
    en_o = tuple(col() for _ in range(3))
    shadow = tuple(col() for _ in range(10))
    for c in range(6):
        a.ray_out[c] = rays_o[c].data_ptr()
    for c in range(3):
        a.tp_out[c], a.en_out[c] = tp_o[c].data_ptr(), en_o[c].data_ptr()
    for c in range(10):
        a.shadow[c] = shadow[c].data_ptr()
    a.state_out, a.flags_out = st_o.data_ptr(), fl_o.data_ptr()
    if count_iters:
        counted = ptf.count_rows(a, dev, {0: (nodes, ltris)}, pay=pay)
    ptf.run_launch(entry, a, "shade_extend")
    out = (rays_o, st_o, tp_o, en_o, fl_o, shadow[0:3], shadow[3:6],
           shadow[6], shadow[7:10])
    if count_iters:
        return out + (ptf.counters(*counted),)
    return out


def shade_extend_reference(
    ltris, mats, lights, ltri, sph, pln, sphmat, plnmat, objmat, depth,
    rays, state, throughput, energy, flags, *, num_lights, num_sph, num_pln,
    nee, rr, cosine, ref_pdf, light_tri_meta=(), records=None, inst=None,
    chunk=4096,
):
    """The plain version of `shade_extend` (same returns, no counters):
    the hits by brute force over the leaf records of `ltris` (or
    `records`, pt_frame.leaf_records(ltris)), then pt_frame's plain
    shading body, on the active lanes only.  With inst = (nodes, roots,
    inst_inv, inst_nrm, inst_root) the instance arm: the hits of
    pt_frame.closest_hit_instances_reference (`records` then from
    pt_frame.instance_records), instance normals made world normals by
    pt_frame.instance_normal.  The leaf-14 arm passes the records of
    pt_frame.leaf_records(ltris, occl=True, pay=pay)."""
    n = state.shape[0]
    dev = state.device
    tb = dict(mats=mats, lights=lights, ltri=ltri, sph=sph, pln=pln,
              sphmat=sphmat, plnmat=plnmat, objmat=objmat,
              num_lights=num_lights, num_sph=num_sph, num_pln=num_pln,
              light_tri_meta=tuple(light_tri_meta))
    md = dict(nee=nee and num_lights > 0, rr=rr, cosine=cosine,
              ref_pdf=ref_pdf)
    ray = [r.clone() for r in rays]
    st = state.clone()
    tp = [c.clone() for c in throughput]
    en = [c.clone() for c in energy]
    fl = flags & 3
    shadow = [torch.zeros(n, dtype=_F32, device=dev) for _ in range(10)]
    lanes = ((flags & 1) != 0).nonzero().squeeze(1)
    if lanes.numel():
        p = dict(ray=tuple(r[lanes] for r in rays), state=state[lanes],
                 tp=tuple(c[lanes] for c in throughput),
                 en=tuple(c[lanes] for c in energy),
                 active=torch.ones(lanes.numel(), dtype=torch.bool,
                                   device=dev),
                 spec=(flags[lanes] >> 1) & 1)
        if inst is None:
            rec = records if records is not None else ptf.leaf_records(ltris)
            hit = ptf.closest_hit_reference(ltris, p["ray"], records=rec,
                                            chunk=chunk)
        else:
            nodes, roots, inst_inv, inst_nrm, inst_root = inst
            h = ptf.closest_hit_instances_reference(
                nodes, ltris, roots, inst_inv, inst_root, p["ray"],
                records=records, chunk=chunk)
            hit = h[:3] + ptf.instance_normal(inst_nrm, h[6], *h[3:6])
        depth0 = torch.full_like(hit[1], int(depth) == 0, dtype=torch.bool)
        sh = ptf._shade_surface(tb, md, p, depth0, *hit)
        for c in range(6):
            ray[c][lanes] = p["ray"][c]
        st[lanes] = p["state"]
        for c in range(3):
            tp[c][lanes] = p["tp"][c]
            en[c][lanes] = p["en"][c]
        word = p["active"].to(_I32) | (p["spec"].to(_I32) << 1)
        if sh is not None:
            sneed, so, sd, stmax, contrib = sh
            word = word | (sneed.to(_I32) << 2)
            zero = torch.zeros_like(stmax)
            for c, v in enumerate((*so, *sd, stmax, *contrib)):
                shadow[c][lanes] = torch.where(sneed, v, zero)
        fl[lanes] = word
    return (tuple(ray), st, tuple(tp), tuple(en), fl, tuple(shadow[0:3]),
            tuple(shadow[3:6]), shadow[6], tuple(shadow[7:10]))


# ---- shadow_resolve ----------------------------------------------------------


def shadow_resolve(
    nodes, ltris, sph, pln, shadow_o, shadow_d, shadow_tmax, flags, energy,
    contrib, *, roots, num_sph, num_pln, occl=False, count_iters=False,
    inst_inv=None, inst_root=None, fused_nn=0, width=8, ents=None,
    occl_rows=1,
):
    """The NEE shadow any-hit of every lane with sneed (flags bit 2) over
    the tree (nodes, ltris, roots) -- the occlusion tables
    (bvh8.to_slim_occl) with occl=True, else shading tables -- and the
    analytic occluders, then energy + (visible ? contrib : 0).  Returns
    energy' (3 (N,) f32 columns); with count_iters=True (CUDA only) also
    the fourteen work counters (the closest-hit ones 0; `sray` the shadow
    rays walked, `wtrip` / `ltrip` their walks' warp and lane trips,
    `longest` the most rows one shadow ray's walk visited).  inst_inv (I, 12),
    inst_root (I,): the instance arm (over the shading tables); ents,
    fused_nn, width: the node-table variants (module docstring; fused and
    16-wide tables are shading tables, occl=False, or occlusion tables of
    CPUGPU_OCCL_W16); occl_rows: the rows per occlusion leaf (1 or 2,
    CPUGPU_OCCL2)."""
    dev = flags.device
    inst = ptf.check_instances(dev, inst_inv, inst_root)
    if occl and (inst is not None or fused_nn or width not in (8, 16)):
        raise ValueError(
            "shadow_resolve: occlusion tables require the plain "
            "non-instanced split-table kernel (width 8 or 16)")
    ptf.check_occl_rows("shadow_resolve", occl_rows, occl)
    ents = ptf.resolve_tables("shadow_resolve", nodes, ents, fused_nn, width,
                              instanced=inst is not None)
    if dev.type == "cpu":
        if count_iters:
            raise ValueError("count_iters needs the CUDA kernel")
        return shadow_resolve_reference(
            ltris, sph, pln, shadow_o, shadow_d, shadow_tmax, flags, energy,
            contrib, num_sph=num_sph, num_pln=num_pln, occl=occl,
            inst=None if inst is None else (nodes, roots, inst_inv,
                                            inst_root))
    if dev.type != "cuda":
        raise ValueError(
            f"shadow_resolve runs on cuda or cpu tensors, not {dev}")
    out = _shadow_resolve_launch(
        ptf.build().mk_shadow_resolve_launch, dev, nodes, ltris, sph, pln,
        shadow_o, shadow_d, shadow_tmax, flags, energy, contrib, roots=roots,
        num_sph=num_sph, num_pln=num_pln, occl=occl, count_iters=count_iters,
        inst=inst, ents=ents, fused_nn=fused_nn, width=width,
        occl_rows=occl_rows)
    leaf = ptf.leaf_arm(occl_rows=occl_rows,
                        occl_width=width if occl else 8)
    ptf.count_launch("shadow_resolve",
                     ptf.table_layout(nodes, ents, fused_nn, width),
                     inst=inst is not None, leaf=leaf)
    return out


def shadow_resolve_host(nodes, ltris, sph, pln, shadow_o, shadow_d,
                        shadow_tmax, flags, energy, contrib, *, roots,
                        num_sph, num_pln, occl=False, count_iters=False,
                        inst_inv=None, inst_root=None, ents=None, fused_nn=0,
                        width=8, occl_rows=1, **_):
    """`shadow_resolve` through the g++ build of the kernel body (CPU)."""
    dev = torch.device("cpu")
    ptf.check_occl_rows("shadow_resolve", occl_rows, occl)
    inst = ptf.check_instances(dev, inst_inv, inst_root)
    return _shadow_resolve_launch(
        ptf.build_host().mk_shadow_resolve_host, dev, nodes,
        ltris, sph, pln, shadow_o, shadow_d, shadow_tmax, flags, energy,
        contrib, roots=roots, num_sph=num_sph, num_pln=num_pln, occl=occl,
        count_iters=count_iters, inst=inst,
        ents=ptf.resolve_tables("shadow_resolve", nodes, ents, fused_nn,
                                width, instanced=inst is not None),
        fused_nn=fused_nn, width=width, occl_rows=occl_rows)


def _shadow_resolve_launch(entry, dev, nodes, ltris, sph, pln, shadow_o,
                           shadow_d, shadow_tmax, flags, energy, contrib, *,
                           roots, num_sph, num_pln, occl, count_iters,
                           inst=None, ents=None, fused_nn=0, width=8,
                           occl_rows=1):
    n = flags.shape[0]
    ptf._check("flags", flags, _I32, dev, (n,))
    _cols("shadow_o", shadow_o, 3, _F32, dev, n)
    _cols("shadow_d", shadow_d, 3, _F32, dev, n)
    ptf._check("shadow_tmax", shadow_tmax, _F32, dev, (n,))
    _cols("energy", energy, 3, _F32, dev, n)
    _cols("contrib", contrib, 3, _F32, dev, n)
    # the shadow tree rides in both tree slots; the closest-hit one is
    # never walked.  The small tables are zero but for spheres and planes.
    tables = list(ptf.dummy_tables(dev, sph.shape[0], pln.shape[0]))
    tables[3:5] = sph, pln
    a = ptf.launch_args(dev, nodes, ltris, nodes, ltris, tables,
                        tuple(shadow_o) + tuple(shadow_d), n=n, roots=roots,
                        sh_roots=roots, occl=occl, num_sph=num_sph,
                        num_pln=num_pln, inst=inst, ents=ents, sh_ents=ents,
                        fused_nn=fused_nn, width=width, sh_width=width,
                        occl_rows=occl_rows)
    a.flags_in = flags.data_ptr()
    cols = tuple(shadow_o) + tuple(shadow_d) + (shadow_tmax,) + tuple(contrib)
    for c in range(10):
        a.shadow[c] = cols[c].data_ptr()
    en_o = tuple(torch.empty(n, dtype=_F32, device=dev) for _ in range(3))
    for c in range(3):
        a.en_in[c], a.en_out[c] = energy[c].data_ptr(), en_o[c].data_ptr()
    if count_iters:
        counted = ptf.count_rows(a, dev, {1: (nodes, ltris)})
    ptf.run_launch(entry, a, "shadow_resolve")
    if count_iters:
        return en_o + (ptf.counters(*counted),)
    return en_o


def shadow_resolve_reference(ltris, sph, pln, shadow_o, shadow_d,
                             shadow_tmax, flags, energy, contrib, *, num_sph,
                             num_pln, occl=False, records=None, inst=None,
                             chunk=4096):
    """The plain version of `shadow_resolve`: the shadow rays of the
    lanes with sneed against every triangle record of `ltris` (occlusion
    rows when occl -- every row, so 1- and 2-row leaves alike -- else
    shading rows; or `records`) by brute force --
    the same triangle set as any tree over them, so the same occluded
    bit -- then the analytic occluders and the energy add.  With inst =
    (nodes, roots, inst_inv, inst_root) the instance arm: a hit of
    pt_frame.closest_hit_instances_reference (`records` then from
    pt_frame.instance_records) occludes."""
    en = [e.clone() for e in energy]
    sl = (((flags >> 2) & 1) != 0).nonzero().squeeze(1)
    if sl.numel() == 0:
        return tuple(en)
    so = tuple(c[sl] for c in shadow_o)
    sd = tuple(c[sl] for c in shadow_d)
    tmax = shadow_tmax[sl]
    if inst is None:
        rc = records
        if rc is None:
            rc = ptf.leaf_records(ltris, occl=occl)
        _, k = brute_force_nearest_triangle(
            torch.stack(so, dim=1), torch.stack(sd, dim=1), rc["v0"],
            rc["e1"], rc["e2"], tmax, chunk=chunk)
    else:
        nodes, roots, inst_inv, inst_root = inst
        k = ptf.closest_hit_instances_reference(
            nodes, ltris, roots, inst_inv, inst_root, so + sd, t_init=tmax,
            any_hit=True, records=records, chunk=chunk)[1]
    occ = (k >= 0) | ptf._analytic_occluded(sph, pln, num_sph, num_pln, so,
                                            sd, tmax)
    zero = torch.zeros_like(tmax)
    for c in range(3):
        en[c][sl] = en[c][sl] + torch.where(occ, zero, contrib[c][sl])
    return tuple(en)
