"""`traverse_packet_slim`: closest hit or any hit of a batch of rays over
the slim 8-wide closest-hit tables (models/bvh8.to_slim), with a per-lane
t bound and lane mask and, with count_depth, each lane's BVH depth -- the
mesh arm of models/scene.intersect_scene.

It replaces the JAX package's Pallas kernel ops/traverse_packet_slim.py
(`_traverse_kernel`, launched by `traverse_packet_slim`).  On CUDA tensors
the wrapper launches the hand-written kernel of csrc/traverse.cu (per-ray
walk in csrc/pt_device.cuh, shared with pt_frame and the per-depth
kernels), built by ops/pt_frame.py's `build`: one thread per lane, the
closest hits over shading leaves with postponed leaves (the kernel's
header).  On CPU tensors it runs `traverse_packet_slim_reference`;
nothing falls back from one to the other.

Per lane: the nearest hit closer than t_init (exact: ties go to the
lowest original triangle id, as in the brute-force oracle) or, with
any_hit, a hit closer than t_init -- which one is not defined, only
whether there is one.  A lane that is not active, or that hits nothing,
gets t_init, triangle id and object -1 and a zero normal.

count_depth (the default, as in the JAX function) adds `bvh_depth` per
lane: the node rows of the lane's walk at which at least one child passed
the push test -- the per-ray reading of the Pallas kernel's
`depth += any(bm[k])`.  The count depends on the walk's visit order, so
it is held bitwise only between the kernel and its plain version, which
is then `traverse_walk_reference`, a lane-parallel PyTorch walk that
mirrors the kernel's (roots, slot-order pushes, slab arithmetic, leaf
tests, tie rule, any-hit exit, instance entry and RESTORE, a 64-entry
stack).  Without count_depth the plain version is brute force over the
leaf records, and bvh_depth is 0.

With inst_inv / inst_root (a scene on the object-space TLAS machinery,
models/scene.py) the kernel's instance arm runs: an instance entry of the
TLAS moves the ray into the instance's object space, and each hit also
returns its instance id (-1 for a world-space hit) with its normal in
object space.  The brute-force plain version then finds each instance's
candidate lanes over the TLAS in world space and tests the instance's
BLAS records in its object space (pt_frame.closest_hit_instances_
reference); the kernel equals it bitwise.

Node-table variants (the JAX kernel's arms): `ents` (the entry side
table, with 64- or 48-col rows), `width=16` and `fused_nn` (the fused
node|leaf table; `ltris` then holds its leaf rows for the plain versions)
launch the kernel's variant arm, with and without count_depth, counted
per layout in ops/pt_frame.py `launches` (launch_key) as every arm is.
The walk `traverse_walk_reference` reads every layout.  As in the JAX
package a side table given with the instance arm is dropped (16-wide and
fused tables raise there).

Occlusion tables (the JAX function's occl / pay / occl_rows): with
occl=True the tree is an occlusion tree (bvh8.to_slim_occl, 8- or
16-wide, leaves of 14-record rows, `occl_rows` rows per leaf), walked by
the kernel's occl arms.  Its any hit returns the t of a record it found
and id 1 (the occlusion bit); without any_hit and without `pay` it is
the t-only query: the exact nearest t, id 1, object -1 and a zero normal
(the JAX function's hit flag, its shading payloads unset); with `pay`
(bvh8.occl_payload rows, 1-row leaves only: CPUGPU_LEAF14) the closest
hit returns the payload's id, object and normal, bitwise the shading
tables' hit.  The plain version is brute force over those records
(pt_frame.leaf_records with occl and pay), or the walk with count_depth,
which reads the occlusion leaves as the kernel does.
"""

from __future__ import annotations

import torch

from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops.intersect import intersect_triangle

# the kernel's stack marker of an instance's end (csrc/pt_device.cuh)
RESTORE = 0x3FFFFFFF

_F32, _I32 = torch.float32, torch.int32


def _columns(v):
    """(N, 3) tensor or 3-tuple of (N,) columns -> 3 contiguous columns."""
    if isinstance(v, (tuple, list)):
        return tuple(c.contiguous() for c in v)
    return tuple(v[:, k].contiguous() for k in range(3))


def traverse_packet_slim(
    origin, direction, t_init, nodes, ltris, roots, *, active=None,
    any_hit: bool = False, count_depth: bool = True, inst_inv=None,
    inst_root=None, fused_nn: int = 0, width: int = 8,
    count_iters: bool = False, ents=None, occl: bool = False, pay=None,
    occl_rows: int = 1,
):
    """Hits of the rays origin/direction ((N, 3) or 3-tuples of (N,) f32)
    closer than t_init (N,) f32 over the tree (nodes (B, 64) or a variant
    layout with ents / fused_nn / width, ltris (NL, 128), roots), for the
    lanes where `active` (N,) is set (all when
    None).  Returns (t, original triangle id (N,) i32, object (N,) i32,
    (nx, ny, nz) flat normal columns, bvh_depth (N,) i32, 0 without
    count_depth) -- the JAX function's order -- and with inst_inv (I, 12)
    / inst_root (I,) also the instance id (N,) i32; with count_iters=True
    (CUDA only) then ops/pt_frame.py's fourteen work counters (the shadow ones
    0).  occl, pay, occl_rows: the occlusion tables (module docstring)."""
    rays = _columns(origin) + _columns(direction)
    dev = t_init.device
    inst = ptf.check_instances(dev, inst_inv, inst_root)
    check_occl("traverse_packet_slim", inst is not None, fused_nn, width,
               occl, pay, occl_rows)
    ents = ptf.resolve_tables("traverse_packet_slim", nodes, ents, fused_nn,
                              width, instanced=inst is not None)
    if pay is not None:
        ptf.check_pay("traverse_packet_slim", pay, ltris, dev)
    layout = dict(ents=ents, fused_nn=fused_nn, width=width, occl=occl,
                  pay=pay, occl_rows=occl_rows)
    if dev.type == "cpu":
        if count_iters:
            raise ValueError("count_iters needs the CUDA kernel")
        return traverse_packet_slim_reference(
            rays, t_init, ltris, active=active, any_hit=any_hit,
            count_depth=count_depth, nodes=nodes, roots=roots,
            inst=None if inst is None else (nodes, roots, inst_inv,
                                            inst_root), **layout)
    if dev.type != "cuda":
        raise ValueError(
            f"traverse_packet_slim runs on cuda or cpu tensors, not {dev}")
    out = launch(ptf.build().traverse_launch, dev, rays, t_init, nodes, ltris,
                 roots, active=active, any_hit=any_hit,
                 count_depth=count_depth, count_iters=count_iters, inst=inst,
                 **layout)
    ptf.count_launch("traverse_packet_slim",
                     ptf.table_layout(nodes, ents, fused_nn, width),
                     inst=inst is not None, depth=count_depth,
                     leaf=ptf.leaf_arm(occl, pay, occl_rows))
    return out


def check_occl(what, instanced, fused_nn, width, occl, pay, occl_rows):
    """The JAX function's checks of its occlusion arguments
    (traverse_packet_slim.py there): occlusion tables on the plain
    non-instanced split-table arm of width 8 or 16, payload rows only
    with them, occl_rows 1 or 2 and 2 only over bare occlusion tables."""
    if occl and (instanced or fused_nn or width not in (8, 16)):
        raise ValueError(
            f"{what}: occlusion tables (bvh8.to_slim_occl) require the "
            "plain non-instanced split-table kernel (width 8 or 16)")
    if pay is not None and not occl:
        raise ValueError(f"{what}: the payload table (bvh8.occl_payload) "
                         "rides the leaf-14 occl tables (occl=True)")
    if occl_rows not in (1, 2):
        raise ValueError(f"{what}: occl_rows must be 1 or 2")
    if occl_rows == 2 and (not occl or pay is not None):
        raise ValueError(
            f"{what}: occl_rows=2 (CPUGPU_OCCL2 fat shadow leaves) requires "
            "the bare occlusion tables (occl=True, no payload rows)")


def traverse_packet_slim_host(origin, direction, t_init, nodes, ltris, roots,
                              *, active=None, any_hit=False,
                              count_depth=True, count_iters=False,
                              inst_inv=None, inst_root=None, ents=None,
                              fused_nn=0, width=8, occl=False, pay=None,
                              occl_rows=1):
    """`traverse_packet_slim` through the g++ build of the kernel body, on
    CPU tensors: a test of the device code without a card."""
    dev = torch.device("cpu")
    inst = ptf.check_instances(dev, inst_inv, inst_root)
    check_occl("traverse_packet_slim", inst is not None, fused_nn, width,
               occl, pay, occl_rows)
    return launch(ptf.build_host().traverse_host, dev,
                  _columns(origin) + _columns(direction), t_init, nodes,
                  ltris, roots, active=active, any_hit=any_hit,
                  count_depth=count_depth, count_iters=count_iters, inst=inst,
                  ents=ptf.resolve_tables("traverse_packet_slim", nodes, ents,
                                          fused_nn, width,
                                          instanced=inst is not None),
                  fused_nn=fused_nn, width=width, occl=occl, pay=pay,
                  occl_rows=occl_rows)


def launch(entry, dev, rays, t_init, nodes, ltris, roots, *, active=None,
           any_hit=False, count_depth=False, count_iters=False, inst=None,
           ents=None, fused_nn=0, width=8, occl=False, pay=None,
           occl_rows=1):
    """One launch of the traversal entry over 6 ray columns; t_init None
    means 1e34 and active None every lane; `inst` the checked instance
    tables (ptf.check_instances) of the instance arm, which adds the hit
    instance column to the outputs; count_depth sets the kernel's
    bvh_depth output (else the column is zeros); ents, fused_nn, width
    the node layout, resolved (ptf.resolve_tables); occl, pay, occl_rows
    the occlusion tree's leaves (checked, check_occl)."""
    n = rays[0].shape[0]
    a = ptf.launch_args(dev, nodes, ltris, nodes, ltris,
                        ptf.dummy_tables(dev), rays, n=n, roots=roots,
                        sh_roots=roots, inst=inst, ents=ents, sh_ents=ents,
                        fused_nn=fused_nn, width=width, tree_occl=occl,
                        occl_rows=occl_rows, pay=pay)
    if t_init is not None:
        ptf._check("t_init", t_init, _F32, dev, (n,))
        a.t_init = t_init.data_ptr()
    if active is not None:
        active = active.to(_I32).contiguous()
        ptf._check("active", active, _I32, dev, (n,))
        a.active = active.data_ptr()
    a.any_hit = int(any_hit)
    out = [torch.empty(n, dtype=dt, device=dev)
           for dt in (_F32, _I32, _I32, _F32, _F32, _F32, _I32)
           [:7 if inst is not None else 6]]
    for c in range(len(out)):
        a.hit_out[c] = out[c].data_ptr()
    if count_depth:
        depth = torch.empty(n, dtype=_I32, device=dev)
        a.depth_out = depth.data_ptr()
    else:
        depth = torch.zeros(n, dtype=_I32, device=dev)
    if count_iters:
        counted = ptf.count_rows(a, dev, {0: (nodes, ltris)}, pay=pay)
    ptf.run_launch(entry, a, "traverse")
    res = (out[0], out[1], out[2], tuple(out[3:6]), depth) + tuple(out[6:])
    if count_iters:
        return res + (ptf.counters(*counted),)
    return res


def traverse_packet_slim_reference(rays, t_init, ltris, *, active=None,
                                   any_hit=False, records=None, inst=None,
                                   chunk=4096, count_depth=False, nodes=None,
                                   roots=None, ents=None, fused_nn=0,
                                   width=8, occl=False, pay=None,
                                   occl_rows=1):
    """The plain version, in the wrapper's output order.  With count_depth
    the walk of the kernel, `traverse_walk_reference` over (nodes, ltris,
    roots) in their layout (ents, fused_nn, width).  Else brute force over
    every leaf record of `ltris` (or
    `records`, pt_frame.leaf_records(ltris)) on the active lanes, the
    nearest hit closer than t_init with ties to the lowest original id,
    and a zero bvh_depth; with any_hit the same nearest hit, one valid
    answer of an any-hit query (only its existence is defined).  rays: 6
    (N,) f32 columns.  With inst = (nodes, roots, inst_inv, inst_root) the
    instance arm (pt_frame.closest_hit_instances_reference; `records`
    then from pt_frame.instance_records), and the instance column out.
    occl, pay, occl_rows: an occlusion tree (the records of
    pt_frame.leaf_records(ltris, occl=True, pay=pay))."""
    if count_depth:
        if inst is not None:
            nodes, roots = inst[0], inst[1]
        return traverse_walk_reference(
            rays, t_init, nodes, ltris, roots, active=active, any_hit=any_hit,
            inst_inv=None if inst is None else inst[2],
            inst_root=None if inst is None else inst[3], ents=ents,
            fused_nn=fused_nn, width=width, occl=occl, pay=pay,
            occl_rows=occl_rows)
    if occl and records is None:
        records = ptf.leaf_records(ltris, occl=True, pay=pay)
    n = t_init.shape[0]
    dev = t_init.device
    t = t_init.clone()
    tri = torch.full((n,), -1, dtype=_I32, device=dev)
    obj = tri.clone()
    iid = tri.clone()
    nrm = [torch.zeros(n, dtype=_F32, device=dev) for _ in range(3)]
    lanes = (torch.arange(n, device=dev) if active is None
             else (active != 0).nonzero().squeeze(1))
    if lanes.numel():
        lr = tuple(r[lanes] for r in rays)
        if inst is None:
            h = ptf.closest_hit_reference(ltris, lr, t_init=t_init[lanes],
                                          records=records, chunk=chunk)
        else:
            h = ptf.closest_hit_instances_reference(
                inst[0], ltris, inst[1], inst[2], inst[3], lr,
                t_init=t_init[lanes], any_hit=any_hit, records=records,
                chunk=chunk)
            iid[lanes] = h[6]
        t[lanes], tri[lanes], obj[lanes] = h[0], h[1], h[2]
        for c in range(3):
            nrm[c][lanes] = h[3 + c]
    out = (t, tri, obj, tuple(nrm), torch.zeros(n, dtype=_I32, device=dev))
    return out if inst is None else out + (iid,)


def _slab_ray(d):
    """The reciprocal direction (1/0 -> 1e30) and the zero-component masks
    of direction columns d, as pt_device.cuh slab_ray forms them."""
    inv = tuple(torch.where(c == 0.0, torch.full_like(c, ptf.BIG), 1.0 / c)
                for c in d)
    return inv, tuple(c == 0.0 for c in d)


def traverse_walk_reference(rays, t_init, nodes, ltris, roots, *,
                            active=None, any_hit=False, inst_inv=None,
                            inst_root=None, ents=None, fused_nn=0, width=8,
                            occl=False, pay=None, occl_rows=1,
                            slab_pad=ptf.SLAB_PAD):
    """The kernel's walk (csrc/pt_device.cuh closest_hit / any_hit over a
    shading tree, with the count_depth arm) on every lane at once: each
    step takes one entry per live lane.  roots[1:] are pushed and
    roots[0] taken first; a node row's 8 slab tests (pt_frame._slab_pass:
    the kernel's arithmetic, the face-inclusive zero-direction rule, at t
    for a closest hit) push the passing children in slot order onto a
    PT_STACK-entry stack, and count 1 when any passes; a leaf row's 8
    records are tested in slot order (ops/intersect.intersect_triangle,
    the kernel's association) with the exact-tie rule for a closest hit
    and the first hit ending an any-hit walk; with inst_inv / inst_root
    an instance entry moves the ray by its inst_inv row (instance_entry's
    association), pushes RESTORE and descends to inst_root without a pop,
    and RESTORE brings the world ray back.  Every node layout of the kernel's
    variant walk: the entries from the side table `ents` or the row, the
    bounds of `width` slots per row (a 16-wide row's 16 slot tests push
    in slot order, as the kernel's two blocks of 8 do), and on a fused
    table (fused_nn) the entries from fused_nn on as leaf rows e -
    fused_nn of `ltris`, with the variant walk's PT_STACK_W16-entry
    stack.  On an occlusion tree (occl; the kernel's occl arms) a leaf is
    `occl_rows` rows of 14 records of 9 cols, tested in order: an any hit
    ends the walk with its t and id 1, a closest hit takes id, object and
    normal from `pay` at the record's offset (or id 1, object -1 and a
    zero normal without it) under the same rules.  Returns the wrapper's
    outputs with bvh_depth (and the instance column with inst_inv); every
    output equals the kernel's bitwise, and t, id, object, normal and
    instance of a closest hit equal the brute-force plain version's.
    slab_pad: the slab test's margin (pt_frame.slab_pass; 1 is the exact
    test of the port before ROADMAP C2's repair)."""
    n = t_init.shape[0]
    dev = t_init.device
    kinst = inst_inv is not None
    ar = torch.arange(n, device=dev)
    alive = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
             else active != 0)
    world = tuple(r.contiguous() for r in rays)
    cur = list(world)
    inv, zero = _slab_ray(cur[3:])
    ciid = torch.full((n,), -1, dtype=_I32, device=dev)
    ht = t_init.clone()
    htri = torch.full((n,), -1, dtype=_I32, device=dev)
    hobj = htri.clone()
    hiid = htri.clone()
    hn = [torch.zeros(n, dtype=_F32, device=dev) for _ in range(3)]
    dep = torch.zeros(n, dtype=_I32, device=dev)
    variant = occl or ptf.table_layout(nodes, ents, fused_nn, width) != "64"
    cap = ptf.PT_STACK_W16 if variant else ptf.PT_STACK
    stack = torch.zeros((n, cap), dtype=_I32, device=dev)
    if len(roots) > 1:
        stack[:, :len(roots) - 1] = torch.tensor(roots[1:], dtype=_I32,
                                                 device=dev)
    sp = torch.full((n,), len(roots) - 1, dtype=torch.int64, device=dev)
    e = torch.full((n,), roots[0], dtype=_I32, device=dev)
    bounds = nodes[:, :6 * width].reshape(-1, width, 6)
    if ents is None:
        ents = nodes[:, 6 * width:7 * width].contiguous().view(_I32)
    if occl:
        # occl_rows rows of 14 records of 9 cols per leaf, as one leaf
        # "row" of 14 * occl_rows records; the payload's normal, object
        # and id at the same offsets, at cols 9..13 of each record here
        rows = ltris[:, :126].reshape(-1, occl_rows * 14, 9)
        if pay is None:
            one = torch.ones(rows.shape[:2] + (1,), dtype=_I32, device=dev)
            extra = torch.cat([torch.zeros_like(rows[..., :3]),
                               (-one).view(_F32), one.view(_F32)], dim=2)
        else:
            extra = pay[:, :126].reshape(-1, occl_rows * 14, 9)[..., :5]
        recs = torch.cat([rows, extra], dim=2)
    else:
        recs = ltris.reshape(-1, 8, 16)
    nrec = recs.shape[1]
    num_inst = 0 if not kinst else inst_root.shape[0]
    while bool(alive.any()):
        e0 = e
        enter = restore = torch.zeros_like(alive)
        if kinst:
            enter = alive & (e0 > ptf.SLIM_EMPTY)
            restore = alive & (e0 == RESTORE)
            k = torch.clamp(e0.long() - ptf.SLIM_EMPTY - 1, 0, num_inst - 1)
            m = inst_inv[k]
            ox, oy, oz, dx, dy, dz = world
            moved = (
                m[:, 0] * ox + m[:, 1] * oy + m[:, 2] * oz + m[:, 3],
                m[:, 4] * ox + m[:, 5] * oy + m[:, 6] * oz + m[:, 7],
                m[:, 8] * ox + m[:, 9] * oy + m[:, 10] * oz + m[:, 11],
                m[:, 0] * dx + m[:, 1] * dy + m[:, 2] * dz,
                m[:, 4] * dx + m[:, 5] * dy + m[:, 6] * dz,
                m[:, 8] * dx + m[:, 9] * dy + m[:, 10] * dz,
            )
            cur = [torch.where(enter, mv, torch.where(restore, wc, cc))
                   for mv, wc, cc in zip(moved, world, cur)]
            inv, zero = _slab_ray(cur[3:])
            ciid = torch.where(enter, k.to(_I32),
                               torch.where(restore, -1, ciid))
            push = enter & (sp < cap)
            stack[ar[push], sp[push]] = RESTORE
            sp = sp + push.long()
            e = torch.where(enter, inst_root[k], e)
        is_node = (e0 < fused_nn) if fused_nn else (e0 >= 0)
        node = alive & ~enter & ~restore & is_node
        leaf = alive & ~enter & ~restore & ~is_node

        # node rows: 8 slab tests, passing children pushed in slot order
        ec = torch.where(node, e0, 0).long()
        box = bounds[ec].permute(2, 0, 1)
        bound_t = (t_init if any_hit else ht)[:, None]
        ent = ents[ec]
        passed = ptf._slab_pass(
            box, tuple(c[:, None] for c in cur[:3]),
            tuple(c[:, None] for c in inv), tuple(c[:, None] for c in zero),
            bound_t, not any_hit, slab_pad) & (ent != ptf.SLIM_EMPTY) \
            & node[:, None]
        dep = dep + passed.any(dim=1).to(_I32)
        pos = sp[:, None] + torch.cumsum(passed.long(), dim=1) - 1
        fits = passed & (pos < cap)
        stack[ar[:, None].expand(n, width)[fits], pos[fits]] = ent[fits]
        sp = sp + fits.sum(dim=1)

        # leaf rows: 8 records in slot order
        lrow = e0.long() - fused_nn if fused_nn else -e0.long() - 1
        lc = torch.where(leaf, lrow, 0)
        r = recs[lc]
        valid, tt = intersect_triangle(
            torch.stack(cur[:3], dim=1)[:, None, :],
            torch.stack(cur[3:], dim=1)[:, None, :],
            r[..., 0:3], r[..., 3:6], r[..., 6:9])
        ids = r[..., 13].contiguous().view(_I32)
        objs = r[..., 12].contiguous().view(_I32)
        found = torch.zeros_like(alive)
        if any_hit:
            hit = leaf[:, None] & valid & (tt < t_init[:, None])
            found = hit.any(dim=1)
            c = torch.argmax(hit.to(torch.int8), dim=1)
            take = (ar, c)
            ht = torch.where(found, tt[take], ht)
            htri = torch.where(found, 1 if occl else ids[take], htri)
            if not occl:  # an occlusion any hit sets t and the bit alone
                hobj = torch.where(found, objs[take], hobj)
                hn = [torch.where(found, r[ar, c, 9 + j], hn[j])
                      for j in range(3)]
            hiid = torch.where(found, ciid, hiid)
        else:
            for c in range(nrec):
                ttc, idc = tt[:, c], ids[:, c]
                tie = (ttc == ht) & ((idc < htri) | (
                    kinst & (idc == htri) & (ciid < hiid)))
                acc = leaf & valid[:, c] & ((ttc < ht) | tie)
                ht = torch.where(acc, ttc, ht)
                htri = torch.where(acc, idc, htri)
                hobj = torch.where(acc, objs[:, c], hobj)
                hn = [torch.where(acc, r[:, c, 9 + j], hn[j])
                      for j in range(3)]
                hiid = torch.where(acc, ciid, hiid)

        # pop: every lane that took a node, a leaf (an any hit ends its
        # walk) or RESTORE; an instance entry descends without one
        pop = alive & ~enter & ~found
        alive = alive & ~found & ~(pop & (sp == 0))
        go = pop & (sp > 0)
        sp = sp - go.long()
        top = stack[ar, torch.clamp(sp, 0, cap - 1)]
        e = torch.where(go, top, e)
    out = (ht, htri, hobj, tuple(hn), dep)
    return out + (hiid,) if kinst else out
