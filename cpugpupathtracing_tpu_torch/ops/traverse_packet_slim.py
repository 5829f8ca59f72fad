"""`traverse_packet_slim`: closest hit or any hit of a batch of rays over
the slim 8-wide closest-hit tables (models/bvh8.to_slim), with a per-lane
t bound and lane mask -- the mesh arm of models/scene.intersect_scene.

It replaces the JAX package's Pallas kernel ops/traverse_packet_slim.py
(`_traverse_kernel`, launched by `traverse_packet_slim`).  On CUDA tensors
the wrapper launches the hand-written kernel of csrc/traverse.cu (per-ray
walk in csrc/pt_device.cuh, shared with pt_frame and the per-depth
kernels), built by ops/pt_frame.py's `build`.  On CPU tensors it runs
`traverse_packet_slim_reference`, brute force over the leaf records;
nothing falls back from one to the other.

Per lane: the nearest hit closer than t_init (exact: ties go to the
lowest original triangle id, as in the brute-force oracle) or, with
any_hit, a hit closer than t_init -- which one is not defined, only
whether there is one.  A lane that is not active, or that hits nothing,
gets t_init, triangle id and object -1 and a zero normal.

With inst_inv / inst_root (a scene on the object-space TLAS machinery,
models/scene.py) the kernel's instance arm runs: an instance entry of the
TLAS moves the ray into the instance's object space, and each hit also
returns its instance id (-1 for a world-space hit) with its normal in
object space.  The plain version then finds each instance's candidate
lanes over the TLAS in world space and tests the instance's BLAS records
by brute force in its object space (pt_frame.closest_hit_instances_
reference); the kernel equals it bitwise.

The JAX function's BVH depth count (count_depth, read only by the debug
AOVs: ROADMAP.md A9), fused and 16-wide tables are not ported: the
wrapper raises on them.
"""

from __future__ import annotations

import torch

from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

# kernel launches of `traverse_packet_slim`, of its instance arm apart
# (the closest-hit test of ops/pt_frame.py and comparisons against the
# plain version not counted)
launches = 0
launches_inst = 0

_F32, _I32 = torch.float32, torch.int32


def _columns(v):
    """(N, 3) tensor or 3-tuple of (N,) columns -> 3 contiguous columns."""
    if isinstance(v, (tuple, list)):
        return tuple(c.contiguous() for c in v)
    return tuple(v[:, k].contiguous() for k in range(3))


def traverse_packet_slim(
    origin, direction, t_init, nodes, ltris, roots, *, active=None,
    any_hit: bool = False, count_depth: bool = False, inst_inv=None,
    inst_root=None, fused_nn: int = 0, width: int = 8,
    count_iters: bool = False,
):
    """Hits of the rays origin/direction ((N, 3) or 3-tuples of (N,) f32)
    closer than t_init (N,) f32 over the tree (nodes (B, 64), ltris
    (NL, 128), roots), for the lanes where `active` (N,) is set (all when
    None).  Returns (t, original triangle id (N,) i32, object (N,) i32,
    (nx, ny, nz) flat normal columns), and with inst_inv (I, 12) /
    inst_root (I,) also the instance id (N,) i32; with count_iters=True
    (CUDA only) then ops/pt_frame.py's ten work counters (the shadow ones
    0)."""
    given = [k for k, v in (("count_depth", count_depth),
                            (f"fused_nn={fused_nn}", fused_nn),
                            (f"width={width}", width != 8)) if v]
    if given:
        raise NotImplementedError(
            f"traverse_packet_slim: {', '.join(given)} not ported (the kernel "
            "walks 8-wide tables and counts no BVH depth); see ROADMAP.md "
            "A14 (fused and 16-wide tables) and A9 (count_depth)")
    global launches, launches_inst
    rays = _columns(origin) + _columns(direction)
    dev = t_init.device
    inst = ptf.check_instances(dev, inst_inv, inst_root)
    if dev.type == "cpu":
        if count_iters:
            raise ValueError("count_iters needs the CUDA kernel")
        return traverse_packet_slim_reference(
            rays, t_init, ltris, active=active, any_hit=any_hit,
            inst=None if inst is None else (nodes, roots, inst_inv,
                                            inst_root))
    if dev.type != "cuda":
        raise ValueError(
            f"traverse_packet_slim runs on cuda or cpu tensors, not {dev}")
    out = launch(ptf.build().traverse_launch, dev, rays, t_init, nodes, ltris,
                 roots, active=active, any_hit=any_hit,
                 count_iters=count_iters, inst=inst)
    if inst is None:
        launches += 1
    else:
        launches_inst += 1
    return out


def traverse_packet_slim_host(origin, direction, t_init, nodes, ltris, roots,
                              *, active=None, any_hit=False,
                              count_iters=False, inst_inv=None,
                              inst_root=None):
    """`traverse_packet_slim` through the g++ build of the kernel body, on
    CPU tensors: a test of the device code without a card."""
    dev = torch.device("cpu")
    return launch(ptf.build_host().traverse_host, dev,
                  _columns(origin) + _columns(direction), t_init, nodes,
                  ltris, roots, active=active, any_hit=any_hit,
                  count_iters=count_iters,
                  inst=ptf.check_instances(dev, inst_inv, inst_root))


def launch(entry, dev, rays, t_init, nodes, ltris, roots, *, active=None,
           any_hit=False, count_iters=False, inst=None):
    """One launch of the traversal entry over 6 ray columns; t_init None
    means 1e34 and active None every lane; `inst` the checked instance
    tables (ptf.check_instances) of the instance arm, which adds the hit
    instance column to the outputs."""
    n = rays[0].shape[0]
    a = ptf.launch_args(dev, nodes, ltris, nodes, ltris,
                        ptf.dummy_tables(dev), rays, n=n, roots=roots,
                        sh_roots=roots, inst=inst)
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
    if count_iters:
        counted = ptf.count_rows(a, dev, {0: (nodes, ltris)})
    ptf.run_launch(entry, a, "traverse")
    res = (out[0], out[1], out[2], tuple(out[3:6])) + tuple(out[6:])
    if count_iters:
        return res + (ptf.counters(*counted),)
    return res


def traverse_packet_slim_reference(rays, t_init, ltris, *, active=None,
                                   any_hit=False, records=None, inst=None,
                                   chunk=4096):
    """The plain version: brute force over every leaf record of `ltris`
    (or `records`, pt_frame.leaf_records(ltris)) on the active lanes, the
    nearest hit closer than t_init with ties to the lowest original id.
    With any_hit the same nearest hit, one valid answer of an any-hit
    query (only its existence is defined).  rays: 6 (N,) f32 columns.
    With inst = (nodes, roots, inst_inv, inst_root) the instance arm's
    plain version (pt_frame.closest_hit_instances_reference; `records`
    then from pt_frame.instance_records), and the instance column out."""
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
    out = (t, tri, obj, tuple(nrm))
    return out if inst is None else out + (iid,)
