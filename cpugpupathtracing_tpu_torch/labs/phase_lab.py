"""L4 `traverse_phase`: closest hits over the slim 8-wide split tables
with deferred leaves, under the phase-split schedule of the JAX package's
tools/phase_lab.py.

On CUDA tensors the wrapper launches the hand-written kernel of
csrc/phase_lab.cu (lab_phase_kernel; built by ops/pt_frame.py with every
unit); on CPU tensors it runs `traverse_phase_reference`, which steps
every lane in lockstep through the kernel's state machine, takes the
kernel's votes per 32 lanes, and equals it bitwise, counters included.
Nothing falls back from one to the other.

The schedule: L1's frame stack with conditional pushes (kernel_lab2.py)
plus one pending-leaf slot per ray.  A trip runs in leaf mode when some
lane of the warp pops a leaf while its slot is full, or when no lane
holds an interior entry and some lane holds a pending or current leaf;
then every lane with a pending or current leaf tests one leaf row (with
drain2 both, the pending one first) and the lanes whose current entry was
a leaf pop.  Otherwise it is an interior trip: slab, push, pop, a popped
leaf into the slot.  Returns (t, hit, obj, iters, leaf iters): per lane
the closest hit closer than t_init (bitwise the standalone traversal's),
per tile of 1024 lanes the trips of its 32 warps and the leaf-mode trips
among them.  count_rows=True appends the launch's work (common.COUNTS).
The wrapper checks that the tree's deepest walk fits the kernel's 24
frames and raises otherwise.
"""

from __future__ import annotations

import torch

from cpugpupathtracing_tpu_torch.labs import common as cm

_I32 = torch.int32


def launch_key(drain2=False, **_) -> str:
    """The launch key of an L4 arm (ops/pt_frame.py launches)."""
    return cm.arm_key("traverse_phase", dict(drain2=drain2))


def traverse_phase(origin, direction, t_init, nodes, ltris, roots, *,
                   active, drain2=False, count_rows=False):
    """L4 (module docstring): rays as component tuples or (N, 3), t_init
    (N,) f32, (B, 64) node rows, (NL, 128) leaf rows, static roots."""
    roots = tuple(int(r) for r in roots)
    rays = cm.columns(origin, direction)
    if nodes.dim() != 2 or nodes.shape[1] != 64:
        raise ValueError("traverse_phase: needs the 64-col node rows and "
                         "their leaf rows")
    cm.check_stack("traverse_phase", nodes, roots, slice(48, 56), width=8,
                   frame_words=cm.FRAME8, capacity=cm.FSTACK8)
    dev = t_init.device
    if dev.type == "cpu":
        return traverse_phase_reference(rays, t_init, nodes, ltris, roots,
                                        active=active, drain2=drain2,
                                        count_rows=count_rows)
    if dev.type != "cuda":
        raise ValueError(f"traverse_phase runs on cuda or cpu tensors, not "
                         f"{dev}")
    out = cm.launch(cm.build().phase_launch, "traverse_phase", rays, t_init,
                    nodes, ltris, roots, active, flags=int(drain2),
                    node_rows=nodes.shape[0], leaf_rows=ltris.shape[0],
                    count_rows=count_rows)
    cm.count_launch(launch_key(drain2))
    return out


def traverse_phase_reference(rays, t_init, nodes, ltris, roots, *, active,
                             drain2=False, count_rows=False):
    """L4's plain version over the six ray columns."""
    L = cm.Lanes(rays, t_init, active)
    n, dev, ar = L.n, L.dev, L.ar
    node_rows = nodes.shape[0]
    if count_rows:
        L.count_rows(node_rows + ltris.shape[0])
    bounds = nodes[:, :48].reshape(-1, 8, 6)
    ents = nodes[:, 48:56].contiguous().view(_I32)
    recs = ltris.reshape(-1, 8, 16)
    stack = torch.zeros((n, cm.FSTACK8), dtype=_I32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    cm.seed_frames(stack, sp, L.act, roots, cm.FRAME8, 8)
    e = torch.where(L.act, roots[0], cm.DONE).to(torch.int64)
    pend = torch.full((n,), -1, dtype=torch.int64, device=dev)

    def drain(mask, lrow):
        lc = torch.where(mask, lrow, 0)
        L.mark(lc[mask] + node_rows, 1, cm.LEAF_TRIS * int(mask.sum()))
        cm.leaf_closest(L, recs[lc], mask)

    def pop(mask):
        nonlocal sp
        can = mask & (sp > 0)
        kk, base, sp = cm.pop_frames(stack, sp, can, cm.FRAME8)
        ent = stack[ar, base + kk].to(torch.int64)
        return torch.where(can, ent, torch.where(mask, cm.DONE, e))

    while True:
        live = e != cm.DONE
        if not L.trip(live | (pend >= 0)):
            break
        is_leaf = live & (e < 0)
        is_int = live & (e >= 0)
        has_p = pend >= 0
        collide = cm.warp_any(is_leaf & has_p)
        any_int = cm.warp_any(is_int)
        any_leafish = cm.warp_any(is_leaf | has_p)
        leaf_mode = collide | (any_leafish & ~any_int)
        L.leafs += leaf_mode
        lm = cm.per_lane(leaf_mode)
        im = ~lm
        cur = -e - 1
        # leaf trips: drain, then the lanes whose entry was a leaf pop
        if drain2:
            drain(lm & has_p, pend)
            drain(lm & is_leaf, cur)
            new_pend = torch.full_like(pend, -1)
        else:
            drain(lm & (has_p | is_leaf), torch.where(has_p, pend, cur))
            new_pend = torch.where(is_leaf & has_p, cur, -1)
        # interior trips: slab and push, a popped leaf into the slot
        slab = im & is_int
        ec = torch.where(slab, e, 0)
        passed, _ = cm.slab_rows(L, bounds, ents, ec, L.t, True, slab)
        L.mark(ec[slab], 0)
        w = cm.mask_bits(passed)
        vals = torch.cat([ents[ec].to(torch.int64), w[:, None]], dim=1)
        sp = cm.push_frames(stack, sp, slab & (w != 0), vals)
        pend = torch.where(lm, new_pend, torch.where(is_leaf, cur, pend))
        e = pop((lm & is_leaf) | (im & live))
    return L.outputs((L.iters, L.leafs), node_rows)
