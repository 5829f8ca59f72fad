"""L1 `traverse_lab2` and L2 `traverse_lab2p`: closest hits over the
slim 8-wide tables under the frame-stack and pipelined schedules of the
JAX package's tools/kernel_lab2.py.

On CUDA tensors each wrapper launches csrc/lab2.cu (built by
ops/pt_frame.py with every unit): lab_prep_kernel, which writes the
outputs of the lanes that are not active and lists the active ones, then
the arm's walk kernel (lab_frame_kernel, lab_pipe_kernel) as persistent
blocks whose warps hand each lane whose ray has ended the next ray of the
list, once 8 of a warp's 32 lanes are idle; on CPU tensors it runs its plain version,
`traverse_lab2_reference` / `traverse_lab2p_reference`, which steps every
lane in lockstep through the kernel's per-ray state machine and equals it
bitwise, counters included.  Nothing falls back from one to the other.

The signatures are the JAX lab's: component-tuple rays, t_init, the
tables, static roots, `active`, and the schedule flags -- L1's
frame_stack (9-word frames, the lowest set bit popped first; else the
linear stack), fused (the fused node|leaf table of `fuse_tables` with nn
node rows; else 64-col node rows and leaf rows), gate_leaf (the leaf
phase under a warp vote) and cond_push (a frame pushed only when its mask
is non-zero); L2's frame_stack, nearest (the nearest child popped first)
and parent (parent-pointer frames) over the fused table.  Each returns
(t, hit, obj, iters, leafs): per lane the closest hit closer than t_init
(a lane that is not active keeps t_init, ids -1), per tile of 1024 lanes
the trips in which its rays held an entry (L2: a current entry or one on
the stack) and those in which they tested a leaf row.  These are per-ray
sums, so no schedule changes them (a warp's rays depend on the order in
which warps finish); L3, L4, L6 and L7 keep per-warp counters until
their own redesign.  The hits are bitwise the standalone traversal's
(ops/traverse_packet_slim.py): the same slab and triangle arithmetic and
the lowest-id tie rule, whatever the visit order.  The counters cannot
equal the JAX lab's, which count 8-row packet trips.  count_rows=True
appends the launch's work (COUNTS: common.COUNTS and the launch's warp
trips, which depend on the schedule; lane trips / (32 x warp trips) is
the share of a warp's lanes that hold a ray a trip).

gate_leaf and cond_push change what the kernel does on a trip, not what
it computes, so the plain versions have no such options.  Each wrapper
checks that the tree's deepest walk fits the kernel's stack
(common.check_stack) and raises otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from cpugpupathtracing_tpu_torch.labs import common as cm
# the fused table of tools/kernel_lab.py, the L1 / L2 arms' `fused`
from cpugpupathtracing_tpu_torch.labs.kernel_lab import (  # noqa: F401
    fuse_tables,
)

_I32 = torch.int32
# the count launch's COUNTS: common.COUNTS, then the launch's warp trips
# (the plain versions': those of the lockstep run, 32 consecutive lanes a
# warp and no refill)
COUNTS = cm.COUNTS + ("warp_trips",)


class RefillArgs(ctypes.Structure):
    """Mirrors struct lab2::RefillArgs of csrc/lab2.cu."""

    _fields_ = [("lanes", ctypes.c_void_p), ("queue", ctypes.c_void_p)]


def _entry(fn, n: int, dev):
    """A launch entry with its RefillArgs: the scratch list of n lanes and
    the two queue words (csrc/lab2.cu zeroes them)."""
    lanes = torch.empty(max(n, 1), dtype=_I32, device=dev)
    queue = torch.empty(2, dtype=_I32, device=dev)
    r = RefillArgs()
    r.lanes, r.queue = lanes.data_ptr(), queue.data_ptr()

    def entry(args_ptr):
        return fn(args_ptr, ctypes.addressof(r))
    # the scratch lives until the launch is enqueued (the caching allocator
    # hands it out again only in stream order)
    entry.scratch = (lanes, queue, r)
    return entry


def prep_launch(origin, direction, t_init, nodes, roots, *, active):
    """An L1 / L2 launch's prep alone on CUDA tensors (csrc/lab2.cu
    lab2_prep: the outputs of the lanes that are not active and the list
    of the active ones), to time its share of a launch; returns (t, hit,
    obj), set on the lanes that are not active."""
    dev = t_init.device
    if dev.type != "cuda":
        raise ValueError(f"prep_launch runs on cuda tensors, not {dev}")
    return cm.launch(_entry(cm.build().lab2_prep, t_init.shape[0], dev),
                     "lab2_prep", cm.columns(origin, direction), t_init,
                     nodes, None, tuple(int(r) for r in roots), active,
                     flags=0, node_rows=nodes.shape[0], leaf_rows=0,
                     iters=False, leafs=False)


def occupancy(lab: str, **flags) -> int:
    """Blocks per SM of the walk kernel of an L1 ("L1": traverse_lab2's
    flags) or L2 ("L2": traverse_lab2p's) arm at 128 threads a block."""
    a = cm.LabArgs()
    if lab == "L1":
        a.flags = _flags(flags.get("frame_stack", False),
                         flags.get("fused", False),
                         flags.get("gate_leaf", False),
                         flags.get("cond_push", False))
        got = cm.build().lab2_occupancy(ctypes.addressof(a), None)
    else:
        a.flags = _flags(flags.get("frame_stack", True),
                         flags.get("nearest", False),
                         flags.get("parent", False))
        got = cm.build().lab2p_occupancy(ctypes.addressof(a), None)
    if got < 0:
        raise RuntimeError(f"lab2 occupancy failed (error {-got})")
    return got


def lab2_key(frame_stack=False, fused=False, gate_leaf=False,
             cond_push=False, **_) -> str:
    """The launch key of an L1 arm (ops/pt_frame.py launches)."""
    return cm.arm_key("traverse_lab2", dict(
        fs=frame_stack, fused=fused, gate=gate_leaf, condpush=cond_push))


def lab2p_key(frame_stack=True, nearest=False, parent=False, **_) -> str:
    """The launch key of an L2 arm."""
    return cm.arm_key("traverse_lab2p", dict(fs=frame_stack, near=nearest,
                                             parent=parent))


def _check_tree(what, nodes, roots, fused, nn, frames, parent=False):
    cm.check_stack(what, nodes, roots, slice(48, 56), width=8,
                   fused_nn=nn if fused else 0,
                   frame_words=(2 if parent else cm.FRAME8) if frames else 0,
                   capacity=cm.FSTACK8 if frames else cm.STACK)


def _flags(*bits) -> int:
    return sum(1 << k for k, b in enumerate(bits) if b)


class RayTrips:
    """The plain versions' counters: per lane the trips in which its ray
    held an entry and those in which it tested a leaf row (summed per tile
    of 1024 lanes: `iters`, `leafs`), and the lockstep run's warp trips
    (Lanes.trip: 32 consecutive lanes a warp, no refill) for the count
    launch's `warp_trips`."""

    def __init__(self, L: cm.Lanes):
        self.L = L
        self.iters = torch.zeros(L.n, dtype=torch.int64, device=L.dev)
        self.leafs = torch.zeros_like(self.iters)

    def add(self, held, leaf) -> None:
        self.iters += held.to(torch.int64)
        self.leafs += leaf.to(torch.int64)

    def outputs(self, node_rows: int, per_ray: bool = False) -> tuple:
        L = self.L
        if per_ray:
            res = L.outputs((), node_rows)
            res = res[:3] + (self.iters[:L.n0], self.leafs[:L.n0]) + res[3:]
        else:
            res = L.outputs(tuple(c.view(-1, cm.WARP).sum(dim=1)
                                  for c in (self.iters, self.leafs)),
                            node_rows)
        if L.seen is None:
            return res
        return res[:-1] + (torch.cat([res[-1], L.iters.sum().view(1)]),)


def traverse_lab2(origin, direction, t_init, nodes, ltris, roots, *, active,
                  nn=0, frame_stack=False, fused=False, gate_leaf=False,
                  cond_push=False, count_rows=False):
    """L1 (module docstring).  nodes: (B, 64) node rows, or with fused the
    (B + NL, 128) fused table and nn = B; ltris: (NL, 128) leaf rows (the
    JAX lab takes a dummy row with fused; read only without)."""
    roots = tuple(int(r) for r in roots)
    rays = cm.columns(origin, direction)
    if cond_push and not frame_stack:
        raise ValueError("traverse_lab2: cond_push needs the frame stack")
    if fused and not nn:
        raise ValueError("traverse_lab2: a fused table needs nn")
    _check_tree("traverse_lab2", nodes, roots, fused, nn, frame_stack)
    node_rows = nn if fused else nodes.shape[0]
    leaf_rows = nodes.shape[0] - nn if fused else ltris.shape[0]
    dev = t_init.device
    if dev.type == "cpu":
        return traverse_lab2_reference(
            rays, t_init, nodes, ltris, roots, active=active, nn=nn,
            frame_stack=frame_stack, fused=fused, count_rows=count_rows)
    if dev.type != "cuda":
        raise ValueError(f"traverse_lab2 runs on cuda or cpu tensors, not "
                         f"{dev}")
    out = cm.launch(_entry(cm.build().lab2_launch, t_init.shape[0], dev),
                    "traverse_lab2", rays, t_init,
                    nodes, None if fused else ltris, roots, active,
                    flags=_flags(frame_stack, fused, gate_leaf, cond_push),
                    nn=nn if fused else 0, node_rows=node_rows,
                    leaf_rows=leaf_rows, count_rows=count_rows,
                    warp_trips=True)
    cm.count_launch(lab2_key(frame_stack, fused, gate_leaf, cond_push))
    return out


def traverse_lab2_reference(rays, t_init, nodes, ltris, roots, *, active,
                            nn=0, frame_stack=False, fused=False,
                            count_rows=False, per_ray=False):
    """L1's plain version over the six ray columns (gate_leaf and
    cond_push change no state: a frame with an empty mask sits above the
    stack's top and is never read); per_ray=True gives `iters` and
    `leafs` per lane (i64) instead of per tile."""
    L = cm.Lanes(rays, t_init, active)
    n, dev, ar = L.n, L.dev, L.ar
    node_rows = nn if fused else nodes.shape[0]
    if count_rows:
        L.count_rows(nodes.shape[0] if fused else node_rows + ltris.shape[0])
    bounds = nodes[:, :48].reshape(-1, 8, 6)
    ents = nodes[:, 48:56].contiguous().view(_I32)
    recs = (nodes if fused else ltris).reshape(-1, 8, 16)
    cap = cm.FSTACK8 if frame_stack else cm.STACK
    stack = torch.zeros((n, cap), dtype=_I32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    if frame_stack:
        cm.seed_frames(stack, sp, L.act, roots, cm.FRAME8, 8)
    elif len(roots) > 1:
        stack[L.act, :len(roots) - 1] = torch.tensor(roots[1:], dtype=_I32,
                                                     device=dev)
        sp[L.act] = len(roots) - 1
    e = torch.where(L.act, roots[0], cm.DONE).to(torch.int64)
    trips = RayTrips(L)
    while True:
        live = e != cm.DONE
        if not L.trip(live):
            break
        leaf = live & ((e >= nn) if fused else (e < 0))
        interior = live & ~leaf
        trips.add(live, leaf)
        ec = torch.where(interior, e, 0)
        passed, _ = cm.slab_rows(L, bounds, ents, ec, L.t, True, interior)
        L.mark(ec[interior], 0)
        lrow = torch.where(leaf, (e - nn) if fused else (-e - 1), 0)
        L.mark(lrow[leaf] + node_rows, 1, cm.LEAF_TRIS * int(leaf.sum()))
        cm.leaf_closest(L, recs[lrow + (nn if fused else 0)], leaf)
        if frame_stack:
            w = cm.mask_bits(passed)
            push = live & (w != 0)
            vals = torch.cat([ents[ec].to(torch.int64), w[:, None]], dim=1)
            sp = cm.push_frames(stack, sp, push, vals)
            can = live & (sp > 0)
            kk, base, sp = cm.pop_frames(stack, sp, can, cm.FRAME8)
            ent = stack[ar, base + kk].to(torch.int64)
        else:
            sp = cm.push_slots(stack, sp, passed & live[:, None], ents[ec])
            can = live & (sp > 0)
            sp = sp - can.to(torch.int64)
            ent = stack[ar, torch.clamp(sp, min=0)].to(torch.int64)
        e = torch.where(can, ent, torch.where(live, cm.DONE, e))
    return trips.outputs(node_rows, per_ray)


def traverse_lab2p(origin, direction, t_init, nodes, ltris, roots, *, active,
                   nn, frame_stack=True, nearest=False, parent=False,
                   count_rows=False):
    """L2 (module docstring) over the fused table `nodes` ((B + NL, 128),
    nn = B); `ltris` is not read (the JAX lab takes a dummy row)."""
    del ltris
    roots = tuple(int(r) for r in roots)
    rays = cm.columns(origin, direction)
    if parent and not frame_stack:
        raise ValueError("traverse_lab2p: parent frames require the frame "
                         "stack")
    if nodes.dim() != 2 or nodes.shape[1] != 128 or not 0 < nn < \
            nodes.shape[0]:
        raise ValueError("traverse_lab2p: the pipelined lab needs the fused "
                         "table (fuse_tables) and its nn")
    _check_tree("traverse_lab2p", nodes, roots, True, nn, frame_stack,
                parent)
    dev = t_init.device
    if dev.type == "cpu":
        return traverse_lab2p_reference(
            rays, t_init, nodes, roots, active=active, nn=nn,
            frame_stack=frame_stack, nearest=nearest, parent=parent,
            count_rows=count_rows)
    if dev.type != "cuda":
        raise ValueError(f"traverse_lab2p runs on cuda or cpu tensors, not "
                         f"{dev}")
    out = cm.launch(_entry(cm.build().lab2p_launch, t_init.shape[0], dev),
                    "traverse_lab2p", rays, t_init, nodes, None, roots,
                    active, flags=_flags(frame_stack, nearest, parent),
                    nn=nn, node_rows=nn, leaf_rows=nodes.shape[0] - nn,
                    count_rows=count_rows, warp_trips=True)
    cm.count_launch(lab2p_key(frame_stack, nearest, parent))
    return out


def traverse_lab2p_reference(rays, t_init, nodes, roots, *, active, nn,
                             frame_stack=True, nearest=False, parent=False,
                             count_rows=False, per_ray=False):
    """L2's plain version: per trip (1) every lane with a non-empty stack
    pops its next entry, (2) the current entry's slab or leaf work, (3)
    the current entry's children pushed and the next entry made current;
    the loop runs while an entry or a frame is left.  per_ray as L1's."""
    L = cm.Lanes(rays, t_init, active)
    n, dev, ar = L.n, L.dev, L.ar
    if count_rows:
        L.count_rows(nodes.shape[0])
    bounds = nodes[:, :48].reshape(-1, 8, 6)
    ents = nodes[:, 48:56].contiguous().view(_I32)
    recs = nodes.reshape(-1, 8, 16)
    frame = 2 if parent else cm.FRAME8
    cap = cm.FSTACK8 if frame_stack else cm.STACK
    stack = torch.zeros((n, cap), dtype=_I32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    extra = list(roots[1:])
    if parent:
        words = []
        for g, pos in enumerate(range(0, len(extra), 8)):
            words += [-(g + 1), (1 << len(extra[pos:pos + 8])) - 1]
        if words:
            stack[L.act, :len(words)] = torch.tensor(words, dtype=_I32,
                                                     device=dev)
            sp[L.act] = len(words)
    elif frame_stack:
        cm.seed_frames(stack, sp, L.act, roots, cm.FRAME8, 8)
    elif extra:
        stack[L.act, :len(extra)] = torch.tensor(extra, dtype=_I32,
                                                 device=dev)
        sp[L.act] = len(extra)
    root_ents = torch.tensor(extra + [0], dtype=torch.int64, device=dev)
    e = torch.where(L.act, roots[0], cm.DONE).to(torch.int64)
    trips = RayTrips(L)
    while True:
        live = e != cm.DONE
        alive = live | (sp > 0)
        if not L.trip(alive):
            break
        leaf = live & (e >= nn)
        interior = live & ~leaf
        trips.add(alive, leaf)
        # (1) pop the next entry
        can = sp > 0
        if frame_stack:
            kk, base, sp2 = cm.pop_frames(stack, sp, can, frame,
                                          near_shift=8 if nearest else 0)
            if parent:
                par = stack[ar, base].to(torch.int64)
                from_row = ents[torch.clamp(par, min=0), kk].to(torch.int64)
                seed = root_ents[torch.clamp(8 * (-par - 1) + kk, 0,
                                             len(extra))]
                ent = torch.where(par >= 0, from_row, seed)
            else:
                ent = stack[ar, base + kk].to(torch.int64)
        else:
            sp2 = sp - can.to(torch.int64)
            ent = stack[ar, torch.clamp(sp2, min=0)].to(torch.int64)
        nxt = torch.where(can, ent, cm.DONE)
        # (2) slab or leaf of the current entry
        ec = torch.where(interior, e, 0)
        passed, tmin = cm.slab_rows(L, bounds, ents, ec, L.t, True, interior)
        L.mark(ec[interior], 0)
        w = cm.mask_bits(passed)
        if nearest:
            w = w | (cm.nearest_slot(passed, tmin) << 8)
        lc = torch.where(leaf, e, 0)
        L.mark(lc[leaf], 1, cm.LEAF_TRIS * int(leaf.sum()))
        cm.leaf_closest(L, recs[lc], leaf)
        # (3) push the current entry's children
        push = interior & ((w & 0xFF) != 0)
        if parent:
            sp = cm.push_frames(stack, sp2, push,
                                torch.stack([e, w], dim=1))
        elif frame_stack:
            vals = torch.cat([ents[ec].to(torch.int64), w[:, None]], dim=1)
            sp = cm.push_frames(stack, sp2, push, vals)
        else:
            sp = cm.push_slots(stack, sp2, passed, ents[ec])
        e = nxt
    return trips.outputs(nn, per_ray)
