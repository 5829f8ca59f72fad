"""Lockstep BVH walks over whole ray batches (the JAX package's
ops/traverse.py), and the step loop the port's three such walks share.

The JAX package runs these walks as `lax.while_loop`s in XLA: every lane
takes one traversal step per iteration, with per-lane node cursors and
fixed-depth stacks held as (N, ...) arrays, until no lane is live.  Here
the loop is Python over steps made of tensor operations (`run_walk`), on
the card or the CPU:
  * the host asks whether any lane is live only once every
    `check_every` steps (CHECK_EVERY): a step of a finished lane changes
    nothing in any of the three bodies, so the cadence moves only the
    number of host synchronisations, never an output;
  * the steps between two checks run on the lanes still live at the
    first of them, gathered there and written back after the steps: no
    step reads another lane, so the outputs are bitwise those of
    stepping every lane;
  * on the card, given a graph cache (`graphs`, a dict the caller owns:
    DeviceScene.walk_graphs, so that the graphs, their memory pools and
    the tables they read die with the snapshot), when GRAPH_MIN_LANES ..
    GRAPH_MAX_LANES lanes live, the check_every steps between two checks
    replay a CUDA graph captured once per walk arguments and lane count
    (padded to a power of two with copies of a live lane): a step is a
    hundred-odd small operations, which the host launches far slower
    than the card runs them once few lanes live (on an H100 at 700 W a
    1080p frame's walks ran 4-6x faster, PERF.md section 6); the
    replayed steps are the launched ones, bitwise.  The three bounds were
    chosen, not measured against other values.
`stats` counts the calls, steps, host synchronisations, lane-steps and
graph replays and captures since import (chip_smoke.py reads it).

`traverse` is the binary walk, shaped like the reference's
(BVH::Traverse, Source/BVH.cpp:61-127): each step a lane either tests
its interior node's two children (near first, the far child pushed, the
reference's `dist == 1e30` miss sentinel), or intersects a chunk of up to
`leaf_chunk` triangles of its leaf, or pops / goes inactive.  Its
`bvh_depth` counts interior descents: the reference's payload.bvh_depth
for the BVH heat map.  Node rows are (B, 8) f32 [min, max,
bitcast(left_first), bitcast(count)] and triangles (T, 9) f32 [v0, e1,
e2].  Several objects walk in one loop: their rows are concatenated and
every object's root is pushed first.

Every slab test takes the port's one margin (intersect.slab_pass at
SLAB_PAD, ROADMAP condition 12), so the closest hits equal brute force
where the JAX walk's exact test loses a grazing box; `slab_pad=1.0` walks
with the JAX function's exact test.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from cpugpupathtracing_tpu_torch.ops.intersect import (
    SLAB_PAD,
    intersect_aabb,
    intersect_triangle,
)
from cpugpupathtracing_tpu_torch.utils.vecmath import AABB_MISS

# steps between two host checks of whether any lane is live
CHECK_EVERY = 8
# since import: walk calls, steps, host synchronisations, lane-steps
# (lanes given to a step, summed over steps), CUDA-graph replays and
# captures
stats = dict(calls=0, steps=0, syncs=0, lane_steps=0, replays=0,
             captures=0)
# the live-lane counts whose steps replay a CUDA graph on the card: the
# lanes are padded to a power of two between these bounds
GRAPH_MIN_LANES = 1 << 10
GRAPH_MAX_LANES = 1 << 18
# the graphs of one cache together hold at most this many padded lanes
GRAPH_CACHE_LANES = 1 << 21

_INF = float("inf")
_I32 = torch.int32


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def graph_cache() -> OrderedDict:
    """A new, empty graph cache for run_walk's `graphs`."""
    return OrderedDict()


class _StepGraph:
    """`steps` steps of a walk's body over `width` lanes, captured once as
    a CUDA graph and replayed for any live lanes gathered into its input
    buffers.  `tables` (the tensors the body reads besides its buffers)
    and `keep` (the body and its constants) stay alive and in place while
    the graph does; a refit writes the tables in place, which a replay
    reads."""

    def __init__(self, body, state: dict, lanes: dict, steps: int, tables,
                 keep):
        self.tables, self.keep = tables, keep
        self.sin = {k: v.clone() for k, v in state.items()}
        self.lin = {k: v.clone() for k, v in lanes.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the warm-up torch asks for
            s = {k: v.clone() for k, v in state.items()}
            for _ in range(steps):
                s = body(s, self.lin)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            s = self.sin
            for _ in range(steps):
                s = body(s, self.lin)
        self.sout = s
        self.width = next(iter(state.values())).shape[0]

    def run(self, full: dict, lanes: dict, idx, m: int) -> None:
        """Step the m lanes idx of full (padded with copies of the first:
        a copy computes the same values, so writing them back is
        harmless) and write them back."""
        pad = torch.cat([idx, idx[:1].expand(self.width - m)])
        for k, v in self.sin.items():
            torch.index_select(full[k], 0, pad, out=v)
        for k, v in self.lin.items():
            torch.index_select(lanes[k], 0, pad, out=v)
        self.graph.replay()
        for k, v in self.sout.items():
            full[k][idx] = v[:m]


def _graph_for(graphs: OrderedDict, key, body, full: dict, lanes: dict, idx,
               width: int, steps: int, tables, keep) -> _StepGraph:
    """The graph of `key` at `width` lanes in the cache `graphs`, captured
    from the lanes idx of full on first use or when the walk reads other
    tables than the cached graph's (least recently used graphs dropped
    past GRAPH_CACHE_LANES)."""
    gk = (key, width, steps)
    g = graphs.get(gk)
    if g is None or any(a is not b for a, b in zip(g.tables, tables)):
        pad = torch.cat([idx, idx[:1].expand(width - idx.numel())])
        g = _StepGraph(body, {k: v[pad] for k, v in full.items()},
                       {k: v[pad] for k, v in lanes.items()}, steps, tables,
                       keep)
        graphs[gk] = g
        stats["captures"] += 1
        while sum(x.width for x in graphs.values()) > GRAPH_CACHE_LANES:
            graphs.popitem(last=False)
    graphs.move_to_end(gk)
    return g


def run_walk(body, state: dict, lanes: dict, live, *,
             check_every: int = CHECK_EVERY, graphs=None, key=None,
             tables=(), keep=None) -> dict:
    """Step `body(state, lanes) -> state` (one traversal step of every
    lane given; `lanes` holds the read-only per-lane inputs) until
    `live(state)` ((n,) bool) holds for no lane, asked every check_every
    steps; the steps run on the lanes live at the last check only.  On
    the card, with a graph cache `graphs` (graph_cache()), the steps of
    GRAPH_MIN_LANES .. GRAPH_MAX_LANES live lanes replay the cached CUDA
    graph of `key` (the walk's static arguments; `tables` the tensors
    the body reads but state and lanes, `keep` its other constants), the
    lanes padded to a power of two: bitwise the same steps.  Every value
    of state and lanes is an (n, ...) tensor; the body may write the
    tensors of state it was given in place."""
    stats["calls"] += 1
    n = next(iter(state.values())).shape[0]
    use_graphs = (graphs is not None
                  and next(iter(state.values())).device.type == "cuda")
    full = state
    while True:
        idx = live(full).nonzero().squeeze(1)
        stats["syncs"] += 1
        m = int(idx.numel())
        if m == 0:
            break
        width = max(GRAPH_MIN_LANES, 1 << (m - 1).bit_length())
        if use_graphs and width <= GRAPH_MAX_LANES:
            _graph_for(graphs, key, body, full, lanes, idx, width,
                       check_every, tables, keep).run(full, lanes, idx, m)
            stats["replays"] += 1
        elif m == n:
            for _ in range(check_every):
                full = body(full, lanes)
        else:
            sub = {k: v[idx] for k, v in full.items()}
            sub_lanes = {k: v[idx] for k, v in lanes.items()}
            for _ in range(check_every):
                sub = body(sub, sub_lanes)
            for k, v in sub.items():
                full[k][idx] = v
        stats["steps"] += check_every
        stats["lane_steps"] += m * check_every
    return full


def _fma(a, b, c):
    """f32 fma(a, b, c): the exact product and sum in float64, rounded
    once to f32 (a double rounding differs from a fused f32 FMA only when
    the float64 sum lands on an f32 rounding midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def _dot_rows(m, v):
    """(n, 3) products of the 3x3 matrices m (n, 3, 3) with v (n, 3) as
    XLA's dot computes them on the CPU (jnp.einsum("nij,nj->ni") op by
    op): per row an FMA chain from +0 over the columns in order."""
    acc = torch.zeros(m.shape[:2], dtype=torch.float32, device=m.device)
    for k in range(3):
        acc = _fma(m[:, :, k], v[:, None, k], acc)
    return acc


def object_ray(inst_inv, iid, origin, direction):
    """The lane's ray in the object space of its current instance iid
    (world space where iid < 0): origin and direction through the inverse
    transform inst_inv (I, 12) (rows of 3x4), the direction left
    unnormalised so that t stays the world-space parameter (the JAX
    package's traverse_wide / traverse_skip local_ray).  Returns (o, d,
    1 / d)."""
    m = inst_inv[torch.clamp(iid, 0, inst_inv.shape[0] - 1).long()]
    m = m.reshape(-1, 3, 4)
    o = _dot_rows(m[:, :, :3], origin) + m[:, :, 3]
    d = _dot_rows(m[:, :, :3], direction)
    w = (iid >= 0)[:, None]
    o = torch.where(w, o, origin)
    d = torch.where(w, d, direction)
    return o, d, 1.0 / d


def leaf_hits(o, d, trows, k_ok, t):
    """Triangle tests of each lane's (C, 9) triangle rows `trows`
    (N, C, 9) against its ray o, d (N, 3): (N, C) t of the valid hits
    closer than t (N,), inf elsewhere and where k_ok (N, C) is False."""
    valid, tt = intersect_triangle(o[:, None, :], d[:, None, :],
                                   trows[..., 0:3], trows[..., 3:6],
                                   trows[..., 6:9])
    valid = valid & k_ok & (tt < t[:, None])
    return torch.where(valid, tt, torch.full_like(tt, _INF))


def pack_nodes(nodes_min, nodes_max, left_first, prim_count) -> np.ndarray:
    """Node SoA as (B, 8) f32 rows; the ints bitcast into columns 6-7
    (the reference's union of bounds and indices, Include/BVH.h:29-34)."""
    b = len(left_first)
    out = np.empty((b, 8), np.float32)
    out[:, 0:3] = nodes_min
    out[:, 3:6] = nodes_max
    out[:, 6] = np.asarray(left_first, np.int32).view(np.float32)
    out[:, 7] = np.asarray(prim_count, np.int32).view(np.float32)
    return out


def pack_tris(v0, v1, v2) -> np.ndarray:
    """Triangles as (T, 9) f32 rows [v0, e1, e2]."""
    out = np.empty((len(v0), 9), np.float32)
    out[:, 0:3] = v0
    out[:, 3:6] = np.asarray(v1) - np.asarray(v0)
    out[:, 6:9] = np.asarray(v2) - np.asarray(v0)
    return out


def _seed_stack(n, stack_depth, roots, dev):
    """(stack, sptr): the roots after the first pushed in order."""
    stack = torch.zeros((n, stack_depth), dtype=_I32, device=dev)
    for i, r in enumerate(roots[1:]):
        stack[:, i] = r
    return stack, torch.full((n,), len(roots) - 1, dtype=_I32, device=dev)


def traverse(origin, direction, t_init, nodes8, tri_perm, tris9, roots, *,
             active=None, stack_depth: int = 48, leaf_chunk: int = 4,
             any_hit: bool = False, count_depth: bool = True,
             slab_pad: float = SLAB_PAD, check_every: int = CHECK_EVERY,
             graphs=None):
    """The binary walk of a ray batch through concatenated BVHs (the JAX
    package's traverse).  origin/direction (N, 3) f32, t_init (N,) f32
    (1e34 for a fresh ray, a tmax for a shadow ray), nodes8 (B, 8) rows,
    tri_perm (T,) i32 leaf order -> global original triangle index,
    tris9 (T, 9) rows in original order, roots the root rows.  Returns
    (t (t_init where missed), original triangle index (-1 = miss),
    interior descents).  With any_hit a lane stops at its first
    confirmed hit, not necessarily the nearest; `active` (N,) bool masks
    lanes out of the walk; `graphs` a graph cache (run_walk)."""
    n, dev = origin.shape[0], origin.device
    num_tris, num_nodes = tris9.shape[0], nodes8.shape[0]
    roots = tuple(int(r) for r in roots)
    stack, sptr = _seed_stack(n, stack_depth, roots, dev)
    node = torch.full((n,), roots[0], dtype=_I32, device=dev)
    if active is not None:
        node = torch.where(active, node, -1)
        sptr = torch.where(active, sptr, 0)
    minus1 = torch.full((n,), -1, dtype=_I32, device=dev)
    state = dict(node=node, cursor=minus1, stack=stack, sptr=sptr,
                 t=t_init.to(torch.float32, copy=True), hit=minus1.clone(),
                 depth=torch.zeros((n,), dtype=_I32, device=dev))
    lanes = dict(o=origin, d=direction, inv=1.0 / direction)
    chunk = torch.arange(leaf_chunk, dtype=_I32, device=dev)

    def body(s, L):
        node, cursor, stack, sptr = s["node"], s["cursor"], s["stack"], s["sptr"]
        t, hit, depth = s["t"], s["hit"], s["depth"]
        o, d, inv = L["o"], L["d"], L["inv"]
        rows = torch.arange(node.shape[0], device=dev)
        active = node >= 0
        row = nodes8[torch.clamp(node, min=0).long()]
        rowi = row.view(_I32)
        left_first, prim_count = rowi[:, 6], rowi[:, 7]
        is_leaf = active & (prim_count > 0)
        is_interior = active & (prim_count == 0)

        # leaf: up to leaf_chunk triangles from the cursor
        start = torch.where(cursor < 0, left_first, cursor)
        k = start[:, None] + chunk[None, :]
        k_ok = is_leaf[:, None] & (k < (left_first + prim_count)[:, None])
        tri_ids = tri_perm[torch.clamp(k, 0, num_tris - 1).long()]
        trows = tris9[torch.clamp(tri_ids, 0, num_tris - 1).long()]
        tt = leaf_hits(o, d, trows, k_ok, t)
        j = torch.argmin(tt, dim=1)[:, None]
        best_t = torch.gather(tt, 1, j)[:, 0]
        chunk_hit = torch.isfinite(best_t)
        t_leaf = torch.where(chunk_hit, best_t, t)
        hit_leaf = torch.where(chunk_hit, torch.gather(tri_ids, 1, j)[:, 0],
                               hit)
        leaf_done = (start + leaf_chunk) >= (left_first + prim_count)
        if any_hit:
            leaf_done = leaf_done | chunk_hit

        # interior: the two children, near first
        li = torch.clamp(left_first, 0, num_nodes - 1)
        ri = torch.clamp(left_first + 1, 0, num_nodes - 1)
        lrow, rrow = nodes8[li.long()], nodes8[ri.long()]
        dl = intersect_aabb(o, inv, t, lrow[:, 0:3], lrow[:, 3:6], slab_pad)
        dr = intersect_aabb(o, inv, t, rrow[:, 0:3], rrow[:, 3:6], slab_pad)
        swap = dl > dr
        near_i = torch.where(swap, ri, li)
        far_i = torch.where(swap, li, ri)
        near_miss = torch.minimum(dl, dr) == AABB_MISS
        descend = is_interior & ~near_miss
        push_far = descend & (torch.maximum(dl, dr) != AABB_MISS)

        # next node, cursor and stack: pop when a leaf is done or no child
        # is hit; an unfinished leaf stays with its cursor advanced
        stay = is_leaf & ~leaf_done
        pop = ((is_leaf & leaf_done) | (is_interior & near_miss)) & (sptr > 0)
        top = stack[rows, torch.clamp(sptr - 1, 0, stack_depth - 1).long()]
        node_next = torch.where(stay, node, torch.where(
            descend, near_i, torch.where(pop, top, -1)))
        node_next = torch.where(active, node_next, node)
        cursor_next = torch.where(stay, start + leaf_chunk, -1)
        sptr_next = torch.where(pop, sptr - 1, sptr)
        # the far child's push: one write a lane (the slot's own value
        # where nothing is pushed)
        slot = torch.clamp(sptr_next, 0, stack_depth - 1).long()
        stack[rows, slot] = torch.where(push_far, far_i, stack[rows, slot])
        sptr_next = torch.where(push_far, sptr_next + 1, sptr_next)
        return dict(
            node=node_next, cursor=cursor_next, stack=stack, sptr=sptr_next,
            t=torch.where(is_leaf, t_leaf, t),
            hit=torch.where(is_leaf, hit_leaf, hit),
            depth=torch.where(descend & count_depth, depth + 1, depth))

    out = run_walk(
        body, state, lanes, lambda s: s["node"] >= 0,
        check_every=check_every, graphs=graphs,
        key=("binary", stack_depth, leaf_chunk, any_hit, count_depth,
             slab_pad),
        tables=(nodes8, tri_perm, tris9), keep=(body, chunk))
    return out["t"], out["hit"], out["depth"]
