"""L3 `traverse16`: closest or any hit over 16-wide fused node|leaf rows,
under the schedule of the JAX package's tools/kernel_lab3.py, and the
table builders `collapse16` / `scene_tables16` (numpy, over the port's
binary BVH, models/bvh.py).

On CUDA tensors `traverse16` launches the hand-written kernel of
csrc/lab3.cu (lab_wide_kernel; built by ops/pt_frame.py with every unit);
on CPU tensors it runs `traverse16_reference`, which steps every lane in
lockstep through the kernel's state machine and equals it bitwise,
counters included.  Nothing falls back from one to the other.

The table: a true 16-wide SAH-cost collapse of the binary tree (the DP of
models/bvh8.py collapse_sah at width 16), node rows of 16 slots -- bounds
at cols 0..95 (6 per slot), child entries at 96..111 (a node row, or nn +
leaf row, SLIM_EMPTY for an empty slot), child counts at 112..127 -- and
the leaf rows after the nn node rows, 8 shading records each (v0, e1,
e2, normal, object, id) with ids local to their object.  The walk:
17-word frames (16 entries and a mask word) pushed only when the mask is
non-zero, the lowest set bit popped first, or with nearest the nearest
slot first; a closest hit whose exact ties go to the lower (object, id),
the order of the global ids, so that t and the object equal the
standalone traversal's over the 8-wide tree and the id equals its global
id less the object's triangle offset; an any hit that stops at the first
record that hits closer than t_init.  count_iters appends the trips of
each tile of 1024 lanes (the sum over its 32 warps); count_rows the
launch's work (common.COUNTS).  The wrapper checks that the tree's
deepest walk fits the kernel's 24 frames and raises otherwise.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cpugpupathtracing_tpu_torch.labs import common as cm
from cpugpupathtracing_tpu_torch.models.bvh8 import SLIM_EMPTY
from cpugpupathtracing_tpu_torch.ops.intersect import intersect_triangle
from cpugpupathtracing_tpu_torch.utils.device import resolve_device

WIDTH = 16
LEAF_TRIS = cm.LEAF_TRIS
_I32 = torch.int32


def collapse16(b, leaf_max: int = 8):
    """The width-16 SAH-cost DP collapse of tools/kernel_lab3.py
    collapse16, bitwise: (nodes (B, 128) f32, ltris (NL, 128) f32,
    max_depth) in the fused encoding (interior children -> node rows,
    leaves -> B + leaf row, SLIM_EMPTY for unused slots); leaf records as
    bvh8.to_slim's (8 records of 16 cols, object column 0, original ids,
    -1 past the leaf's triangles)."""
    n_nodes = b.num_nodes
    lf = b.left_first.astype(np.int64)
    pc = b.prim_count.astype(np.int64)
    nmin, nmax = b.nodes_min, b.nodes_max
    is_leaf = pc > 0
    e = np.maximum(nmax - nmin, 0.0).astype(np.float64)
    sa = np.maximum(
        e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0], 1e-12)

    t_first = np.where(is_leaf, lf, 0)
    t_count = np.where(is_leaf, pc, 0)
    for n in range(n_nodes - 1, -1, -1):
        if not is_leaf[n]:
            left, right = int(lf[n]), int(lf[n]) + 1
            t_first[n] = min(t_first[left], t_first[right])
            t_count[n] = t_count[left] + t_count[right]

    w1 = WIDTH
    inf = np.inf
    cost = np.full((n_nodes, w1), inf)
    choice = np.full((n_nodes, w1), -9, np.int16)
    # split candidates of i children (i = 2..W): j = 1..i-1 to the left
    # child, i - j to the right; invalid (i, j) pairs cost +inf, so the
    # first minimum is the lab's argmin over j in order
    ii = np.arange(1, w1 + 1)[:, None]
    jj = np.arange(1, w1)[None, :]
    ok = jj < ii
    lcol = np.where(ok, jj - 1, 0)
    rcol = np.where(ok, ii - jj - 1, 0)
    for n in range(n_nodes - 1, -1, -1):
        if is_leaf[n]:
            cost[n, :] = sa[n]
            choice[n, :] = -1
            continue
        left, right = int(lf[n]), int(lf[n]) + 1
        v = np.where(ok, cost[left][lcol] + cost[right][rcol], inf)
        k = np.argmin(v, axis=1)
        a_cost = v[np.arange(w1), k]
        a_j = (k + 1).astype(np.int16)
        c_leaf = sa[n] if t_count[n] <= leaf_max else inf
        c_node = sa[n] + a_cost[w1 - 1]
        if c_leaf <= c_node:
            cost[n, 0], choice[n, 0] = c_leaf, -1
        else:
            cost[n, 0], choice[n, 0] = c_node, -2
        for i in range(2, w1 + 1):
            if cost[n, i - 2] <= a_cost[i - 1]:
                cost[n, i - 1] = cost[n, i - 2]
                choice[n, i - 1] = -3
            else:
                cost[n, i - 1] = a_cost[i - 1]
                choice[n, i - 1] = a_j[i - 1]

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 200000))

    def decompose(n, i):
        while i > 1 and choice[n, i - 1] == -3:
            i -= 1
        if i == 1:
            return [n]
        j = int(choice[n, i - 1])
        left, right = int(lf[n]), int(lf[n]) + 1
        return decompose(left, j) + decompose(right, i - j)

    rows: list = [None]
    leaf_order: list = []
    leaf_refs: list = []  # (row, slot, leaf row)
    int_refs: list = []   # (row, slot, child row)
    stack = [([0] if is_leaf[0] else decompose(0, w1), 0)]
    depth_of = {0: 0}
    max_depth = 0
    while stack:
        slots, row_idx = stack.pop()
        d = depth_of[row_idx]
        max_depth = max(max_depth, d)
        bmin = np.full((WIDTH, 3), 1e30, np.float32)
        bmax = np.full((WIDTH, 3), -1e30, np.float32)
        cidx = np.full(WIDTH, SLIM_EMPTY, np.int32)
        ccnt = np.full(WIDTH, -1, np.int32)
        for k, s in enumerate(slots):
            bmin[k] = nmin[s]
            bmax[k] = nmax[s]
            if choice[s, 0] == -1:
                first, cnt = int(t_first[s]), int(t_count[s])
                leaf_refs.append((row_idx, k, len(leaf_order)))
                leaf_order.append(b.tri_indices[first:first + cnt])
                ccnt[k] = cnt
            else:
                child_row = len(rows)
                rows.append(None)
                int_refs.append((row_idx, k, child_row))
                ccnt[k] = 0
                depth_of[child_row] = d + 1
                stack.append((decompose(s, w1), child_row))
        row = np.zeros(128, np.float32)
        row[0:96] = np.concatenate([bmin, bmax], axis=1).reshape(-1)
        row[96:112].view(np.int32)[:] = cidx
        row[112:128].view(np.int32)[:] = ccnt
        rows[row_idx] = row

    nodes = np.stack(rows)
    nn = len(nodes)
    civ = nodes[:, 96:112].view(np.int32)
    for r, k, cr in int_refs:
        civ[r, k] = cr
    for r, k, lr in leaf_refs:
        civ[r, k] = nn + lr

    nl = len(leaf_order)
    ltris = np.zeros((max(nl, 1), 128), np.float32)
    recs = ltris.reshape(-1, LEAF_TRIS, 16)
    tid = ltris.view(np.int32).reshape(-1, LEAF_TRIS, 16)
    tid[:, :, 13] = -1
    if nl:
        lens = np.array([len(s) for s in leaf_order])
        lrow = np.repeat(np.arange(nl), lens)
        slot = np.concatenate([np.arange(c) for c in lens])
        t = np.concatenate(leaf_order).astype(np.int64)
        recs[lrow, slot, 0:3] = b.tri_v0[t]
        recs[lrow, slot, 3:6] = b.tri_v1[t] - b.tri_v0[t]
        recs[lrow, slot, 6:9] = b.tri_v2[t] - b.tri_v0[t]
        recs[lrow, slot, 9:12] = b.tri_normal[t]
        tid[lrow, slot, 13] = t
    return nodes, ltris, max_depth


def scene_tables16(objects, device="cuda"):
    """tools/kernel_lab3.py scene_tables16: the per-object 16-wide tables
    of `objects` (a list of (binary BVH, object index)) concatenated into
    one fused table, the object index stamped in every leaf record; node
    rows of all objects first, then their leaf rows.  Returns (fused
    (B + NL, 128) f32 tensor on `device` (the card unless the caller asks
    for the CPU), nn = B, roots tuple)."""
    device = resolve_device(device)
    metas = [collapse16(b)[:2] + (oi,) for b, oi in objects]
    total_nodes = sum(len(n) for n, _, _ in metas)
    nodes_l, ltris_l, roots = [], [], []
    node_off = leaf_off = 0
    for nodes, ltris, oi in metas:
        nd = nodes.copy()
        civ = nd[:, 96:112].view(np.int32)
        nn_i = len(nodes)
        is_leaf_e = civ >= nn_i
        is_int_e = (civ >= 0) & (civ < nn_i) & (civ != SLIM_EMPTY)
        sel_empty = civ == SLIM_EMPTY
        civ[is_leaf_e & ~sel_empty] += total_nodes - nn_i + leaf_off
        civ[is_int_e] += node_off
        lt = ltris.copy()
        lt.view(np.int32)[:, 12::16] = oi
        nodes_l.append(nd)
        ltris_l.append(lt)
        roots.append(node_off)
        node_off += nn_i
        leaf_off += len(ltris)
    fused = np.concatenate(nodes_l + ltris_l, axis=0)
    return torch.from_numpy(fused).to(device), total_nodes, tuple(roots)


def launch_key(any_hit=False, nearest=False, **_) -> str:
    """The launch key of an L3 arm (ops/pt_frame.py launches)."""
    return cm.arm_key("traverse16", dict(any=any_hit, near=nearest))


def traverse16(origin, direction, t_init, nodes, roots, *, active, nn,
               any_hit=False, count_iters=False, nearest=False,
               count_rows=False):
    """L3 (module docstring): rays as component tuples or (N, 3), t_init
    (N,) f32, the fused table of scene_tables16 and its nn, static roots.
    Returns (t, tri, obj) [+ iters per tile with count_iters] [+ COUNTS
    with count_rows]."""
    roots = tuple(int(r) for r in roots)
    rays = cm.columns(origin, direction)
    if nodes.dim() != 2 or nodes.shape[1] != 128 or not 0 < nn < \
            nodes.shape[0]:
        raise ValueError("traverse16: needs the fused 16-wide table "
                         "(scene_tables16) and its nn")
    cm.check_stack("traverse16", nodes, roots, slice(96, 112), width=16,
                   fused_nn=nn, frame_words=cm.FRAME16,
                   capacity=cm.FSTACK16)
    dev = t_init.device
    if dev.type == "cpu":
        return traverse16_reference(rays, t_init, nodes, roots,
                                    active=active, nn=nn, any_hit=any_hit,
                                    count_iters=count_iters, nearest=nearest,
                                    count_rows=count_rows)
    if dev.type != "cuda":
        raise ValueError(f"traverse16 runs on cuda or cpu tensors, not {dev}")
    out = cm.launch(cm.build().lab3_launch, "traverse16", rays, t_init,
                    nodes, None, roots, active,
                    flags=int(any_hit) | (int(nearest) << 1), nn=nn,
                    node_rows=nn, leaf_rows=nodes.shape[0] - nn,
                    iters=count_iters, leafs=False, count_rows=count_rows)
    cm.count_launch(launch_key(any_hit, nearest))
    return out


def traverse16_reference(rays, t_init, nodes, roots, *, active, nn,
                         any_hit=False, count_iters=False, nearest=False,
                         count_rows=False):
    """L3's plain version over the six ray columns."""
    L = cm.Lanes(rays, t_init, active)
    n, dev, ar = L.n, L.dev, L.ar
    if count_rows:
        L.count_rows(nodes.shape[0])
    bounds = nodes[:, :96].reshape(-1, WIDTH, 6)
    ents = nodes[:, 96:112].contiguous().view(_I32)
    recs = nodes.reshape(-1, LEAF_TRIS, 16)
    stack = torch.zeros((n, cm.FSTACK16), dtype=_I32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    cm.seed_frames(stack, sp, L.act, roots, cm.FRAME16, WIDTH)
    e = torch.where(L.act, roots[0], cm.DONE).to(torch.int64)
    while True:
        live = e != cm.DONE
        if not L.trip(live):
            break
        interior = live & (e < nn)
        leaf = live & ~interior
        ec = torch.where(interior, e, 0)
        passed, tmin = cm.slab_rows(L, bounds, ents, ec,
                                    L.t_init if any_hit else L.t,
                                    not any_hit, interior)
        L.mark(ec[interior], 0)
        w = cm.mask_bits(passed)
        if nearest:
            w = w | (cm.nearest_slot(passed, tmin) << 16)
        lc = torch.where(leaf, e, 0)
        r = recs[lc]
        found = torch.zeros_like(leaf)
        if any_hit:
            valid, tt = intersect_triangle(L.o[:, None, :], L.d[:, None, :],
                                           r[..., 0:3], r[..., 3:6],
                                           r[..., 6:9])
            hits = leaf[:, None] & valid & (tt < L.t_init[:, None])
            found = hits.any(dim=1)
            c = torch.argmax(hits.to(torch.int8), dim=1)
            tests = torch.where(found, c + 1, LEAF_TRIS)
            L.mark(lc[leaf], 1, int(tests[leaf].sum()))
            L.t = torch.where(found, tt[ar, c], L.t)
            L.hit = torch.where(found, r[ar, c, 13].contiguous().view(_I32),
                                L.hit)
            L.obj = torch.where(found, r[ar, c, 12].contiguous().view(_I32),
                                L.obj)
        else:
            L.mark(lc[leaf], 1, LEAF_TRIS * int(leaf.sum()))
            cm.leaf_closest(L, r, leaf, lex=True)
        push = interior & ((w & 0xFFFF) != 0)
        vals = torch.cat([ents[ec].to(torch.int64), w[:, None]], dim=1)
        sp = cm.push_frames(stack, sp, push, vals)
        go = live & ~found
        can = go & (sp > 0)
        kk, base, sp = cm.pop_frames(stack, sp, can, cm.FRAME16,
                                     near_shift=16 if nearest else 0,
                                     low_mask=0xFFFF)
        ent = stack[ar, base + kk].to(torch.int64)
        e = torch.where(can, ent, torch.where(live, cm.DONE, e))
    return L.outputs((L.iters,) if count_iters else (), nn)
