"""Stackless skip-link BVH walk (the JAX package's ops/traverse_skip.py).

A threaded BVH stores in every node `next`, the node that follows it in
depth-first order when its subtree is skipped (the right sibling of a
left child, the parent's `next` otherwise), so a lane's whole state is
one node row (ops/traverse.py's `run_walk` drives the steps):

    row = nodes[node]                  # (N, 12) rows
    hit = slab(row.bounds)             # one box
    leaf?  its <= 4 contiguous triangles, then node = row.next
    hit and interior -> node = row.left_first (its first child)
    miss             -> node = row.next

It visits more nodes than an ordered walk (no near child first, only
t-culling) but keeps no stack.  Triangles sit in leaf order (the binary
build's permutation).  The scene's roots are chained: each object's DFS
end threads to the next object's root.  Instances need no stack either:
entering a BLAS from a TLAS leaf saves one resume register, and the
BLAS's NEXT_RETURN end restores world space.

Node rows, (B, 12) f32: 0..5 the box, 6 bitcast i32 first triangle
(leaf), first child (interior) or instance id (TLAS instance leaf), 7
bitcast i32 count (0 interior, > 0 leaf, -2 instance leaf), 8 bitcast i32
next (a row; NEXT_DONE ends the walk, NEXT_RETURN pops the resume
register), 9..11 zero.  The packers run on the host in numpy and are
bitwise the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from cpugpupathtracing_tpu_torch.ops.intersect import SLAB_PAD, slab_interval, slab_pass
from cpugpupathtracing_tpu_torch.ops.traverse import (
    CHECK_EVERY,
    leaf_hits,
    object_ray,
    run_walk,
)

LEAF_MAX = 4
NEXT_DONE = -1
NEXT_RETURN = -2
CCNT_INSTANCE = -2

_I32 = torch.int32
_BIG = 0x7FFFFFFF


def pack_skip_nodes(b, tri_off: int, node_off: int, end_next: int) -> np.ndarray:
    """The binary BVH b (models/bvh.py) threaded into (B, 12) rows, at
    global offsets tri_off / node_off; end_next is the `next` of the
    tree's DFS end (the next object's root, NEXT_DONE, or NEXT_RETURN for
    an instanced BLAS)."""
    n = b.num_nodes
    rows = np.zeros((n, 12), np.float32)
    rows[:, 0:3] = b.nodes_min
    rows[:, 3:6] = b.nodes_max
    nxt = np.full(n, end_next, np.int32)
    lf = np.empty(n, np.int32)
    is_leaf = b.prim_count > 0
    lf[is_leaf] = b.left_first[is_leaf] + tri_off
    lf[~is_leaf] = b.left_first[~is_leaf] + node_off

    # next[left] = right; next[right] = next[parent]; DFS-follow = left
    stack = [(0, end_next)]
    while stack:
        node, nx = stack.pop()
        nxt[node] = nx
        if b.prim_count[node] == 0:
            li = int(b.left_first[node])
            stack.append((li, li + 1 + node_off))
            stack.append((li + 1, nx))
    rows[:, 6] = lf.view(np.float32)
    rows[:, 7] = b.prim_count.astype(np.int32).view(np.float32)
    rows[:, 8] = nxt.view(np.float32)
    return rows


def pack_skip_tlas(imin, imax, inst_ids, end_next: int, node_off: int) -> np.ndarray:
    """A threaded binary tree over instance boxes at node_off: median
    splits on the widest axis of the centers, leaves are instance entries
    (count -2, left_first the instance id).  A left subtree's ends are
    threaded to its right sibling once that is built (the PLACEHOLDER
    re-threading of the JAX function)."""
    num = len(inst_ids)
    centers = (imin + imax) * 0.5
    rows: list[np.ndarray] = []

    PLACEHOLDER = np.int32(-777777)

    def _rethread(root_local, nx):
        """Set `next` to nx on every node of root's subtree that still
        holds the placeholder."""
        stack = [root_local]
        while stack:
            i = stack.pop()
            r = rows[i]
            cur = r[8:9].view(np.int32)[0]
            if cur == PLACEHOLDER:
                r[8] = np.int32(nx).view(np.float32)
            if r[7:8].view(np.int32)[0] == 0:
                li = int(r[6:7].view(np.int32)[0]) - node_off
                stack.append(li)
                stack.append(li + 1)

    def build2(ids, nx):
        row_idx = len(rows)
        rows.append(np.zeros(12, np.float32))
        mn = imin[ids].min(0)
        mx = imax[ids].max(0)
        r = rows[row_idx]
        r[0:3], r[3:6] = mn, mx
        if len(ids) == 1:
            r[6] = np.int32(inst_ids[ids[0]]).view(np.float32)
            r[7] = np.int32(CCNT_INSTANCE).view(np.float32)
            r[8] = np.int32(nx).view(np.float32)
            return row_idx
        axis = int(np.argmax(centers[ids].max(0) - centers[ids].min(0)))
        order = np.argsort(centers[ids][:, axis], kind="stable")
        h = max(1, len(ids) // 2)
        li = build2(ids[order[:h]], PLACEHOLDER)
        ri = build2(ids[order[h:]], nx)
        _rethread(li, ri + node_off)
        r[6] = np.int32(li + node_off).view(np.float32)
        r[7] = np.int32(0).view(np.float32)
        r[8] = np.int32(nx).view(np.float32)
        return row_idx

    build2(np.arange(num), end_next)
    return np.stack(rows)


def traverse_skip(origin, direction, t_init, nodes12, tris9, leaf_tri_id,
                  root: int, *, active=None, any_hit: bool = False,
                  count_depth: bool = True, inst_inv=None,
                  inst_blas_root=None, slab_pad: float = SLAB_PAD,
                  check_every: int = CHECK_EVERY, graphs=None):
    """The skip-link walk (the JAX package's traverse_skip) from `root`
    through nodes12 (B, 12), tris9 (T, 9) in leaf order and leaf_tri_id
    (T,) leaf order -> original global id; with inst_inv (I, 12) and
    inst_blas_root (I,) the instance arm.  Returns (t, original triangle
    id (-1 = miss), interior boxes hit, the hit's instance (-1: a
    world-space hit or none)); `graphs` a graph cache
    (traverse.run_walk)."""
    n, dev = origin.shape[0], origin.device
    num_tris, num_nodes = tris9.shape[0], nodes12.shape[0]
    instanced = inst_inv is not None
    node = torch.full((n,), int(root), dtype=_I32, device=dev)
    if active is not None:
        node = torch.where(active, node, NEXT_DONE)
    minus1 = torch.full((n,), -1, dtype=_I32, device=dev)
    state = dict(node=node, t=t_init.to(torch.float32, copy=True),
                 hit=minus1, depth=torch.zeros((n,), dtype=_I32, device=dev))
    if instanced:
        state.update(iid=minus1.clone(),
                     resume=torch.full_like(minus1, NEXT_DONE),
                     hit_iid=minus1.clone())
        nblas = inst_blas_root.shape[0]
    lanes = dict(o=origin, d=direction)
    if not instanced:
        lanes["inv"] = 1.0 / direction
    quad = torch.arange(LEAF_MAX, dtype=_I32, device=dev)

    def body(s, L):
        node, t, hit, depth = s["node"], s["t"], s["hit"], s["depth"]
        lane_active = node >= 0
        row = nodes12[torch.clamp(node, 0, num_nodes - 1).long()]
        rowi = row.view(_I32)
        left_first, prim_count, nxt = rowi[:, 6], rowi[:, 7], rowi[:, 8]
        if instanced:
            iid = s["iid"]
            o, d, inv = object_ray(inst_inv, iid, L["o"], L["d"])
        else:
            o, d, inv = L["o"], L["d"], L["inv"]
        tmin, tmax = slab_interval(o, inv, row[:, 0:3], row[:, 3:6])
        box_hit = lane_active & slab_pass(tmin, tmax, t, False, slab_pad)
        do_leaf = box_hit & (prim_count > 0)

        # leaf: <= LEAF_MAX contiguous triangles
        k = left_first[:, None] + quad[None, :]
        k_ok = do_leaf[:, None] & (quad[None, :] < prim_count[:, None])
        kc = torch.clamp(k, 0, max(num_tris - 1, 0))
        tt = leaf_hits(o, d, tris9[kc.long()], k_ok, t)
        best_t = torch.amin(tt, dim=1)
        chunk_hit = torch.isfinite(best_t)
        kc_best = torch.amin(torch.where(tt == best_t[:, None], kc, _BIG),
                             dim=1)
        out = dict(t=torch.where(chunk_hit, best_t, t),
                   hit=torch.where(chunk_hit, kc_best, hit))

        # next node
        descend = box_hit & (prim_count == 0)
        node_next = torch.where(descend, left_first, nxt)
        if instanced:
            # a TLAS instance leaf hit saves the resume row and enters
            # the BLAS; the BLAS's DFS end restores world space
            enter = box_hit & (prim_count == CCNT_INSTANCE)
            new_iid = torch.clamp(left_first, 0, max(nblas - 1, 0))
            resume = torch.where(enter, nxt, s["resume"])
            iid_n = torch.where(enter, new_iid, iid)
            node_next = torch.where(enter, inst_blas_root[new_iid.long()],
                                    node_next)
            ret = lane_active & (node_next == NEXT_RETURN)
            node_next = torch.where(ret, resume, node_next)
            out.update(iid=torch.where(ret, -1, iid_n),
                       resume=torch.where(ret, NEXT_DONE, resume),
                       hit_iid=torch.where(chunk_hit, iid, s["hit_iid"]))
        if any_hit:
            node_next = torch.where(chunk_hit, NEXT_DONE, node_next)
        out.update(node=torch.where(lane_active, node_next, NEXT_DONE),
                   depth=torch.where(descend & count_depth, depth + 1, depth))
        return out

    out = run_walk(
        body, state, lanes, lambda s: s["node"] >= 0,
        check_every=check_every, graphs=graphs,
        key=("skip", any_hit, count_depth, slab_pad),
        tables=(nodes12, tris9, inst_inv, inst_blas_root), keep=(body, quad))
    hit = out["hit"]
    tri = torch.where(
        hit >= 0,
        leaf_tri_id[torch.clamp(hit, 0, max(num_tris - 1, 0)).long()], -1)
    hit_iid = out["hit_iid"] if instanced else torch.full_like(hit, -1)
    return out["t"], tri, out["depth"], hit_iid
