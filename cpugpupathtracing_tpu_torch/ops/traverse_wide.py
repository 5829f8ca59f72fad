"""8-wide lockstep BVH walk (the JAX package's ops/traverse_wide.py).

The same lockstep scheme as ops/traverse.py (its `run_walk` drives the
steps) over the collapsed 8-wide BVH (models/bvh8.collapse at
LEAF_MAX = 4): each step a lane either
  * expands its interior node: one (64,) row, 8 slab tests, the nearest
    hit child becomes the next entry and the other hit children are
    pushed far to near, so the nearest of them pops first; or
  * intersects its leaf: up to LEAF_MAX contiguous triangles in one
    step; or
  * enters an instance (a TLAS leaf): the lane's ray moves into the
    instance's object space until it pops an entry pushed outside; or
  * pops / goes inactive.

Stack entries encode every kind in one int32: e >= 0 an interior row;
DONE a finished lane; e < 0 otherwise a leaf, v = -e - 1 with start
v >> 3 and count v & 7, or an instance where count is 0 (id v >> 3).
The children are ordered by `_sort8_desc`, the JAX function's
19-comparator network: its order on ties is not a stable sort's and fixes
the visit order, so the hit of an exact tie in t and the bvh_depth count
depend on it.  The pushes are one scatter at sptr + rank (pushed slots
are distinct per lane) and the top of the stack one gather, where the TPU
code compares every slot with every child (an (N, S, 8) temporary).
"""

from __future__ import annotations

import torch

from cpugpupathtracing_tpu_torch.ops.intersect import SLAB_PAD, slab_interval, slab_pass
from cpugpupathtracing_tpu_torch.ops.traverse import (
    CHECK_EVERY,
    _seed_stack,
    leaf_hits,
    object_ray,
    run_walk,
)
from cpugpupathtracing_tpu_torch.utils.vecmath import AABB_MISS

DONE = 0x7FFFFFFF
LEAF_MAX = 4
WIDTH = 8

# child_count codes of a wide node row (models/bvh8.py): > 0 a triangle
# leaf, 0 interior, -1 empty, -2 an instance (TLAS leaf; its child index
# is the instance id)
CCNT_INTERIOR = 0
CCNT_EMPTY = -1
CCNT_INSTANCE = -2

_I32 = torch.int32
_BIG = 0x7FFFFFFF


def _encode_leaf(start, count):
    return -((start << 3) | count) - 1


def _encode_instance(iid):
    return -(iid << 3) - 1  # count bits 0: an instance


def _decode_leaf(e):
    v = -e - 1
    return v >> 3, v & 7


# the optimal 19-comparator sorting network for 8 inputs
_SORT8_PAIRS = (
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (1, 2), (5, 6), (0, 4), (3, 7),
    (1, 5), (2, 6), (3, 5), (2, 4),
    (1, 2), (3, 4), (5, 6),
)


def _sort8_desc(dist, entry):
    """The 8 (dist, entry) columns sorted by dist, descending, through
    the JAX function's comparator network (its tie order, not a stable
    sort's)."""
    d = list(dist.unbind(1))
    e = list(entry.unbind(1))
    for i, j in _SORT8_PAIRS:
        swap = d[i] < d[j]
        d[i], d[j] = torch.where(swap, d[j], d[i]), torch.where(swap, d[i], d[j])
        e[i], e[j] = torch.where(swap, e[j], e[i]), torch.where(swap, e[i], e[j])
    return torch.stack(d, dim=1), torch.stack(e, dim=1)


def traverse8(origin, direction, t_init, nodes, tris9, leaf_tri_id, roots, *,
              active=None, stack_depth: int = 24, any_hit: bool = False,
              count_depth: bool = True, inst_inv=None, inst_blas_root=None,
              slab_pad: float = SLAB_PAD, check_every: int = CHECK_EVERY,
              graphs=None):
    """The 8-wide walk (the JAX package's traverse8).  nodes (B, 64) f32
    wide rows, tris9 (T, 9) rows in leaf order, leaf_tri_id (T,) i32 leaf
    order -> original id, roots the root rows.  With inst_inv (I, 12) and
    inst_blas_root (I,) a TLAS leaf moves the lane into the instance: the
    ray is tested in object space (the unnormalised direction, so t stays
    world t) until the lane pops an entry pushed outside the instance.
    Returns (t, original triangle id (-1 = miss), descents, the hit's
    instance (-1: a world-space hit or none)).  A push past stack_depth
    is dropped and a pop past it reads 0, as in the JAX function.
    `graphs` a graph cache (traverse.run_walk)."""
    n, dev = origin.shape[0], origin.device
    num_tris, num_nodes = tris9.shape[0], nodes.shape[0]
    roots = tuple(int(r) for r in roots)
    instanced = inst_inv is not None
    # one column past the stack takes the pushes that would overflow it
    stack, sptr = _seed_stack(n, stack_depth + 1, roots, dev)
    entry = torch.full((n,), roots[0], dtype=_I32, device=dev)
    if active is not None:
        entry = torch.where(active, entry, DONE)
        sptr = torch.where(active, sptr, 0)
    minus1 = torch.full((n,), -1, dtype=_I32, device=dev)
    state = dict(entry=entry, stack=stack, sptr=sptr,
                 t=t_init.to(torch.float32, copy=True), hit=minus1,
                 depth=torch.zeros((n,), dtype=_I32, device=dev))
    if instanced:
        state.update(iid=minus1.clone(), stack_iid=torch.full_like(stack, -1),
                     hit_iid=minus1.clone())
        nblas = inst_blas_root.shape[0]
    lanes = dict(o=origin, d=direction)
    if not instanced:
        lanes["inv"] = 1.0 / direction
    quad = torch.arange(LEAF_MAX, dtype=_I32, device=dev)

    def body(s, L):
        entry, stack, sptr = s["entry"], s["stack"], s["sptr"]
        t, hit, depth = s["t"], s["hit"], s["depth"]
        m = entry.shape[0]
        lane_active = entry != DONE
        neg = lane_active & (entry < 0)
        if instanced:
            iid = s["iid"]
            decoded = -entry - 1
            is_inst = neg & ((decoded & 7) == 0)
            is_leaf = neg & ((decoded & 7) != 0)
            o, d, inv = object_ray(inst_inv, iid, L["o"], L["d"])
            new_iid = decoded >> 3
            blas_entry = inst_blas_root[
                torch.clamp(new_iid, 0, nblas - 1).long()]
        else:
            is_leaf = neg
            o, d, inv = L["o"], L["d"], L["inv"]
        is_interior = lane_active & (entry >= 0)

        # interior: one row, 8 children
        row = nodes[torch.clamp(torch.where(is_interior, entry, 0), 0,
                                num_nodes - 1).long()]
        bounds = row[:, 0:48].reshape(m, WIDTH, 6)
        rowi = row.view(_I32)
        cidx, ccnt = rowi[:, 48:56], rowi[:, 56:64]
        tmin, tmax = slab_interval(o[:, None, :], inv[:, None, :],
                                   bounds[..., 0:3], bounds[..., 3:6])
        child_hit = (slab_pass(tmin, tmax, t[:, None], False, slab_pad)
                     & (ccnt != CCNT_EMPTY))
        dist = torch.where(child_hit, tmin, torch.full_like(tmin, AABB_MISS))
        child_entry = torch.where(ccnt > 0, _encode_leaf(cidx, ccnt), cidx)
        if instanced:
            child_entry = torch.where(ccnt == CCNT_INSTANCE,
                                      _encode_instance(cidx), child_entry)

        # children by distance, descending (the hit ones last): the
        # nearest becomes the next entry, the other n_hit - 1 are pushed
        # far to near at sptr + rank
        dist_s, entry_s = _sort8_desc(dist, child_entry)
        valid_s = dist_s != AABB_MISS
        n_hit = valid_s.sum(dim=1, dtype=_I32)
        nearest = entry_s[:, WIDTH - 1]
        rank = torch.cumsum(valid_s.to(_I32), dim=1, dtype=_I32) - 1
        is_push = valid_s & (rank < (n_hit - 1)[:, None]) & is_interior[:, None]
        slot = sptr[:, None] + rank
        slot = torch.where(is_push & (slot < stack_depth), slot,
                           stack_depth).long()
        stack.scatter_(1, slot, entry_s)
        if instanced:
            stack_iid = s["stack_iid"]
            stack_iid.scatter_(1, slot, iid[:, None].expand(-1, WIDTH))
        sptr_int = sptr + torch.where(is_interior,
                                      torch.clamp(n_hit - 1, min=0), 0)
        descend = is_interior & (n_hit > 0)

        # leaf: up to LEAF_MAX contiguous triangles
        if instanced:
            start = torch.where(is_leaf, decoded >> 3, -1)
            count = torch.where(is_leaf, decoded & 7, 0)
        else:
            start, count = _decode_leaf(torch.where(is_leaf, entry, -1))
        k = start[:, None] + quad[None, :]
        k_ok = is_leaf[:, None] & (quad[None, :] < count[:, None])
        kc = torch.clamp(k, 0, max(num_tris - 1, 0))
        tt = leaf_hits(o, d, tris9[kc.long()], k_ok, t)
        best_t = torch.amin(tt, dim=1)
        chunk_hit = torch.isfinite(best_t)
        kc_best = torch.amin(torch.where(tt == best_t[:, None], kc, _BIG),
                             dim=1)
        t = torch.where(chunk_hit, best_t, t)
        hit = torch.where(chunk_hit, kc_best, hit)

        # next entry
        finished = is_leaf | (is_interior & (n_hit == 0))
        pop = finished & (sptr_int > 0)
        top_at = torch.clamp(sptr_int - 1, min=0)
        top_in = top_at < stack_depth
        top_at = torch.clamp(top_at, max=stack_depth).long()[:, None]
        top = torch.where(top_in, torch.gather(stack, 1, top_at)[:, 0], 0)
        entry_next = torch.where(descend, nearest,
                                 torch.where(pop, top, DONE))
        out = dict(stack=stack, t=t, hit=hit)
        if instanced:
            top_iid = torch.where(
                top_in, torch.gather(stack_iid, 1, top_at)[:, 0], 0)
            iid_next = torch.where(descend, iid,
                                   torch.where(pop, top_iid, iid))
            out.update(iid=torch.where(is_inst, new_iid, iid_next),
                       stack_iid=stack_iid,
                       hit_iid=torch.where(chunk_hit, iid, s["hit_iid"]))
            entry_next = torch.where(is_inst, blas_entry, entry_next)
        entry_next = torch.where(lane_active, entry_next, DONE)
        if any_hit:
            entry_next = torch.where(is_leaf & chunk_hit, DONE, entry_next)
        out.update(
            entry=entry_next,
            sptr=torch.where(lane_active & pop, sptr_int - 1, sptr_int),
            depth=torch.where(descend & count_depth, depth + 1, depth))
        return out

    out = run_walk(
        body, state, lanes, lambda s: s["entry"] != DONE,
        check_every=check_every, graphs=graphs,
        key=("wide", stack_depth, any_hit, count_depth, slab_pad),
        tables=(nodes, tris9, inst_inv, inst_blas_root), keep=(body, quad))
    hit = out["hit"]
    tri = torch.where(
        hit >= 0,
        leaf_tri_id[torch.clamp(hit, 0, max(num_tris - 1, 0)).long()], -1)
    hit_iid = out["hit_iid"] if instanced else torch.full_like(hit, -1)
    return out["t"], tri, out["depth"], hit_iid
