"""Batched ray-primitive intersection (the JAX package's ops/intersect.py
in torch), bitwise equal to it: the same predicates, epsilons and f32
association (Source/Primitives.cpp).

Rays are `(N, 3)` origin/direction tensors and primitives broadcast
against them.  Triangles are stored as (v0, e1, e2) with e1 = v1 - v0,
e2 = v2 - v0 precomputed on the host.  The slab test's one margin
(`slab_pass`, SLAB_PAD) lives here too: every walk of the port, the
kernels' plain versions and the XLA walks (ops/traverse*.py), takes it.
"""

from __future__ import annotations

import numpy as np
import torch

from cpugpupathtracing_tpu_torch.utils.vecmath import AABB_MISS, cross, dot3, sqrt

# Double-sided determinant epsilon (Source/Primitives.cpp:16).
TRI_DET_EPS = 0.001
# Plane denominator epsilon (Source/Primitives.cpp:56).
PLANE_DENOM_EPS = 1e-6

_INF = float("inf")


def intersect_triangle(origin, direction, v0, e1, e2):
    """Moller-Trumbore, double-sided (Source/Primitives.cpp:6-47).
    Returns (valid, t) with t = inf where invalid; the caller still
    checks t < ray.t."""
    h = cross(direction, e2)
    a = dot3(e1, h)
    det_ok = torch.abs(a) >= TRI_DET_EPS
    f = 1.0 / torch.where(det_ok, a, torch.ones_like(a))
    s = origin - v0
    u = f * dot3(s, h)
    q = cross(s, e1)
    v = f * dot3(direction, q)
    t = f * dot3(e2, q)
    valid = det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & ((u + v) <= 1.0) & (t > 0.0)
    return valid, torch.where(valid, t, torch.full_like(t, _INF))


def intersect_sphere(origin, direction, center, radius_sq):
    """Geometric sphere test (Source/Primitives.cpp:71-114)."""
    el = center - origin
    tca = dot3(el, direction)
    d2 = dot3(el, el) - tca * tca
    thc = sqrt(torch.clamp(radius_sq - d2, min=0.0))
    t0 = tca - thc
    t1 = tca + thc
    t = torch.where(t0 < 0.0, t1, t0)
    valid = (tca >= 0.0) & (d2 <= radius_sq) & (t >= 0.0)
    return valid, torch.where(valid, t, torch.full_like(t, _INF))


def intersect_plane(origin, direction, point, normal):
    """Infinite plane (Source/Primitives.cpp:49-69)."""
    denom = dot3(direction, normal)
    denom_ok = torch.abs(denom) > PLANE_DENOM_EPS
    t = dot3(point - origin, normal) / torch.where(
        denom_ok, denom, torch.ones_like(denom))
    valid = denom_ok & (t > 0.0)
    return valid, torch.where(valid, t, torch.full_like(t, _INF))


# csrc/pt_device.cuh SLAB_PAD: 1 + 2 gamma_3 in f32 (1 + 3 * 2^-23)
SLAB_PAD = float(np.float32(1.0) + np.float32(3.0 * 2.0 ** -23))


def slab_pass(tmin, tmax, t, at_t, pad=SLAB_PAD):
    """csrc/pt_device.cuh slab_hit: the conservative slab test (Ize,
    JCGT 2013) of entry and exit distances tmin / tmax against t (at t too
    with at_t): tmax and t widened by pad (SLAB_PAD) before the compares,
    so a ray grazing a flat box's edge keeps the box (ROADMAP C2); pad 1
    is the exact test the port had before.  The products round in f32, as
    the kernel's."""
    hi, tp = tmax * pad, t * pad
    before = (tmin < tp) | (tmin == tp) if at_t else tmin < tp
    return (hi >= tmin) & before & (tmax > 0.0)


def slab_interval(origin, inv_direction, bmin, bmax):
    """(tmin, tmax) of the slab test in the JAX package's arithmetic
    (ops/intersect.py intersect_aabb there): per axis (b - o) * inv,
    min / max of the two, a NaN slab (0 * inf: a zero direction component
    with the origin on the slab) non-restricting, then the max of the
    entries and the min of the exits over the trailing axis."""
    t1 = (bmin - origin) * inv_direction
    t2 = (bmax - origin) * inv_direction
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    lo = torch.where(torch.isnan(lo), -float("inf"), lo)
    hi = torch.where(torch.isnan(hi), float("inf"), hi)
    return torch.amax(lo, dim=-1), torch.amin(hi, dim=-1)


def intersect_aabb(origin, inv_direction, ray_t, bmin, bmax, pad=1.0):
    """Slab test returning the entry distance, or AABB_MISS (1e30) where
    the box is missed (IntersectAABB, Source/Primitives.cpp:116-146; the
    JAX package's intersect_aabb): hit when tmax >= tmin, tmin < ray_t
    and tmax > 0 (slab_pass at `pad`; 1 is the JAX function's exact test,
    the XLA walks pass SLAB_PAD).  The binary walk orders a node's two
    children by these distances and tests the sentinel for a miss."""
    tmin, tmax = slab_interval(origin, inv_direction, bmin, bmax)
    hit = slab_pass(tmin, tmax, ray_t, False, pad)
    return torch.where(hit, tmin, torch.full_like(tmin, AABB_MISS))


def brute_force_nearest_triangle(origin, direction, tri_v0, tri_e1, tri_e2,
                                 t_init, chunk: int = 4096):
    """Oracle: test every triangle against every ray, return the nearest
    (ties keep the lowest index, like argmin).

    rays (N,3) x triangles (T,3) -> (t (N,), tri_idx (N,) int64, -1 =
    miss).  Triangles go in chunks of `chunk` so memory stays
    O(N * chunk)."""
    n = origin.shape[0]
    best_t = torch.full((n,), _INF, dtype=torch.float32, device=origin.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=origin.device)
    for c0 in range(0, tri_v0.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        valid, t = intersect_triangle(
            origin[:, None, :], direction[:, None, :],
            tri_v0[None, sl], tri_e1[None, sl], tri_e2[None, sl],
        )
        t = torch.where(valid & (t < t_init[:, None]), t,
                        torch.full_like(t, _INF))
        ct, ci = _first_min(t)
        closer = ct < best_t  # strict: an earlier chunk keeps a tie
        best_t = torch.where(closer, ct, best_t)
        best_i = torch.where(closer, ci + c0, best_i)
    hit = torch.isfinite(best_t)
    return torch.where(hit, best_t, t_init), torch.where(hit, best_i, -1)


def _first_min(t: torch.Tensor):
    """(min over dim 1, lowest column index attaining it)."""
    m = torch.amin(t, dim=1)
    cols = torch.arange(t.shape[1], device=t.device).expand_as(t)
    idx = torch.where(t == m[:, None], cols, t.shape[1])
    return m, torch.amin(idx, dim=1)
