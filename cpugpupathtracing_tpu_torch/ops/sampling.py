"""Sampling and shading helpers (Source/Util.cpp:7-79,
Source/Primitives.cpp:170-220), batched over lanes and written over
(x, y, z) component tuples of (N,) tensors in exactly the f32
association of the JAX package's ops/sampling.py and
megakernel._shade_surface, which the plain path-tracing body
(ops/pt_frame.py), the XLA integrator (models/integrators.py) and the
CUDA kernel (csrc/pt_device.cuh) all follow.  RNG states are u32 values
in int64 tensors (utils/rng.py).

As in the JAX package, uniform sphere directions are sampled directly
(z = 1 - 2u, azimuth 2 pi u) instead of the reference's rejection loop:
the distribution is identical.
"""

from __future__ import annotations

import torch

from cpugpupathtracing_tpu_torch.utils import rng
from cpugpupathtracing_tpu_torch.utils.vecmath import TWO_PI, sqrt


def uniform_sphere_from_uv(u1: torch.Tensor, u2: torch.Tensor):
    """Uniform direction on the unit sphere from two uniforms in [0,1)."""
    z = 1.0 - 2.0 * u1
    r = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return r * torch.cos(phi), r * torch.sin(phi), z


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize(v):
    """v / |v| (the JAX package's vecmath.normalize)."""
    n = sqrt(_dot(v, v))
    return tuple(c / n for c in v)


def uniform_sphere(state):
    """A uniform unit-sphere direction from two draws: (state', dir)."""
    state, u1 = rng.next_f32(state)
    state, u2 = rng.next_f32(state)
    return state, uniform_sphere_from_uv(u1, u2)


def uniform_hemisphere(state, normal):
    """Uniform hemisphere sample around `normal`: a uniform sphere
    direction flipped to the normal's side (Util::UniformHemisphereSample,
    Source/Util.cpp:7-19)."""
    state, d = uniform_sphere(state)
    flip = torch.where(_dot(d, normal) < 0.0, torch.full_like(d[0], -1.0),
                       torch.ones_like(d[0]))
    return state, tuple(c * flip for c in d)


def cosine_weighted(state, normal):
    """Cosine-weighted hemisphere sample, normalize(normal + unit sphere)
    (Util::CosineWeightedDiffuseReflection, Source/Util.cpp:21-30); where
    normal + d is ~0 the normal itself (the JAX package's
    normalize_safe(..., fallback=normal))."""
    state, u = uniform_sphere(state)
    w = tuple(n + c for n, c in zip(normal, u))
    len_sq = _dot(w, w)
    ok = len_sq > 1e-20
    scale = torch.where(ok, torch.rsqrt(torch.clamp(len_sq, min=1e-20)),
                        torch.zeros_like(len_sq))
    return state, tuple(torch.where(ok, c * scale, n)
                        for c, n in zip(w, normal))


def refract(direction, normal, eta, cosi, k):
    """Snell refraction from precomputed eta, cos(i) and k
    (Source/Util.cpp:51-54): normalize(d eta + (eta cosi - sqrt(max(k,
    0))) n).  The caller selects lanes with k >= 0."""
    coef = eta * cosi - sqrt(torch.clamp(k, min=0.0))
    return _normalize(tuple(dc * eta + coef * nc
                            for dc, nc in zip(direction, normal)))


def random_point_triangle(state, v0, v1, v2):
    """Uniform point on a triangle by folding the unit square over its
    diagonal (Source/Primitives.cpp:170-186): (state', point)."""
    state, u0 = rng.next_f32(state)
    state, u1 = rng.next_f32(state)
    over = (u0 + u1) > 1.0
    alpha = torch.where(over, 1.0 - u0, u0)
    beta = torch.where(over, 1.0 - u1, u1)
    gamma = 1.0 - alpha - beta
    return state, tuple(alpha * a + beta * b + gamma * c
                        for a, b, c in zip(v0, v1, v2))


def random_point_sphere_facing(state, center, radius, pos):
    """A point on the hemisphere of a sphere (center, radius (N,)) that
    faces `pos` (Source/Primitives.cpp:214-220): (state', point)."""
    to_pos = _normalize(tuple(p - c for p, c in zip(pos, center)))
    state, d = uniform_hemisphere(state, to_pos)
    return state, tuple(c + radius * dc for c, dc in zip(center, d))


def survival_probability_rr(r, g, b):
    """clamp(max(albedo.rgb), 0.1, 1.0) (Source/Util.cpp:32-35)."""
    return torch.clamp(torch.maximum(torch.maximum(r, g), b), 0.1, 1.0)


def reflect(d, n, ddn):
    """Mirror reflection d - 2 n (d.n) (Source/Util.cpp:37-40)."""
    return tuple(dc - 2.0 * nc * ddn for dc, nc in zip(d, n))


def fresnel(cos_in, cos_out, ior_outside, ior_inside):
    """Exact polarized Fresnel: mean of squared s/p amplitudes
    (Source/Util.cpp:42-49), fed the signed dot products like the
    reference."""
    s_pol = (ior_outside * cos_in - ior_inside * cos_out) / (
        ior_outside * cos_in + ior_inside * cos_out
    )
    p_pol = (ior_outside * cos_out - ior_inside * cos_in) / (
        ior_outside * cos_out + ior_inside * cos_in
    )
    return 0.5 * (s_pol * s_pol + p_pol * p_pol)
