"""Sampling and shading helpers (Source/Util.cpp:7-79), batched over
lanes and written over (x, y, z) component tuples in exactly the f32
association of the JAX package's megakernel._shade_surface, which the
plain path-tracing body (ops/pt_frame.py) and the CUDA kernel
(csrc/pt_device.cuh) both follow.

As in the JAX package, uniform sphere directions are sampled directly
(z = 1 - 2u, azimuth 2 pi u) instead of the reference's rejection loop:
the distribution is identical.
"""

from __future__ import annotations

import torch

from cpugpupathtracing_tpu_torch.utils.vecmath import TWO_PI, sqrt


def uniform_sphere_from_uv(u1: torch.Tensor, u2: torch.Tensor):
    """Uniform direction on the unit sphere from two uniforms in [0,1)."""
    z = 1.0 - 2.0 * u1
    r = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return r * torch.cos(phi), r * torch.sin(phi), z


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
