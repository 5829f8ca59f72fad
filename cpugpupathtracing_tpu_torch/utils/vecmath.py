"""Vector math over `(..., 3)` / `(..., 4)` float32 tensors (the JAX
package's utils/vecmath.py in torch).

Dot products and lengths are written out as x*x + y*y + z*z: a library
reduction may sum three terms in another order, and the hit and shading
arithmetic must associate exactly like the JAX package's."""

from __future__ import annotations

import torch

PI = 3.14159265
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI

# Reference ray-t infinity (Include/Primitives.h:75).
RAY_TMAX = 1e34
# The slab test's miss distance (IntersectAABB, Source/Primitives.cpp:116-146).
AABB_MISS = 1e30

# Self-intersection nudge (Source/Main.cpp:49).
RAY_NUDGE = 0.001


def deg2rad(deg):
    return deg * (PI / 180.0)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, taken in float64 and rounded
    once to f32 (the double rounding is exact for sqrt).  Vectorised
    float32 sqrt on some CPU builds of torch is off by an ULP in rare
    lanes; the reference, XLA and the CUDA kernel all round exactly."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def fdiv(a: torch.Tensor, k: float) -> torch.Tensor:
    """a / k as a true f32 division: a python-scalar divisor may be turned
    into a multiply by its reciprocal on the card, one ULP off."""
    return a / torch.full_like(a, k)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing 3-component axis, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length(v: torch.Tensor) -> torch.Tensor:
    return sqrt(dot3(v, v))


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / length(v)[..., None]


def vec4_to_uint(rgba: torch.Tensor) -> torch.Tensor:
    """Pack `(..., 4)` float RGBA to u32 0xAABBGGRR (values in an int64
    tensor).

    Matches Vec4ToUint (Include/MathLib.h:144-152): clamp each channel
    to <= 1 (and at 0; NaN -> 0), scale by 255, truncate. Alpha forced
    255. No gamma, exactly like the reference.
    """
    c = rgba[..., :3]
    c = torch.clamp(torch.nan_to_num(c, nan=0.0), 0.0, 1.0)
    c = (255.0 * c).to(torch.int64) & 0xFF
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    return (255 << 24) + (b << 16) + (g << 8) + r


def uint_to_rgba8(packed: torch.Tensor) -> torch.Tensor:
    """Unpack u32 0xAABBGGRR to `(..., 4)` uint8 (R, G, B, A)."""
    packed = packed.to(torch.int64)
    chans = [(packed >> sh) & 0xFF for sh in (0, 8, 16, 24)]
    return torch.stack(chans, dim=-1).to(torch.uint8)


def linear_to_srgb(rgb: torch.Tensor) -> torch.Tensor:
    """Correct sRGB OETF (unused by the default pipeline, which packs
    linear like the reference)."""
    c = torch.clamp(rgb, 0.0, 1.0)
    return torch.where(
        c < 0.0031308, c * 12.92, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055
    )
