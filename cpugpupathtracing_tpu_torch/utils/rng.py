"""Counter-seeded per-lane xorshift32 RNG, bitwise equal to the JAX
package's utils/rng.py.

u32 values ride in int64 tensors holding 0 .. 2**32 - 1: torch's uint32
lacks shifts and multiplies on some backends, and an int64 product of
two values below 2**32 can overflow, so 32-bit products are formed from
16-bit halves (`_mul32`).  Every helper masks its result to 32 bits.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
F32_SCALE = 2.3283064365387e-10  # Include/Random.h:31-34


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2**32 for x in [0, 2**32) and a constant k < 2**32,
    without int64 overflow: both 16-bit halves of x times k stay < 2**48."""
    lo = (x & 0xFFFF) * k
    hi = ((x >> 16) * k) & 0xFFFF
    return (lo + (hi << 16)) & M32


def wang_hash(x: torch.Tensor) -> torch.Tensor:
    """WangHash (Include/Random.h:6-13), batched over u32 values."""
    x = (x ^ 61) ^ (x >> 16)
    x = _mul32(x, 9)
    x = x ^ (x >> 4)
    x = _mul32(x, 0x27D4EB2D)
    x = x ^ (x >> 15)
    return x


def seed_lanes(lane_index: torch.Tensor, frame_index: int, salt: int = 0):
    """Deterministic per-lane seeds: hash lane id with frame and salt.
    Seeds of exactly 0 would lock xorshift32 at 0 forever, so they are
    remapped (rng.seed_lanes in the JAX package)."""
    lane = lane_index.to(torch.int64) & M32
    salt_term = ((salt & M32) * 0x85EBCA6B + 1) & M32
    s = wang_hash((_mul32(lane, 0x9E3779B9) + salt_term) & M32)
    frame = torch.full_like(lane, (int(frame_index) + 0x68BC21EB) & M32)
    s = wang_hash(s ^ wang_hash(frame))
    return torch.where(s == 0, torch.full_like(s, 0x12345678), s)


def xs32(s: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step (Include/Random.h:15-21)."""
    s = s ^ ((s << 13) & M32)
    s = s ^ (s >> 17)
    s = s ^ ((s << 5) & M32)
    return s


def u2f(v: torch.Tensor) -> torch.Tensor:
    """u32 -> uniform [0,1) f32: a correctly rounded u32 -> f32
    conversion times 2.3283064365387e-10 (Include/Random.h:31-34)."""
    return v.to(torch.float32) * F32_SCALE


def next_u32(state: torch.Tensor):
    """One xorshift32 step: returns (state', value)."""
    s = xs32(state)
    return s, s


def next_f32(state: torch.Tensor):
    """Uniform float in [0, 1): returns (state', value)."""
    s = xs32(state)
    return s, u2f(s)


def next_u32_range(state: torch.Tensor, lo, hi):
    """Uniform integer in [lo, hi] by modulo (RandomUInt32Range,
    Include/Random.h:41-46): returns (state', lo + v % (hi + 1 - lo)), or
    lo where that span is 0 (all of u32).  lo / hi: ints or tensors of
    u32 values; the arithmetic wraps at 2**32 as the JAX package's
    does.  Int bounds stay Python scalars (no host-to-device copy)."""
    s, v = next_u32(state)
    lo, hi = lo & M32, hi & M32
    span = (hi + 1 - lo) & M32
    if not isinstance(span, torch.Tensor):
        return s, (torch.full_like(v, lo) if span == 0
                   else (lo + v % span) & M32)
    return s, torch.where(span == 0, lo + 0 * v,
                          (lo + v % torch.clamp(span, min=1)) & M32)
