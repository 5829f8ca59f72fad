"""The port's foundation (cpugpupathtracing_tpu_torch utils/rng.py,
utils/vecmath.py, ops/intersect.py) against the JAX package on the same
numpy inputs: RNG, the RGBA8 pack and every ray-primitive test are
bitwise equal.

The JAX ray-primitive tests run op by op (jax.disable_jit): inside a
jitted fusion XLA's CPU compiler always allows contracting a*b + c into
one FMA, which moves t by up to a few tens of ULPs where u, v or t
cancel.  The port, like the reference and the CUDA kernel (built with
--fmad=false), rounds every product; op by op the JAX functions do the
same, and then the two agree bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.ops import intersect as jint
from cpugpupathtracing_tpu.utils import rng as jrng
from cpugpupathtracing_tpu.utils import vecmath as jvec
from cpugpupathtracing_tpu_torch.ops import intersect as tint
from cpugpupathtracing_tpu_torch.utils import rng as trng
from cpugpupathtracing_tpu_torch.utils import vecmath as tvec

EDGES = np.array([0, 1, 2, 61, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                  0xFFFFFFFF], np.uint32)


def _u32(rng, n=4096):
    return np.concatenate([EDGES, rng.integers(0, 2**32, n, dtype=np.uint64)
                           .astype(np.uint32)])


def _t(a):
    """u32 numpy -> the port's int64 carrier."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq_u32(port, ref):
    np.testing.assert_array_equal(port.numpy().astype(np.uint32),
                                  np.asarray(ref))


def test_wang_hash_bitwise(rng_np):
    x = _u32(rng_np)
    _eq_u32(trng.wang_hash(_t(x)), jrng.wang_hash(jnp.asarray(x)))


@pytest.mark.parametrize("frame,salt", [(0, 0), (7, 0x12345678),
                                        (0xFFFFFFFF, 0xFFFFFFFF)])
def test_seed_lanes_bitwise(rng_np, frame, salt):
    lane = _u32(rng_np)
    ref = jrng.seed_lanes(jnp.asarray(lane), jnp.uint32(frame), salt=salt)
    _eq_u32(trng.seed_lanes(_t(lane), frame, salt=salt), ref)


def test_next_u32_f32_bitwise(rng_np):
    s = _u32(rng_np)
    s_ref, v_ref = jrng.next_u32(jnp.asarray(s))
    s_port, v_port = trng.next_u32(_t(s))
    _eq_u32(s_port, s_ref)
    _eq_u32(v_port, v_ref)
    s_ref, f_ref = jrng.next_f32(jnp.asarray(s))
    s_port, f_port = trng.next_f32(_t(s))
    _eq_u32(s_port, s_ref)
    np.testing.assert_array_equal(f_port.numpy(), np.asarray(f_ref))


def test_u2f_edges_bitwise():
    """u32 -> f32 is correctly rounded on both sides, 0 and 2^32-1 too."""
    ref = EDGES.astype(np.float32) * np.float32(2.3283064365387e-10)
    np.testing.assert_array_equal(trng.u2f(_t(EDGES)).numpy(), ref)


def test_vec4_to_uint_bitwise(rng_np):
    rgba = rng_np.uniform(-0.5, 1.5, (4096, 4)).astype(np.float32)
    rgba[:8, 0] = [np.nan, 0.0, 1.0, 1.0 / 255, 0.5, -0.0, np.inf, -np.inf]
    ref = jvec.vec4_to_uint(jnp.asarray(rgba))
    port = tvec.vec4_to_uint(torch.from_numpy(rgba))
    _eq_u32(port, ref)
    np.testing.assert_array_equal(
        tvec.uint_to_rgba8(port).numpy(), np.asarray(jvec.uint_to_rgba8(ref)))


def test_linear_to_srgb_matches(rng_np):
    """Transcendental (pow): equal within a few ULPs, not bitwise."""
    rgb = rng_np.uniform(-0.2, 1.2, (4096, 3)).astype(np.float32)
    ref = np.asarray(jvec.linear_to_srgb(jnp.asarray(rgb)))
    got = tvec.linear_to_srgb(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def _rays(rng, n):
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _tris(rng, t):
    v0 = rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e2[:4] = 1e-4 * e1[:4]  # near-degenerate: the determinant epsilon
    return v0, e1, e2


def _eq_hits(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def test_intersect_triangle_bitwise(rng_np):
    o, d = _rays(rng_np, 512)
    v0, e1, e2 = _tris(rng_np, 64)
    args = (o[:, None], d[:, None], v0[None], e1[None], e2[None])
    with jax.disable_jit():
        ref = jint.intersect_triangle(*map(jnp.asarray, args))
    port = tint.intersect_triangle(*map(torch.from_numpy, args))
    assert np.asarray(ref[0]).any()
    _eq_hits(port, ref)


def test_intersect_sphere_plane_bitwise(rng_np):
    o, d = _rays(rng_np, 2048)
    c = rng_np.uniform(-2, 2, (8, 3)).astype(np.float32)
    r2 = rng_np.uniform(0.1, 2.0, 8).astype(np.float32)
    args = (o[:, None], d[:, None], c[None], r2[None])
    with jax.disable_jit():
        ref = jint.intersect_sphere(*map(jnp.asarray, args))
    port = tint.intersect_sphere(*map(torch.from_numpy, args))
    assert np.asarray(ref[0]).any()
    _eq_hits(port, ref)
    n = rng_np.normal(size=(8, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n = n.astype(np.float32)
    n[0] = (0.0, 1.0, 0.0)
    d[:16] = (1.0, 0.0, 0.0)  # parallel to plane 0: the denominator epsilon
    args = (o[:, None], d[:, None], c[None], n[None])
    with jax.disable_jit():
        ref = jint.intersect_plane(*map(jnp.asarray, args))
    port = tint.intersect_plane(*map(torch.from_numpy, args))
    _eq_hits(port, ref)


def test_brute_force_nearest_bitwise(rng_np):
    o, d = _rays(rng_np, 1024)
    v0, e1, e2 = _tris(rng_np, 300)
    t_init = np.full(1024, 1e34, np.float32)
    t_init[:64] = 0.5  # a bounded ray: hits beyond it are ignored
    with jax.disable_jit():
        ref = jint.brute_force_nearest_triangle(
            *map(jnp.asarray, (o, d, v0, e1, e2, t_init)))
    port = tint.brute_force_nearest_triangle(
        *map(torch.from_numpy, (o, d, v0, e1, e2, t_init)), chunk=64)
    assert (np.asarray(ref[1]) >= 0).mean() > 0.2
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))
