"""The port's camera (cpugpupathtracing_tpu_torch/models/camera.py)
against the JAX package's on the same lanes.

Bitwise against the JAX functions run op by op (jax.disable_jit).  Under
jit, XLA's CPU compiler contracts the screen-plane interpolation
tl + u (tr - tl) + v (bl - tl) into FMAs, which the port (like the
reference and the CUDA build with --fmad=false) does not: a direction
component then moves by a few ULPs of the larger terms -- up to ~2000
ULPs of a component that cancels to nearly zero, still below 1e-6 in
absolute terms.  That bound is asserted too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
from cpugpupathtracing_tpu.models import camera as jcam
from cpugpupathtracing_tpu_torch.config import CameraConfig
from cpugpupathtracing_tpu_torch.models import camera as tcam

JIT_ATOL = 1e-6


def _cams(pos, aspect):
    return (jcam.to_arrays(JCameraConfig(pos=pos, aspect=aspect)),
            tcam.to_arrays(CameraConfig(pos=pos, aspect=aspect), "cpu"))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_block_shape_matches():
    for w, h in ((1920, 1080), (1280, 720), (96, 54), (64, 32), (384, 56)):
        assert tcam.block_shape(w, h) == jcam.block_shape(w, h)
    assert tcam.block_shape(1920, 1080) == (8, 128)
    assert tcam.block_shape(96, 54) is None


def test_lane_rays_bitwise():
    """96x54 (the golden frames) has no block shape: row-major lanes."""
    jc, tc = _cams((0.0, 0.5, 7.0), 16.0 / 9.0)
    lane = np.arange(96 * 54, dtype=np.uint32)
    with jax.disable_jit():
        ref = jcam.lane_rays(jc, jnp.asarray(lane), 96, 54)
    port = tcam.lane_rays(tc, torch.from_numpy(lane.astype(np.int64)), 96, 54)
    _eq(port[0], ref[0])
    _eq(port[1], ref[1])
    jitted = jax.jit(lambda ln: jcam.lane_rays(jc, ln, 96, 54))(
        jnp.asarray(lane))
    np.testing.assert_allclose(port[1].numpy(), np.asarray(jitted[1]),
                               rtol=0, atol=JIT_ATOL)


@pytest.mark.parametrize("w,h,lanes", [(1920, 1080, 16384), (384, 56, None)])
def test_blocked_lane_rays_bitwise(w, h, lanes):
    """8x128 blocks: config 3's 1920x1080 (the middle 16384 lanes) and a
    small frame whole."""
    bh, bw = tcam.block_shape(w, h)
    assert (bh, bw) == (8, 128)
    jc, tc = _cams((0.0, 0.0, 8.0), 16.0 / 9.0)
    n = w * h
    lo = 0 if lanes is None else n // 2 - lanes // 2
    lane = np.arange(lo, lo + (lanes or n), dtype=np.uint32)
    with jax.disable_jit():
        ref = jcam.blocked_lane_rays(jc, jnp.asarray(lane), w, h, bh, bw)
    port = tcam.blocked_lane_rays(tc, torch.from_numpy(lane.astype(np.int64)),
                                  w, h, bh, bw)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r).astype(
            np.int64 if np.asarray(r).dtype == np.uint32 else np.float32))
    jitted = jax.jit(
        lambda ln: jcam.blocked_lane_rays(jc, ln, w, h, bh, bw))(
            jnp.asarray(lane))
    np.testing.assert_allclose(port[1].numpy(), np.asarray(jitted[1]),
                               rtol=0, atol=JIT_ATOL)
    np.testing.assert_array_equal(port[2].numpy(),
                                  np.asarray(jitted[2]).astype(np.int64))


def test_unblock_image_bitwise(rng_np):
    w, h = 384, 56
    arr = rng_np.normal(size=(w * h, 3)).astype(np.float32)
    ref = jcam.unblock_image(jnp.asarray(arr), w, h, 8, 128)
    _eq(tcam.unblock_image(torch.from_numpy(arr), w, h, 8, 128), ref)


def test_blocked_needs_whole_blocks():
    _, tc = _cams((0.0, 0.0, 8.0), 2.0)
    with pytest.raises(ValueError):
        tcam.blocked_lane_rays(tc, torch.arange(64 * 32), 64, 32, 8, 128)
