"""Screen-plane pinhole camera, batched ray generation (the JAX package's
models/camera.py in torch, bitwise equal to it).

The screen plane sits at distance deg2rad(fov_deg) along view_dir (the
FOV is used as a focal distance), with corners at center +- (aspect, 1,
0) -- an axis-aligned plane, so the camera translates but cannot rotate
(Source/Main.cpp:94-170).  Screen coordinates have no half-pixel offset:
u = x/width, v = y/height (Source/Main.cpp:713-714).

Lane and pixel indices are int64 tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cpugpupathtracing_tpu_torch.config import CameraConfig
from cpugpupathtracing_tpu_torch.utils import rng as rnglib
from cpugpupathtracing_tpu_torch.utils.device import resolve_device
from cpugpupathtracing_tpu_torch.utils.vecmath import deg2rad, fdiv, normalize


class CameraArrays(NamedTuple):
    pos: torch.Tensor       # (3,) f32
    view_dir: torch.Tensor  # (3,) f32
    fov_rad: torch.Tensor   # () f32
    aspect: torch.Tensor    # () f32


def to_arrays(cam: CameraConfig, device="cuda") -> CameraArrays:
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return CameraArrays(
        pos=f32(cam.pos),
        view_dir=f32(cam.view_dir),
        fov_rad=f32(deg2rad(cam.fov_deg)),
        aspect=f32(cam.aspect),
    )


def screen_plane(cam: CameraArrays):
    """UpdateScreenPlane (Source/Main.cpp:143-149)."""
    one = torch.ones_like(cam.aspect)
    zero = torch.zeros_like(cam.aspect)
    center = cam.pos + cam.fov_rad * cam.view_dir
    top_left = center + torch.stack([-cam.aspect, one, zero])
    top_right = center + torch.stack([cam.aspect, one, zero])
    bottom_left = center + torch.stack([-cam.aspect, -one, zero])
    return cam.pos, top_left, top_right, bottom_left


def get_ray(cam: CameraArrays, u: torch.Tensor, v: torch.Tensor):
    """Camera::GetRay (Source/Main.cpp:133-140), batched over u/v.
    Returns (origin (N, 3), direction (N, 3))."""
    pos, tl, tr, bl = screen_plane(cam)
    pixel = tl + u[..., None] * (tr - tl) + v[..., None] * (bl - tl)
    direction = normalize(pixel - pos)
    origin = pos.expand_as(direction)
    return origin, direction


def lane_rays(cam: CameraArrays, lane: torch.Tensor, width: int, height: int):
    """Rays for flat row-major lane indices (lane = y * width + x)."""
    xs = (lane % width).to(torch.float32)
    ys = (lane // width).to(torch.float32)
    return get_ray(cam, fdiv(xs, float(width)), fdiv(ys, float(height)))


def block_shape(width: int, height: int):
    """Pixel-block tiling for coherent ray order, or None."""
    if width % 32 == 0 and height % 32 == 0:
        return 32, 32
    if width % 128 == 0 and height % 8 == 0:
        return 8, 128
    return None


def blocked_lane_rays(cam: CameraArrays, lane: torch.Tensor, width: int,
                      height: int, bh: int, bw: int):
    """Rays in pixel-block order: consecutive lanes cover a bh x bw pixel
    block.  Returns (origin, direction, pixel_index) where pixel_index is
    the row-major framebuffer position of each lane -- it keys the RNG
    streams, so the image is independent of ray order."""
    if width % bw or height % bh:
        raise ValueError(f"{width}x{height} is not tiled by {bh}x{bw} blocks")
    per_block = bh * bw
    bpr = width // bw
    bi = lane // per_block
    w = lane % per_block
    by = w // bw
    bx = w % bw
    x = (bi % bpr) * bw + bx
    y = (bi // bpr) * bh + by
    pix = y * width + x
    u = fdiv(x.to(torch.float32), float(width))
    v = fdiv(y.to(torch.float32), float(height))
    origin, direction = get_ray(cam, u, v)
    return origin, direction, pix


def unblock_image(arr: torch.Tensor, width: int, height: int, bh: int, bw: int):
    """Block-order (H*W, ...) -> image row-major order, pure reshapes."""
    lead = tuple(arr.shape[1:])
    a = arr.reshape((height // bh, width // bw, bh, bw) + lead)
    a = a.transpose(1, 2)  # (H/bh, bh, W/bw, bw, ...)
    return a.reshape((height * width,) + lead)


def pixel_rays(cam: CameraArrays, width: int, height: int, *, lane=None,
               jitter: bool = False, rng_state=None):
    """Rays for every pixel, row-major (y, x) flattened to (H*W, 3): the
    reference's per-pixel u = x/width, v = y/height (Source/Main.cpp:
    713-716), no half-pixel centring.  lane: (H*W,) int64 lane indices
    (default 0..H*W-1 on the camera's device).  jitter=True adds two
    next_f32 draws of rng_state to x and y and returns (origin, direction,
    rng_state'); else (origin, direction)."""
    if lane is None:
        lane = torch.arange(width * height, dtype=torch.int64,
                            device=cam.pos.device)
    xs = (lane % width).to(torch.float32)
    ys = (lane // width).to(torch.float32)
    if jitter:
        if rng_state is None:
            raise ValueError("jitter=True requires rng_state")
        rng_state, jx = rnglib.next_f32(rng_state)
        rng_state, jy = rnglib.next_f32(rng_state)
        xs = xs + jx
        ys = ys + jy
    origin, direction = get_ray(cam, fdiv(xs, float(width)),
                                fdiv(ys, float(height)))
    if jitter:
        return origin, direction, rng_state
    return origin, direction
