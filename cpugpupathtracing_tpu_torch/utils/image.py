"""Image output (a copy of the JAX package's utils/image.py; numpy and
zlib only).

The reference presents its CPU framebuffer through a DX12 swap-chain blit
(Source/DX12.cpp:277-369); the port renders without a window system, so
the presentation layer becomes: packed-RGBA8 framebuffers written to PNG
(pure-Python zlib encoder, no external deps) or returned as numpy arrays
for notebook display.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def png_bytes(rgba: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode an (H, W, 3|4) uint8 array as in-memory PNG bytes (the
    DX12-presenter stand-in's encoder)."""
    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8:
        raise ValueError(f"png encode expects uint8, got {rgba.dtype}")
    if rgba.ndim != 3 or rgba.shape[2] not in (3, 4):
        raise ValueError(f"png encode expects (H, W, 3|4), got {rgba.shape}")
    h, w, c = rgba.shape
    color_type = 6 if c == 4 else 2
    # Filter byte 0 (None) per scanline.
    raw = b"".join(b"\x00" + rgba[y].tobytes() for y in range(h))
    png = b"\x89PNG\r\n\x1a\n"
    png += _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
    png += _png_chunk(b"IDAT", zlib.compress(raw, compress_level))
    png += _png_chunk(b"IEND", b"")
    return png


def write_png(path: str, rgba: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 array as a PNG file."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgba))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for files written by write_png (8-bit RGB/RGBA,
    no interlace, filter 0). Used by golden-image tests."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", payload[:10])
            if bit_depth != 8 or color_type not in (2, 6):
                raise ValueError("unsupported PNG (need 8-bit RGB/RGBA)")
            c = 4 if color_type == 6 else 3
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * c + 1
    out = np.empty((h, w, c), np.uint8)
    prev = np.zeros(w * c, np.uint16)
    for y in range(h):
        row = raw[y * stride : (y + 1) * stride]
        filt, scan = row[0], np.frombuffer(row[1:], np.uint8).astype(np.uint16)
        if filt == 0:
            cur = scan
        elif filt == 2:  # Up
            cur = (scan + prev) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        out[y] = cur.reshape(w, c).astype(np.uint8)
        prev = cur
    return out


def packed_to_rgba8(packed: np.ndarray) -> np.ndarray:
    """u32 0xAABBGGRR framebuffer -> (H, W, 4) uint8."""
    packed = np.asarray(packed, np.uint32)
    out = np.empty(packed.shape + (4,), np.uint8)
    out[..., 0] = packed & 0xFF
    out[..., 1] = (packed >> 8) & 0xFF
    out[..., 2] = (packed >> 16) & 0xFF
    out[..., 3] = (packed >> 24) & 0xFF
    return out
