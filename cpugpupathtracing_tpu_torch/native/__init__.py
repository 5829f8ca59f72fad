"""Native (C++) BVH builder, loaded via ctypes.

A copy of the JAX package's native builder (bvh_builder.cc is the same
source), compiled with g++ on first use into build/torch_native/<hash>/.
It is the port's only BVH builder: a failed compile raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from cpugpupathtracing_tpu_torch.utils.build import hashed_dir, source_path

_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17",
          "-ffp-contract=off"]  # bit-parity with numpy (no FMA contraction)
_lib = None


def get_lib() -> ctypes.CDLL:
    """Load the native library, compiling it first if needed.  Raises if
    g++ fails."""
    global _lib
    if _lib is not None:
        return _lib
    src = source_path("native", "bvh_builder.cc")
    lib_path = os.path.join(hashed_dir("torch_native", [src], _FLAGS),
                            "libbvh.so")
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    lib.bvh_build.restype = ctypes.c_int
    lib.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def native_bvh_build(
    tri_verts: np.ndarray,
    build_option: int,
    max_leaf_size: int | None,
    leaf_stop: int | None = None,
):
    """Run the native builder. tri_verts: (T, 9) f32 [v0, v1, v2], T > 0.
    Returns (nodes_min, nodes_max, left_first, prim_count, perm,
    max_depth)."""
    lib = get_lib()
    t = len(tri_verts)
    tri_verts = np.ascontiguousarray(tri_verts, np.float32)
    cap = 4 * t
    nodes_min = np.empty((cap, 3), np.float32)
    nodes_max = np.empty((cap, 3), np.float32)
    left_first = np.zeros(cap, np.int32)
    prim_count = np.zeros(cap, np.int32)
    perm = np.empty(t, np.int32)
    info = np.zeros(2, np.int32)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    rc = lib.bvh_build(
        p(tri_verts, ctypes.c_float), t, int(build_option),
        int(max_leaf_size or 0), int(leaf_stop or 0),
        p(nodes_min, ctypes.c_float), p(nodes_max, ctypes.c_float),
        p(left_first, ctypes.c_int32), p(prim_count, ctypes.c_int32),
        p(perm, ctypes.c_int32), p(info, ctypes.c_int32),
    )
    if rc != 0:
        raise ValueError(f"bvh_build failed ({rc}) on {t} triangles")
    n = int(info[0])
    return (
        nodes_min[:n].copy(), nodes_max[:n].copy(),
        left_first[:n].copy(), prim_count[:n].copy(),
        perm, int(info[1]),
    )
