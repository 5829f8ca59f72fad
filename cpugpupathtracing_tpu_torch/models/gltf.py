"""Hand-rolled glTF 2.0 loader (no external deps).

A copy of the JAX package's models/gltf.py (the port imports nothing of
that package; this module needs numpy, json, struct and base64 only).
Replaces the reference's cgltf-based GLTFLoader (Source/GLTFLoader.cpp:19-89
over Extern/cgltf/cgltf.h): parses the JSON, loads external .bin buffers,
base64 data: URIs, and GLB containers, and extracts POSITION + NORMAL
accessors plus indices (u8/u16/u32 widened to u32) into a Mesh.

The reference has a known quirk: it resizes-and-overwrites the output per
primitive, so only the *last* primitive of the *last* mesh survives
(Source/GLTFLoader.cpp:34-85).  The correct behavior (concatenate all
primitives of all meshes) is the default here; `last_primitive_only=True`
reproduces the reference for parity runs.  Like the reference, node
transforms and materials/textures are ignored unless `apply_transforms`.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from cpugpupathtracing_tpu_torch.models.mesh import Mesh
from cpugpupathtracing_tpu_torch.utils.log import except_error, log_warn

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}

_TYPE_COMPONENTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(doc: dict, base_dir: str, glb_bin: bytes | None) -> list[bytes]:
    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if glb_bin is None:
                except_error("GLTFLoader", "buffer without uri outside GLB container")
            buffers.append(glb_bin)
        elif uri.startswith("data:"):
            _, b64 = uri.split(",", 1)
            buffers.append(base64.b64decode(b64))
        else:
            path = os.path.join(base_dir, uri)
            if not os.path.exists(path):
                except_error("GLTFLoader", "missing buffer file: {}", path)
            with open(path, "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(doc: dict, buffers: list[bytes], accessor_idx: int) -> np.ndarray:
    acc = doc["accessors"][accessor_idx]
    if "sparse" in acc:
        except_error("GLTFLoader", "sparse accessors not supported")
    n_comp = _TYPE_COMPONENTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    bv = doc["bufferViews"][acc["bufferView"]]
    data = buffers[bv["buffer"]]
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    item = np.dtype(dtype).itemsize * n_comp
    stride = bv.get("byteStride") or item
    if stride == item:
        arr = np.frombuffer(data, dtype, count * n_comp, start).reshape(count, n_comp)
    else:
        # interleaved bufferView: O(1) strided view over the raw bytes
        # (a per-row Python loop here cost seconds on 100k-vert meshes)
        nbytes = (count - 1) * stride + item if count else 0
        flat = np.frombuffer(data, np.uint8, nbytes, start)
        strided = np.lib.stride_tricks.as_strided(
            flat, shape=(count, item), strides=(stride, 1), writeable=False
        )
        arr = np.ascontiguousarray(strided).view(dtype).reshape(count, n_comp)
    return arr.squeeze(-1) if n_comp == 1 else arr


def _parse_glb(raw: bytes) -> tuple[dict, bytes | None]:
    magic, _version, _length = struct.unpack_from("<III", raw, 0)
    if magic != 0x46546C67:  # 'glTF'
        except_error("GLTFLoader", "not a GLB file")
    pos, doc, binary = 12, None, None
    while pos < len(raw):
        chunk_len, chunk_type = struct.unpack_from("<II", raw, pos)
        chunk = raw[pos + 8 : pos + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # JSON
            doc = json.loads(chunk)
        elif chunk_type == 0x004E4942:  # BIN
            binary = chunk
        pos += 8 + chunk_len
    if doc is None:
        except_error("GLTFLoader", "GLB missing JSON chunk")
    return doc, binary


def _node_world_transforms(doc: dict) -> dict[int, np.ndarray]:
    """World matrix per node for the default scene (column-major glTF)."""

    def local_matrix(node: dict) -> np.ndarray:
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        t = node.get("translation", [0, 0, 0])
        r = node.get("rotation", [0, 0, 0, 1])  # xyzw quaternion
        s = node.get("scale", [1, 1, 1])
        x, y, z, w = r
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        m[:3, :3] = rot * np.asarray(s, np.float64)[None, :]
        m[:3, 3] = t
        return m

    world: dict[int, np.ndarray] = {}

    def visit(node_idx: int, parent: np.ndarray):
        node = doc["nodes"][node_idx]
        w = parent @ local_matrix(node)
        world[node_idx] = w
        for child in node.get("children", []):
            visit(child, w)

    scene = doc.get("scenes", [{}])[doc.get("scene", 0)]
    for root in scene.get("nodes", range(len(doc.get("nodes", [])))):
        visit(root, np.eye(4))
    return world


def load(
    filepath: str,
    *,
    last_primitive_only: bool = False,
    apply_transforms: bool = False,
) -> Mesh:
    """Load a .gltf/.glb file into a single Mesh.

    last_primitive_only: reproduce the reference's overwrite-per-primitive
    bug (Source/GLTFLoader.cpp:34-85).  apply_transforms: bake node world
    transforms into positions/normals (the reference never does).
    """
    with open(filepath, "rb") as f:
        raw = f.read()
    if raw[:4] == b"glTF":
        doc, glb_bin = _parse_glb(raw)
    else:
        doc, glb_bin = json.loads(raw), None
    buffers = _load_buffers(doc, os.path.dirname(filepath), glb_bin)

    transforms: dict[int, np.ndarray] = {}
    mesh_to_nodes: dict[int, list[int]] = {}
    if apply_transforms:
        transforms = _node_world_transforms(doc)
        for node_idx, node in enumerate(doc.get("nodes", [])):
            if "mesh" in node:
                mesh_to_nodes.setdefault(node["mesh"], []).append(node_idx)

    parts: list[Mesh] = []
    for mesh_idx, gmesh in enumerate(doc.get("meshes", [])):
        for prim in gmesh.get("primitives", []):
            attrs = prim["attributes"]
            if "POSITION" not in attrs:
                log_warn("GLTFLoader", "primitive without POSITION skipped")
                continue
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            if "NORMAL" in attrs:
                nrm = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
            else:
                nrm = np.zeros_like(pos)
            if "indices" in prim:
                idx = _read_accessor(doc, buffers, prim["indices"]).astype(np.uint32)
            else:
                idx = np.arange(len(pos), dtype=np.uint32)

            instances = mesh_to_nodes.get(mesh_idx, [None]) if apply_transforms else [None]
            for node_idx in instances:
                p, n = pos, nrm
                if node_idx is not None and node_idx in transforms:
                    m = transforms[node_idx]
                    p = (pos @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
                    nm = np.linalg.inv(m[:3, :3]).T
                    n = nrm @ nm.T
                    n = (n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)).astype(np.float32)
                part = Mesh(p, n, idx)
                if last_primitive_only:
                    parts = [part]
                else:
                    parts.append(part)

    if not parts:
        except_error("GLTFLoader", "no geometry found in {}", filepath)
    out = parts[0]
    for p in parts[1:]:
        out = out.concat(p)
    return out
