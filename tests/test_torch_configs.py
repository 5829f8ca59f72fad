"""The port's glTF loader (cpugpupathtracing_tpu_torch models/gltf.py),
its benchmark configurations 2 and 4 and the CONFIGS table
(benchscenes.py), and the per-object build option that config 2 brings
(models/scene.py add_mesh / _packet_tree), against the JAX package.

  * gltf.load against the JAX package's on files the test writes: a
    .gltf with a base64 buffer, a .gltf with an external .bin and an
    interleaved vertex view, a .glb; node transforms (TRS, a matrix, a
    child) baked or not; every array bitwise.
  * Config 2 (the duck asset is absent, so both packages take the
    icosphere, ROADMAP.md condition 1): each mesh's closest-hit tables
    under CPUGPU_PACKET_TREE fat, dp and sweep_dp bitwise against the
    JAX package's _build_wide_cache(obj, mode=...); every table of the
    scene under fat, where NAIVE_SPLIT changes the tree, bitwise against
    JAX's Scene.device(); and one 96x54 frame (the row-major branch) on
    the whole-frame route equal to the per-depth route's.
  * CONFIGS: JAX's five keys and names; config 4 is config 3's scene."""

import base64
import json
import struct

import jax
import numpy as np
import pytest

from cpugpupathtracing_tpu import benchscenes as jbench
from cpugpupathtracing_tpu.models import gltf as jgltf
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu_torch import benchscenes as tbench
from cpugpupathtracing_tpu_torch.config import (
    BuildOption,
    CameraConfig,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import gltf as tgltf
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.models.renderer import Renderer

from tests.test_torch_variants import _assert_tables_equal, _set_flags


def _gltf_doc(rng, interleaved: bool):
    """Two meshes (u16 and u32 indices) and four nodes: a TRS node with a
    child, a matrix node, and a second instance of mesh 0.  Returns (doc
    without buffer uri, the buffer bytes)."""
    parts, views, accessors = [], [], []

    def add(arr, target_comp, typ):
        off = sum(len(p) for p in parts)
        parts.append(arr.tobytes() + b"\0" * (-arr.nbytes % 4))
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": arr.nbytes})
        accessors.append({"bufferView": len(views) - 1,
                          "componentType": target_comp,
                          "count": int(arr.shape[0]), "type": typ})
        return len(accessors) - 1

    meshes = []
    for k, itype in enumerate((np.uint16, np.uint32)):
        nv = 9 + 3 * k
        pos = rng.normal(size=(nv, 3)).astype(np.float32)
        nrm = rng.normal(size=(nv, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        idx = rng.integers(0, nv, 3 * (nv - 2)).astype(itype)
        if interleaved and k == 0:
            off = sum(len(p) for p in parts)
            inter = np.concatenate([pos, nrm], axis=1)
            parts.append(inter.tobytes())
            views.append({"buffer": 0, "byteOffset": off,
                          "byteLength": inter.nbytes, "byteStride": 24})
            accessors.append({"bufferView": len(views) - 1,
                              "componentType": 5126, "count": nv,
                              "type": "VEC3"})
            accessors.append({"bufferView": len(views) - 1, "byteOffset": 12,
                              "componentType": 5126, "count": nv,
                              "type": "VEC3"})
            a_pos, a_nrm = len(accessors) - 2, len(accessors) - 1
        else:
            a_pos = add(pos, 5126, "VEC3")
            a_nrm = add(nrm, 5126, "VEC3")
        a_idx = add(idx, 5123 if itype == np.uint16 else 5125, "SCALAR")
        meshes.append({"primitives": [{"attributes": {
            "POSITION": a_pos, "NORMAL": a_nrm}, "indices": a_idx}]})
    blob = b"".join(parts)
    matrix = np.eye(4)
    matrix[:3, :3] = [[0.0, -2.0, 0.0], [2.0, 0.0, 0.0], [0.0, 0.0, 0.5]]
    matrix[:3, 3] = [1.0, -2.0, 3.0]
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 2, 3]}],
        "nodes": [
            {"mesh": 0, "translation": [0.5, 1.0, -1.5],
             "rotation": [0.0, 0.38268343, 0.0, 0.92387953],
             "scale": [1.5, 1.0, 0.75], "children": [1]},
            {"mesh": 1, "translation": [0.0, 2.0, 0.0]},
            {"mesh": 1, "matrix": matrix.T.reshape(-1).tolist()},
            {"mesh": 0, "scale": [2.0, 2.0, 2.0]},
        ],
        "meshes": meshes,
        "bufferViews": views,
        "accessors": accessors,
        "buffers": [{"byteLength": len(blob)}],
    }
    return doc, blob


def _write(kind: str, tmp_path, rng) -> str:
    doc, blob = _gltf_doc(rng, interleaved=kind == "external")
    if kind == "embedded":
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(blob).decode())
    elif kind == "external":
        (tmp_path / "m.bin").write_bytes(blob)
        doc["buffers"][0]["uri"] = "m.bin"
    if kind != "glb":
        path = tmp_path / "m.gltf"
        path.write_text(json.dumps(doc))
        return str(path)
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    path = tmp_path / "m.glb"
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + len(body))
                     + body)
    return str(path)


@pytest.mark.parametrize("kind", ["embedded", "external", "glb"])
def test_gltf_load_vs_jax(kind, tmp_path, rng_np):
    """gltf.load equals the JAX package's on the same file, bitwise, with
    and without the node transforms and with last_primitive_only."""
    path = _write(kind, tmp_path, rng_np)
    for kw in (dict(), dict(apply_transforms=True),
               dict(last_primitive_only=True)):
        got, ref = tgltf.load(path, **kw), jgltf.load(path, **kw)
        for field in ("positions", "normals", "indices"):
            a, b = getattr(got, field), getattr(ref, field)
            assert a.dtype == b.dtype and a.shape == b.shape, (kw, field)
            assert a.tobytes() == b.tobytes(), (kw, field)
        assert got.num_triangles > 0


def test_gltf_load_errors(tmp_path):
    """The loader's refusals, as the JAX package's: a missing buffer
    file, a GLB without its JSON chunk, a file without geometry."""
    cases = {
        "a.gltf": (json.dumps({"buffers": [{"uri": "gone.bin"}]}).encode(),
                   "missing buffer"),
        "b.glb": (b"glTF" + struct.pack("<II", 2, 12), "JSON chunk"),
        "c.gltf": (json.dumps({"meshes": []}).encode(), "no geometry"),
    }
    for name, (raw, msg) in cases.items():
        (tmp_path / name).write_bytes(raw)
        for loader in (tgltf, jgltf):
            with pytest.raises(RuntimeError, match=msg):
                loader.load(str(tmp_path / name))


def test_configs_table():
    """CONFIGS carries the JAX package's keys and names; config 4 is
    config 3's scene, camera, settings and size."""
    assert {k: v[0] for k, v in tbench.CONFIGS.items()} == \
        {k: v[0] for k, v in jbench.CONFIGS.items()}
    c3 = tbench.config3_sah_dielectrics()
    c4 = tbench.config4_variance_reduction(spp=8)
    assert c4[1:5] == c3[1:5] and c4[5] is None
    assert [o.name for o in c4[0].objects] == [o.name for o in c3[0].objects]


@pytest.fixture(scope="module")
def config2():
    """Config 2 in both packages (the icosphere fallback)."""
    jc = jbench.config2_path_tracer_midpoint()
    tc = tbench.config2_path_tracer_midpoint()
    return jc, tc


@pytest.mark.parametrize("mode", ["fat", "dp", "sweep_dp"])
def test_config2_packet_trees_vs_jax(config2, mode):
    """Each mesh of config 2 (NAIVE_SPLIT) has the JAX package's
    closest-hit tables in each mode, bitwise; fat and dp are cached per
    build option."""
    jc, tc = config2
    assert tc[1] == CameraConfig(pos=(0.0, 0.5, 7.0))
    assert tc[2] == RenderSettings(render_mode=RenderMode.ADVANCED)
    assert tc[3:] == (1280, 720, None) == jc[3:]
    for jo, to in zip(jc[0].objects, tc[0].objects):
        if to.kind != tscene.PRIM_MESH:
            continue
        assert to.build_option == BuildOption.NAIVE_SPLIT
        assert int(jo.build_option) == int(to.build_option)
        ref = jscene._build_wide_cache(jo, mode=mode)[2]
        got = tscene._packet_tree(to, mode)
        assert got.nodes.tobytes() == ref.nodes.tobytes(), (to.name, mode)
        assert got.ltris.tobytes() == ref.ltris.tobytes(), (to.name, mode)
        assert got.max_depth == ref.max_depth
    key = (mode, BuildOption.NAIVE_SPLIT) if mode != "sweep_dp" else mode
    assert key in tc[0].objects[0].blas[1].pw


def test_config2_device_vs_jax(config2, monkeypatch):
    """Config 2's whole snapshot under CPUGPU_PACKET_TREE=fat (the 64-col
    rows): every table bitwise against JAX's Scene.device()."""
    jc, tc = config2
    _set_flags(monkeypatch, tree="fat", smem="0")
    with jax.disable_jit():
        jdev = jc[0].device()
    _assert_tables_equal(jdev, tc[0].build_device("cpu"))


def test_config2_frame_routes(config2, monkeypatch):
    """One 96x54 frame of config 2 (no pixel blocks: the row-major
    branch; the card's 1280x720 takes blocks) on the whole-frame route
    and on the per-depth route (CPUGPU_NO_PTFRAME=1): image and traced
    count equal, bitwise."""
    _, tc = config2
    scene, cam, settings = tc[0], tc[1], tc[2].replace(max_ray_depth=3)
    out = []
    for env in ("0", "1"):
        monkeypatch.setenv("CPUGPU_NO_PTFRAME", env)
        r = Renderer(scene, camera=cam,
                     config=RenderConfig(width=96, height=54),
                     settings=settings, device="cpu")
        r.render_frame()
        out.append((r.image_u32(), r.stats.traced_rays))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] > 96 * 54
    assert (out[0][0] != 0xFF000000).any()
