"""Scenes on the port's XLA walks (Scene(traversal="wide" | "skip" |
"binary")) through the rest of the port against the JAX package on the
CPU: frames through Renderer, the TLAS refit, the
stack bound, the walk graphs' owner, the route gates, the checkpoint
and scene_from_numpy (the walks, tables, intersect_scene and the BVH_DEPTH
view: tests/test_torch_walks.py).

Tolerances:
  * a refit's walk tables, instance tables and world bounds: bitwise a
    fresh build's and the JAX package's _refit_device's;
  * 96x54 frames on a "skip" and a "binary" scene against the JAX
    package's frames on the same scene and walk: the tolerance of
    tests/test_torch_renderer.py (jitted JAX contracts FMAs, ROADMAP
    condition 3)."""

import dataclasses

import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
from cpugpupathtracing_tpu.config import RenderConfig as JRenderConfig
from cpugpupathtracing_tpu.config import RenderSettings as JRenderSettings
from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.models import renderer as jrenderer
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu_torch import benchscenes
from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import renderer as trenderer
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.ops import intersect as tisect

from tests.test_instances import TRANSFORMS
from tests.test_torch_renderer import EQUAL_SHARE_MIN, MAX_MAX, MEAN_MAX
from tests.test_torch_scene import golden_scene
from tests.test_torch_walks import (
    OWN,
    SHARED,
    N,
    _t,
    camera_rays,
    scene,
)

def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.astype(b.dtype).tobytes() == b.tobytes()


def test_packet_snapshot_builds_no_walk_table():
    """A "packet" scene builds none of the walks' tables; use_wide=False
    forces "binary"; a scene without meshes resolves to "binary" in both
    packages; an unknown walk and instanced meshes on the binary walk
    raise."""
    dev = golden_scene(tscene, tmat, tmesh).build_device("cpu")
    assert dev.traversal == "packet" and dev.proots
    assert all(getattr(dev, n) is None for n, _ in tscene.WALK_FIELDS)
    assert dev.node_table is dev.pnodes
    assert tscene.Scene(use_wide=False, traversal="skip").traversal == \
        jscene.Scene(use_wide=False, traversal="skip").traversal == "binary"
    s1 = benchscenes.config1_whitted()[0]
    assert s1.build_device("cpu").traversal == "binary"
    j1 = jscene.Scene()
    j1.add_sphere("s", (0.0, 0.0, 0.0), 1.0, j1.add_material(
        jmat.Material.diffuse((0.5, 0.5, 0.5))))
    assert j1.device().traversal == "binary"
    with pytest.raises(Exception):
        tscene.Scene(traversal="stackless")
    s = scene(tscene, tmat, tmesh, "wide", True)
    s.use_wide, s.traversal = False, "binary"
    with pytest.raises(Exception, match="use_wide"):
        s.build_device("cpu")


@pytest.mark.parametrize("walk", ["skip", "binary"])
def test_frame_vs_jax(walk):
    """A 96x54 ADVANCED frame (3 accumulated) through Renderer on the
    walk's scene (the XLA route, as the gates send it) against the JAX
    package's Renderer on the same scene and walk."""
    kw = dict(camera=(0.0, 0.5, 7.0), width=96, height=54, seed=0x12345678)
    calls = []
    xla_fn = tint.trace_advanced
    mp = pytest.MonkeyPatch()
    mp.setattr(tint, "trace_advanced",
               lambda *a, **k: calls.append(1) or xla_fn(*a, **k))
    try:
        r = trenderer.Renderer(
            scene(tscene, tmat, tmesh, walk),
            camera=CameraConfig(pos=kw["camera"]),
            config=RenderConfig(width=96, height=54, seed=kw["seed"]),
            settings=RenderSettings(render_mode=RenderMode.ADVANCED),
            device="cpu")
        r.render(3)
    finally:
        mp.undo()
    assert len(calls) == 3
    jr = jrenderer.Renderer(
        scene(jscene, jmat, jmesh, walk),
        camera=JCameraConfig(pos=kw["camera"]),
        config=JRenderConfig(width=96, height=54, seed=kw["seed"]),
        settings=JRenderSettings())
    jr.render(3)
    assert jr.scene.device().traversal == walk
    got, ref = r.image_u32(), np.asarray(jr.image_u32())
    delta = np.abs(got.view(np.uint8).astype(np.int64)
                   - ref.view(np.uint8).astype(np.int64))
    assert (delta == 0).mean() >= EQUAL_SHARE_MIN, (delta == 0).mean()
    assert delta.mean() <= MEAN_MAX and delta.max() <= MAX_MAX
    assert r.stats.traced_rays == jr.stats.traced_rays


@pytest.mark.parametrize("walk", ["wide", "skip"])
def test_refit_vs_fresh_and_jax(walk):
    """A transform edit refits the snapshot in place: its wnodes /
    snodes12 TLAS rows, inst_inv, inst_nrm and world bounds equal a
    fresh build's and the JAX package's _refit_device's, bitwise."""
    tf = np.array(TRANSFORMS[1], np.float32).copy()
    tf[:3, 3] += (0.7, -0.4, 1.3)
    ts, js = (scene(S, m, me, walk, True) for S, m, me in
              ((tscene, tmat, tmesh), (jscene, jmat, jmesh)))
    dev = ts.device("cpu")
    before = {n: getattr(dev, n).clone() for n in OWN[walk] + SHARED}
    js.device()
    for s in (ts, js):
        s.set_instance_transform(0, 1, tf)
    assert ts.device("cpu") is dev  # refit in place
    jdev = js.device()
    fresh = scene(tscene, tmat, tmesh, walk, True)
    fresh.objects[0].instances[1] = tf
    fdev = fresh.build_device("cpu")
    node = OWN[walk][0]
    assert not torch.equal(getattr(dev, node), before[node])
    for n in OWN[walk] + SHARED + ("tri_obj",):
        assert _same(getattr(dev, n).numpy(), getattr(fdev, n).numpy()), n
        assert _same(getattr(dev, n).numpy(), getattr(jdev, n)), n


def test_stack_bound_raises_and_wide_builds(monkeypatch):
    """A tree the kernels' stack cannot hold (PT_STACK patched small) is
    refused on "packet" with an error naming the need, the bound and
    Scene(traversal="wide"); the same scene built with traversal="wide"
    walks in PyTorch, its hits brute force's t."""
    monkeypatch.setattr(tscene, "PT_STACK", 8)
    with pytest.raises(RuntimeError, match=r"traversal stack, more than "
                       r"the kernel's 8; Scene\(traversal=\"wide\"\)"):
        golden_scene(tscene, tmat, tmesh).build_device("cpu")
    s = golden_scene(tscene, tmat, tmesh)
    s.traversal = "wide"
    fb = s.build_device("cpu")
    assert fb.traversal == s.build_info["traversal"] == "wide"
    assert not fb.proots and fb.wnodes is not None
    o, d = camera_rays(False)
    t0 = torch.full((N,), 1e34)
    h = tscene.intersect_scene(fb, _t(o), _t(d), t0)
    tris = fb.tris9
    bt, bi = tisect.brute_force_nearest_triangle(
        _t(o), _t(d), tris[:, 0:3], tris[:, 3:6], tris[:, 6:9], t0)
    mesh = (h.kind == tscene.PRIM_MESH) & (h.obj >= 0)
    assert int(mesh.sum()) > 30
    assert torch.equal(h.t[mesh], bt[mesh])


def test_walk_graphs_belong_to_the_snapshot():
    """Each snapshot owns its cache of walk graphs (ops/traverse.py
    run_walk), so they die with it: a new build or a dataclasses.replace
    starts an empty one, a refit keeps the snapshot and its cache, and on
    the CPU no graph is captured."""
    tf = np.array(TRANSFORMS[1], np.float32).copy()
    tf[:3, 3] += (0.5, 0.0, 0.0)
    s = scene(tscene, tmat, tmesh, "wide", True)
    dev = s.device("cpu")
    o, d = camera_rays(True)
    tscene.intersect_scene(dev, _t(o), _t(d), torch.full((N,), 1e34))
    assert isinstance(dev.walk_graphs, dict) and not dev.walk_graphs
    assert dataclasses.replace(dev).walk_graphs is not dev.walk_graphs
    assert s.build_device("cpu").walk_graphs is not dev.walk_graphs
    cache = dev.walk_graphs
    s.set_instance_transform(0, 1, tf)
    assert s.device("cpu") is dev and dev.walk_graphs is cache


@pytest.mark.parametrize("walk", ["wide", "skip", "binary"])
def test_gates_refuse_walk_scenes(walk, monkeypatch):
    """No kernel route takes a snapshot on an XLA walk, even on the card
    (its device patched to report CUDA): packet_path_active is False, the
    per-depth and whole-frame gates give the walk as the reason, the
    Whitted kernel refuses a mesh scene, and trace_sample takes
    trace_advanced / trace_whitted."""
    tdev = scene(tscene, tmat, tmesh, walk).build_device("cpu")
    pdev = golden_scene(tscene, tmat, tmesh).build_device("cpu")
    monkeypatch.setattr(tscene.DeviceScene, "device",
                        property(lambda self: torch.device("cuda")))
    assert tscene.packet_path_active(pdev)
    assert not tscene.packet_path_active(tdev)
    adv = RenderSettings()
    for gate in (tscene.megakernel_gate_reason, tscene.pt_frame_gate_reason):
        assert walk in gate(tdev, adv) and gate(pdev, adv) is None
    assert not tscene.megakernel_active(tdev, adv)
    assert not tscene.pt_frame_active(tdev, adv)
    monkeypatch.setenv("CPUGPU_FORCE_WHITTED_KERNEL", "1")
    assert not tscene.whitted_kernel_active(
        tdev, RenderSettings(render_mode=RenderMode.WHITTED))
    picked = []
    for name in ("trace_advanced_frame", "trace_advanced_mega",
                 "trace_advanced"):
        monkeypatch.setattr(tint, name, lambda *a, _n=name, **k: (
            picked.append(_n), (None, None))[1])
    z = torch.zeros((4, 3))
    trenderer.trace_sample(tdev, adv, z, z, z[:, 0], None)
    assert picked == ["trace_advanced"]


def test_checkpoint_on_binary_scene(tmp_path):
    """save_checkpoint / load_checkpoint on a snapshot without packet
    tables: the fingerprint hashes the walk's node rows, the state comes
    back, and a "packet" renderer of the same scene refuses it."""
    def renderer(walk):
        s = scene(tscene, tmat, tmesh, walk) if walk else \
            golden_scene(tscene, tmat, tmesh)
        return trenderer.Renderer(
            s, camera=CameraConfig(pos=(0.0, 0.5, 7.0)),
            config=RenderConfig(width=16, height=8, seed=5),
            settings=RenderSettings(max_ray_depth=1), device="cpu")
    r = renderer("binary")
    r.render(2)
    path = str(tmp_path / "ck.npz")
    r.save_checkpoint(path)
    r2 = renderer("binary")
    assert r2.load_checkpoint(path)
    assert torch.equal(r2._accumulator, r._accumulator)
    assert r2.num_accumulated == 2
    assert not renderer(None).load_checkpoint(path)
    assert not renderer("skip").load_checkpoint(path)


def test_scene_from_numpy_carries_walks():
    """scene_from_numpy of a JAX snapshot's tables (with its walk tables
    and metadata) gives a snapshot whose intersect_scene equals the
    port's own build bitwise; to_numpy round-trips it."""
    jdev = scene(jscene, jmat, jmesh, "skip", True).device()
    arrays = {n: None if getattr(jdev, n, None) is None
              else np.asarray(getattr(jdev, n))
              for n, _ in tscene.TABLE_FIELDS + tscene.WALK_FIELDS}
    meta = dict(proots=(), poccl_roots=(), light_tri_meta=jdev.light_tri_meta,
                num_lights=jdev.num_lights,
                num_sph=int(jdev.sph_center.shape[0]),
                num_pln=int(jdev.pln_point.shape[0]),
                num_instances=jdev.num_instances, traversal=jdev.traversal,
                use_wide=jdev.use_wide, sroot=jdev.sroot)
    for n in ("pnodes", "pltris", "inst_blas_root_packet"):
        arrays[n] = np.zeros((0,) + np.asarray(getattr(jdev, n)).shape[1:],
                             np.asarray(getattr(jdev, n)).dtype)
    sdev = tscene.scene_from_numpy(arrays, meta, "cpu")
    own = scene(tscene, tmat, tmesh, "skip", True).build_device("cpu")
    o, d = camera_rays(True)
    t0 = torch.full((N,), 1e34)
    a = tscene.intersect_scene(sdev, _t(o), _t(d), t0)
    b = tscene.intersect_scene(own, _t(o), _t(d), t0)
    for x, y in zip(a[:6], b[:6]):
        assert torch.equal(x, y)
    back = tscene.scene_from_numpy(*sdev.to_numpy(), "cpu")
    assert back.traversal == "skip" and back.sroot == sdev.sroot
    assert torch.equal(back.snodes12.view(torch.int32),
                       sdev.snodes12.view(torch.int32))
    assert back.refit is None
