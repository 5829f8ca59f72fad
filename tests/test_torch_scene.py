"""The port's scene build (cpugpupathtracing_tpu_torch/models/scene.py)
against the JAX package's Scene.device() under the benchmark's tree flags
(CPUGPU_PACKET_TREE=sweep_dp, CPUGPU_OCCL=1, CPUGPU_SMEMTREE=48,
CPUGPU_FRAMESTACK=1 -- the port's defaults -- patched on the JAX modules
as tests/test_golden.py patches PACKET_TREE): every table the
path-tracing kernels read, the side tables and 48-col rows included, is
bitwise equal.  Also: the morton8 sort key, the numpy
round trip, the port's independence from JAX and the device default."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu.ops import traverse_packet_slim as jtps
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import scene as tscene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The suite runs in several worker processes (pytest-xdist), each of which
# imports every test module.  torch's default of one intra-op thread per
# core in each of them oversubscribes the machine and slows every worker,
# the JAX package's included; one thread each.
torch.set_num_threads(1)


def patch_bench_flags(mp):
    """The JAX package's module constants as its benchmark flags set them
    (bench_flags_default.json): the values the port takes when the
    variables are unset."""
    mp.setattr(jscene, "PACKET_TREE", "sweep_dp")
    mp.setattr(jscene, "PACKET_OCCL", True)
    mp.setattr(jtps, "SMEMTREE_DEFAULT", "48")
    mp.setattr(jtps, "FRAMESTACK_DEFAULT", True)


@pytest.fixture()
def bench_tree_flags(monkeypatch):
    patch_bench_flags(monkeypatch)


def golden_scene(S, mat, mesh):
    """tests/test_golden.py's scene, built with either package."""
    s = S.Scene()
    white = s.add_material(mat.Material.diffuse((0.9, 0.9, 0.9)))
    blue = s.add_material(mat.Material.diffuse((0.2, 0.2, 0.8)))
    light = s.add_material(mat.Material.light((1.0, 0.95, 0.8), 10.0))
    glass = s.add_material(mat.Material.dielectric(
        (1.0, 1.0, 1.0), 0.0, 1.0, (0.2, 0.8, 0.8), 1.517))
    s.add_mesh("ico", mesh.icosphere(radius=1.5, subdivisions=2), glass)
    s.add_mesh("cube", mesh.cube(center=(2.8, -0.5, -1.0), half=0.9), blue)
    s.add_plane("floor", (0.0, -2.0, 0.0), (0.0, 1.0, 0.0), white)
    li = s.add_sphere("light", (8.0, 9.0, 7.0), 4.0, light)
    s.mark_light(li)
    return s


def megakernel_scene(S, mat, mesh, num_lights=2):
    """tests/test_megakernel.py's scene, built with either package."""
    s = S.Scene()
    white = s.add_material(mat.Material.diffuse((0.8, 0.8, 0.8)))
    glass = s.add_material(mat.Material.dielectric(
        (0.9, 0.9, 0.9), 0.1, 0.8, (0.1, 0.2, 0.2), 1.5))
    light = s.add_material(mat.Material.light((1.0, 0.95, 0.8), 10.0))
    mirror = s.add_material(mat.Material.diffuse((0.9, 0.9, 0.9),
                                                 specular=1.0))
    s.add_mesh("ball", mesh.icosphere(subdivisions=1), glass)
    s.add_mesh("floor", mesh.ground_quad(half_extent=50.0, y=-2.0), white)
    s.add_sphere("mirrorball", (2.5, 0.0, 1.0), 0.8, mirror)
    s.add_plane("backwall", (0.0, 0.0, -12.0), (0.0, 0.0, 1.0), white)
    centers = [(6.0, 6.0, 6.0), (-6.0, 6.0, -4.0)]
    for li in range(num_lights):
        i = s.add_sphere(f"light{li}", centers[li], 2.0, light)
        s.mark_light(i)
    return s


def jax_tables(jdev):
    """The JAX DeviceScene's leaves and static metadata for
    scene_from_numpy."""
    arrays = {n: None if getattr(jdev, n) is None
              else np.asarray(getattr(jdev, n))
              for n, _ in tscene.TABLE_FIELDS + tscene.VARIANT_FIELDS}
    meta = dict(proots=jdev.proots, poccl_roots=jdev.poccl_roots,
                light_tri_meta=jdev.light_tri_meta,
                num_lights=jdev.num_lights,
                num_sph=int(jdev.sph_center.shape[0]),
                num_pln=int(jdev.pln_point.shape[0]),
                has_mesh_lights=bool(jdev.has_mesh_lights),
                num_instances=jdev.num_instances,
                packet_flattened=bool(jdev.packet_flattened),
                pfused_nn=jdev.pfused_nn, packet_width=jdev.packet_width,
                smem_small=bool(jdev.smem_small))
    return arrays, meta


def reference_scene(S, mat, mesh):
    """Config 3's scene: the ~92k-triangle dragon stand-in, the ground
    quad and two sphere lights."""
    return S.make_reference_scene()


@pytest.mark.parametrize("make", [golden_scene, megakernel_scene,
                                  reference_scene],
                         ids=["golden", "megakernel", "config3"])
def test_build_device_bitwise(bench_tree_flags, make):
    jdev = make(jscene, jmat, jmesh).device()
    tdev = make(tscene, tmat, tmesh).build_device("cpu")
    arrays, meta = jax_tables(jdev)
    for name, dtype in tscene.TABLE_FIELDS + tscene.VARIANT_FIELDS:
        ref, got = arrays[name], getattr(tdev, name)
        if ref is None:  # no fused table under the benchmark's flags
            assert got is None, name
            continue
        assert got.dtype == dtype, name
        assert tuple(got.shape) == ref.shape, name
        assert got.numpy().tobytes() == ref.tobytes(), name
    for name in tscene.META_FIELDS:
        assert getattr(tdev, name) == meta[name], name
    assert tdev.pents is not None  # the side tables are the default
    assert tdev.num_mats == int(jdev.mk_mats.shape[0])
    assert tdev.num_objs == int(jdev.mk_objmat.shape[0])


def test_stack_bound_refuses_deep_trees(monkeypatch):
    """A tree whose worst-case traversal stack exceeds the kernel's raises
    (the JAX package falls back to another table; the port has none)."""
    monkeypatch.setattr(tscene, "PT_STACK", 8)
    with pytest.raises(RuntimeError, match="traversal stack"):
        golden_scene(tscene, tmat, tmesh).build_device("cpu")


def test_reorder_key_bitwise(bench_tree_flags, rng_np):
    jdev = golden_scene(jscene, jmat, jmesh).device()
    tdev = golden_scene(tscene, tmat, tmesh).build_device("cpu")
    n = 4096
    o = rng_np.uniform(-20, 20, (n, 3)).astype(np.float32)  # some outside
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d[:8] = 0.0  # direction signs of exact zeros
    d[8:16] = -0.0
    act = rng_np.integers(0, 2, n).astype(np.int32)
    ref = jscene.reorder_key(jdev, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(act), bits=8)
    got = tscene.reorder_key(tdev, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(act))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))


def test_scene_from_numpy_round_trip():
    tdev = megakernel_scene(tscene, tmat, tmesh).build_device("cpu")
    arrays, meta = tdev.to_numpy()
    back = tscene.scene_from_numpy(arrays, meta, "cpu")
    for name, _ in tscene.TABLE_FIELDS + tscene.VARIANT_FIELDS:
        # bytes: the int32 entries bitcast into the f32 rows read as NaNs
        if getattr(tdev, name) is None:
            assert getattr(back, name) is None, name
            continue
        assert getattr(back, name).numpy().tobytes() == \
            getattr(tdev, name).numpy().tobytes(), name
    for name in tscene.META_FIELDS:
        assert getattr(back, name) == getattr(tdev, name), name


def test_port_imports_no_jax(tmp_path):
    """Importing every module of the port and chip_smoke.py loads neither
    jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import cpugpupathtracing_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cpugpupathtracing_tpu')]\n"
        "new = {'models.whitted', 'ops.traverse_packet_slim', "
        "'ops.whitted_kernel'}\n"
        "assert new <= {m.split('.', 1)[1] for m in mods}, mods\n"
        "assert len(mods) >= 18, mods\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_raises_without_cuda(monkeypatch):
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer
    from cpugpupathtracing_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    scene = golden_scene(tscene, tmat, tmesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scene.build_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(scene)
    assert resolve_device("cpu") == torch.device("cpu")
