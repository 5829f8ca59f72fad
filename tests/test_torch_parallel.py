"""The port's multi-GPU rendering (cpugpupathtracing_tpu_torch/parallel/:
distributed.py, sharding.py), on the CPU with the gloo backend.

  * The four cases of tests/test_distributed.py on the port: no process
    group without a coordinator, none (and no dial) at num_processes=1,
    the primary and the mesh of one process, the gather of one process.
  * render_rank and trace_rank, rank r of d for every r in one process,
    on tests/test_sharding.py's tiny scene at 64x32 (32x32 blocks: at
    d = 4 each rank holds half a block) and 64x30 (no block shape:
    row-major lanes): the pixels-mode slices put together are bitwise the
    port's one-device frame (accumulator, pixels, traced), and 2 frames
    of 2 spp bitwise the Renderer's, which runs them as 1-spp sub-steps;
    the samples-mode sum in rank order is bitwise its d-spp frame traced
    unrolled.
  * One 2-rank gloo run in two processes (a file:// rendezvous, 60 s a
    join): the CLI in pixels mode under the CPUGPU_* variables, then
    render_frame_sharded in both modes for 2 frames, each bitwise the
    one-device frames; the CLI's stats lines are the one-process CLI's;
    the ranks import no JAX.
  * The JAX package's render_frame_sharded on make_mesh(2) (both modes, 2
    frames, one fixture) against the 2-rank run's images, within the
    golden tolerance of tests/test_torch_renderer.py (measured: pixels
    mode all channels equal, samples mode 99.96%, max 1).
  * ValueError on COMPARISON and on a pixel count the ranks do not divide.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import camera as tcam
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.models.renderer import (
    Renderer,
    accumulate,
    render_frame,
)
from cpugpupathtracing_tpu_torch.parallel import distributed as tdist
from cpugpupathtracing_tpu_torch.parallel import sharding as tshard
from cpugpupathtracing_tpu_torch.utils import image as timage

from tests.test_torch_renderer import EQUAL_SHARE_MIN, MAX_MAX, MEAN_MAX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7
FRAMES = 2
JOIN_S = 60


def tiny_scene(S, mat, mesh):
    """tests/test_sharding.py's tiny_scene, built with either package."""
    s = S.Scene()
    grey = s.add_material(mat.Material.diffuse((0.5, 0.5, 0.5)))
    light = s.add_material(mat.Material.light((1.0, 1.0, 1.0), 10.0))
    s.add_mesh("cube", mesh.cube(half=1.5), grey)
    s.add_plane("floor", (0.0, -3.0, 0.0), (0.0, 1.0, 0.0), grey)
    li = s.add_sphere("light", (8.0, 9.0, 7.0), 4.0, light)
    s.mark_light(li)
    return s


@pytest.fixture(scope="module")
def tiny_host():
    return tiny_scene(tscene, tmat, tmesh)


@pytest.fixture(scope="module")
def tiny(tiny_host):
    return tiny_host.device("cpu")


def one_device(ds, width, height, spp, frames=1):
    """The port's one-device frames from zeros: spp samples a frame at
    sample_base f * spp, unrolled.  Returns (accumulator, pixels, traced
    per frame)."""
    cam = tcam.to_arrays(CameraConfig(), "cpu")
    n = width * height
    acc = torch.zeros((n, 4))
    traced = []
    for f in range(frames):
        acc, pix, tr, _ = render_frame(ds, cam, acc, f * spp,
                                       torch.arange(n), RenderSettings(),
                                       width, height, spp, SEED)
        traced.append(int(tr))
    return acc, pix, traced


# ---- tests/test_distributed.py on the port ----------------------------------


def test_no_env_is_noop(monkeypatch):
    for var in ("CPUGPU_COORDINATOR", "CPUGPU_NUM_PROCESSES",
                "CPUGPU_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.maybe_initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_num_processes_one_is_noop(monkeypatch):
    monkeypatch.setenv("CPUGPU_COORDINATOR", "localhost:9999")
    monkeypatch.setenv("CPUGPU_NUM_PROCESSES", "1")
    monkeypatch.delenv("CPUGPU_DISTRIBUTED", raising=False)
    # must not dial the (absent) coordinator for a one-process run
    assert tdist.maybe_initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_primary_and_mesh():
    assert tdist.is_primary() is True
    mesh = tdist.global_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    assert tshard.make_mesh(1, device="cpu") == mesh
    with pytest.raises(ValueError):
        tshard.make_mesh(2, device="cpu")


def test_gather_image_single_process():
    ref = torch.arange(64 * 32 * 4, dtype=torch.float32).reshape(-1, 4)
    np.testing.assert_array_equal(tdist.gather_image_to_host(ref),
                                  ref.numpy())
    # pixels mode: lanes in pixel-block order come back row-major
    np.testing.assert_array_equal(
        tshard.gather_frame(ref, 64, 32, "pixels"),
        tcam.unblock_image(ref, 64, 32, 32, 32).numpy())
    # a resolution without a block shape was traced row-major
    np.testing.assert_array_equal(
        tshard.gather_frame(ref[:64 * 30], 64, 30, "pixels"),
        ref[:64 * 30].numpy())
    # samples mode: the rank holds the whole row-major frame
    np.testing.assert_array_equal(
        tshard.gather_frame(ref, 64, 32, "samples"), ref.numpy())
    with pytest.raises(ValueError, match="shard_mode"):
        tshard.gather_frame(ref, 64, 32, "rows")


# ---- the per-rank function, every rank in one process -----------------------


def rank_frames(ds, width, height, spp, frames, world):
    """render_rank for every rank of world, frames frames of spp samples:
    (accumulator, pixels) put together row-major, traced per frame."""
    cam = tcam.to_arrays(CameraConfig(), "cpu")
    m = width * height // world
    accs = [torch.zeros((m, 4)) for _ in range(world)]
    pixs = [None] * world
    traced = []
    for f in range(frames):
        tr = 0
        for r in range(world):
            accs[r], pixs[r], t, _ = tshard.render_rank(
                ds, cam, accs[r], f * spp, RenderSettings(), width, height,
                spp, SEED, r, world)
            tr += int(t)
        traced.append(tr)
    return (tshard.gather_frame(torch.cat(accs), width, height, "pixels"),
            tshard.gather_frame(torch.cat(pixs), width, height, "pixels"),
            traced)


@pytest.mark.parametrize("width,height", [(64, 32), (64, 30)])
@pytest.mark.parametrize("world", [2, 4])
def test_rank_slices_put_together(tiny, tiny_host, width, height, world):
    cam = tcam.to_arrays(CameraConfig(), "cpu")
    n = width * height
    settings = RenderSettings()
    acc1, pix1, tr1 = one_device(tiny, width, height, 1)
    acc, pix, tr = rank_frames(tiny, width, height, 1, 1, world)
    np.testing.assert_array_equal(acc, acc1.numpy())
    np.testing.assert_array_equal(pix, pix1.numpy())
    assert tr == tr1

    # 2 frames of 2 spp: the Renderer's 1-spp sub-steps on every rank
    r = Renderer(tiny_host, camera=CameraConfig(),
                 config=RenderConfig(width=width, height=height,
                                     samples_per_frame=2, seed=SEED),
                 settings=settings, device="cpu")
    assert r._spp_substeps(2)
    traced = []
    for _ in range(2):
        r.render_frame()
        traced.append(r.stats.traced_rays)
    acc, pix, tr = rank_frames(tiny, width, height, 2, 2, world)
    np.testing.assert_array_equal(acc, r._accumulator.numpy())
    np.testing.assert_array_equal(pix, r._pixels.numpy())
    assert tr == traced

    accd, pixd, trd = one_device(tiny, width, height, world)
    parts = [tshard.trace_rank(tiny, cam, settings, width, height, 1, SEED,
                               0, r, world, "samples") for r in range(world)]
    acc, pix, _ = accumulate(torch.zeros((n, 4)),
                             tshard.ordered_sum([e for e, _ in parts]),
                             world, settings)
    assert torch.equal(acc, accd) and torch.equal(pix, pixd)
    assert sum(int(t) for _, t in parts) == trd[0]


def test_refusals(tiny):
    cam = tcam.to_arrays(CameraConfig(), "cpu")
    mesh = tshard.make_mesh(device="cpu")
    acc = torch.zeros((64 * 32, 4))
    with pytest.raises(ValueError, match="COMPARISON"):
        tshard.render_frame_sharded(
            tiny, cam, acc, 0,
            RenderSettings(render_mode=RenderMode.COMPARISON), 64, 32, 1,
            SEED, mesh)
    with pytest.raises(ValueError, match="divisible"):
        tshard.trace_rank(tiny, cam, RenderSettings(), 64, 32, 1, SEED, 0,
                          0, 3)
    with pytest.raises(ValueError, match="shard_mode"):
        tshard.render_frame_sharded(tiny, cam, acc, 0, RenderSettings(), 64,
                                    32, 1, SEED, mesh, "rows")
    with pytest.raises(RuntimeError, match="process group"):
        tshard.render_frame_sharded(
            tiny, cam, acc[:1024], 0, RenderSettings(), 64, 32, 1, SEED,
            tdist.RankMesh(2, 0, torch.device("cpu")))


def test_one_rank_without_group_equals_renderer(tiny):
    """render_frame_sharded at one rank and no process group: both modes
    are the one-device frame."""
    cam = tcam.to_arrays(CameraConfig(), "cpu")
    mesh = tshard.make_mesh(device="cpu")
    acc1, pix1, tr1 = one_device(tiny, 64, 32, 1, frames=2)
    for mode in tshard.SHARD_MODES:
        acc = torch.zeros((64 * 32, 4))
        for f in range(2):
            acc, pix, tr, _ = tshard.render_frame_sharded(
                tiny, cam, acc, f, RenderSettings(), 64, 32, 1, SEED, mesh,
                mode)
            assert int(tr) == tr1[f]
        np.testing.assert_array_equal(
            tshard.gather_frame(acc, 64, 32, mode), acc1.numpy())
        np.testing.assert_array_equal(
            tshard.gather_frame(pix, 64, 32, mode), pix1.numpy())


# ---- a 2-rank gloo run in two processes -------------------------------------

RANK_BODY = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    os.environ.update(CPUGPU_COORDINATOR="file://" + tmp + "/rendezvous",
                      CPUGPU_NUM_PROCESSES="2", CPUGPU_PROCESS_ID=str(rank))
    from cpugpupathtracing_tpu_torch import cli
    from cpugpupathtracing_tpu_torch.config import CameraConfig, RenderSettings
    from cpugpupathtracing_tpu_torch.models import camera as tcam
    from cpugpupathtracing_tpu_torch.models import materials as tmat
    from cpugpupathtracing_tpu_torch.models import mesh as tmesh
    from cpugpupathtracing_tpu_torch.models import scene as tscene
    from cpugpupathtracing_tpu_torch.parallel import distributed, sharding
    cli.main(["--device", "cpu", "--scene", "whitted", "--mode", "whitted",
              "--camera-pos", "0", "0.5", "8", "--width", "64", "--height",
              "32", "--frames", "2", "--max-depth", "4", "--stats-json",
              "--out", tmp + "/cli.png"])
    assert distributed.maybe_initialize_distributed(device="cpu")
    s = tscene.Scene()
    grey = s.add_material(tmat.Material.diffuse((0.5, 0.5, 0.5)))
    light = s.add_material(tmat.Material.light((1.0, 1.0, 1.0), 10.0))
    s.add_mesh("cube", tmesh.cube(half=1.5), grey)
    s.add_plane("floor", (0.0, -3.0, 0.0), (0.0, 1.0, 0.0), grey)
    s.mark_light(s.add_sphere("light", (8.0, 9.0, 7.0), 4.0, light))
    mesh = sharding.make_mesh(2, device="cpu")
    ds = s.device(mesh.device)
    cam = tcam.to_arrays(CameraConfig(), mesh.device)
    out = {}
    for mode in sharding.SHARD_MODES:
        acc = torch.zeros(sharding.accumulator_shape(64, 32, 2, mode))
        per = 2 if mode == "samples" else 1
        for f in range(%(frames)d):
            acc, pix, tr, _ = sharding.render_frame_sharded(
                ds, cam, acc, f * per, RenderSettings(), 64, 32, 1,
                %(seed)d, mesh, mode)
            out[f"traced_{mode}_{f}"] = int(tr)
        for name, x in (("acc", acc), ("pix", pix)):
            out[f"{name}_{mode}"] = sharding.gather_frame(x, 64, 32, mode)
    out["jax_imported"] = any(m == "jax" or m.startswith(("jax.",
                              "cpugpupathtracing_tpu."))
                              for m in sys.modules)
    if distributed.is_primary():
        np.savez(tmp + "/ranks.npz", **out)
    dist.destroy_process_group()
""") % {"frames": FRAMES, "seed": SEED}


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Run RANK_BODY as ranks 0 and 1; kill both and fail when a rank is
    not done within JOIN_S seconds."""
    tmp = str(tmp_path_factory.mktemp("gloo"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_BODY, str(r), tmp], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a gloo rank did not finish within {JOIN_S} s")
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    data = dict(np.load(os.path.join(tmp, "ranks.npz")))
    return data, outs[0][0], os.path.join(tmp, "cli.png")


def test_gloo_two_ranks_bitwise(tiny, gloo_run):
    data, _, _ = gloo_run
    assert not bool(data["jax_imported"])
    acc1, pix1, tr1 = one_device(tiny, 64, 32, 1, frames=FRAMES)
    np.testing.assert_array_equal(data["acc_pixels"], acc1.numpy())
    np.testing.assert_array_equal(data["pix_pixels"], pix1.numpy())
    acc2, pix2, tr2 = one_device(tiny, 64, 32, 2, frames=FRAMES)
    np.testing.assert_array_equal(data["acc_samples"], acc2.numpy())
    np.testing.assert_array_equal(data["pix_samples"], pix2.numpy())
    for f in range(FRAMES):
        assert int(data[f"traced_pixels_{f}"]) == tr1[f]
        assert int(data[f"traced_samples_{f}"]) == tr2[f]


def test_gloo_cli_equals_one_process(gloo_run, tmp_path, capsys):
    """The CLI under a 2-rank group (pixels mode) writes the image of the
    one-process CLI, and rank 0 prints its stats lines: the same traced
    and accumulated counts, and the same mean energy but for the order of
    the f32 energy sum's adds."""
    from cpugpupathtracing_tpu_torch import cli

    _, stdout, png = gloo_run
    out = str(tmp_path / "one.png")
    cli.main(["--device", "cpu", "--scene", "whitted", "--mode", "whitted",
              "--camera-pos", "0", "0.5", "8", "--width", "64", "--height",
              "32", "--frames", "2", "--max-depth", "4", "--stats-json",
              "--out", out])
    one = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    two = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    assert len(two) == len(one) == 2
    for a, b in zip(one, two):
        a, b = json.loads(a), json.loads(b)
        assert a.keys() == b.keys()
        assert (a["traced_rays"], a["accumulated"]) == \
            (b["traced_rays"], b["accumulated"])
        assert b["mean_energy"] == pytest.approx(a["mean_energy"], rel=1e-4,
                                                 abs=1e-4)
    np.testing.assert_array_equal(timage.read_png(png), timage.read_png(out))


# ---- against the JAX package's render_frame_sharded -------------------------


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded frames on make_mesh(2): FRAMES frames per
    mode of tests/test_sharding.py's scene, camera and seed."""
    import jax.numpy as jnp

    from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
    from cpugpupathtracing_tpu.config import RenderSettings as JSettings
    from cpugpupathtracing_tpu.models import camera as jcam
    from cpugpupathtracing_tpu.models import materials as jmat
    from cpugpupathtracing_tpu.models import mesh as jmesh
    from cpugpupathtracing_tpu.models import scene as jscene
    from cpugpupathtracing_tpu.parallel import sharding as jshard

    dev = tiny_scene(jscene, jmat, jmesh).device()
    cam = jcam.to_arrays(JCameraConfig())
    mesh = jshard.make_mesh(2)
    out = {}
    for mode, per in (("pixels", 1), ("samples", 2)):
        acc = jnp.zeros((64 * 32, 4), jnp.float32)
        for f in range(FRAMES):
            acc, pix, _ = jshard.render_frame_sharded(
                dev, cam, acc, jnp.int32(f * per),
                jnp.arange(64 * 32, dtype=jnp.uint32), JSettings(), 64, 32,
                1, SEED, mesh, mode)
        out[mode] = np.asarray(pix).astype(np.uint32)
    return out


@pytest.mark.parametrize("mode", ["pixels", "samples"])
def test_two_rank_image_vs_jax(gloo_run, jax_sharded, mode):
    got = gloo_run[0][f"pix_{mode}"].astype(np.uint32)
    ref = jax_sharded[mode]
    delta = np.abs(got.view(np.uint8).astype(np.int64)
                   - ref.view(np.uint8).astype(np.int64))
    assert (delta == 0).mean() >= EQUAL_SHARE_MIN, (delta == 0).mean()
    assert delta.mean() <= MEAN_MAX, delta.mean()
    assert delta.max() <= MAX_MAX, delta.max()
