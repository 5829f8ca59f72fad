"""The port's bench (bench_torch.py) and parity gates
(cpugpupathtracing_tpu_torch/parity_gate.py), on the CPU.

  * run_sharded at one rank (tests/test_bench_devices.py on the port): 3
    frames after the first against the port's Renderer over 4 frames,
    pixels and traced bitwise; the same with the instanced scene and its
    moving-instance hook; the samples mode (at one rank the Renderer's
    frames too).
  * run_sharded at one rank against bench.py's loop on the JAX package's
    sharding module (plain, hooked, samples): traced exactly, pixels within
    the golden tolerance.
  * One 2-rank gloo run of `bench_torch.py --device cpu --devices 2
    --config 1 64 32 2` in two processes (a file:// rendezvous): rank 0
    prints one line with bench.py's --devices keys; the ranks import no
    JAX.
  * `bench_torch.py --device cpu --config 1 64 32 2` in one process: one
    line with bench.py's single-device keys (a literal list from
    bench.py:304-325), pct_of_kernel_floor and the four gate fields null;
    bench_torch and parity_gate import no JAX.  Without a card the default
    device raises, with and without --devices.
  * Each gate on the CPU (the wrappers' plain versions; check_parity on
    the small dragon of __graft_entry__._flagship, both B4 gates at 256
    rays) returns ok, and raises when its route is perturbed: one hit id
    flipped in traverse_packet_slim (both B4 gates), one traced ray added
    to the Whitted kernel's and to pt_frame's count.
  * check_parity's ray set is the JAX gate's (the JAX camera op by op).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bench_torch
from cpugpupathtracing_tpu_torch import parity_gate as pg
from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    RenderConfig,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models.renderer import Renderer
from cpugpupathtracing_tpu_torch.models.scene import (
    Scene,
    make_reference_scene,
)
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from cpugpupathtracing_tpu_torch.ops import whitted_kernel as wk

from tests.test_torch_renderer import EQUAL_SHARE_MIN, MAX_MAX, MEAN_MAX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 32
FRAMES = 3
JOIN_S = 60

# bench.py:304-325 and :171-185
SINGLE_KEYS = ["metric", "value", "unit", "vs_baseline", "extra"]
SINGLE_EXTRA = ["config", "pct_of_kernel_floor", "frame_ms",
                "rays_per_frame", "resolution", "frames_timed",
                "scene_build_s", "first_frame_s", "compiled_parity_ok",
                "compiled_parity_instanced_ok", "compiled_parity_whitted_ok",
                "compiled_parity_ptframe_ok", "device", "bench_flags"]
DEVICES_EXTRA = ["config", "devices", "shard_mode", "frames_timed",
                 "frame_ms", "bench_flags"]
GATE_FIELDS = ["compiled_parity_ok", "compiled_parity_instanced_ok",
               "compiled_parity_whitted_ok", "compiled_parity_ptframe_ok"]


def _scene(S=Scene, mat=tmat, mesh=tmesh):
    """tests/test_bench_devices.py's scene, built with either package."""
    s = S()
    grey = s.add_material(mat.Material.diffuse((0.5, 0.5, 0.5)))
    light = s.add_material(mat.Material.light((1.0, 1.0, 1.0), 10.0))
    s.add_mesh("cube", mesh.cube(half=1.5), grey)
    s.add_plane("floor", (0.0, -3.0, 0.0), (0.0, 1.0, 0.0), grey)
    li = s.add_sphere("light", (8.0, 9.0, 7.0), 4.0, light)
    s.mark_light(li)
    return s


def _scene_instanced(S=Scene, mat=tmat, mesh=tmesh):
    """The instanced scene of tests/test_bench_devices.py, either package."""
    s = S()
    grey = s.add_material(mat.Material.diffuse((0.5, 0.5, 0.5)))
    light = s.add_material(mat.Material.light((1.0, 1.0, 1.0), 10.0))
    tf = np.zeros((2, 4, 4), np.float32)
    for i in range(2):
        tf[i] = np.eye(4)
        tf[i, 0, 3] = -1.5 + 3.0 * i
    obj = s.add_instanced_mesh("cubes", mesh.cube(half=0.8), grey, tf)
    s.add_plane("floor", (0.0, -3.0, 0.0), (0.0, 1.0, 0.0), grey)
    li = s.add_sphere("light", (8.0, 9.0, 7.0), 4.0, light)
    s.mark_light(li)
    return s, obj


def _hook_for(scene, obj):
    def hook(frame, renderer):
        # config 5's shape: move both instances, then reset
        for i in range(2):
            m = np.eye(4, dtype=np.float32)
            m[0, 3] = -1.5 + 3.0 * i + 0.2 * frame
            scene.set_instance_transform(obj, i, m)
        renderer.reset()

    return hook


def _renderer_frames(scene, hook=None):
    """The Renderer over FRAMES + 1 frames (run_sharded's count), the hook
    before each as run_sharded calls it: (pixels u32 row-major, traced)."""
    r = Renderer(scene, camera=CameraConfig(aspect=W / H),
                 config=RenderConfig(width=W, height=H), device="cpu")
    traced = 0
    for f in range(FRAMES + 1):
        if hook is not None:
            hook(f, r)
        r.render_frame()
        traced += r.stats.traced_rays
    return r.image_u32().reshape(-1), traced


def _run_sharded(scene, hook=None, shard_mode="pixels", pos=None):
    cam = CameraConfig(aspect=W / H)
    if pos is not None:
        cam = cam.replace(pos=pos)
    pixels, traced, wall = bench_torch.run_sharded(
        scene, cam, RenderSettings(), W, H, FRAMES, 1,
        RenderConfig().seed, devices=1, shard_mode=shard_mode, hook=hook,
        device="cpu")
    assert pixels.dtype == np.uint32 and pixels.shape == (W * H,)
    assert wall > 0
    return pixels, traced


def test_run_sharded_matches_renderer():
    single, single_traced = _renderer_frames(_scene())
    pixels, traced = _run_sharded(_scene())
    np.testing.assert_array_equal(pixels, single)
    assert traced == single_traced


def test_run_sharded_hooked_matches_renderer():
    s1, o1 = _scene_instanced()
    single, single_traced = _renderer_frames(s1, _hook_for(s1, o1))
    s2, o2 = _scene_instanced()
    pixels, traced = _run_sharded(s2, _hook_for(s2, o2))
    np.testing.assert_array_equal(pixels, single)
    assert traced == single_traced


def test_run_sharded_samples_mode():
    """One rank in samples mode traces the whole frame once a frame: the
    Renderer's frames again, every pixel lit by something."""
    single, single_traced = _renderer_frames(_scene())
    pixels, traced = _run_sharded(_scene(), shard_mode="samples")
    assert traced >= (FRAMES + 1) * W * H
    assert (pixels != 0).any()
    np.testing.assert_array_equal(pixels, single)
    assert traced == single_traced


# the default camera moved 0.05 along x: from x = 0 the scene's plane of
# symmetry runs through the cube's edges, where exact ties and the slab
# margin part the port from the JAX walk (ROADMAP C, conditions 5 and 12;
# there 5 of 13,389 traced rays differ over the 4 frames)
JAX_CAMERA_POS = (0.05, 0.0, 8.0)


def _jax_run_sharded(case):
    """bench.py's run_sharded loop (bench.py:68-123) on the JAX package's
    sharding module, on a one-device mesh: FRAMES + 1 frames, the hook
    and a new snapshot before each but the first.  bench.py itself is not
    imported (it sets a compilation cache of its own)."""
    import jax.numpy as jnp

    from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
    from cpugpupathtracing_tpu.config import RenderConfig as JRenderConfig
    from cpugpupathtracing_tpu.config import RenderSettings as JSettings
    from cpugpupathtracing_tpu.models import camera as jcam
    from cpugpupathtracing_tpu.models import materials as jmat
    from cpugpupathtracing_tpu.models import mesh as jmesh
    from cpugpupathtracing_tpu.models import scene as jscene
    from cpugpupathtracing_tpu.parallel import sharding as jshard

    hook = None
    if case == "hooked":
        scene, obj = _scene_instanced(jscene.Scene, jmat, jmesh)
        hook = _hook_for(scene, obj)
    else:
        scene = _scene(jscene.Scene, jmat, jmesh)
    mode = "samples" if case == "samples" else "pixels"
    mesh = jshard.make_mesh(1)
    shim = bench_torch._ShardedHookShim()
    if hook is not None:
        hook(0, shim)
    dev = scene.device()
    cam = jcam.to_arrays(JCameraConfig(aspect=W / H, pos=JAX_CAMERA_POS))
    acc = jnp.zeros((W * H, 4), jnp.float32)
    lane = jnp.arange(W * H, dtype=jnp.uint32)
    traced = 0
    for f in range(FRAMES + 1):
        if hook is not None and f:
            shim.want_reset = False
            hook(f, shim)
            dev = scene.device()
            if shim.want_reset:
                acc = jnp.zeros_like(acc)
        acc, pix, tr = jshard.render_frame_sharded(
            dev, cam, acc, jnp.int32(f), lane, JSettings(), W, H, 1,
            JRenderConfig().seed, mesh, mode)
        traced += int(tr)
    return np.asarray(pix).astype(np.uint32).reshape(-1), traced


@pytest.mark.parametrize("case", ["plain", "hooked", "samples"])
def test_run_sharded_vs_jax(case):
    """The port's run_sharded at one rank against the JAX bench's loop on
    the same scene, camera, seed and frames: traced exactly, pixels within the
    golden tolerance of tests/test_torch_renderer.py (jitted JAX rounds a
    few f32 operations otherwise).  Catches a wrong frame count, stream
    offset or traced sum in the bench's loop."""
    ref, ref_traced = _jax_run_sharded(case)
    if case == "hooked":
        s, o = _scene_instanced()
        got, traced = _run_sharded(s, _hook_for(s, o), pos=JAX_CAMERA_POS)
    else:
        got, traced = _run_sharded(
            _scene(), shard_mode="samples" if case == "samples" else "pixels",
            pos=JAX_CAMERA_POS)
    assert traced == ref_traced
    delta = np.abs(got.view(np.uint8).astype(np.int64)
                   - ref.view(np.uint8).astype(np.int64))
    assert (delta == 0).mean() >= EQUAL_SHARE_MIN, (delta == 0).mean()
    assert delta.mean() <= MEAN_MAX, delta.mean()
    assert delta.max() <= MAX_MAX, delta.max()


# ---- bench_torch.py in new processes ----------------------------------------

JAX_CHECK = textwrap.dedent("""
    jax = sorted(m for m in sys.modules if m == "jax"
                 or m.startswith(("jax.", "cpugpupathtracing_tpu.")))
    print("JAX_MODULES=" + json.dumps(jax), file=sys.stderr)
""")

SINGLE_BODY = textwrap.dedent("""
    import json, runpy, sys
    import torch
    torch.set_num_threads(1)
    from cpugpupathtracing_tpu_torch import parity_gate
    sys.argv = ["bench_torch.py", "--device", "cpu", "--config", "1", "64",
                "32", "2"]
    runpy.run_path("bench_torch.py", run_name="__main__")
""") + JAX_CHECK

RANK_BODY = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    os.environ.update(CPUGPU_COORDINATOR="file://" + tmp + "/rendezvous",
                      CPUGPU_NUM_PROCESSES="2", CPUGPU_PROCESS_ID=str(rank))
    import bench_torch
    bench_torch.main(["--device", "cpu", "--devices", "2", "--config", "1",
                      "64", "32", "2"])
""") + JAX_CHECK


def _run(procs):
    """Wait for every process (JOIN_S seconds each); kill them all and fail
    when one is late or exits non-zero.  Returns [(stdout, stderr)]."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a bench process did not finish within {JOIN_S} s")
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r}:\n{err[-3000:]}"
    return outs


def _popen(args):
    return subprocess.Popen([sys.executable, "-c", *args], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _jax_modules(err: str) -> list:
    line = [ln for ln in err.splitlines() if ln.startswith("JAX_MODULES=")]
    assert len(line) == 1, err[-2000:]
    return json.loads(line[0].split("=", 1)[1])


def test_bench_gloo_two_ranks(tmp_path):
    procs = [_popen([RANK_BODY, str(r), str(tmp_path)]) for r in range(2)]
    outs = _run(procs)
    for _, err in outs:
        assert _jax_modules(err) == []
    lines = outs[0][0].splitlines()
    assert len(lines) == 1 and outs[1][0] == ""
    rec = json.loads(lines[0])
    assert sorted(rec) == sorted(SINGLE_KEYS)
    assert sorted(rec["extra"]) == sorted(DEVICES_EXTRA)
    assert rec["value"] > 0 and rec["unit"] == "Mrays/s"
    assert rec["extra"]["devices"] == 2
    assert rec["extra"]["shard_mode"] == "pixels"
    assert rec["extra"]["frames_timed"] == 2
    assert rec["extra"]["bench_flags"]["CPUGPU_PACKET_TREE"] == "sweep_dp"
    assert "2 devices" in rec["metric"]


def test_bench_single_process_line():
    out, err = _run([_popen([SINGLE_BODY])])[0]
    assert _jax_modules(err) == []
    lines = out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert sorted(rec) == sorted(SINGLE_KEYS)
    assert sorted(rec["extra"]) == sorted(SINGLE_EXTRA)
    extra = rec["extra"]
    assert rec["value"] > 0
    assert abs(rec["vs_baseline"] - rec["value"] / 100.0) <= 1e-4
    assert extra["pct_of_kernel_floor"] is None
    assert all(extra[k] is None for k in GATE_FIELDS)
    assert extra["config"] == 1 and extra["resolution"] == "64x32"
    assert extra["frames_timed"] == 2 and extra["device"] == "cpu"
    assert extra["rays_per_frame"] >= 64 * 32
    assert extra["bench_flags"]["CPUGPU_SMEMTREE"] == "48"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("extra", [[], ["--devices", "1"]])
def test_bench_default_device_needs_a_card(extra, monkeypatch):
    """No fallback: the default device is the card, and without one the
    bench raises before it times anything."""
    monkeypatch.setattr(bench_torch, "apply_bench_flags", dict)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main(["--config", "1", *extra, "8", "4", "1"])


# ---- the parity gates -------------------------------------------------------


@pytest.fixture(scope="module")
def small_dragon():
    """config 3's scene with __graft_entry__._flagship's small dragon."""
    return make_reference_scene(
        dragon_mesh=tmesh.icosphere(radius=2.0, subdivisions=3))


def _gate(name, small_dragon):
    if name == "parity":
        return pg.check_parity(n_rays=256, scene=small_dragon, device="cpu")
    if name == "instanced":
        return pg.check_parity_instanced(n_rays=256, device="cpu")
    if name == "whitted":
        return pg.check_parity_whitted(device="cpu")
    return pg.check_parity_ptframe(device="cpu")


GATES = ["parity", "instanced", "whitted", "ptframe"]


@pytest.mark.parametrize("name", GATES)
def test_gate_passes_on_cpu(name, small_dragon):
    res = _gate(name, small_dragon)
    assert res["ok"] is True and res["backend"] == "cpu"
    assert res["checked"] == (256 if name in ("parity", "instanced")
                              else 64 * 32)
    if name == "parity":
        assert res["occl_any_hit_checked"] and res["max_t_rel"] < 1e-5
    if name == "instanced":
        assert res["flattened"] and res["hits"] > 256 // 10
    if name in ("whitted", "ptframe"):
        assert res["flip_lanes"] == 0


def _flip_one_hit(real):
    """traverse_packet_slim with one closest hit's triangle id swapped for
    another hit's."""
    def wrapped(*args, **kw):
        out = real(*args, **kw)
        if kw.get("any_hit"):
            return out
        hit = out[1].clone()
        lanes = (hit >= 0).nonzero().squeeze(1)
        k = lanes[0]
        other = lanes[hit[lanes] != hit[k]][0]
        hit[k] = hit[other]
        return (out[0], hit) + tuple(out[2:])

    return wrapped


def _one_more_ray(real):
    """A kernel wrapper whose traced total counts one ray too many."""
    def wrapped(*args, **kw):
        out = real(*args, **kw)
        return tuple(out[:-1]) + (out[-1] + 1,)

    return wrapped


@pytest.mark.parametrize("name,match", [
    ("parity", "hit ids differ"),
    ("instanced", "instanced hits differ"),
    ("whitted", "traced mismatch"),
    ("ptframe", "traced mismatch"),
])
def test_gate_raises_on_perturbed_route(name, match, small_dragon,
                                        monkeypatch):
    if name in ("parity", "instanced"):
        monkeypatch.setattr(tps, "traverse_packet_slim",
                            _flip_one_hit(tps.traverse_packet_slim))
    elif name == "whitted":
        monkeypatch.setattr(wk, "whitted_frame_rows",
                            _one_more_ray(wk.whitted_frame_rows))
    else:
        monkeypatch.setattr(ptf, "pt_frame", _one_more_ray(ptf.pt_frame))
    with pytest.raises(AssertionError, match=match):
        _gate(name, small_dragon)


def test_gate_rays_are_the_jax_gates():
    """check_parity's rays: the JAX gate's construction (tools/
    tpu_parity_gate.py:54-66), its camera run op by op."""
    import jax
    import jax.numpy as jnp

    from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
    from cpugpupathtracing_tpu.models import camera as jcam

    n, seed = 256, 5
    rng = np.random.default_rng(seed)
    with jax.disable_jit():
        cam = jcam.to_arrays(JCameraConfig())
        lane = jnp.asarray(
            rng.choice(1920 * 1080, n // 2, replace=False).astype(np.uint32))
        o1, d1 = jcam.lane_rays(cam, lane, 1920, 1080)
        o2 = jnp.asarray(rng.normal(size=(n - n // 2, 3)).astype(np.float32)
                         * 6)
        aim = jnp.asarray(rng.normal(size=(n - n // 2, 3)).astype(np.float32)
                          * 2)
        d2 = aim - o2
        d2 = d2 / jnp.linalg.norm(d2, axis=1, keepdims=True)
        o_ref = np.asarray(jnp.concatenate([o1, o2]))
        d_ref = np.asarray(jnp.concatenate([d1, d2]))
    o, d = pg.gate_rays(n, seed, "cpu")
    np.testing.assert_array_equal(o.numpy(), o_ref)
    # the norm's sum of squares may round differently (ULPs)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-6, atol=1e-7)
