"""The port's front ends: Renderer.metrics / profile / validate_frame /
save_checkpoint / load_checkpoint (cpugpupathtracing_tpu_torch/models/
renderer.py), camera.pixel_rays, the package's exports and cli.py, on
the CPU.

  * metrics has the JAX package's keys; after 2 frames of the golden scene
    at 8x4 its traced_rays, accumulated_frames, paused and objects equal a
    JAX Renderer's, and mean_energy is within 1% relative (measured 0.15%:
    jitted JAX contracts multiply-adds and has its own transcendentals,
    which flip a shadow ray here and there, ROADMAP.md condition 3; one
    flip moves a 32-pixel frame's mean by that much).
  * The checkpoint (tests/test_renderer.py:176-237 on the port): a resumed
    renderer's next frame equals an uninterrupted run's bitwise; a settings
    toggle survives a reload; a render-mode change, or another scene,
    invalidates it and resets.
  * validate_frame passes a clean frame, and on a scene with a NaN albedo
    raises FloatingPointError naming a lane, with the accumulator, the
    counters, the energy total and the stats as they were.
  * profile writes a Chrome trace.
  * pixel_rays, with and without jitter, bitwise against the JAX
    package's run op by op (jax.disable_jit()).
  * The CLI: WHITTED on config 1's scene at 96x54 within the golden
    tolerance (tests/test_torch_renderer.py) of tests/goldens/frames.npz's
    `whitted` frame; --stats-json lines with the JAX package's keys;
    --checkpoint resumes; --serve 0 --frames 2 returns; the default device
    raises without a card.
"""

import glob
import json
import math
import os

import numpy as np
import pytest
import torch

import cpugpupathtracing_tpu_torch as tpkg
from cpugpupathtracing_tpu_torch import cli
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
from cpugpupathtracing_tpu_torch.models.renderer import Renderer
from cpugpupathtracing_tpu_torch.models.whitted import make_whitted_scene
from cpugpupathtracing_tpu_torch.utils import image as timage

from tests.test_torch_renderer import (
    EQUAL_SHARE_MIN,
    GOLDENS,
    MAX_MAX,
    MEAN_MAX,
)
from tests.test_torch_scene import golden_scene

W, H = 16, 8
CAMERA = CameraConfig(pos=(0.05, 0.5, 7.0), aspect=2.0)
SETTINGS = RenderSettings(max_ray_depth=2)
METRIC_KEYS = {"fps", "frame_time_ms", "traced_rays", "total_traced_rays",
               "mrays_per_s", "accumulated_frames", "mean_energy", "paused",
               "objects"}


def renderer(scene=None) -> Renderer:
    return Renderer(scene or golden_scene(tscene, tmat, tmesh),
                    camera=CAMERA, config=RenderConfig(width=W, height=H),
                    settings=SETTINGS, device="cpu")


def state(r: Renderer) -> tuple:
    return (r._accumulator.clone(), r._pixels.clone(), r.num_accumulated,
            r._sample_counter, r.total_energy_received,
            r.stats.traced_rays, r.stats.total_traced_rays)


def same_state(a: tuple, b: tuple) -> bool:
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and a[2:] == b[2:])


# ---- metrics, profile, validate_frame ---------------------------------------


def test_metrics_against_jax():
    from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
    from cpugpupathtracing_tpu.config import RenderConfig as JRenderConfig
    from cpugpupathtracing_tpu.models import materials as jmat
    from cpugpupathtracing_tpu.models import mesh as jmesh
    from cpugpupathtracing_tpu.models import scene as jscene
    from cpugpupathtracing_tpu.models.renderer import Renderer as JRenderer

    j = JRenderer(golden_scene(jscene, jmat, jmesh),
                  camera=JCameraConfig(pos=(0.0, 0.5, 7.0)),
                  config=JRenderConfig(width=8, height=4))
    t = Renderer(golden_scene(tscene, tmat, tmesh),
                 camera=CameraConfig(pos=(0.0, 0.5, 7.0)),
                 config=RenderConfig(width=8, height=4), device="cpu")
    for r in (j, t):
        r.render(2)
    mj, mt = j.metrics(), t.metrics()
    assert set(mt) == set(mj) == METRIC_KEYS
    for key in ("traced_rays", "total_traced_rays", "accumulated_frames",
                "paused", "objects"):
        assert mt[key] == mj[key], key
    assert mt["mean_energy"] == pytest.approx(mj["mean_energy"], rel=1e-2)
    assert mt["mrays_per_s"] > 0 and mt["fps"] > 0
    json.dumps(mt)  # what /stats.json serves


def test_profile_writes_trace(tmp_path):
    r = renderer()
    with r.profile(str(tmp_path)):
        r.render_frame()
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]
    assert r.num_accumulated == 1


def test_validate_frame_clean_and_nan():
    r = renderer()
    r.validate_frame()
    assert r.num_accumulated == 1 and r.stats.traced_rays > W * H
    clean = renderer()
    clean.render_frame()
    assert torch.equal(r._accumulator, clean._accumulator)
    # a NaN albedo on the cube (object 1, material 1), set on the scene
    # behind the renderer's back so that nothing resets
    r.scene.set_material(1, tmat.Material.diffuse((math.nan, 0.2, 0.8)))
    before = state(r)
    with pytest.raises(FloatingPointError, match=r"lane \d+"):
        r.validate_frame()
    assert same_state(state(r), before)
    assert bool(torch.isfinite(r._accumulator).all())


# ---- the checkpoint ---------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    a = renderer()
    a.render(3)
    img = a.image_u32().copy()
    p = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(p)
    with np.load(p, allow_pickle=False) as data:
        assert set(data.files) == {"accumulator", "num_accumulated",
                                   "sample_counter", "total_energy",
                                   "fingerprint"}
    b = renderer()
    assert b.load_checkpoint(p)
    assert b.num_accumulated == 3 and b._sample_counter == 3
    assert b.total_energy_received == a.total_energy_received
    a.render_frame()
    b.render_frame()
    assert torch.equal(a._accumulator, b._accumulator)
    np.testing.assert_array_equal(a.image_u32(), b.image_u32())
    assert not np.array_equal(img, b.image_u32())


def test_checkpoint_settings_toggle_survives_reload(tmp_path):
    a = renderer()
    a.render(2)
    p = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(p)
    b = renderer()
    b.set_settings(b.settings.replace(
        max_ray_depth=b.settings.max_ray_depth + 1,
        next_event_estimation=not b.settings.next_event_estimation))
    assert b.load_checkpoint(p)
    assert b.num_accumulated == 2


def test_checkpoint_render_mode_change_invalidates(tmp_path):
    a = renderer()
    a.render(1)
    p = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(p)
    b = renderer()
    b.set_render_mode(RenderMode.BRUTE_FORCE)
    assert not b.load_checkpoint(p)


def test_checkpoint_fingerprint_mismatch_resets(tmp_path):
    a = renderer()
    a.render(2)
    p = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(p)
    other = renderer(make_whitted_scene())
    other.render(1)
    assert not other.load_checkpoint(p)
    assert other.num_accumulated == 0
    assert float(other._accumulator.abs().sum()) == 0.0


# ---- pixel_rays and the exports ---------------------------------------------


def test_pixel_rays_against_jax():
    import jax
    import jax.numpy as jnp

    from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
    from cpugpupathtracing_tpu.models import camera as jcam

    w, h = 12, 7
    seeds = np.random.default_rng(5).integers(1, 2**32, w * h,
                                              dtype=np.uint64)
    tc = tcam.to_arrays(CAMERA, "cpu")
    o, d = tcam.pixel_rays(tc, w, h)
    oj, dj, sj = tcam.pixel_rays(
        tc, w, h, jitter=True,
        rng_state=torch.from_numpy(seeds.astype(np.int64)))
    with jax.disable_jit():
        jc = jcam.to_arrays(JCameraConfig(pos=CAMERA.pos,
                                          aspect=CAMERA.aspect))
        ro, rd = jcam.pixel_rays(jc, w, h)
        rjo, rjd, rjs = jcam.pixel_rays(
            jc, w, h, jitter=True,
            rng_state=jnp.asarray(seeds.astype(np.uint32)))
    for got, ref in ((o, ro), (d, rd), (oj, rjo), (dj, rjd)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(sj.numpy(), np.asarray(rjs).astype(np.int64))
    assert not torch.equal(d, dj)
    with pytest.raises(ValueError):
        tcam.pixel_rays(tc, w, h, jitter=True)


def test_exports_match_jax():
    import cpugpupathtracing_tpu as jpkg

    assert tpkg.__all__ == jpkg.__all__
    assert tpkg.__version__ == jpkg.__version__
    for name in tpkg.__all__[:-1]:
        got, ref = getattr(tpkg, name), getattr(jpkg, name)
        assert got.__name__ == ref.__name__
        if hasattr(ref, "__members__"):
            assert {k: int(v) for k, v in got.__members__.items()} == \
                {k: int(v) for k, v in ref.__members__.items()}


# ---- the CLI ----------------------------------------------------------------

WHITTED = ["--scene", "whitted", "--mode", "whitted", "--camera-pos", "0",
           "0.5", "8", "--width", "96", "--height", "54", "--max-depth", "4",
           "--device", "cpu"]


def test_cli_whitted_golden_and_stats(tmp_path, capsys):
    out = str(tmp_path / "w.png")
    cli.main(WHITTED + ["--frames", "2", "--stats-json", "--out", out])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["frame"] for ln in lines] == [0, 1]
    assert all(set(ln) == {"frame", "fps", "frame_ms", "traced_rays",
                           "accumulated", "mean_energy"} for ln in lines)
    assert [ln["accumulated"] for ln in lines] == [1, 2]
    assert all(ln["traced_rays"] > 96 * 54 for ln in lines)
    got = timage.read_png(out)
    ref = timage.packed_to_rgba8(np.load(GOLDENS)["whitted"])
    assert got.shape == ref.shape == (54, 96, 4)
    delta = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert (delta == 0).mean() >= EQUAL_SHARE_MIN, (delta == 0).mean()
    assert delta.mean() <= MEAN_MAX, delta.mean()
    assert delta.max() <= MAX_MAX, delta.max()


def test_cli_checkpoint_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    args = WHITTED + ["--frames", "1", "--stats-json", "--checkpoint", ck,
                      "--out", str(tmp_path / "a.png")]
    cli.main(args)
    cli.main(args)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["accumulated"] for ln in lines] == [1, 2]
    with np.load(ck, allow_pickle=False) as data:
        assert int(data["num_accumulated"]) == 2
        acc = data["accumulator"]
    r = cli.build_renderer(cli.parse_args(WHITTED))
    r.render(2)
    np.testing.assert_array_equal(acc, r._accumulator.numpy())


def test_cli_serve_returns(tmp_path):
    out = str(tmp_path / "s.png")
    cli.main(["--scene", "whitted", "--mode", "whitted", "--width", "16",
              "--height", "8", "--frames", "2", "--serve", "0", "--device",
              "cpu", "--out", out])
    assert timage.read_png(out).shape == (8, 16, 4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_default_device_needs_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--scene", "whitted", "--mode", "whitted", "--width", "8",
                  "--height", "4", "--frames", "1",
                  "--out", str(tmp_path / "x.png")])
