"""The port's CUDA kernel on the card (marked `gpu`; without a CUDA
device each test skips).  No JAX here: the machine with the card has
none, so run these there without the JAX conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

The kernel is held against its plain PyTorch version on the same card
and inputs under the megakernel contract (traced exact, < 3% flipped
lanes, flips < 0.02, mean within 1e-4), its closest hits against brute
force bitwise, and the split-span schedule against one span bitwise."""

import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu_torch.config import CameraConfig, RenderSettings
from cpugpupathtracing_tpu_torch.models import camera as camlib
from cpugpupathtracing_tpu_torch.models import integrators
from cpugpupathtracing_tpu_torch.models import materials as matlib
from cpugpupathtracing_tpu_torch.models import mesh as meshlib
from cpugpupathtracing_tpu_torch.models.scene import Scene
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.utils import rng as rnglib

pytestmark = pytest.mark.gpu
W, H = 128, 64


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = Scene()
    white = s.add_material(matlib.Material.diffuse((0.8, 0.8, 0.8)))
    glass = s.add_material(matlib.Material.dielectric(
        (0.9, 0.9, 0.9), 0.1, 0.8, (0.1, 0.2, 0.2), 1.5))
    light = s.add_material(matlib.Material.light((1.0, 0.95, 0.8), 10.0))
    mirror = s.add_material(matlib.Material.diffuse((0.9, 0.9, 0.9),
                                                    specular=1.0))
    s.add_mesh("ball", meshlib.icosphere(subdivisions=2), glass)
    s.add_mesh("floor", meshlib.ground_quad(half_extent=50.0, y=-2.0), white)
    s.add_sphere("mirrorball", (2.5, 0.0, 1.0), 0.8, mirror)
    s.add_plane("backwall", (0.0, 0.0, -12.0), (0.0, 0.0, 1.0), white)
    for k, c in enumerate([(6.0, 6.0, 6.0), (-6.0, 6.0, -4.0),
                           (0.0, 8.0, 0.0)]):
        s.mark_light(s.add_sphere(f"light{k}", c, 1.5, light))
    dev = s.build_device("cuda")
    cam = camlib.to_arrays(CameraConfig(pos=(0.0, 0.0, 6.0), aspect=2.0),
                           "cuda")
    lane = torch.arange(W * H, device="cuda")
    o, d = camlib.lane_rays(cam, lane, W, H)
    st = rnglib.seed_lanes(lane, 0, salt=0x7777)
    return dev, o, d, st


def _rays(o, d):
    return tuple(o[:, k].contiguous() for k in range(3)) + tuple(
        d[:, k].contiguous() for k in range(3))


def _contract(ref, got):
    diff = (ref - got).abs()
    flips = (diff > 3e-6 + 3e-5 * ref.abs()).any(dim=1).float().mean()
    assert float(flips) < 0.03
    assert float(diff.max()) < 0.02
    assert abs(float(ref.mean()) - float(got.mean())) < 1e-4


@pytest.mark.parametrize("settings", [
    RenderSettings(max_ray_depth=5),
    RenderSettings(max_ray_depth=3, next_event_estimation=False),
    RenderSettings(max_ray_depth=3, cosine_weighted_diffuse=False,
                   russian_roulette=False),
], ids=["default", "no-nee", "uniform-no-rr"])
def test_kernel_matches_plain(card, settings):
    dev, o, d, st = card
    kw = integrators.frame_kwargs(dev, settings)
    rays = _rays(o, d)
    depths = settings.max_ray_depth + 1
    before = ptf.launches
    e_k, s_k, tr_k = ptf.pt_frame(*dev.tables(), rays, st, depths=depths,
                                  **kw)
    assert ptf.launches == before + 1
    e_p, s_p, tr_p = ptf.pt_frame_reference(
        dev.pltris, *dev.tables()[2:], rays, st,
        num_lights=kw["num_lights"], num_sph=kw["num_sph"],
        num_pln=kw["num_pln"], nee=kw["nee"], rr=kw["rr"],
        cosine=kw["cosine"], ref_pdf=kw["ref_pdf"], depths=depths,
        light_tri_meta=kw["light_tri_meta"])
    ptf.check_status("cuda")
    assert int(tr_k) == int(tr_p)
    assert float((s_k == s_p).float().mean()) > 0.97
    _contract(e_p, e_k)


def test_closest_hits_bitwise(card):
    dev, o, d, _ = card
    rays = _rays(o, d)
    hk = ptf.closest_hit(dev.pnodes, dev.pltris, dev.proots, rays)
    hp = ptf.closest_hit_reference(dev.pltris, rays)
    assert int((hk[1] >= 0).sum()) > W * H // 4
    for a, b in zip(hk, hp):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_split_span_bitwise(card):
    dev, o, d, st = card
    settings = RenderSettings()
    idx = torch.arange(W * H, dtype=torch.int32, device="cuda")
    s1, one = integrators.trace_advanced_frame(dev, settings, o, d, st,
                                               idx=None)
    s2, two = integrators.trace_advanced_frame(dev, settings, o, d, st,
                                               idx=idx)
    assert torch.equal(one.energy, two.energy)
    assert int(one.traced_rays) == int(two.traced_rays)
    assert torch.equal(s1, s2)


def test_wrapper_refuses_bad_inputs(card):
    dev, o, d, st = card
    kw = integrators.frame_kwargs(dev, RenderSettings())
    rays = _rays(o, d)
    with pytest.raises(ValueError):
        ptf.pt_frame(*dev.tables(), rays, st.to(torch.int32), depths=6, **kw)
    with pytest.raises(ValueError):
        ptf.pt_frame(*dev.tables(), tuple(r.cpu() for r in rays), st,
                     depths=6, **kw)
    assert np.isfinite(float(ptf.pt_frame(*dev.tables(), rays, st, depths=6,
                                          **kw)[0].sum()))
