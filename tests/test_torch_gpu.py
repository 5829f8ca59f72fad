"""The port's CUDA kernels on the card (marked `gpu`; without a CUDA
device each test skips).  No JAX here: the machine with the card has
none, so run these there without the JAX conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Each kernel (pt_frame, shade_extend, shadow_resolve) is held against its
plain PyTorch version on the same card and inputs under the megakernel
contract (traced exact, < 3% flipped lanes, flips < 0.02, mean within
1e-4), pt_frame's closest hits against brute force bitwise, the
split-span schedule against one span bitwise, and the per-depth route
against the whole-frame route bitwise.  traverse_packet_slim's closest
hits equal its plain version's bitwise and its any hits in existence;
whitted_frame equals its plain version bitwise (energy, state, traced);
the two Whitted routes agree on state and traced exactly and on energy
bitwise.  On an instanced scene on the object-space machinery the
instance arms of traverse_packet_slim, shade_extend and shadow_resolve
equal their plain versions bitwise, and a refit on the card equals a
fresh build bitwise.  traverse_packet_slim's count_depth arm (plain and
instance) equals its plain version, the PyTorch walk, bitwise on every
output, bvh_depth included.  The variant arms of every node-table
layout (side tables with 64- or 48-col rows, 16-wide rows, the fused
table) equal the plain 64-col arms bitwise, and their count_depth arms
the walk on the same tables."""

import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import camera as camlib
from cpugpupathtracing_tpu_torch.models import integrators
from cpugpupathtracing_tpu_torch.models import materials as matlib
from cpugpupathtracing_tpu_torch.models import mesh as meshlib
from cpugpupathtracing_tpu_torch.models import whitted
from cpugpupathtracing_tpu_torch.models.scene import Scene
from cpugpupathtracing_tpu_torch.ops import megakernel as mk
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from cpugpupathtracing_tpu_torch.ops import whitted_kernel as wk
from cpugpupathtracing_tpu_torch.utils import rng as rnglib

pytestmark = pytest.mark.gpu
W, H = 128, 64


def _card_scene() -> Scene:
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
    return s


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = _card_scene().build_device("cuda")
    cam = camlib.to_arrays(CameraConfig(pos=(0.0, 0.0, 6.0), aspect=2.0),
                           "cuda")
    lane = torch.arange(W * H, device="cuda")
    o, d = camlib.lane_rays(cam, lane, W, H)
    st = rnglib.seed_lanes(lane, 0, salt=0x7777)
    return dev, o, d, st


def _launched(key: str) -> int:
    """The launch count of one kernel arm (ops/pt_frame.py launches)."""
    return ptf.launches.get(key, 0)


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
    before = _launched("pt_frame")
    e_k, s_k, tr_k = ptf.pt_frame(*dev.tables(), rays, st, depths=depths,
                                  **kw)
    assert _launched("pt_frame") == before + 1
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


def _depth0(dev, o, d, st):
    """shade_extend's inputs of a fresh wavefront at depth 0 (kernel args,
    keyword args)."""
    n = st.shape[0]
    one = torch.ones(n, device="cuda")
    zero = torch.zeros(n, device="cuda")
    flags = torch.ones(n, dtype=torch.int32, device="cuda")
    return ((*dev.tables(), 0, _rays(o, d), st, (one, one, one),
             (zero, zero, zero), flags), integrators.extend_kwargs(dev, RenderSettings()))


def _shade_plain(dev, args, kw):
    keys = ("num_lights", "num_sph", "num_pln", "nee", "rr", "cosine",
            "ref_pdf", "light_tri_meta")
    return mk.shade_extend_reference(dev.pltris, *args[2:],
                                     **{k: kw[k] for k in keys})


def test_shade_extend_matches_plain(card):
    dev, o, d, st = card
    args, kw = _depth0(dev, o, d, st)
    before = _launched("shade_extend")
    got = mk.shade_extend(*args, **kw)
    assert _launched("shade_extend") == before + 1
    ref = _shade_plain(dev, args, kw)
    ptf.check_status("cuda")
    assert torch.equal(got[4], ref[4])  # flags, sneed included
    assert torch.equal(got[1], ref[1])  # state
    _contract(torch.stack(ref[3], 1), torch.stack(got[3], 1))
    sneed = ((got[4] >> 2) & 1).bool()
    assert float(sneed.float().mean()) > 0.1
    for g, r in zip((*got[5], *got[6], got[7], *got[8]),
                    (*ref[5], *ref[6], ref[7], *ref[8])):
        assert not bool(g[~sneed].any())
        assert torch.allclose(g, r, rtol=1e-4, atol=1e-5)


def test_shadow_resolve_matches_plain(card):
    dev, o, d, st = card
    args, kw = _depth0(dev, o, d, st)
    _, _, _, en, fl, so, sd, stm, contrib = _shade_plain(dev, args, kw)
    sargs = (dev.poccl_nodes, dev.poccl_ltris, dev.mk_sph, dev.mk_pln, so,
             sd, stm, fl, en, contrib)
    before = _launched("shadow_resolve")
    got = mk.shadow_resolve(*sargs, **integrators.shadow_kwargs(dev))
    assert _launched("shadow_resolve") == before + 1
    ref = mk.shadow_resolve_reference(
        dev.poccl_ltris, dev.mk_sph, dev.mk_pln, so, sd, stm, fl, en,
        contrib, num_sph=dev.num_sph, num_pln=dev.num_pln, occl=True)
    ptf.check_status("cuda")
    assert torch.equal(torch.stack(got, 1), torch.stack(ref, 1))


@pytest.mark.parametrize("sort", [False, True], ids=["nosort", "sort"])
def test_per_depth_route_bitwise(card, sort):
    dev, o, d, st = card
    settings = RenderSettings()
    idx = torch.arange(W * H, dtype=torch.int32, device="cuda") if sort \
        else None
    s1, one = integrators.trace_advanced_frame(dev, settings, o, d, st)
    before = dict(ptf.launches)
    s2, two = integrators.trace_advanced_mega(dev, settings, o, d, st,
                                              idx=idx)
    for name in ("shade_extend", "shadow_resolve"):
        assert (_launched(name) == before.get(name, 0)
                + settings.max_ray_depth + 1)
    ptf.check_status("cuda")
    assert torch.equal(one.energy, two.energy)
    assert int(one.traced_rays) == int(two.traced_rays)
    assert torch.equal(s1, s2)


def test_megakernel_wrappers_refuse_bad_inputs(card):
    dev, o, d, st = card
    args, kw = _depth0(dev, o, d, st)
    inst = torch.zeros((1, 12), device="cuda")
    with pytest.raises(ValueError, match="inst_root"):
        mk.shade_extend(*args, inst_inv=inst, **kw)
    with pytest.raises(ValueError, match="width=16"):
        mk.shade_extend(*args, width=16, **kw)
    with pytest.raises(NotImplementedError, match="slice 7"):
        mk.shade_extend(*args, pay=torch.zeros((1, 128), device="cuda"),
                        **kw)
    bad = list(args)
    bad[12] = st.to(torch.int32)
    with pytest.raises(ValueError, match="state"):
        mk.shade_extend(*bad, **kw)
    got = mk.shade_extend(*args, **kw)
    _, _, _, en, fl, so, sd, stm, contrib = got
    sargs = [dev.poccl_nodes, dev.poccl_ltris, dev.mk_sph, dev.mk_pln, so,
             sd, stm, fl, en, contrib]
    skw = integrators.shadow_kwargs(dev)
    with pytest.raises(ValueError, match="inst_root"):
        mk.shadow_resolve(*sargs, inst_inv=inst, **skw)
    sargs[7] = fl.to(torch.int64)
    with pytest.raises(ValueError, match="flags"):
        mk.shadow_resolve(*sargs, **skw)
    sargs[7] = fl
    sargs[4] = (so[0].cpu(), so[1], so[2])
    with pytest.raises(ValueError, match="shadow_o"):
        mk.shadow_resolve(*sargs, **skw)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_traverse_matches_plain(card, any_hit):
    dev, o, d, _ = card
    n = W * H
    g = torch.Generator(device="cuda").manual_seed(3)
    t_init = torch.where(torch.rand(n, device="cuda", generator=g) < 0.5,
                         torch.full((n,), 1e34, device="cuda"),
                         1.0 + 10.0 * torch.rand(n, device="cuda",
                                                 generator=g))
    active = torch.rand(n, device="cuda", generator=g) < 0.5
    before = _launched("traverse_packet_slim")
    got = tps.traverse_packet_slim(o, d, t_init, dev.pnodes, dev.pltris,
                                   dev.proots, active=active, any_hit=any_hit,
                                   count_depth=False)
    assert _launched("traverse_packet_slim") == before + 1
    ref = tps.traverse_packet_slim_reference(_rays(o, d), t_init, dev.pltris,
                                             active=active)
    ptf.check_status("cuda")
    assert int((ref[1] >= 0).sum()) > n // 8
    assert torch.equal(got[1] >= 0, ref[1] >= 0)
    if not any_hit:
        for a, b in zip(got[:3] + got[3], ref[:3] + ref[3]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture()
def whitted_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = whitted.make_whitted_scene().build_device("cuda")
    cam = camlib.to_arrays(CameraConfig(pos=(0.0, 0.5, 8.0), aspect=2.0),
                           "cuda")
    lane = torch.arange(W * H, device="cuda")
    o, d = camlib.lane_rays(cam, lane, W, H)
    return dev, o, d, rnglib.seed_lanes(lane, 0, salt=0x1CE)


def test_whitted_frame_matches_plain(whitted_card):
    dev, o, d, st = whitted_card
    args = (dev.mk_mats, dev.mk_lights, dev.mk_sph, dev.mk_pln,
            dev.mk_sph_mat, dev.mk_pln_mat, dev.mk_objmat, _rays(o, d), st)
    kw = dict(num_lights=dev.num_lights, num_sph=dev.num_sph,
              num_pln=dev.num_pln, depths=5)
    before = _launched("whitted_frame")
    got = wk.whitted_frame(*args, num_mats=dev.num_mats, **kw)
    assert _launched("whitted_frame") == before + 1
    ref = wk.whitted_frame_reference(*args, **kw)
    assert int(got[2]) == int(ref[2]) > W * H
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0], ref[0])


def test_whitted_routes_agree(whitted_card):
    dev, o, d, st = whitted_card
    settings = RenderSettings(render_mode=RenderMode.WHITTED,
                              max_ray_depth=4)
    s1, one = whitted.trace_whitted(dev, settings, o, d, st)
    s2, two = whitted.trace_whitted_kernel(dev, settings, o, d, st)
    assert int(one.traced_rays) == int(two.traced_rays)
    assert torch.equal(s1, s2)
    assert torch.equal(one.energy, two.energy)


def _instanced_scene():
    """Three scaled, rotated icospheres under a TLAS, a floor quad and a
    sphere light (tests/test_packet_instances.py's render scene)."""
    s = Scene()
    white = s.add_material(matlib.Material.diffuse((0.8, 0.8, 0.8)))
    glass = s.add_material(matlib.Material.dielectric(
        (0.9, 0.9, 0.9), 0.1, 0.8, (0.1, 0.2, 0.2), 1.5))
    tf = np.zeros((3, 4, 4), np.float32)
    for i in range(3):
        ang = 2.1 * i + 0.4
        c, sn = np.cos(ang), np.sin(ang)
        sc = 0.6 + 0.2 * i
        tf[i] = [[c * sc, 0, sn * sc, 2.2 * (i - 1)], [0, sc, 0, 0.3 * i],
                 [-sn * sc, 0, c * sc, 0.5], [0, 0, 0, 1]]
    s.add_instanced_mesh("balls", meshlib.icosphere(subdivisions=2), glass,
                         tf)
    s.add_mesh("floor", meshlib.ground_quad(half_extent=20.0, y=-2.0), white)
    light = s.add_material(matlib.Material.light((1.0, 1.0, 1.0), 20.0))
    s.mark_light(s.add_sphere("light", (6.0, 8.0, 6.0), 2.0, light))
    return s


@pytest.fixture()
def inst_card(monkeypatch):
    """The instanced scene on the object-space machinery on the card, and
    camera rays and seeds for it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("CPUGPU_NO_FLATTEN", "1")
    s = _instanced_scene()
    dev = s.device("cuda")
    assert dev.machinery
    cam = camlib.to_arrays(CameraConfig(pos=(0.0, 0.5, 7.0), aspect=2.0),
                           "cuda")
    lane = torch.arange(W * H, device="cuda")
    o, d = camlib.lane_rays(cam, lane, W, H)
    st = rnglib.seed_lanes(lane, 0, salt=5)
    return s, dev, o, d, st


def _bits(cols):
    return [c.view(torch.int32) if c.dtype == torch.float32 else c
            for c in cols]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_traverse_instance_arm_matches_plain(inst_card, any_hit):
    """traverse_packet_slim's instance arm on the card equals its plain
    version: closest hits bitwise (t, id, object, object-space normal,
    instance), any hits in existence."""
    _, dev, o, d, _ = inst_card
    rays = _rays(o, d)
    t0 = torch.full((W * H,), 1e34, device="cuda")
    act = torch.arange(W * H, device="cuda") % 3 != 0
    before = _launched("traverse_packet_slim_inst")
    got = tps.traverse_packet_slim(rays[:3], rays[3:], t0, dev.pnodes,
                                   dev.pltris, dev.proots, active=act,
                                   any_hit=any_hit, count_depth=False,
                                   **dev.inst_kwargs(nrm=False))
    assert _launched("traverse_packet_slim_inst") == before + 1
    ref = tps.traverse_packet_slim_reference(
        rays, t0, dev.pltris, active=act, any_hit=any_hit,
        inst=(dev.pnodes, dev.proots, dev.inst_inv,
              dev.inst_blas_root_packet))
    ptf.check_status("cuda")
    if any_hit:
        assert torch.equal(got[1] >= 0, ref[1] >= 0)
        return
    for a_, b_ in zip(_bits((got[0], got[1], got[2], *got[3], got[5])),
                      _bits((ref[0], ref[1], ref[2], *ref[3], ref[5]))):
        assert torch.equal(a_, b_)
    assert int((got[5] >= 0).sum()) > 100


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("arm", ["plain", "instance"])
def test_traverse_depth_arm_matches_walk(card, inst_card, arm, any_hit):
    """traverse_packet_slim's count_depth arm on the card (plain and
    instance arm) equals its plain version, the PyTorch walk, bitwise on
    every output: t, id, object, normal, bvh_depth (and instance); every
    lane with a mesh hit has bvh_depth >= 1."""
    if arm == "plain":
        dev, o, d, _ = card
        kw = {}
    else:
        _, dev, o, d, _ = inst_card
        kw = dev.inst_kwargs(nrm=False)
    rays = _rays(o, d)
    n = W * H
    t0 = torch.full((n,), 1e34, device="cuda")
    act = torch.arange(n, device="cuda") % 3 != 0
    name = ptf.launch_key("traverse_packet_slim", inst=arm == "instance",
                          depth=True)
    before = _launched(name)
    got = tps.traverse_packet_slim(rays[:3], rays[3:], t0, dev.pnodes,
                                   dev.pltris, dev.proots, active=act,
                                   any_hit=any_hit, **kw)
    assert _launched(name) == before + 1
    ref = tps.traverse_walk_reference(
        rays, t0, dev.pnodes, dev.pltris, dev.proots, active=act,
        any_hit=any_hit, inst_inv=kw.get("inst_inv"),
        inst_root=kw.get("inst_root"))
    ptf.check_status("cuda")
    flat = lambda x: (x[0], x[1], x[2], *x[3], *x[4:])  # noqa: E731
    for a_, b_ in zip(_bits(flat(got)), _bits(flat(ref))):
        assert torch.equal(a_, b_)
    hit = got[1] >= 0
    assert int(hit.sum()) > 100 and (got[4][hit] >= 1).all()
    assert not got[4][~act].any()


def test_megakernel_instance_arms_match_plain(inst_card):
    """shade_extend's and shadow_resolve's instance arms on the card
    equal their plain versions bitwise (every output column of
    shade_extend; shadow_resolve's energy)."""
    _, dev, o, d, st = inst_card
    n = W * H
    one = torch.ones(n, device="cuda")
    zero = torch.zeros(n, device="cuda")
    kw = dict(integrators.extend_kwargs(dev, RenderSettings()),
              **dev.inst_kwargs())
    args = (*dev.tables(), 0, _rays(o, d), st, (one, one, one),
            (zero, zero, zero), torch.ones(n, dtype=torch.int32,
                                           device="cuda"))
    got = mk.shade_extend(*args, **kw)
    keys = ("num_lights", "num_sph", "num_pln", "nee", "rr", "cosine",
            "ref_pdf", "light_tri_meta")
    ref = mk.shade_extend_reference(
        args[1], *args[2:], **{k: kw[k] for k in keys},
        inst=(dev.pnodes, dev.proots, dev.inst_inv, dev.inst_nrm,
              dev.inst_blas_root_packet))

    def flat(x):
        return [c for v in x for c in (v if isinstance(v, tuple) else (v,))]

    for a_, b_ in zip(_bits(flat(got)), _bits(flat(ref))):
        assert torch.equal(a_, b_)
    nodes, ltris, skw = integrators.shadow_tables(dev)
    sargs = (nodes, ltris, dev.mk_sph, dev.mk_pln, got[5], got[6], got[7],
             got[4], got[3], got[8])
    e_k = mk.shadow_resolve(*sargs, **skw)
    e_p = mk.shadow_resolve_reference(
        *sargs[1:], num_sph=dev.num_sph, num_pln=dev.num_pln,
        inst=(nodes, dev.proots, dev.inst_inv, dev.inst_blas_root_packet))
    ptf.check_status("cuda")
    for a_, b_ in zip(_bits(e_k), _bits(e_p)):
        assert torch.equal(a_, b_)
    assert int(((got[4] >> 2) & 1).sum()) > 100


def test_refit_on_card_equals_fresh_build(inst_card):
    """A transform edit refits the snapshot on the card, in place; it
    then equals a fresh build at the same transforms bitwise, and the
    object-space per-depth route runs its instance arms on it."""
    s, dev, o, d, st = inst_card
    m = s.objects[0].instances[1].copy()
    m[0, 3] += 0.7
    s.set_instance_transform(0, 1, m)
    assert s.device("cuda") is dev
    fresh_scene = _instanced_scene()
    fresh_scene.set_instance_transform(0, 1, m)
    fresh = fresh_scene.device("cuda")
    from cpugpupathtracing_tpu_torch.models.scene import TABLE_FIELDS
    for name, _ in TABLE_FIELDS:
        assert torch.equal(*_bits((getattr(dev, name), getattr(fresh, name))))
    before = dict(ptf.launches)
    integrators.trace_advanced_mega(dev, RenderSettings(), o, d, st)
    for name in ("shade_extend_inst", "shadow_resolve_inst"):
        assert _launched(name) == before.get(name, 0) + 6
    ptf.check_status("cuda")


# the node-table layouts of the variant arms (ops/pt_frame.py LAYOUTS),
# each with the any-hit tables (occl) and, for the 16-wide and fused
# tables, without them (shadow rays then walk the shading tables)
VARIANT_ENV = {
    "ents": dict(CPUGPU_SMEMTREE="1"),
    "48": dict(CPUGPU_SMEMTREE="48"),
    "w16": dict(CPUGPU_PACKET_TREE="w16"),
    "fused": dict(CPUGPU_FUSED="1"),
    "fused_w16": dict(CPUGPU_FUSED="1", CPUGPU_PACKET_TREE="w16"),
}
VARIANT_CASES = [(k, True) for k in VARIANT_ENV] + [("w16", False),
                                                   ("fused", False)]


def _variant_scene(monkeypatch, env, occl=True):
    """The card fixture's scene built under node-table flags (side tables
    for every tree size)."""
    for k in ("CPUGPU_PACKET_TREE", "CPUGPU_FUSED", "CPUGPU_SMEMTREE",
              "CPUGPU_OCCL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("CPUGPU_SMEMTREE_MIN_NODES", "1")
    monkeypatch.setenv("CPUGPU_OCCL", "1" if occl else "0")
    return _card_scene().build_device("cuda")


@pytest.mark.parametrize("layout,occl", VARIANT_CASES,
                         ids=[f"{k}{'' if o else '_shared'}"
                              for k, o in VARIANT_CASES])
def test_variant_arms_match_plain_arms(card, layout, occl, monkeypatch):
    """Every variant arm on the card equals the plain 64-col arm on the
    same scene bitwise: pt_frame (energy, state, traced) on the
    whole-frame route's tables, shade_extend (every output) and
    shadow_resolve on the per-depth route's; traverse_packet_slim's
    closest hits equal brute force bitwise and its count_depth arm the
    walk on the same tables bitwise, bvh_depth included.  Each launch is
    counted under its layout."""
    _, o, d, st = card
    settings = RenderSettings()
    depths = settings.max_ray_depth + 1
    rays = _rays(o, d)
    base = _variant_scene(monkeypatch, dict(CPUGPU_SMEMTREE="0"), occl)
    dev = _variant_scene(monkeypatch, VARIANT_ENV[layout], occl)
    runs = []
    for ds in (base, dev):
        tables, kw = integrators.frame_args(ds, settings)
        frame = ptf.pt_frame(*tables, rays, st, depths=depths, **kw)
        args, ekw = _depth0(ds, o, d, st)
        tables, tkw = integrators.route_tables(ds)
        args = (*tables, *args[10:])
        ext = mk.shade_extend(*args, **ekw, **tkw)
        sn, sl, skw = integrators.shadow_tables(ds)
        en = mk.shadow_resolve(sn, sl, ds.mk_sph, ds.mk_pln, ext[5], ext[6],
                               ext[7], ext[4], ext[3], ext[8], **skw)
        runs.append((frame, ext, en))
    ptf.check_status("cuda")

    def flat(x):
        return ([c for v in x for c in flat(v)] if isinstance(x, tuple)
                else [x.reshape(-1)])

    got, ref = flat(runs[1]), flat(runs[0])
    assert len(got) == len(ref) == 3 + 24 + 3
    for a_, b_ in zip(_bits(got), _bits(ref)):
        assert torch.equal(a_, b_)
    key = ptf.arm_key(ptf.table_layout(*_layout_of(dev)),
                      "48" if layout == "48" else
                      "ents" if layout == "ents" else "64")
    assert _launched(ptf.launch_key("pt_frame", key)) >= 1
    assert _launched(ptf.launch_key("shade_extend", layout)) >= 1
    nodes, ltris, fused_nn, ents = _packet(dev)
    n = W * H
    t0 = torch.full((n,), 1e34, device="cuda")
    act = torch.arange(n, device="cuda") % 3 != 0
    lkw = dict(fused_nn=fused_nn, width=dev.packet_width, ents=ents)
    for any_hit in (False, True):
        name = ptf.launch_key("traverse_packet_slim", layout, depth=True)
        before = _launched(name)
        got = tps.traverse_packet_slim(rays[:3], rays[3:], t0, nodes, ltris,
                                       dev.proots, active=act,
                                       any_hit=any_hit, **lkw)
        assert _launched(name) == before + 1
        ref = tps.traverse_walk_reference(rays, t0, nodes, ltris, dev.proots,
                                          active=act, any_hit=any_hit, **lkw)
        ptf.check_status("cuda")
        fl = lambda x: (x[0], x[1], x[2], *x[3], *x[4:])  # noqa: E731
        for a_, b_ in zip(_bits(fl(got)), _bits(fl(ref))):
            assert torch.equal(a_, b_)
    got = tps.traverse_packet_slim(rays[:3], rays[3:], t0, nodes, ltris,
                                   dev.proots, count_depth=False, **lkw)
    ref = tps.traverse_packet_slim_reference(rays, t0, ltris)
    for a_, b_ in zip(_bits(fl(got)), _bits(fl(ref))):
        assert torch.equal(a_, b_)


def _packet(dev):
    from cpugpupathtracing_tpu_torch.models.scene import packet_tables

    return packet_tables(dev)


def _layout_of(dev):
    nodes, _, fused_nn, ents = _packet(dev)
    return nodes, ents, fused_nn, dev.packet_width
