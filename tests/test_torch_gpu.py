"""The port's CUDA kernels on the card (marked `gpu`; without a CUDA
device each test skips).  No JAX here: the machine with the card has
none, so run these there without the JAX conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Each kernel (pt_frame, shade_extend, shadow_resolve) is held against its
plain PyTorch version on the same card and inputs under the megakernel
contract (traced exact, < 3% flipped lanes, flips < 0.02, mean within
1e-4), pt_frame's closest hits against brute force bitwise, the
split-span schedule against one span bitwise, pt_frame on more lanes
than its persistent launch keeps resident (so that its threads refill
finished paths) against its single launch bitwise and the plain version,
and the per-depth route against the whole-frame route bitwise;
shade_extend on its postponed-leaf walk (at depths 1 and 4) and on the
slot-order walks of its instance and leaf-14 arms, over a wavefront
whose lanes are all dead, a dead tail after the compaction, one live
lane in 32 and a ragged n, bitwise on every output; shadow_resolve on
every arm (64- and 48-col, 2-row and 16-wide occlusion leaves, 16-wide
and fused shading tables, instances) over the same kinds of wavefront,
columns off 16-byte alignment, two launches in a row and 100 times the
lanes, bitwise.  traverse_packet_slim's closest
hits equal its plain version's bitwise and its any hits in existence;
whitted_frame equals its plain version bitwise (energy, state, traced),
through its six-column and its (n, 3) rows entry, on every lane
missing, one live lane a warp and rays into the glass sphere at 1 to 5
depths, and on more lanes than the card keeps resident; the two Whitted
routes agree on state and traced exactly and on energy bitwise.  On an instanced scene on the object-space machinery the
instance arms of traverse_packet_slim, shade_extend and shadow_resolve
equal their plain versions bitwise, and a refit on the card equals a
fresh build bitwise.  traverse_packet_slim's count_depth arm (plain and
instance) equals its plain version, the PyTorch walk, bitwise on every
output, bvh_depth included.  The variant arms of every node-table
layout (side tables with 64- or 48-col rows, 16-wide rows, the fused
table) equal the plain 64-col arms bitwise, and their count_depth arms
the walk on the same tables.  The leaf arms (leaf-14 payload rows,
2-row and 16-wide any-hit trees) equal their plain versions bitwise.
Every arm of the traversal labs L1-L4, L6 and L7 (labs/) equals its
plain version bitwise on a bounce fan of the card scene, counters
included, and L7's warps take the max of their paired L6 warps' trips.
Every stage set of the floor probe L5 equals its plain version bitwise
(t and the final entry); the launch probe L8 equals x * 2 and x * 4 at
n = 0 to 4099 and on a view whose alignment differs from its output's; the
shared-memory probe L9 reads its word from every table up to the
device's opt-in limit, is refused above it, and launches after a
refusal.  The XLA walks (no kernel) give the same hits with their steps
replayed from CUDA graphs as launched from the host, bitwise."""

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


def test_pt_frame_refills_finished_paths(card):
    """More lanes than pt_frame's persistent launch keeps resident, so its
    threads refill lanes: the card scene's lanes repeated to twice the
    resident threads, as one span and as the split schedule's two spans
    with the carry.  Every copy of every output is bitwise the single
    launch's, and the repeated launch holds against the plain version
    under the megakernel contract, as test_kernel_matches_plain's."""
    dev, o, d, st = card
    settings = RenderSettings()
    kw = integrators.frame_kwargs(dev, settings)
    rays = _rays(o, d)
    depths, split = settings.max_ray_depth + 1, 2
    e_k, s_k, tr_k = ptf.pt_frame(*dev.tables(), rays, st, depths=depths,
                                  **kw)
    resident = ptf.resident_threads(*dev.tables(), rays, st, **kw)
    reps = -(-2 * resident // (W * H))
    big = tuple(r.repeat(reps) for r in rays)
    assert big[0].shape[0] > resident > 0

    def tile(x):
        x = torch.stack(x, 1) if isinstance(x, tuple) else x
        return x.repeat((reps,) + (1,) * (x.dim() - 1))

    def same(a, b):
        a = torch.stack(a, 1) if isinstance(a, tuple) else a
        return torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, tile(b).view(torch.int32)
                           if a.is_floating_point() else tile(b))

    e_b, s_b, tr_b = ptf.pt_frame(*dev.tables(), big, st.repeat(reps),
                                  depths=depths, **kw)
    assert same(e_b, e_k) and same(s_b, s_k)
    assert int(tr_b) == reps * int(tr_k)
    c1 = ptf.pt_frame(*dev.tables(), big, st.repeat(reps), depths=split,
                      carry_out=True, **kw)
    c1s = ptf.pt_frame(*dev.tables(), rays, st, depths=split,
                       carry_out=True, **kw)
    for a, b in zip(c1[:5], c1s[:5]):
        assert same(a, b)
    c2 = ptf.pt_frame(*dev.tables(), c1[0], c1[1], depths=depths - split,
                      depth_base=split, carry_in=c1[2:5], **kw)
    c2s = ptf.pt_frame(*dev.tables(), c1s[0], c1s[1], depths=depths - split,
                       depth_base=split, carry_in=c1s[2:5], **kw)
    assert same(c2[0], c2s[0]) and same(c2[1], c2s[1])
    assert int(c1[5] + c2[2]) == reps * int(c1s[5] + c2s[2])
    ptf.check_status("cuda")
    e_p, s_p, tr_p = ptf.pt_frame_reference(
        dev.pltris, *dev.tables()[2:], big, st.repeat(reps),
        num_lights=kw["num_lights"], num_sph=kw["num_sph"],
        num_pln=kw["num_pln"], nee=kw["nee"], rr=kw["rr"],
        cosine=kw["cosine"], ref_pdf=kw["ref_pdf"], depths=depths,
        light_tri_meta=kw["light_tri_meta"])
    assert int(tr_b) == int(tr_p)
    assert float((s_b == s_p).float().mean()) > 0.97
    _contract(e_p, e_b)


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
    with pytest.raises(ValueError, match="leaf-14 tables"):
        mk.shade_extend(*args, pay=torch.zeros((1, 128), device="cuda"),
                        **dict(kw, width=16))
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


MASKS = ["dead", "one_in_32", "half", "live"]


def _mask(kind, n, dev="cuda"):
    """A lane mask: none live, one lane in 32, a random half (numpy seed
    7), every lane."""
    if kind == "dead":
        return torch.zeros(n, dtype=torch.bool, device=dev)
    if kind == "one_in_32":
        return torch.arange(n, device=dev) % 32 == 7
    if kind == "half":
        rng = np.random.default_rng(7)
        return torch.from_numpy(rng.uniform(size=n) < 0.5).to(dev)
    return torch.ones(n, dtype=torch.bool, device=dev)


def _arm_call(arm, card, inst_card, mask):
    """(traverse_packet_slim's output, its plain version's, any_hit, the
    mask) of one arm on the card scene's camera rays under `mask`: the
    closest hit (brute force), the any hit toward the card's first light,
    the count_depth closest hit (the walk) and the instance arm's closest
    hit (its brute force)."""
    if arm == "instance":
        _, dev, o, d, _ = inst_card
        ikw = dev.inst_kwargs(nrm=False)
    else:
        dev, o, d, _ = card
        ikw = {}
    n = o.shape[0]
    rays = _rays(o, d)
    act = _mask(mask, n)
    t0 = torch.full((n,), 1e34, device="cuda")
    if arm == "any":
        hit = ptf.closest_hit_reference(dev.pltris, rays)
        pos = o + d * torch.where(hit[1] >= 0, hit[0], 0.0)[:, None]
        to_l = dev.mk_lights[0, 0:3][None, :] - pos
        dist = torch.sqrt((to_l * to_l).sum(dim=1))
        to_l = to_l / dist[:, None]
        rays = _rays(pos + to_l * 0.001, to_l)
        t0 = dist - dev.mk_lights[0, 3] - 0.002
    depth = arm == "depth"
    got = tps.traverse_packet_slim(rays[:3], rays[3:], t0, dev.pnodes,
                                   dev.pltris, dev.proots, active=act,
                                   any_hit=arm == "any", count_depth=depth,
                                   **ikw)
    if depth:
        ref = tps.traverse_walk_reference(rays, t0, dev.pnodes, dev.pltris,
                                          dev.proots, active=act)
    else:
        ref = tps.traverse_packet_slim_reference(
            rays, t0, dev.pltris, active=act, any_hit=arm == "any",
            inst=(dev.pnodes, dev.proots, dev.inst_inv,
                  dev.inst_blas_root_packet) if ikw else None)
    ptf.check_status("cuda")
    return got, ref, arm == "any", act, t0


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("arm", ["closest", "any", "depth", "instance"])
def test_traverse_masks(card, inst_card, arm, mask):
    """Inactive lanes write their outputs at once and live ones walk (in
    the postponed-leaf walk a warp's lanes without a ray only vote): under
    every mask (none live, one in 32, a random half, all) each arm equals
    its plain version -- closest hits (plain
    with postponed leaves, count_depth, instance) bitwise on every
    output, any hits in existence -- and every inactive lane holds
    t_init, ids -1, a zero normal and depth 0, bitwise."""
    got, ref, any_hit, act, t0 = _arm_call(arm, card, inst_card, mask)
    flat = lambda x: (x[0], x[1], x[2], *x[3], *x[4:])  # noqa: E731
    got, ref = flat(got), flat(ref)
    dead = ~act
    assert torch.equal(got[0][dead].view(torch.int32),
                       t0[dead].view(torch.int32))
    for c in got[1:3] + got[6:]:
        want = 0 if c is got[6] else -1
        assert bool((c[dead] == want).all())
    for c in got[3:6]:
        assert bool((c[dead] == 0).all())
    if any_hit:
        assert torch.equal(got[1] >= 0, ref[1] >= 0)
    else:
        for a_, b_ in zip(_bits(got), _bits(ref)):
            assert torch.equal(a_, b_)
    if mask in ("half", "live"):
        assert int((got[1] >= 0).sum()) > 0


def _most_resident() -> int:
    """The most threads the card keeps resident (every SM full): a launch
    of more lanes runs in several block waves."""
    props = torch.cuda.get_device_properties(0)
    return props.multi_processor_count * props.max_threads_per_multi_processor


@pytest.mark.parametrize("lanes", ["one", "ragged", "beyond_resident"])
def test_traverse_lane_counts(card, lanes):
    """Launches of 1 lane, of a count that is no multiple of a warp's 32
    lanes, and of more lanes than the card keeps resident (several block
    waves): every lane bitwise the 8192-lane launch's at the same ray:
    closest hits with and without count_depth (the walk's bvh_depth too),
    any hits."""
    dev, o, d, _ = card
    rays = _rays(o, d)
    n = W * H
    t0 = 1.0 + 10.0 * torch.arange(n, device="cuda") / n
    act = _mask("half", n)
    for any_hit, depth in ((False, False), (False, True), (True, False)):
        kw = dict(active=act, any_hit=any_hit, count_depth=depth)
        ref = tps.traverse_packet_slim(rays[:3], rays[3:], t0, dev.pnodes,
                                       dev.pltris, dev.proots, **kw)
        if lanes == "one":
            idx = torch.tensor([int(act.nonzero()[3])], device="cuda")
        elif lanes == "ragged":
            idx = torch.arange(n - 77, device="cuda")
        else:
            idx = torch.arange(n, device="cuda").repeat(
                _most_resident() // n + 2)
        got = tps.traverse_packet_slim(
            tuple(c[idx] for c in rays[:3]), tuple(c[idx] for c in rays[3:]),
            t0[idx], dev.pnodes, dev.pltris, dev.proots,
            **dict(kw, active=act[idx]))
        ptf.check_status("cuda")
        flat = lambda x: (x[0], x[1], x[2], *x[3], x[4])  # noqa: E731
        for a_, b_ in zip(_bits(flat(got)), _bits(flat(ref))):
            assert torch.equal(a_, b_[idx])


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


def _whitted_case(o, d, case: str):
    """(origin, direction) rows of a B5 lane case: every lane missing
    (straight back, away from the scene), one live lane a warp (lane 16 of
    each 32 keeps its camera ray, the others miss), or every ray straight
    into the glass sphere (its center, jittered by a seeded numpy draw:
    refraction, total internal reflection and Beer's law over 5 depths)."""
    away = torch.zeros_like(d)
    away[:, 2] = 1.0
    if case == "all_miss":
        return o, away
    if case == "one_live_a_warp":
        keep = (torch.arange(o.shape[0], device=o.device) % 32 == 16)[:, None]
        return o, torch.where(keep, d, away)
    rng = np.random.default_rng(15)
    jitter = torch.from_numpy(rng.uniform(-0.35, 0.35, (o.shape[0], 3)))
    tgt = torch.tensor([0.8, -0.2, 1.5]) + jitter.float()
    dd = tgt.to(o.device) - o
    return o, dd / dd.norm(dim=1, keepdim=True)


def _whitted_args(dev, st):
    return ((dev.mk_mats, dev.mk_lights, dev.mk_sph, dev.mk_pln,
             dev.mk_sph_mat, dev.mk_pln_mat, dev.mk_objmat),
            dict(num_lights=dev.num_lights, num_sph=dev.num_sph,
                 num_pln=dev.num_pln))


@pytest.mark.parametrize("depths", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("case", ["all_miss", "one_live_a_warp", "glass"])
def test_whitted_frame_lane_cases(whitted_card, case, depths):
    """B5 through both entries (six columns; the (n, 3) rows with the
    camera origin expanded over every lane) against its plain version
    bitwise on energy, state and traced, at 1 to 5 depths."""
    dev, o, d, st = whitted_card
    o, d = _whitted_case(o, d, case)
    tables, kw = _whitted_args(dev, st)
    ref = wk.whitted_frame_reference(*tables, _rays(o, d), st,
                                     depths=depths, **kw)
    cols = wk.whitted_frame(*tables, _rays(o, d), st, num_mats=dev.num_mats,
                            depths=depths, **kw)
    rows = wk.whitted_frame_rows(*tables, o, d, st, num_mats=dev.num_mats,
                                 depths=depths, **kw)
    for got in (cols, rows):
        assert int(got[2]) == int(ref[2])
        assert torch.equal(got[1], ref[1])
        assert torch.equal(got[0], ref[0])
    if case == "all_miss":
        assert int(ref[2]) == W * H


def test_whitted_frame_past_resident(whitted_card):
    """A launch of more lanes than the card keeps resident (the camera
    lanes repeated) equals the plain version bitwise, and its traced
    total is the sum over the repeats."""
    dev, o, d, st = whitted_card
    tables, kw = _whitted_args(dev, st)
    reps = wk.resident_threads(torch.device("cuda")) // (W * H) + 2
    o, d, st = o.repeat(reps, 1), d.repeat(reps, 1), st.repeat(reps)
    got = wk.whitted_frame_rows(*tables, o, d, st, num_mats=dev.num_mats,
                                depths=5, **kw)
    ref = wk.whitted_frame_reference(*tables, _rays(o, d), st, depths=5,
                                     **kw)
    one = wk.whitted_frame_reference(*tables, _rays(o[:W * H], d[:W * H]),
                                     st[:W * H], depths=5, **kw)
    assert int(got[2]) == int(ref[2]) == reps * int(one[2])
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0], ref[0])


def test_whitted_rows_entry_matches_columns(whitted_card):
    """whitted_frame_rows on the camera's expanded origin and on a
    contiguous copy of it equals whitted_frame on six columns bitwise;
    each call is one launch, counted once."""
    dev, o, d, st = whitted_card
    tables, kw = _whitted_args(dev, st)
    assert o.stride(0) == 0
    before = _launched("whitted_frame")
    cols = wk.whitted_frame(*tables, _rays(o, d), st, num_mats=dev.num_mats,
                            depths=5, **kw)
    for origin in (o, o.contiguous()):
        rows = wk.whitted_frame_rows(*tables, origin, d, st,
                                     num_mats=dev.num_mats, depths=5, **kw)
        assert all(torch.equal(x, y) for x, y in zip(rows, cols))
    assert _launched("whitted_frame") == before + 3


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


LEAF_ENV = {"default": {}, "leaf14": dict(CPUGPU_LEAF14="1"),
            "occl2": dict(CPUGPU_OCCL2="1"),
            "occl_w16": dict(CPUGPU_OCCL_W16="1")}
LEAF_ARMS = ["pt_frame-occl2", "shade_extend-leaf14", "shadow_resolve-occl2",
             "shadow_resolve-occl_w16", "traverse-default", "traverse-occl2",
             "traverse-occl_w16", "traverse-leaf14"]


def _leaf_scene(monkeypatch, flag):
    """The card fixture's scene under a leaf-side / occlusion flag (side
    tables for every tree size, the default CPUGPU_SMEMTREE=48)."""
    for k in ("CPUGPU_PACKET_TREE", "CPUGPU_FUSED", "CPUGPU_SMEMTREE",
              "CPUGPU_OCCL", "CPUGPU_LEAF14", "CPUGPU_OCCL2",
              "CPUGPU_OCCL_W16"):
        monkeypatch.delenv(k, raising=False)
    for k, v in LEAF_ENV[flag].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("CPUGPU_SMEMTREE_MIN_NODES", "1")
    return _card_scene().build_device("cuda")


@pytest.mark.parametrize("arm", LEAF_ARMS)
def test_leaf_arms_match_plain(card, arm, monkeypatch):
    """Each leaf arm on the card equals its plain version bitwise and is
    counted under its own key: pt_frame's 2-row arm (energy, state,
    traced; and the default tables' kernel), shade_extend's leaf-14 arm
    (every output; brute force over the payload records),
    shadow_resolve's 2-row and 16-wide arms; traverse_packet_slim's occl
    arms (1-row, 2-row, 16-wide: any hits in existence, the t-only
    closest hit bitwise; leaf-14: the closest hit bitwise) against brute
    force, and their count_depth arms against the walk on every output."""
    kernel, flag = arm.split("-")
    _, o, d, st = card
    rays = _rays(o, d)
    settings = RenderSettings()
    dev = _leaf_scene(monkeypatch, flag)
    n = W * H

    def flat(x):
        return ([c for v in x for c in flat(v)] if isinstance(x, tuple)
                else [x.reshape(-1)])

    def same(a, b):
        for a_, b_ in zip(_bits(flat(a)), _bits(flat(b))):
            assert torch.equal(a_, b_)

    if kernel == "pt_frame":
        tables, kw = integrators.frame_args(dev, settings)
        key = ptf.launch_key("pt_frame", "48", leaf="occl2")
        before = _launched(key)
        got = ptf.pt_frame(*tables, rays, st, depths=6, **kw)
        assert _launched(key) == before + 1
        ref = ptf.pt_frame_reference(
            tables[1], *tables[2:], rays, st, depths=6,
            sh_records=ptf.leaf_records(kw["sh_ltris"], occl=True),
            **{k: kw[k] for k in ("num_lights", "num_sph", "num_pln", "nee",
                                  "rr", "cosine", "ref_pdf",
                                  "light_tri_meta")})
        base = _leaf_scene(monkeypatch, "default")
        btab, bkw = integrators.frame_args(base, settings)
        same(got, ref)
        same(got, ptf.pt_frame(*btab, rays, st, depths=6, **bkw))
    elif kernel in ("shade_extend", "shadow_resolve"):
        args, ekw = _depth0(dev, o, d, st)
        tables, tkw = integrators.route_tables(dev)
        args = (*tables, *args[10:])
        ekw = dict(ekw, **tkw)
        ext = mk.shade_extend(*args, **ekw)
        if kernel == "shade_extend":
            assert _launched(ptf.launch_key("shade_extend", "48",
                                            leaf="pay")) >= 1
            keys = ("num_lights", "num_sph", "num_pln", "nee", "rr",
                    "cosine", "ref_pdf", "light_tri_meta")
            same(ext, mk.shade_extend_reference(
                tables[1], *args[2:], records=ptf.leaf_records(
                    tables[1], occl=True, pay=tkw["pay"]),
                **{k: ekw[k] for k in keys}))
        else:
            sn, sl, skw = integrators.shadow_tables(dev)
            sargs = (sn, sl, dev.mk_sph, dev.mk_pln, ext[5], ext[6], ext[7],
                     ext[4], ext[3], ext[8])
            key = ptf.launch_key("shadow_resolve", "48" if flag == "occl2"
                                 else "64", leaf="occl2" if flag == "occl2"
                                 else "ow16")
            before = _launched(key)
            got = mk.shadow_resolve(*sargs, **skw)
            assert _launched(key) == before + 1
            same(got, mk.shadow_resolve_reference(
                sl, dev.mk_sph, dev.mk_pln, *sargs[4:], num_sph=dev.num_sph,
                num_pln=dev.num_pln, occl=True))
            assert int(((ext[4] >> 2) & 1).sum()) > 100
    else:
        nodes, ltris, roots, ents = integrators.occl_tables(dev)
        t0 = torch.full((n,), 1e34, device="cuda")
        act = torch.arange(n, device="cuda") % 3 != 0
        kw = dict(active=act, occl=True, pay=dev.poccl_pay,
                  occl_rows=dev.poccl_rows, width=dev.poccl_width, ents=ents)
        queries = ([False, True] if flag != "leaf14" else [False])
        for any_hit in queries:
            got = tps.traverse_packet_slim(rays[:3], rays[3:], t0, nodes,
                                           ltris, roots, any_hit=any_hit,
                                           count_depth=False, **kw)
            ref = tps.traverse_packet_slim_reference(
                rays, t0, ltris, any_hit=any_hit, **{
                    k: v for k, v in kw.items() if k != "ents"})
            assert torch.equal(got[1] >= 0, ref[1] >= 0)
            assert int((got[1] >= 0).sum()) > n // 8
            if not any_hit:
                same(got, ref)
            walk_kw = dict(kw, any_hit=any_hit)
            got = tps.traverse_packet_slim(rays[:3], rays[3:], t0, nodes,
                                           ltris, roots, **walk_kw)
            same(got, tps.traverse_walk_reference(rays, t0, nodes, ltris,
                                                  roots, **walk_kw))
        layout = ptf.table_layout(nodes, ents, 0, dev.poccl_width)
        leaf = ptf.leaf_arm(True, dev.poccl_pay, dev.poccl_rows)
        assert _launched(ptf.launch_key("traverse_packet_slim", layout,
                                        leaf=leaf)) >= 1
        assert _launched(ptf.launch_key("traverse_packet_slim", layout,
                                        depth=True, leaf=leaf)) >= 1
    ptf.check_status("cuda")


def _flat_cols(x):
    return ([c for v in x for c in _flat_cols(v)] if isinstance(x, tuple)
            else [x.reshape(-1)])


def _all_bitwise(got, ref):
    for a_, b_ in zip(_bits(_flat_cols(got)), _bits(_flat_cols(ref))):
        assert torch.equal(a_, b_)


def _next_depth(args, out, flags, lanes=None):
    """shade_extend's arguments of depth 1 from depth 0's arguments and
    outputs, with the lane flags `flags`, gathered on `lanes` where
    given."""
    c = (*out[:4], flags)
    if lanes is not None:
        c = tuple(tuple(x[lanes] for x in v) if isinstance(v, tuple)
                  else v[lanes] for v in c)
    return (*args[:10], 1, *c)


def _dead_lanes(case, fl):
    """(flags, lanes) of a dead-lane case from depth 0's flags `fl`."""
    n = fl.shape[0]
    lane = torch.arange(n, device="cuda")
    if case == "all_dead":
        return fl & 2, None
    if case == "dead_tail":
        return fl & 3, torch.argsort(((fl & 1) == 0).to(torch.int32),
                                     stable=True)
    if case == "one_in_32":
        return (fl & 2) | (lane % 32 == 5).to(torch.int32), None
    # ragged: single dead lanes, a dead warp, n not a multiple of 32 or 128
    dead = (lane % 7 == 3) | ((lane >= 256) & (lane < 288))
    return (fl & 3) & ~dead.to(torch.int32), lane[:n - 77]


B2_DEAD = ["all_dead", "dead_tail", "one_in_32", "ragged"]


@pytest.mark.parametrize("depth", [1, 4], ids=["d1", "d4"])
@pytest.mark.parametrize("case", B2_DEAD)
def test_shade_extend_dead_lanes(card, case, depth):
    """shade_extend's postponed-leaf walk at depths 1 and 4 equals its
    plain version bitwise on every output: over a wavefront whose lanes
    are all dead, over a dead tail after the compaction (live lanes
    first), with one live lane in 32, and with single dead lanes, a dead
    warp and n not a multiple of 32 or 128."""
    dev, o, d, st = card
    args, kw = _depth0(dev, o, d, st)
    out = mk.shade_extend(*args, **kw)
    args = _next_depth(args, out, *_dead_lanes(case, out[4]))
    args = (*args[:10], depth, *args[11:])
    got = mk.shade_extend(*args, **kw)
    ref = _shade_plain(dev, args, kw)
    ptf.check_status("cuda")
    _all_bitwise(got, ref)
    live = int((args[15] & 1).sum())
    assert (live == 0) == (case == "all_dead")
    if case == "all_dead":
        assert not bool((got[4] & 5).any())


@pytest.mark.parametrize("case", B2_DEAD)
@pytest.mark.parametrize("arm", ["instance", "leaf14"])
def test_shade_extend_dead_lanes_other_arms(card, inst_card, arm, case,
                                           monkeypatch):
    """The instance arm and the leaf-14 arm (slot-order walks) at depth 1
    equal their plain versions bitwise on every output, over the dead-lane
    cases of test_shade_extend_dead_lanes."""
    keys = ("num_lights", "num_sph", "num_pln", "nee", "rr", "cosine",
            "ref_pdf", "light_tri_meta")
    if arm == "instance":
        _, dev, o, d, st = inst_card
        args, kw = _depth0(dev, o, d, st)
        kw = dict(kw, **dev.inst_kwargs())
        extra = dict(inst=(dev.pnodes, dev.proots, dev.inst_inv,
                           dev.inst_nrm, dev.inst_blas_root_packet))
    else:
        _, o, d, st = card
        dev = _leaf_scene(monkeypatch, "leaf14")
        args, kw = _depth0(dev, o, d, st)
        tables, tkw = integrators.route_tables(dev)
        args, kw = (*tables, *args[10:]), dict(kw, **tkw)
        extra = dict(records=ptf.leaf_records(tables[1], occl=True,
                                              pay=tkw["pay"]))
    out = mk.shade_extend(*args, **kw)
    args = _next_depth(args, out, *_dead_lanes(case, out[4]))
    got = mk.shade_extend(*args, **kw)
    ptf.check_status("cuda")
    _all_bitwise(got, mk.shade_extend_reference(
        args[1], *args[2:], **{k: kw[k] for k in keys}, **extra))
    live = int((args[15] & 1).sum())
    assert (live == 0) == (case == "all_dead")


# shadow_resolve's arms (B3): the node layouts of its any-hit tree (64-col
# plain arm, 48-col with side tables, 2-row and 16-wide occlusion leaves)
# and of the shading tree it walks without one (16-wide, fused), and the
# instance arm
B3_ENV = {
    "64": dict(CPUGPU_SMEMTREE="0"),
    "48": {},
    "occl2": dict(CPUGPU_OCCL2="1"),
    "occl_w16": dict(CPUGPU_OCCL_W16="1"),
    "w16": dict(CPUGPU_PACKET_TREE="w16", CPUGPU_OCCL="0"),
    "fused": dict(CPUGPU_FUSED="1", CPUGPU_OCCL="0"),
}
B3_ARMS = list(B3_ENV) + ["instance"]
B3_CASES = ["all_dead", "dead_tail", "one_in_32", "ragged", "unaligned",
            "twice", "x100"]


def _b3_inputs(arm, card, inst_card, monkeypatch):
    """(shadow_resolve's arguments after one shade_extend at depth 0,
    keyword arguments, the plain version's extra arguments) on an arm."""
    if arm == "instance":
        _, dev, o, d, st = inst_card
    else:
        _, o, d, st = card
        for k in ("CPUGPU_PACKET_TREE", "CPUGPU_FUSED", "CPUGPU_SMEMTREE",
                  "CPUGPU_OCCL", "CPUGPU_LEAF14", "CPUGPU_OCCL2",
                  "CPUGPU_OCCL_W16"):
            monkeypatch.delenv(k, raising=False)
        for k, v in B3_ENV[arm].items():
            monkeypatch.setenv(k, v)
        monkeypatch.setenv("CPUGPU_SMEMTREE_MIN_NODES", "1")
        dev = _card_scene().build_device("cuda")
    args, kw = _depth0(dev, o, d, st)
    tables, tkw = integrators.route_tables(dev)
    ext = mk.shade_extend(*tables, *args[10:], **dict(kw, **tkw,
                                                      **dev.inst_kwargs()))
    sn, sl, skw = integrators.shadow_tables(dev)
    extra = dict(num_sph=dev.num_sph, num_pln=dev.num_pln,
                 occl=skw["occl"])
    if arm == "instance":
        extra["inst"] = (sn, dev.proots, dev.inst_inv,
                         dev.inst_blas_root_packet)
    return (sn, sl, dev.mk_sph, dev.mk_pln, ext[5], ext[6], ext[7], ext[4],
            ext[3], ext[8]), skw, extra


def _b3_case(case, sargs):
    """shadow_resolve's arguments under a lane case: every shadow ray
    dropped; the shadow rays first (a dead tail); one lane in 32 keeping
    its shadow ray; single lanes and a warp dropped with n not a multiple
    of 4 or 32; every column a view 4 bytes past a 16-byte
    boundary; the lanes repeated 100 times."""
    fl = sargs[7]
    n = fl.shape[0]
    lane = torch.arange(n, device="cuda")

    def pick(ix, a=sargs):
        return a[:4] + tuple(
            tuple(c[ix] for c in x) if isinstance(x, tuple) else x[ix]
            for x in a[4:])

    if case == "all_dead":
        return sargs[:7] + (fl & 3,) + sargs[8:]
    if case == "dead_tail":
        return pick(torch.argsort((((fl >> 2) & 1) == 0).to(torch.int32),
                                  stable=True))
    if case == "one_in_32":
        keep = (lane % 32 == 5).to(torch.int32) << 2
        return sargs[:7] + ((fl & 3) | (fl & keep),) + sargs[8:]
    if case == "ragged":
        drop = (lane % 7 == 3) | ((lane >= 256) & (lane < 288))
        fl = fl & ~(drop.to(torch.int32) << 2)
        return pick(lane[:n - 77], sargs[:7] + (fl,) + sargs[8:])
    if case == "unaligned":
        def off(x):
            if isinstance(x, tuple):
                return tuple(off(c) for c in x)
            y = torch.empty(n + 1, dtype=x.dtype, device="cuda")[1:]
            y.copy_(x)
            return y
        return sargs[:4] + tuple(off(x) for x in sargs[4:])
    if case == "x100":
        return pick(lane.repeat(100))
    return sargs


@pytest.mark.parametrize("case", B3_CASES)
@pytest.mark.parametrize("arm", B3_ARMS)
def test_shadow_resolve_lane_cases(card, inst_card, arm, case, monkeypatch):
    """shadow_resolve on every arm equals the plain version bitwise
    (energy on every lane) over a wavefront without a shadow ray, a dead
    tail (whole warps of shadow rays, each lane walking its own), one
    shadow ray in 32 (warps walking it with all their lanes), ragged n,
    columns that are not 16-byte aligned, two launches in a row on the
    same inputs, and 100 times the lanes (more than half the warps the
    card keeps resident, where a warp shares the walks of up to 16 shadow
    rays; the others launch a tenth of them, at most 2); each call counts
    one launch."""
    sargs, skw, extra = _b3_inputs(arm, card, inst_card, monkeypatch)
    sargs = _b3_case(case, sargs)
    if case == "unaligned":
        assert sargs[8][0].data_ptr() % 16 == 4
    key = ptf.launch_key("shadow_resolve", ptf.table_layout(
        sargs[0], skw.get("ents"), skw.get("fused_nn", 0),
        skw.get("width", 8)), inst=arm == "instance",
        leaf=ptf.leaf_arm(occl_rows=skw.get("occl_rows", 1),
                          occl_width=skw.get("width", 8) if skw["occl"]
                          else 8))
    before = _launched(key)
    got = [mk.shadow_resolve(*sargs, **skw)
           for _ in range(2 if case == "twice" else 1)]
    assert _launched(key) == before + len(got)
    ref = mk.shadow_resolve_reference(*sargs[1:], **extra)
    ptf.check_status("cuda")
    for g in got:
        _all_bitwise(g, ref)
    live = int(((sargs[7] >> 2) & 1).sum())
    assert (live == 0) == (case == "all_dead")
    if case == "all_dead":
        _all_bitwise(got[0], sargs[8])


@pytest.fixture()
def lab_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cpugpupathtracing_tpu_torch.labs import bounce_fan
    return bounce_fan, bounce_fan.make_fan("cuda", W, H, scene=_card_scene())


@pytest.mark.parametrize("lab", ["L1", "L2", "L3", "L4", "L6", "L7"])
def test_lab_kernels_match_plain(lab_card, lab):
    """Every arm of the traversal lab on the card's bounce fan: the kernel
    equals its plain version bitwise on every output (t, hit, object, L6's
    depth, the per-tile trip counters -- L1's and L2's per-ray sums --, the
    count launch's work and rows read), its hits equal
    traverse_packet_slim's (but for L6's fma arm, whose planes are not
    B4's, and leaf skip, which finds none), and each launch is counted.
    L1's and L2's warp trips are their schedule's (warps refill finished
    rays): at least the rays' trips over 32."""
    bf, fan = lab_card
    for arm in (a for a in bf.ARMS if a.kernel == lab):
        before = _launched(bf.arm_key(arm))
        got = bf.call(fan, arm, count_rows=True)
        assert _launched(bf.arm_key(arm)) == before + 1
        ref = bf.plain(fan, arm, fan.rays, fan.t_init, fan.active,
                       count_rows=True)
        ptf.check_status("cuda")
        assert len(got) == len(ref)
        if lab in bf.PER_RAY:
            assert 32 * int(got[-1][-1]) >= int(got[3].sum()) > 0
            got = got[:-1] + (got[-1][:-1],)
            ref = ref[:-1] + (ref[-1][:-1],)
        for a, b in zip(got, ref):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), arm.label
        if arm.hits == "equal":
            assert bf.hit_mismatches(fan, arm, got) == 0, arm.label
        assert bf.trips(arm, got)[0] > 0


@pytest.mark.parametrize("lab", ["L1", "L2"])
def test_lab2_refill_matches_plain_on_ragged_lanes(lab_card, lab):
    """L1 and L2 over the fan's lanes repeated until the active rays are
    three times the threads the card keeps resident, less 9 lanes (not a
    multiple of 32, the last warp's lanes partly inactive, t_init
    different on every lane): the warps' first hand-out leaves rays on the
    list, so lanes take a new ray while the rest of their warp walks.
    Every output bitwise the plain version's but the schedule's warp
    trips."""
    from cpugpupathtracing_tpu_torch.labs import kernel_lab2 as l2

    bf, fan = lab_card
    arms = [a for a in bf.ARMS if a.kernel == lab]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # 128 threads a block (csrc/lab_device.cuh lab::kBlock)
    resident = max(sms * l2.occupancy(lab, **a.kw) * 128 for a in arms)
    reps = -(-3 * resident // int(fan.active.sum()))
    rays = tuple(c.repeat(reps)[:-9].contiguous() for c in fan.rays)
    act = fan.active.repeat(reps)[:-9].contiguous()
    act[-20:-3] = False
    n = act.numel()
    assert n % 32 and int(act.sum()) > 2 * resident
    gen = torch.Generator(device="cuda").manual_seed(5)
    t0 = torch.rand(n, device="cuda", generator=gen) * 40.0 + 1.0
    for arm in arms:
        ref = bf.plain(fan, arm, rays, t0, act, count_rows=True)
        got = bf.call(fan, arm, rays, t0, act, count_rows=True)
        ptf.check_status("cuda")
        assert 32 * int(got[-1][-1]) >= int(got[3].sum()) > 0
        for a, b in zip(got[:-1] + (got[-1][:-1],),
                        ref[:-1] + (ref[-1][:-1],)):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), arm.label


def test_lab_dual_takes_the_pair_max(lab_card):
    """L7's counter per pair of tiles is the sum over its warps of the max
    of the two L6 (ilv, fixed) warps each pairs."""
    from cpugpupathtracing_tpu_torch.labs import kernel_lab as kl

    bf, fan = lab_card
    got = kl.traverse_lab_dual(fan.rays[:3], fan.rays[3:], fan.t_init,
                               fan.nodes, fan.ltris, fan.roots,
                               active=fan.active)
    l6 = kl.traverse_lab_reference(fan.rays, fan.t_init, fan.nodes,
                                   fan.ltris, fan.roots, active=fan.active,
                                   slab="ilv", leaf="ilv", order="fixed",
                                   warp_trips=True)
    assert torch.equal(got[4], kl.pair_trips(l6[-1], fan.t_init.numel()))


def test_lab_sweep_reciprocal_is_exact(card):
    """The slab-skip sweep's reciprocal (csrc/kernel_lab.cu rcp_fast)
    equals 1.0f / x bitwise on every f32 of its range."""
    from cpugpupathtracing_tpu_torch.labs import kernel_lab as kl

    bad, tested = kl.rcp_check(torch.device("cuda"))
    assert bad == 0 and tested == 2 * (251 * 2 ** 23)


@pytest.mark.parametrize("scale", [1e19, 3e19])
def test_lab_sweep_slow_rows_match_plain(lab_card, scale):
    """A leaf record whose determinants pass the sweep's fast reciprocal
    (|det| >= 2^126, some infinite at 3e19): the slab-skip arm's rows that
    hold it are tested again exactly, every output bitwise its plain
    version's."""
    bf, fan = lab_card
    arm = next(a for a in bf.ARMS if a.kw.get("slab") == "skip")
    lt = fan.ltris.clone()
    lt[0, 3:9] *= scale
    case = fan._replace(ltris=lt)
    got = bf.call(case, arm, count_rows=True)
    ref = bf.plain(case, arm, case.rays, case.t_init, case.active,
                   count_rows=True)
    for a, b in zip(got, ref):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_floor_probe_matches_plain(lab_card):
    """Every stage set of L5 on the fan's rays and random 64-row tables at
    16 trips: t and the final entry bitwise against the plain version."""
    from cpugpupathtracing_tpu_torch.labs import floor_probe as fp

    _, fan = lab_card
    rng = np.random.default_rng(0)
    nodes = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    ltris = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    nodes, ltris = nodes.cuda(), ltris.cuda()
    for stages in fp.STAGE_SETS:
        got = fp.floor_probe(stages, nodes, ltris, fan.rays, k_iters=16)
        ref = fp.floor_probe_reference(stages, nodes, ltris, fan.rays,
                                       k_iters=16)
        assert torch.equal(got[0].view(torch.int32),
                           ref[0].view(torch.int32)), stages
        assert torch.equal(got[1], ref[1]), stages
        assert _launched(fp.launch_key(stages)) >= 1


def test_launch_and_smem_probes(card):
    from cpugpupathtracing_tpu_torch.labs import launch_probe as lp
    from cpugpupathtracing_tpu_torch.labs import smem_probe as sp

    x = torch.randn(1024, device="cuda")
    assert torch.equal(lp.trivial(x), x * 2)
    assert torch.equal(lp.trivial2(x), x * 4)
    dev = torch.device("cuda")
    optin = sp.optin_bytes(dev)
    for words in (1024, optin // 4, optin // 4 + 1):
        res = sp.probe(words, False, dev, optin)
        assert res["ok"] == (words * 4 <= optin)
    assert sp.probe(optin // 4 // 8 * 8, True, dev, optin)["ok"]
    # a launch after the refusal
    assert sp.probe(1024, False, dev, optin)["value"] == 1019


@pytest.mark.parametrize("n", [0, 1, 3, 1023, 1024, 1025, 4099, "x[1:]"])
def test_launch_probe_shapes(card, n):
    """L8's 16-byte vector kernel with its scalar head and tail equals x * 2
    (and two chained launches x * 4) bitwise at every size, and on a view
    one element into its storage (input and output aligned apart)."""
    from cpugpupathtracing_tpu_torch.labs import launch_probe as lp

    x = (torch.randn(1025, device="cuda")[1:] if n == "x[1:]"
         else torch.randn(n, device="cuda"))
    assert torch.equal(lp.trivial(x), x * 2)
    assert torch.equal(lp.trivial2(x), x * 4)


@pytest.mark.parametrize("words", ["tail", "limit", "limit+1"])
def test_smem_probe_staging(card, words):
    """L9 stages its table by 16-byte asynchronous copies: config 3's
    entry mirror plus one word (a scalar tail of 1) and the opt-in limit
    read the right word in 1-D and 2-D (whole rows of 8), one word more
    is refused; a table that is not 16-byte aligned raises."""
    from cpugpupathtracing_tpu_torch.labs import smem_probe as sp

    dev = torch.device("cuda")
    optin = sp.optin_bytes(dev)
    limit = optin // 4
    n = {"tail": sp.CONFIG3_ROWS * 8 + 1, "limit": limit,
         "limit+1": limit + 1}[words]
    res = sp.probe(n, False, dev, optin)
    assert res["ok"] == (words != "limit+1")
    if res["ok"]:
        assert res["value"] == res["expected"]
        assert sp.probe(n // 8 * 8, True, dev, optin)["ok"]
        tab = torch.arange(n + 1, dtype=torch.int32, device=dev)
        idx = torch.zeros(1, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="16-byte"):
            sp.smem_probe(tab[1:], idx)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("walk", ["wide", "skip", "binary"])
def test_walks_graphs_match_host_launched(card, walk, any_hit, monkeypatch):
    """The XLA walks on the card (Scene(traversal=...), no kernel): the
    steps replayed from CUDA graphs equal the host-launched steps bitwise
    on every field of intersect_scene, also on a second call (the
    snapshot's cached graphs), and the closest hits' t equals brute
    force's."""
    from cpugpupathtracing_tpu_torch.models import scene as scenelib
    from cpugpupathtracing_tpu_torch.ops import intersect as isect
    from cpugpupathtracing_tpu_torch.ops import traverse as trav

    _, o, d, _ = card
    s = _card_scene()
    s.traversal = walk
    ds = s.build_device("cuda")
    assert ds.traversal == walk
    n = o.shape[0]
    t0 = torch.where(torch.arange(n, device="cuda") % 3 == 0, 4.0, 1e34)
    act = torch.arange(n, device="cuda") % 5 != 0
    runs, cached = [], []
    for graph_max in (0, trav.GRAPH_MAX_LANES, trav.GRAPH_MAX_LANES):
        monkeypatch.setattr(trav, "GRAPH_MAX_LANES", graph_max)
        trav.reset_stats()
        runs.append(scenelib.intersect_scene(ds, o, d, t0, active=act,
                                             any_hit=any_hit)[:6])
        assert (trav.stats["replays"] > 0) == (graph_max > 0)
        cached.append((trav.stats["captures"], len(ds.walk_graphs)))
    # the graphs are the snapshot's: none host-launched, captured on the
    # first graph run, reused on the second, none on a new snapshot
    k = cached[1][1]
    assert cached == [(0, 0), (k, k), (0, k)] and k > 0, cached
    assert not s.build_device("cuda").walk_graphs
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b)
    if not any_hit:
        tr = ds.tris9
        bt, _ = isect.brute_force_nearest_triangle(
            o, d, tr[:, 0:3], tr[:, 3:6], tr[:, 6:9], t0)
        mesh = act & (runs[1][2] == scenelib.PRIM_MESH) & (runs[1][1] >= 0)
        assert int(mesh.sum()) > 100
        assert torch.equal(runs[1][0][mesh].view(torch.int32),
                           bt[mesh].view(torch.int32))
