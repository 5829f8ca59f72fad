"""pt_frame's Hopper design (cpugpupathtracing_tpu_torch csrc/pt_frame.cu:
persistent warps that refill finished paths, whose walks count their
warp and lane trips under count_iters) and the conservative slab test
that every walk of the port shares (csrc/pt_device.cuh slab_hit; ROADMAP
C2), on the CPU through the g++ build of the kernel bodies
(ops/pt_frame.py build_host) and the plain versions.

  * C2: rays from (0, 0.5, 6) that meet tests/test_megakernel.py's ground
    quad at its edge x = -50 graze the edge of the quad's flat box.  Both
    walks -- the kernels' walk (the g++ build) and the plain walk
    traverse_walk_reference -- find their hits bitwise as brute force
    does.  Without the margin (slab_pad = 1, the slab test before the
    repair) the plain walk loses the floor on a pinned one of them, so
    the margin is what keeps it.  pt_frame's body on those rays keeps the
    plain version's traced counts and states.
  * count_iters' trip counters of pt_frame's body on an icosphere scene,
    per node layout (the plain arm and the variant walks): lane trips <=
    32 warp trips, and a lane trip is one visit of a node or leaf row.

No JAX here: C2 is a fault of the port's walks against the port's own
brute-force oracle (the JAX packet walk shares the slab arithmetic, a
recorded departure, ROADMAP C).  The card's side (lanes refilled past
the resident threads) is tests/test_torch_gpu.py's."""

import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu_torch.config import CameraConfig, RenderSettings
from cpugpupathtracing_tpu_torch.models import camera as camlib
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from cpugpupathtracing_tpu_torch.utils import rng as rnglib
from tests.test_megakernel import _check
from tests.test_torch_scene import megakernel_scene
from tests.test_torch_variants import FLAG_VARS, LAYOUT_ENV

# the C2 rays: from the camera at (0, 0.5, 6) toward (-50, -2, z), the
# quad's edge, for z across it; the pinned one first misses in the walk
# without the margin
C2_ORIGIN = (0.0, 0.5, 6.0)
C2_Z = np.linspace(-49.9, 5.9, 2001).astype(np.float32)
C2_PINNED = 31
W, H = 96, 54


def _rays_to(o, targets):
    """Rays from o toward each target, directions normalised in f32: 6
    (N,) f32 columns."""
    d = targets - np.asarray(o, np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    n = targets.shape[0]
    return tuple(torch.full((n,), float(c), dtype=torch.float32)
                 for c in o) + tuple(torch.from_numpy(d[:, k].copy())
                                     for k in range(3))


@pytest.fixture(scope="module")
def c2():
    """tests/test_megakernel.py's scene (the port's build, plain tables)
    and the C2 rays."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CPUGPU_SMEMTREE", "0")
        dev = megakernel_scene(tscene, tmat, tmesh).build_device("cpu")
    tgt = np.stack([np.full_like(C2_Z, -50.0), np.full_like(C2_Z, -2.0),
                    C2_Z], axis=1)
    return dev, _rays_to(C2_ORIGIN, tgt)


def _bits(cols):
    return [c.view(torch.int32) if c.dtype == torch.float32 else c
            for c in cols]


def _walk(dev, rays, slab_pad=ptf.SLAB_PAD):
    """traverse_walk_reference's closest hits: (t, id, object, nx, ny,
    nz)."""
    n = rays[0].shape[0]
    res = tps.traverse_walk_reference(
        rays, torch.full((n,), ptf.RAY_TMAX, dtype=torch.float32),
        dev.pnodes, dev.pltris, dev.proots, slab_pad=slab_pad)
    return (res[0], res[1], res[2], *res[3])


@pytest.mark.parametrize("walk", ["slot", "plain_walk"])
def test_c2_grazing_rays_keep_their_hits(c2, walk):
    """Every walk's closest hits on the C2 rays equal brute force's,
    bitwise; the pinned ray hits the floor there."""
    dev, rays = c2
    brute = ptf.closest_hit_reference(dev.pltris, rays)
    if walk == "plain_walk":
        got = _walk(dev, rays)
    else:
        # the kernels' slot-order walk: B4's count_depth arm (its closest
        # hits without count_depth walk with postponed leaves,
        # tests/test_torch_b4_redesign.py)
        n = rays[0].shape[0]
        res = tps.traverse_packet_slim_host(
            rays[:3], rays[3:], torch.full((n,), ptf.RAY_TMAX), dev.pnodes,
            dev.pltris, dev.proots, count_depth=True)
        got = (res[0], res[1], res[2], *res[3])
    assert int((brute[1] >= 0).sum()) > 1500
    floor_obj = int(brute[2][C2_PINNED])
    assert floor_obj >= 0 and bool((brute[2] == floor_obj).sum() > 1000)
    for a, b in zip(_bits(got), _bits(brute)):
        assert torch.equal(a, b)


def test_c2_margin_keeps_the_floor(c2):
    """Without the margin (the slab test before the repair) the plain
    walk loses the floor on the pinned ray, and on 277 of the 2001: they
    graze the flat box's edge.  With it, the walk agrees with brute
    force."""
    dev, rays = c2
    brute = ptf.closest_hit_reference(dev.pltris, rays)
    assert int(brute[1][C2_PINNED]) >= 0
    old = _walk(dev, rays, slab_pad=1.0)
    assert int(old[1][C2_PINNED]) == -1
    assert int((old[1] != brute[1]).sum()) == 277
    assert torch.equal(_walk(dev, rays)[1], brute[1])


def test_c2_pt_frame_body_on_grazing_rays(c2):
    """pt_frame's g++ body on the C2 rays against its plain version: traced
    and RNG states exact, energy under the megakernel contract (glibc's
    and torch's sin/cos differ by ULPs)."""
    dev, rays = c2
    n = rays[0].shape[0]
    st = rnglib.seed_lanes(torch.arange(n), 0, salt=0x7777)
    kw = tint.frame_kwargs(dev, RenderSettings(max_ray_depth=1))
    host = ptf.pt_frame_host(*dev.tables(), rays, st, depths=2, **kw)
    plain = ptf.pt_frame(*dev.tables(), rays, st, depths=2, **kw)
    assert int(host[2]) == int(plain[2])
    assert torch.equal(host[1], plain[1])

    class Traced:
        def __init__(self, e, t):
            self.energy, self.traced_rays = e, t

    _check(Traced(plain[0], plain[2]), Traced(host[0], host[2]), True)


def _ico_scene():
    """An icosphere of 1280 triangles in glass over the ground quad, a
    mirror sphere, a back wall and two sphere lights."""
    s = tscene.Scene()
    white = s.add_material(tmat.Material.diffuse((0.8, 0.8, 0.8)))
    glass = s.add_material(tmat.Material.dielectric(
        (0.9, 0.9, 0.9), 0.1, 0.8, (0.1, 0.2, 0.2), 1.5))
    light = s.add_material(tmat.Material.light((1.0, 0.95, 0.8), 10.0))
    s.add_mesh("ball", tmesh.icosphere(radius=1.5, subdivisions=3), glass)
    s.add_mesh("floor", tmesh.ground_quad(half_extent=50.0, y=-2.0), white)
    s.add_plane("backwall", (0.0, 0.0, -12.0), (0.0, 0.0, 1.0), white)
    for k, c in enumerate([(6.0, 6.0, 6.0), (-6.0, 6.0, -4.0)]):
        s.mark_light(s.add_sphere(f"light{k}", c, 2.0, light))
    return s


@pytest.fixture(scope="module")
def ico_rays():
    """96x54 camera rays at the icosphere (camera at x = 0.05, off the
    scene's plane of symmetry) and 2048 random rays from around it."""
    cam = camlib.to_arrays(CameraConfig(pos=(0.05, 0.5, 5.0),
                                        aspect=W / H), "cpu")
    o, d = camlib.lane_rays(cam, torch.arange(W * H), W, H)
    rng = np.random.default_rng(5)
    ro = rng.uniform(-3, 3, (2048, 3)).astype(np.float32)
    rd = (rng.normal(size=(2048, 3)) - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = torch.cat([o, torch.from_numpy(ro)])
    d = torch.cat([d, torch.from_numpy(rd)])
    return tuple(o[:, k].contiguous() for k in range(3)) + tuple(
        d[:, k].contiguous() for k in range(3))


def _layout_tables(mp, layout):
    for k in FLAG_VARS:
        mp.delenv(k, raising=False)
    for k, v in LAYOUT_ENV[layout].items():
        mp.setenv(k, v)
    mp.setenv("CPUGPU_SMEMTREE_MIN_NODES", "1")
    dev = _ico_scene().build_device("cpu")
    nodes, ltris, fused_nn, ents = tscene.packet_tables(dev)
    assert ptf.table_layout(nodes, ents, fused_nn, dev.packet_width) == layout
    return dev, nodes, ltris, dict(ents=ents, fused_nn=fused_nn,
                                   width=dev.packet_width)


@pytest.mark.parametrize("layout", ["64", "48", "w16", "fused"])
def test_trip_counters(ico_rays, layout, monkeypatch):
    """count_iters' warp and lane trips of pt_frame's walks, in the plain
    arm (64) and the variant walks: a lane trip per node or leaf row
    visited (closest-hit and shadow walks), at most 32 per warp trip (the
    host build runs warps of one lane, so there the two are equal)."""
    dev, nodes, _, _ = _layout_tables(monkeypatch, layout)
    n = ico_rays[0].shape[0]
    st = rnglib.seed_lanes(torch.arange(n), 0, salt=0x7777)
    tables, kw = tint.frame_args(dev, RenderSettings(max_ray_depth=2))
    assert nodes.shape[0] > 16
    assert ptf.table_layout(tables[0], kw.get("ents"), kw.get("fused_nn", 0),
                            kw.get("width", 8)) == layout
    out = ptf.pt_frame_host(*tables, ico_rays, st, depths=3,
                            count_iters=True, **kw)
    it = dict(zip(ptf.COUNTERS, (int(v) for v in out[-1])))
    assert it["wtrip"] > 0
    assert it["ltrip"] <= 32 * it["wtrip"]
    assert it["ltrip"] == it["node"] + it["leaf"] + it["snode"] + it["sleaf"]
    assert it["ray"] + it["sray"] == int(out[2])
