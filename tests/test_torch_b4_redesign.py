"""traverse_packet_slim's Hopper design (cpugpupathtracing_tpu_torch
csrc/traverse.cu: the closest hits over shading leaves walk with
postponed leaves, csrc/pt_device.cuh closest_hit's kPost; count launches
count their warp and lane trips) on the CPU, through the g++ build of
the kernel bodies (ops/pt_frame.py build_host), which runs a warp of one
lane: its vote is the lane's own predicate.

  * The postponed-leaf closest hits are bitwise brute force's (t, id,
    object, normal) and the slot-order walk's (B4's count_depth arm, the
    walk B4's closest hits took before), on the C2 rays that graze the
    ground quad's flat box (tests/test_torch_pt_redesign.py) and on
    camera and random rays of the icosphere scene under every node layout
    of the variant walks (64-col, 48-col with side tables, 16-wide,
    fused).
  * B4's trip counters per layout: lane trips <= 32 warp trips; a lane
    trip is one row visited (the slot-order walks: one per warp trip of a
    one-lane warp; the postponed walk: a trip that only parks a leaf
    visits none).

The card's side (sparse masks, launches past the most threads the card
keeps resident) is tests/test_torch_gpu.py's.  No JAX here: the
hits are held against the port's brute-force oracle, which the JAX
package's tests pin."""

import pytest
import torch

from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from tests.test_torch_pt_redesign import (  # noqa: F401 (fixtures)
    _bits,
    _layout_tables,
    c2,
    ico_rays,
)

LAYOUTS = ["64", "48", "w16", "fused"]


def _b4(tree, rays, **kw):
    """B4's g++ body on the rays with t_init RAY_TMAX: (t, id, object, nx,
    ny, nz[, counters])."""
    nodes, ltris, roots, lkw = tree
    n = rays[0].shape[0]
    res = tps.traverse_packet_slim_host(
        rays[:3], rays[3:], torch.full((n,), ptf.RAY_TMAX), nodes, ltris,
        roots, **lkw, **kw)
    return (res[0], res[1], res[2], *res[3]) + tuple(res[5:])


@pytest.fixture(scope="module")
def ico_tables():
    """The icosphere scene's shading tree under each layout."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for layout in LAYOUTS:
            dev, nodes, ltris, lkw = _layout_tables(mp, layout)
            out[layout] = (dev, (nodes, ltris, dev.proots, lkw))
    return out


@pytest.mark.parametrize("case", ["c2"] + [f"ico_{k}" for k in LAYOUTS])
def test_postponed_hits_bitwise(case, c2, ico_rays, ico_tables):
    """Closest hits with postponed leaves equal brute force and the
    slot-order walk bitwise."""
    if case == "c2":
        dev, rays = c2
        tree = (dev.pnodes, dev.pltris, dev.proots, {})
    else:
        dev, tree = ico_tables[case[4:]]
        rays = ico_rays
    post = _b4(tree, rays, count_depth=False)
    slot = _b4(tree, rays, count_depth=True)
    brute = ptf.closest_hit_reference(dev.pltris, rays)
    assert int((brute[1] >= 0).sum()) > rays[0].shape[0] // 4
    for a, b, c in zip(_bits(post), _bits(slot), _bits(brute)):
        assert torch.equal(a, c)
        assert torch.equal(b, c)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_b4_trip_counters(layout, ico_rays, ico_tables):
    """count_iters' warp and lane trips of B4's walks: the postponed-leaf
    closest hit, the slot-order closest hit (count_depth) and the any hit
    toward a light.  Lane trips <= 32 warp trips; a lane trip is one node
    or leaf row visited."""
    dev, tree = ico_tables[layout]
    n = ico_rays[0].shape[0]
    light = dev.mk_lights[0, :3]
    to_l = light[None, :] - torch.stack(ico_rays[:3], dim=1)
    to_l = to_l / torch.sqrt((to_l * to_l).sum(dim=1))[:, None]
    shadow = ico_rays[:3] + tuple(to_l[:, k].contiguous() for k in range(3))
    for rays, kw in ((ico_rays, dict(count_depth=False)),
                     (ico_rays, dict(count_depth=True)),
                     (shadow, dict(any_hit=True, count_depth=False))):
        it = dict(zip(ptf.COUNTERS,
                      (int(v) for v in _b4(tree, rays, count_iters=True,
                                           **kw)[-1])))
        assert it["ray"] == n and it["wtrip"] > 0
        assert it["ltrip"] <= 32 * it["wtrip"]
        assert it["ltrip"] == it["node"] + it["leaf"]
        if kw.get("count_depth") or kw.get("any_hit"):
            assert it["ltrip"] == it["wtrip"]
        else:
            assert it["ltrip"] <= it["wtrip"]
