"""shadow_resolve's Hopper design (cpugpupathtracing_tpu_torch
csrc/megakernel.cu: one thread per lane; a warp with few shadow rays
walks each with all its lanes, a warp with more walks one per lane with
the occlusion rows read as 16-byte vectors, csrc/pt_device.cuh
occl_row_any_vec; count launches count their warp and lane trips and
the longest walk) on the CPU, through the g++ build of the lane body
(ops/megakernel.py shadow_resolve_host), which runs one lane at a time:
the lane's own walk (the warp-wide walk needs a card).

  * On the icosphere scene's camera and random rays, after one plain
    shade_extend at depth 1 over a carry with dead lanes mixed in (single
    lanes and whole warps), every arm's energy equals the plain version
    bitwise: the any-hit tree's 1-row and 2-row occlusion leaves
    (CPUGPU_OCCL2) and its 16-wide rows (CPUGPU_OCCL_W16), and the
    shading tree (CPUGPU_OCCL=0) under every node layout.
  * The vector reads of occlusion rows, record by record: a short shadow
    ray into every record of every occlusion row (records 12 and 13, in
    the row's last five vectors, among them) is occluded, one out of it
    is not, as brute force says.
  * The count arm: lane trips <= 32 warp trips, a lane trip one row
    visited, and the longest walk the most rows one lane's walk visits
    when it runs alone.

The card's side (the warp-wide walks; all-dead wavefronts, dead tails,
one shadow ray in 32, ragged n, unaligned columns, launches in a row,
more lanes than the card keeps resident) is tests/test_torch_gpu.py's.
No JAX here: the plain version is the port's, which
tests/test_torch_megakernel.py holds against JAX."""

import pytest
import torch

from cpugpupathtracing_tpu_torch.config import RenderSettings
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.ops import megakernel as tmk
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.utils import rng as rnglib
from tests.test_torch_b2_redesign import _carry
from tests.test_torch_pt_redesign import (  # noqa: F401 (fixtures)
    _ico_scene,
    ico_rays,
)
from tests.test_torch_variants import FLAG_VARS, LAYOUT_ENV

# arm: the flags of its tables (the any-hit tree, or with CPUGPU_OCCL=0
# the shading tree in a node layout of tests/test_torch_b4_redesign.py's
# LAYOUTS)
ARMS = {
    "occl_64": dict(CPUGPU_SMEMTREE="0"),
    "occl_48": {},
    "occl2": dict(CPUGPU_OCCL2="1"),
    "occl_w16": dict(CPUGPU_OCCL_W16="1"),
    **{f"shade_{k}": dict(LAYOUT_ENV[k], CPUGPU_OCCL="0")
       for k in ("64", "48", "w16", "fused")},
}
EXTRA_FLAGS = ("CPUGPU_OCCL2", "CPUGPU_OCCL_W16", "CPUGPU_LEAF14")


@pytest.fixture(scope="module")
def ico_arms():
    """The icosphere scene's snapshot under each arm's flags."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for arm, env in ARMS.items():
            for k in FLAG_VARS + EXTRA_FLAGS:
                mp.delenv(k, raising=False)
            for k, v in env.items():
                mp.setenv(k, v)
            mp.setenv("CPUGPU_SMEMTREE_MIN_NODES", "1")
            out[arm] = _ico_scene().build_device("cpu")
    return out


def _shadow_args(dev, rays):
    """shadow_resolve's arguments after one plain shade_extend at depth 1
    over _carry's lanes (dead lanes and whole dead warps among them)."""
    n = rays[0].shape[0]
    tables, tkw = tint.route_tables(dev)
    kw = dict(tint.extend_kwargs(dev, RenderSettings()), **tkw)
    st = rnglib.seed_lanes(torch.arange(n), 0, salt=0x5151)
    _, _, _, en, fl, so, sd, stmax, contrib = tmk.shade_extend(
        *tables, 1, rays, st, *_carry(n, 3), **kw)
    sh_nodes, sh_ltris, skw = tint.shadow_tables(dev)
    return (sh_nodes, sh_ltris, dev.mk_sph, dev.mk_pln, so, sd, stmax, fl,
            en, contrib), skw


def _bits(cols):
    return [c.view(torch.int32) for c in cols]


@pytest.mark.parametrize("arm", list(ARMS))
def test_arms_match_plain(arm, ico_arms, ico_rays):
    """Every arm's g++ lane body equals the plain version bitwise, on
    lanes with and without shadow rays."""
    dev = ico_arms[arm]
    args, skw = _shadow_args(dev, ico_rays)
    want = dict(occl=not arm.startswith("shade"),
                occl_rows=2 if arm == "occl2" else 1,
                width=16 if arm in ("occl_w16", "shade_w16") else 8)
    assert {k: skw.get(k, 1 if k == "occl_rows" else 8)
            for k in want} == want
    sneed = (args[7] >> 2) & 1
    n = sneed.shape[0]
    assert n // 8 < int(sneed.sum()) < n - n // 8
    assert int(sneed[32:96].sum()) == 0  # a dead run of two warps
    host = tmk.shadow_resolve_host(*args, **skw)
    plain = tmk.shadow_resolve(*args, **skw)
    for a, b in zip(_bits(host), _bits(plain)):
        assert torch.equal(a, b)
    # some lanes see their light, some are occluded
    lit = plain[0] != args[8][0]
    assert 0 < int(lit.sum()) < int(sneed.sum())


@pytest.mark.parametrize("rows", [1, 2])
def test_occlusion_rows_record_by_record(rows, ico_arms):
    """A short shadow ray into each record of each occlusion row (along
    its normal, 1e-3 to either side of its centroid) is occluded, and one
    pointing away is not, in the g++ body (the rows' 16-byte reads) as in
    the plain version; the records include every slot of a row, 12 and 13
    (the last five vectors) among them."""
    dev = ico_arms["occl2" if rows == 2 else "occl_48"]
    sh_nodes, sh_ltris, skw = tint.shadow_tables(dev)
    assert skw["occl"] and skw.get("occl_rows", 1) == rows
    rec = sh_ltris[:, :14 * 9].reshape(-1, 14, 9)
    real = (rec[:, :, 3:9] != 0).any(dim=2)
    slot = torch.arange(14).expand_as(real)[real]
    assert {12, 13} <= set(slot.tolist())
    v0, e1, e2 = rec[real][:, 0:3], rec[real][:, 3:6], rec[real][:, 6:9]
    nrm = torch.linalg.cross(e1, e2)
    nrm = nrm / torch.linalg.norm(nrm, dim=1, keepdim=True)
    mid = v0 + (e1 + e2) / 3.0
    h = 1e-3
    origin = torch.cat([mid + h * nrm, mid + h * nrm])
    direction = torch.cat([-nrm, nrm])
    m = origin.shape[0]
    one = torch.ones(m)
    args = (sh_nodes, sh_ltris, dev.mk_sph, dev.mk_pln,
            tuple(origin[:, k].contiguous() for k in range(3)),
            tuple(direction[:, k].contiguous() for k in range(3)),
            torch.full((m,), 2 * h), torch.full((m,), 5, dtype=torch.int32),
            (0 * one, 0 * one, 0 * one), (one, one, one))
    skw = dict(skw, num_sph=0, num_pln=0)
    host = tmk.shadow_resolve_host(*args, **skw)
    plain = tmk.shadow_resolve(*args, **skw)
    for a, b in zip(_bits(host), _bits(plain)):
        assert torch.equal(a, b)
    half = m // 2
    assert bool((plain[0][:half] == 0).all())
    assert bool((plain[0][half:] == 1).all())


@pytest.mark.parametrize("arm", ["occl_48", "occl2", "shade_w16"])
def test_count_arm(arm, ico_arms, ico_rays):
    """The count arm on the first 256 lanes: the shadow rays it walked,
    lane trips <= 32 warp trips and one per row visited, and the longest
    walk the most rows one of those lanes visits alone."""
    dev = ico_arms[arm]
    args, skw = _shadow_args(dev, ico_rays)

    def cut(x, ix):
        if isinstance(x, tuple):
            return tuple(cut(c, ix) for c in x)
        return x[ix].contiguous() if x.dim() == 1 else x

    args = args[:4] + tuple(cut(x, slice(0, 256)) for x in args[4:])

    def counts(a):
        out = tmk.shadow_resolve_host(*a, count_iters=True, **skw)
        return dict(zip(ptf.COUNTERS, (int(v) for v in out[-1])))

    it = counts(args)
    live = ((args[7] >> 2) & 1).nonzero().squeeze(1)
    assert it["sray"] == live.numel() > 16
    assert 0 < it["ltrip"] <= 32 * it["wtrip"]
    assert it["ltrip"] == it["snode"] + it["sleaf"] <= it["wtrip"]
    alone = [counts(args[:4] + tuple(cut(x, live[k:k + 1])
                                     for x in args[4:]))["ltrip"]
             for k in range(live.numel())]
    assert sum(alone) == it["ltrip"]
    assert it["longest"] == max(alone)
