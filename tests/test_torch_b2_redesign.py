"""shade_extend's Hopper design (cpugpupathtracing_tpu_torch
csrc/megakernel.cu: at every depth the closest hits over shading leaves
without instances walk with postponed leaves, csrc/pt_device.cuh
closest_hit's kPost, and the leaf-14 and instance arms in slot order;
count launches count their warp and lane trips) on the CPU, through the
g++ build of the kernel bodies (ops/megakernel.py shade_extend_host),
which runs a warp of one lane: its vote is the lane's own predicate.
(The columns' streaming loads and stores are plain ones on the host.)

  * On the C2 rays that graze the ground quad's flat box
    (tests/test_torch_pt_redesign.py) and on the icosphere scene's camera
    and random rays under every node layout of the walks (64-col, 48-col
    with side tables, 16-wide, fused), with dead lanes mixed in (single
    lanes and whole warps), the postponed-leaf walk at depths 1 and 4
    equals the plain version: flags and RNG state exactly, the hit points
    (next origins, shadow origins) bitwise on every lane, the other ray,
    throughput and shadow columns bitwise on every dead lane and on all
    but a few live ones (glibc's and torch's sin / cos round apart on a
    few percent of arguments), energy under the megakernel contract.
  * The count arm of the postponed-leaf walk and of the leaf-14 arm's
    slot-order walk: lane trips <= 32 warp trips, a lane trip one row
    visited, and the live lanes the rays traced.

The card's side (all-dead wavefronts, a dead tail, one live lane in 32,
ragged n, the instance and leaf-14 arms) is tests/test_torch_gpu.py's.
No JAX here: the plain version is the port's, which
tests/test_torch_megakernel.py holds against JAX."""

import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu_torch.config import RenderSettings
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.ops import megakernel as tmk
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.utils import rng as rnglib
from tests.test_megakernel import _check
from tests.test_torch_b4_redesign import LAYOUTS
from tests.test_torch_pt_redesign import (  # noqa: F401 (fixtures)
    _bits,
    _ico_scene,
    _layout_tables,
    c2,
    ico_rays,
)
from tests.test_torch_variants import FLAG_VARS


class _Traced:
    def __init__(self, e):
        self.energy, self.traced_rays = e, 0


@pytest.fixture(scope="module")
def ico_scenes():
    """The icosphere scene's snapshot under each node layout."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for layout in LAYOUTS:
            dev, _, _, _ = _layout_tables(mp, layout)
            out[layout] = dev
    return out


@pytest.fixture(scope="module")
def ico_leaf14():
    """The icosphere scene's snapshot with the leaf-14 payload rows
    (CPUGPU_LEAF14): shade_extend's slot-order arm."""
    with pytest.MonkeyPatch.context() as mp:
        for k in FLAG_VARS:
            mp.delenv(k, raising=False)
        mp.setenv("CPUGPU_LEAF14", "1")
        mp.setenv("CPUGPU_SMEMTREE_MIN_NODES", "1")
        dev = _ico_scene().build_device("cpu")
    assert dev.poccl_pay is not None
    return dev


def _carry(n, seed):
    """A wavefront's carry after a bounce: throughput and energy made with
    numpy from `seed`; flags with specular bits, single dead lanes and
    whole dead warps of 32."""
    rng = np.random.default_rng(seed)
    tp = tuple(torch.from_numpy(rng.uniform(0.2, 1.0, n).astype(np.float32))
               for _ in range(3))
    en = tuple(torch.from_numpy(rng.uniform(0.0, 0.5, n).astype(np.float32))
               for _ in range(3))
    live = rng.uniform(size=n) > 0.3
    live[32:96] = False
    spec = rng.integers(0, 2, n)
    flags = torch.from_numpy((live | (spec << 1)).astype(np.int32))
    return tp, en, flags


def _extend(dev, rays, depth, count_iters=False, seed=3):
    n = rays[0].shape[0]
    tables, tkw = tint.route_tables(dev)
    kw = dict(tint.extend_kwargs(dev, RenderSettings()), **tkw)
    st = rnglib.seed_lanes(torch.arange(n), 0, salt=0x5151)
    args = (*tables, depth, rays, st, *_carry(n, seed))
    host = tmk.shade_extend_host(*args, count_iters=count_iters, **kw)
    return host, tmk.shade_extend(*args, **kw), args


def _flat(out):
    rays, st, tp, en, fl, so, sd, stmax, contrib = out[:9]
    return dict(rays=list(rays), state=[st], tp=list(tp), flags=[fl],
                shadow=[*so, *sd, stmax, *contrib], energy=list(en))


def _same(host, plain, flags):
    """host against plain: flags and state exact; the hit points (next
    origins, shadow origins) bitwise on every lane; rays, throughput and
    shadow columns bitwise on the dead lanes and on all but a few live
    ones (glibc's and torch's sin / cos round apart on a few percent of
    arguments); energy under the megakernel contract."""
    h, p = _flat(host), _flat(plain)
    assert torch.equal(h["flags"][0], p["flags"][0])
    assert torch.equal(h["state"][0], p["state"][0])
    # the next origins and the shadow rays' origins are the hit points,
    # which no transcendental touches: bitwise on every lane
    for a, b in zip(_bits(h["rays"][:3] + h["shadow"][:3]),
                    _bits(p["rays"][:3] + p["shadow"][:3])):
        assert torch.equal(a, b)
    dead = (flags & 1) == 0
    off = torch.zeros_like(dead)
    for key in ("rays", "tp", "shadow", "energy"):
        for a, b in zip(_bits(h[key]), _bits(p[key])):
            assert torch.equal(a[dead], b[dead]), key
            off |= a != b
    assert float(off.float().mean()) < 0.05
    _check(_Traced(torch.stack(p["energy"], 1)),
           _Traced(torch.stack(h["energy"], 1)), True)


@pytest.mark.parametrize("case", ["c2"] + [f"ico_{k}" for k in LAYOUTS])
def test_postponed_arm_matches_plain(case, c2, ico_rays, ico_scenes):
    """At depths 1 and 4, the g++ lane body of the postponed-leaf walk on
    live and dead lanes equals the plain version (_same)."""
    dev, rays = c2 if case == "c2" else (ico_scenes[case[4:]], ico_rays)
    if case != "c2":
        tables, tkw = tint.route_tables(dev)
        assert ptf.table_layout(tables[0], tkw["ents"], tkw["fused_nn"],
                                tkw["width"]) == case[4:]
    post, plain, args = _extend(dev, rays, 1)
    flags = args[-1]
    assert int((flags & 1).sum()) > rays[0].shape[0] // 2
    _same(post, plain, flags)
    assert int(((plain[4] >> 2) & 1).sum()) > rays[0].shape[0] // 8
    post4, plain4, _ = _extend(dev, rays, 4)
    _same(post4, plain4, flags)


@pytest.mark.parametrize("arm", ["slot", "postponed"])
def test_count_arm_trips(arm, ico_rays, ico_scenes, ico_leaf14):
    """shade_extend's count arm on the host build, on the leaf-14 arm's
    slot-order walk and on the postponed-leaf walk: trips counted (lane
    trips <= 32 warp trips, a lane trip one row visited; the slot-order
    walk's one-lane warps visit a row every trip), the rays its live lanes
    traced."""
    dev = ico_leaf14 if arm == "slot" else ico_scenes["48"]
    host, _, args = _extend(dev, ico_rays, 1, count_iters=True)
    it = dict(zip(ptf.COUNTERS, (int(v) for v in host[-1])))
    assert it["ray"] == int((args[-1] & 1).sum())
    assert it["wtrip"] > 0
    assert it["ltrip"] <= 32 * it["wtrip"]
    assert it["ltrip"] == it["node"] + it["leaf"]
    if arm == "slot":
        assert it["ltrip"] == it["wtrip"]
    else:
        assert it["ltrip"] <= it["wtrip"]
