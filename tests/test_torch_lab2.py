"""The traversal labs L1 and L2 of the port (cpugpupathtracing_tpu_torch
labs/kernel_lab2.py: traverse_lab2, traverse_lab2p, fuse_tables) against
the JAX package's tools/kernel_lab2.py and brute force, on the CPU (the
plain versions; the CUDA kernels are held against them bitwise on the
card by tests/test_torch_gpu.py and chip_smoke.py).

Inputs as tools/kernel_lab2.py _selfcheck makes them: an icosphere of
subdivisions 1 (the JAX package's bvh.build, SAH_SPLIT_INTERVALS, leaves
of 8, bvh8.collapse and to_slim), 1024 rays from numpy's default_rng(3)
toward a point near the centre, one root, and here 10% of the lanes
inactive.

Tolerances.  Against the JAX lab run in interpret mode (one run per lab,
each in a module fixture; its XLA compile is its whole cost): hit and
object bitwise on every lane, t within T_ULPS units in the last place on
every lane that hits (the interpret run is jitted, and XLA's CPU
compiler contracts the triangle test's multiply-adds into FMAs; 4 ULPs
seen).  Against brute force run op by op (jax.disable_jit(), no FMA): t,
id and object bitwise on every active lane -- the port takes the lowest
id on exact ties, as brute force does.  Between the port's arms: every
hit bitwise.  The trip counters are the card's schedule (32-lane warps)
and are not compared with the JAX lab's (8-row packets); the invariant
the JAX lab's own check asserts -- parent-pointer frames take exactly the
frame stack's trips -- is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.config import BuildOption
from cpugpupathtracing_tpu.models import bvh as jbvh
from cpugpupathtracing_tpu.models import bvh8 as jbvh8
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.ops import intersect as jisect
from cpugpupathtracing_tpu_torch.labs import common as cm
from cpugpupathtracing_tpu_torch.labs import kernel_lab2 as l2
from tools import kernel_lab as jlab
from tools import kernel_lab2 as jlab2

N = 1024
T_ULPS = 16
RAY_TMAX = 1e34


def _slim(center=(0.0, 0.0, 0.0)):
    m = jmesh.icosphere(center=center, subdivisions=1)
    b = jbvh.build(m.positions, m.normals, m.indices,
                   BuildOption.SAH_SPLIT_INTERVALS, max_leaf_size=8)
    return b, jbvh8.to_slim(jbvh8.collapse(b, leaf_max=8), b.tri_normal)


def _rays(n=N, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 4
    aim = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = rng.random(n) >= 0.1
    return o, d, act


def _brute(o, d, bvhs):
    """Op-by-op brute force over the triangles of `bvhs` in order: (t,
    global id)."""
    v0 = np.concatenate([b.tri_v0 for b in bvhs])
    e1 = np.concatenate([b.tri_v1 - b.tri_v0 for b in bvhs])
    e2 = np.concatenate([b.tri_v2 - b.tri_v0 for b in bvhs])
    with jax.disable_jit():
        t, idx = jisect.brute_force_nearest_triangle(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(e1),
            jnp.asarray(e2), jnp.full((len(o),), RAY_TMAX, jnp.float32))
    return np.asarray(t), np.asarray(idx)


def _two_spheres(b, s):
    """tools/kernel_lab2.py _selfcheck's two-root tables: a second sphere
    at x = 2.5, its table spliced after the first, ids made global."""
    b2, s2 = _slim(center=(2.5, 0.0, 0.0))
    nodes = np.concatenate([s.nodes, s2.nodes.copy()])
    ci2 = nodes[len(s.nodes):, 48:56].view(np.int32)
    cc2 = nodes[len(s.nodes):, 56:64].view(np.int32)
    ci2[cc2 == 0] += len(s.nodes)
    ci2[cc2 > 0] -= len(s.ltris)
    lt2 = s2.ltris.copy()
    ids = lt2.view(np.int32)[:, 13::16]
    ids[ids >= 0] += b.num_triangles
    return b2, nodes, np.concatenate([s.ltris, lt2]), (0, len(s.nodes))


@pytest.fixture(scope="module")
def case():
    b, s = _slim()
    o, d, act = _rays()
    b2, nodes2, ltris2, roots2 = _two_spheres(b, s)
    bt, bidx = _brute(o, d, [b])
    bt2, bidx2 = _brute(o, d, [b, b2])
    tt = torch.from_numpy
    return dict(
        b=b, s=s, o=o, d=d, act=act,
        rays=tuple(tt(np.ascontiguousarray(v[:, k])) for v in (o, d)
                   for k in range(3)),
        t0=torch.full((N,), RAY_TMAX, dtype=torch.float32),
        tact=tt(act), nodes=tt(s.nodes), ltris=tt(s.ltris),
        brute=(bt, bidx), two=(tt(nodes2), tt(ltris2), roots2),
        brute2=(bt2, bidx2))


def _jax_cols(c):
    o, d = c["o"], c["d"]
    return (tuple(jnp.asarray(o[:, k]) for k in range(3)),
            tuple(jnp.asarray(d[:, k]) for k in range(3)),
            jnp.full((N,), RAY_TMAX, jnp.float32),
            jnp.asarray(c["act"].astype(np.int32)))


@pytest.fixture(scope="module")
def jax_lab2(case):
    """L1 in interpret mode with every option on (frame stack, fused
    table, gated leaf phase, conditional push)."""
    un, nn = jlab.fuse_tables(case["s"].nodes, case["s"].ltris)
    oc, dc, t0, act = _jax_cols(case)
    out = jlab2.traverse_lab2(oc, dc, t0, jnp.asarray(un),
                              jnp.zeros((1, 128), jnp.float32), (0,),
                              active=act, nn=nn, frame_stack=True, fused=True,
                              gate_leaf=True, cond_push=True)
    return tuple(np.asarray(x) for x in out)


@pytest.fixture(scope="module")
def jax_lab2p(case):
    """L2 in interpret mode: frame stack, nearest first, parent frames."""
    un, nn = jlab.fuse_tables(case["s"].nodes, case["s"].ltris)
    oc, dc, t0, act = _jax_cols(case)
    out = jlab2.traverse_lab2p(oc, dc, t0, jnp.asarray(un),
                               jnp.zeros((1, 128), jnp.float32), (0,),
                               active=act, nn=nn, frame_stack=True,
                               nearest=True, parent=True)
    return tuple(np.asarray(x) for x in out)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _vs_jax(got, ref):
    t, hit, obj = (x.numpy() for x in got[:3])
    rt, rhit, robj = ref[:3]
    np.testing.assert_array_equal(hit, rhit)
    np.testing.assert_array_equal(obj, robj)
    assert (hit >= 0).sum() > N // 2  # most rays meet the sphere
    assert _ulps(t, rt).max() <= T_ULPS


def _vs_brute(c, got, brute, act=None):
    act = c["act"] if act is None else act
    t, hit, obj = (x.numpy() for x in got[:3])
    bt, bidx = brute
    np.testing.assert_array_equal(hit[act], bidx[act])
    np.testing.assert_array_equal(t[act].view(np.int32),
                                  bt[act].view(np.int32))
    np.testing.assert_array_equal(obj[act] >= 0, bidx[act] >= 0)
    # lanes that are not active keep t_init and ids -1
    assert (hit[~act] == -1).all() and (t[~act] == RAY_TMAX).all()


def _fused(c):
    return l2.fuse_tables(c["nodes"], c["ltris"])


def test_fuse_tables_bitwise(case):
    un, nn = jlab.fuse_tables(case["s"].nodes, case["s"].ltris)
    got, tnn = _fused(case)
    assert tnn == nn
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  un.view(np.int32))


def test_lab2_vs_jax_interpret(case, jax_lab2):
    table, nn = _fused(case)
    got = l2.traverse_lab2(case["rays"][:3], case["rays"][3:], case["t0"],
                           table, case["ltris"], (0,), active=case["tact"],
                           nn=nn, frame_stack=True, fused=True,
                           gate_leaf=True, cond_push=True)
    _vs_jax(got, jax_lab2)
    tiles = -(-N // cm.TILE)
    assert got[3].shape == (tiles,) and got[4].shape == (tiles,)
    assert 0 < int(got[4].sum()) < int(got[3].sum())


L1_ARMS = {
    "linear": {}, "fs": dict(frame_stack=True),
    "fs_condpush": dict(frame_stack=True, cond_push=True),
    "fs_fused": dict(frame_stack=True, fused=True),
    "fs_fused_gate": dict(frame_stack=True, fused=True, gate_leaf=True),
    "fused": dict(fused=True), "gate": dict(gate_leaf=True),
}


def _l1(c, kw, two=False):
    nodes, ltris, roots = c["two"] if two else (c["nodes"], c["ltris"], (0,))
    nn = 0
    if kw.get("fused"):
        nodes, nn = l2.fuse_tables(nodes, ltris)
    return l2.traverse_lab2(c["rays"][:3], c["rays"][3:], c["t0"], nodes,
                            ltris, roots, active=c["tact"], nn=nn,
                            count_rows=True, **kw)


@pytest.mark.parametrize("arm", list(L1_ARMS))
def test_lab2_arms_vs_brute_force(case, arm):
    got = _l1(case, L1_ARMS[arm])
    _vs_brute(case, got, case["brute"])
    base = _l1(case, {})
    for a, b in zip(got[:3], base[:3]):
        assert torch.equal(a, b)
    # the fused table changes no walk: the same trips and rows read as
    # the split tables under the same schedule
    if L1_ARMS[arm].get("fused"):
        split = _l1(case, {k: v for k, v in L1_ARMS[arm].items()
                           if k != "fused"})
        for a, b in zip(got, split):
            assert torch.equal(a, b)


@pytest.mark.parametrize("frame_stack", [False, True], ids=["linear", "fs"])
def test_lab2_two_roots(case, frame_stack):
    got = _l1(case, dict(frame_stack=frame_stack), two=True)
    _vs_brute(case, got, case["brute2"])


def test_lab2p_vs_jax_interpret(case, jax_lab2p):
    table, nn = _fused(case)
    got = l2.traverse_lab2p(case["rays"][:3], case["rays"][3:], case["t0"],
                            table, None, (0,), active=case["tact"], nn=nn,
                            frame_stack=True, nearest=True, parent=True)
    _vs_jax(got, jax_lab2p)


L2_ARMS = {
    "linear": dict(frame_stack=False), "fs": dict(frame_stack=True),
    "fs_near": dict(frame_stack=True, nearest=True),
    "fs_parent": dict(frame_stack=True, parent=True),
}


def _l2(c, kw, two=False):
    nodes, ltris, roots = c["two"] if two else (c["nodes"], c["ltris"], (0,))
    table, nn = l2.fuse_tables(nodes, ltris)
    return l2.traverse_lab2p(c["rays"][:3], c["rays"][3:], c["t0"], table,
                             None, roots, active=c["tact"], nn=nn,
                             count_rows=True, **kw)


@pytest.mark.parametrize("arm", list(L2_ARMS))
def test_lab2p_arms_vs_brute_force(case, arm):
    got = _l2(case, L2_ARMS[arm])
    _vs_brute(case, got, case["brute"])
    assert int(got[4].sum()) < int(got[3].sum())


@pytest.mark.parametrize("nearest", [False, True], ids=["ctz", "nearest"])
@pytest.mark.parametrize("two", [False, True], ids=["one_root", "two_roots"])
def test_lab2p_parent_frames_take_the_frame_stacks_trips(case, nearest,
                                                         two):
    fs = _l2(case, dict(frame_stack=True, nearest=nearest), two=two)
    par = _l2(case, dict(frame_stack=True, nearest=nearest, parent=True),
              two=two)
    _vs_brute(case, par, case["brute2" if two else "brute"])
    for a, b in zip(fs, par):  # hits, trips, leaf trips, rows read
        assert torch.equal(a, b)


def _chain(depth):
    """A tree of `depth` levels, one child per node, a leaf at the end."""
    nodes = np.zeros((depth, 64), np.float32)
    nodes[:, :48] = np.tile([-1, -1, -1, 1, 1, 1], 8)
    ents = nodes[:, 48:56].view(np.int32)
    ents[:] = cm.SLIM_EMPTY
    ents[:, 0] = np.arange(1, depth + 1)
    ents[-1, 0] = -1
    return torch.from_numpy(nodes), torch.zeros((1, 128))


def test_wrappers_refuse(case):
    r, t0, act = case["rays"], case["t0"], case["tact"]
    with pytest.raises(ValueError, match="cond_push"):
        l2.traverse_lab2(r[:3], r[3:], t0, case["nodes"], case["ltris"],
                         (0,), active=act, cond_push=True)
    table, nn = _fused(case)
    with pytest.raises(ValueError, match="parent"):
        l2.traverse_lab2p(r[:3], r[3:], t0, table, None, (0,), active=act,
                          nn=nn, frame_stack=False, parent=True)
    with pytest.raises(ValueError, match="fused table"):
        l2.traverse_lab2p(r[:3], r[3:], t0, case["nodes"], None, (0,),
                          active=act, nn=nn)
    # a tree deeper than the kernels' stacks hold: the linear stack
    # (7 per level) and the 24 frames
    nodes, ltris = _chain(9)
    with pytest.raises(ValueError, match="traversal stack"):
        l2.traverse_lab2(r[:3], r[3:], t0, nodes, ltris, (0,), active=act)
    l2.traverse_lab2(r[:3], r[3:], t0, nodes, ltris, (0,), active=act,
                     frame_stack=True)
    nodes, ltris = _chain(23)
    with pytest.raises(ValueError, match="traversal stack"):
        l2.traverse_lab2(r[:3], r[3:], t0, nodes, ltris, (0,), active=act,
                         frame_stack=True)


# ---- the per-ray counters (the card's kernels refill finished rays, so
# a warp's rays depend on the order in which warps finish) ----------------

def _plain(c, lab, kw, rays, t0, act, **extra):
    table, nn = l2.fuse_tables(c["nodes"], c["ltris"])
    if lab == "L1":
        fused = kw.get("fused", False)
        return l2.traverse_lab2_reference(
            rays, t0, table if fused else c["nodes"], c["ltris"], (0,),
            active=act, nn=nn if fused else 0,
            frame_stack=kw.get("frame_stack", False), fused=fused, **extra)
    return l2.traverse_lab2p_reference(
        rays, t0, table, (0,), active=act, nn=nn,
        frame_stack=kw.get("frame_stack", True),
        nearest=kw.get("nearest", False), parent=kw.get("parent", False),
        **extra)


PLAIN_ARMS = {
    "L1_linear": ("L1", {}), "L1_fs": ("L1", dict(frame_stack=True)),
    "L2_linear": ("L2", dict(frame_stack=False)),
    "L2_fs_near_parent": ("L2", dict(frame_stack=True, nearest=True,
                                     parent=True)),
}


@pytest.mark.parametrize("arm", list(PLAIN_ARMS))
def test_lab2_counters_do_not_depend_on_lane_order(case, arm):
    """The same rays in another lane order: every ray's hit and trips move
    with it, and the tile's counters stay (the lockstep warps' trips of
    the count launch's warp_trips are the schedule's and may change)."""
    lab, kw = PLAIN_ARMS[arm]
    perm = torch.from_numpy(np.random.default_rng(11).permutation(N))
    rays, t0, act = case["rays"], case["t0"], case["tact"]
    base = _plain(case, lab, kw, rays, t0, act, count_rows=True)
    moved = _plain(case, lab, kw, tuple(r[perm] for r in rays), t0[perm],
                   act[perm], count_rows=True)
    for a, b in zip(base[:3], moved[:3]):
        assert torch.equal(a[perm], b)
    for a, b in zip(base[3:5], moved[3:5]):  # one tile of 1024 lanes
        assert a.shape == (1,) and torch.equal(a, b)
    assert torch.equal(base[-1][:5], moved[-1][:5])
    rb = _plain(case, lab, kw, rays, t0, act, per_ray=True)
    rm = _plain(case, lab, kw, tuple(r[perm] for r in rays), t0[perm],
                act[perm], per_ray=True)
    for a, b in zip(rb[3:5], rm[3:5]):
        assert torch.equal(a[perm], b)
    assert int(rb[3][~act].abs().sum()) == 0
    assert torch.equal(rb[3].sum().view(1), base[3].to(torch.int64))
    # every warp trip holds at most 32 rays' trips
    assert 32 * int(base[-1][5]) >= int(base[3].sum())


@pytest.mark.parametrize("nearest", [False, True], ids=["ctz", "nearest"])
def test_lab2p_parent_frames_take_each_rays_trips(case, nearest):
    """L2's invariant ray by ray: parent-pointer frames take exactly the
    frame stack's trips and leaf trips on every lane."""
    kw = dict(frame_stack=True, nearest=nearest)
    r, t0, act = case["rays"], case["t0"], case["tact"]
    fs = _plain(case, "L2", kw, r, t0, act, per_ray=True)
    par = _plain(case, "L2", dict(kw, parent=True), r, t0, act, per_ray=True)
    for a, b in zip(fs, par):
        assert torch.equal(a, b)
    assert int(fs[3].max()) > int(fs[3][act].min()) > 0


@pytest.mark.parametrize("arm", list(PLAIN_ARMS))
def test_lab2_inactive_lanes_in_a_ragged_last_warp(case, arm):
    """1000 lanes (not a multiple of 32), the last warp's lanes partly
    inactive, t_init different on every lane: a lane that is not active
    returns its t_init and ids -1 and counts no trip; the active ones
    equal the run over all 1024 lanes."""
    lab, kw = PLAIN_ARMS[arm]
    n = 1000
    act = case["tact"][:n].clone()
    act[-20:-3] = False  # the last warp (lanes 992..999) ends inactive
    t0 = torch.from_numpy(np.random.default_rng(5).uniform(
        1.0, 50.0, n).astype(np.float32))
    rays = tuple(r[:n] for r in case["rays"])
    got = _plain(case, lab, kw, rays, t0, act, count_rows=True)
    per = _plain(case, lab, kw, rays, t0, act, per_ray=True)
    assert got[0].shape == (n,) and got[3].shape == (1,)
    off = ~act
    assert torch.equal(got[0][off].view(torch.int32),
                       t0[off].view(torch.int32))
    assert (got[1][off] == -1).all() and (got[2][off] == -1).all()
    assert int(per[3][off].sum()) == 0 and int(per[4][off].sum()) == 0
    assert bool((per[3][act] > 0).all())
    full = _plain(case, lab, kw, case["rays"], torch.cat(
        [t0, torch.full((N - n,), RAY_TMAX)]), torch.cat(
        [act, torch.zeros(N - n, dtype=torch.bool)]), count_rows=True)
    for a, b in zip(got[:3], full[:3]):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, (b.view(torch.int32)
                                    if b.is_floating_point() else b)[:n])
    assert torch.equal(got[3], full[3]) and torch.equal(got[4], full[4])
