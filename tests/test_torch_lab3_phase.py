"""The traversal labs L3 and L4 of the port (cpugpupathtracing_tpu_torch
labs/kernel_lab3.py: traverse16, collapse16, scene_tables16;
labs/phase_lab.py: traverse_phase) against the JAX package's
tools/kernel_lab3.py and tools/phase_lab.py and brute force, on the CPU
(the plain versions; the CUDA kernels are held against them bitwise on
the card by tests/test_torch_gpu.py and chip_smoke.py).

Inputs as tools/kernel_lab2.py _selfcheck makes them: 1024 rays from
numpy's default_rng(3) toward a point near the centre of an icosphere, 10%
of the lanes inactive.  L4 walks the slim tables of an icosphere of
subdivisions 1 (the JAX package's bvh.build, SAH_SPLIT_INTERVALS, leaves
of 8, bvh8.collapse, to_slim); L3 the 16-wide tables of one of
subdivisions 2 (at subdivisions 1 the 16-wide collapse is a single row,
and the walk would never push a frame).

Tolerances.  Against the JAX lab run in interpret mode (one run per lab,
each in a module fixture): hit and object bitwise on every lane, t within
T_ULPS units in the last place on every lane that hits (the interpret run
is jitted, and XLA's CPU compiler contracts the triangle test's
multiply-adds into FMAs).  Against brute force run op by op
(jax.disable_jit(), no FMA): t, id and object bitwise on every active
lane of a closest hit (L3's ids local to their object, made global by the
object's triangle offset, as tools/kernel_lab3.py's check does), the
occlusion bit of an any hit.  The table builders: bitwise against the JAX
package's.  Counters: L4's drain2 takes no more leaf trips than v1 does."""

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
from cpugpupathtracing_tpu_torch.labs import kernel_lab3 as l3
from cpugpupathtracing_tpu_torch.labs import phase_lab as pl
from tools import kernel_lab3 as jlab3
from tools import phase_lab as jphase

N = 1024
T_ULPS = 16
RAY_TMAX = 1e34


def _bvh(subdivisions, center=(0.0, 0.0, 0.0)):
    m = jmesh.icosphere(center=center, subdivisions=subdivisions)
    return jbvh.build(m.positions, m.normals, m.indices,
                      BuildOption.SAH_SPLIT_INTERVALS, max_leaf_size=8)


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


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    o = rng.normal(size=(N, 3)).astype(np.float32) * 4
    aim = rng.normal(size=(N, 3)).astype(np.float32) * 0.5
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = rng.random(N) >= 0.1
    b1, b2 = _bvh(1), _bvh(2)
    b2x = _bvh(2, center=(2.5, 0.0, 0.0))
    s1 = jbvh8.to_slim(jbvh8.collapse(b1, leaf_max=8), b1.tri_normal)
    tt = torch.from_numpy
    return dict(
        o=o, d=d, act=act, b1=b1, b2=b2, b2x=b2x, s1=s1,
        rays=tuple(tt(np.ascontiguousarray(v[:, k])) for v in (o, d)
                   for k in range(3)),
        t0=torch.full((N,), RAY_TMAX, dtype=torch.float32), tact=tt(act),
        brute1=_brute(o, d, [b1]), brute2=_brute(o, d, [b2]),
        brute2x=_brute(o, d, [b2, b2x]))


def _jax_cols(c):
    o, d = c["o"], c["d"]
    return (tuple(jnp.asarray(o[:, k]) for k in range(3)),
            tuple(jnp.asarray(d[:, k]) for k in range(3)),
            jnp.full((N,), RAY_TMAX, jnp.float32),
            jnp.asarray(c["act"].astype(np.int32)))


@pytest.fixture(scope="module")
def jax_lab3(case):
    """L3 in interpret mode: a closest hit, nearest first, count_iters."""
    fused, nn, roots = jlab3.scene_tables16([(case["b2"], 0)])
    oc, dc, t0, act = _jax_cols(case)
    out = jlab3.traverse16(oc, dc, t0, fused, roots, active=act, nn=nn,
                           count_iters=True, nearest=True)
    return tuple(np.asarray(x) for x in out)


@pytest.fixture(scope="module")
def jax_phase(case):
    """L4 in interpret mode (v1: one leaf row per lane and leaf trip)."""
    s = case["s1"]
    oc, dc, t0, act = _jax_cols(case)
    out = jphase.traverse_phase(oc, dc, t0, jnp.asarray(s.nodes),
                                jnp.asarray(s.ltris), (0,), active=act)
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


def _vs_brute(c, t, hit, brute):
    act = c["act"]
    bt, bidx = brute
    np.testing.assert_array_equal(hit[act], bidx[act])
    np.testing.assert_array_equal(t[act].view(np.int32),
                                  bt[act].view(np.int32))
    assert (hit[~act] == -1).all() and (t[~act] == RAY_TMAX).all()


# ---- L3 --------------------------------------------------------------------


@pytest.mark.parametrize("sub", [1, 2])
def test_collapse16_bitwise(case, sub):
    b = case["b1" if sub == 1 else "b2"]
    want = jlab3.collapse16(b)
    got = l3.collapse16(b)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def test_scene_tables16_bitwise(case):
    objs = [(case["b2"], 0), (case["b2x"], 3)]
    fused, nn, roots = jlab3.scene_tables16(objs)
    got, tnn, troots = l3.scene_tables16(objs, "cpu")
    assert (tnn, troots) == (nn, roots)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(fused).view(np.int32))


def _l3(c, two=False, **kw):
    objs = [(c["b2"], 0)] + ([(c["b2x"], 1)] if two else [])
    fused, nn, roots = l3.scene_tables16(objs, "cpu")
    return l3.traverse16(c["rays"][:3], c["rays"][3:], c["t0"], fused,
                         roots, active=c["tact"], nn=nn, count_iters=True,
                         count_rows=True, **kw)


def test_traverse16_vs_jax_interpret(case, jax_lab3):
    got = _l3(case, nearest=True)
    _vs_jax(got, jax_lab3)
    assert int(got[3].sum()) > 0


@pytest.mark.parametrize("nearest", [False, True], ids=["ctz", "nearest"])
@pytest.mark.parametrize("two", [False, True], ids=["one_root", "two_roots"])
def test_traverse16_closest_vs_brute_force(case, nearest, two):
    t, tri, obj = (x.numpy() for x in _l3(case, two, nearest=nearest)[:3])
    glob = np.where((obj == 1) & (tri >= 0),
                    tri + case["b2"].num_triangles, tri)
    _vs_brute(case, t, glob, case["brute2x" if two else "brute2"])
    act = case["act"]
    np.testing.assert_array_equal(obj[act] >= 0, tri[act] >= 0)


@pytest.mark.parametrize("two", [False, True], ids=["one_root", "two_roots"])
def test_traverse16_any_hit_occlusion(case, two):
    got = _l3(case, two, any_hit=True)
    closest = _l3(case, two)
    act = case["act"]
    _, bidx = case["brute2x" if two else "brute2"]
    hit = got[1].numpy()
    np.testing.assert_array_equal(hit[act] >= 0, bidx[act] >= 0)
    # the first hit its walk finds ends it: fewer trips and rows than the
    # closest hit
    assert int(got[3].sum()) < int(closest[3].sum())
    assert int(got[4][2]) < int(closest[4][2])


# ---- L4 --------------------------------------------------------------------


def _phase(c, drain2=False):
    s = c["s1"]
    return pl.traverse_phase(c["rays"][:3], c["rays"][3:], c["t0"],
                             torch.from_numpy(s.nodes),
                             torch.from_numpy(s.ltris), (0,),
                             active=c["tact"], drain2=drain2,
                             count_rows=True)


def test_phase_vs_jax_interpret(case, jax_phase):
    got = _phase(case)
    _vs_jax(got, jax_phase)
    assert 0 < int(got[4].sum()) < int(got[3].sum())


@pytest.mark.parametrize("drain2", [False, True], ids=["v1", "drain2"])
def test_phase_vs_brute_force(case, drain2):
    got = _phase(case, drain2)
    _vs_brute(case, got[0].numpy(), got[1].numpy(), case["brute1"])


def test_phase_drain2_takes_no_more_leaf_trips(case):
    v1, d2 = _phase(case), _phase(case, drain2=True)
    for a, b in zip(v1[:3], d2[:3]):
        assert torch.equal(a, b)
    assert int(d2[4].sum()) <= int(v1[4].sum())


def test_wrappers_refuse(case):
    r, t0, act = case["rays"], case["t0"], case["tact"]
    s = case["s1"]
    with pytest.raises(ValueError, match="64-col"):
        pl.traverse_phase(r[:3], r[3:], t0, torch.zeros((4, 128)),
                          torch.from_numpy(s.ltris), (0,), active=act)
    with pytest.raises(ValueError, match="16-wide"):
        l3.traverse16(r[:3], r[3:], t0, torch.from_numpy(s.nodes), (0,),
                      active=act, nn=1)
    # a 16-wide tree deeper than the kernel's 24 frames of 17 words
    nodes = np.zeros((24, 128), np.float32)
    nodes[:, :96] = np.tile([-1, -1, -1, 1, 1, 1], 16)
    ents = nodes[:, 96:112].view(np.int32)
    ents[:] = l3.SLIM_EMPTY
    ents[:, 0] = np.arange(1, 25)
    with pytest.raises(ValueError, match="traversal stack"):
        l3.traverse16(r[:3], r[3:], t0, torch.from_numpy(nodes), (0,),
                      active=act, nn=23)
