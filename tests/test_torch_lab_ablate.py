"""The traversal labs L6 and L7 of the port (cpugpupathtracing_tpu_torch
labs/kernel_lab.py: traverse_lab, traverse_lab_dual, fuse_tables,
fma_f32) against the JAX package's tools/kernel_lab.py and brute force,
on the CPU (the plain versions; the CUDA kernels are held against them
bitwise on the card by tests/test_torch_gpu.py and chip_smoke.py).

Inputs as tests/test_torch_lab2.py makes them, at 4096 rays (the JAX
lab's grid step, two pairs of tiles for L7): an icosphere of
subdivisions 1, rays from numpy's default_rng(3) toward a point near the
centre, one root, 10% of the lanes inactive; a second sphere spliced in
for two roots.

Tolerances.  Against the JAX lab run in interpret mode (one run, in a
module fixture; its XLA compile is its whole cost): hit and object
bitwise on every lane, t within T_ULPS units in the last place on every
lane that hits (the interpret run is jitted, and XLA's CPU compiler
contracts the triangle test's multiply-adds into FMAs: 48 ULPs seen on
a grazing ray of these 4096; tests/test_torch_lab2.py saw 4 on 1024).
Against brute force run op by op (jax.disable_jit(), no FMA): t, id and
object bitwise on every active lane, for every arm that finds hits.
Between arms that are one walk in two instruction orders (seq / ilv,
extract / packed, fixed / packedmask, vector / smem entries, split /
fused tables): every output bitwise.  The counters and depth are the
card's schedule and are not compared with the JAX lab's 8-row packets.
L7's JAX body cannot run here: its pallas_call passes no interpret= and
reads pl.program_id inside pl.when, which the CPU backend cannot lower;
its plain version is held against the L6 JAX run's hits and against
L6's per-warp trips (a warp's trips are the max of the two L6 warps it
pairs)."""

from fractions import Fraction

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
from cpugpupathtracing_tpu_torch.labs import kernel_lab as kl
from cpugpupathtracing_tpu_torch.labs import kernel_lab2 as l2
from tools import kernel_lab as jlab

N = 4096
T_ULPS = 64
RAY_TMAX = 1e34


def _slim(center=(0.0, 0.0, 0.0)):
    m = jmesh.icosphere(center=center, subdivisions=1)
    b = jbvh.build(m.positions, m.normals, m.indices,
                   BuildOption.SAH_SPLIT_INTERVALS, max_leaf_size=8)
    return b, jbvh8.to_slim(jbvh8.collapse(b, leaf_max=8), b.tri_normal)


def _brute(o, d, bvhs):
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
    b, s = _slim()
    rng = np.random.default_rng(3)
    o = rng.normal(size=(N, 3)).astype(np.float32) * 4
    aim = rng.normal(size=(N, 3)).astype(np.float32) * 0.5
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = rng.random(N) >= 0.1
    b2, s2 = _slim(center=(2.5, 0.0, 0.0))
    nodes2 = np.concatenate([s.nodes, s2.nodes.copy()])
    ci2 = nodes2[len(s.nodes):, 48:56].view(np.int32)
    cc2 = nodes2[len(s.nodes):, 56:64].view(np.int32)
    ci2[cc2 == 0] += len(s.nodes)
    ci2[cc2 > 0] -= len(s.ltris)
    lt2 = s2.ltris.copy()
    ids = lt2.view(np.int32)[:, 13::16]
    ids[ids >= 0] += b.num_triangles
    tt = torch.from_numpy
    return dict(
        s=s, o=o, d=d, act=act,
        rays=tuple(tt(np.ascontiguousarray(v[:, k])) for v in (o, d)
                   for k in range(3)),
        t0=torch.full((N,), RAY_TMAX, dtype=torch.float32), tact=tt(act),
        nodes=tt(s.nodes), ltris=tt(s.ltris), brute=_brute(o, d, [b]),
        two=(tt(nodes2), tt(np.concatenate([s.ltris, lt2])),
             (0, len(s.nodes))),
        brute2=_brute(o, d, [b, b2]))


@pytest.fixture(scope="module")
def jax_lab(case):
    """L6 in interpret mode: slab="ilv", leaf="ilv", order="fixed" (the
    arm L7 pairs), with GROUPS lowered to 1 -- a grid step of one
    1024-lane tile, whose tiles are independent, so the same output at a
    quarter of the compile."""
    o, d = case["o"], case["d"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlab, "GROUPS", 1)
        out = _jax_lab(o, d, case)
    return tuple(np.asarray(x) for x in out)


def _jax_lab(o, d, case):
    return jlab.traverse_lab(
        tuple(jnp.asarray(o[:, k]) for k in range(3)),
        tuple(jnp.asarray(d[:, k]) for k in range(3)),
        jnp.full((N,), RAY_TMAX, jnp.float32), jnp.asarray(case["s"].nodes),
        jnp.asarray(case["s"].ltris), (0,),
        active=jnp.asarray(case["act"].astype(np.int32)),
        opts_t=(("leaf", "ilv"), ("order", "fixed"), ("slab", "ilv")))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _vs_jax(got, ref):
    t, hit, obj = (x.numpy() for x in got[:3])
    np.testing.assert_array_equal(hit, ref[1])
    np.testing.assert_array_equal(obj, ref[2])
    assert (hit >= 0).sum() > N // 2  # most rays meet the sphere
    assert _ulps(t, ref[0]).max() <= T_ULPS


def _vs_brute(c, got, brute, act=None):
    act = c["act"] if act is None else act
    t, hit, obj = (x.numpy() for x in got[:3])
    bt, bidx = brute
    np.testing.assert_array_equal(hit[act], bidx[act])
    np.testing.assert_array_equal(t[act].view(np.int32),
                                  bt[act].view(np.int32))
    np.testing.assert_array_equal(obj[act] >= 0, bidx[act] >= 0)
    assert (hit[~act] == -1).all() and (t[~act] == RAY_TMAX).all()


# every instantiated arm by its launch key
ARM_KW = {kl.launch_key(**kw): kw for kw in (
    dict(leaf=a[0], slab=a[1], ctrl=a[2],
         entries="smem" if a[3] else "vector",
         order="fixed" if a[4] else "nearest",
         decode="fused" if a[5] else None, fma=a[6], unroll=a[7])
    for a in kl.ARMS)}


def _l6(c, two=False, **kw):
    nodes, ltris, roots = c["two"] if two else (c["nodes"], c["ltris"], (0,))
    nn = 0
    if kw.get("decode") == "fused":
        nodes, nn = kl.fuse_tables(nodes, ltris)
    return kl.traverse_lab(c["rays"][:3], c["rays"][3:], c["t0"], nodes,
                           ltris, roots, active=c["tact"], nn=nn,
                           count_rows=True, **kw)


def test_lab_vs_jax_interpret(case, jax_lab):
    got = _l6(case, slab="ilv", leaf="ilv", order="fixed")
    _vs_jax(got, jax_lab)
    assert got[3].shape == (N,) and got[4].shape == (N // cm.TILE,)
    # depth: the interior steps in which the ray entered a child, at
    # least one for a lane that hits
    hit = got[1] >= 0
    assert bool((got[3][hit] >= 1).all()) and int(got[3].sum()) > 0


# arms that are another arm's walk in another instruction order or
# table layout: every output equal
_BASE = "traverse_lab_leafilv_slabilv"
_FIXED = "traverse_lab_leafilv_slabilv_fixed"
TWINS = {
    "traverse_lab": _BASE,
    "traverse_lab_slabilv": _BASE,
    "traverse_lab_leafilv": _BASE,
    "traverse_lab_leafilv_slabilv_packed": _BASE,
    "traverse_lab_leafilv_slabilv_packedmask": _FIXED,
    "traverse_lab_leafilv_slabilv_smem_fixed": _FIXED,
    "traverse_lab_leafilv_slabilv_fixed_fused": _FIXED,
    "traverse_lab_leafilv_slabilv_framestack_fused":
        "traverse_lab_leafilv_slabilv_framestack",
}


@pytest.mark.parametrize("key", list(ARM_KW))
def test_lab_arms_vs_brute_force(case, key):
    """Every arm: hits against brute force (leaf skip: none; fma: its
    planes are not B4's, but on these rays no hit moves); every output
    against its twin (TWINS)."""
    kw = ARM_KW[key]
    got = _l6(case, **kw)
    if kw["leaf"] == "skip":
        assert bool((got[1] == -1).all()) and torch.equal(got[0], case["t0"])
        assert int(got[-1][1]) == 0 and int(got[-1][2]) == 0  # no leaf work
    else:
        _vs_brute(case, got, case["brute"])
    if key in TWINS:
        for a, b in zip(got, _l6(case, **ARM_KW[TWINS[key]])):
            assert torch.equal(a, b), key


def test_lab_unroll_counts_votes(case):
    """unroll=U takes U steps per warp vote: its iterations are the
    per-warp steps of unroll=1 divided by U, rounded up."""
    r1 = kl.traverse_lab_reference(case["rays"], case["t0"], case["nodes"],
                                   case["ltris"], (0,), active=case["tact"],
                                   slab="ilv", leaf="ilv", warp_trips=True)
    per_warp = r1[-1]
    for u in (2, 4):
        got = _l6(case, slab="ilv", leaf="ilv", unroll=u)
        want = cm.tile_sum(-(-per_warp // u), N)
        assert torch.equal(got[4], want)
        for a, b in zip(got[:4], r1[:4]):
            assert torch.equal(a, b)


def test_lab_slab_skip_visits_every_row(case):
    got = _l6(case, slab="skip", leaf="ilv", order="fixed")
    _vs_brute(case, got, case["brute"])
    counts = dict(zip(cm.COUNTS, got[-1].tolist()))
    assert counts["node_rows"] == case["nodes"].shape[0]
    assert counts["leaf_rows"] == case["ltris"].shape[0]
    # every live lane takes every row of the tree
    live = int(case["tact"].sum())
    assert counts["node"] == live * case["nodes"].shape[0]
    assert int(got[3].sum()) == 0  # no slab test, no depth


@pytest.mark.parametrize("key", ["traverse_lab", "traverse_lab_leafilv_"
                                 "slabilv_fixed", "traverse_lab_leafilv_"
                                 "slabilv_framestack"])
def test_lab_two_roots(case, key):
    got = _l6(case, two=True, **ARM_KW[key])
    _vs_brute(case, got, case["brute2"])


def test_dual_vs_jax_and_pair_max(case, jax_lab):
    """L7's plain version: the L6 JAX run's hits, depth zero, and per pair
    of tiles the sum over its warps of the max of the two L6 warps it
    pairs (L6's per-warp trips from its plain version)."""
    got = kl.traverse_lab_dual(case["rays"][:3], case["rays"][3:],
                               case["t0"], case["nodes"], case["ltris"], (0,),
                               active=case["tact"], count_rows=True)
    _vs_jax(got, jax_lab)
    assert bool((got[3] == 0).all())
    r6 = kl.traverse_lab_reference(case["rays"], case["t0"], case["nodes"],
                                   case["ltris"], (0,), active=case["tact"],
                                   slab="ilv", leaf="ilv", order="fixed",
                                   warp_trips=True)
    assert got[4].shape == (N // kl.PAIR,)
    assert torch.equal(got[4], kl.pair_trips(r6[-1], N))
    # a pair's trips lie between its two tiles' most and their sum
    tiles = r6[4].view(-1, 2)
    assert bool((got[4] >= tiles.amax(dim=1)).all())
    assert bool((got[4] <= tiles.sum(dim=1)).all())
    # the same rows and work as L6's walk
    assert torch.equal(got[-1], _l6(case, slab="ilv", leaf="ilv",
                                    order="fixed")[-1])


def _f32_round(r: Fraction) -> np.float32:
    """The f32 nearest the exact rational r, ties to an even mantissa."""
    c = np.float32(float(r))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))):
        err = abs(Fraction(float(cand)) - r)
        even = int(np.array(cand).view(np.int32)) % 2 == 0
        if best is None or err < best[0] or (err == best[0] and even):
            best = (err, cand)
    return best[1]


def test_fma_f32_rounds_once():
    """fma_f32 is a correctly rounded f32 a * b + c: known double-rounding
    cases (a plain f64 sum rounds to the f32 tie and then to even) and
    random cancelling triples against the exact rational result."""
    a = torch.tensor([1 + 2 ** -12] * 4, dtype=torch.float32)
    c = torch.tensor([2 ** -70, -2 ** -70, 2 ** -40, -2 ** -40],
                     dtype=torch.float32)
    want = [1 + 2 ** -11 + 2 ** -23, 1 + 2 ** -11,
            1 + 2 ** -11 + 2 ** -23, 1 + 2 ** -11]
    assert kl.fma_f32(a, a, c).double().tolist() == want
    naive = (a.double() * a.double() + c.double()).float()
    assert naive[0].item() != want[0]  # the double rounding it avoids
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 400)).astype(np.float32)
    x[2] = -(x[0].astype(np.float64) * x[1]).astype(np.float32) * \
        (1 + rng.normal(size=400).astype(np.float32) * 1e-6)
    got = kl.fma_f32(*(torch.from_numpy(v) for v in x)).numpy()
    for i in range(x.shape[1]):
        exact = Fraction(float(x[0, i])) * Fraction(float(x[1, i])) + \
            Fraction(float(x[2, i]))
        assert got[i] == _f32_round(exact), i


def test_fuse_tables_one_copy():
    """kernel_lab2's fuse_tables is kernel_lab's (tests/test_torch_lab2.py
    holds it against the JAX lab's bitwise)."""
    assert l2.fuse_tables is kl.fuse_tables


def test_options_and_refusals(case):
    # the JAX body's normalisation
    o = kl.options(leaf="full", slab="full", ctrl="framestack", fma=True)
    assert (o["leaf"], o["slab"], o["order"], o["fma"]) == \
        ("seq", "seq", "fixed", False)
    r, t0, act = case["rays"], case["t0"], case["tact"]
    with pytest.raises(ValueError, match="not instantiated"):
        kl.traverse_lab(r[:3], r[3:], t0, case["nodes"], case["ltris"], (0,),
                        active=act, leaf="skip", slab="skip")
    with pytest.raises(ValueError, match="ctrl"):
        kl.traverse_lab(r[:3], r[3:], t0, case["nodes"], case["ltris"], (0,),
                        active=act, ctrl="fancy")
    with pytest.raises(ValueError, match="fused table needs nn"):
        kl.traverse_lab(r[:3], r[3:], t0, case["nodes"], case["ltris"], (0,),
                        active=act, slab="ilv", leaf="ilv", order="fixed",
                        decode="fused")
    # a chain deeper than the linear stack's worst case (7 per level)
    depth = 9
    nodes = np.zeros((depth, 64), np.float32)
    nodes[:, :48] = np.tile([-1, -1, -1, 1, 1, 1], 8)
    ents = nodes[:, 48:56].view(np.int32)
    ents[:] = cm.SLIM_EMPTY
    ents[:, 0] = np.arange(1, depth + 1)
    ents[-1, 0] = -1
    for f in (kl.traverse_lab, kl.traverse_lab_dual):
        with pytest.raises(ValueError, match="traversal stack"):
            f(r[:3], r[3:], t0, torch.from_numpy(nodes),
              torch.zeros((1, 128)), (0,), active=act)


# ---- the slab-skip arm's sweep (csrc/kernel_lab.cu sweep_kernel) ----------

SKIP = dict(slab="skip", leaf="ilv", order="fixed")


def _skip_scene():
    """The small tree on which chip_smoke.py holds the slab-skip arm
    against its plain version: an icosphere of subdivisions 1 and a
    ground quad, two roots."""
    from cpugpupathtracing_tpu_torch.models import materials as matlib
    from cpugpupathtracing_tpu_torch.models import mesh as meshlib
    from cpugpupathtracing_tpu_torch.models.scene import Scene

    s = Scene()
    m = s.add_material(matlib.Material.diffuse((0.8, 0.8, 0.8)))
    s.add_mesh("ball", meshlib.icosphere(subdivisions=1, radius=2.0), m)
    s.add_mesh("floor", meshlib.ground_quad(half_extent=50.0, y=-2.0), m)
    return s


@pytest.fixture(scope="module")
def skip_fan():
    """The small tree's bounce fan at 32x32 (1024 lanes, about half of them
    active), with t_init set on every fifth lane."""
    from cpugpupathtracing_tpu_torch.labs import bounce_fan as bf

    fan = bf.make_fan("cpu", 32, 32, scene=_skip_scene())
    t0 = fan.t_init.clone()
    t0[::5] = 3.0
    return fan, t0


@pytest.mark.parametrize("nroots", [2, 1])
def test_slab_skip_rows_are_every_lanes(skip_fan, nroots):
    """The sweep's premise: in the slab-skip arm's plain walk every active
    lane -- t_init set or not, under one root or two -- visits the same
    entries in the same order, sweep_rows' rows, and an inactive lane
    none."""
    fan, t0 = skip_fan
    roots = fan.roots[:nroots]
    assert len(fan.roots) == 2
    visits = []
    kl.traverse_lab_reference(fan.rays, t0, fan.nodes, fan.ltris, roots,
                              active=fan.active, visits=visits, **SKIP)
    seq = torch.stack(visits)[:, :t0.numel()]  # (steps, lanes)
    act = fan.active
    assert 0 < int(act.sum()) < act.numel()
    first = seq[:, act.nonzero()[0, 0]]
    assert bool((seq[:, act] == first[:, None]).all())
    assert bool((seq[:, ~act] == cm.DONE).all())
    node_seq, leaf_seq = kl.sweep_rows(fan.nodes, roots)
    assert cm.DONE not in first.tolist()  # an active lane never idles
    assert [e for e in first.tolist() if e >= 0] == node_seq
    assert [-e - 1 for e in first.tolist() if e < 0] == leaf_seq
    if nroots == 2:  # both trees, every row of the tables
        assert sorted(node_seq) == list(range(fan.nodes.shape[0]))
        assert sorted(leaf_seq) == list(range(fan.ltris.shape[0]))


def _tree_order_sweep(rays, t_init, active, ltris, leaf_seq):
    """Every active ray against every record of the leaf rows, in the
    rows' order: the closest hit by t, then the lower id (t_init, ids -1
    to start; an inactive lane keeps them)."""
    from cpugpupathtracing_tpu_torch.ops.intersect import intersect_triangle

    o = torch.stack(rays[:3], dim=1)
    d = torch.stack(rays[3:], dim=1)
    t = t_init.clone()
    hit = torch.full_like(t, -1, dtype=torch.int32)
    obj = hit.clone()
    for row in leaf_seq:
        recs = ltris[row].view(8, 16)
        ids = recs[:, 13].contiguous().view(torch.int32)
        objs = recs[:, 12].contiguous().view(torch.int32)
        for c in range(8):
            ok, tt = intersect_triangle(o, d, recs[c, 0:3], recs[c, 3:6],
                                        recs[c, 6:9])
            take = active & ok & ((tt < t) | ((tt == t) & (ids[c] < hit)))
            t = torch.where(take, tt, t)
            hit = torch.where(take, ids[c], hit)
            obj = torch.where(take, objs[c], obj)
    return t, hit, obj


@pytest.mark.parametrize("which", ["small", "small_one_root", "spheres"])
def test_tree_order_sweep_equals_the_walk(skip_fan, case, which):
    """The sweep the card runs, written here over the plain walk's leaf
    rows: its t, hit and object bitwise the walk's on every lane, and the
    walk's counters from the row sequence alone -- depth 0, per tile the
    sequence's steps times the warps with an active lane, the work of a
    count launch and the rows read.  On the small tree's fan (two roots,
    and its first root alone; few of its bounce rays hit) and on the two
    spheres of `case` (two roots, most rays hit)."""
    if which == "spheres":
        rays, t0, act = case["rays"], case["t0"], case["tact"]
        nodes, ltris, roots = case["two"]
    else:
        fan, t0 = skip_fan
        rays, act, nodes, ltris = fan.rays, fan.active, fan.nodes, fan.ltris
        roots = fan.roots[:1] if which == "small_one_root" else fan.roots
    got = kl.traverse_lab(rays[:3], rays[3:], t0, nodes, ltris, roots,
                          active=act, count_rows=True, **SKIP)
    node_seq, leaf_seq = kl.sweep_rows(nodes, roots)
    want = _tree_order_sweep(rays, t0, act, ltris, leaf_seq)
    assert int((want[1] >= 0).sum()) > (N // 2 if which == "spheres" else 10)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert bool((got[3] == 0).all())
    steps = len(node_seq) + len(leaf_seq)
    warps = cm.warp_any(act).to(torch.int64) * steps
    assert torch.equal(got[4], cm.tile_sum(warps, t0.numel()))
    live = int(act.sum())
    assert got[-1].tolist() == [live * len(node_seq), live * len(leaf_seq),
                                live * len(leaf_seq) * 8,
                                len(set(node_seq)), len(set(leaf_seq))]


def _merge(hits):
    """The closest hit over the pieces' (t, hit, object), in piece order:
    a later piece's hit is taken where its t is smaller, or equal with a
    lower id (csrc/kernel_lab.cu sweep_merge_kernel)."""
    t, hit, obj = (x.clone() for x in hits[0])
    for tt, hh, oo in hits[1:]:
        take = (hh >= 0) & ((tt < t) | ((tt == t) & (hh < hit)))
        t = torch.where(take, tt, t)
        hit = torch.where(take, hh, hit)
        obj = torch.where(take, oo, obj)
    return t, hit, obj


@pytest.mark.parametrize("which", ["small", "spheres"])
def test_pieced_sweep_equals_the_walk(skip_fan, case, which):
    """The sweep as the card cuts it: the leaf sequence in min(8, rows)
    pieces (piece c the rows [c * rows // 8, (c + 1) * rows // 8)), each
    swept from t_init, then merged by (t, id): t, hit and object bitwise
    the plain walk's."""
    if which == "spheres":
        rays, t0, act = case["rays"], case["t0"], case["tact"]
        nodes, ltris, roots = case["two"]
    else:
        fan, t0 = skip_fan
        rays, act, nodes, ltris = fan.rays, fan.active, fan.nodes, fan.ltris
        roots = fan.roots
    got = kl.traverse_lab(rays[:3], rays[3:], t0, nodes, ltris, roots,
                          active=act, **SKIP)
    _, leaf_seq = kl.sweep_rows(nodes, roots)
    n = len(leaf_seq)
    chunks = max(1, min(kl.SWEEP_CHUNKS, n))
    assert chunks == kl.SWEEP_CHUNKS
    pieces = [leaf_seq[c * n // chunks:(c + 1) * n // chunks]
              for c in range(chunks)]
    assert all(pieces) and sum(pieces, []) == leaf_seq
    want = _merge([_tree_order_sweep(rays, t0, act, ltris, p)
                   for p in pieces])
    assert int((want[1] >= 0).sum()) > 10
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
