"""The node-table variants of the port (cpugpupathtracing_tpu_torch):
CPUGPU_PACKET_TREE's five tree modes, CPUGPU_SMEMTREE's entry side tables
and 48-col rows, CPUGPU_FUSED's node|leaf table, and the kernel arms that
walk them.

  * Tables: the port's scene build against the JAX package's
    Scene.device() (op by op; its module constants patched as
    tests/test_packet.py and tests/test_flatten.py patch them), bitwise,
    per mode -- every table and its metadata, the widened TLAS of a
    flattened 16-wide scene, smem_small, and what packet_tables /
    occl_tables hand each caller.  A refit of a flattened scene under
    w16 and under fused (pfused rebuilt on the tables' device) equals a
    fresh build bitwise.
  * Kernel bodies: the g++ build of csrc/pt_device.cuh (ops/pt_frame.py
    build_host) on every layout: traverse_packet_slim's hits bitwise
    against brute force (any hits in existence), rays with zero direction
    components over 48-col rows with NaN empty slots included; its
    count_depth walk (traverse_walk_reference) bitwise against the g++
    build, bvh_depth included; pt_frame, shade_extend and shadow_resolve
    on each layout bitwise against the same bodies on the plain 64-col
    tables, and their state, flags and traced counts exactly the plain
    versions'.
  * The wrappers' checks (the JAX package's _resolve_smem and
    _check_table_width, and its checks of the leaf-side and occlusion
    arguments), the per-layout launch counts, the flag-keyed scene cache,
    the routes' table choice, and the 16-wide stack bound.

Scenes: tests/test_golden.py's (a 320-triangle icosphere, a cube, a floor
plane, a sphere light) and tests/test_packet_instances.py's instanced
one; the rays of tests/test_torch_xla.py's walk queries.
"""

import numpy as np
import jax
import pytest
import torch

from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu.ops import traverse_packet_slim as jtps
from cpugpupathtracing_tpu_torch.config import RenderSettings
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.ops import megakernel as tmk
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from tests.test_torch_instances import _flatten_tf, flatten_scene, \
    packet_instanced
from tests.test_torch_scene import golden_scene

# (CPUGPU_PACKET_TREE, CPUGPU_FUSED, CPUGPU_SMEMTREE) of each table case
TABLE_CASES = {
    "fat": ("fat", False, "48"),
    "dp": ("dp", False, "48"),
    "sweep": ("sweep", False, "48"),
    "sweep_dp_48": ("sweep_dp", False, "48"),
    "sweep_dp_ents": ("sweep_dp", False, "1"),
    "sweep_dp_off": ("sweep_dp", False, "0"),
    "w16": ("w16", False, "48"),
    "fused": ("sweep_dp", True, "48"),
    "fused_w16": ("w16", True, "48"),
}
# the environment of each kernel layout (ops/pt_frame.py LAYOUTS), side
# tables for trees of every size
LAYOUT_ENV = {
    "64": dict(CPUGPU_SMEMTREE="0"),
    "ents": dict(CPUGPU_SMEMTREE="1"),
    "48": dict(CPUGPU_SMEMTREE="48"),
    "w16": dict(CPUGPU_PACKET_TREE="w16"),
    "fused": dict(CPUGPU_FUSED="1"),
    "fused_w16": dict(CPUGPU_FUSED="1", CPUGPU_PACKET_TREE="w16"),
}
FLAG_VARS = ("CPUGPU_PACKET_TREE", "CPUGPU_FUSED", "CPUGPU_SMEMTREE",
             "CPUGPU_OCCL", "CPUGPU_SMEMTREE_MIN_NODES")


def _set_flags(mp, tree="sweep_dp", fused=False, smem="48", min_nodes=None,
               occl=True):
    """Both packages under one set of node-table flags: the JAX module
    constants and the port's environment."""
    mp.setattr(jscene, "PACKET_TREE", tree)
    mp.setattr(jscene, "PACKET_FUSED", fused)
    mp.setattr(jscene, "PACKET_OCCL", occl)
    mp.setattr(jtps, "SMEMTREE_DEFAULT", smem)
    mp.setattr(jtps, "FRAMESTACK_DEFAULT", True)
    mp.setenv("CPUGPU_PACKET_TREE", tree)
    mp.setenv("CPUGPU_FUSED", "1" if fused else "0")
    mp.setenv("CPUGPU_SMEMTREE", smem)
    mp.setenv("CPUGPU_OCCL", "1" if occl else "0")
    if min_nodes is None:
        mp.delenv("CPUGPU_SMEMTREE_MIN_NODES", raising=False)
    else:
        mp.setenv("CPUGPU_SMEMTREE_MIN_NODES", str(min_nodes))


def _layout_env(mp, layout, occl=True):
    for k in FLAG_VARS:
        mp.delenv(k, raising=False)
    for k, v in LAYOUT_ENV[layout].items():
        mp.setenv(k, v)
    mp.setenv("CPUGPU_SMEMTREE_MIN_NODES", "1")
    if not occl:
        mp.setenv("CPUGPU_OCCL", "0")


def _bits(t):
    return t.numpy().tobytes()


def _assert_tables_equal(jdev, tdev):
    """Every table, variant and metadata field of the two snapshots
    bitwise (a JAX table the port keeps as an empty one: the any-hit tree
    on the object-space machinery)."""
    for name, dtype in tscene.TABLE_FIELDS + tscene.VARIANT_FIELDS:
        ref, got = getattr(jdev, name), getattr(tdev, name)
        if ref is None:
            assert got is None or got.numel() == 0, name
            continue
        ref = np.asarray(ref)
        assert got is not None and got.dtype == dtype, name
        assert tuple(got.shape) == ref.shape and _bits(got) == ref.tobytes(), \
            name
    for name in ("proots", "poccl_roots", "num_instances", "packet_flattened",
                 "pfused_nn", "packet_width", "smem_small"):
        assert getattr(tdev, name) == getattr(jdev, name), name


def _jax_device(make):
    with jax.disable_jit():
        return make(jscene, jmat, jmesh).device()


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_variant_tables_vs_jax(case, monkeypatch):
    """Each tree mode, side-table mode and the fused table: the port's
    tables equal JAX's bitwise, and packet_tables / occl_tables hand the
    per-launch and whole-frame callers the same tables in both packages
    (a tree under CPUGPU_SMEMTREE_MIN_NODES only to whole-frame ones)."""
    tree, fused, smem = TABLE_CASES[case]
    for min_nodes in (None, 1):  # a small tree (smem_small), then not
        _set_flags(monkeypatch, tree, fused, smem, min_nodes)
        jdev = _jax_device(golden_scene)
        tdev = golden_scene(tscene, tmat, tmesh).build_device("cpu")
        _assert_tables_equal(jdev, tdev)
        assert tdev.packet_width == (16 if tree == "w16" else 8)
        assert tdev.smem_small == (min_nodes is None and smem in ("1", "48")
                                   and not fused and tree != "w16")
        for wf in (False, True):
            jp, tp = jscene.packet_tables(jdev, wf), tscene.packet_tables(
                tdev, wf)
            assert jp[2] == tp[2]
            for r, g in zip((jp[0], jp[1], jp[3]), (tp[0], tp[1], tp[3])):
                assert (r is None) == (g is None)
                if r is not None:
                    assert _bits(g) == np.asarray(r).tobytes()
            jo, to = jscene.occl_tables(jdev, wf), tscene.occl_tables(tdev, wf)
            assert jo[2] == to[2]
            for r, g in zip((jo[0], jo[1], jo[3]), (to[0], to[1], to[3])):
                assert (r is None) == (g is None)
                if r is not None:
                    assert _bits(g) == np.asarray(r).tobytes()


@pytest.mark.parametrize("case,flat", [
    ("fused_w16", True), ("w16", False), ("fused", False),
    ("fused_w16", False)], ids=["fused_w16-flat", "w16-objspace",
                                "fused-objspace", "fused_w16-objspace"])
def test_instanced_variant_tables_vs_jax(case, flat, monkeypatch):
    """An instanced scene under w16 / fused: flattened, the 16-wide
    world-space copies, the widened TLAS rows and the fused table over
    them; on the object-space machinery the 8-wide sweep_dp fallback and
    no fused table -- bitwise JAX's.  (One flattened case: JAX's op-by-op
    flatten costs seconds per table shape; the 8-wide fused table over
    flattened rows is the refit test's.)"""
    tree, fused, smem = TABLE_CASES[case]
    _set_flags(monkeypatch, tree, fused, smem, 1)
    monkeypatch.setenv("CPUGPU_NO_FLATTEN", "0" if flat else "1")
    jdev = _jax_device(packet_instanced)
    tdev = packet_instanced(tscene, tmat, tmesh).build_device("cpu")
    _assert_tables_equal(jdev, tdev)
    assert tdev.packet_flattened == flat
    assert tdev.packet_width == (16 if flat and tree == "w16" else 8)
    assert (tdev.pfused is not None) == (flat and fused)
    if flat and tree == "w16":
        tlas = tdev.pnodes[tdev.proots[-1]].view(torch.int32)
        assert (tlas[104:112] == ptf.SLIM_EMPTY).all()  # widened rows


@pytest.mark.parametrize("case", ["sweep_dp_ents", "w16", "fused",
                                  "fused_w16"])
def test_flattened_refit_vs_fresh_build(case, monkeypatch):
    """A transform edit of a flattened scene refits its rows, its fused
    table and its side tables in place; every table then equals a fresh
    build at the same transforms bitwise (tests/test_flatten.py:121-133).
    The move carries instance 0 across the others, so the TLAS assigns
    its child slots anew: the side tables' TLAS entries change with it
    (the JAX package's refit leaves them as built)."""
    tree, fused, smem = TABLE_CASES[case]
    _set_flags(monkeypatch, tree, fused, smem, 1)
    monkeypatch.setenv("CPUGPU_NO_FLATTEN", "0")
    tfs = [_flatten_tf(), _flatten_tf(3.0, 0.5, 0.7),
           _flatten_tf(-3.0, 1.5, -1.2, 1.0)]
    target = _flatten_tf(6.0, 0.7, 0.3)
    s = flatten_scene(tscene, tmat, tmesh, [t.copy() for t in tfs])
    dev = s.device("cpu")
    before = {k: getattr(dev, k).clone() for k in ("pfused", "pents")
              if getattr(dev, k) is not None}
    s.set_instance_transform(0, 0, target)
    assert s.device("cpu") is dev  # refit, not rebuilt
    fresh = flatten_scene(tscene, tmat, tmesh,
                          [target] + tfs[1:]).build_device("cpu")
    for name, _ in tscene.TABLE_FIELDS + tscene.VARIANT_FIELDS:
        a, b = getattr(dev, name), getattr(fresh, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert _bits(a) == _bits(b), name
    assert set(before) == ({"pfused"} if fused else {"pents"}
                           if smem == "1" and tree != "w16" else set())
    for k, v in before.items():
        assert not torch.equal(v, getattr(dev, k)), k


@pytest.fixture(scope="module")
def queries():
    """2048 random queries aimed into the golden scene (tests/test_torch_
    xla.py's walk queries): t_init 1e34 or finite, 70% of lanes active,
    96 rays with zero direction components -- along -z, along -y, and in
    the plane x = 0 from an origin on it."""
    rng = np.random.default_rng(11)
    n = 2048
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 2] += 3.0
    d = (rng.normal(size=(n, 3)) * 2.0 - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:32] = [0.0, 0.0, -1.0]
    d[32:64] = [0.0, -1.0, 0.0]
    d[64:96, 0] = 0.0
    o[64:96, 0] = 0.0
    rays = tuple(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                 for a in (o, d) for k in range(3))
    t0 = torch.from_numpy(np.where(rng.uniform(size=n) < 0.5, 1e34,
                                   rng.uniform(1, 15, n)).astype(np.float32))
    act = torch.from_numpy(rng.uniform(size=n) < 0.7)
    return rays, t0, act


def _layout_scene(mp, layout, occl=True):
    """The golden scene built under a layout's flags, and the tables and
    layout keywords its per-launch callers get (packet_tables)."""
    _layout_env(mp, layout, occl)
    dev = golden_scene(tscene, tmat, tmesh).build_device("cpu")
    nodes, ltris, fused_nn, ents = tscene.packet_tables(dev)
    assert ptf.table_layout(nodes, ents, fused_nn, dev.packet_width) == layout
    return dev, (nodes, ltris), dict(fused_nn=fused_nn,
                                     width=dev.packet_width, ents=ents)


def _flat(res):
    return (res[0], res[1], res[2], *res[3], *res[4:])


def _int_bits(cols):
    return [c.view(torch.int32) if c.dtype == torch.float32 else c
            for c in cols]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("layout", list(LAYOUT_ENV))
def test_traverse_host_build_vs_brute_force(queries, layout, any_hit,
                                            monkeypatch):
    """The g++ build of the traversal on each layout against the
    brute-force plain version: closest hits bitwise (t, id, object,
    normal), any hits in existence -- the zero-direction rays over the
    48-col rows' NaN empty slots among them."""
    rays, t0, act = queries
    dev, (nodes, ltris), kw = _layout_scene(monkeypatch, layout)
    args = (rays[:3], rays[3:], t0, nodes, ltris, dev.proots)
    host = tps.traverse_packet_slim_host(*args, active=act, any_hit=any_hit,
                                         count_depth=False, **kw)
    brute = tps.traverse_packet_slim(*args, active=act, any_hit=any_hit,
                                     count_depth=False, **kw)
    hit = host[1] >= 0
    assert int(hit.sum()) > 200 and int(hit[:96].sum()) > 10
    if layout == "48":
        assert torch.isnan(nodes).any()  # empty slots: NaN bounds
    if any_hit:
        assert torch.equal(hit, brute[1] >= 0)
        return
    for a, b in zip(_int_bits(_flat(host)), _int_bits(_flat(brute))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("layout", list(LAYOUT_ENV))
def test_depth_walk_vs_host_build_per_layout(queries, layout, any_hit,
                                             monkeypatch):
    """count_depth's plain version, the walk, on each layout against the
    g++ build of the kernel body, bitwise on every output, bvh_depth
    included; the 16-wide trees are shallower."""
    rays, t0, act = queries
    dev, (nodes, ltris), kw = _layout_scene(monkeypatch, layout)
    args = (rays[:3], rays[3:], t0, nodes, ltris, dev.proots)
    walk = tps.traverse_packet_slim(*args, active=act, any_hit=any_hit, **kw)
    host = tps.traverse_packet_slim_host(*args, active=act, any_hit=any_hit,
                                         **kw)
    for a, b in zip(_int_bits(_flat(walk)), _int_bits(_flat(host))):
        assert torch.equal(a, b)
    assert not walk[4][~act].any() and int(walk[4].max()) > 1
    assert int(walk[4].max()) <= (5 if dev.packet_width == 16 else 7)


# (layout, any-hit tables): with CPUGPU_OCCL=0 the shadow rays walk the
# shading tables, fused and 16-wide ones too
BODY_CASES = [(k, True) for k in LAYOUT_ENV] + [
    ("48", False), ("w16", False), ("fused", False)]


@pytest.fixture(scope="module")
def body_rays():
    """The port's camera rays of tests/test_torch_xla.py (32x16 lanes at
    x = 0.05) and their RNG states."""
    from cpugpupathtracing_tpu_torch.config import CameraConfig
    from cpugpupathtracing_tpu_torch.models import camera as camlib
    from cpugpupathtracing_tpu_torch.utils import rng as rnglib

    w, h = 32, 16
    cam = camlib.to_arrays(CameraConfig(pos=(0.05, 0.5, 7.0), aspect=w / h),
                           "cpu")
    lane = torch.arange(w * h)
    o, d = camlib.lane_rays(cam, lane, w, h)
    rays = tuple(o[:, k].contiguous() for k in range(3)) + tuple(
        d[:, k].contiguous() for k in range(3))
    return rays, rnglib.seed_lanes(lane, 0, salt=0x1CE)


def _bodies(dev, rays, st, settings):
    """pt_frame (the whole-frame route's tables), shade_extend at depth 0
    and shadow_resolve on its shadow rays (the per-depth route's) through
    the g++ build, and the plain versions of the last two."""
    tables, kw = tint.frame_args(dev, settings)
    frame = ptf.pt_frame_host(*tables, rays, st,
                              depths=settings.max_ray_depth + 1, **kw)
    tables, tkw = tint.route_tables(dev)
    ekw = dict(tint.extend_kwargs(dev, settings), **tkw)
    n = st.shape[0]
    one, zero = torch.ones(n), torch.zeros(n)
    args = (*tables, 0, rays, st, (one, one, one), (zero, zero, zero),
            torch.ones(n, dtype=torch.int32))
    ext = tmk.shade_extend_host(*args, **ekw)
    ext_plain = tmk.shade_extend(*args, **ekw)
    sn, sl, skw = tint.shadow_tables(dev)
    sargs = (sn, sl, dev.mk_sph, dev.mk_pln, ext[5], ext[6], ext[7], ext[4],
             ext[3], ext[8])
    sh = tmk.shadow_resolve_host(*sargs, **skw)
    sh_plain = tmk.shadow_resolve(*sargs, **skw)
    return frame, ext, ext_plain, sh, sh_plain


def _cat(out):
    """Every column of a wrapper's output tuple, flattened, as bits."""
    cols = []
    for x in out:
        cols += list(x) if isinstance(x, tuple) else [x.reshape(-1)]
    return _int_bits(cols)


@pytest.mark.parametrize("layout,occl", BODY_CASES,
                         ids=[f"{k}{'' if o else '_shared'}"
                              for k, o in BODY_CASES])
def test_kernel_bodies_per_layout(body_rays, layout, occl, monkeypatch):
    """pt_frame, shade_extend and shadow_resolve through the g++ build on
    each layout equal the same bodies on the plain 64-col tables bitwise
    (energy, state, traced, every carry and shadow column), and their
    state, flags and traced counts equal the plain versions' exactly
    (the g++ build's glibc transcendentals differ from torch's by ULPs,
    so energies are held against the 64-col build, which the card holds
    against the plain versions bitwise)."""
    rays, st = body_rays
    settings = RenderSettings(max_ray_depth=3)
    _layout_env(monkeypatch, "64", occl)
    ref = _bodies(golden_scene(tscene, tmat, tmesh).build_device("cpu"),
                  rays, st, settings)
    dev, _, _ = _layout_scene(monkeypatch, layout, occl)
    got = _bodies(dev, rays, st, settings)
    assert (tscene.occl_tables(dev) is None) == (not occl)
    for r, g in zip(ref, got):
        for a, b in zip(_cat(r), _cat(g)):
            assert torch.equal(a, b)
    frame, ext, ext_plain, sh, sh_plain = got
    plain = ptf.pt_frame(*tint.frame_args(dev, settings)[0], rays, st,
                         depths=4, **tint.frame_args(dev, settings)[1])
    assert torch.equal(frame[1], plain[1]) and int(frame[2]) == int(plain[2])
    assert torch.equal(ext[1], ext_plain[1]) and torch.equal(ext[4],
                                                             ext_plain[4])
    assert int(((ext[4] >> 2) & 1).sum()) > 100
    for a, b in zip(sh, sh_plain):
        assert torch.equal(a, b)


def test_wrapper_layout_checks(queries, monkeypatch):
    """The JAX wrappers' checks: a 48-col table without its side table
    raises; a side table with a layout it does not apply to is dropped
    from a 64-col table and refused with a 48-col one; a table of the
    wrong width raises; the leaf-14 payload, 2-row occlusion leaves and
    16-wide occlusion tables raise where the JAX wrappers raise: occl_rows=2
    without occlusion tables, a 16-wide shadow tree in pt_frame, 16-wide
    rows given as 48-col ones, a payload without occl.  CPU calls (the
    plain versions) count no launch."""
    rays, t0, act = queries
    dev, (nodes, ltris), kw = _layout_scene(monkeypatch, "48")
    args = (rays[:3], rays[3:], t0)
    with pytest.raises(ValueError, match="side table"):
        tps.traverse_packet_slim(*args, nodes, ltris, dev.proots)
    with pytest.raises(ValueError, match="48-col"):
        tps.traverse_packet_slim(*args, nodes, ltris, dev.proots,
                                 ents=dev.pents, fused_nn=3)
    with pytest.raises(ValueError, match="expects 128"):
        ptf.resolve_tables("x", dev.pnodes, dev.pents, width=16)
    assert ptf.resolve_tables("x", dev.pnodes, dev.pents,
                              instanced=True) is None
    assert ptf.resolve_tables("x", dev.pnodes, dev.pents) is dev.pents
    with pytest.raises(ValueError, match="instance machinery"):
        ptf.resolve_tables("x", dev.pnodes, None, fused_nn=4, instanced=True)
    settings = RenderSettings(max_ray_depth=1)
    tables, fkw = tint.frame_args(dev, settings)
    st = torch.zeros(rays[0].shape[0], dtype=torch.int64)
    bare = {k: v for k, v in fkw.items() if not k.startswith("sh_")}
    with pytest.raises(ValueError, match="requires occl tables"):
        ptf.pt_frame(*tables, rays, st, depths=1,
                     **dict(bare, occl=False, occl_rows=2))
    with pytest.raises(ValueError, match="occl_rows must be 1 or 2"):
        ptf.pt_frame(*tables, rays, st, depths=1, **dict(fkw, occl_rows=3))
    wide = dict(fkw, sh_nodes=torch.zeros(4, 128), sh_ents=None)
    with pytest.raises(ValueError, match="expects 64 cols"):
        ptf.pt_frame(*tables, rays, st, depths=1, **wide)
    sn, sl, skw = tint.shadow_tables(dev)
    n = st.shape[0]
    z = tuple(torch.zeros(n) for _ in range(3))
    sargs = (sn, sl, dev.mk_sph, dev.mk_pln, z, z, torch.zeros(n),
             torch.zeros(n, dtype=torch.int32), z, z)
    with pytest.raises(ValueError, match="requires occl tables"):
        tmk.shadow_resolve(*sargs, **dict(skw, occl=False, occl_rows=2))
    with pytest.raises(ValueError, match="split-table kernel"):
        tmk.shadow_resolve(*sargs, **dict(skw, width=4))
    with pytest.raises(ValueError, match="expects 128 cols"):
        tmk.shadow_resolve(sn.new_zeros(4, 64), *sargs[1:],
                           **dict(skw, width=16, ents=None))
    with pytest.raises(ValueError, match="rides the leaf-14 occl tables"):
        tps.traverse_packet_slim(*args, nodes, ltris, dev.proots,
                                 pay=torch.zeros(1, 128), **kw)
    before = dict(ptf.launches)
    tps.traverse_packet_slim(*args, nodes, ltris, dev.proots, **kw)
    tint.trace_advanced_frame(dev, settings, torch.stack(rays[:3], 1),
                              torch.stack(rays[3:], 1), st)
    assert ptf.launches == before


def test_routes_pass_the_selected_tables(body_rays, monkeypatch):
    """Each route hands its kernels the tables of packet_tables /
    occl_tables, as the JAX routes do: the whole-frame route the 48-col
    rows with both side tables, the per-depth route and intersect_scene
    the 64-col rows of a small tree without side tables, the shadow
    launches the any-hit tables; the gate refuses a fused scene."""
    rays, st = body_rays
    _layout_env(monkeypatch, "48")
    monkeypatch.delenv("CPUGPU_SMEMTREE_MIN_NODES")  # the tree is small
    dev = golden_scene(tscene, tmat, tmesh).build_device("cpu")
    assert dev.smem_small and dev.pnodes48 is not None
    seen = []

    def spy(name, fn, nodes_at=0):
        def call(*a, **k):
            seen.append((name, a[nodes_at].shape[1],
                         k.get("ents") is not None,
                         k.get("sh_ents") is not None))
            return fn(*a, **k)
        return call

    monkeypatch.setattr(ptf, "pt_frame", spy("pt_frame", ptf.pt_frame))
    monkeypatch.setattr(tmk, "shade_extend",
                        spy("shade_extend", tmk.shade_extend))
    monkeypatch.setattr(tmk, "shadow_resolve",
                        spy("shadow_resolve", tmk.shadow_resolve))
    monkeypatch.setattr(tps, "traverse_packet_slim",
                        spy("traverse", tps.traverse_packet_slim, 3))
    settings = RenderSettings(max_ray_depth=1)
    o, d = torch.stack(rays[:3], 1), torch.stack(rays[3:], 1)
    tint.trace_advanced_frame(dev, settings, o, d, st)
    tint.trace_advanced_mega(dev, settings, o, d, st)
    tscene.intersect_scene(dev, o, d, torch.full((o.shape[0],), 1e34))
    assert seen == [("pt_frame", 48, True, True),
                    ("shade_extend", 64, False, False),
                    ("shadow_resolve", 64, False, False),
                    ("shade_extend", 64, False, False),
                    ("shadow_resolve", 64, False, False),
                    ("traverse", 64, False, False)]
    _layout_env(monkeypatch, "fused")
    fdev = golden_scene(tscene, tmat, tmesh).build_device("cpu")
    assert tscene.pt_frame_gate_reason(fdev, settings) == \
        "fused packet tables"


def test_scene_cache_follows_the_flags(monkeypatch):
    """Scene.device() rebuilds when a node-table flag changed since the
    snapshot was built (a flag read at build time is never served
    stale), and keeps the snapshot otherwise; the trees of each mode are
    built once per mesh."""
    s = golden_scene(tscene, tmat, tmesh)
    _layout_env(monkeypatch, "64")
    a = s.device("cpu")
    assert s.device("cpu") is a and a.pents is None
    _layout_env(monkeypatch, "w16")
    b = s.device("cpu")
    assert b is not a and b.packet_width == 16
    _layout_env(monkeypatch, "64")
    c = s.device("cpu")
    assert c is not b and _bits(c.pnodes) == _bits(a.pnodes)
    assert set(s.objects[0].blas[1].pw) == {"sweep_dp", "w16"}


def test_w16_fallback_and_stack_bound(monkeypatch):
    """An instanced scene over the flatten budget falls back from w16 to
    8-wide sweep_dp tables on the object-space machinery; a 16-wide tree
    whose worst-case walk exceeds the variant walks' stack raises."""
    _layout_env(monkeypatch, "w16")
    monkeypatch.setenv("CPUGPU_FLATTEN_BUDGET_MB", "0.01")
    s = flatten_scene(tscene, tmat, tmesh)
    dev = s.build_device("cpu")
    assert dev.machinery and dev.packet_width == 8
    assert s.build_info["packet_tree"] == "sweep_dp"
    monkeypatch.delenv("CPUGPU_FLATTEN_BUDGET_MB")
    s = flatten_scene(tscene, tmat, tmesh)
    dev = s.build_device("cpu")
    assert dev.packet_flattened and dev.packet_width == 16
    need = s.build_info["stack_need"]["closest-hit"]
    assert need <= ptf.PT_STACK_W16
    monkeypatch.setattr(tscene, "PT_STACK_W16", need - 1)
    with pytest.raises(RuntimeError, match="traversal stack"):
        flatten_scene(tscene, tmat, tmesh).build_device("cpu")
