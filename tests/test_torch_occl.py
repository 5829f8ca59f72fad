"""The leaf-side and occlusion variants of the port
(cpugpupathtracing_tpu_torch): CPUGPU_LEAF14 (closest hits over the
any-hit tree's 14-record leaves, with their payload rows), CPUGPU_OCCL2
(any-hit leaves of two rows) and CPUGPU_OCCL_W16 (16-wide any-hit trees),
and the kernel arms that walk them.

  * Builders: bvh8.to_slim_occl with 2-row leaves and at width 16, and
    bvh8.occl_payload, against the JAX package's bitwise
    (tests/test_occl.py's icosphere).
  * Tables: Scene.device() under each flag and side-table mode against
    the JAX package's (op by op; its module constants patched --
    scene.PACKET_LEAF14 / PACKET_OCCL2 / PACKET_OCCL_W16, and
    integrators.PACKET_OCCL2, which it imports by name), bitwise, with
    the whole-frame gate's reason; a flattened instanced scene's, and
    its refit after a move that permutes the TLAS slots against a fresh
    build; the flags' implications and conflicts.
  * Kernel bodies: the g++ build of csrc/pt_device.cuh on each new arm:
    traverse_packet_slim's occl any hit, t-only and leaf-14 closest hit
    over 1- and 2-row and 16-wide trees against brute force (and the
    shading tables' hits) and, with count_depth, the walk bitwise;
    pt_frame's and shadow_resolve's 2-row arms, shadow_resolve's
    16-wide arm and shade_extend's leaf-14 arm against the same bodies
    on the default tables bitwise, and against the plain versions.
  * traverse_packet_slim's plain leaf-14 version against one
    interpret-mode run of the JAX Pallas kernel (1024 rays).
  * Frames: under each flag the frame of each route its gate allows,
    through the g++ bodies, equals the default tables' frame bitwise
    (energy, state, traced), and each route hands its kernels the
    flag's tables.

Scenes: tests/test_golden.py's (a 320-triangle icosphere, a cube, a floor
plane, a sphere light) and tests/test_flatten.py's instanced one; the
rays of tests/test_torch_variants.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.config import BuildOption as JBuildOption
from cpugpupathtracing_tpu.config import RenderSettings as JSettings
from cpugpupathtracing_tpu.models import bvh as jbvh
from cpugpupathtracing_tpu.models import bvh8 as jbvh8
from cpugpupathtracing_tpu.models import integrators as jint
from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import mesh as jmesh
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu.ops import traverse_packet_slim as jtps
from cpugpupathtracing_tpu_torch.config import BuildOption, RenderSettings
from cpugpupathtracing_tpu_torch.config import packet_flags
from cpugpupathtracing_tpu_torch.models import bvh as tbvh
from cpugpupathtracing_tpu_torch.models import bvh8 as tbvh8
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.ops import megakernel as tmk
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from tests.test_torch_instances import _flatten_tf, flatten_scene
from tests.test_torch_scene import golden_scene
from tests.test_torch_variants import _assert_tables_equal, _bits, _cat, \
    _flat, _int_bits, body_rays, queries  # noqa: F401 (fixtures)

FLAGS = {
    "default": {},
    "leaf14": dict(leaf14=True),
    "occl2": dict(occl2=True),
    "occl_w16": dict(w16=True),
}
FLAG_VARS = ("CPUGPU_PACKET_TREE", "CPUGPU_FUSED", "CPUGPU_SMEMTREE",
             "CPUGPU_OCCL", "CPUGPU_LEAF14", "CPUGPU_OCCL2",
             "CPUGPU_OCCL_W16", "CPUGPU_SMEMTREE_MIN_NODES",
             "CPUGPU_FRAMESTACK")


def _set_flags(mp, leaf14=False, occl2=False, w16=False, smem="48",
               min_nodes="1"):
    """Both packages under one set of flags: the JAX module constants
    (scene's, and integrators' PACKET_OCCL2, which it imports by name)
    and the port's environment; side tables for trees of every size
    unless min_nodes is None."""
    mp.setattr(jscene, "PACKET_TREE", "sweep_dp")
    mp.setattr(jscene, "PACKET_FUSED", False)
    mp.setattr(jscene, "PACKET_OCCL", True)
    mp.setattr(jscene, "PACKET_LEAF14", leaf14)
    mp.setattr(jscene, "PACKET_OCCL2", occl2)
    mp.setattr(jscene, "PACKET_OCCL_W16", w16)
    mp.setattr(jint, "PACKET_OCCL2", occl2)
    mp.setattr(jtps, "SMEMTREE_DEFAULT", smem)
    mp.setattr(jtps, "FRAMESTACK_DEFAULT", True)
    for k in FLAG_VARS:
        mp.delenv(k, raising=False)
    mp.setenv("CPUGPU_SMEMTREE", smem)
    for name, on in (("CPUGPU_LEAF14", leaf14), ("CPUGPU_OCCL2", occl2),
                     ("CPUGPU_OCCL_W16", w16)):
        if on:
            mp.setenv(name, "1")
    if min_nodes is not None:
        mp.setenv("CPUGPU_SMEMTREE_MIN_NODES", min_nodes)


def _jax_device(make):
    with jax.disable_jit():
        return make(jscene, jmat, jmesh).device()


# ---- builders ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rows2", "w16", "pay"])
def test_occl_builders_vs_jax(kind):
    """to_slim_occl(rows_per_leaf=2) over a leaf_max-28 collapse, at width
    16, and occl_payload, bitwise the JAX package's on the same mesh; the
    2-row leaves hold every triangle once and their padding is zero."""
    outs = []
    for mesh, bvh, bvh8, opt in ((jmesh, jbvh, jbvh8, JBuildOption),
                                 (tmesh, tbvh, tbvh8, BuildOption)):
        m = mesh.icosphere(subdivisions=2)
        b = bvh.build(m.positions, m.normals, m.indices,
                      opt.SAH_SPLIT_PRIMITIVES, max_leaf_size=8)
        rows = 2 if kind == "rows2" else 1
        w = bvh8.collapse_sah(b, leaf_max=bvh8.OCCL_TRIS * rows,
                              width=16 if kind == "w16" else 8)
        so = bvh8.to_slim_occl(w, rows_per_leaf=rows)
        pay = bvh8.occl_payload(w, b.tri_normal) if kind == "pay" else None
        outs.append((so.nodes, so.ltris, so.max_depth, pay, b.num_triangles))
    (jn, jl, jd, jp, ntri), (tn, tl, td, tp, _) = outs
    assert tn.tobytes() == jn.tobytes() and tl.tobytes() == jl.tobytes()
    assert td == jd
    if kind == "pay":
        assert tp.tobytes() == jp.tobytes()
        ids = tp.view(np.int32)[:, 4:126:9]
        assert sorted(ids[ids >= 0].tolist()) == list(range(ntri))
    wd = tn.shape[1] // 8
    assert wd == (16 if kind == "w16" else 8)
    ccnt = tn[:, 7 * wd:8 * wd].view(np.int32)
    assert int(ccnt[ccnt > 0].sum()) == ntri
    if kind == "rows2":
        assert int(ccnt.max()) > tbvh8.OCCL_TRIS  # some leaf takes two rows
        recs = tl[:, :126].reshape(-1, 9)
        assert int((recs[:, 3:9] != 0).any(axis=1).sum()) == ntri
    with pytest.raises(ValueError, match="8-wide only"):
        tbvh8.to_slim_occl(tbvh8.collapse_sah(
            tbvh.build(*(lambda m: (m.positions, m.normals, m.indices))(
                tmesh.icosphere(subdivisions=1)),
                BuildOption.SAH_SPLIT_PRIMITIVES, max_leaf_size=8),
            leaf_max=14, width=16), rows_per_leaf=2)


# ---- tables ------------------------------------------------------------------


TABLE_CASES = [("leaf14", s) for s in ("48", "1", "0")] + [
    ("occl2", s) for s in ("48", "1", "0")] + [("occl_w16", s)
                                               for s in ("1", "0")]


@pytest.mark.parametrize("flag,smem", TABLE_CASES,
                         ids=[f"{f}-{s}" for f, s in TABLE_CASES])
def test_flag_tables_vs_jax(flag, smem, monkeypatch):
    """Under each flag and side-table mode the port's tables equal JAX's
    bitwise (poccl_pay, the 2-row and 128-col any-hit tables, the side
    tables), for a small tree (smem_small) and not, and survive
    to_numpy / scene_from_numpy; its poccl_width and poccl_rows are the
    flag's; the whole-frame gate gives JAX's reason
    (LEAF14 and OCCL_W16 go per depth); the per-depth route's closest
    hits walk the any-hit tree with the payload under LEAF14
    (integrators.py:763-776 there), its shadow rays the any-hit tree."""
    monkeypatch.setenv("CPUGPU_TPU_FORCE_PACKET", "1")  # JAX's gates
    for min_nodes in (None, "1"):
        _set_flags(monkeypatch, smem=smem, min_nodes=min_nodes,
                   **FLAGS[flag])
        jdev = _jax_device(golden_scene)
        tdev = golden_scene(tscene, tmat, tmesh).build_device("cpu")
        _assert_tables_equal(jdev, tdev)
        assert tdev.poccl_width == jdev.poccl_width == (
            16 if flag == "occl_w16" else 8)
        assert tdev.poccl_rows == (2 if flag == "occl2" else 1)
        assert (tdev.poccl_pay is not None) == (flag == "leaf14")
        back = tscene.scene_from_numpy(*tdev.to_numpy(), "cpu")
        for name, _ in tscene.VARIANT_FIELDS:
            a, b = getattr(back, name), getattr(tdev, name)
            assert (a is None) == (b is None), name
            assert a is None or _bits(a) == _bits(b), name
        assert (back.poccl_width, back.poccl_rows) == (tdev.poccl_width,
                                                       tdev.poccl_rows)
        assert tscene.pt_frame_gate_reason(tdev, RenderSettings()) == \
            jscene.pt_frame_gate_reason(jdev, JSettings())
        tables, tkw = tint.route_tables(tdev)
        sn, sl, skw = tint.shadow_tables(tdev)
        assert sl is tdev.poccl_ltris and skw["occl"]
        assert skw["width"] == tdev.poccl_width
        assert skw["occl_rows"] == tdev.poccl_rows
        if flag != "leaf14":
            assert tables[1] is tdev.pltris and "pay" not in tkw
            continue
        want = ((tdev.poccl_nodes, None) if tdev.smem_small else
                (tdev.poccl_nodes48 if smem == "48" else tdev.poccl_nodes,
                 tdev.poccl_ents))
        assert tables[0] is want[0] and tkw["ents"] is want[1]
        assert tables[1] is tdev.poccl_ltris and tkw["pay"] is tdev.poccl_pay
        assert tkw["roots"] == tdev.poccl_roots


def test_occl_w16_under_smemtree48(monkeypatch):
    """OCCL_W16 under the default CPUGPU_SMEMTREE=48: the JAX build
    raises (its side-table step reads 8-wide any-hit rows it did not
    make, ROADMAP C); the port builds the closest-hit side table and
    48-col rows and none for the 16-wide any-hit tree, whose tables equal
    JAX's under CPUGPU_SMEMTREE=1."""
    _set_flags(monkeypatch, w16=True, smem="1")
    jdev = _jax_device(golden_scene)
    _set_flags(monkeypatch, w16=True, smem="48")
    tdev = golden_scene(tscene, tmat, tmesh).build_device("cpu")
    assert tdev.poccl_ents is None and tdev.poccl_nodes48 is None
    assert _bits(tdev.pnodes48) == tbvh8.slim_bounds48(
        tdev.pnodes.numpy()).tobytes()
    import dataclasses
    _assert_tables_equal(jdev, dataclasses.replace(tdev, pnodes48=None))
    with pytest.raises(UnboundLocalError):
        _jax_device(golden_scene)


@pytest.mark.parametrize("env,err", [
    (dict(CPUGPU_LEAF14="1", CPUGPU_OCCL2="1"), "CPUGPU_OCCL2"),
    (dict(CPUGPU_OCCL_W16="1", CPUGPU_OCCL2="1"), "CPUGPU_OCCL_W16"),
    (dict(CPUGPU_OCCL_W16="1", CPUGPU_LEAF14="1"), "CPUGPU_OCCL_W16"),
], ids=["leaf14+occl2", "w16+occl2", "w16+leaf14"])
def test_flag_conflicts_raise(env, err, monkeypatch):
    """The JAX package's conflicts raise with its messages at every build;
    OCCL2 and OCCL_W16 imply CPUGPU_OCCL, and LEAF14 builds the any-hit
    tables, with CPUGPU_OCCL=0 too."""
    for k in FLAG_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=f"^{err} ") as ei:
        golden_scene(tscene, tmat, tmesh).build_device("cpu")
    assert "cannot combine" in str(ei.value)
    for k in env:
        monkeypatch.delenv(k)
    monkeypatch.setenv("CPUGPU_OCCL", "0")
    name = next(iter(env))
    monkeypatch.setenv(name, "1")
    flags = packet_flags()
    assert flags.occl == (name != "CPUGPU_LEAF14")
    dev = golden_scene(tscene, tmat, tmesh).build_device("cpu")
    assert dev.poccl_roots and dev.poccl_nodes.shape[0] > 0


@pytest.mark.parametrize("flag", ["leaf14", "occl2"])
def test_flattened_tables_and_refit(flag, monkeypatch):
    """A flattened instanced scene under LEAF14 / OCCL2: the any-hit
    tables and payload rows (repacked from the world-space shading
    records) equal JAX's bitwise; after a move that carries instance 0
    across the others (the TLAS assigns its slots anew) the refit equals
    a fresh build bitwise, poccl_pay included (tests/test_occl.py:310)."""
    _set_flags(monkeypatch, **FLAGS[flag])
    monkeypatch.setenv("CPUGPU_NO_FLATTEN", "0")
    jdev = _jax_device(flatten_scene)
    s = flatten_scene(tscene, tmat, tmesh, [t.copy() for t in
                                            (_flatten_tf(),
                                             _flatten_tf(3.0, 0.5, 0.7),
                                             _flatten_tf(-3.0, 1.5, -1.2,
                                                         1.0))])
    dev = s.device("cpu")
    assert dev.packet_flattened
    _assert_tables_equal(jdev, dev)
    assert dev.poccl_rows == (2 if flag == "occl2" else 1)
    before = {k: getattr(dev, k).clone() for k in
              ("poccl_ltris", "poccl_pay", "pents")
              if getattr(dev, k) is not None}
    target = _flatten_tf(6.0, 0.7, 0.3)
    s.set_instance_transform(0, 0, target)
    assert s.device("cpu") is dev  # refit, not rebuilt
    fresh = flatten_scene(tscene, tmat, tmesh, [
        target, _flatten_tf(3.0, 0.5, 0.7),
        _flatten_tf(-3.0, 1.5, -1.2, 1.0)]).build_device("cpu")
    for name, _ in tscene.TABLE_FIELDS + tscene.VARIANT_FIELDS:
        a, b = getattr(dev, name), getattr(fresh, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert _bits(a) == _bits(b), name
    assert set(before) == ({"poccl_ltris", "poccl_pay"} if flag == "leaf14"
                           else {"poccl_ltris"}) | {"pents"}
    for k, v in before.items():
        assert not torch.equal(v, getattr(dev, k)), k


# ---- kernel bodies (the g++ build of csrc/pt_device.cuh) -------------------


def _flag_scene(mp, flag, smem="48"):
    _set_flags(mp, smem=smem, **FLAGS[flag])
    return golden_scene(tscene, tmat, tmesh).build_device("cpu")


# (flag, query): the occl arms of traverse_packet_slim
B4_ARMS = [("default", "any"), ("default", "tonly"), ("occl2", "any"),
           ("occl2", "tonly"), ("occl_w16", "any"), ("occl_w16", "tonly"),
           ("leaf14", "closest"), ("leaf14", "any")]


@pytest.mark.parametrize("flag,query", B4_ARMS,
                         ids=[f"{f}-{q}" for f, q in B4_ARMS])
def test_traverse_occl_arms_host_vs_plain(queries, flag, query, monkeypatch):
    """traverse_packet_slim over the any-hit tree (occl) through the g++
    build: any hits agree with brute force in existence, with t below
    t_init and id 1; the t-only closest hit gives brute force's nearest t
    bitwise, id 1, object -1 and a zero normal; the leaf-14 closest hit
    (pay) equals brute force and the shading tables' closest hit bitwise
    (t, id, object, normal).  With count_depth the g++ build equals the
    walk on every output, bvh_depth included."""
    rays, t0, act = queries
    dev = _flag_scene(monkeypatch, flag)
    nodes, ltris, roots, ents = tscene.occl_tables(dev)
    kw = dict(active=act, any_hit=query == "any", occl=True,
              pay=dev.poccl_pay, occl_rows=dev.poccl_rows,
              width=dev.poccl_width, ents=ents)
    args = (rays[:3], rays[3:], t0, nodes, ltris, roots)
    host = tps.traverse_packet_slim_host(*args, count_depth=False, **kw)
    plain = tps.traverse_packet_slim(*args, count_depth=False, **kw)
    hit = host[1] >= 0
    assert int(hit.sum()) > 200 and torch.equal(hit, plain[1] >= 0)
    if query == "any":
        assert (host[1][hit] == 1).all() and (host[0][hit] < t0[hit]).all()
    else:
        for a, b in zip(_int_bits(_flat(host)), _int_bits(_flat(plain))):
            assert torch.equal(a, b)
        if query == "tonly":
            assert (host[1][hit] == 1).all() and (host[2] == -1).all()
            assert not torch.stack(host[3]).any()
        else:
            pn, pl, _, pe = tscene.packet_tables(dev)
            shade = tps.traverse_packet_slim_host(
                rays[:3], rays[3:], t0, pn, pl, dev.proots, active=act,
                count_depth=False, ents=pe)
            for a, b in zip(_int_bits(_flat(host)), _int_bits(_flat(shade))):
                assert torch.equal(a, b)
    walk = tps.traverse_packet_slim(*args, **kw)
    host = tps.traverse_packet_slim_host(*args, **kw)
    for a, b in zip(_int_bits(_flat(walk)), _int_bits(_flat(host))):
        assert torch.equal(a, b)
    assert int(walk[4].max()) >= 1 and not walk[4][~act].any()


def _bodies(dev, rays, st, settings):
    """pt_frame on the whole-frame route's tables (where its gate takes
    the scene), shade_extend at depth 0 and shadow_resolve on its shadow
    rays on the per-depth route's, through the g++ build, and the plain
    versions of all three."""
    frame = frame_plain = None
    if tscene.pt_frame_gate_reason(dev, settings) is None:
        tables, kw = tint.frame_args(dev, settings)
        depths = settings.max_ray_depth + 1
        frame = ptf.pt_frame_host(*tables, rays, st, depths=depths, **kw)
        frame_plain = ptf.pt_frame(*tables, rays, st, depths=depths, **kw)
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
    return frame, frame_plain, ext, ext_plain, sh, sh_plain


BODY_CASES = [("leaf14", "48"), ("leaf14", "0"), ("occl2", "48"),
              ("occl2", "0"), ("occl_w16", "0")]


@pytest.mark.parametrize("flag,smem", BODY_CASES,
                         ids=[f"{f}-{s}" for f, s in BODY_CASES])
def test_kernel_bodies_per_flag(body_rays, flag, smem, monkeypatch):
    """pt_frame's 2-row arm (OCCL2; the gate sends LEAF14 and OCCL_W16 per
    depth), shade_extend's leaf-14 arm and shadow_resolve's 2-row and
    16-wide arms through the g++ build equal the same bodies on the
    default tables of the same side-table mode bitwise (energy, state,
    traced, every carry and shadow column); their state, flags and
    traced counts equal the plain versions' exactly, and shadow_resolve
    its plain version bitwise (the g++ build's glibc transcendentals
    differ from torch's by ULPs, so energies are held against the default
    bodies, which the card holds against the plain versions bitwise)."""
    rays, st = body_rays
    settings = RenderSettings(max_ray_depth=3)
    ref = _bodies(_flag_scene(monkeypatch, "default", smem), rays, st,
                  settings)
    dev = _flag_scene(monkeypatch, flag, smem)
    got = _bodies(dev, rays, st, settings)
    assert (got[0] is None) == (flag != "occl2")
    for r, g in zip(ref, got):
        if g is None:
            continue
        for a, b in zip(_cat(r), _cat(g)):
            assert torch.equal(a, b)
    frame, frame_plain, ext, ext_plain, sh, sh_plain = got
    if frame is not None:
        assert torch.equal(frame[1], frame_plain[1])
        assert int(frame[2]) == int(frame_plain[2])
    assert torch.equal(ext[1], ext_plain[1]) and torch.equal(ext[4],
                                                             ext_plain[4])
    assert int(((ext[4] >> 2) & 1).sum()) > 100
    for a, b in zip(sh, sh_plain):
        assert torch.equal(a, b)


def test_leaf_arm_launch_keys():
    """Each leaf arm counts under its own key; the arms of the shading
    tables and 8-wide 1-row shadow trees keep theirs."""
    cases = [
        ("pt_frame", "48", dict(occl_rows=2), "pt_frame_48_occl2"),
        ("shade_extend", "48", dict(pay=torch.zeros(1)),
         "shade_extend_48_pay"),
        ("shadow_resolve", "64", dict(occl_rows=2), "shadow_resolve_occl2"),
        ("shadow_resolve", "w16", dict(occl_width=16), "shadow_resolve_ow16"),
        ("shadow_resolve", "48", dict(occl_width=8), "shadow_resolve_48"),
        ("traverse_packet_slim", "w16", dict(occl=True),
         "traverse_packet_slim_w16_occl"),
    ]
    for wrapper, layout, kw, key in cases:
        assert ptf.launch_key(wrapper, layout, leaf=ptf.leaf_arm(**kw)) \
            == key
    assert ptf.launch_key("traverse_packet_slim", "48", depth=True,
                          leaf="pay") == "traverse_packet_slim_48_pay_depth"


# ---- B4 against the JAX kernel ---------------------------------------------


def test_leaf14_plain_vs_jax_kernel(rng_np):
    """traverse_packet_slim's plain leaf-14 closest hit (occl + pay)
    against one interpret-mode run of the JAX Pallas kernel on 1024 rays
    of tests/test_occl.py's icosphere: the same lanes hit; where the
    triangle agrees (all but at most 8 lanes: the interpret run is
    jitted, and XLA's contracted multiply-adds can move t by an ULP and
    flip a hit on an edge) its id, object and normal bitwise and t within
    1e-5."""
    n = 1024
    m = jmesh.icosphere(subdivisions=2)
    b = jbvh.build(m.positions, m.normals, m.indices,
                   JBuildOption.SAH_SPLIT_PRIMITIVES, max_leaf_size=8)
    w = jbvh8.collapse_sah(b, leaf_max=jbvh8.OCCL_TRIS)
    so = jbvh8.to_slim_occl(w)
    pay = jbvh8.occl_payload(w, b.tri_normal)
    o = rng_np.normal(size=(n, 3)).astype(np.float32) * 4
    d = rng_np.normal(size=(n, 3)).astype(np.float32) * 0.5 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.full(n, 1e34, np.float32)
    jt, jid, jobj, jn, _, _ = jtps.traverse_packet_slim(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0),
        jnp.asarray(so.nodes), jnp.asarray(so.ltris), (0,), interpret=True,
        count_depth=False, occl=True, pay=jnp.asarray(pay))
    cols = tuple(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                 for a in (o, d) for k in range(3))
    got = tps.traverse_packet_slim(
        cols[:3], cols[3:], torch.from_numpy(t0), torch.from_numpy(so.nodes),
        torch.from_numpy(so.ltris), (0,), count_depth=False, occl=True,
        pay=torch.from_numpy(pay))
    jid = np.asarray(jid)
    np.testing.assert_array_equal(got[1].numpy() >= 0, jid >= 0)
    assert int((jid >= 0).sum()) > 200
    same = got[1].numpy() == jid
    assert int((~same).sum()) <= 8
    np.testing.assert_array_equal(got[2].numpy()[same], np.asarray(jobj)[same])
    for k in range(3):
        assert got[3][k].numpy()[same].tobytes() == \
            np.asarray(jn[k])[same].tobytes()
    np.testing.assert_allclose(got[0].numpy()[same], np.asarray(jt)[same],
                               rtol=1e-5, atol=1e-5)


# ---- frames ------------------------------------------------------------------


@pytest.mark.parametrize("flag", ["leaf14", "occl2", "occl_w16"])
def test_frames_per_flag_equal_default(body_rays, flag, monkeypatch):
    """A frame (depth 3, both routes where the gate allows: OCCL2 whole
    frame and per depth, LEAF14 and OCCL_W16 per depth) through the g++
    bodies equals the default tables' frame bitwise -- energy, state,
    traced -- and its kernels got the flag's tables: pt_frame and
    shadow_resolve occl_rows=2, shade_extend the payload rows,
    shadow_resolve the 16-wide rows."""
    rays, st = body_rays
    o, d = torch.stack(rays[:3], 1), torch.stack(rays[3:], 1)
    settings = RenderSettings(max_ray_depth=3)
    idx = torch.arange(o.shape[0], dtype=torch.int32)
    seen = []

    def spy(name, fn):
        def call(*a, **k):
            seen.append((name, k.get("occl_rows", 1),
                         k.get("pay") is not None, k.get("width", 8)))
            return fn(*a, **k)
        return call

    monkeypatch.setattr(ptf, "pt_frame", spy("pt_frame", ptf.pt_frame_host))
    monkeypatch.setattr(tmk, "shade_extend",
                        spy("shade_extend", tmk.shade_extend_host))
    monkeypatch.setattr(tmk, "shadow_resolve",
                        spy("shadow_resolve", tmk.shadow_resolve_host))
    frames = {}
    for name in ("default", flag):
        dev = _flag_scene(monkeypatch, name)
        reason = tscene.pt_frame_gate_reason(dev, settings)
        routes = [tint.trace_advanced_mega]
        if reason is None:
            routes.append(tint.trace_advanced_frame)
        else:
            assert name != "default" and name != "occl2"
            assert ("leaf-14" if name == "leaf14" else "16-wide") in reason
        del seen[:]
        frames[name] = [route(dev, settings, o, d, st, idx=idx)
                        for route in routes]
        calls = set(seen)
    base = frames["default"][0]
    for s2, r2 in frames[flag]:
        assert torch.equal(s2, base[0])
        assert torch.equal(r2.energy, base[1].energy)
        assert int(r2.traced_rays) == int(base[1].traced_rays)
    want = {"leaf14": {("shade_extend", 1, True, 8),
                       ("shadow_resolve", 1, False, 8)},
            "occl2": {("shade_extend", 1, False, 8),
                      ("shadow_resolve", 2, False, 8),
                      ("pt_frame", 2, False, 8)},
            "occl_w16": {("shade_extend", 1, False, 8),
                         ("shadow_resolve", 1, False, 16)}}[flag]
    assert calls == want
    assert float(base[1].energy.sum()) > 0
