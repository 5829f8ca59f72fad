"""The port's per-depth pipeline (cpugpupathtracing_tpu_torch
ops/megakernel.py, models/integrators.trace_advanced_mega, the route
gates of models/scene.py and models/renderer.trace_sample) against the
JAX package, on tests/test_megakernel.py's scene and its 64x32 rays,
with the scene tables handed over through scene_from_numpy.

On the CPU the wrappers run their plain versions, so these tests hold the
plain versions against JAX.  Tolerances:
  * integers bitwise: flags, traced counts, RNG state on lanes live at
    the start (the TPU kernel keeps stepping a dead lane's state inside a
    live 1024-lane tile, the port freezes it), sort keys, permutations;
  * energies under the megakernel contract (tests/test_megakernel.py's
    _check: traced exact, < 3% of lanes beyond 3e-6 + 3e-5 |e|, every
    difference < 0.02, means within 1e-4): torch's sin/cos/exp and
    XLA's differ by ULPs and XLA contracts multiply-adds into FMAs, which
    moves near-tangent shadow tests;
  * rays, throughput and shadow rays within 1e-5 + 1e-4 |x| on >= 97% of
    lanes (the same ULP differences, except where a flip sends a lane
    elsewhere);
  * the port's two routes against each other bitwise: both call the same
    shading body and the same energy add, on the CPU (plain versions)
    and in the g++ build of the kernels' per-lane bodies.
The CUDA kernels are held against the plain versions on the card
(chip_smoke.py, tests/test_torch_gpu.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cpugpupathtracing_tpu.config import RenderSettings as JRenderSettings
from cpugpupathtracing_tpu.models import integrators as jint
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu.ops import megakernel as jmk
from cpugpupathtracing_tpu_torch.config import CameraConfig, RenderSettings
from cpugpupathtracing_tpu_torch.models import camera as camlib
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import renderer as trend
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.ops import megakernel as tmk
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.utils import rng as rnglib

from tests.test_megakernel import _check, _scene, _trace
from tests.test_torch_pt_frame import SETTINGS, Traced, _rays
from tests.test_torch_renderer import CASES, GOLDENS, _render
from tests.test_torch_scene import golden_scene, jax_tables

N = 64 * 32
ENV = ("CPUGPU_NO_MEGAKERNEL", "CPUGPU_NO_PTFRAME", "CPUGPU_PTFRAME_SPLIT",
       "CPUGPU_PTFRAME_MAX_NODES", "CPUGPU_FORCE_PTFRAME",
       "CPUGPU_SORT_DEPTHS", "CPUGPU_SHADOW_SORT", "CPUGPU_NO_SORT")


@pytest.fixture()
def frame(monkeypatch):
    """(JAX DeviceScene, port DeviceScene on the CPU, origin, direction,
    state): the scene under the benchmark's tree flags and the 64x32
    row-major camera rays of _trace's camera, which hit the glass ball,
    the floor, the back wall and the mirror sphere.  (_trace's own
    blocked rays all point straight down at the floor: an 8x128 block is
    wider than the image.)"""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jscene, "PACKET_TREE", "sweep_dp")
    monkeypatch.setattr(jscene, "PACKET_OCCL", True)
    jdev = _scene().device()
    tdev = tscene.scene_from_numpy(*jax_tables(jdev), "cpu")
    cam = camlib.to_arrays(CameraConfig(pos=(0.0, 0.0, 6.0), aspect=2.0),
                           "cpu")
    lane = torch.arange(N)
    o, d = camlib.lane_rays(cam, lane, 64, 32)
    return jdev, tdev, o, d, rnglib.seed_lanes(lane, 0, salt=0x7777)


def _jax_trace_rays(jdev):
    """_trace's own rays and states, for holding the port against a JAX
    integrator run through _trace."""
    got = {}

    def grab(dev, settings, o, d, state, idx=None):
        got.update(o=np.array(o), d=np.array(d),
                   s=np.asarray(state).astype(np.int64))
        return state, None

    _trace(jdev, JRenderSettings(), grab)
    return tuple(torch.from_numpy(got[k]) for k in "ods")


def _carry(seed=3):
    """A depth-0 carry made from a numpy seed: throughput in [0.5, 1),
    small energies, 85% of lanes active, 30% specular."""
    r = np.random.default_rng(seed)
    tp = r.uniform(0.5, 1.0, (3, N)).astype(np.float32)
    en = r.uniform(0.0, 0.1, (3, N)).astype(np.float32)
    fl = ((r.random(N) < 0.85).astype(np.int32)
          | ((r.random(N) < 0.3).astype(np.int32) << 1))
    return (tuple(torch.from_numpy(x) for x in tp),
            tuple(torch.from_numpy(x) for x in en), torch.from_numpy(fl))


def _close_share(a, b):
    """Share of lanes whose columns all agree within 1e-5 + 1e-4 |a|."""
    a = np.stack([np.asarray(x) for x in a], axis=1)
    b = np.stack([np.asarray(x) for x in b], axis=1)
    return 1.0 - (np.abs(a - b) > 1e-5 + 1e-4 * np.abs(a)).any(axis=1).mean()


def test_shade_extend_vs_jax_kernel(frame):
    """Plain shade_extend against one interpret-mode run of the JAX Pallas
    kernel at depth 0: flags exact, energy under the contract, state
    equal on live lanes, rays, throughput and shadow rays within ULPs."""
    jdev, tdev, o, d, s = frame
    tp, en, fl = _carry()
    kw = tint.extend_kwargs(tdev, RenderSettings())
    np32 = lambda cols: tuple(jnp.asarray(c.numpy()) for c in cols)  # noqa: E731
    ref = jmk.shade_extend(
        jdev.pnodes, jdev.pltris, jdev.mk_mats, jdev.mk_lights,
        jdev.mk_light_tris, jdev.mk_sph, jdev.mk_pln, jdev.mk_sph_mat,
        jdev.mk_pln_mat, jdev.mk_objmat, jnp.zeros((1,), jnp.int32),
        np32(_rays(o, d)), jnp.asarray(s.numpy().astype(np.uint32)),
        np32(tp), np32(en), jnp.asarray(fl.numpy()),
        interpret=True, **dict(kw, roots=jdev.proots))
    got = tmk.shade_extend(*tdev.tables(), 0, _rays(o, d), s, tp, en, fl,
                           **kw)
    r_rays, r_st, r_tp, r_en, r_fl, r_so, r_sd, r_stm, r_c = ref
    g_rays, g_st, g_tp, g_en, g_fl, g_so, g_sd, g_stm, g_c = got
    np.testing.assert_array_equal(g_fl.numpy(), np.asarray(r_fl))
    live = (fl.numpy() & 1) == 1
    sneed = (g_fl.numpy() >> 2) & 1 == 1
    assert 0.1 < sneed.mean() < live.mean()
    np.testing.assert_array_equal(
        g_st.numpy()[live], np.asarray(r_st).astype(np.int64)[live])
    for name, r, g in (("rays", r_rays, g_rays), ("throughput", r_tp, g_tp)):
        assert _close_share(r, g) >= 0.97, name
    # shadow columns: compared where sneed (the Pallas kernel leaves them
    # unmasked on the other lanes of a live tile, the port zeroes them)
    sh_r = [np.asarray(x)[sneed] for x in (*r_so, *r_sd, r_stm, *r_c)]
    sh_g = [x.numpy()[sneed] for x in (*g_so, *g_sd, g_stm, *g_c)]
    assert _close_share(sh_r, sh_g) >= 0.97
    for x in (*g_so, *g_sd, g_stm, *g_c):
        assert not x.numpy()[~sneed].any()
    traced = int(live.sum() + sneed.sum())
    _check(Traced(np.stack([np.asarray(x) for x in r_en], 1), traced),
           Traced(torch.stack(g_en, 1).numpy(), traced), True)


def test_shadow_resolve_vs_jax_kernel(frame):
    """Plain shadow_resolve against one interpret-mode run of the JAX
    Pallas kernel over the occlusion tables, on the same shadow columns
    (the port's plain shade_extend of a depth-0 carry)."""
    jdev, tdev, o, d, s = frame
    tp, en, fl = _carry()
    _, _, _, en2, fl2, so, sd, stm, contrib = tmk.shade_extend(
        *tdev.tables(), 0, _rays(o, d), s, tp, en, fl, **tint.extend_kwargs(tdev, RenderSettings()))
    j = lambda cols: tuple(jnp.asarray(c.numpy()) for c in cols)  # noqa: E731
    ref = jmk.shadow_resolve(
        jdev.poccl_nodes, jdev.poccl_ltris, jdev.mk_sph, jdev.mk_pln,
        j(so), j(sd), jnp.asarray(stm.numpy()), jnp.asarray(fl2.numpy()),
        j(en2), j(contrib), roots=jdev.poccl_roots, num_sph=tdev.num_sph,
        num_pln=tdev.num_pln, interpret=True, occl=True)
    got = tmk.shadow_resolve(tdev.poccl_nodes, tdev.poccl_ltris, tdev.mk_sph,
                             tdev.mk_pln, so, sd, stm, fl2, en2, contrib,
                             **tint.shadow_kwargs(tdev))
    sneed = ((fl2 >> 2) & 1).numpy() == 1
    lit = (torch.stack(got, 1) != torch.stack(en2, 1)).any(1).numpy()
    assert 0.2 < lit[sneed].mean() < 1.0  # both occluded and lit lanes
    traced = int(sneed.sum())
    _check(Traced(np.stack([np.asarray(x) for x in ref], 1), traced),
           Traced(torch.stack(got, 1).numpy(), traced), True)


_jax_refs: dict = {}


@pytest.mark.parametrize("sort", [True, False], ids=["sort", "nosort"])
@pytest.mark.parametrize("name", list(SETTINGS))
def test_mega_matches_jax_integrator(frame, name, sort):
    """The port's trace_advanced_mega against JAX trace_advanced (its
    XLA integrator, run once per settings case)."""
    jdev, tdev, _, _, _ = frame
    o, d, s = _jax_trace_rays(jdev)
    if name not in _jax_refs:
        _jax_refs[name] = _trace(jdev, JRenderSettings(**SETTINGS[name]),
                                 jint.trace_advanced)[1]
    ref = _jax_refs[name]
    idx = torch.arange(N, dtype=torch.int32) if sort else None
    _, got = tint.trace_advanced_mega(tdev, RenderSettings(**SETTINGS[name]),
                                      o, d, s, idx=idx)
    _check(ref, got, SETTINGS[name].get("next_event_estimation", True))


@pytest.mark.parametrize("route", ["sort", "nosort", "shadow-sort",
                                   "sort-all-depths"])
def test_per_depth_route_bitwise_whole_frame(frame, monkeypatch, route):
    """The per-depth route equals the whole-frame route per lane: energy,
    traced and final state, bitwise (plain versions on the CPU)."""
    _, tdev, o, d, s = frame
    if route == "shadow-sort":
        monkeypatch.setenv("CPUGPU_SHADOW_SORT", "1")
    if route == "sort-all-depths":
        monkeypatch.setenv("CPUGPU_SORT_DEPTHS", "9")
    settings = RenderSettings(max_ray_depth=4)
    idx = None if route == "nosort" else torch.arange(N, dtype=torch.int32)
    sorts = tint.sorts
    st1, one = tint.trace_advanced_frame(tdev, settings, o, d, s)
    st2, two = tint.trace_advanced_mega(tdev, settings, o, d, s, idx=idx)
    assert tint.sorts - sorts == {"nosort": 0, "sort": 3, "shadow-sort": 3,
                                  "sort-all-depths": 4}[route]
    assert torch.equal(one.energy, two.energy)
    assert int(one.traced_rays) == int(two.traced_rays)
    assert torch.equal(st1, st2)


def _rows_read(iters, kind, table):
    """Distinct rows read: one at least where the walks read any, at most
    every visit and every row of the table."""
    assert min(iters[kind], 1) <= iters[f"{kind}_rows"] <= min(
        iters[kind], table.shape[0]), kind


def test_kernel_bodies_host_build(frame, monkeypatch):
    """The CUDA kernels' per-lane bodies (csrc/pt_device.cuh), built with
    g++ and run lane by lane: shade_extend and shadow_resolve agree with
    their plain versions (flags, state and traced exact, energy within
    the contract: glibc's and torch's sin/cos differ by ULPs), and the
    per-depth route through them equals the whole-frame kernel body
    bitwise, sorted or not -- the refactor shares the body by
    construction."""
    _, tdev, o, d, s = frame
    tp, en, fl = _carry()
    kw = tint.extend_kwargs(tdev, RenderSettings())
    args = (*tdev.tables(), 0, _rays(o, d), s, tp, en, fl)
    host = tmk.shade_extend_host(*args, count_iters=True, **kw)
    plain = tmk.shade_extend(*args, **kw)
    assert torch.equal(host[4], plain[4])
    assert torch.equal(host[1], plain[1])
    iters = dict(zip(ptf.COUNTERS, (int(v) for v in host[-1])))
    live, sneed = int((fl & 1).sum()), int(((plain[4] >> 2) & 1).sum())
    assert iters["ray"] == live and iters["sray"] == iters["sleaf"] == 0
    _rows_read(iters, "node", tdev.pnodes)
    _rows_read(iters, "leaf", tdev.pltris)
    _check(Traced(torch.stack(plain[3], 1), 0),
           Traced(torch.stack(host[3], 1), 0), True)
    sh = plain[5:9] + (plain[3],)
    sargs = (tdev.poccl_nodes, tdev.poccl_ltris, tdev.mk_sph, tdev.mk_pln,
             sh[0], sh[1], sh[2], plain[4], sh[4], plain[8])
    s_host = tmk.shadow_resolve_host(*sargs, count_iters=True,
                                     **tint.shadow_kwargs(tdev))
    s_plain = tmk.shadow_resolve(*sargs, **tint.shadow_kwargs(tdev))
    iters = dict(zip(ptf.COUNTERS, (int(v) for v in s_host[-1])))
    assert iters["sray"] == sneed and iters["ray"] == iters["leaf"] == 0
    _rows_read(iters, "snode", tdev.poccl_nodes)
    _rows_read(iters, "sleaf", tdev.poccl_ltris)
    _check(Traced(torch.stack(s_plain, 1), 0),
           Traced(torch.stack(s_host[:3], 1), 0), True)

    monkeypatch.setattr(ptf, "pt_frame", ptf.pt_frame_host)
    monkeypatch.setattr(tmk, "shade_extend", tmk.shade_extend_host)
    monkeypatch.setattr(tmk, "shadow_resolve", tmk.shadow_resolve_host)
    settings = RenderSettings(max_ray_depth=4)
    st1, one = tint.trace_advanced_frame(tdev, settings, o, d, s)
    for idx in (None, torch.arange(N, dtype=torch.int32)):
        st2, two = tint.trace_advanced_mega(tdev, settings, o, d, s, idx=idx)
        assert torch.equal(one.energy, two.energy)
        assert int(one.traced_rays) == int(two.traced_rays)
        assert torch.equal(st1, st2)


def test_sort_keys_vs_jax(frame, rng_np):
    """sort_wavefront(mode="compact"), reorder_key(bits=5) and
    active_bit against JAX, bitwise."""
    jdev, tdev, o, d, s = frame
    tp, en, _ = _carry()
    act = rng_np.integers(0, 2, N).astype(np.int32)
    spec = rng_np.integers(0, 2, N).astype(np.int32)
    assert [tscene.active_bit(m) for m in ("compact", "morton5", "morton8")] \
        == [jscene.active_bit(m) for m in ("compact", "morton5", "morton8")]
    ref = jscene.reorder_key(jdev, jnp.asarray(o.numpy()),
                             jnp.asarray(d.numpy()), jnp.asarray(act), bits=5)
    got = tscene.reorder_key(tdev, o, d, torch.from_numpy(act), bits=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))

    names = ("ray_ox", "ray_oy", "ray_oz", "ray_dx", "ray_dy", "ray_dz")
    jc = {k: jnp.asarray(v.numpy()) for k, v in zip(names, _rays(o, d))}
    jc.update(state=jnp.asarray(s.numpy().astype(np.uint32)),
              active=jnp.asarray(act), is_specular=jnp.asarray(spec),
              lane=jnp.arange(N, dtype=jnp.int32),
              **{f"tp_{a}": jnp.asarray(x.numpy()) for a, x in zip("xyz", tp)},
              **{f"en_{a}": jnp.asarray(x.numpy()) for a, x in zip("xyz", en)})
    ref = jint.sort_wavefront(jdev, jc, jnp.arange(N, dtype=jnp.int32),
                              aovs=False, mode="compact")
    got = tint.sort_wavefront(tdev, dict(
        ray=_rays(o, d), state=s, tp=tp, en=en,
        active=torch.from_numpy(act), spec=torch.from_numpy(spec),
        lane=torch.arange(N, dtype=torch.int32)), mode="compact")
    pairs = [(ref[k], got["ray"][c]) for c, k in enumerate(names)]
    pairs += [(ref[f"tp_{a}"], got["tp"][c]) for c, a in enumerate("xyz")]
    pairs += [(ref[f"en_{a}"], got["en"][c]) for c, a in enumerate("xyz")]
    pairs += [(ref["active"], got["active"]), (ref["is_specular"], got["spec"]),
              (ref["lane"], got["lane"])]
    for r, g in pairs:
        assert np.asarray(r).tobytes() == g.numpy().tobytes()
    np.testing.assert_array_equal(got["state"].numpy(),
                                  np.asarray(ref["state"]).astype(np.int64))


def test_sorted_shadow_resolve_vs_jax(frame):
    """The depth-0 shadow sort (CPUGPU_SHADOW_SORT=1): the port's
    sorted_shadow_resolve equals JAX's sort-resolve-restore glue around
    the same resolve function (the port's plain one, behind a shim), and
    the unsorted resolve, bitwise."""
    jdev, tdev, o, d, s = frame
    tp, en, fl = _carry()
    _, _, _, en2, fl2, so, sd, stm, contrib = tmk.shade_extend(
        *tdev.tables(), 0, _rays(o, d), s, tp, en, fl, **tint.extend_kwargs(tdev, RenderSettings()))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    j = lambda cols: tuple(jnp.asarray(c.numpy()) for c in cols)  # noqa: E731

    class Shim:
        @staticmethod
        def shadow_resolve(nodes, ltris, sph, pln, so_, sd_, stm_, fl_, en_,
                           c_, **_):
            out = tmk.shadow_resolve(
                tdev.poccl_nodes, tdev.poccl_ltris, tdev.mk_sph, tdev.mk_pln,
                tuple(map(t, so_)), tuple(map(t, sd_)), t(stm_), t(fl_),
                tuple(map(t, en_)), tuple(map(t, c_)),
                **tint.shadow_kwargs(tdev))
            return tuple(jnp.asarray(x.numpy()) for x in out)

    ref = jint.sorted_shadow_resolve(
        jdev, Shim, j(so), j(sd), jnp.asarray(stm.numpy()),
        jnp.asarray(fl2.numpy()), j(en2), j(contrib),
        jnp.arange(N, dtype=jnp.int32), static={},
        tables=(jdev.poccl_nodes, jdev.poccl_ltris))
    got = tint.sorted_shadow_resolve(tdev, so, sd, stm, fl2, en2, contrib)
    flat = tmk.shadow_resolve(tdev.poccl_nodes, tdev.poccl_ltris, tdev.mk_sph,
                              tdev.mk_pln, so, sd, stm, fl2, en2, contrib,
                              **tint.shadow_kwargs(tdev))
    for r, g, f in zip(ref, got, flat):
        assert np.asarray(r).tobytes() == g.numpy().tobytes()
        assert torch.equal(g, f)


GATE_CASES = {
    "small-scene": ({}, 5),
    "no-ptframe": ({"CPUGPU_NO_PTFRAME": "1"}, 5),
    "max-nodes-16": ({"CPUGPU_PTFRAME_MAX_NODES": "16"}, 5),
    "max-nodes-2": ({"CPUGPU_PTFRAME_MAX_NODES": "2"}, 5),
    "max-nodes-2-forced": ({"CPUGPU_PTFRAME_MAX_NODES": "2",
                            "CPUGPU_FORCE_PTFRAME": "1"}, 5),
    "unsplit-max-nodes-2": ({"CPUGPU_PTFRAME_MAX_NODES": "2",
                             "CPUGPU_PTFRAME_SPLIT": "0"}, 5),
    "depth-33": ({}, 33),
    "no-megakernel": ({"CPUGPU_NO_MEGAKERNEL": "1"}, 5),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_route_gates_match_jax(frame, monkeypatch, case):
    """For each gate case the port picks the route JAX picks: the same
    pt_frame_active and megakernel_active (the small scene's tree has 4
    node rows), with the JAX packet path forced on as off the TPU."""
    jdev, tdev, *_ = frame
    monkeypatch.setenv("CPUGPU_TPU_FORCE_PACKET", "1")
    env, depth = GATE_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    js, ts = JRenderSettings(max_ray_depth=depth), \
        RenderSettings(max_ray_depth=depth)
    assert tscene.pt_frame_active(tdev, ts) == jscene.pt_frame_active(jdev, js)
    assert tscene.megakernel_active(tdev, ts) == \
        jscene.megakernel_active(jdev, js)


def test_routes_repaired(frame, monkeypatch):
    """trace_sample follows the gates (the whole-frame kernel, else the
    per-depth pipeline, else the XLA integrator trace_advanced, as for
    AOVs), and an unsorted frame of a tree over the unsorted budget goes
    to trace_advanced_mega."""
    _, tdev, o, d, s = frame
    calls = []
    for name in ("trace_advanced_frame", "trace_advanced_mega",
                 "trace_advanced"):
        fn = getattr(tint, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append((_name, k.get("idx") is not None))
            return _fn(*a, **k)
        monkeypatch.setattr(tint, name, spy)
    idx = torch.arange(N, dtype=torch.int32)
    settings = RenderSettings()
    trend.trace_sample(tdev, settings, o, d, s, idx)
    monkeypatch.setenv("CPUGPU_NO_PTFRAME", "1")
    trend.trace_sample(tdev, settings, o, d, s, idx)
    monkeypatch.delenv("CPUGPU_NO_PTFRAME")
    monkeypatch.setenv("CPUGPU_PTFRAME_MAX_NODES", "2")
    monkeypatch.setenv("CPUGPU_FORCE_PTFRAME", "1")
    trend.trace_sample(tdev, settings, o, d, s, None)
    _, res = trend.trace_sample(tdev, RenderSettings(track_aovs=True), o, d,
                                s, idx)
    assert calls == [("trace_advanced_frame", True),
                     ("trace_advanced_mega", True),
                     ("trace_advanced_frame", False),
                     ("trace_advanced_mega", False),
                     ("trace_advanced", True)]
    assert int(res.traced_rays) > N and (res.ray_depth > 0).any()


def test_mesh_lights_over_budget_refused(frame, monkeypatch):
    """A scene whose mesh lights exceed the light table builds, and the
    kernel gates refuse it: trace_sample takes the XLA integrator, as in
    the JAX package, whose sample_light draws the mesh light's triangles
    from tris9."""
    _, _, o, d, st = frame
    monkeypatch.setattr(tscene, "MESH_LIGHT_MAX_TRIS", 4)
    s = golden_scene(tscene, tmat, tmesh)
    light = s.add_material(tmat.Material.light((1.0, 1.0, 1.0), 5.0))
    s.mark_light(s.add_mesh("panel", tmesh.cube(center=(0.0, 4.0, 0.0),
                                                half=0.5), light))
    dev = s.build_device("cpu")
    assert dev.has_mesh_lights and not any(c for _, c in dev.light_tri_meta)
    assert dev.light_tri_count.tolist() == [0, 12]
    settings = RenderSettings()
    assert not tscene.megakernel_active(dev, settings)
    assert not tscene.pt_frame_active(dev, settings)
    calls = []
    xla = tint.trace_advanced
    monkeypatch.setattr(tint, "trace_advanced",
                        lambda *a, **k: calls.append(1) or xla(*a, **k))
    _, res = trend.trace_sample(dev, settings, o, d, st, None)
    assert calls == [1]
    assert torch.isfinite(res.energy).all() and float(res.energy.sum()) > 0


def test_golden_advanced_per_depth_route(monkeypatch):
    """The `advanced` golden through Renderer on the per-depth route
    (CPUGPU_NO_PTFRAME=1): the image and traced counts equal the
    whole-frame route's, so it meets the golden's tolerance too."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    whole = _render(CASES["advanced"])
    calls = []
    mega = tint.trace_advanced_mega
    monkeypatch.setattr(tint, "trace_advanced_mega",
                        lambda *a, **k: calls.append(1) or mega(*a, **k))
    monkeypatch.setenv("CPUGPU_NO_PTFRAME", "1")
    per_depth = _render(CASES["advanced"])
    assert len(calls) == 3
    assert np.array_equal(per_depth.image_u32(), whole.image_u32())
    assert per_depth.stats.total_traced_rays == whole.stats.total_traced_rays
    ref = np.load(GOLDENS)["advanced"]
    delta = np.abs(per_depth.image_u32().view(np.uint8).astype(np.int64)
                   - ref.view(np.uint8).astype(np.int64))
    assert (delta == 0).mean() >= 0.995 and delta.max() <= 32
