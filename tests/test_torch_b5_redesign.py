"""B5's redesign (csrc/whitted.cu and csrc/whitted.cuh; the rows entry
ops/whitted_kernel.py `whitted_frame_rows`) on the CPU, against the JAX
package's trace_whitted run op by op (jax.disable_jit()).

Held against it, on the same inputs: the plain version
`whitted_frame_reference`, the renderer's entry `whitted_frame_rows`
(on CPU tensors its plain version on the rows' columns), and the g++
build of the kernel body through both entries (`whitted_frame_host` on
six columns and on (n, 3) rows) -- the body whose skipped arithmetic
(csrc/whitted.cuh) is the redesign's bitwise claim.

Cases, 512 lanes each (one shape, so op-by-op JAX compiles once): config
1's camera rays at 32x16 cut to 1-5 depths; rays that miss every object;
rays straight into the glass sphere (refraction, total internal
reflection and Beer's law over 5 live depths); and config 1's scene with
a twin of the red and the glass sphere and of the floor, whose rays tie
exactly on t between two objects (the lower kind wins).

Tolerances: state and traced exact everywhere; energy bitwise between
op-by-op JAX, the plain version and the rows entry, with JAX's Beer's-law
exp evaluated by torch (XLA's and torch's f32 exp differ in the last ULP
on a few percent of the lanes leaving the glass sphere;
tests/test_torch_xla.py shares its transcendentals the same way); the
g++ build's
energy within 1e-6 relative of the plain version (glibc's expf against
torch's exp: an ULP on a few lanes leaving the glass sphere, as in
tests/test_torch_whitted.py).  On the card the kernel equals the plain
version bitwise (tests/test_torch_gpu.py)."""

import jax
import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.config import RenderMode as JRenderMode
from cpugpupathtracing_tpu.config import RenderSettings as JRenderSettings
from cpugpupathtracing_tpu.models import materials as jmat
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu.models import whitted as jw
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import whitted_kernel as twk

from tests.test_torch_whitted import _port, _rays, _t
from tests.test_torch_xla import _by_torch, _Proxy

W, H = 32, 16
CAMERA = (0.0, 0.5, 8.0)
GLASS = (0.8, -0.2, 1.5)
CASES = [f"config1_d{k}" for k in range(1, 6)] + ["all_miss", "glass",
                                                  "ties"]


def _tie_scene():
    """Config 1's scene (the JAX package's make_whitted_scene) with a twin
    of the red sphere, of the glass sphere and of the floor, each after
    the original and with another material."""
    s = jw.make_whitted_scene()
    mirror = s.add_material(jmat.Material.diffuse((0.95, 0.95, 0.95),
                                                  specular=1.0))
    green = s.add_material(jmat.Material.diffuse((0.2, 0.8, 0.2)))
    s.add_sphere("Red twin", (-2.5, 0.0, 0.0), 1.0, mirror)
    s.add_sphere("Glass twin", GLASS, 0.8, green)
    s.add_plane("Floor twin", (0.0, -1.2, 0.0), (0.0, 1.0, 0.0), mirror)
    return s


def _case_rays(case, o, d):
    if case == "all_miss":
        return o, np.tile(np.float32([0.0, 0.0, 1.0]), (o.shape[0], 1))
    if case == "glass":
        rng = np.random.default_rng(15)
        tgt = np.float32(GLASS) + rng.uniform(
            -0.35, 0.35, (o.shape[0], 3)).astype(np.float32)
        dd = tgt - o
        return o, (dd / np.linalg.norm(dd, axis=1, keepdims=True)).astype(
            np.float32)
    return o, d


@pytest.fixture(scope="module")
def b5():
    """Per case: the port's scene, the rays (numpy), the depths and JAX
    trace_whitted's (state, energy, traced) run op by op."""
    o, d, st = _rays(W, H, CAMERA)
    scenes = {}
    for name, make in (("config1", jw.make_whitted_scene),
                       ("ties", _tie_scene)):
        jdev = make().device()
        scenes[name] = (jdev, _port(jdev))
    out = {}
    for case in CASES:
        depths = int(case[-1]) if case.startswith("config1") else 5
        jdev, tdev = scenes["ties" if case == "ties" else "config1"]
        co, cd = _case_rays(case, o, d)
        js = JRenderSettings(render_mode=JRenderMode.WHITTED,
                             max_ray_depth=depths - 1)
        with jax.disable_jit(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jw, "jnp", _Proxy(jw.jnp, exp=_by_torch(torch.exp)))
            j_st, j_res = jw.trace_whitted(jdev, js, co, cd, st)
        out[case] = dict(tdev=tdev, o=co, d=cd, st=st, depths=depths,
                         jax=(np.asarray(j_st).astype(np.int64),
                              np.asarray(j_res.energy),
                              int(j_res.traced_rays)))
    return out


def _args(c):
    tdev = c["tdev"]
    tables = (tdev.mk_mats, tdev.mk_lights, tdev.mk_sph, tdev.mk_pln,
              tdev.mk_sph_mat, tdev.mk_pln_mat, tdev.mk_objmat)
    kw = dict(num_lights=tdev.num_lights, num_sph=tdev.num_sph,
              num_pln=tdev.num_pln, depths=c["depths"])
    o, d = _t(c["o"]), _t(c["d"])
    cols = tuple(o[:, k].contiguous() for k in range(3)) + tuple(
        d[:, k].contiguous() for k in range(3))
    return tables, kw, o, d, cols, _t(c["st"], torch.int64)


@pytest.mark.parametrize("case", CASES)
def test_b5_against_jax(b5, case):
    """The plain version, the rows entry and the g++ build of the body
    (six columns and rows) against op-by-op JAX trace_whitted."""
    c = b5[case]
    tables, kw, o, d, cols, st = _args(c)
    j_st, j_en, j_tr = c["jax"]
    ref = twk.whitted_frame_reference(*tables, cols, st, **kw)
    rows = twk.whitted_frame_rows(*tables, o, d, st,
                                  num_mats=c["tdev"].num_mats, **kw)
    hosts = (twk.whitted_frame_host(*tables, cols, st, **kw),
             twk.whitted_frame_host(*tables, None, st, rows=(o, d), **kw))
    for got in (ref, rows) + hosts:
        assert int(got[2]) == j_tr
        np.testing.assert_array_equal(got[1].numpy(), j_st)
    for got in (ref, rows):
        np.testing.assert_array_equal(got[0].numpy(), j_en)
    for got in hosts:
        torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=0.0)
    if case == "all_miss":
        assert j_tr == W * H and not j_en.any()
    if case == "glass":
        assert j_tr > 3 * W * H  # the paths live several depths


def test_b5_ties_resolve_to_the_lower_kind(b5):
    """The tie case really ties: some rays meet the red sphere and its
    twin at the same t (and the floor and its twin), and the nearest hit
    is the original, the lower kind."""
    c = b5["ties"]
    tables, kw, o, d, cols, st = _args(c)
    sph, pln = tables[2], tables[3]
    t, kind = ptf._analytic_tests(
        sph, pln, kw["num_sph"], kw["num_pln"], *cols,
        torch.full((W * H,), 1e34), torch.zeros(W * H, dtype=torch.int32))
    num_sph = kw["num_sph"]
    for orig, twin in ((0, num_sph - 2), (num_sph, num_sph + 1)):
        def t_of(k):
            if k < num_sph:
                return ptf._sphere_t(sph[k], *cols)
            return ptf._plane_t(pln[k - num_sph], *cols)
        tie = (t_of(orig) == t_of(twin)) & (kind == 1 + orig)
        assert int(tie.sum()) > 0
    assert not bool(((kind == num_sph - 1) | (kind == num_sph + 2)).any())


def test_b5_count_arm_host(b5):
    """The g++ build's count arm on the glass rays: `ray` and `sray`
    match the traced total, the per-depth warp and lane trips of a warp
    of one lane equal the live lanes of the plain version's depths, and
    the longest path is the most live depths of one lane."""
    c = b5["glass"]
    tables, kw, o, d, cols, st = _args(c)
    *out, it = twk.whitted_frame_host(*tables, None, st, rows=(o, d),
                                      count_iters=True, **kw)
    it = dict(zip(ptf.COUNTERS, (int(v) for v in it)))
    assert it["ray"] + it["sray"] == int(out[2])
    carry = twk.whitted_carry(cols, st)
    live = torch.zeros(W * H, dtype=torch.int64)
    for _ in range(kw["depths"]):
        live += carry["act"]
        carry = twk.whitted_depth(tables, carry, **{
            k: kw[k] for k in ("num_lights", "num_sph", "num_pln")})
    assert it["ray"] == it["wtrip"] == it["ltrip"] == int(live.sum())
    assert it["longest"] == int(live.max()) >= 4


@pytest.mark.parametrize("layout", ["expanded_origin", "strided_rows"])
def test_b5_rows_entry_layouts(b5, layout):
    """whitted_frame_rows reads any row stride in place: the camera's
    origin expanded over every lane (stride 0) and direction rows of
    stride 4 (a view of wider rows) give the six-column result, through
    the plain version and the g++ build."""
    c = b5["config1_d5"]
    tables, kw, o, d, cols, st = _args(c)
    if layout == "expanded_origin":
        o = o[:1].expand(W * H, 3)
        assert o.stride(0) == 0
        cols = tuple(o[:, k].contiguous() for k in range(3)) + cols[3:]
    else:
        d = torch.cat([d, torch.zeros(W * H, 1)], dim=1)[:, :3]
        assert d.stride(0) == 4
    ref = twk.whitted_frame_reference(*tables, cols, st, **kw)
    rows = twk.whitted_frame_rows(*tables, o, d, st,
                                  num_mats=c["tdev"].num_mats, **kw)
    host = twk.whitted_frame_host(*tables, None, st, rows=(o, d), **kw)
    for got in (rows, host):
        assert torch.equal(got[1], ref[1]) and int(got[2]) == int(ref[2])
    assert torch.equal(rows[0], ref[0])
    torch.testing.assert_close(host[0], ref[0], rtol=1e-6, atol=0.0)


def test_b5_rows_entry_refuses_bad_rows(b5):
    """The launch refuses rows it cannot read in place: a column stride
    other than 1, or the wrong shape."""
    c = b5["config1_d1"]
    tables, kw, o, d, cols, st = _args(c)
    with pytest.raises(ValueError, match="unit column stride"):
        twk.whitted_frame_host(*tables, None, st, rows=(o, d.t().contiguous().t()), **kw)
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        twk.whitted_frame_host(*tables, None, st, rows=(o, d[:, :2]), **kw)
