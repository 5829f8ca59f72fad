"""The port's path-tracing function (cpugpupathtracing_tpu_torch
ops/pt_frame.py and the split-span schedule of models/integrators.py)
against the JAX package, on tests/test_megakernel.py's scene and its
64x32 rays, with the scene tables handed over through scene_from_numpy.

On the CPU `pt_frame` runs its plain version, so these tests hold the
plain version against JAX under the megakernel contract
(tests/test_megakernel.py's _check: traced exact, < 3% boundary flips,
flips < 0.02, mean within 1e-4): torch's sin/cos/exp/rsqrt and XLA's
differ by ULPs, and XLA contracts multiply-adds into FMAs, which moves
near-tangent NEE shadow tests.  The CUDA kernel is held against the
plain version on the card (chip_smoke.py, tests/test_torch_gpu.py);
here its per-ray body is also built with g++ and held against it.

RNG states are compared only on lanes still active at the end of a
span: the TPU kernel keeps stepping a dead lane's state while any lane
of its 1024-lane tile lives, the port freezes it."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from cpugpupathtracing_tpu.config import RenderSettings as JRenderSettings
from cpugpupathtracing_tpu.models import integrators as jint
from cpugpupathtracing_tpu.models import scene as jscene
from cpugpupathtracing_tpu.ops import pt_frame_kernel as pfk
from cpugpupathtracing_tpu_torch.config import RenderSettings
from cpugpupathtracing_tpu_torch.models import integrators as tint
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

from tests.test_megakernel import _check, _scene, _trace
from tests.test_torch_scene import jax_tables

class Traced(NamedTuple):
    """What _check reads of a trace result."""
    energy: object
    traced_rays: object


SETTINGS = {
    "default": dict(max_ray_depth=3),
    "no-nee": dict(max_ray_depth=2, next_event_estimation=False),
}


@pytest.fixture()
def frame(monkeypatch):
    """(JAX DeviceScene, port DeviceScene on the CPU, origin, direction,
    state) for _trace's 64x32 rays, under the benchmark's tree flags."""
    monkeypatch.setattr(jscene, "PACKET_TREE", "sweep_dp")
    monkeypatch.setattr(jscene, "PACKET_OCCL", True)
    jdev = _scene().device()
    tdev = tscene.scene_from_numpy(*jax_tables(jdev), "cpu")
    got = {}

    def grab(dev, settings, o, d, state, idx=None):
        got.update(o=np.array(o), d=np.array(d),
                   s=np.asarray(state).astype(np.int64))
        return state, None

    _trace(jdev, JRenderSettings(), grab)
    return (jdev, tdev, torch.from_numpy(got["o"]), torch.from_numpy(got["d"]),
            torch.from_numpy(got["s"]))


def _rays(o, d):
    return tuple(o[:, k].contiguous() for k in range(3)) + tuple(
        d[:, k].contiguous() for k in range(3))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_plain_matches_jax_integrator(frame, name):
    jdev, tdev, o, d, s = frame
    _, ref = _trace(jdev, JRenderSettings(**SETTINGS[name]),
                    jint.trace_advanced)
    _, got = tint.trace_advanced_frame(tdev, RenderSettings(**SETTINGS[name]),
                                       o, d, s)
    _check(ref, got, SETTINGS[name].get("next_event_estimation", True))


def test_split_schedule_bitwise_single_span(frame):
    """carry_out -> morton8 sort -> carry_in, restored to lane order,
    equals one span per lane: energy, traced and final state."""
    _, tdev, o, d, s = frame
    settings = RenderSettings(max_ray_depth=3)
    idx = torch.arange(o.shape[0], dtype=torch.int32)
    st1, one = tint.trace_advanced_frame(tdev, settings, o, d, s, idx=None)
    st2, two = tint.trace_advanced_frame(tdev, settings, o, d, s, idx=idx)
    assert torch.equal(one.energy, two.energy)
    assert int(one.traced_rays) == int(two.traced_rays)
    assert torch.equal(st1, st2)


def test_sort_wavefront_round_trip(frame):
    """The sort permutes whole lanes (active first) and folds/unfolds the
    flags; restore_lane_order undoes it."""
    _, tdev, o, d, s = frame
    n = o.shape[0]
    g = torch.Generator().manual_seed(7)
    act = (torch.rand(n, generator=g) < 0.6).to(torch.int32)
    spec = (torch.rand(n, generator=g) < 0.3).to(torch.int32)
    c = dict(ray=_rays(o, d), state=s, tp=(o[:, 0], o[:, 1], o[:, 2]),
             en=(d[:, 0], d[:, 1], d[:, 2]), active=act, spec=spec,
             lane=torch.arange(n, dtype=torch.int32))
    out = tint.sort_wavefront(tdev, c)
    k = int(act.sum())
    assert bool(out["active"][:k].all()) and not bool(out["active"][k:].any())
    lane = out["lane"].long()
    assert torch.equal(out["spec"], spec[lane])
    assert torch.equal(out["state"], s[lane])
    back = tint.restore_lane_order(out["lane"], [out["ray"][0], out["spec"]])
    assert torch.equal(back[0], c["ray"][0])
    assert torch.equal(back[1], spec)


def test_carry_layout_vs_jax_kernel(frame, monkeypatch):
    """One interpret-mode run of the JAX Pallas kernel pins the span carry:
    pt_frame(depths=2, carry_out=True) on both sides, 2048 lanes."""
    monkeypatch.setenv("CPUGPU_TPU_FORCE_PACKET", "1")
    jdev, tdev, o, d, s = frame
    kw = tint.frame_kwargs(tdev, RenderSettings())
    jrays = tuple(np.ascontiguousarray(r.numpy()) for r in _rays(o, d))
    ref = pfk.pt_frame(
        jdev.pnodes, jdev.pltris, jdev.mk_mats, jdev.mk_lights,
        jdev.mk_light_tris, jdev.mk_sph, jdev.mk_pln, jdev.mk_sph_mat,
        jdev.mk_pln_mat, jdev.mk_objmat, jrays,
        s.numpy().astype(np.uint32),
        roots=jdev.proots, num_mats=kw["num_mats"],
        num_lights=kw["num_lights"], num_sph=kw["num_sph"],
        num_pln=kw["num_pln"], num_objs=kw["num_objs"], nee=kw["nee"],
        rr=kw["rr"], cosine=kw["cosine"], ref_pdf=kw["ref_pdf"], depths=2,
        interpret=True, sh_nodes=jdev.poccl_nodes, sh_ltris=jdev.poccl_ltris,
        sh_roots=jdev.poccl_roots, occl=True,
        light_tri_meta=jdev.light_tri_meta, carry_out=True)
    got = ptf.pt_frame(*tdev.tables(), _rays(o, d), s, depths=2,
                       carry_out=True, **kw)
    r_rays, r_st, r_tp, r_en, r_fl, r_tr = ref
    g_rays, g_st, g_tp, g_en, g_fl, g_tr = got
    assert int(r_tr) == int(g_tr)
    np.testing.assert_array_equal(g_fl.numpy(), np.asarray(r_fl))
    live = (g_fl.numpy() & 1) == 1
    assert 0.2 < live.mean() < 1.0
    np.testing.assert_array_equal(
        g_st.numpy()[live], np.asarray(r_st).astype(np.int64)[live])
    # rays and throughput: ULP-level transcendental differences only,
    # except on the few lanes a boundary flip sends elsewhere
    for name, r, g in (("rays", r_rays, g_rays), ("throughput", r_tp, g_tp)):
        a = np.stack([np.asarray(x) for x in r], axis=1)
        b = torch.stack(g, dim=1).numpy()
        off = (np.abs(a - b) > 1e-5 + 1e-4 * np.abs(a)).any(axis=1)
        assert off.mean() < 0.03, f"{name}: {off.sum()} lanes off"
    en_ref = np.stack([np.asarray(x) for x in r_en], axis=1)
    en_got = torch.stack(g_en, dim=1).numpy()

    _check(Traced(en_ref, r_tr), Traced(en_got, g_tr), True)


@pytest.mark.parametrize("carry_out", [False, True], ids=["frame", "span"])
def test_kernel_body_host_build_vs_plain(frame, carry_out):
    """Extra check: the CUDA kernel's per-ray body (csrc/pt_device.cuh)
    built with g++ and run lane by lane on the CPU agrees with the plain
    version -- hits bitwise, RNG streams, flags and traced exact, energy
    within the contract (glibc's and torch's sin/cos differ by ULPs)."""
    _, tdev, o, d, s = frame
    kw = tint.frame_kwargs(tdev, RenderSettings(max_ray_depth=3))
    rays = _rays(o, d)
    hh = ptf.closest_hit_host(tdev.pnodes, tdev.pltris, tdev.proots, rays)
    hp = ptf.closest_hit_reference(tdev.pltris, rays)
    for a, b in zip(hh, hp):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    depths = 2 if carry_out else 4
    host = ptf.pt_frame_host(*tdev.tables(), rays, s, depths=depths,
                             carry_out=carry_out, count_iters=True, **kw)
    plain = ptf.pt_frame(*tdev.tables(), rays, s, depths=depths,
                         carry_out=carry_out, **kw)
    iters = dict(zip(ptf.COUNTERS, (int(v) for v in host[-1])))
    assert iters["ray"] + iters["sray"] == int(host[-2])  # rays == traced
    # distinct rows read: one at least where the walks read any, at most
    # every visit and every row of the table
    for visits, rows, table in (("node", "node_rows", tdev.pnodes),
                                ("leaf", "leaf_rows", tdev.pltris),
                                ("snode", "snode_rows", tdev.poccl_nodes),
                                ("sleaf", "sleaf_rows", tdev.poccl_ltris)):
        assert min(iters[visits], 1) <= iters[rows] <= min(
            iters[visits], table.shape[0]), rows
    assert int(host[-2]) == int(plain[-1])
    assert torch.equal(host[1], plain[1])
    if carry_out:
        assert torch.equal(host[4], plain[4])
        energy = (torch.stack(host[3], 1), torch.stack(plain[3], 1))
    else:
        energy = (host[0], plain[0])

    _check(Traced(energy[1], plain[-1]), Traced(energy[0], host[-2]), True)


def test_wrappers_refuse_more_roots_than_the_stack(frame):
    """Roots seed the kernel's fixed traversal stack: more than it holds
    is refused before any launch, never overflowed."""
    _, tdev, o, d, s = frame
    kw = tint.frame_kwargs(tdev, RenderSettings())
    rays = _rays(o, d)
    many = tuple(tdev.proots) * (ptf.PT_STACK + 1)
    with pytest.raises(ValueError, match="roots"):
        ptf.closest_hit_host(tdev.pnodes, tdev.pltris, many, rays)
    with pytest.raises(ValueError, match="sh_roots"):
        ptf.pt_frame_host(*tdev.tables(), rays, s, depths=1,
                          **dict(kw, sh_roots=many))


def test_build_keeps_each_units_nvcc_log(tmp_path, monkeypatch):
    """A build that finds its libraries made reads each unit's nvcc output
    (registers, spills) from beside the library, as the build that made
    them had it; a library without its log is built again.  nvcc is a
    script here that prints its shell's pid, so a unit built again prints
    another line."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do case \"$1\" in\n"
        "  -o) out=$2; shift 2;; *.cu) src=$1; shift;; *) shift;; esac\n"
        "done\n"
        "echo \"ptxas info: $(basename $src) $$\"\n"
        ": > \"$out\"\n")
    nvcc.chmod(0o755)
    out_dir = tmp_path / "kernels"
    out_dir.mkdir()
    for name in ("build_log", "build_dir", "build_seconds"):
        monkeypatch.setattr(ptf, name, getattr(ptf, name))
    monkeypatch.setattr(ptf, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(ptf, "hashed_dir", lambda *a: str(out_dir))
    monkeypatch.setattr(ptf, "_bind", lambda lib, names: {})
    monkeypatch.setattr(ptf, "_check_layout", lambda fns, what: None)
    monkeypatch.setattr(ptf.ctypes, "CDLL", lambda path: None)

    def build():
        monkeypatch.setattr(ptf, "_lib", None)
        ptf.build()
        return ptf.build_log.split("\n")

    first = build()
    assert [ln for ln in first if ln.endswith(".cu:")] == [
        f"{unit}:" for unit, _ in ptf._UNITS]
    assert build() == first
    (out_dir / "liblab2.so.log").unlink()
    again = build()
    changed = [a for a, b in zip(first, again) if a != b]
    assert len(again) == len(first) and len(changed) == 1
    assert changed[0].startswith("ptxas info: lab2.cu ")
