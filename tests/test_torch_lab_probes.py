"""The TPU probes L5, L8 and L9 of the port (cpugpupathtracing_tpu_torch
labs/floor_probe.py, launch_probe.py, smem_probe.py) against the JAX
package's tools/floor_probe.py, tools/profile_tpu2.py and
tools/smem_probe.py, on the CPU (the plain versions; the CUDA kernels are
held against them bitwise on the card by tests/test_torch_gpu.py and
chip_smoke.py).

L5: the JAX probe has no function that returns its output (run returns
its time), so the tests build its pallas_call over _probe_kernel in
interpret mode, with the module's K lowered to K_TEST and GROUPS to 1 (a
grid step of one 1024-lane sub-tile; the sub-tiles are independent, so
the grid of four steps covers the same 4096 lanes), on random (64, 64) /
(64, 128) tables and ray columns from numpy's default_rng(0) as its main
makes them.  The port's plain version under the "tpu" layout (the slab
vote over 128-lane rows, the fill from each sub-tile's first lane) holds
t within T_ATOL: the interpret run is jitted and XLA's CPU compiler
contracts the triangle test's multiply-adds into FMAs (5.4e-7 seen; the
slab stage alone agrees bitwise).  Two such runs, the two full stage
sets.  L8: `trivial` / `trivial2` are nested in section_pallas and cannot
run here; the plain version is held against copy_kernel's arithmetic,
x * 2.0 in jnp.  L9: smem_probe._kernel in an interpret pallas_call."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cpugpupathtracing_tpu_torch.labs import common as cm
from cpugpupathtracing_tpu_torch.labs import floor_probe as fp
from cpugpupathtracing_tpu_torch.labs import launch_probe as lp
from cpugpupathtracing_tpu_torch.labs import smem_probe as sp
from tools import floor_probe as jfp
from tools import smem_probe as jsp

LANES = 4096
K_TEST = 16
T_ATOL = 2e-6


@pytest.fixture(scope="module")
def probe_case():
    rng = np.random.default_rng(0)
    cols = [(rng.normal(size=LANES).astype(np.float32) + 0.5)
            for _ in range(6)]
    nodes = rng.normal(size=(64, 64)).astype(np.float32)
    ltris = rng.normal(size=(64, 128)).astype(np.float32)
    return dict(cols=cols, nodes=nodes, ltris=ltris,
                t=(torch.from_numpy(nodes), torch.from_numpy(ltris),
                   tuple(torch.from_numpy(c) for c in cols)))


def _jax_probe(c, stages):
    """t of tools/floor_probe.py's _probe_kernel in interpret mode (K and
    GROUPS lowered; module docstring)."""
    tile = jfp.TILE
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfp, "K", K_TEST)
        mp.setattr(jfp, "GROUPS", 1)
        f = pl.pallas_call(
            functools.partial(jfp._probe_kernel, stages=stages),
            grid=(LANES // tile,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2
            + [pl.BlockSpec((tile,), lambda i: (i,),
                            memory_space=pltpu.VMEM)] * 6,
            out_specs=pl.BlockSpec((tile,), lambda i: (i,),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((LANES,), jnp.float32),
            scratch_shapes=[pltpu.SMEM((jfp.ROWS,), jnp.int32),
                            pltpu.SMEM((jfp.ROWS,), jnp.int32),
                            pltpu.SMEM((jfp.ROWS, jfp.STACK), jnp.int32)],
            interpret=True)
        return np.asarray(f(jnp.asarray(c["nodes"]), jnp.asarray(c["ltris"]),
                            *(jnp.asarray(x) for x in c["cols"])))


@pytest.mark.parametrize("stages", [("ctrl", "loads", "slab", "leaf"),
                                    ("fctrl", "loads", "slab", "leaf")],
                         ids=["ctrl", "fctrl"])
def test_floor_probe_vs_jax_interpret(probe_case, stages):
    want = _jax_probe(probe_case, stages)
    t, entry = fp.floor_probe(stages, *probe_case["t"], k_iters=K_TEST,
                              layout="tpu")
    np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=T_ATOL)
    assert (t.numpy() == want).mean() > 0.5
    assert bool((t != 1.0).all())  # every lane's t moved
    # the control is the TPU row's: one entry per row of 128 lanes
    rows = entry.view(-1, 1024).view(-1, 8, 128)
    assert bool((rows == rows[..., :1]).all())


def test_floor_probe_layouts_couple_their_groups():
    """One lane of a 128-lane row meets a box: under "tpu" its whole row
    moves t on, under "warp" its 32-lane warp alone."""
    n = 1024
    nodes = torch.zeros((64, 64))
    nodes[:, :48] = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]).repeat(8)
    ltris = torch.zeros((64, 128))
    # every ray along +x from (5, 5, 5) misses the boxes [-1, 1]^3; lane
    # 200's, from (-1.5, 0, 0), enters them at 0.5 < t = 1
    rays = [torch.full((n,), 5.0) for _ in range(3)] + \
        [torch.ones(n), torch.zeros(n), torch.zeros(n)]
    rays[0][200], rays[1][200], rays[2][200] = -1.5, 0.0, 0.0
    stages = ("ctrl", "loads", "slab")
    t_tpu, _ = fp.floor_probe(stages, nodes, ltris, tuple(rays), k_iters=1,
                              layout="tpu")
    t_warp, _ = fp.floor_probe(stages, nodes, ltris, tuple(rays), k_iters=1,
                               layout="warp")
    moved_tpu = (t_tpu != 1.0).nonzero().squeeze(1)
    moved_warp = (t_warp != 1.0).nonzero().squeeze(1)
    assert moved_tpu.tolist() == list(range(128, 256))
    assert moved_warp.tolist() == list(range(192, 224))


def test_floor_probe_stage_sets():
    assert len(fp.STAGE_SETS) == 10
    assert fp.launch_key(()) == "floor_probe_loop"
    assert fp.launch_key(("loads", "fctrl")) == "floor_probe_fctrl_loads"
    with pytest.raises(ValueError, match="stage set"):
        fp.stage_set(("slab",))
    # the bound: slab and leaf operations, the control stages bytes only
    ms, by = fp.bound(("ctrl", "loads", "slab", "leaf"), 2_073_600, 2000)
    assert by == "operations" and ms == pytest.approx(
        2_073_600 * 2000 * 8 * (26 + 55) / 67e12 * 1e3)
    assert fp.bound(("ctrl",), 1024, 2000)[1] == "bytes"


def test_trivial_is_copy_kernels_arithmetic():
    x = np.random.default_rng(1).normal(size=1024).astype(np.float32)
    want = np.asarray(jnp.asarray(x) * 2.0)
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(lp.trivial(tx).numpy(), want)
    np.testing.assert_array_equal(lp.trivial2(tx).numpy(),
                                  np.asarray(jnp.asarray(want) * 2.0))


def test_b4_cube_case():
    """The launch probe's cube: every ray meets the near face at 8 - 1.5."""
    ds, o, d, t = lp.cube_case(torch.device("cpu"))
    hit = lp.b4(ds, o, d, t)
    assert bool((hit[1] >= 0).all()) and bool((hit[0] == 6.5).all())


@pytest.mark.parametrize("shape2d", [False, True], ids=["1d", "2d"])
def test_smem_probe_vs_jax_interpret(shape2d):
    words = 4000
    tab = np.arange(words, dtype=np.int32)
    for row in (0, words // 8 - 1):
        f = pl.pallas_call(
            functools.partial(jsp._kernel, shape2d=shape2d),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
            out_shape=jax.ShapeDtypeStruct((1,), jnp.int32), interpret=True)
        jt = jnp.asarray(tab.reshape(-1, 8) if shape2d else tab)
        want = int(f(jt, jnp.full((1,), row, jnp.int32))[0])
        got = sp.smem_probe(torch.from_numpy(tab),
                            torch.full((1,), row, dtype=torch.int32),
                            two_d=shape2d)
        assert int(got) == want == row * 8 + 3


def test_smem_probe_answers(monkeypatch):
    """FAIL only for a refused table above the limit; a refusal of a size
    that fits, or a wrong value, raises."""
    dev, optin = torch.device("cpu"), 4096
    assert sp.probe(1024, False, dev, optin)["ok"]
    labels = [lb for lb, _, _ in sp.sizes(sp.H100_OPTIN_BYTES)]
    assert "opt-in limit + 1 word" in labels and len(labels) == 8

    def refuse(tab, idx, two_d=False):
        raise sp.Refused("refused")

    monkeypatch.setattr(sp, "smem_probe", refuse)
    assert sp.probe(2048, False, dev, optin)["ok"] is False
    with pytest.raises(sp.Refused):
        sp.probe(1024, False, dev, optin)
    monkeypatch.setattr(sp, "smem_probe",
                        lambda tab, idx, two_d=False: torch.zeros(1))
    with pytest.raises(AssertionError, match="want"):
        sp.probe(1024, False, dev, optin)


class _Recorder(list):
    """A lane's stack that records the deepest word written, counts the
    words read and written, and the reads of a word never written (the
    kernel's shared memory holds no zeros there)."""

    def __init__(self, *a):
        super().__init__(*a)
        self.deepest, self.words, self.unwritten = 0, 0, 0
        self.written = {0}  # the seeded word

    def __getitem__(self, k):
        self.words += 1
        self.unwritten += k not in self.written
        return super().__getitem__(k)

    def __setitem__(self, k, v):
        self.deepest = max(self.deepest, k)
        self.words += 1
        self.written.add(k)
        super().__setitem__(k, v)


@pytest.mark.parametrize("control", ["ctrl", "fctrl"])
def test_floor_control_fits_the_stack(control):
    """The plain version's control at the probe's K trips never writes a
    word past the kernel's per-lane stack (fp.STACK words in shared
    memory, csrc/floor_probe.cu), never reads a word it has not written,
    and keeps every entry >= 0 (the kernel takes % ROWS as the low bits);
    control_trace's deepest word and stack words are those the plain
    version's own accesses show (the seeded word 0 aside)."""
    e, sp = list(range(8)), [1] * 8
    stack = [_Recorder([0] * fp.STACK) for _ in range(8)]
    for j in range(8):
        list.__setitem__(stack[j], 0, j + 8)
    for _ in range(fp.K_ITERS):
        fp._control((control,), e, sp, stack)
        assert min(e) >= 0
    assert sum(st.unwritten for st in stack) == 0
    got = [(st.deepest, st.words) for st in stack]
    assert got == fp.control_trace((control,), fp.K_ITERS)
    assert max(d for d, _ in got) < fp.STACK
    # the control fills most of the stack: ctrl's clamp at STACK - 8 and
    # fctrl's at STACK - 18 (then a 9-word frame) are reached
    assert min(d for d, _ in got) >= fp.STACK - 10
    # the yardstick: 4 bytes a word at the shared memory's rate
    ms = fp.control_yardstick((control,), 1024, fp.K_ITERS)
    words = sum(w for _, w in got) * 128
    assert ms == pytest.approx(words * 4 / cm.SMEM_BYTES_PER_S * 1e3)
    assert fp.control_yardstick(("loads",), 1024, fp.K_ITERS) == 0.0


def test_floor_unfused_rate_is_half_the_bound():
    """The unfused figure: the same slab and leaf operations at 128 lanes
    an SM a clock, about half the bound's 67 TFLOP/s."""
    st = ("ctrl", "loads", "slab", "leaf")
    ms, _ = fp.bound(st, 2_073_600, 2000)
    un = fp.unfused_ms(st, 2_073_600, 2000)
    assert un == pytest.approx(fp.operations(st, 2_073_600, 2000)
                               / (132 * 128 * 1.98e9) * 1e3)
    assert 1.9 < un / ms < 2.1

