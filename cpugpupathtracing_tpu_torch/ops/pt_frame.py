"""`pt_frame`: the whole ADVANCED path trace of a batch of rays in one
launch -- per depth the closest hit over the slim 8-wide tables, the
TracePathAdvanced shading body (Source/Main.cpp:396-579), the NEE shadow
any-hit over the occlusion tables plus the analytic occluders, and the
energy add.

It replaces the JAX package's Pallas kernel ops/pt_frame_kernel.py
(`_pt_frame_kernel`, launched by `pt_frame`).  On CUDA tensors the
wrapper launches the hand-written kernel of csrc/pt_frame.cu (per-ray
body in csrc/pt_device.cuh), built with nvcc for sm_90a on first use and
loaded with ctypes.  On CPU tensors it runs `pt_frame_reference`, a
lane-vectorised PyTorch transcription of the same depth loop; nothing
falls back from one to the other.

Exactness.  Both versions draw the per-lane xorshift32 stream in the
order of the JAX package's megakernel._shade_surface and use its
predicates, epsilons and f32 association.  Hits are exact: the kernel
walks the BVH, the plain version tests every leaf record (brute force,
lowest original id first), and both return the bitwise nearest hit.
Transcendentals (sin, cos, exp, rsqrt) may differ from XLA's by ULPs,
which can flip a near-tangent NEE shadow test: the megakernel contract.
Unlike the TPU kernel, which keeps stepping a dead lane's RNG state
while any lane of its 1024-lane tile lives, both versions freeze a lane
the moment its path dies; energy and traced counts are unaffected.

Span mode serves the split-span schedule (models/integrators.py):
`depths` counts this span's depths, `depth_base` offsets the NEE
double-count guard's depth-0 test, `carry_in=(throughput3, energy3,
flags)` continues paths of an earlier span and `carry_out=True` returns
the whole carry: (rays6, state, throughput3, energy3, flags, traced)
with flags = active | is_specular << 1.

Node tables: `nodes` is the closest-hit tree's 64-col 8-wide slim rows,
or a variant of the JAX kernel's arms -- `ents` (the entry side table,
with 64- or 48-col rows), `width=16` (128-col rows), `fused_nn` (the
fused node|leaf table; `ltris` then holds the same leaf rows for the
plain version) -- and the shadow tree's rows 64- or 48-col with or
without `sh_ents`.  The plain 64-col tables launch the kernel's plain arm,
every other layout its variant arm, each counted apart in `launches`
(launch_key).  `occl_rows=2` (the JAX package's CPUGPU_OCCL2) says the
shadow tree's leaves are two rows of 14 records each; it launches the
kernel's 2-row arm.  The plain version is brute force, which no layout
changes: the closest hits over the shading records, the shadow test
over the shadow tree's records (every row of every leaf).  A 16-wide
shadow tree raises, as in the JAX wrapper (its gate sends
CPUGPU_OCCL_W16 scenes to the per-depth route).

RNG states are u32 values carried in int64 tensors (utils/rng.py).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
import types

import numpy as np
import torch

from cpugpupathtracing_tpu_torch.ops import sampling
from cpugpupathtracing_tpu_torch.ops.intersect import (  # noqa: F401
    PLANE_DENOM_EPS,
    SLAB_PAD,
    brute_force_nearest_triangle,
    slab_pass,
)
from cpugpupathtracing_tpu_torch.utils.build import hashed_dir, source_path
from cpugpupathtracing_tpu_torch.utils.device import resolve_device
from cpugpupathtracing_tpu_torch.utils.rng import next_u32_range, u2f, xs32
from cpugpupathtracing_tpu_torch.utils.vecmath import (
    INV_PI,
    PI,
    RAY_NUDGE,
    RAY_TMAX,
    TWO_PI,
    fdiv,
    sqrt,
)

# kernel launches of every wrapper of the port, by arm (launch_key; added
# at an arm's first launch).  Comparisons against the plain versions and
# CPU calls are not counted.
launches: dict = {}
# work counters of count_iters: the kernel's visits (pt::Counters: node,
# leaf, shadow node and shadow leaf rows read, closest-hit and shadow rays
# traversed), the warp trips and lane trips of its walk loops
# (pt::count_trip: lane trips / (32 warp trips) is the share of a warp's
# lanes that work in a trip), the longest walk (shadow_resolve's: the
# most rows one shadow ray visited; 0 elsewhere), then the distinct
# node, leaf, shadow node and shadow leaf rows and leaf-14 payload
# records the launch read (pt::Tree::seen_*)
NUM_COUNTERS = 9
COUNTERS = ("node", "leaf", "snode", "sleaf", "ray", "sray", "wtrip",
            "ltrip", "longest", "node_rows", "leaf_rows", "snode_rows",
            "sleaf_rows", "pay_recs")
# records per occlusion leaf row (models/bvh8.py OCCL_TRIS)
OCCL_TRIS = 14
# per-ray traversal stack of the kernel (csrc/pt_device.cuh PT_STACK): the
# wrappers refuse more roots than it holds, and the scene build
# (models/scene.py) refuses trees whose worst-case walk would not fit
PT_STACK = 64
# the variant arms' stack (csrc/pt_device.cuh PT_STACK_W16): room for the
# 15 siblings a 16-wide row leaves pending per level
PT_STACK_W16 = 128
# the layouts of a node table (table_layout), the first the plain arm's
LAYOUTS = ("64", "ents", "48", "w16", "fused", "fused_w16")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v",
]
HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
# every source of the CUDA build (the build directory hashes them all),
# and per compilation unit the C entry points of its shared library
_SOURCES = ("pt_frame.cu", "megakernel.cu", "traverse.cu", "whitted.cu",
            "lab2.cu", "lab3.cu", "phase_lab.cu", "kernel_lab.cu",
            "floor_probe.cu", "probes.cu",
            "pt_launch.cuh", "pt_device.cuh", "whitted.cuh", "lab_device.cuh")
_UNITS = (
    ("pt_frame.cu", ("pt_frame_launch", "pt_frame_resident")),
    ("megakernel.cu", ("mk_shade_extend_launch", "mk_shadow_resolve_launch")),
    ("traverse.cu", ("traverse_launch", "pt_args_layout")),
    ("whitted.cu", ("whitted_launch", "whitted_resident",
                    "whitted_io_layout")),
    # the traversal labs (labs/)
    ("lab2.cu", ("lab2_launch", "lab2p_launch", "lab_args_layout")),
    ("lab3.cu", ("lab3_launch",)),
    ("phase_lab.cu", ("phase_launch",)),
    ("kernel_lab.cu", ("kernel_lab_launch", "kernel_lab_arms",
                       "kernel_lab_occupancy", "kernel_lab_dual_launch",
                       "kernel_lab_sweep_launch", "kernel_lab_sweep_layout",
                       "kernel_lab_rcp_check")),
    # the TPU probes (labs/floor_probe.py, launch_probe.py, smem_probe.py)
    ("floor_probe.cu", ("floor_launch", "floor_args_layout")),
    ("probes.cu", ("scale2_launch", "smem_probe_launch", "smem_optin",
                   "probe_args_layout")),
)
_HOST_SOURCES = ("pt_host_check.cc", "pt_device.cuh", "whitted.cuh")
_HOST_ENTRIES = ("pt_frame_host", "traverse_host", "whitted_host",
                 "whitted_io_layout",
                 "mk_shade_extend_host", "mk_shadow_resolve_host",
                 "pt_args_layout")
_MAX_SMALL_BYTES = 48 * 1024

_lib = None
build_log = ""      # nvcc's output of the last build (registers, spills)
build_seconds = 0.0
build_dir = ""      # the directory of the last build's shared libraries
_host_lib = None
# one i32 per device: bit 0 set once any launch overflowed a traversal stack
_status: dict = {}
# packed small tables by the identity of the tables they were packed from
# (see _small_tables)
_small_cache: dict = {}
_SMALL_CACHE_MAX = 16


# ---- build and bind --------------------------------------------------------


class _PtArgs(ctypes.Structure):
    """Launch arguments; mirrors struct pt::PtArgs of csrc/pt_device.cuh."""

    _fields_ = [
        ("nodes", ctypes.c_void_p),
        ("ltris", ctypes.c_void_p),
        ("sh_nodes", ctypes.c_void_p),
        ("sh_ltris", ctypes.c_void_p),
        ("small", ctypes.c_void_p),
        ("ray", ctypes.c_void_p * 6),
        ("state", ctypes.c_void_p),
        ("tp_in", ctypes.c_void_p * 3),
        ("en_in", ctypes.c_void_p * 3),
        ("flags_in", ctypes.c_void_p),
        ("ray_out", ctypes.c_void_p * 6),
        ("state_out", ctypes.c_void_p),
        ("tp_out", ctypes.c_void_p * 3),
        ("en_out", ctypes.c_void_p * 3),
        ("flags_out", ctypes.c_void_p),
        ("tr_out", ctypes.c_void_p),
        ("hit_out", ctypes.c_void_p * 7),
        ("depth_out", ctypes.c_void_p),
        ("t_init", ctypes.c_void_p),
        ("active", ctypes.c_void_p),
        ("shadow", ctypes.c_void_p * 10),
        ("iters", ctypes.c_void_p),
        ("seen", ctypes.c_void_p * 5),
        ("inst_inv", ctypes.c_void_p),
        ("inst_nrm", ctypes.c_void_p),
        ("inst_root", ctypes.c_void_p),
        ("ents", ctypes.c_void_p),
        ("sh_ents", ctypes.c_void_p),
        ("pay", ctypes.c_void_p),
        ("status", ctypes.c_void_p),
        ("next", ctypes.c_void_p),
        ("stream", ctypes.c_void_p),
    ] + [(name, ctypes.c_int) for name in (
        "small_words",
        "mat_rows", "light_rows", "ltri_rows", "sph_rows", "pln_rows",
        "obj_rows",
        "num_sph", "num_pln", "num_lights", "nroots", "sh_nroots",
        "mesh_lights", "sh_occl",
        "n", "depths", "depth_base", "nee", "rr", "cosine", "ref_pdf",
        "any_hit", "num_inst",
        "fused_nn", "width", "cols", "sh_cols",
        "occl", "occl_rows", "sh_width",
    )]


def _check_layout(fns: dict, what: str) -> None:
    """Raise unless the build's struct pt::PtArgs has _PtArgs' size and
    field offsets (pt::args_layout: size, depth_out, pay, sh_width): a
    field out of step would shift every later one silently."""
    got = (ctypes.c_longlong * 4)()
    fns["pt_args_layout"](ctypes.addressof(got))
    want = (ctypes.sizeof(_PtArgs), _PtArgs.depth_out.offset,
            _PtArgs.pay.offset, _PtArgs.sh_width.offset)
    if tuple(got) != want:
        raise RuntimeError(f"{what}: PtArgs layout {tuple(got)} (size, "
                           f"depth_out, pay, sh_width) differs from the "
                           f"ctypes mirror's {want}")


# entries that take a second pointer after their arguments (whitted.cu's
# WhittedIO, kernel_lab.cu's SweepArgs); every other entry takes one
_TWO_ARGS = ("whitted_launch", "whitted_resident", "whitted_host",
             "kernel_lab_sweep_launch", "kernel_lab_rcp_check")


def _bind(lib, names) -> dict:
    fns = {}
    for name in names:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (2 if name in _TWO_ARGS else 1)
        fns[name] = fn
    return fns


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> types.SimpleNamespace:
    """Compile every kernel unit (csrc/pt_frame.cu, megakernel.cu,
    traverse.cu, whitted.cu, the labs' lab2.cu, lab3.cu, phase_lab.cu,
    kernel_lab.cu and the probes' floor_probe.cu, probes.cu) for sm_90a,
    one nvcc per unit, all started together, into
    build/torch_kernels/<hash of all sources>/ and load them: a namespace
    of the C launch entries.  Raises if any nvcc fails."""
    global _lib, build_log, build_seconds, build_dir
    if _lib is not None:
        return _lib
    out_dir = hashed_dir("torch_kernels",
                         [source_path("csrc", s) for s in _SOURCES],
                         NVCC_FLAGS)
    t0 = time.perf_counter()
    jobs = []
    for unit, _ in _UNITS:
        out = os.path.join(out_dir, "lib" + unit.replace(".cu", ".so"))
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path("csrc", unit)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((unit, out, tmp, proc))
    logs, failed = [], []
    for unit, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate(timeout=900)
        logs.append(f"{unit}:\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(unit)
        else:
            os.replace(tmp, out)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
    build_seconds = time.perf_counter() - t0
    build_dir = out_dir
    fns = {}
    for unit, names in _UNITS:
        out = os.path.join(out_dir, "lib" + unit.replace(".cu", ".so"))
        fns.update(_bind(ctypes.CDLL(out), names))
    _check_layout(fns, "nvcc build")
    _lib = types.SimpleNamespace(**fns)
    return _lib


def build_host() -> types.SimpleNamespace:
    """g++ build of the kernels' per-lane bodies (csrc/pt_host_check.cc)
    for CPU tests that hold the device code against the plain versions.
    The render path never uses it."""
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    srcs = [source_path("csrc", s) for s in _HOST_SOURCES]
    out = os.path.join(hashed_dir("torch_host", srcs, HOST_FLAGS),
                       "libpt_host.so")
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["g++", *HOST_FLAGS, "-o", tmp, srcs[0]], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
    fns = _bind(ctypes.CDLL(out), _HOST_ENTRIES)
    _check_layout(fns, "g++ build")
    _host_lib = types.SimpleNamespace(**fns)
    return _host_lib


# ---- argument packing (shared by the CUDA and the host build) -------------


def _pack_small(mats, lights, ltri, sph, pln, sphmat, plnmat, objmat,
                light_tri_meta, roots, sh_roots) -> torch.Tensor:
    """The small scene tables as one f32 word array in the layout of
    pt::unpack: f32 mats, lights, light triangles, spheres, planes, then
    the i32 bits of objmat, sphmat, plnmat, light_tri_meta, roots and
    shadow roots."""
    dev = mats.device
    meta = [v for se in light_tri_meta for v in se]
    meta += [0] * (2 * lights.shape[0] - len(meta))
    ints = torch.cat([
        objmat.reshape(-1).to(torch.int32),
        sphmat.reshape(-1).to(torch.int32),
        plnmat.reshape(-1).to(torch.int32),
        torch.tensor(meta + list(roots) + list(sh_roots), dtype=torch.int32,
                     device=dev),
    ])
    return torch.cat([
        mats.reshape(-1), lights.reshape(-1), ltri.reshape(-1),
        sph.reshape(-1), pln.reshape(-1), ints.view(torch.float32),
    ]).contiguous()


def _check(name, x, dtype, dev, shape=None):
    if x.device != dev or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor on {dev}, got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def _small_tables(tables, light_tri_meta, roots, sh_roots) -> torch.Tensor:
    """_pack_small, once per set of tables: a scene's small tables are
    packed on its first launch and reused after, so a launch makes no
    host-to-device copy (which would synchronise the host with the
    stream).  The cache holds the tables themselves, so an id it keys on
    cannot be reused by another tensor while the entry lives."""
    key = (tuple(id(t) for t in tables), tuple(light_tri_meta), tuple(roots),
           tuple(sh_roots))
    hit = _small_cache.get(key)
    if hit is None:
        if len(_small_cache) >= _SMALL_CACHE_MAX:
            _small_cache.pop(next(iter(_small_cache)))
        hit = _small_cache[key] = (tuple(tables), _pack_small(
            *tables, light_tri_meta, roots, sh_roots))
    return hit[1]


def _check_tree(prefix, nodes, ltris, roots, dev, ents=None,
                fused_nn=0) -> None:
    """A slim tree as the kernels take it: (B, 48 | 64 | 128) f32 node
    rows (resolve_tables has checked the columns against the layout),
    (NL, 128) f32 leaf rows, 1 to PT_STACK roots; a side table (R, 8) i32
    of at least B rows; a fused table of fused_nn node rows and then the
    NL leaf rows."""
    _check_roots(f"{prefix}roots", roots)
    _check(f"{prefix}nodes", nodes, torch.float32, dev)
    if nodes.dim() != 2 or nodes.shape[1] not in (48, 64, 128):
        raise ValueError(f"{prefix}nodes: need (B, 48 | 64 | 128) slim node "
                         "rows")
    _check(f"{prefix}ltris", ltris, torch.float32, dev)
    if ltris.dim() != 2 or ltris.shape[1] != 128:
        raise ValueError(f"{prefix}ltris: need (NL, 128) leaf rows")
    if ents is not None:
        _check(f"{prefix}ents", ents, torch.int32, dev)
        if ents.dim() != 2 or ents.shape[1] != 8 or \
                ents.shape[0] < nodes.shape[0]:
            raise ValueError(f"{prefix}ents: need (R >= {nodes.shape[0]}, 8) "
                             "entries, one row per node row")
    if fused_nn and nodes.shape[0] != fused_nn + ltris.shape[0]:
        raise ValueError(f"{prefix}nodes: a fused table holds fused_nn="
                         f"{fused_nn} node rows and the {ltris.shape[0]} "
                         f"leaf rows, not {nodes.shape[0]} rows")


def table_layout(nodes, ents=None, fused_nn=0, width=8) -> str:
    """The layout of a (resolved) node table, one of LAYOUTS: "64" plain
    rows, "ents" 64-col rows with the side table, "48" bounds-only rows
    with it, "w16" 16-wide rows, "fused" / "fused_w16" the fused table."""
    if fused_nn:
        return "fused" if width == 8 else "fused_w16"
    if width == 16:
        return "w16"
    if ents is not None:
        return "48" if nodes.shape[1] == 48 else "ents"
    return "64"


def arm_key(layout: str, sh_layout: str) -> str:
    """A variant arm's key in the launch counts: the closest-hit tree's
    layout, then "+sh" and the shadow tree's where it differs and is not
    the plain 64-col one."""
    if sh_layout in (layout, "64"):
        return layout
    return f"{layout}+sh{sh_layout}"


def launch_key(wrapper: str, layout: str = "64", inst: bool = False,
               depth: bool = False, leaf: str = "") -> str:
    """An arm's key in `launches`:
    "<wrapper>[_inst][_<layout>][_<leaf>][_depth]", the layout
    (table_layout; pt_frame's arm_key) left out for the plain 64-col
    tables and for the 16-wide occlusion rows, whose leaf name "ow16"
    says it; `leaf` names the leaf arms (leaf_arm)."""
    return "_".join([wrapper] + ["inst"] * inst
                    + [layout] * (layout != "64" and leaf != "ow16")
                    + [leaf] * bool(leaf) + ["depth"] * depth)


def leaf_arm(occl=False, pay=None, occl_rows=1, occl_width=8) -> str:
    """The leaf arm's name in launch_key: "occl2" for 2-row occlusion
    leaves (CPUGPU_OCCL2), "pay" for the leaf-14 closest hit with payload
    rows (CPUGPU_LEAF14), "occl" for traverse_packet_slim's other walks
    over occlusion leaves, "ow16" for a shadow walk over 16-wide
    occlusion rows (CPUGPU_OCCL_W16); "" for the arms over the shading
    tables and 8-wide 1-row shadow trees, whose keys are as before."""
    if occl_rows == 2:
        return "occl2"
    if pay is not None:
        return "pay"
    if occl_width == 16:
        return "ow16"
    return "occl" if occl else ""


def count_launch(wrapper: str, layout: str = "64", inst: bool = False,
                 depth: bool = False, leaf: str = "") -> None:
    """Add one to the arm's count in `launches`, where its kernel ran."""
    key = launch_key(wrapper, layout, inst, depth, leaf)
    launches[key] = launches.get(key, 0) + 1


def resolve_tables(what, nodes, ents=None, fused_nn=0, width=8,
                   instanced=False):
    """The JAX wrappers' checks of a node table (traverse_packet_slim.py
    _resolve_width_flags, _resolve_smem and _check_table_width): width 8
    or 16; 16-wide and fused tables never on the instance machinery; a
    side table only on the plain 8-wide split-table arm -- dropped from a
    64-col table where it does not apply, refused with a 48-col one, which
    cannot be walked without it; then the columns the layout needs (64,
    48 with a side table, 128 at width 16 or fused).  Returns the side
    table to use (or None)."""
    if width not in (8, 16):
        raise ValueError(f"{what}: packet node width must be 8 or 16, got "
                         f"{width}")
    if instanced and (width == 16 or fused_nn):
        raise ValueError(f"{what}: 16-wide and fused packet tables do not "
                         "support the instance machinery (flatten the scene)")
    if ents is None:
        if nodes.shape[1] == 48:
            raise ValueError(f"{what}: a 48-col bounds-only node table "
                             "requires the entry side table (ents)")
    elif instanced or fused_nn or width != 8:
        if nodes.shape[1] == 48:
            raise ValueError(f"{what}: 48-col node tables need the "
                             "non-instanced 8-wide split-table kernel")
        ents = None
    expect = 128 if (width == 16 or fused_nn) else (
        48 if ents is not None and nodes.shape[1] == 48 else 64)
    if nodes.dim() != 2 or nodes.shape[1] != expect:
        raise ValueError(
            f"{what}: packet node table has {tuple(nodes.shape)} but width="
            f"{width} fused_nn={fused_nn} expects {expect} cols")
    return ents


def check_occl_rows(what: str, occl_rows: int, occl: bool) -> None:
    """The JAX wrappers' checks of occl_rows: 1 or 2, and 2 (CPUGPU_OCCL2)
    only with occlusion tables."""
    if occl_rows not in (1, 2):
        raise ValueError(f"{what}: occl_rows must be 1 or 2")
    if occl_rows == 2 and not occl:
        raise ValueError(f"{what}: occl_rows=2 (CPUGPU_OCCL2) requires "
                         "occl tables")


def check_pay(what: str, pay, ltris, dev) -> None:
    """The leaf-14 payload rows: (NO, 128) f32 on the leaf rows' device,
    one row per occlusion leaf row."""
    _check(f"{what} pay", pay, torch.float32, dev)
    if tuple(pay.shape) != tuple(ltris.shape):
        raise ValueError(f"{what}: pay needs one (128,) row per occlusion "
                         f"leaf row, {tuple(ltris.shape)}, got "
                         f"{tuple(pay.shape)}")


def launch_args(dev, nodes, ltris, sh_nodes, sh_ltris, tables, rays, *, n,
                roots, sh_roots, occl=False, light_tri_meta=(), num_sph=0,
                num_pln=0, num_lights=0, nee=False, rr=False, cosine=False,
                ref_pdf=False, depths=1, depth_base=0,
                inst=None, ents=None, sh_ents=None, fused_nn=0,
                width=8, sh_width=None, tree_occl=False, occl_rows=1,
                pay=None) -> _PtArgs:
    """Checked launch arguments of any kernel of csrc/ over n lanes: the
    closest-hit tree, the shadow tree (both None, with no roots, for the
    Whitted kernel, which walks none), the eight small tables (f32 mats,
    lights, light triangles, spheres, planes; i32 sphmat, plnmat,
    objmat), six (n,) f32 ray columns (or None: the caller sets them),
    the mode and the stream; `inst`
    the instance tables (check_instances) of a walk on the object-space
    machinery; the node layout of the closest-hit tree (ents, fused_nn,
    width, as resolve_tables resolved them) and the shadow tree's side
    table (the shadow tree is the closest-hit tree's layout unless occl,
    when it is split and sh_width wide, 8 by default); `tree_occl` when
    the closest-hit tree is an occlusion tree (traverse_packet_slim's
    occl arms), `occl_rows` the rows per leaf of the occlusion tree, `pay`
    its leaf-14 payload rows.  The caller sets the per-lane column
    pointers."""
    if nodes is not None:
        _check_tree("", nodes, ltris, roots, dev, ents, fused_nn)
        _check_tree("sh_", sh_nodes, sh_ltris, sh_roots, dev, sh_ents,
                    0 if occl else fused_nn)
    elif roots or sh_roots:
        raise ValueError("roots given without a tree")
    for k, t in enumerate(tables):
        _check(f"table {k}", t, torch.int32 if k >= 5 else torch.float32, dev)
    for c in range(6 if rays is not None else 0):
        _check(f"rays[{c}]", rays[c], torch.float32, dev, (n,))
    small = _small_tables(tables, light_tri_meta, roots, sh_roots)
    if small.numel() * 4 > _MAX_SMALL_BYTES:
        raise ValueError("small scene tables exceed the kernel's 48 KB of "
                         "shared memory")
    mats, lights, ltri, sph, pln, sphmat, plnmat, objmat = tables
    a = _PtArgs()
    if nodes is not None:
        a.nodes, a.ltris = nodes.data_ptr(), ltris.data_ptr()
        a.sh_nodes, a.sh_ltris = sh_nodes.data_ptr(), sh_ltris.data_ptr()
    a.small = small.data_ptr()
    for c in range(6 if rays is not None else 0):
        a.ray[c] = rays[c].data_ptr()
    a.small_words = small.numel()
    a.mat_rows, a.light_rows = mats.shape[0], lights.shape[0]
    a.ltri_rows, a.sph_rows, a.pln_rows = (ltri.shape[0], sph.shape[0],
                                           pln.shape[0])
    a.obj_rows = objmat.shape[0]
    a.num_sph, a.num_pln, a.num_lights = num_sph, num_pln, num_lights
    a.nroots, a.sh_nroots = len(roots), len(sh_roots)
    a.mesh_lights = int(any(c for _, c in light_tri_meta))
    a.sh_occl, a.occl, a.occl_rows = int(occl), int(tree_occl), occl_rows
    if pay is not None:
        a.pay = pay.data_ptr()
    a.n, a.depths, a.depth_base = n, depths, depth_base
    a.nee, a.rr, a.cosine, a.ref_pdf = int(nee), int(rr), int(cosine), \
        int(ref_pdf)
    if inst is not None:
        inst_inv, inst_nrm, inst_root = inst
        a.inst_inv, a.inst_root = inst_inv.data_ptr(), inst_root.data_ptr()
        if inst_nrm is not None:
            a.inst_nrm = inst_nrm.data_ptr()
        a.num_inst = inst_root.shape[0]
    if nodes is not None:
        a.cols, a.sh_cols = nodes.shape[1], sh_nodes.shape[1]
        a.fused_nn, a.width = fused_nn, width
        a.sh_width = sh_width or (8 if occl else width)
        if ents is not None:
            a.ents = ents.data_ptr()
        if sh_ents is not None:
            a.sh_ents = sh_ents.data_ptr()
    else:
        a.width = a.sh_width = 8
    a.status = _status_tensor(dev).data_ptr()
    if dev.type == "cuda":
        a.stream = torch.cuda.current_stream(dev).cuda_stream
    return a


def check_instances(dev, inst_inv, inst_root, inst_nrm=None):
    """The instance tables of a kernel wrapper's object-space arm, checked
    ((I, 12) f32 inst_inv, (I,) i32 inst_root, (I, 9) f32 inst_nrm or
    None), as launch_args takes them; None when no instance table is
    given.  Raises when only some are."""
    if inst_inv is None and inst_root is None and inst_nrm is None:
        return None
    if inst_inv is None or inst_root is None:
        raise ValueError("the instance arm needs inst_inv and inst_root")
    i = inst_root.shape[0]
    if i == 0:
        raise ValueError("the instance arm needs at least one instance")
    _check("inst_inv", inst_inv, torch.float32, dev, (i, 12))
    _check("inst_root", inst_root, torch.int32, dev, (i,))
    if inst_nrm is not None:
        _check("inst_nrm", inst_nrm, torch.float32, dev, (i, 9))
    return inst_inv, inst_nrm, inst_root


def count_rows(a: _PtArgs, dev, trees, pay=None):
    """count_iters: zeroed work counters and one byte map per row of each
    walked tree's nodes and leaves, set into `a`.  `trees` maps slot 0
    (closest-hit) and/or 1 (shadow) to (nodes, ltris); a shadow walk over
    the closest-hit tables shares its maps.  With the leaf-14 payload rows
    `pay`, one byte per payload record too.  Returns the (iters, maps)
    that `counters` reads after the launch."""
    iters = torch.zeros(NUM_COUNTERS, dtype=torch.int64, device=dev)
    a.iters = iters.data_ptr()
    maps = [None] * 5
    if pay is not None:
        maps[4] = torch.zeros(pay.shape[0] * OCCL_TRIS, dtype=torch.uint8,
                              device=dev)
    for slot, (nodes, ltris) in trees.items():
        other = trees.get(1 - slot)
        if slot == 1 and other is not None and other[0] is nodes:
            maps[2], maps[3] = maps[0], maps[1]
            continue
        sizes = [nodes.shape[0], ltris.shape[0]]
        maps[2 * slot], maps[2 * slot + 1] = torch.zeros(
            sum(sizes), dtype=torch.uint8, device=dev).split(sizes)
    for k in range(5):
        if maps[k] is not None:
            a.seen[k] = maps[k].data_ptr()
    return iters, maps


def counters(iters, maps) -> torch.Tensor:
    """The fourteen counts of COUNTERS: the kernel's six visit counts,
    two trip counts and its longest walk, then the distinct rows read of nodes, ltris,
    sh_nodes and sh_ltris (0 for a tree not walked, and for the shadow
    tree when it is the closest-hit tree, whose rows then count once) and
    the payload records read."""
    zero = torch.zeros((), dtype=torch.int64, device=iters.device)
    rows = [zero if m is None else m.sum(dtype=torch.int64) for m in maps]
    if maps[2] is maps[0] and maps[0] is not None:
        rows[2] = rows[3] = zero
    return torch.cat([iters, torch.stack(rows)])


def run_launch(entry, a: _PtArgs, what: str) -> None:
    rc = entry(ctypes.addressof(a))
    if rc != 0:
        raise RuntimeError(f"{what} launch failed (error {rc})")


def _status_tensor(dev) -> torch.Tensor:
    key = str(dev)
    if key not in _status:
        _status[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _status[key]


def check_status(device="cuda") -> None:
    """Raise if any launch on `device` overflowed a per-ray traversal
    stack (the scene build refuses trees that could; this reads the
    kernel's own flag, and synchronises)."""
    st = _status.get(str(resolve_device(device)))
    if st is not None and int(st.item()) != 0:
        raise RuntimeError("pt_frame: a traversal stack overflowed; the "
                           "scene's tree is deeper than the kernel's stack")


# ---- the entry point -------------------------------------------------------


def pt_frame(
    nodes, ltris, mats, lights, ltri, sph, pln, sphmat, plnmat, objmat,
    rays, state,
    *, roots, num_mats, num_lights, num_sph, num_pln, num_objs,
    nee, rr, cosine, ref_pdf, depths,
    sh_nodes=None, sh_ltris=None, sh_roots=None, occl=False,
    count_iters=False, light_tri_meta=(), depth_base=0, carry_in=None,
    carry_out=False, fused_nn=0, width=8, ents=None, sh_ents=None,
    occl_rows=1,
):
    """Full advanced path trace of rays (6-tuple of (N,) f32) with RNG
    state (N,) (int64 carrying u32).  The arguments are those of the JAX
    package's pt_frame without its TPU schedule flags: the node-table
    variants fused_nn, width, ents (closest-hit tree) and sh_ents (the
    8-wide shadow tree) as the module docstring says, and occl_rows (1 or
    2: the rows per leaf of the occlusion shadow tree).

    Returns (energy (N, 3) f32, state' (N,), traced () int64), or with
    carry_out=True (rays6, state', throughput3, energy3, flags (N,) i32,
    traced).  count_iters=True appends an int64 tensor of the kernel's
    fourteen work counts (CUDA only; names in COUNTERS): closest-hit node
    rows and leaf rows visited, shadow node rows and leaf rows visited,
    closest-hit rays and shadow rays traversed, the walk loops' warp
    trips and lane trips, 0 (the longest walk is shadow_resolve's), then how many distinct rows of each of the four
    tables (nodes, ltris, sh_nodes, sh_ltris)
    the launch read (the shadow ones 0 when the shadow rays walk the
    closest-hit tables, whose rows then count once) and 0 payload
    records.

    sh_* are the any-hit tables (bvh8.to_slim_occl when occl=True); when
    absent the shadow rays walk the closest-hit tables."""
    del num_mats, num_objs  # read from the table shapes
    check_occl_rows("pt_frame", occl_rows, occl)
    layout_kw = _frame_layouts("pt_frame", nodes, sh_nodes, ents, sh_ents,
                               fused_nn, width, occl)
    sh_nodes, sh_ltris, sh_roots = _shadow_tables(
        nodes, ltris, roots, sh_nodes, sh_ltris, sh_roots, occl)
    nee = nee and num_lights > 0
    kw = dict(num_lights=num_lights, num_sph=num_sph, num_pln=num_pln,
              nee=nee, rr=rr, cosine=cosine, ref_pdf=ref_pdf, depths=depths,
              light_tri_meta=light_tri_meta, depth_base=depth_base,
              carry_in=carry_in, carry_out=carry_out)
    tables = (mats, lights, ltri, sph, pln, sphmat, plnmat, objmat)
    dev = state.device
    if dev.type == "cpu":
        if count_iters:
            raise ValueError("count_iters needs the CUDA kernel")
        return pt_frame_reference(
            ltris, *tables, rays, state,
            sh_records=leaf_records(sh_ltris, occl=True) if occl else None,
            **kw)
    if dev.type != "cuda":
        raise ValueError(f"pt_frame runs on cuda or cpu tensors, not {dev}")
    out = _launch(build().pt_frame_launch, dev, nodes, ltris, sh_nodes,
                  sh_ltris, tables, rays, state, roots=roots,
                  sh_roots=sh_roots, occl=occl, count_iters=count_iters,
                  occl_rows=occl_rows, **layout_kw, **kw)
    count_launch("pt_frame", arm_key(
        table_layout(nodes, layout_kw["ents"], fused_nn, width),
        table_layout(sh_nodes, layout_kw["sh_ents"], 0 if occl else fused_nn,
                     8 if occl else width)), leaf=leaf_arm(
                         occl_rows=occl_rows))
    return out


def pt_frame_host(
    nodes, ltris, mats, lights, ltri, sph, pln, sphmat, plnmat, objmat,
    rays, state, *, roots, num_lights, num_sph, num_pln, nee, rr, cosine,
    ref_pdf, depths, sh_nodes=None, sh_ltris=None, sh_roots=None,
    occl=False, light_tri_meta=(), depth_base=0, carry_in=None,
    carry_out=False, count_iters=False, fused_nn=0, width=8, ents=None,
    sh_ents=None, occl_rows=1, **_,
):
    """`pt_frame` through the g++ build of the kernel body, on CPU
    tensors: a test of the device code without a card."""
    check_occl_rows("pt_frame", occl_rows, occl)
    layout_kw = _frame_layouts("pt_frame", nodes, sh_nodes, ents, sh_ents,
                               fused_nn, width, occl)
    sh_nodes, sh_ltris, sh_roots = _shadow_tables(
        nodes, ltris, roots, sh_nodes, sh_ltris, sh_roots, occl)
    return _launch(
        build_host().pt_frame_host, torch.device("cpu"), nodes, ltris,
        sh_nodes, sh_ltris,
        (mats, lights, ltri, sph, pln, sphmat, plnmat, objmat), rays, state,
        roots=roots, sh_roots=sh_roots, occl=occl,
        light_tri_meta=light_tri_meta, num_sph=num_sph, num_pln=num_pln,
        num_lights=num_lights, nee=nee and num_lights > 0, rr=rr,
        cosine=cosine, ref_pdf=ref_pdf, depths=depths, depth_base=depth_base,
        carry_in=carry_in, carry_out=carry_out, count_iters=count_iters,
        occl_rows=occl_rows, **layout_kw)


def resident_threads(
    nodes, ltris, mats, lights, ltri, sph, pln, sphmat, plnmat, objmat,
    rays, state, *, roots, sh_nodes=None, sh_ltris=None, sh_roots=None,
    occl=False, light_tri_meta=(), count_iters=False, fused_nn=0, width=8,
    ents=None, sh_ents=None, occl_rows=1, **_,
) -> int:
    """The threads pt_frame's persistent launch on these arguments (CUDA
    tensors; pt_frame's own) keeps resident: the card's SMs times the
    blocks per SM of the kernel arm the launch takes (its count arm with
    count_iters), times 128 (csrc/pt_frame.cu pt_frame_resident).  A
    query: nothing is launched.  A launch of more lanes refills its
    threads with lanes as their paths end."""
    check_occl_rows("pt_frame", occl_rows, occl)
    layout_kw = _frame_layouts("pt_frame", nodes, sh_nodes, ents, sh_ents,
                               fused_nn, width, occl)
    sh_nodes, sh_ltris, sh_roots = _shadow_tables(
        nodes, ltris, roots, sh_nodes, sh_ltris, sh_roots, occl)
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"resident_threads needs cuda tensors, not {dev}")
    a = launch_args(dev, nodes, ltris, sh_nodes, sh_ltris,
                    (mats, lights, ltri, sph, pln, sphmat, plnmat, objmat),
                    rays, n=state.shape[0], roots=roots, sh_roots=sh_roots,
                    occl=occl, light_tri_meta=light_tri_meta,
                    occl_rows=occl_rows, **layout_kw)
    if count_iters:
        iters = torch.zeros(NUM_COUNTERS, dtype=torch.int64, device=dev)
        a.iters = iters.data_ptr()
    got = build().pt_frame_resident(ctypes.addressof(a))
    if got < 0:
        raise RuntimeError(f"pt_frame_resident failed (error {-got})")
    return got


def _frame_layouts(what, nodes, sh_nodes, ents, sh_ents, fused_nn, width,
                   occl) -> dict:
    """pt_frame's node layouts resolved (resolve_tables) for the launch:
    the closest-hit tree's, and the shadow tree's -- 8-wide and split
    when it is its own (occl), else the closest-hit tree itself."""
    ents = resolve_tables(what, nodes, ents, fused_nn, width)
    if sh_nodes is not None:
        sh_ents = resolve_tables(f"{what} sh_", sh_nodes, sh_ents)
    else:
        sh_ents = ents
    return dict(ents=ents, sh_ents=sh_ents, fused_nn=fused_nn, width=width)


def _shadow_tables(nodes, ltris, roots, sh_nodes, sh_ltris, sh_roots, occl):
    if sh_nodes is None:
        if occl:
            raise ValueError("occl=True requires separate shadow tables")
        return nodes, ltris, roots
    if not occl:
        raise ValueError("separate shadow tables must be the "
                         "occlusion-specialized (occl) form")
    return sh_nodes, sh_ltris, sh_roots


def _check_roots(name, roots):
    if not 1 <= len(roots) <= PT_STACK:
        raise ValueError(f"{name}: the kernel walks 1 to {PT_STACK} roots "
                         f"(its traversal stack), got {len(roots)}")


def _launch(entry, dev, nodes, ltris, sh_nodes, sh_ltris, tables, rays,
            state, *, roots, sh_roots, occl=False, light_tri_meta=(),
            num_sph, num_pln, num_lights, nee, rr, cosine, ref_pdf, depths,
            depth_base=0, carry_in=None, carry_out=False, count_iters=False,
            ents=None, sh_ents=None, fused_nn=0, width=8, occl_rows=1):
    n = state.shape[0]
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    _check("state", state, i64, dev, (n,))
    a = launch_args(dev, nodes, ltris, sh_nodes, sh_ltris, tables, rays, n=n,
                    roots=roots, sh_roots=sh_roots, occl=occl,
                    light_tri_meta=light_tri_meta, num_sph=num_sph,
                    num_pln=num_pln, num_lights=num_lights, nee=nee, rr=rr,
                    cosine=cosine, ref_pdf=ref_pdf, depths=depths,
                    depth_base=depth_base, ents=ents, sh_ents=sh_ents,
                    fused_nn=fused_nn, width=width, occl_rows=occl_rows)
    a.state = state.data_ptr()
    if carry_in is not None:
        tp_in, en_in, flags_in = carry_in
        for c in range(3):
            _check("carry throughput", tp_in[c], f32, dev, (n,))
            _check("carry energy", en_in[c], f32, dev, (n,))
            a.tp_in[c], a.en_in[c] = tp_in[c].data_ptr(), en_in[c].data_ptr()
        _check("carry flags", flags_in, i32, dev, (n,))
        a.flags_in = flags_in.data_ptr()

    def col(dtype=f32):
        return torch.empty(n, dtype=dtype, device=dev)

    en = [col() for _ in range(3)]
    st_out, tr = col(i64), col(i32)
    for c in range(3):
        a.en_out[c] = en[c].data_ptr()
    a.state_out, a.tr_out = st_out.data_ptr(), tr.data_ptr()
    if carry_out:
        rays_out, tp_out, flags = [col() for _ in range(6)], \
            [col() for _ in range(3)], col(i32)
        for c in range(6):
            a.ray_out[c] = rays_out[c].data_ptr()
        for c in range(3):
            a.tp_out[c] = tp_out[c].data_ptr()
        a.flags_out = flags.data_ptr()
    if count_iters:
        counted = count_rows(a, dev, {0: (nodes, ltris),
                                      1: (sh_nodes, sh_ltris)})
    # the persistent threads' lane counter (the host build ignores it)
    fetch = torch.zeros(1, dtype=i32, device=dev)
    a.next = fetch.data_ptr()
    run_launch(entry, a, "pt_frame")
    traced = tr.sum(dtype=i64)
    if carry_out:
        out = (tuple(rays_out), st_out, tuple(tp_out), tuple(en), flags,
               traced)
    else:
        out = (torch.stack(en, dim=1), st_out, traced)
    if not count_iters:
        return out
    return out + (counters(*counted),)


def closest_hit(nodes, ltris, roots, rays):
    """Nearest hit of each ray over one slim tree: (t, original triangle
    id, object, nx, ny, nz), t = 1e34 and ids -1 on a miss.  On CUDA
    tensors the kernel's own traversal (traverse_packet_slim's kernel,
    launched here without its launch count); on CPU tensors the
    brute-force plain version."""
    from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps

    dev = rays[0].device
    if dev.type == "cpu":
        return closest_hit_reference(ltris, rays)
    t, tri, obj, nrm, _ = tps.launch(build().traverse_launch, dev, rays,
                                     None, nodes, ltris, roots)
    return (t, tri, obj) + nrm


def closest_hit_host(nodes, ltris, roots, rays):
    """B4's closest hit through the g++ build of the kernel body (CPU):
    the walk with postponed leaves (`closest_hit`'s kPost arm, which B4's
    closest hits without count_depth or instances take)."""
    from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps

    t, tri, obj, nrm, _ = tps.launch(build_host().traverse_host,
                                     torch.device("cpu"), rays, None, nodes,
                                     ltris, roots)
    return (t, tri, obj) + nrm


_dummy: dict = {}


def dummy_tables(dev, sph_rows: int = 1, pln_rows: int = 1) -> tuple:
    """Zero small tables for launches that read none of them (one row
    each; sphere and plane rows as given, so that real sphere and plane
    tables can take their place), one set per device and shape, so their
    packing is cached."""
    key = (str(dev), sph_rows, pln_rows)
    if key not in _dummy:
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        _dummy[key] = (z(1, 14), z(1, 10), z(1, 12), z(sph_rows, 6),
                       z(pln_rows, 7), z(sph_rows, dtype=torch.int32),
                       z(pln_rows, dtype=torch.int32),
                       z(1, dtype=torch.int32))
    return _dummy[key]


# ---- the plain version -----------------------------------------------------


def leaf_records(ltris: torch.Tensor, occl: bool = False,
                 pay: torch.Tensor | None = None) -> dict:
    """Every real triangle record of slim leaf rows (8 x 16 cols), in
    original-id order: v0, e1, e2, flat normal (R, 3) f32, obj, id (R,)
    i32.  With occl, of occlusion leaf rows (14 x 9-col [v0, e1, e2],
    bvh8.to_slim_occl; every row of every leaf, one or two rows each):
    with their leaf-14 payload rows `pay` (bvh8.occl_payload) the records
    of id >= 0 in id order with the payload's normal, object and id;
    without them every record that is not all-zero padding, with id 1,
    object -1 and a zero normal (a t and an occlusion bit are all they
    give)."""
    if occl:
        rec = ltris[:, :14 * 9].reshape(-1, 9)
        if pay is None:
            rec = rec[(rec[:, 3:9] != 0).any(dim=1)]
            m = torch.ones(rec.shape[0], dtype=torch.int32,
                           device=rec.device)
            return dict(v0=rec[:, 0:3], e1=rec[:, 3:6], e2=rec[:, 6:9],
                        n=torch.zeros_like(rec[:, 0:3]), obj=-m, id=m)
        p = pay[:, :14 * 9].reshape(-1, 9)
        ids = p[:, 4].view(torch.int32)
        keep = ids >= 0
        order = torch.argsort(ids[keep].to(torch.int64), stable=True)
        rec, p = rec[keep][order], p[keep][order]
        return dict(v0=rec[:, 0:3], e1=rec[:, 3:6], e2=rec[:, 6:9],
                    n=p[:, 0:3], obj=p[:, 3].view(torch.int32),
                    id=p[:, 4].view(torch.int32))
    rec = ltris.reshape(-1, 16)
    ids = rec[:, 13].view(torch.int32)
    rec = rec[ids >= 0]
    order = torch.argsort(rec[:, 13].view(torch.int32).to(torch.int64),
                          stable=True)
    rec = rec[order]
    return dict(v0=rec[:, 0:3], e1=rec[:, 3:6], e2=rec[:, 6:9],
                n=rec[:, 9:12], obj=rec[:, 12].view(torch.int32),
                id=rec[:, 13].view(torch.int32))


def closest_hit_reference(ltris, rays, t_init=None, records=None,
                          chunk=4096):
    """Brute-force nearest hit over the leaf records (ties keep the lowest
    original id) with t < t_init (default 1e34): (t, tri, obj, nx, ny, nz)
    like `closest_hit`; `records` reuses leaf_records(ltris)."""
    rc = records if records is not None else leaf_records(ltris)
    o = torch.stack(rays[0:3], dim=1)
    d = torch.stack(rays[3:6], dim=1)
    if t_init is None:
        t_init = torch.full_like(rays[0], RAY_TMAX)
    t, k = brute_force_nearest_triangle(o, d, rc["v0"], rc["e1"], rc["e2"],
                                        t_init, chunk=chunk)
    hit = k >= 0
    kk = torch.where(hit, k, 0)
    m1 = torch.full_like(k, -1).to(torch.int32)
    tri = torch.where(hit, rc["id"][kk], m1)
    obj = torch.where(hit, rc["obj"][kk], m1)
    nrm = torch.where(hit[:, None], rc["n"][kk], torch.zeros_like(o))
    return t, tri, obj, nrm[:, 0], nrm[:, 1], nrm[:, 2]


# slim entry encoding (models/bvh8.py SLIM_EMPTY; csrc/pt_device.cuh)
SLIM_EMPTY = 0x40000000
BIG = 1e30


def _leaf_rows_records(ltris, rows) -> dict:
    """leaf_records of the leaf rows `rows` (a list of row indices)."""
    idx = torch.as_tensor(sorted(set(rows)), dtype=torch.int64,
                          device=ltris.device)
    return leaf_records(ltris.index_select(0, idx).reshape(-1, 128))


def instance_records(nodes, ltris, roots, inst_root) -> dict:
    """What the plain version of the instance arm needs of a tree with a
    TLAS over object-space instances, from a host walk of its entries:
    the leaf records reached without an instance entry (world space),
    per instance the (row, slot) child boxes of its path through the TLAS
    (in world space), and the leaf records of each instance's BLAS."""
    ent = nodes.detach().cpu().numpy()[:, 48:56].view(np.int32)
    iroot = [int(r) for r in inst_root.cpu().numpy()]

    def walk(starts, on_instance):
        leaves, stack = [], [(int(r), ()) for r in starts]
        while stack:
            r, path = stack.pop()
            for k in range(8):
                e = int(ent[r, k])
                if e == SLIM_EMPTY:
                    continue
                if e > SLIM_EMPTY:
                    on_instance(e - SLIM_EMPTY - 1, path + ((r, k),))
                elif e >= 0:
                    stack.append((e, path + ((r, k),)))
                else:
                    leaves.append(-e - 1)
        return leaves

    paths = {}
    world = walk(roots, paths.__setitem__)
    blas = {r: _leaf_rows_records(ltris, walk([r], None)) for r in
            set(iroot)}
    boxes = {}
    for i, path in paths.items():
        rows = torch.as_tensor([r for r, _ in path], dtype=torch.int64,
                               device=nodes.device)
        cols = torch.as_tensor([6 * k for _, k in path], dtype=torch.int64,
                               device=nodes.device)
        boxes[i] = nodes[rows[:, None], cols[:, None]
                         + torch.arange(6, device=nodes.device)]
    return dict(world=_leaf_rows_records(ltris, world) if world else None,
                boxes=boxes, blas=[blas[r] for r in iroot])


def _slab_pass(box, o, inv, zero, t, at_t, pad=SLAB_PAD):
    """Lanes whose ray (origin o, reciprocal direction inv, zero-direction
    mask zero; 3-tuples of (N,)) enters the box (6,) [min, max] before t
    (at t too with at_t): the slab test of csrc/pt_device.cuh
    slab_child, zero_slab's rule and slab_hit's margin (pad)
    included."""
    return slab_test(box, o, inv, zero, t, at_t, pad)[0]


def slab_test(box, o, inv, zero, t, at_t, pad=SLAB_PAD):
    """_slab_pass, and the entry distance tmin of every test."""
    t1, t2 = [], []
    for a in range(3):
        lo, hi = box[a], box[3 + a]
        a1 = (lo - o[a]) * inv[a]
        a2 = (hi - o[a]) * inv[a]
        inf = torch.full_like(a1, float("inf"))
        a1 = torch.where(zero[a], torch.where(lo <= o[a], -inf, inf), a1)
        a2 = torch.where(zero[a], torch.where(o[a] <= hi, inf, -inf), a2)
        t1.append(a1)
        t2.append(a2)
    tmin = torch.fmax(torch.fmax(torch.fmin(t1[0], t2[0]),
                                 torch.fmin(t1[1], t2[1])),
                      torch.fmin(t1[2], t2[2]))
    tmax = torch.fmin(torch.fmin(torch.fmax(t1[0], t2[0]),
                                 torch.fmax(t1[1], t2[1])),
                      torch.fmax(t1[2], t2[2]))
    return slab_pass(tmin, tmax, t, at_t, pad), tmin


def closest_hit_instances_reference(nodes, ltris, roots, inst_inv,
                                    inst_root, rays, t_init=None, *,
                                    any_hit=False, records=None,
                                    chunk=4096):
    """The plain version of the instance arm of a walk (the object-space
    TLAS machinery): the world-space records by brute force; then per
    instance, on the lanes whose world ray passes every box of the
    instance's TLAS path, the ray moved into its object space by its
    inst_inv row (the kernel's arithmetic) against every record of its
    BLAS.  The nearest hit closer than t_init wins, exact ties to the
    lowest original id, then the lowest instance -- the kernel's rule.
    Returns (t, tri, obj, nx, ny, nz, iid); the normal of an instance hit
    is in object space.  With any_hit the same nearest hit, one valid
    answer of an any-hit query.  `records` reuses instance_records."""
    rc = records if records is not None else instance_records(
        nodes, ltris, roots, inst_root)
    ox, oy, oz, dx, dy, dz = rays
    n = ox.shape[0]
    dev = ox.device
    if t_init is None:
        t_init = torch.full_like(ox, RAY_TMAX)
    m1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if rc["world"] is not None:
        t, tri, obj, nx, ny, nz = closest_hit_reference(
            ltris, rays, t_init=t_init, records=rc["world"], chunk=chunk)
    else:
        zero = torch.zeros_like(ox)
        t, tri, obj, nx, ny, nz = t_init.clone(), m1, m1.clone(), zero, \
            zero.clone(), zero.clone()
    iid = m1.clone()
    o = (ox, oy, oz)
    inv = tuple(torch.where(c == 0.0, torch.full_like(c, BIG), 1.0 / c)
                for c in (dx, dy, dz))
    zero_dir = tuple(c == 0.0 for c in (dx, dy, dz))
    for i in range(inst_root.shape[0]):
        if i not in rc["boxes"]:
            continue  # no TLAS entry reaches the instance
        cand = torch.ones(n, dtype=torch.bool, device=dev)
        for box in rc["boxes"][i]:
            cand &= _slab_pass(box, o, inv, zero_dir, t_init, not any_hit)
        lanes = cand.nonzero().squeeze(1)
        if lanes.numel() == 0:
            continue
        m = inst_inv[i]
        wo = [c[lanes] for c in (ox, oy, oz, dx, dy, dz)]
        obj_rays = (
            m[0] * wo[0] + m[1] * wo[1] + m[2] * wo[2] + m[3],
            m[4] * wo[0] + m[5] * wo[1] + m[6] * wo[2] + m[7],
            m[8] * wo[0] + m[9] * wo[1] + m[10] * wo[2] + m[11],
            m[0] * wo[3] + m[1] * wo[4] + m[2] * wo[5],
            m[4] * wo[3] + m[5] * wo[4] + m[6] * wo[5],
            m[8] * wo[3] + m[9] * wo[4] + m[10] * wo[5],
        )
        h = closest_hit_reference(ltris, obj_rays, t_init=t_init[lanes],
                                  records=rc["blas"][i], chunk=chunk)
        tl, tril = t[lanes], tri[lanes]
        better = (h[1] >= 0) & ((h[0] < tl) | ((h[0] == tl) & (h[1] < tril)))
        sel = lanes[better]
        t[sel] = h[0][better]
        tri[sel] = h[1][better]
        obj[sel] = h[2][better]
        nx[sel], ny[sel], nz[sel] = (h[3][better], h[4][better],
                                     h[5][better])
        iid[sel] = i
    return t, tri, obj, nx, ny, nz, iid


def instance_normal(inst_nrm, iid, nx, ny, nz):
    """World normal of instance hits: normalize(inst_nrm[iid] @ n) where
    iid >= 0 and the image is not zero, else n unchanged -- the explicit
    arithmetic of the JAX package's hit_surface and of the kernel's
    shade_extend epilogue.  inst_nrm (I, 9); the rest (N,) columns."""
    nm = inst_nrm[torch.clamp(iid, min=0).long()]
    wx = nm[:, 0] * nx + nm[:, 1] * ny + nm[:, 2] * nz
    wy = nm[:, 3] * nx + nm[:, 4] * ny + nm[:, 5] * nz
    wz = nm[:, 6] * nx + nm[:, 7] * ny + nm[:, 8] * nz
    wl = sqrt(wx * wx + wy * wy + wz * wz)
    winst = (iid >= 0) & (wl > 0.0)
    wls = torch.where(winst, wl, torch.ones_like(wl))
    return (torch.where(winst, wx / wls, nx), torch.where(winst, wy / wls, ny),
            torch.where(winst, wz / wls, nz))


def _sphere_t(s, ox, oy, oz, dx, dy, dz):
    """Hit distance of sphere row s (center, r^2), +inf where missed."""
    elx, ely, elz = s[0] - ox, s[1] - oy, s[2] - oz
    tca = elx * dx + ely * dy + elz * dz
    d2 = (elx * elx + ely * ely + elz * elz) - tca * tca
    thc = sqrt(torch.clamp(s[3] - d2, min=0.0))
    t0 = tca - thc
    t1 = tca + thc
    ts = torch.where(t0 < 0.0, t1, t0)
    vs = (tca >= 0.0) & (d2 <= s[3]) & (ts >= 0.0)
    return torch.where(vs, ts, torch.full_like(ts, float("inf")))


def _plane_t(p, ox, oy, oz, dx, dy, dz):
    """Hit distance of plane row p (point, normal), +inf where missed."""
    denom = dx * p[3] + dy * p[4] + dz * p[5]
    den_ok = torch.abs(denom) > PLANE_DENOM_EPS
    tp = ((p[0] - ox) * p[3] + (p[1] - oy) * p[4] + (p[2] - oz) * p[5]) / (
        torch.where(den_ok, denom, torch.ones_like(denom)))
    vp = den_ok & (tp > 0.0)
    return torch.where(vp, tp, torch.full_like(tp, float("inf")))


def _analytic_tests(sph, pln, num_sph, num_pln, ox, oy, oz, dx, dy, dz, t,
                    kind):
    """megakernel._analytic_tests: kind 0 = mesh/miss, 1 + s = sphere s,
    1 + S + p = plane p."""
    inf = float("inf")
    for rows, count, fn, base in ((sph, num_sph, _sphere_t, 1),
                                  (pln, num_pln, _plane_t, 1 + num_sph)):
        if not count:
            continue
        best = torch.full_like(t, inf)
        bj = torch.zeros_like(kind)
        for j in range(count):
            tj = fn(rows[j], ox, oy, oz, dx, dy, dz)
            closer = (tj < t) & (tj < best)
            best = torch.where(closer, tj, best)
            bj = torch.where(closer, torch.full_like(bj, j), bj)
        found = torch.isfinite(best)
        t = torch.where(found, best, t)
        kind = torch.where(found, base + bj, kind)
    return t, kind


def _shade_surface(tb, md, p, depth0, t, tri, obj, mnx, mny, mnz):
    """megakernel._shade_surface on lane tensors: updates the path dict
    `p` in place and returns the shadow ray (sneed, origin3, dir3, tmax,
    contribution3)."""
    ox, oy, oz, dx, dy, dz = p["ray"]
    state = p["state"]
    active = p["active"]
    is_spec = p["spec"] != 0
    mats, lights = tb["mats"], tb["lights"]
    sph, pln = tb["sph"], tb["pln"]
    num_sph, num_pln = tb["num_sph"], tb["num_pln"]
    kind = torch.zeros_like(tri)
    t, kind = _analytic_tests(sph, pln, num_sph, num_pln, ox, oy, oz, dx,
                              dy, dz, t, kind)

    hit_any = (tri >= 0) | (kind > 0)
    active = active & hit_any

    # hit surface (GetRayHitResult, Main.cpp:325-338)
    px = ox + dx * t
    py = oy + dy * t
    pz = oz + dz * t
    nx, ny, nz = mnx, mny, mnz
    objmat = tb["objmat"]
    in_obj = (obj >= 1) & (obj < objmat.shape[0])
    mat_idx = objmat[torch.where(in_obj, obj, 0).long()]
    for s in range(num_sph):
        is_s = kind == 1 + s
        c = sph[s]
        vx, vy, vz = px - c[0], py - c[1], pz - c[2]
        l_s = sqrt(vx * vx + vy * vy + vz * vz)
        nx = torch.where(is_s, vx / l_s, nx)
        ny = torch.where(is_s, vy / l_s, ny)
        nz = torch.where(is_s, vz / l_s, nz)
        mat_idx = torch.where(is_s, tb["sphmat"][s], mat_idx)
    for q in range(num_pln):
        is_p = kind == 1 + num_sph + q
        nx = torch.where(is_p, pln[q, 3], nx)
        ny = torch.where(is_p, pln[q, 4], ny)
        nz = torch.where(is_p, pln[q, 5], nz)
        mat_idx = torch.where(is_p, tb["plnmat"][q], mat_idx)
    in_mat = (mat_idx >= 0) & (mat_idx < mats.shape[0])
    mrow = mats[torch.where(in_mat, mat_idx, 0).long()]  # (n, 14)
    alb_r, alb_g, alb_b = mrow[:, 0], mrow[:, 1], mrow[:, 2]
    m_spec, m_refr, m_ior = mrow[:, 3], mrow[:, 4], mrow[:, 8]
    is_light = mrow[:, 13] > 0.5

    # light hit (Main.cpp:424-431)
    tpx, tpy, tpz = p["tp"]
    enx, eny, enz = p["en"]
    zero = torch.zeros_like(t)
    hit_light = active & is_light
    add_em = hit_light & (depth0 | is_spec) if md["nee"] else hit_light
    inten = mrow[:, 12]
    enx = enx + torch.where(add_em, tpx * mrow[:, 9] * inten, zero)
    eny = eny + torch.where(add_em, tpy * mrow[:, 10] * inten, zero)
    enz = enz + torch.where(add_em, tpz * mrow[:, 11] * inten, zero)
    active = active & ~hit_light

    dw = torch.clamp(1.0 - m_spec - m_refr, min=0.0)
    brdf_r, brdf_g, brdf_b = alb_r * INV_PI, alb_g * INV_PI, alb_b * INV_PI

    # NEE (Main.cpp:439-465; sample_light draw layout)
    shadow = None
    if md["nee"]:
        do_nee = active & (dw > 0.001)
        num_lights = tb["num_lights"]
        state, li = next_u32_range(state, 0, num_lights - 1)
        lrow = lights[li]
        lcx, lcy, lcz = lrow[:, 0], lrow[:, 1], lrow[:, 2]
        lrad, larea = lrow[:, 3], lrow[:, 4]

        state, (lpx, lpy, lpz) = sampling.random_point_sphere_facing(
            state, (lcx, lcy, lcz), lrad, (px, py, pz))
        r_d = torch.clamp(lrad, min=1e-20)
        lnx, lny, lnz = (lpx - lcx) / r_d, (lpy - lcy) / r_d, (lpz - lcz) / r_d
        meta = tb["light_tri_meta"]
        state = xs32(state)
        if any(c for _, c in meta):
            # mesh-light arm: a uniform triangle of the picked light,
            # fold-sampled on the unit square
            ti = torch.zeros_like(li)
            for lj, (st_, cnt) in enumerate(meta):
                if cnt:
                    ti = torch.where(li == lj, st_ + state % cnt, ti)
            trow = tb["ltri"][ti]
            state, (ptx, pty, ptz) = sampling.random_point_triangle(
                state, (trow[:, 0], trow[:, 1], trow[:, 2]),
                (trow[:, 3], trow[:, 4], trow[:, 5]),
                (trow[:, 6], trow[:, 7], trow[:, 8]))
            is_sph_l = lrow[:, 9] > 0.5
            lpx = torch.where(is_sph_l, lpx, ptx)
            lpy = torch.where(is_sph_l, lpy, pty)
            lpz = torch.where(is_sph_l, lpz, ptz)
            lnx = torch.where(is_sph_l, lnx, trow[:, 9])
            lny = torch.where(is_sph_l, lny, trow[:, 10])
            lnz = torch.where(is_sph_l, lnz, trow[:, 11])
        else:
            # stream-layout dummies (sample_light's no-mesh-light arm)
            state = xs32(xs32(state))

        tlx, tly, tlz = lpx - px, lpy - py, lpz - pz
        dist = sqrt(tlx * tlx + tly * tly + tlz * tlz)
        d_d = torch.clamp(dist, min=1e-20)
        tlx, tly, tlz = tlx / d_d, tly / d_d, tlz / d_d
        ndotl = nx * tlx + ny * tly + nz * tlz
        nldotl = -(lnx * tlx + lny * tly + lnz * tlz)
        sneed = do_nee & (ndotl > 0.0) & (nldotl > 0.0)
        solid = (nldotl * larea) / torch.clamp(dist * dist, min=1e-20)
        s_ = ndotl * solid
        nl_f = float(num_lights)
        contrib = tuple(
            torch.where(sneed, tp * s_ * brdf * lem * nl_f * dw, zero)
            for tp, brdf, lem in ((tpx, brdf_r, lrow[:, 5]),
                                  (tpy, brdf_g, lrow[:, 6]),
                                  (tpz, brdf_b, lrow[:, 7])))
        so = (px + tlx * RAY_NUDGE, py + tly * RAY_NUDGE,
              pz + tlz * RAY_NUDGE)
        stmax = dist - 2.0 * RAY_NUDGE
        shadow = (sneed, so, (tlx, tly, tlz), stmax, contrib)

    # Russian roulette (Main.cpp:468-475)
    if md["rr"]:
        surv = sampling.survival_probability_rr(alb_r, alb_g, alb_b)
        state = xs32(state)
        r_rr = u2f(state)
        active = active & ~(surv < r_rr)
        tpx = torch.where(active, tpx / surv, tpx)
        tpy = torch.where(active, tpy / surv, tpy)
        tpz = torch.where(active, tpz / surv, tpz)

    # lobe selection (Main.cpp:478-570)
    state = xs32(state)
    r_lobe = u2f(state)
    sel_spec = active & (r_lobe < m_spec)
    sel_diel = active & ~sel_spec & (r_lobe < m_spec + m_refr)
    sel_diff = active & ~sel_spec & ~sel_diel

    ddn = dx * nx + dy * ny + dz * nz
    rfx, rfy, rfz = sampling.reflect((dx, dy, dz), (nx, ny, nz), ddn)

    cosi_raw = torch.clamp(ddn, -1.0, 1.0)
    outside = cosi_raw < 0.0
    inside = ~outside
    cosi = torch.abs(cosi_raw)
    one = torch.ones_like(t)
    etai = torch.where(outside, one, m_ior)
    etat = torch.where(outside, m_ior, one)
    nrx = torch.where(outside, nx, -nx)
    nry = torch.where(outside, ny, -ny)
    nrz = torch.where(outside, nz, -nz)
    eta = etai / etat
    kk = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = kk < 0.0
    rx, ry, rz = sampling.refract((dx, dy, dz), (nrx, nry, nrz), eta, cosi,
                                  kk)
    angle_in = ddn
    angle_out = rx * nx + ry * ny + rz * nz
    fr = sampling.fresnel(angle_in, angle_out, etai, etat)
    fr = torch.where(tir, one, fr)
    state = xs32(state)
    r_fr = u2f(state)
    choose_refract = r_fr > fr

    # diffuse bounce (Main.cpp:548-568)
    if md["cosine"]:
        state, (dfx, dfy, dfz) = sampling.cosine_weighted(state, (nx, ny, nz))
        ndotr = dfx * nx + dfy * ny + dfz * nz
        if md["ref_pdf"]:
            weight = fdiv(ndotr, 1.0 / TWO_PI)
        else:
            weight = ndotr / fdiv(torch.clamp(ndotr, min=1e-6), PI)
    else:
        state, (dfx, dfy, dfz) = sampling.uniform_hemisphere(state,
                                                             (nx, ny, nz))
        ndotr = dfx * nx + dfy * ny + dfz * nz
        if md["ref_pdf"]:
            weight = ndotr / fdiv(torch.clamp(ndotr, min=1e-6), PI)
        else:
            weight = fdiv(ndotr, 1.0 / TWO_PI)

    beer_r = torch.exp(-mrow[:, 5] * t)
    beer_g = torch.exp(-mrow[:, 6] * t)
    beer_b = torch.exp(-mrow[:, 7] * t)

    diel_bounce = sel_diel & ~tir
    diel_refract = diel_bounce & choose_refract
    diel_reflect = diel_bounce & ~choose_refract

    mirror = sel_spec | diel_reflect
    ndir_x = torch.where(sel_diff, dfx,
                         torch.where(diel_refract, rx,
                                     torch.where(mirror, rfx, dx)))
    ndir_y = torch.where(sel_diff, dfy,
                         torch.where(diel_refract, ry,
                                     torch.where(mirror, rfy, dy)))
    ndir_z = torch.where(sel_diff, dfz,
                         torch.where(diel_refract, rz,
                                     torch.where(mirror, rfz, dz)))

    mul_any = sel_spec | diel_reflect | diel_refract
    ref_in = diel_refract & inside
    tms = []
    for alb, beer, brdf in ((alb_r, beer_r, brdf_r), (alb_g, beer_g, brdf_g),
                            (alb_b, beer_b, brdf_b)):
        tm = torch.where(mul_any, alb, one)
        tm = torch.where(ref_in, alb * beer, tm)
        tms.append(torch.where(sel_diff, weight * brdf, tm))
    tpx, tpy, tpz = tpx * tms[0], tpy * tms[1], tpz * tms[2]

    bounced = sel_spec | diel_bounce | sel_diff
    spec = torch.where(sel_spec | diel_bounce, torch.ones_like(p["spec"]),
                       p["spec"])
    spec = torch.where(sel_diff, torch.zeros_like(spec), spec)
    p["ray"] = (
        torch.where(bounced, px + ndir_x * RAY_NUDGE, ox),
        torch.where(bounced, py + ndir_y * RAY_NUDGE, oy),
        torch.where(bounced, pz + ndir_z * RAY_NUDGE, oz),
        torch.where(bounced, ndir_x, dx),
        torch.where(bounced, ndir_y, dy),
        torch.where(bounced, ndir_z, dz),
    )
    p.update(state=state, tp=(tpx, tpy, tpz), en=(enx, eny, enz),
             active=active, spec=spec)
    return shadow


def _analytic_occluded(sph, pln, num_sph, num_pln, so, sd, tmax):
    """megakernel._analytic_occluded_nee without the sneed mask (the
    caller passes shadow rays only)."""
    occ = torch.zeros_like(tmax, dtype=torch.bool)
    for s in range(num_sph):
        occ = occ | (_sphere_t(sph[s], *so, *sd) < tmax)
    for q in range(num_pln):
        occ = occ | (_plane_t(pln[q], *so, *sd) < tmax)
    return occ


def pt_frame_reference(
    ltris, mats, lights, ltri, sph, pln, sphmat, plnmat, objmat, rays, state,
    *, num_lights, num_sph, num_pln, nee, rr, cosine, ref_pdf, depths,
    light_tri_meta=(), depth_base=0, carry_in=None, carry_out=False,
    sh_records=None, chunk=4096,
):
    """The plain version of `pt_frame` (same returns): the depth loop of
    _pt_frame_kernel over the lanes still alive, with the hits taken by
    brute force over the leaf records of `ltris` and the shadow test as
    an any-hit over the same records -- or over `sh_records`, those of
    the occlusion tree (leaf_records(sh_ltris, occl=True)) -- plus the
    analytic occluders.  A lane leaves the loop when its path dies, as
    in the CUDA kernel."""
    n = state.shape[0]
    f32 = torch.float32
    rec = leaf_records(ltris)
    sh_rec = rec if sh_records is None else sh_records
    tb = dict(mats=mats, lights=lights, ltri=ltri, sph=sph, pln=pln,
              sphmat=sphmat, plnmat=plnmat, objmat=objmat,
              num_lights=num_lights, num_sph=num_sph, num_pln=num_pln,
              light_tri_meta=tuple(light_tri_meta))
    md = dict(nee=nee and num_lights > 0, rr=rr, cosine=cosine,
              ref_pdf=ref_pdf)
    ray = [r.clone() for r in rays]
    st = state.clone()
    if carry_in is not None:
        tp = [c.clone() for c in carry_in[0]]
        en = [c.clone() for c in carry_in[1]]
        active = (carry_in[2] & 1) != 0
        spec = (carry_in[2] >> 1) & 1
    else:
        tp = [torch.ones(n, dtype=f32, device=st.device) for _ in range(3)]
        en = [torch.zeros(n, dtype=f32, device=st.device) for _ in range(3)]
        active = torch.ones(n, dtype=torch.bool, device=st.device)
        spec = torch.zeros(n, dtype=torch.int32, device=st.device)
    tr = torch.zeros(n, dtype=torch.int64, device=st.device)
    for d in range(depths):
        lanes = active.nonzero().squeeze(1)
        if lanes.numel() == 0:
            break
        p = dict(ray=tuple(r[lanes] for r in ray), state=st[lanes],
                 tp=tuple(c[lanes] for c in tp),
                 en=tuple(c[lanes] for c in en),
                 active=active[lanes], spec=spec[lanes])
        tr[lanes] += 1
        hit = closest_hit_reference(ltris, p["ray"], records=rec,
                                    chunk=chunk)
        depth0 = torch.full_like(hit[1], d + depth_base == 0,
                                 dtype=torch.bool)
        shadow = _shade_surface(tb, md, p, depth0, *hit)
        en_l = list(p["en"])
        if shadow is not None:
            sneed, so, sd, stmax, contrib = shadow
            sl = sneed.nonzero().squeeze(1)
            if sl.numel():
                tr[lanes[sl]] += 1
                so_s = tuple(c[sl] for c in so)
                sd_s = tuple(c[sl] for c in sd)
                occ = closest_hit_reference(
                    ltris, so_s + sd_s, t_init=stmax[sl], records=sh_rec,
                    chunk=chunk)[1] >= 0
                occ = occ | _analytic_occluded(
                    sph, pln, num_sph, num_pln, so_s, sd_s, stmax[sl])
                lit = torch.zeros_like(sneed)
                lit[sl] = ~occ
                zero = torch.zeros_like(en_l[0])
                en_l = [e + torch.where(lit, c, zero)
                        for e, c in zip(en_l, contrib)]
        for c in range(6):
            ray[c][lanes] = p["ray"][c]
        st[lanes] = p["state"]
        for c in range(3):
            tp[c][lanes] = p["tp"][c]
            en[c][lanes] = en_l[c]
        active[lanes] = p["active"]
        spec[lanes] = p["spec"]

    traced = tr.sum()
    if carry_out:
        flags = active.to(torch.int32) | (spec.to(torch.int32) << 1)
        return tuple(ray), st, tuple(tp), tuple(en), flags, traced
    return torch.stack(en, dim=1), st, traced
