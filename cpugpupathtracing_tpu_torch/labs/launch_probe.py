"""L8, the launch probe: a trivial kernel launched once and twice chained,
and the standalone traversal at growing sizes, to measure the launch
floor on this card.

    python -m cpugpupathtracing_tpu_torch.labs.launch_probe
    python -m cpugpupathtracing_tpu_torch.labs.launch_probe --device cpu \\
        --tiles 1 4

The port of the JAX package's tools/profile_tpu2.py section_pallas: its
Pallas kernels `trivial` (copy_kernel, o = 2x on 1024 f32) and
`trivial2` (two chained calls, o = 4x), then the standalone traversal
(ops/traverse_packet_slim.py, B4, its plain closest-hit arm) on the
12-triangle cube of half-size 1.5 at 1024 rays from (0, 0, 8) along -z,
and on config 3 (models/scene.py make_reference_scene, its plain 64-col
tables) at 1, 4, 16 and 64 tiles of 1024 rays of the default camera
(camera.blocked_lane_rays: the first 8x128 blocks of a 1024-wide
image).  On CUDA tensors `trivial` / `trivial2` launch the
hand-written kernel of csrc/probes.cu (scale2_kernel: one 16-byte
vector per thread in the smallest grid of 256-thread blocks that covers
n; built by ops/pt_frame.py with every unit); on CPU tensors they run
the plain version, x * 2.  section_stream (XLA's take, scatter-min,
sort and compaction, no Pallas kernel) is not ported.

Per case the driver reports the host wall time per call (each call
followed by torch.cuda.synchronize()), the device time per call (CUDA
events with the stream held busy, common.busy_ms: every kernel of the
call, and trivial2 makes two launches a call), the profiler's time per
launch of the case's kernel where the profiler saw it, and the lanes;
beside `trivial`, the same clocks of PyTorch's x * 2.  The last line of
the output is a JSON object of the numbers (null device times on the CPU
and where the profiler saw no launch).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

import torch

from cpugpupathtracing_tpu_torch.config import CameraConfig
from cpugpupathtracing_tpu_torch.labs import common as cm
from cpugpupathtracing_tpu_torch.labs.bounce_fan import plain_tables
from cpugpupathtracing_tpu_torch.models import camera as camlib
from cpugpupathtracing_tpu_torch.models import materials as matlib
from cpugpupathtracing_tpu_torch.models import mesh as meshlib
from cpugpupathtracing_tpu_torch.models import scene as scenelib
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops import traverse_packet_slim as tps
from cpugpupathtracing_tpu_torch.utils.device import resolve_device

N = 1024         # the JAX probe's f32 elements and cube rays
TILES = (1, 4, 16, 64)
RAY_T = 1e30     # the JAX probe's t_init
REPS = 20

_F32 = torch.float32


class ProbeArgs(ctypes.Structure):
    """Mirrors struct ProbeArgs of csrc/probes.cu."""

    _fields_ = [
        ("inp", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("stream", ctypes.c_void_p),
    ] + [(name, ctypes.c_int) for name in ("n", "two_d")]


_checked = []


def probes_lib():
    """The build, with ProbeArgs' layout checked against it once."""
    lib = ptf.build()
    if not _checked:
        got = (ctypes.c_longlong * 3)()
        lib.probe_args_layout(ctypes.addressof(got))
        want = (ctypes.sizeof(ProbeArgs), ProbeArgs.stream.offset,
                ProbeArgs.two_d.offset)
        if tuple(got) != want:
            raise RuntimeError(f"ProbeArgs layout {tuple(got)} differs from "
                               f"the ctypes mirror's {want}")
        _checked.append(True)
    return lib


def _scale2(x: torch.Tensor, key: str) -> torch.Tensor:
    """One launch of scale2_kernel on x, counted under `key`."""
    ptf._check("x", x, _F32, x.device)
    out = torch.empty_like(x)
    a = ProbeArgs()
    a.inp, a.out = x.data_ptr(), out.data_ptr()
    a.stream = torch.cuda.current_stream(x.device).cuda_stream
    a.n = x.numel()
    rc = probes_lib().scale2_launch(ctypes.addressof(a))
    if rc != 0:
        raise RuntimeError(f"{key} launch failed (error {rc})")
    cm.count_launch(key)
    return out


def _device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"runs on cuda or cpu tensors, not {x.device}")
    return x.device.type == "cuda"


def trivial(x: torch.Tensor) -> torch.Tensor:
    """o = 2x: one launch of the kernel (the plain version on the CPU)."""
    return _scale2(x, "trivial") if _device(x) else scale2_reference(x)


def trivial2(x: torch.Tensor) -> torch.Tensor:
    """o = 4x: two chained launches of the kernel."""
    if not _device(x):
        return scale2_reference(scale2_reference(x))
    return _scale2(_scale2(x, "trivial2"), "trivial2")


def scale2_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: x * 2."""
    return x * 2.0


def cube_case(dev):
    """B4 on the 12-triangle cube: (tables, rays, t_init) of 1024 rays
    from (0, 0, 8) along -z."""
    s = scenelib.Scene()
    m = s.add_material(matlib.Material.diffuse((0.5, 0.5, 0.5)))
    s.add_mesh("cube", meshlib.cube(half=1.5), m)
    with plain_tables():
        ds = s.device(dev)
    o = torch.zeros((N, 3), dtype=_F32, device=dev)
    o[:, 2] = 8.0
    d = torch.zeros((N, 3), dtype=_F32, device=dev)
    d[:, 2] = -1.0
    return ds, o, d, torch.full((N,), RAY_T, dtype=_F32, device=dev)


def config3_case(ntiles: int, dev):
    """B4 on config 3 at ntiles tiles of 1024 blocked camera rays: the
    first ntiles 8x128 blocks of a 1024-wide image of whole block rows."""
    n = ntiles * 1024
    cam = camlib.to_arrays(CameraConfig(), dev)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    o, d, _ = camlib.blocked_lane_rays(cam, lane, 1024, 8 * -(-ntiles // 8),
                                       8, 128)
    return o, d, torch.full((n,), RAY_T, dtype=_F32, device=dev)


def b4(ds, o, d, t):
    return tps.traverse_packet_slim(o, d, t, ds.pnodes, ds.pltris, ds.proots,
                                    count_depth=False)


def host_ms(fn, reps: int = REPS) -> float:
    """Mean host milliseconds of fn() followed by a synchronise."""
    on_card = torch.cuda.is_available()
    fn()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        if on_card:
            torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def cases(dev, tiles=TILES, ds3=None) -> list:
    """(label, kernel, lanes, fn) of every case, in the JAX driver's
    order; the library call x * 2 beside trivial.  ds3: config 3's
    snapshot with the plain tables, where the caller has it."""
    x = torch.ones(N, dtype=_F32, device=dev)
    ds_cube, o, d, t = cube_case(dev)
    if ds3 is None:
        with plain_tables():
            ds3 = scenelib.make_reference_scene().device(dev)
    out = [("trivial", "scale2_kernel", N, lambda: trivial(x)),
           ("x * 2 (library)", "elementwise", N, lambda: x * 2),
           ("trivial2", "scale2_kernel", N, lambda: trivial2(x)),
           ("b4 cube", "traverse_kernel", N, lambda: b4(ds_cube, o, d, t))]
    for k in tiles:
        rays = config3_case(k, dev)
        out.append((f"b4 config3 {k} tiles", "traverse_kernel", k * 1024,
                    lambda rays=rays: b4(ds3, *rays)))
    return out


def run(dev, tiles=TILES, reps: int = REPS) -> list:
    """Each case's host ms per call and, on the card, its device ms per
    call (common.busy_ms) and the profiler's ms per launch of its kernel
    (None where the profiler saw none)."""
    on_card = dev.type == "cuda"
    rows = []
    for label, kernel, lanes, fn in cases(dev, tiles):
        rows.append(dict(
            label=label, lanes=lanes, host_ms=host_ms(fn, reps),
            device_ms=cm.busy_ms(fn, reps) if on_card else None,
            profiler_ms=cm.profiled_ms(fn, kernel, reps) if on_card
            else None))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiles", type=int, nargs="*", default=list(TILES))
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    x = torch.arange(N, dtype=_F32, device=dev)
    if not (torch.equal(trivial(x), x * 2) and
            torch.equal(trivial2(x), x * 4)):
        raise AssertionError("trivial / trivial2 differ from x * 2 / x * 4")
    rows = run(dev, args.tiles, args.reps)
    for r in rows:
        dms = "not measured" if r["device_ms"] is None else \
            f"{r['device_ms']:.4f} ms device"
        if r["profiler_ms"] is not None:
            dms += f"  {r['profiler_ms']:.4f} ms profiler"
        print(f"{r['label']:24s} {r['lanes']:7d} lanes  {r['host_ms']:.4f} ms "
              f"host  {dms}", flush=True)
    print(json.dumps(dict(device=str(dev), cases=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
