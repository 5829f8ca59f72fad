"""L5, the floor probe: K fixed trips per lane of the traversal loop
body built up in stages, to price each stage per trip on this card.

    python -m cpugpupathtracing_tpu_torch.labs.floor_probe
    python -m cpugpupathtracing_tpu_torch.labs.floor_probe --device cpu \\
        --width 96 --height 54 --k-iters 8

The port of the JAX package's tools/floor_probe.py (`run` over
_probe_kernel, and `main`'s ten stage sets, STAGE_SETS).  On CUDA tensors
`floor_probe` launches the hand-written kernel of csrc/floor_probe.cu
(floor_kernel; built by ops/pt_frame.py with every unit); on CPU tensors
it runs `floor_probe_reference`.  Nothing falls back from one to the
other.  Inputs: (R >= 64, 64) f32 node rows and (R >= 64, 128) f32 leaf
rows (rows 0..63 are read), the six (N,) f32 ray columns; outputs t (N,)
f32 -- the probe's output, 1.0 moved on by the slab and leaf stages --
and the lane's entry after the last trip (N,) i32, which shows the
control stages ran.  The stages and what couples lanes are the kernel's
(csrc/floor_probe.cu); the plain version takes the layout: "warp" (the
kernel's: votes and fills over 32 lanes) or "tpu" (the JAX probe's: the
slab vote over a row of 128 lanes, the fill from the first lane of each
1024), and pads the lanes to whole groups with the ray (1, 1, 1, 1, 1, 1),
as the kernel runs its last warp.  A slab vote here is whether some
lane's box passes; the JAX probe asks whether the row's least entry
distance is finite, which differs only for a box entered at -inf.

The driver runs every stage set on config 3's bounce fan
(labs/bounce_fan.py, 2,073,600 lanes) at K = 2000 trips and reports per
set the device ms of the launch and ns per warp trip (ms / (warps x K)),
and its bound: the f32 operations of the slab and leaf stages (26 per
slab test, 55 per triangle test) over 67 TFLOP/s against the bytes of
the lane columns and the 64 rows over 3.35 TB/s -- the model has no term
for the integer and stack work of the control stages; beside it the same
operations at the unfused f32 issue rate (the kernels are built with
--fmad=false) and a yardstick for the control stages, the stack words
they move at the shared memory's rate (control_yardstick).  With
--device cpu it runs the plain version at the given size.  The last line
of the output is a JSON object of the numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from cpugpupathtracing_tpu_torch.labs import common as cm
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.utils.device import resolve_device

K_ITERS = 2000  # the JAX probe's trips per lane
ROWS = 64       # rows the entries cycle through
STACK = 64
STAGES = ("ctrl", "fctrl", "loads", "slab", "leaf")
# tools/floor_probe.py main's stage sets, in its order
STAGE_SETS = (
    (),
    ("ctrl",),
    ("fctrl",),
    ("loads",),
    ("ctrl", "loads"),
    ("fctrl", "loads"),
    ("ctrl", "loads", "slab"),
    ("ctrl", "loads", "leaf"),
    ("ctrl", "loads", "slab", "leaf"),
    ("fctrl", "loads", "slab", "leaf"),
)
LAYOUTS = {"warp": (32, 32), "tpu": (128, 1024)}  # (slab vote, fill) lanes
SLAB_TESTS = TRI_TESTS = 8
# the bound's model (labs/bounce_fan.py's rates and per-test operations)
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
OPS_SLAB, OPS_TRI = 26, 55
LANE_BYTES = 6 * 4 + 4 + 4  # six ray columns in, t and the entry out

_F32, _I32 = torch.float32, torch.int32


class FloorArgs(ctypes.Structure):
    """Mirrors struct FloorArgs of csrc/floor_probe.cu."""

    _fields_ = [
        ("nodes", ctypes.c_void_p),
        ("ltris", ctypes.c_void_p),
        ("ray", ctypes.c_void_p * 6),
        ("t_out", ctypes.c_void_p),
        ("entry_out", ctypes.c_void_p),
        ("stream", ctypes.c_void_p),
    ] + [(name, ctypes.c_int) for name in ("n", "k_iters", "stages")]


_checked = []


def _lib():
    lib = ptf.build()
    if not _checked:
        got = (ctypes.c_longlong * 3)()
        lib.floor_args_layout(ctypes.addressof(got))
        want = (ctypes.sizeof(FloorArgs), FloorArgs.stream.offset,
                FloorArgs.stages.offset)
        if tuple(got) != want:
            raise RuntimeError(f"FloorArgs layout {tuple(got)} differs from "
                               f"the ctypes mirror's {want}")
        _checked.append(True)
    return lib


def stage_set(stages) -> tuple:
    """The stage set in STAGE_SETS order; raises for one the kernel does
    not instantiate."""
    s = tuple(x for x in STAGES if x in stages)
    if set(stages) - set(STAGES) or s not in {tuple(sorted(
            x, key=STAGES.index)) for x in STAGE_SETS}:
        raise ValueError(f"floor_probe: the stage set {tuple(stages)} is not "
                         f"one of tools/floor_probe.py's {STAGE_SETS}")
    return s


def stage_bits(stages) -> int:
    return sum(1 << STAGES.index(x) for x in stage_set(stages))


def launch_key(stages) -> str:
    """The launch key of a stage set (ops/pt_frame.py launches)."""
    return "_".join(("floor_probe",) + (stage_set(stages) or ("loop",)))


def floor_probe(stages, nodes, ltris, rays, *, k_iters: int = K_ITERS,
                layout: str = "warp"):
    """(t, entry) of every lane after k_iters trips of the stages (module
    docstring).  `layout` is the plain version's ("warp" is the
    kernel's)."""
    stages = stage_set(stages)
    dev = nodes.device
    n = rays[0].shape[0]
    if nodes.shape[0] < ROWS or ltris.shape[0] < ROWS or \
            nodes.shape[1] != 64 or ltris.shape[1] != 128:
        raise ValueError("floor_probe: needs (R >= 64, 64) node rows and "
                         "(R >= 64, 128) leaf rows")
    if dev.type == "cpu":
        return floor_probe_reference(stages, nodes, ltris, rays,
                                     k_iters=k_iters, layout=layout)
    if dev.type != "cuda":
        raise ValueError(f"floor_probe runs on cuda or cpu tensors, not {dev}")
    if layout != "warp":
        raise ValueError("floor_probe: the kernel couples warps "
                         "(layout='warp')")
    ptf._check("nodes", nodes, _F32, dev)
    ptf._check("ltris", ltris, _F32, dev)
    a = FloorArgs()
    a.nodes, a.ltris = nodes.data_ptr(), ltris.data_ptr()
    for c in range(6):
        ptf._check(f"rays[{c}]", rays[c], _F32, dev, (n,))
        a.ray[c] = rays[c].data_ptr()
    t = torch.empty(n, dtype=_F32, device=dev)
    entry = torch.empty(n, dtype=_I32, device=dev)
    a.t_out, a.entry_out = t.data_ptr(), entry.data_ptr()
    a.stream = torch.cuda.current_stream(dev).cuda_stream
    a.n, a.k_iters, a.stages = n, k_iters, stage_bits(stages)
    rc = _lib().floor_launch(ctypes.addressof(a))
    if rc != 0:
        raise RuntimeError(f"floor_probe launch failed (error {rc})")
    cm.count_launch(launch_key(stages))
    return t, entry


def _ctz8(mw: int) -> int:
    return 7 if mw == 0 else min((mw & -mw).bit_length() - 1, 7)


def _control(stages, e: list, sp: list, stack: list) -> None:
    """One trip of the control stage on the 8 rows' entries (in place):
    the kernel's integer code, row by row."""
    for j in range(len(e)):
        ej, s, st = e[j], sp[j], stack[j]
        if "fctrl" in stages:
            w = ej % 255 + 1
            bp = min(s, STACK - 9)
            for k in range(8):
                st[bp + k] = (ej + k + 1) % ROWS
            st[bp + 8] = w
            s += 9 if ej >= 0 and w != 0 else 0
            s = min(s, STACK - 18)
            can = s > 0
            base = max(s - 9, 0)
            mw = st[base + 8]
            ent = st[base + _ctz8(mw)]
            rem = mw & (mw - 1)
            st[base + 8] = rem if can else mw
            if can and rem == 0:
                s = base
            ej = ent if can else 0
        elif "ctrl" in stages:
            for k in range(8):
                if ej >= 0 and (ej + k) % 3 == 0:
                    st[min(s, STACK - 1)] = (ej + k + 1) % ROWS
                    s += 1
            s = min(s, STACK - 8)
            top = st[max(s - 1, 0)]
            if s > 0:
                ej, s = top, s - 1
            else:
                ej = 0
        else:
            ej = (ej + 1) % ROWS
        e[j], sp[j] = ej, s


def floor_probe_reference(stages, nodes, ltris, rays, *,
                          k_iters: int = K_ITERS, layout: str = "warp"):
    """The plain version (module docstring): the control on the 8 TPU
    rows' entries (every lane of a row has the same), the slab and leaf
    arithmetic over all lanes."""
    stages = stage_set(stages)
    vote, fill = LAYOUTS[layout]
    dev = nodes.device
    n0 = rays[0].shape[0]
    n = -(-n0 // fill) * fill
    ox, oy, oz, dx, dy, dz = (torch.cat([c, torch.ones(n - n0, dtype=_F32,
                                                       device=dev)])
                              for c in rays)
    ix, iy, iz = (torch.where(c == 0.0, torch.full_like(c, 1e30), 1.0 / c)
                  for c in (dx, dy, dz))
    row = (torch.arange(n, device=dev) % 1024) // 128
    e = list(range(8))
    sp = [1] * 8
    stack = [[0] * STACK for _ in range(8)]
    for j in range(8):
        stack[j][0] = j + 8
    t = ox * 0.0 + 1.0
    for _ in range(k_iters):
        m = t > -1.0
        if "loads" in stages:
            ent = torch.tensor(e, device=dev)[row]
            r = torch.where(ent >= 0, ent % ROWS, 0)
            nm, lm = nodes[r, :48], ltris[r]
        else:
            f = t.view(-1, fill)[:, 0].repeat_interleave(fill)[:, None]
            nm, lm = f.expand(n, 48), f.expand(n, 128)
        if "slab" in stages:
            b = nm.reshape(n, 8, 6)
            tx1 = (b[..., 0] - ox[:, None]) * ix[:, None]
            ty1 = (b[..., 1] - oy[:, None]) * iy[:, None]
            tz1 = (b[..., 2] - oz[:, None]) * iz[:, None]
            tx2 = (b[..., 3] - ox[:, None]) * ix[:, None]
            ty2 = (b[..., 4] - oy[:, None]) * iy[:, None]
            tz2 = (b[..., 5] - oz[:, None]) * iz[:, None]
            tmin = torch.fmax(torch.fmax(torch.fmin(tx1, tx2),
                                         torch.fmin(ty1, ty2)),
                              torch.fmin(tz1, tz2))
            tmax = torch.fmin(torch.fmin(torch.fmax(tx1, tx2),
                                         torch.fmax(ty1, ty2)),
                              torch.fmax(tz1, tz2))
            bm = (tmax >= tmin) & (tmin < t[:, None]) & m[:, None]
            moved = bm.any(dim=1).view(-1, vote).any(dim=1)
            t = torch.where(moved.repeat_interleave(vote), t + 1e-7, t)
        if "leaf" in stages:
            for c in range(8):
                tm = lm[:, 16 * c:16 * c + 12]
                v0x, v0y, v0z = tm[:, 0], tm[:, 1], tm[:, 2]
                e1x, e1y, e1z = tm[:, 3], tm[:, 4], tm[:, 5]
                e2x, e2y, e2z = tm[:, 6], tm[:, 7], tm[:, 8]
                hx = dy * e2z - dz * e2y
                hy = dz * e2x - dx * e2z
                hz = dx * e2y - dy * e2x
                a = e1x * hx + e1y * hy + e1z * hz
                det_ok = torch.abs(a) >= 0.001
                f = 1.0 / torch.where(det_ok, a, torch.ones_like(a))
                sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
                u = f * (sx * hx + sy * hy + sz * hz)
                qx = sy * e1z - sz * e1y
                qy = sz * e1x - sx * e1z
                qz = sx * e1y - sy * e1x
                vv = f * (dx * qx + dy * qy + dz * qz)
                tt = f * (e2x * qx + e2y * qy + e2z * qz)
                ok = det_ok & (u >= 0.0) & (vv >= 0.0) & ((u + vv) <= 1.0) \
                    & (tt > 0.0) & (tt < t) & m
                t = torch.where(ok, tt, t)
        _control(stages, e, sp, stack)
    entry = torch.tensor(e, dtype=_I32, device=dev)[row]
    return t[:n0], entry[:n0]


def bound(stages, lanes: int, k_iters: int) -> tuple:
    """(ms, "bytes" | "operations") of a launch over `lanes` lanes: the
    f32 operations of its slab and leaf stages against the bytes of the
    lane columns and the 64 rows read once (module docstring)."""
    stages = stage_set(stages)
    ops = operations(stages, lanes, k_iters)
    rows = ROWS * (64 + 128) * 4 if "loads" in stages else 0
    b = lanes * LANE_BYTES + rows
    t_b, t_o = b / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def operations(stages, lanes: int, k_iters: int) -> int:
    """The f32 operations of the slab and leaf stages of a launch."""
    stages = stage_set(stages)
    return lanes * k_iters * (OPS_SLAB * SLAB_TESTS * ("slab" in stages)
                              + OPS_TRI * TRI_TESTS * ("leaf" in stages))


def unfused_ms(stages, lanes: int, k_iters: int) -> float:
    """The slab and leaf operations at the unfused f32 issue rate
    (common.UNFUSED_F32_OPS_PER_S): what --fmad=false can reach, about
    half the bound's 67 TFLOP/s."""
    return operations(stages, lanes, k_iters) / cm.UNFUSED_F32_OPS_PER_S * 1e3


def control_trace(stages, k_iters: int) -> list:
    """Per TPU row of lanes (the 8 start entries) the control stage's
    stack work over k_iters trips of the plain version's integer code:
    (deepest word written, words moved).  The words are counted from the
    kernel's code: ctrl stores each push taken and loads the top (1 a
    trip); fctrl stores a 9-word frame, loads the mask word and the popped
    entry and stores the mask back (12 a trip); no control, none."""
    stages = stage_set(stages)
    e = list(range(8))
    sp = [1] * 8
    stack = [[0] * STACK for _ in range(8)]
    for j in range(8):
        stack[j][0] = j + 8
    deepest, words = [0] * 8, [0] * 8
    for _ in range(k_iters):
        for j in range(8):
            if "fctrl" in stages:
                deepest[j] = max(deepest[j], min(sp[j], STACK - 9) + 8)
                words[j] += 12
            elif "ctrl" in stages:
                pushes = sum(e[j] >= 0 and (e[j] + k) % 3 == 0
                             for k in range(8))
                if pushes:
                    deepest[j] = max(deepest[j],
                                     min(sp[j] + pushes - 1, STACK - 1))
                words[j] += pushes + 1
        _control(stages, e, sp, stack)
    return list(zip(deepest, words))


def control_yardstick(stages, lanes: int, k_iters: int) -> float:
    """ms for the stack words the control stage moves (control_trace, a
    lane of TPU row (lane % 1024) // 128 moving its row's words) at the
    shared memory's rate (common.SMEM_BYTES_PER_S): a yardstick for the
    control stages, which the bound has no term for -- not a bound."""
    per_row = [w for _, w in control_trace(stages, k_iters)]
    row = (torch.arange(lanes) % 1024) // 128
    words = sum(per_row[j] * int((row == j).sum()) for j in range(8))
    return words * 4 / cm.SMEM_BYTES_PER_S * 1e3


def ns_per_trip(ms: float, lanes: int, k_iters: int) -> float:
    """Device ns per warp trip: ms over the launch's warps x K."""
    return ms * 1e6 / (-(-lanes // cm.WARP) * k_iters)


def run(nodes, ltris, rays, k_iters: int = K_ITERS,
        timed: bool = False) -> list:
    """One launch of each stage set: where `timed`, its device ms
    (common.busy_ms) and ns per warp trip; its bound, the slab and leaf
    operations at the unfused issue rate (unfused_ms), the control's stack
    words at the shared-memory rate (stack_ms, control_yardstick), and
    t's mean (a check that the stages ran)."""
    lanes = rays[0].shape[0]
    outs = {}

    def launch(stages):
        def fn():
            outs[stages] = floor_probe(stages, nodes, ltris, rays,
                                       k_iters=k_iters)
        return fn

    ms = [cm.busy_ms(launch(st)) if timed else launch(st)()
          for st in STAGE_SETS]
    rows = []
    for stages, st_ms in zip(STAGE_SETS, ms):
        t, entry = outs[stages]
        b_ms, b_by = bound(stages, lanes, k_iters)
        rows.append(dict(
            stages="+".join(stages) or "loop", key=launch_key(stages),
            lanes=lanes, k_iters=k_iters, ms=st_ms,
            ns_per_trip=None if st_ms is None else ns_per_trip(st_ms, lanes,
                                                               k_iters),
            bound_ms=b_ms, bound_by=b_by,
            unfused_ms=unfused_ms(stages, lanes, k_iters),
            stack_ms=control_yardstick(stages, lanes, k_iters),
            t_mean=float(t.double().mean()),
            moved_lanes=int((t != 1.0).sum()),
            entry_sum=int(entry.sum())))
    return rows


def main(argv=None) -> int:
    from cpugpupathtracing_tpu_torch.labs import bounce_fan as bf

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--k-iters", type=int, default=K_ITERS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    fan = bf.make_fan(dev, args.width, args.height)
    rows = run(fan.nodes, fan.ltris, fan.rays, args.k_iters, timed=on_card)
    for r in rows:
        ms = "not measured" if r["ms"] is None else \
            f"{r['ms']:.3f} ms  {r['ns_per_trip']:.3f} ns/trip"
        print(f"{r['stages']:24s} {ms}  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), unfused {r['unfused_ms']:.4f} ms, "
              f"stack words {r['stack_ms']:.4f} ms", flush=True)
    print(json.dumps(dict(device=str(dev), lanes=fan.info["lanes"],
                          k_iters=args.k_iters, stage_sets=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
