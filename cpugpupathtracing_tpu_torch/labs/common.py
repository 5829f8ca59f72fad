"""What the traversal labs share: the launch arguments of
csrc/lab_device.cuh, the launch and its counters, the stack-depth check
of every lab wrapper, and the lane-parallel pieces of the plain versions.

A lab wrapper launches its CUDA kernel on CUDA tensors and runs its plain
version on CPU tensors; nothing falls back from one to the other.  Its
outputs are the JAX lab's -- t, triangle id and object per lane, and the
per-tile counters of 1024 lanes -- and with count_rows=True the work of
the launch as COUNTS (the bound of chip_smoke.py reads them).

The plain versions step every lane in lockstep through the kernel's state
machine, one entry per lane and trip, and count trips per 32 lanes: a
warp of the kernel iterates while any of its lanes lives, so its trips,
its leaf trips and (L4) its votes are those of the lockstep run grouped
by 32 lanes.  Lanes are padded to a multiple of 32 with inactive lanes,
as the kernel's last warp is.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.ops.intersect import intersect_triangle

DONE = 0x7FFFFFFF
SLIM_EMPTY = ptf.SLIM_EMPTY
TILE = 1024
WARP = 32
LEAF_TRIS = 8
# the kernels' stacks (csrc/lab_device.cuh): the linear stack's slots, the
# frames of 9 (8-wide) or 17 (16-wide) words of the frame stacks, and the
# words of those stacks (a parent-pointer frame is 2 of them)
STACK = 64
FRAME8, FRAME16 = 9, 17
FSTACK8, FSTACK16 = FRAME8 * 24, FRAME16 * 24
# the work of a count launch: node rows slab-tested, leaf rows tested,
# triangle records tested, then the distinct node and leaf rows read
COUNTS = ("node", "leaf", "tri", "node_rows", "leaf_rows")
# What an H100 SXM can issue, beside the data sheet's peaks that the
# bounds use: every kernel is built with --fmad=false, so its f32
# arithmetic issues unfused, at most 128 lanes an SM a clock (the data
# sheet's 67 TFLOP/s counts a fused multiply-add as two); and the shared
# memory serves 32 banks x 4 B an SM a clock.  At 132 SMs and the 1.98 GHz
# boost clock.
SMS, CLOCK_HZ = 132, 1.98e9
UNFUSED_F32_OPS_PER_S = SMS * 128 * CLOCK_HZ
SMEM_BYTES_PER_S = SMS * 32 * 4 * CLOCK_HZ

_F32, _I32 = torch.float32, torch.int32


class LabArgs(ctypes.Structure):
    """Mirrors struct lab::LabArgs of csrc/lab_device.cuh."""

    _fields_ = [
        ("nodes", ctypes.c_void_p),
        ("ltris", ctypes.c_void_p),
        ("roots", ctypes.c_void_p),
        ("ray", ctypes.c_void_p * 6),
        ("t_init", ctypes.c_void_p),
        ("active", ctypes.c_void_p),
        ("t_out", ctypes.c_void_p),
        ("hit_out", ctypes.c_void_p),
        ("obj_out", ctypes.c_void_p),
        ("iters", ctypes.c_void_p),
        ("leafs", ctypes.c_void_p),
        ("seen", ctypes.c_void_p),
        ("counts", ctypes.c_void_p),
        ("status", ctypes.c_void_p),
        ("stream", ctypes.c_void_p),
        ("depth_out", ctypes.c_void_p),
        ("ents", ctypes.c_void_p),
    ] + [(name, ctypes.c_int) for name in (
        "n", "nroots", "nn", "node_rows", "flags")]


_checked = []


def build():
    """The kernels (ops/pt_frame.py builds every unit, the labs' with
    them), with LabArgs' layout checked against the build's once."""
    lib = ptf.build()
    if not _checked:
        got = (ctypes.c_longlong * 3)()
        lib.lab_args_layout(ctypes.addressof(got))
        want = (ctypes.sizeof(LabArgs), LabArgs.status.offset,
                LabArgs.flags.offset)
        if tuple(got) != want:
            raise RuntimeError(f"LabArgs layout {tuple(got)} (size, status, "
                               f"flags) differs from the ctypes mirror's "
                               f"{want}")
        _checked.append(True)
    return lib


def smem_optin() -> int:
    """The device's shared memory per block with the opt-in attribute
    (cudaDevAttrMaxSharedMemoryPerBlockOptin, csrc/probes.cu), bytes."""
    got = ptf.build().smem_optin(None)
    if got < 0:
        raise RuntimeError(f"smem_optin failed (error {-got})")
    return got


def busy_ms(fn, reps: int = 1, spin_cycles: int = 2_000_000,
            attempts: int = 3) -> float:
    """Mean device milliseconds per call of fn() over reps calls, from
    CUDA events recorded while a spin kernel ahead of them holds the
    stream busy, so the host's time between launches does not count (fn
    must not synchronise).  Every kernel fn launches counts, the
    wrapper's small ones (counters zeroed, a mask converted) too.  Where
    the spin ended before the last call was enqueued (a slow host, or an
    fn that synchronises), the stream idled inside the span: the spin is
    made four times longer and the run made again, and after `attempts`
    such runs this raises.  This is the labs' and probes' clock: a
    process that opens many torch.profiler sessions sees the profiler
    miss launches, then record none."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    held = torch.cuda.Event()
    for _ in range(attempts):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles * (reps + 1))
        held.record()
        start.record()
        for _ in range(reps):
            fn()
        idled = held.query()
        end.record()
        torch.cuda.synchronize()
        if not idled:
            return start.elapsed_time(end) / reps
        spin_cycles *= 4
    raise RuntimeError("busy_ms: the stream idled between launches in "
                       f"{attempts} runs (does fn synchronise?)")


def profiled_ms(fn, kernel: str, reps: int = 1,
                attempts: int = 3) -> float | None:
    """Mean device milliseconds per launch of the kernels whose name holds
    `kernel` ("" for every kernel) while fn() runs reps times
    (torch.profiler, one session): the mean over the launches the
    profiler saw (it misses one now and then), a session that saw none
    run again.  None ("not measured") where `attempts` sessions saw none:
    after many sessions in one process the profiler records nothing, so
    no check rests on this clock (busy_ms is the one that must answer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and kernel in e.name
               and "Memcpy" not in e.name and "Memset" not in e.name]
        if evs:
            return sum(e.time_range.end - e.time_range.start
                       for e in evs) / len(evs) / 1e3
    return None


def count_launch(key: str) -> None:
    """One launch of a lab arm, in ops/pt_frame.py's `launches`."""
    ptf.launches[key] = ptf.launches.get(key, 0) + 1


def arm_key(kernel: str, flags: dict) -> str:
    """An arm's launch key (ops/pt_frame.py launches): the kernel and its
    set flags in order."""
    return "_".join([kernel] + [k for k, v in flags.items() if v])


def columns(origin, direction) -> tuple:
    """Six contiguous (N,) ray columns of component tuples or (N, 3)."""
    out = []
    for v in (origin, direction):
        if isinstance(v, (tuple, list)):
            out += [c.contiguous() for c in v]
        else:
            out += [v[:, k].contiguous() for k in range(3)]
    return tuple(out)


# ---- the stack-depth check -------------------------------------------------

_depths: dict = {}
_DEPTHS_MAX = 16


def tree_depth(table: torch.Tensor, roots, ent_cols: slice,
               fused_nn: int = 0) -> int:
    """Levels of interior rows below the roots (a root is level 1): the
    frames a frame-stack walk holds at most.  Interior entries are rows
    >= 0 below SLIM_EMPTY, and below fused_nn in a fused table.  Cached
    per table (the cache holds the table, so its id is not reused)."""
    key = (id(table), tuple(roots), ent_cols.start, fused_nn)
    hit = _depths.get(key)
    if hit is not None:
        return hit[1]
    ents = table[:, ent_cols].contiguous().view(_I32).cpu().numpy()
    limit = fused_nn if fused_nn else SLIM_EMPTY
    level = np.unique(np.asarray(roots, np.int64))
    depth = 0
    while level.size:
        depth += 1
        ch = ents[level].reshape(-1)
        level = np.unique(ch[(ch >= 0) & (ch < limit)].astype(np.int64))
    if len(_depths) >= _DEPTHS_MAX:
        _depths.pop(next(iter(_depths)))
    _depths[key] = (table, depth)
    return depth


def check_stack(what: str, table, roots, ent_cols: slice, *, width: int,
                fused_nn: int = 0, frame_words: int = 0,
                capacity: int = STACK) -> int:
    """Raise unless the kernel's per-ray stack holds this tree's deepest
    walk (an overflowing stack would drop subtrees): a frame stack of
    `capacity` words in frames of frame_words needs a frame per level, one
    per 8 (16) extra roots, and room for one more (tools/phase_lab.py's
    rule); the linear stack width - 1 pending siblings per level and the
    roots (the scene build's rule).  Returns the tree's depth."""
    depth = tree_depth(table, roots, ent_cols, fused_nn)
    if frame_words:
        root_frames = -(-(len(roots) - 1) // width)
        need = frame_words * (depth + 1 + root_frames + 1)
    else:
        need = (width - 1) * (depth + 1) + 1 + len(roots)
    if need > capacity:
        raise ValueError(f"{what}: the tree (depth {depth}, {len(roots)} "
                         f"roots) needs a {need}-word traversal stack, more "
                         f"than the kernel's {capacity}")
    return depth


# ---- the launch ------------------------------------------------------------

_roots_cache: dict = {}


def _roots_tensor(roots, dev) -> torch.Tensor:
    key = (tuple(roots), str(dev))
    if key not in _roots_cache:
        _roots_cache[key] = torch.tensor(list(roots), dtype=_I32, device=dev)
    return _roots_cache[key]


def launch(entry, what: str, rays, t_init, nodes, ltris, roots, active, *,
           flags: int, nn: int = 0, node_rows: int, leaf_rows: int,
           iters: bool = True, leafs: bool = True,
           count_rows: bool = False, depth: bool = False, ents=None,
           counter_lanes: int = TILE) -> tuple:
    """One launch of a lab kernel over the six ray columns: checked
    arguments, outputs (t, hit, obj), with `depth` the per-lane depth
    column, the `iters` and `leafs` counters (one per counter_lanes
    lanes) where asked, and with count_rows the COUNTS tensor.  `nodes`
    the node table (or the fused table), `ltris` the leaf rows (None with
    a fused table), node_rows / leaf_rows the seen map's two parts,
    `ents` the (node_rows, 8) i32 entry mirror where the arm reads it."""
    dev = t_init.device
    n = t_init.shape[0]
    for c in range(6):
        ptf._check(f"rays[{c}]", rays[c], _F32, dev, (n,))
    ptf._check("t_init", t_init, _F32, dev, (n,))
    ptf._check("nodes", nodes, _F32, dev)
    if ltris is not None:
        ptf._check("ltris", ltris, _F32, dev)
    if not roots:
        raise ValueError(f"{what}: no roots")
    a = LabArgs()
    a.nodes = nodes.data_ptr()
    a.ltris = ltris.data_ptr() if ltris is not None else 0
    a.roots = _roots_tensor(roots, dev).data_ptr()
    for c in range(6):
        a.ray[c] = rays[c].data_ptr()
    a.t_init = t_init.data_ptr()
    if active is not None:
        active = active.to(_I32).contiguous()
        ptf._check("active", active, _I32, dev, (n,))
        a.active = active.data_ptr()
    if ents is not None:
        ptf._check("ents", ents, _I32, dev, (node_rows, 8))
        a.ents = ents.data_ptr()
    out = (torch.empty(n, dtype=_F32, device=dev),
           torch.empty(n, dtype=_I32, device=dev),
           torch.empty(n, dtype=_I32, device=dev))
    if depth:
        out += (torch.empty(n, dtype=_I32, device=dev),)
    a.t_out, a.hit_out, a.obj_out = (x.data_ptr() for x in out[:3])
    if depth:
        a.depth_out = out[3].data_ptr()
    tiles = -(-n // counter_lanes)
    counters = []
    for want, field in ((iters, "iters"), (leafs, "leafs")):
        if want:
            c = torch.zeros(tiles, dtype=_I32, device=dev)
            setattr(a, field, c.data_ptr())
            counters.append(c)
    if count_rows:
        seen = torch.zeros(node_rows + leaf_rows, dtype=torch.uint8,
                           device=dev)
        work = torch.zeros(3, dtype=torch.int64, device=dev)
        a.seen, a.counts = seen.data_ptr(), work.data_ptr()
    a.status = ptf._status_tensor(dev).data_ptr()
    a.stream = torch.cuda.current_stream(dev).cuda_stream
    a.n, a.nroots, a.nn, a.node_rows, a.flags = (n, len(roots), nn,
                                                 node_rows, flags)
    rc = entry(ctypes.addressof(a))
    if rc != 0:
        raise RuntimeError(f"{what} launch failed (error {rc})")
    res = out + tuple(counters)
    if count_rows:
        res += (count_tensor(work, seen, node_rows),)
    return res


def count_tensor(work, seen, node_rows) -> torch.Tensor:
    """COUNTS from the three work counters and the seen map."""
    return torch.cat([work.to(torch.int64), torch.stack([
        seen[:node_rows].sum(dtype=torch.int64),
        seen[node_rows:].sum(dtype=torch.int64)])])


# ---- the plain versions' lanes ---------------------------------------------


class Lanes:
    """The lanes of a plain run, padded to whole warps: rays (o, d as
    (n, 3); slab form inv, zero), the active mask, the hit state (t, hit,
    obj) and the per-warp trip counters."""

    def __init__(self, rays, t_init, active):
        n0 = t_init.shape[0]
        n = -(-n0 // WARP) * WARP
        dev = t_init.device
        pad = n - n0

        def padded(x, fill):
            if not pad:
                return x
            return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                            device=dev)])

        cols = [padded(c, 1.0) for c in rays]
        self.n0, self.n, self.dev = n0, n, dev
        self.o = torch.stack(cols[:3], dim=1)
        self.d = torch.stack(cols[3:], dim=1)
        inv = tuple(torch.where(c == 0.0, torch.full_like(c, ptf.BIG),
                                1.0 / c) for c in cols[3:])
        self.slab = (tuple(c[:, None] for c in cols[:3]),
                     tuple(c[:, None] for c in inv),
                     tuple((c == 0.0)[:, None] for c in cols[3:]))
        act = (torch.ones(n0, dtype=torch.bool, device=dev) if active is None
               else active != 0)
        self.act = padded(act, False)
        self.t_init = padded(t_init, 0.0)
        self.t = self.t_init.clone()
        self.hit = torch.full((n,), -1, dtype=_I32, device=dev)
        self.obj = self.hit.clone()
        self.ar = torch.arange(n, device=dev)
        self.iters = torch.zeros(n // WARP, dtype=torch.int64, device=dev)
        self.leafs = torch.zeros_like(self.iters)
        self.work = torch.zeros(3, dtype=torch.int64, device=dev)
        self.seen = None

    def count_rows(self, rows: int) -> None:
        self.seen = torch.zeros(rows, dtype=torch.uint8, device=self.dev)

    def mark(self, rows: torch.Tensor, kind: int, tests: int = 0) -> None:
        """Rows (a 1-D index tensor) read: counted as node (kind 0) or
        leaf (1) visits, `tests` triangle records in all."""
        self.work[kind] += rows.numel()
        self.work[2] += tests
        if self.seen is not None:
            self.seen[rows] = 1

    def trip(self, alive: torch.Tensor) -> bool:
        """Count a trip for every warp with a live lane; False when none
        has one (the run is over)."""
        w = warp_any(alive)
        if not bool(w.any()):
            return False
        self.iters += w
        return True

    def outputs(self, counters=(), node_rows: int = 0) -> tuple:
        """(t, hit, obj) of the real lanes, each per-warp counter summed
        per tile of 1024 lanes, and COUNTS when rows were counted."""
        n0 = self.n0
        res = (self.t[:n0], self.hit[:n0], self.obj[:n0])
        for c in counters:
            res += (tile_sum(c, n0),)
        if self.seen is not None:
            res += (count_tensor(self.work, self.seen, node_rows),)
        return res


def warp_any(mask: torch.Tensor) -> torch.Tensor:
    """Per warp of 32 lanes: whether any lane's mask is set."""
    return mask.view(-1, WARP).any(dim=1)


def per_lane(warp_mask: torch.Tensor) -> torch.Tensor:
    """A per-warp mask broadcast to the warp's lanes."""
    return warp_mask.repeat_interleave(WARP)


def tile_sum(per_warp: torch.Tensor, n0: int) -> torch.Tensor:
    """Per-warp counts summed per tile of 1024 lanes, i32 (ceil(n0 /
    1024),) as the kernels' counters."""
    tiles = -(-n0 // TILE)
    full = torch.zeros(tiles * (TILE // WARP), dtype=torch.int64,
                       device=per_warp.device)
    full[:per_warp.numel()] = per_warp
    return full.view(tiles, -1).sum(dim=1).to(_I32)


def slab_rows(L: Lanes, bounds, ents, rows, t, at_t, mask):
    """The slab tests of each lane's row (bounds (B, W, 6), entries (B, W)
    i32; rows (n,) i64) against t: (pass (n, W) bool on lanes in mask,
    tmin (n, W)) -- pt_frame's slab arithmetic, the kernel's."""
    box = bounds[rows].permute(2, 0, 1)
    passed, tmin = ptf.slab_test(box, *L.slab, t[:, None], at_t)
    return passed & (ents[rows] != SLIM_EMPTY) & mask[:, None], tmin


def mask_bits(passed: torch.Tensor) -> torch.Tensor:
    """The i64 mask of bits k where passed[:, k]."""
    w = passed.shape[1]
    weights = torch.tensor([1 << k for k in range(w)], dtype=torch.int64,
                           device=passed.device)
    return (passed.to(torch.int64) * weights).sum(dim=1)


def nearest_slot(passed, tmin) -> torch.Tensor:
    """The lab's nearest child: the first slot of least entry distance,
    a failing slot counting +inf (slot 0 when none passes)."""
    dist = torch.where(passed, tmin, torch.full_like(tmin, float("inf")))
    return torch.argmin(dist, dim=1).to(torch.int64)


def ctz(v: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of non-zero i64 values (exact through frexp: the
    lowest set bit is a power of two)."""
    low = (v & -v).to(torch.float64)
    return (torch.frexp(low).exponent - 1).to(torch.int64)


def leaf_closest(L: Lanes, recs: torch.Tensor, mask: torch.Tensor,
                 lex: bool = False) -> None:
    """The 8 records (n, 8, 16) of each masked lane's leaf row in slot
    order against its closest hit: taken when strictly nearer, or at the
    same t with the lower id (lex: the lower (object, id)) -- the
    kernel's record_closest."""
    valid, tt = intersect_triangle(L.o[:, None, :], L.d[:, None, :],
                                   recs[..., 0:3], recs[..., 3:6],
                                   recs[..., 6:9])
    ids = recs[..., 13].contiguous().view(_I32)
    objs = recs[..., 12].contiguous().view(_I32)
    for c in range(recs.shape[1]):
        ttc, idc, obc = tt[:, c], ids[:, c], objs[:, c]
        lower = ((obc < L.obj) | ((obc == L.obj) & (idc < L.hit))) if lex \
            else idc < L.hit
        acc = mask & valid[:, c] & ((ttc < L.t) | ((ttc == L.t) & lower))
        L.t = torch.where(acc, ttc, L.t)
        L.hit = torch.where(acc, idc, L.hit)
        L.obj = torch.where(acc, obc, L.obj)


def seed_frames(stack, sp, act, roots, frame: int, width: int) -> None:
    """The extra roots roots[1:] as frames of `width` entries and a mask
    word on every active lane (the kernels' seeding); sets sp in place."""
    words = []
    rest = list(roots[1:])
    for pos in range(0, len(rest), width):
        chunk = rest[pos:pos + width]
        words += chunk + [0] * (frame - 1 - len(chunk)) + [(1 << len(chunk))
                                                           - 1]
    if words:
        stack[act, :len(words)] = torch.tensor(words, dtype=_I32,
                                               device=stack.device)
        sp[act] = len(words)


def push_frames(stack, sp, push, vals) -> torch.Tensor:
    """Write frame words vals (n, F) at each pushing lane's sp and return
    the new sp (the kernels' pushes; the depth check keeps them in the
    stack)."""
    f = vals.shape[1]
    if bool((push & (sp + f > stack.shape[1])).any()):
        raise RuntimeError("lab stack overflow: the depth check failed")
    lanes = push.nonzero().squeeze(1)
    if lanes.numel():
        cols = sp[lanes, None] + torch.arange(f, device=sp.device)
        stack[lanes[:, None], cols] = vals[lanes].to(_I32)
    return sp + f * push.to(torch.int64)


def push_slots(stack, sp, passed, ents) -> torch.Tensor:
    """The linear stack's push: every passing child in slot order."""
    pos = sp[:, None] + torch.cumsum(passed.to(torch.int64), dim=1) - 1
    if bool((passed & (pos >= stack.shape[1])).any()):
        raise RuntimeError("lab stack overflow: the depth check failed")
    n, w = passed.shape
    ar = torch.arange(n, device=sp.device)[:, None].expand(n, w)
    stack[ar[passed], pos[passed]] = ents[passed]
    return sp + passed.sum(dim=1)


def pop_frames(stack, sp, can, frame: int, near_shift: int = 0,
               low_mask: int = 0xFF):
    """The frame-stack pop on lanes `can` (sp > 0): the frame's mask word,
    the popped slot (its lowest set bit, or with near_shift the nearest
    slot stored at that shift while its bit is set), the mask's rest
    written back, the frame dropped when no low bit is left.  Returns
    (slot, frame base, new sp); slot and base are meaningful on `can`."""
    ar = torch.arange(stack.shape[0], device=stack.device)
    base = torch.clamp(sp - frame, min=0)
    mw = stack[ar, base + frame - 1].to(torch.int64) & 0xFFFFFFFF
    low = mw & low_mask
    kk = ctz(torch.where(can & (low != 0), low, torch.ones_like(low)))
    if near_shift:
        bk = (mw >> near_shift) & (low_mask.bit_length() - 1)
        kk = torch.where(((mw >> bk) & 1) != 0, bk, kk)
    rem = mw & ~(torch.ones_like(kk) << kk)
    lanes = can.nonzero().squeeze(1)
    stack[lanes, base[lanes] + frame - 1] = rem[lanes].to(_I32)
    sp = torch.where(can & ((rem & low_mask) == 0), base, sp)
    return kk, base, sp
