"""L6 `traverse_lab` and L7 `traverse_lab_dual`: the closest hit of a ray
batch over the slim 8-wide tables with the ablation flags of the JAX
package's tools/kernel_lab.py, and `fuse_tables`, its fused node|leaf
table.

On CUDA tensors each wrapper launches its hand-written kernel of
csrc/kernel_lab.cu (lab_ablate_kernel, lab_dual_kernel; built by
ops/pt_frame.py with every unit); on CPU tensors it runs its plain
version, `traverse_lab_reference` / `traverse_lab_dual_reference`, which
steps every lane in lockstep and equals the kernel bitwise, counters and
depth included.  Nothing falls back from one to the other.

The signatures are the JAX lab's: component-tuple rays, t_init, the
tables, static roots, `active`, and L6's options as keyword flags --
leaf seq / ilv / skip, slab seq / ilv / skip, ctrl extract / packed /
packedmask / framestack, entries vector / smem, order nearest / fixed,
decode None / "fused" (with nn), unroll 1 / 2 / 4 and fma.  `options`
normalises them as the JAX body does ("full" is "seq"; packedmask and
framestack ignore order; fma acts only on the ilv slab).  Each returns
(t, hit, obj, depth, iters): per lane the closest hit closer than t_init
(a lane that is not active keeps t_init, ids -1) and the interior steps
in which its ray entered a child; per tile of 1024 lanes (L7: per pair of
tiles) the loop iterations of its 32 warps.  count_rows=True appends the
launch's work (common.COUNTS).

What each option does on this card (csrc/kernel_lab.cu): seq / ilv and
extract / packed are two orders of the same register code on a thread;
packedmask and framestack push in slot order (framestack in 9-word
frames), nearest pushes the nearest passing child last; smem reads the
child entries from a copy of the (B, 8) entry mirror in each block's
shared memory; unroll takes 1, 2 or 4 steps per warp vote (`iters`
counts votes: entries = iters x unroll at most); fma computes the slab
planes with a correctly rounded fused multiply-add (`fma_f32` in the
plain version) and may lose a hit B4 finds; leaf skip tests no triangle
and finds no hit; slab skip pushes every valid child, so every row of
the tree is visited and the hits are those of brute force.  Hits
otherwise are bitwise B4's (ops/traverse_packet_slim.py): the same
arithmetic and the lowest-id tie rule.  The counters are the card's
schedule, one ray per thread, and cannot equal the JAX lab's 8-row
packet trips.

Only the arms in ARMS are instantiated; any other combination raises and
names itself.  Each wrapper checks that the tree's deepest walk fits the
kernel's stack (common.check_stack: the linear stack's worst case pushes
every child of every level, which slab skip does) and raises otherwise;
the shared-memory arm also raises where the entry mirror exceeds the
device's shared memory per block.
"""

from __future__ import annotations

import ctypes

import torch

from cpugpupathtracing_tpu_torch.labs import common as cm
from cpugpupathtracing_tpu_torch.models.scene import fuse_packet_tables
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf

_I32, _F32 = torch.int32, torch.float32
PAIR = 2 * cm.TILE

LEAF = SLAB = ("seq", "ilv", "skip")
CTRL = ("extract", "packed", "packedmask", "framestack")
ENTRIES = ("vector", "smem")
ORDER = ("nearest", "fixed")
UNROLL = (1, 2, 4)
# the arms csrc/kernel_lab.cu instantiates (its ARMS, in its order):
# (leaf, slab, ctrl, smem entries, fixed order, fused, fma, unroll)
ARMS = (
    ("seq", "seq", "extract", False, False, False, False, 1),
    ("seq", "ilv", "extract", False, False, False, False, 1),
    ("ilv", "seq", "extract", False, False, False, False, 1),
    ("ilv", "ilv", "extract", False, False, False, False, 1),
    ("ilv", "ilv", "extract", False, False, False, False, 2),
    ("ilv", "ilv", "extract", False, True, False, False, 1),
    ("ilv", "ilv", "packedmask", False, True, False, False, 1),
    ("ilv", "ilv", "extract", False, True, False, True, 1),
    ("ilv", "ilv", "framestack", False, True, False, False, 1),
    ("ilv", "ilv", "extract", False, True, True, False, 1),
    ("ilv", "ilv", "framestack", False, True, True, False, 1),
    ("ilv", "ilv", "packed", False, False, False, False, 1),
    ("ilv", "ilv", "extract", True, True, False, False, 1),
    ("ilv", "ilv", "extract", False, False, False, False, 4),
    ("skip", "ilv", "extract", False, True, False, False, 1),
    ("ilv", "skip", "extract", False, True, False, False, 1),
)


def fuse_tables(nodes, ltris):
    """The fused node|leaf table of tools/kernel_lab.py fuse_tables: node
    rows padded to 128 cols, leaf rows appended, leaf entries -(lrow + 1)
    re-encoded as nn + lrow.  It is the scene build's CPUGPU_FUSED table
    (models/scene.py fuse_packet_tables), bitwise.  Returns (table, nn)."""
    return fuse_packet_tables(nodes, ltris), int(nodes.shape[0])


def options(leaf="seq", slab="seq", ctrl="extract", entries="vector",
            order="nearest", decode=None, unroll=1, fma=False) -> dict:
    """L6's options normalised as the JAX body reads them."""
    o = dict(leaf={"full": "seq"}.get(leaf, leaf),
             slab={"full": "seq"}.get(slab, slab), ctrl=ctrl,
             entries=entries, order=order, decode=decode, unroll=unroll,
             fma=bool(fma))
    for key, allowed in (("leaf", LEAF), ("slab", SLAB), ("ctrl", CTRL),
                         ("entries", ENTRIES), ("order", ORDER),
                         ("decode", (None, "fused")), ("unroll", UNROLL)):
        if o[key] not in allowed:
            raise ValueError(f"traverse_lab: {key}={o[key]!r} is not one of "
                             f"{allowed}")
    if ctrl in ("packedmask", "framestack"):
        o["order"] = "fixed"
    if o["slab"] != "ilv":
        o["fma"] = False
    return o


def _arm(o: dict) -> tuple:
    return (o["leaf"], o["slab"], o["ctrl"], o["entries"] == "smem",
            o["order"] == "fixed", o["decode"] == "fused", o["fma"],
            o["unroll"])


def arm_code(o: dict) -> int:
    """The arm's code in csrc/kernel_lab.cu (Arm::entry)."""
    leaf, slab, ctrl, smem, fixed, fused, fma, unroll = _arm(o)
    return (LEAF.index(leaf) | SLAB.index(slab) << 2 | CTRL.index(ctrl) << 4
            | smem << 6 | fixed << 7 | fused << 8 | fma << 9
            | UNROLL.index(unroll) << 10)


def launch_key(**opts) -> str:
    """The launch key of an L6 arm (ops/pt_frame.py launches)."""
    o = options(**opts)
    fixed = o["order"] == "fixed" and o["ctrl"] in ("extract", "packed")
    return "_".join(["traverse_lab"] + [p for p, on in (
        (f"leaf{o['leaf']}", o["leaf"] != "seq"),
        (f"slab{o['slab']}", o["slab"] != "seq"),
        (o["ctrl"], o["ctrl"] != "extract"),
        ("smem", o["entries"] == "smem"), ("fixed", fixed),
        ("fused", o["decode"] == "fused"), ("fma", o["fma"]),
        (f"unroll{o['unroll']}", o["unroll"] > 1)) if on])


DUAL_KEY = "traverse_lab_dual"


def _check_arm(o: dict) -> None:
    if _arm(o) not in ARMS:
        raise ValueError(f"traverse_lab: the arm {launch_key(**o)} ("
                         f"{', '.join(f'{k}={v!r}' for k, v in o.items())}) "
                         "is not instantiated in csrc/kernel_lab.cu")


_lib_checked = []


def _lib():
    """The build, with csrc/kernel_lab.cu's arm list checked against
    ARMS once."""
    lib = cm.build()
    if not _lib_checked:
        got = (ctypes.c_int * 64)()
        k = lib.kernel_lab_arms(ctypes.addressof(got))
        want = [arm_code(options(leaf=a[0], slab=a[1], ctrl=a[2],
                                 entries="smem" if a[3] else "vector",
                                 order="fixed" if a[4] else "nearest",
                                 decode="fused" if a[5] else None, fma=a[6],
                                 unroll=a[7])) for a in ARMS]
        if list(got[:k]) != want:
            raise RuntimeError(f"csrc/kernel_lab.cu instantiates the arms "
                               f"{list(got[:k])}, labs/kernel_lab.py lists "
                               f"{want}")
        _lib_checked.append(True)
    return lib


# the entry mirrors of the shared-memory arm, by the table they copy (the
# cache holds the table, so its id is not reused)
_mirrors: dict = {}


def entry_mirror(nodes, node_rows: int) -> torch.Tensor:
    """The (node_rows, 8) i32 entry mirror nodes[:node_rows, 48:56]."""
    key = (id(nodes), node_rows)
    hit = _mirrors.get(key)
    if hit is None:
        if len(_mirrors) >= 8:
            _mirrors.pop(next(iter(_mirrors)))
        hit = _mirrors[key] = (nodes, nodes[:node_rows, 48:56].contiguous()
                               .view(_I32))
    return hit[1]


def occupancy(node_rows: int, **opts) -> int:
    """Blocks per SM of the arm's kernel (the shared-memory arm's at a
    mirror of node_rows rows)."""
    o = options(**opts)
    _check_arm(o)
    a = cm.LabArgs()
    a.flags, a.node_rows = arm_code(o), node_rows
    got = _lib().kernel_lab_occupancy(ctypes.addressof(a))
    if got < 0:
        raise RuntimeError(f"kernel_lab_occupancy failed (error {got})")
    return got


def _tables(what, nodes, ltris, roots, fused, nn, frames):
    if fused and not nn:
        raise ValueError(f"{what}: a fused table needs nn")
    cm.check_stack(what, nodes, roots, slice(48, 56), width=8,
                   fused_nn=nn if fused else 0,
                   frame_words=cm.FRAME8 if frames else 0,
                   capacity=cm.FSTACK8 if frames else cm.STACK)
    node_rows = nn if fused else nodes.shape[0]
    leaf_rows = nodes.shape[0] - nn if fused else ltris.shape[0]
    return node_rows, leaf_rows


def traverse_lab(origin, direction, t_init, nodes, ltris, roots, *, active,
                 nn=0, count_rows=False, **opts):
    """L6 (module docstring).  nodes: (B, 64) node rows, or with
    decode="fused" the (B + NL, 128) fused table and nn = B; ltris: (NL,
    128) leaf rows (read only without the fused table)."""
    o = options(**opts)
    _check_arm(o)
    roots = tuple(int(r) for r in roots)
    rays = cm.columns(origin, direction)
    fused = o["decode"] == "fused"
    node_rows, leaf_rows = _tables("traverse_lab", nodes, ltris, roots,
                                   fused, nn, o["ctrl"] == "framestack")
    dev = t_init.device
    if dev.type == "cpu":
        return traverse_lab_reference(rays, t_init, nodes, ltris, roots,
                                      active=active, nn=nn,
                                      count_rows=count_rows, **o)
    if dev.type != "cuda":
        raise ValueError(f"traverse_lab runs on cuda or cpu tensors, not "
                         f"{dev}")
    ents = None
    if o["entries"] == "smem":
        limit = cm.smem_optin()
        if node_rows * 32 > limit:
            raise ValueError(f"traverse_lab: the entry mirror "
                             f"({node_rows * 32} B) exceeds the device's "
                             f"{limit} B of shared memory per block")
        ents = entry_mirror(nodes, node_rows)
    out = cm.launch(_lib().kernel_lab_launch, "traverse_lab", rays, t_init,
                    nodes, None if fused else ltris, roots, active,
                    flags=arm_code(o), nn=nn if fused else 0,
                    node_rows=node_rows, leaf_rows=leaf_rows, leafs=False,
                    count_rows=count_rows, depth=True, ents=ents)
    cm.count_launch(launch_key(**o))
    return out


def traverse_lab_dual(origin, direction, t_init, nodes, ltris, roots, *,
                      active, count_rows=False):
    """L7 (module docstring) over (B, 64) node rows and (NL, 128) leaf
    rows: iters has one counter per pair of tiles (2048 lanes)."""
    roots = tuple(int(r) for r in roots)
    rays = cm.columns(origin, direction)
    node_rows, leaf_rows = _tables("traverse_lab_dual", nodes, ltris, roots,
                                   False, 0, False)
    dev = t_init.device
    if dev.type == "cpu":
        return traverse_lab_dual_reference(rays, t_init, nodes, ltris, roots,
                                           active=active,
                                           count_rows=count_rows)
    if dev.type != "cuda":
        raise ValueError(f"traverse_lab_dual runs on cuda or cpu tensors, "
                         f"not {dev}")
    out = cm.launch(_lib().kernel_lab_dual_launch, "traverse_lab_dual", rays,
                    t_init, nodes, ltris, roots, active, flags=0,
                    node_rows=node_rows, leaf_rows=leaf_rows, leafs=False,
                    count_rows=count_rows, depth=True, counter_lanes=PAIR)
    cm.count_launch(DUAL_KEY)
    return out


# ---- the plain versions ----------------------------------------------------


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """a * b + c of f32 tensors rounded once, as the kernel's fmaf: the
    product is exact in f64; the f64 sum is made round-to-odd from its
    exact error (Knuth's two-sum), so rounding it to f32 gives the
    correctly rounded exact sum (a plain f64 sum would round twice)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), bits + 1, bits - 1)
    odd = (err != 0) & torch.isfinite(s) & torch.isfinite(err) & \
        ((bits & 1) == 0)
    return torch.where(odd, step, bits).view(torch.float64).to(_F32)


def _slab_fma(L, bounds, ents, rows, t, mask):
    """cm.slab_rows with the fma arm's planes fmaf(b, inv, -o*inv)."""
    box = bounds[rows].permute(2, 0, 1)
    o, inv, zero = L.slab
    t1, t2 = [], []
    for k in range(3):
        lo, hi = box[k], box[3 + k]
        oi = o[k] * inv[k]
        a1 = fma_f32(lo, inv[k].expand_as(lo), (-oi).expand_as(lo))
        a2 = fma_f32(hi, inv[k].expand_as(hi), (-oi).expand_as(hi))
        inf = torch.full_like(a1, float("inf"))
        t1.append(torch.where(zero[k], torch.where(lo <= o[k], -inf, inf),
                              a1))
        t2.append(torch.where(zero[k], torch.where(o[k] <= hi, inf, -inf),
                              a2))
    tmin = torch.fmax(torch.fmax(torch.fmin(t1[0], t2[0]),
                                 torch.fmin(t1[1], t2[1])),
                      torch.fmin(t1[2], t2[2]))
    tmax = torch.fmin(torch.fmin(torch.fmax(t1[0], t2[0]),
                                 torch.fmax(t1[1], t2[1])),
                      torch.fmax(t1[2], t2[2]))
    passed = ptf.slab_pass(tmin, tmax, t[:, None], True)
    return passed & (ents[rows] != cm.SLIM_EMPTY) & mask[:, None], tmin


def _walk(L, nodes, ltris, roots, nn, o):
    """Every lane's walk in lockstep, one entry per live lane and step:
    sets L's hits and work counts; returns (depth, entries) per padded
    lane, i64."""
    n, dev, ar = L.n, L.dev, L.ar
    fused = o["decode"] == "fused"
    bounds = nodes[:, :48].reshape(-1, 8, 6)
    ents = nodes[:, 48:56].contiguous().view(_I32)
    recs = (nodes if fused else ltris).reshape(-1, 8, 16)
    node_rows = nn if fused else nodes.shape[0]
    frames = o["ctrl"] == "framestack"
    fixed = o["order"] == "fixed"
    stack = torch.zeros((n, cm.FSTACK8 if frames else cm.STACK), dtype=_I32,
                        device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    if frames:
        cm.seed_frames(stack, sp, L.act, roots, cm.FRAME8, 8)
    elif len(roots) > 1:
        stack[L.act, :len(roots) - 1] = torch.tensor(roots[1:], dtype=_I32,
                                                     device=dev)
        sp[L.act] = len(roots) - 1
    e = torch.where(L.act, roots[0], cm.DONE).to(torch.int64)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    steps = torch.zeros(n, dtype=torch.int64, device=dev)
    slots = torch.arange(8, device=dev)
    while True:
        live = e != cm.DONE
        if not bool(live.any()):
            break
        steps += live
        leaf = live & ((e >= nn) if fused else (e < 0))
        interior = live & ~leaf
        ec = torch.where(interior, e, 0)
        if o["slab"] == "skip":
            passed = (ents[ec] != cm.SLIM_EMPTY) & interior[:, None]
            tmin = torch.zeros(passed.shape, dtype=_F32, device=dev)
        else:
            if o["fma"]:
                passed, tmin = _slab_fma(L, bounds, ents, ec, L.t, interior)
            else:
                passed, tmin = cm.slab_rows(L, bounds, ents, ec, L.t, True,
                                            interior)
            depth += passed.any(dim=1)
        L.mark(ec[interior], 0)
        if o["leaf"] != "skip":
            lrow = torch.where(leaf, (e - nn) if fused else (-e - 1), 0)
            L.mark(lrow[leaf] + node_rows, 1, cm.LEAF_TRIS * int(leaf.sum()))
            cm.leaf_closest(L, recs[lrow + (nn if fused else 0)], leaf)
        if frames:
            w = cm.mask_bits(passed)
            vals = torch.cat([ents[ec].to(torch.int64), w[:, None]], dim=1)
            sp = cm.push_frames(stack, sp, live & (w != 0), vals)
            can = live & (sp > 0)
            kk, base, sp = cm.pop_frames(stack, sp, can, cm.FRAME8)
            ent = stack[ar, base + kk].to(torch.int64)
        else:
            if fixed:
                sp = cm.push_slots(stack, sp, passed, ents[ec])
            else:
                bk = cm.nearest_slot(passed, tmin)
                best = (slots[None, :] == bk[:, None]) & \
                    passed.any(dim=1)[:, None]
                sp = cm.push_slots(stack, sp, passed & ~best, ents[ec])
                sp = cm.push_slots(stack, sp, best, ents[ec])
            can = live & (sp > 0)
            sp = sp - can.to(torch.int64)
            ent = stack[ar, torch.clamp(sp, min=0)].to(torch.int64)
        e = torch.where(can, ent, torch.where(live, cm.DONE, e))
    return depth, steps


def _outputs(L, depth, counters, count_rows, node_rows) -> tuple:
    n0 = L.n0
    res = (L.t[:n0], L.hit[:n0], L.obj[:n0], depth[:n0].to(_I32)) + \
        tuple(counters)
    if count_rows:
        res += (cm.count_tensor(L.work, L.seen, node_rows),)
    return res


def _lanes(rays, t_init, active, nodes, ltris, fused, nn, count_rows,
           pad_to=cm.WARP):
    n0 = t_init.shape[0]
    pad = -n0 % pad_to
    if pad:
        dev = t_init.device
        rays = tuple(torch.cat([c, torch.ones(pad, dtype=_F32, device=dev)])
                     for c in rays)
        t_init = torch.cat([t_init, torch.zeros(pad, dtype=_F32, device=dev)])
        act = torch.ones(n0, dtype=torch.bool, device=dev) if active is None \
            else active != 0
        active = torch.cat([act, torch.zeros(pad, dtype=torch.bool,
                                             device=dev)])
    L = cm.Lanes(rays, t_init, active)
    L.n0 = n0
    node_rows = nn if fused else nodes.shape[0]
    if count_rows:
        L.count_rows(nodes.shape[0] if fused else node_rows + ltris.shape[0])
    return L, node_rows


def traverse_lab_reference(rays, t_init, nodes, ltris, roots, *, active,
                           nn=0, count_rows=False, warp_trips=False, **opts):
    """L6's plain version over the six ray columns; with warp_trips the
    steps of each warp of 32 lanes (i64) are appended."""
    o = options(**opts)
    fused = o["decode"] == "fused"
    L, node_rows = _lanes(rays, t_init, active, nodes, ltris, fused, nn,
                          count_rows)
    depth, steps = _walk(L, nodes, ltris, tuple(roots), nn, o)
    per_warp = steps.view(-1, cm.WARP).amax(dim=1)
    iters = cm.tile_sum(-(-per_warp // o["unroll"]), L.n0)
    res = _outputs(L, depth, (iters,), count_rows, node_rows)
    return res + (per_warp,) if warp_trips else res


def pair_trips(warp_trips: torch.Tensor, n: int) -> torch.Tensor:
    """Per pair of 1024-lane tiles the sum over its 32 thread warps of
    the max of the two L6 warps each pairs (warp w of tile 2p with warp
    w of tile 2p + 1): L7's counters from L6's per-warp trips over n
    lanes, i32 (ceil(n / 2048),)."""
    pairs = -(-n // PAIR)
    full = torch.zeros(pairs * 2 * (cm.TILE // cm.WARP), dtype=torch.int64,
                       device=warp_trips.device)
    full[:warp_trips.numel()] = warp_trips
    return full.view(pairs, 2, -1).amax(dim=1).sum(dim=1).to(_I32)


def traverse_lab_dual_reference(rays, t_init, nodes, ltris, roots, *,
                                active, count_rows=False):
    """L7's plain version: every ray's walk is L6's slab="ilv",
    leaf="ilv", order="fixed" walk (the step of each ray is the same
    whatever ray shares its thread); a thread warp steps while any of its
    64 rays lives, so its trips are the max of the two 32-lane groups."""
    o = options(slab="ilv", leaf="ilv", order="fixed")
    L, node_rows = _lanes(rays, t_init, active, nodes, ltris, False, 0,
                          count_rows, pad_to=PAIR)
    _, steps = _walk(L, nodes, ltris, tuple(roots), 0, o)
    iters = pair_trips(steps.view(-1, cm.WARP).amax(dim=1), L.n0)
    return _outputs(L, torch.zeros_like(steps), (iters,), count_rows,
                    node_rows)
