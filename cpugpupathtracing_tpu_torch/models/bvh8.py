"""8-wide BVH: host-side collapse of the binary BVH into the slim tables
the path-tracing kernel walks (ops/pt_frame.py, csrc/pt_device.cuh).

A copy of the JAX package's models/bvh8.py, cut to the tree shapes the
port builds (models/scene.py's CPUGPU_PACKET_TREE modes): the greedy
collapse (`collapse`, modes fat / sweep) and the SAH-cost DP collapse at
width 8 or 16 (`collapse_sah`, modes dp / sweep_dp / w16), re-encoded
into shading-complete leaf rows (`to_slim`) and bare any-hit leaf rows
(`to_slim_occl`), plus the entry side tables (`slim_side_tables`) and
48-col bounds-only rows (`slim_bounds48`) of CPUGPU_SMEMTREE.  The
tables are bitwise those of the JAX package, so both packages trace the
same trees.

Hit results are identical to the binary tree (any valid BVH returns the
same nearest hit).

BVH8 node row layout, (B, 64) float32 = 256 B:
  cols  0..47: 8 children x (min.xyz, max.xyz)
  cols 48..55: bitcast int32 child_index (interior: child row;
               leaf: start into the leaf-ordered triangle array)
  cols 56..63: bitcast int32 child_count (0 = interior, >0 = leaf tri
               count, -1 = empty slot)

Triangles are re-emitted in leaf order so every leaf's triangles are
contiguous; `leaf_tri_id` maps leaf order back to original triangle ids
for the reference's payload semantics (payload.tri_idx,
Source/BVH.cpp:81).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cpugpupathtracing_tpu_torch.models.bvh import BVH

WIDTH = 8
SLIM_EMPTY = 0x40000000  # pre-encoded entry marking an unused child slot
# occlusion (any-hit) leaf rows: 14 bare triangle records (v0, e1, e2 --
# no normal/object/id columns, which shadow rays never read) of stride 9
# fill 126 of the 128 columns, so an occlusion leaf holds 14/8 = 1.75x
# the triangles of a shading-complete row and the any-hit tree gets
# proportionally shallower (see to_slim_occl)
OCCL_TRIS = 14
OCCL_STRIDE = 9


@dataclasses.dataclass
class BVH8:
    nodes: np.ndarray        # (B, 64) f32 packed rows
    tris9: np.ndarray        # (T, 9) f32 [v0, e1, e2], leaf order
    leaf_tri_id: np.ndarray  # (T,) i32 leaf order -> original tri index
    max_depth: int

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def width(self) -> int:
        """Node arity, encoded in the row size (64 cols = 8-wide, 128
        cols = 16-wide)."""
        return self.nodes.shape[1] // 8


def collapse(b: BVH, leaf_max: int = 8) -> BVH8:
    """Greedy collapse of a binary BVH into an 8-wide one (modes fat and
    sweep): the children of a wide node start from the binary node's two
    children, and the interior candidate with the largest half-area is
    expanded until 8 slots are used or only leaves remain."""
    if int(b.prim_count.max()) > leaf_max:
        raise ValueError(
            f"binary BVH has leaves > {leaf_max} tris; build with "
            f"max_leaf_size={leaf_max} for device traversal"
        )

    left_first = b.left_first
    prim_count = b.prim_count
    nmin, nmax = b.nodes_min, b.nodes_max

    rows: list[np.ndarray] = []
    leaf_order: list[np.ndarray] = []
    leaf_cursor = 0
    max_depth = 0

    def area(i: int) -> float:
        # GetAABBVolume (Source/Primitives.cpp:280-284): xy + yz + zx, f32
        e = (nmax[i] - nmin[i]).astype(np.float32)
        return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    def wide_children(i: int) -> list[int]:
        """Binary node -> up to 8 binary descendants (leaves or subtrees)."""
        if prim_count[i] > 0:
            return [i]  # root is a single leaf
        slots = [int(left_first[i]), int(left_first[i]) + 1]
        while len(slots) < WIDTH:
            # expand the interior slot with the largest half-area
            best, best_a = -1, -1.0
            for s_idx, s in enumerate(slots):
                if prim_count[s] == 0:
                    a = area(s)
                    if a > best_a:
                        best, best_a = s_idx, a
            if best < 0:
                break
            s = slots.pop(best)
            slots.append(int(left_first[s]))
            slots.append(int(left_first[s]) + 1)
        return slots

    # rows emitted through an explicit stack of (binary node, row, depth);
    # row 0 = root
    rows.append(np.zeros(64, np.float32))
    stack = [(0, 0, 0)]
    while stack:
        bin_node, row_idx, depth = stack.pop()
        max_depth = max(max_depth, depth)
        slots = wide_children(bin_node)
        bmin = np.full((WIDTH, 3), 1e30, np.float32)
        bmax = np.full((WIDTH, 3), -1e30, np.float32)
        cidx = np.zeros(WIDTH, np.int32)
        ccnt = np.full(WIDTH, -1, np.int32)
        for k, s in enumerate(slots):
            bmin[k] = nmin[s]
            bmax[k] = nmax[s]
            if prim_count[s] > 0:
                first, cnt = int(left_first[s]), int(prim_count[s])
                seg = b.tri_indices[first : first + cnt]
                cidx[k] = leaf_cursor
                ccnt[k] = cnt
                leaf_order.append(seg)
                leaf_cursor += cnt
            else:
                child_row = len(rows)
                rows.append(np.zeros(64, np.float32))
                cidx[k] = child_row
                ccnt[k] = 0
                stack.append((s, child_row, depth + 1))
        row = np.empty(64, np.float32)
        row[0:48] = np.concatenate([bmin, bmax], axis=1).reshape(-1)
        row[48:56] = cidx.view(np.float32)
        row[56:64] = ccnt.view(np.float32)
        rows[row_idx] = row

    return _bvh8(b, rows, leaf_order, max_depth)


def _bvh8(b: BVH, rows, leaf_order, max_depth) -> BVH8:
    """A BVH8 from emitted node rows and the leaves' triangle segments."""
    leaf_ids = (
        np.concatenate(leaf_order).astype(np.int32)
        if leaf_order
        else np.zeros(0, np.int32)
    )
    tris9 = np.empty((len(leaf_ids), 9), np.float32)
    tris9[:, 0:3] = b.tri_v0[leaf_ids]
    tris9[:, 3:6] = b.tri_v1[leaf_ids] - b.tri_v0[leaf_ids]
    tris9[:, 6:9] = b.tri_v2[leaf_ids] - b.tri_v0[leaf_ids]
    return BVH8(
        nodes=np.stack(rows),
        tris9=tris9,
        leaf_tri_id=leaf_ids,
        max_depth=max_depth,
    )


def collapse_sah(b: BVH, leaf_max: int = 8, width: int = WIDTH) -> BVH8:
    """SAH-cost dynamic-programming collapse (the wide-BVH construction
    of Ylitie et al. 2017).

    Every binary subtree chooses, by expected-pops cost, whether to
    (a) become ONE leaf row (merging several adjacent binary leaves
    into a single record block), (b) become an interior wide node, or
    (c) distribute its two halves across the parent's slots.  Expected
    iterations ~ sum over emitted child entries of SA(entry bounds)
    (the probability a random ray's slab test pushes that entry).

    `width` selects the node arity: 8 emits (B, 64) rows, 16 emits
    (B, 128) rows -- 16 x (min, max).xyz bounds in cols 0..95, child
    indices in 96..111, counts in 112..127 (mode w16).  The recurrence is
    the same; only the slot budget changes.

    Input: a binary BVH with subtree-contiguous tri_indices (both the
    numpy and native builders partition in place, so every subtree owns
    a contiguous id range -- asserted below).  Returns a BVH8 whose leaf
    children each cover <= leaf_max triangles.
    """
    n_nodes = b.num_nodes
    lf = b.left_first.astype(np.int64)
    pc = b.prim_count.astype(np.int64)
    nmin, nmax = b.nodes_min, b.nodes_max
    is_leaf = pc > 0

    sa = np.maximum(_half_area_rows(nmin, nmax), 1e-12)

    # postorder: children before parents (children indices > parent here,
    # so a reverse index sweep is a valid postorder; asserted)
    interior = ~is_leaf
    if interior.any():
        assert (lf[interior] > np.nonzero(interior)[0]).all(), (
            "collapse_sah assumes child rows follow their parent"
        )
    # subtree triangle ranges (contiguous by partition-based builds)
    t_first = np.where(is_leaf, lf, 0)
    t_count = np.where(is_leaf, pc, 0)
    for n in range(n_nodes - 1, -1, -1):
        if not is_leaf[n]:
            l, r = int(lf[n]), int(lf[n]) + 1
            first = min(t_first[l], t_first[r])
            count = t_count[l] + t_count[r]
            assert (
                max(t_first[l] + t_count[l], t_first[r] + t_count[r]) - first
                == count
            ), "tri_indices not subtree-contiguous"
            t_first[n], t_count[n] = first, count

    if width not in (8, 16):
        raise ValueError(f"collapse width must be 8 or 16, got {width}")
    W1 = width  # slots per wide node
    INF = np.float64(np.inf)
    # C[n, i-1]: min cost of subtree n distributed into i slots
    C = np.full((n_nodes, W1), INF)
    # choice[n, i-1]: -1 self-as-leaf, -2 self-as-node, j>=1 split (l->j)
    # -3: use fewer slots (fall back to C[n, i-2])
    choice = np.full((n_nodes, W1), -9, np.int8)

    for n in range(n_nodes - 1, -1, -1):
        if is_leaf[n]:
            # binary leaf: one slot, one leaf row
            C[n, :] = sa[n]
            choice[n, :] = -1
            continue
        l, r = int(lf[n]), int(lf[n]) + 1
        # A(n, i): split the two halves across i slots
        A = np.full(W1, INF)
        Aj = np.zeros(W1, np.int8)
        for i in range(2, W1 + 1):
            best, bj = INF, 0
            for j in range(1, i):
                v = C[l, j - 1] + C[r, i - j - 1]
                if v < best:
                    best, bj = v, j
            A[i - 1] = best
            Aj[i - 1] = bj
        # C(n, 1): leaf row (if it fits) vs interior wide node
        c_leaf = sa[n] if t_count[n] <= leaf_max else INF
        c_node = sa[n] + A[W1 - 1]
        if c_leaf <= c_node:
            C[n, 0], choice[n, 0] = c_leaf, -1
        else:
            C[n, 0], choice[n, 0] = c_node, -2
        for i in range(2, W1 + 1):
            if C[n, i - 2] <= A[i - 1]:
                C[n, i - 1] = C[n, i - 2]
                choice[n, i - 1] = -3
            else:
                C[n, i - 1] = A[i - 1]
                choice[n, i - 1] = Aj[i - 1]

    # ---- reconstruction ----
    rows: list[np.ndarray] = []
    leaf_order: list[np.ndarray] = []
    leaf_cursor = 0
    max_depth = 0

    def decompose(n: int, i: int) -> list[int]:
        while i > 1 and choice[n, i - 1] == -3:
            i -= 1
        if i == 1:
            return [n]
        j = int(choice[n, i - 1])
        l, r = int(lf[n]), int(lf[n]) + 1
        return decompose(l, j) + decompose(r, i - j)

    ncol = 8 * width
    rows.append(np.zeros(ncol, np.float32))
    # root always emits a wide node (the kernel's entry is a node row)
    root_slots = [0] if is_leaf[0] else decompose(0, W1)
    stack = [(root_slots, 0, 0)]
    while stack:
        slots, row_idx, depth = stack.pop()
        max_depth = max(max_depth, depth)
        bmin = np.full((width, 3), 1e30, np.float32)
        bmax = np.full((width, 3), -1e30, np.float32)
        cidx = np.zeros(width, np.int32)
        ccnt = np.full(width, -1, np.int32)
        for k, s in enumerate(slots):
            bmin[k] = nmin[s]
            bmax[k] = nmax[s]
            if choice[s, 0] == -1:  # leaf row over the whole subtree
                first, cnt = int(t_first[s]), int(t_count[s])
                seg = b.tri_indices[first : first + cnt]
                cidx[k] = leaf_cursor
                ccnt[k] = cnt
                leaf_order.append(seg)
                leaf_cursor += cnt
            else:  # interior wide child
                child_row = len(rows)
                rows.append(np.zeros(ncol, np.float32))
                cidx[k] = child_row
                ccnt[k] = 0
                stack.append((decompose(s, W1), child_row, depth + 1))
        row = np.empty(ncol, np.float32)
        row[0 : 6 * width] = np.concatenate([bmin, bmax], axis=1).reshape(-1)
        row[6 * width : 7 * width] = cidx.view(np.float32)
        row[7 * width : 8 * width] = ccnt.view(np.float32)
        rows[row_idx] = row

    return _bvh8(b, rows, leaf_order, max_depth)


def _half_area_rows(nmin: np.ndarray, nmax: np.ndarray) -> np.ndarray:
    e = np.maximum(nmax - nmin, 0.0).astype(np.float64)
    return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]


@dataclasses.dataclass
class BVH8Slim:
    """Leaf-blocked tables: every leaf is ONE 512-byte row of triangle
    records, so a leaf visit is one contiguous row read that returns
    everything shading needs (flat normal, owning object, original
    triangle id).

    ltris row layout, (NL, 128) f32 = 8 records x 16 cols (to_slim):
      +0..2  v0        +3..5  e1 = v1 - v0     +6..8  e2 = v2 - v0
      +9..11 flat v0.normal (TriangleNormal, Source/Primitives.cpp:148)
      +12    owning object index (bitcast i32; scene fills this)
      +13    original triangle id (bitcast i32; -1 in padding records)
      +14,15 zero padding (degenerate records fail the determinant test)
    or 14 bare records of stride 9 [v0, e1, e2] (to_slim_occl).

    nodes row layout, (B, 64) f32:
      cols  0..47: 8 children x (min.xyz, max.xyz)
      cols 48..55: bitcast int32 PRE-ENCODED child entry:
                   >= 0 interior child row, < 0 leaf: row = -entry - 1,
                   EMPTY (0x40000000) for unused slots (the direction-
                   agnostic slab test can spuriously pass an empty slot's
                   inverted bounds, so validity lives in the entry)
      cols 56..63: bitcast int32 child_count (host-side bookkeeping; the
                   kernel never reads it)
    At width 16 (collapse_sah(width=16)) the rows are (B, 128): bounds
    0..95, entries 96..111, counts 112..127, with the same encoding.
    """

    nodes: np.ndarray     # (B, 64) f32 -- (B, 128) at width 16
    ltris: np.ndarray     # (NL, 128) f32 leaf records
    max_depth: int

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_leaf_rows(self) -> int:
        return len(self.ltris)

    @property
    def width(self) -> int:
        return self.nodes.shape[1] // 8


def to_slim_occl(w: BVH8) -> BVH8Slim:
    """Re-encode a BVH8 (leaf_max <= OCCL_TRIS) into occlusion-only
    leaf-blocked tables for any-hit shadow traversal.

    Shadow rays (the NEE occlusion test, Source/Main.cpp:452-453) only
    need a boolean "does any triangle intersect with t < tmax", so the
    leaf record drops the flat normal / object index / triangle id of
    the shading-complete `to_slim` rows.  A leaf row packs OCCL_TRIS=14
    records of OCCL_STRIDE=9 floats [v0, e1, e2] (126 of 128 cols;
    degenerate all-zero padding records fail the determinant epsilon
    like to_slim's).  Occlusion results are bitwise identical to the
    shading tree's any-hit (same Moller-Trumbore arithmetic on the same
    float v0/e1/e2 values; the occluded bit is an OR over the same
    triangle set)."""
    nodes = w.nodes.copy()
    cidx = nodes[:, 48:56].view(np.int32)
    ccnt = nodes[:, 56:64].view(np.int32)
    is_leaf = ccnt > 0
    if is_leaf.any() and int(ccnt[is_leaf].max()) > OCCL_TRIS:
        raise ValueError(f"occlusion tables need leaf_max <= {OCCL_TRIS}")

    starts = cidx[is_leaf]
    counts = ccnt[is_leaf]
    nl = len(starts)
    ltris = np.zeros((max(nl, 1), 128), np.float32)
    for leaf, (st, c) in enumerate(zip(starts, counts)):
        for k in range(int(c)):
            base = OCCL_STRIDE * k
            ltris[leaf, base : base + 9] = w.tris9[st + k]
    leaf_rows = np.arange(nl, dtype=np.int32)
    cidx[is_leaf] = -(leaf_rows + 1)
    cidx[ccnt == -1] = SLIM_EMPTY
    return BVH8Slim(nodes=nodes, ltris=ltris, max_depth=w.max_depth)


def to_slim(w: BVH8, tri_normal: np.ndarray) -> BVH8Slim:
    """Re-encode a BVH8 (built with leaf_max=8) into leaf-blocked form.

    tri_normal: (T, 3) flat per-triangle normals in ORIGINAL order.
    The object-index column is left 0; the scene build stamps it.  Width
    follows the input tree: a width-16 BVH8 keeps its (B, 128) node rows
    (bounds 0..95, entries 96..111) with the same leaf / EMPTY entry
    encoding; leaf records are the same at both widths."""
    width = w.width
    nodes = w.nodes.copy()
    cidx = nodes[:, 6 * width : 7 * width].view(np.int32)
    ccnt = nodes[:, 7 * width : 8 * width].view(np.int32)
    is_leaf = ccnt > 0
    if is_leaf.any() and int(ccnt[is_leaf].max()) > 8:
        raise ValueError("slim tables need leaf_max <= 8")

    starts = cidx[is_leaf]
    counts = ccnt[is_leaf]
    nl = len(starts)
    ltris = np.zeros((max(nl, 1), 128), np.float32)
    tid_view = ltris.view(np.int32)
    for row, (st, c) in enumerate(zip(starts, counts)):
        for k in range(8):
            base = 16 * k
            if k < c:
                ltris[row, base : base + 9] = w.tris9[st + k]
                orig = int(w.leaf_tri_id[st + k])
                ltris[row, base + 9 : base + 12] = tri_normal[orig]
                tid_view[row, base + 13] = orig
            else:
                tid_view[row, base + 13] = -1
    # pre-encode entries: leaf children -> -(leaf_row + 1); empty -> EMPTY
    leaf_rows = np.arange(nl, dtype=np.int32)
    cidx[is_leaf] = -(leaf_rows + 1)
    cidx[ccnt == -1] = SLIM_EMPTY
    return BVH8Slim(nodes=nodes, ltris=ltris, max_depth=w.max_depth)


def slim_side_tables(nodes: np.ndarray,
                     roots: tuple[int, ...]) -> tuple[np.ndarray, int]:
    """The entry side table of a slim 8-wide node table (CPUGPU_SMEMTREE):
    (ents, nvirt), ents (B + nvirt, 8) i32 holding each node row's 8
    pre-encoded child entries (the bits of node cols 48..55), then
    `nvirt` virtual rows of the extra roots roots[1:] in chunks of 8
    (padded with SLIM_EMPTY).  The JAX package's TPU kernels seed their
    frame stack from the virtual rows; the port's kernels take the roots
    from their launch arguments and read the real rows only."""
    if nodes.shape[1] != 64:
        raise ValueError("side tables are for 8-wide 64-col slim nodes")
    ents = np.ascontiguousarray(nodes.view(np.int32)[:, 48:56])
    extra = [int(r) for r in roots[1:]]
    vrows = []
    while extra:
        chunk, extra = extra[:8], extra[8:]
        row = np.full((8,), SLIM_EMPTY, np.int32)
        row[: len(chunk)] = chunk
        vrows.append(row)
    if vrows:
        ents = np.concatenate([ents, np.stack(vrows)], axis=0)
    return ents, len(vrows)


def slim_bounds48(nodes: np.ndarray) -> np.ndarray:
    """(B, 48) bounds-only node table (CPUGPU_SMEMTREE=48): the entry and
    count columns move to the side table and the row shrinks from 256 to
    192 bytes.  Empty child slots get NaN bounds.  The JAX package relies
    on every slab comparison against NaN being False; the port's kernels
    keep validity in the entry (ents[k] != SLIM_EMPTY), because CUDA's
    fminf / fmaxf drop a NaN operand."""
    if nodes.shape[1] != 64:
        raise ValueError("bounds48 is derived from 8-wide 64-col nodes")
    b = np.ascontiguousarray(nodes[:, :48])
    empty = nodes.view(np.int32)[:, 48:56] == SLIM_EMPTY
    for k in range(8):
        b[empty[:, k], 6 * k : 6 * k + 6] = np.nan
    return b
