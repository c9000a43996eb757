"""BVH8 table (port of ``ops/bvh8.py``): the acceleration structure K2 walks.

Row layout ((N, 128) float32, slot-major SoA groups):
  internal: [0:8]=lo.x[slot] [8:16]=lo.y [16:24]=lo.z [24:32]=hi.x [32:40]=hi.y
            [40:48]=hi.z  [48]=first child row  [49]=offset map (3 bits per
            slot: child row = base + (offmap >> 3*slot) & 7); empty slots
            carry inverted boxes (lo = 3e38 > hi = -3e38); [127]=0
  leaf:     9 coordinate planes of leaf_max lanes, v0.x v0.y v0.z v1.x ...
            v2.z, at [0 : 9*leaf_max], then the original triangle ids (-1 =
            empty slot) at [9*leaf_max : 10*leaf_max]; [127]=1.  leaf_max is
            8 or 12 (12 * 10 lanes still fit the row); internal rows keep 8
            slots either way.

The table has three kinds, the reference's: f32 rows with 8-triangle
leaves, f32 rows with 12-triangle leaves, and bf16 rows with 8-triangle
leaves (``table_to_bf16``: (N, 128) bfloat16, 256 bytes a row; boxes rounded
outwards, integer lanes as exact 8-bit pieces, leaf vertices rounded to
nearest relative to the leaf's vertex centroid; ops/traverse.decode_rows
reads them back).  ``build_bvh8_auto`` and runtime/renderer.Renderer._get_bvh
choose among them by the reference's table-size rule (TABLE_BUDGET_BYTES).

Static scenes build it once on the host: native binned-SAH binary tree,
collapsed to 8-wide rows (native_bridge.py); any other binary tree, such as
the device LBVH (ops/bvh.py), collapses the same way (``build_bvh8_host``),
natively or, without a native build, in Python with the same rows.
``validate_host`` checks an f32 table's structure.  The per-slot refit
metadata (child8 / valid8 / tri8) is read back from the rows
(``BVH8.from_rows``), and ``refit8`` recomputes the leaf triangles and every
box of an f32 table for moved vertices with the topology kept: animated
scenes refit every frame (models/passes.add_bvh_pass).  It is plain PyTorch
on every device: a refit is `depth` sweeps of a few gathers over the rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch import native_bridge

LEAF_MAX = 8
BIG = 3.0e38  # the inverted box of an empty slot: lo = BIG > hi = -BIG
#: the reference's table-size rule (vulkanhybridrenderer_tpu/ops/bvh8.py:302,
#: runtime/renderer.py:204-232): a table kind is taken where its bytes, rows
#: x 128 x the element size, are at most this
TABLE_BUDGET_BYTES = 15 << 20
#: the table kinds: (row dtype, leaf_max) -> name
KINDS = {(torch.float32, 8): "f32-8", (torch.float32, 12): "f32-12",
         (torch.bfloat16, 8): "bf16-8"}


@dataclasses.dataclass(frozen=True)
class BVH8:
    rows: Any  # (N, 128) float32 or bfloat16 tensor
    #: stack bound: longest root-to-leaf chain of internal rows, plus 2
    depth: int = 16
    leaf_max: int = LEAF_MAX
    #: refit metadata, (N, 8) each: an internal row's child row per slot (-1:
    #: empty slot, and every slot of a leaf row), its non-empty slots, and a
    #: leaf row's triangle ids (-1: empty slot, and every slot of an
    #: internal row).  None on a table made without them (refit8 needs them)
    child8: Any = None  # int32
    valid8: Any = None  # bool
    tri8: Any = None  # int32

    @property
    def is_leaf_rows(self):
        """(N,) bool: the leaf rows ([127] = 1)."""
        return self.rows[:, 127] > 0.5

    @property
    def root(self) -> int:
        return 0

    @property
    def num_rows(self) -> int:
        return self.rows.shape[0]

    @property
    def kind(self) -> str:
        """The table's kind: "f32-8", "f32-12" or "bf16-8"."""
        return table_kind(self.rows, self.leaf_max)

    @property
    def table_bytes(self) -> int:
        """The row table's bytes: 512 a row in f32, 256 in bf16."""
        return self.rows.shape[0] * self.rows.shape[1] * self.rows.element_size()

    def to(self, device) -> "BVH8":
        move = lambda a: None if a is None else a.to(device)  # noqa: E731
        return dataclasses.replace(self, rows=self.rows.to(device),
                                   child8=move(self.child8), valid8=move(self.valid8),
                                   tri8=move(self.tri8))

    @classmethod
    def from_rows(cls, rows, depth: int, leaf_max: int = LEAF_MAX) -> "BVH8":
        """A BVH8 over `rows` (f32 with leaf_max 8 or 12, or bf16 with 8)
        with its refit metadata read from the rows as the walk decodes them
        (ops/traverse.decode_rows): an internal row's non-inverted boxes are
        its valid slots, its first child row and offset map give their child
        rows; a leaf row's id lanes its triangle ids."""
        from vulkanhybridrenderer_tpu_torch.ops.traverse import decode_rows

        table_kind(rows, leaf_max)
        rf, base, offmap, tri = decode_rows(rows, leaf_max)
        leaf = rf[:, 127] > 0.5
        valid = ~leaf[:, None] & (rf[:, 0:8] <= rf[:, 24:32])
        shift = 3 * torch.arange(8, device=rows.device)
        child = base.to(torch.int64)[:, None] + ((offmap.to(torch.int64)[:, None] >> shift) & 7)
        child8 = torch.where(valid, child, -1).to(torch.int32)
        tri8 = torch.where(leaf[:, None], tri, -1)
        return cls(rows=rows, depth=int(depth), leaf_max=leaf_max,
                   child8=child8, valid8=valid, tri8=tri8)


def table_kind(rows, leaf_max: int) -> str:
    """The kind of a table of `rows` with `leaf_max` triangles a leaf
    (KINDS); ValueError for any other pair."""
    kind = KINDS.get((rows.dtype, leaf_max))
    if kind is None:
        raise ValueError(f"BVH8 rows are float32 with 8 or 12 triangles a leaf, or bfloat16 "
                         f"with 8 (lanes [72:96] take a bf16 row's id pieces); got "
                         f"{rows.dtype} with {leaf_max}")
    return kind


def build_bvh8_host(bvh, tri_verts, prefer_native: bool = True,
                    leaf_max: int = LEAF_MAX) -> BVH8:
    """The BVH8 of any binary tree (ops/bvh.BVH: the SAH tree, the native or
    the device LBVH, any leaf_size) over its (T, 3, 3) triangles, collapsed
    on the host into f32 rows with `leaf_max` (8 or 12) triangles a leaf:
    natively (native/bvh8.cpp) where prefer_native and the native build is
    available, else in Python; both give the same rows and depth.  The
    reference's signature and function.  Returns a BVH8 whose rows live on
    the CPU."""
    if leaf_max not in (8, 12):
        raise ValueError(f"leaf_max={leaf_max}: BVH8 leaf rows hold 8 or 12 triangles")
    if prefer_native and native_bridge.native_available():
        rows, depth = native_bridge.bvh8_collapse_host(bvh, tri_verts, leaf_max)
    else:
        rows, depth = _collapse_python(bvh, np.asarray(tri_verts, np.float32), leaf_max)
    return BVH8.from_rows(torch.from_numpy(rows), depth, leaf_max)


def build_bvh8_sah_host(tri_verts, leaf_max: int = LEAF_MAX) -> BVH8:
    """The native binned-SAH binary tree of (T, 3, 3) world triangles,
    collapsed by ``build_bvh8_host``.  Needs the native build.  Returns a
    BVH8 whose rows live on the CPU."""
    tris = np.asarray(tri_verts, np.float32)
    return build_bvh8_host(native_bridge.build_sah_host(tris), tris, leaf_max=leaf_max)


def build_bvh8_auto(bvh, tri_verts, budget: int = TABLE_BUDGET_BYTES) -> BVH8:
    """The reference's leaf-width choice (its build_bvh8_auto): the f32
    leaf-8 table where its bytes are at most `budget`, else the leaf-12
    table where that one's are, else the leaf-8 table."""
    b8 = build_bvh8_host(bvh, tri_verts, leaf_max=8)
    if b8.num_rows * 512 <= budget:
        return b8
    b12 = build_bvh8_host(bvh, tri_verts, leaf_max=12)
    if b12.num_rows * 512 <= budget:
        return b12
    return b8


def _bf16_directed(x, up: bool):
    """bfloat16 bit patterns (uint16) of float32 values rounded upwards (up)
    or downwards: the reference's _bf16_directed.  Dropping an f32's low 16
    bits rounds its magnitude down; adding 0xFFFF first rounds it up; the
    direction is away from zero exactly when the sign disagrees with it.
    Values exact in bf16 are unchanged either way."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    away = (bits >> 31).astype(bool) != up
    bits = np.where(away, bits + np.uint32(0xFFFF), bits) & np.uint32(0xFFFF0000)
    return (bits >> 16).astype(np.uint16)


def _bf16_nearest(x):
    """bfloat16 bit patterns (uint16) of float32 values rounded to nearest,
    ties to even, NaN to the quiet NaN 0x7FC0 with its sign: numpy's astype
    to bfloat16 (ml_dtypes) without ml_dtypes."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    near = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) >> 16
    quiet = ((bits >> 16) & np.uint32(0x8000)) | np.uint32(0x7FC0)
    return np.where(np.isnan(x), quiet, near).astype(np.uint16)


def table_to_bf16(b: BVH8) -> BVH8:
    """The f32 leaf-8 table of `b` re-encoded in bf16 (the reference's
    table_to_bf16, bit for bit; half the bytes).  Layout (decoded by
    ops/traverse.decode_rows):
      internal rows: [0:24] lo planes rounded down, [24:48] hi planes
        rounded up (every box only grows: a walk may descend more, never
        miss a hit; the empty slots' +-3e38 stay inverted); [48:51] the
        first child row and [51:54] the offset map as 8-bit pieces (lo,
        mid, hi), exact in bf16.
      leaf rows: [0:72] the vertices minus the row's per-axis vertex
        centroid (over its valid slots), rounded to nearest; [72:80],
        [80:88], [88:96] the 8-bit pieces of triangle id + 1 (0: empty
        slot); [96:99] the centroid in bf16 and [99:102] its residual (c
        minus the first, in bf16).  Internal rows keep [96:102] zero.
      [127] the leaf flag, 0 or 1.
    The host arithmetic is the reference's numpy arithmetic.  Static
    scenes only: refit8 writes f32 rows.  The rows are bfloat16 on b's
    device; the refit metadata is b's."""
    if b.leaf_max != 8 or b.rows.dtype != torch.float32:
        raise ValueError("table_to_bf16 needs f32 rows with 8-triangle leaves (lanes "
                         "[72:96] take the id pieces)")
    rows = b.rows.cpu().numpy()
    n = rows.shape[0]
    leaf = rows[:, 127] > 0.5
    out = np.zeros((n, 128), np.uint16)
    out[:, 127] = _bf16_nearest(rows[:, 127])

    def bytes3(v):
        v = v.astype(np.int64)
        return (v & 255), ((v >> 8) & 255), ((v >> 16) & 255)

    ri = rows[~leaf]
    oi = out[~leaf]
    oi[:, 0:24] = _bf16_directed(ri[:, 0:24], up=False)
    oi[:, 24:48] = _bf16_directed(ri[:, 24:48], up=True)
    for j, piece in enumerate(bytes3(np.round(ri[:, 48]))):
        oi[:, 48 + j] = _bf16_nearest(piece.astype(np.float32))
    for j, piece in enumerate(bytes3(np.round(ri[:, 49]))):
        oi[:, 51 + j] = _bf16_nearest(piece.astype(np.float32))
    out[~leaf] = oi

    rl = rows[leaf]
    ol = out[leaf]
    ids1 = np.round(rl[:, 72:80]).astype(np.int64) + 1  # -1 (empty) -> 0
    valid = ids1 > 0
    # per-axis vertex centroid over the valid slots (plane k holds axis k % 3),
    # in the reference's numpy operations and order
    vmask = np.concatenate([valid] * 9, axis=1)
    verts = rl[:, 0:72]
    cen = np.zeros((rl.shape[0], 3), np.float32)
    for ax in range(3):
        lanes = np.concatenate([np.arange(k * 8, k * 8 + 8) for k in range(ax, 9, 3)])
        sel = verts[:, lanes] * vmask[:, lanes]
        cen[:, ax] = sel.sum(axis=1) / np.maximum(vmask[:, lanes].sum(axis=1), 1)
    c_hi = _bf16_nearest(cen)
    c_hi_f = (c_hi.astype(np.uint32) << 16).view(np.float32)
    c_lo = _bf16_nearest(cen - c_hi_f)
    cexp = np.concatenate([cen[:, k % 3:k % 3 + 1].repeat(8, axis=1) for k in range(9)],
                          axis=1)
    rel = np.where(vmask, verts - cexp, 0.0).astype(np.float32)
    ol[:, 0:72] = _bf16_nearest(rel)
    for j, piece in enumerate(bytes3(ids1)):
        ol[:, 72 + 8 * j:80 + 8 * j] = _bf16_nearest(piece.astype(np.float32))
    ol[:, 96:99] = c_hi
    ol[:, 99:102] = c_lo
    out[leaf] = ol
    bf16 = torch.from_numpy(out).view(torch.bfloat16).to(b.rows.device)
    return dataclasses.replace(b, rows=bf16)


def _subtree_counts(left, right, leaf_tri, order, leaf_size):
    """Per-node triangle counts of a binary tree (numpy int64): a leaf's
    valid `order` entries, an internal node's children's sum, by whole-tree
    sweeps until nothing changes (as many as the tree is deep)."""
    is_leaf = leaf_tri >= 0
    count = np.zeros(left.shape[0], np.int64)
    slots = leaf_tri[is_leaf, None] + np.arange(leaf_size)
    inside = slots < order.shape[0]
    count[is_leaf] = ((order[np.where(inside, slots, 0)] >= 0) & inside).sum(axis=1)
    internal = np.flatnonzero(~is_leaf)
    for _ in range(left.shape[0] + 1):
        new = count[left[internal]] + count[right[internal]]
        if np.array_equal(new, count[internal]):
            return count
        count[internal] = new
    raise ValueError("subtree counts do not settle: the tree has a cycle")


def _collapse_python(bvh, tris, leaf_max: int):
    """The reference's Python collapse (its build_bvh8_host with
    prefer_native=False), which native/bvh8.cpp mirrors: ((N, 128) float32
    rows, depth bound).  Each BVH8 node, from the root and last-made
    first, greedily splits its largest binary subtree until it has >= 8
    bins or none is larger than a leaf (``make_bins``); subtrees of at most
    leaf_max triangles are packed first-fit by falling count into leaf bins
    (``pack``).  A bin takes the slot of its centre's octant about the
    node's centre, probing upwards mod 8, and children get rows in slot
    order.  Box centres are float32, as the native code computes them."""
    left, right = bvh.left.cpu().numpy(), bvh.right.cpu().numpy()
    leaf_tri, order = bvh.leaf_tri.cpu().numpy(), bvh.order.cpu().numpy()
    amin, amax = bvh.aabb_min.cpu().numpy(), bvh.aabb_max.cpu().numpy()
    ls = bvh.leaf_size
    count = _subtree_counts(left, right, leaf_tri, order, ls).tolist()
    centre = np.float32(0.5) * (amin + amax)
    left_l, right_l, start_l, order_l = (left.tolist(), right.tolist(), leaf_tri.tolist(),
                                         order.tolist())

    def pack(roots):
        """(subtrees that stay internal, in roots order; leaf packs)."""
        big = [r for r in roots if count[r] > leaf_max]
        small = sorted((r for r in roots if count[r] <= leaf_max), key=lambda r: -count[r])
        packs = []  # [triangles, [roots]]
        for r in small:
            for p in packs:
                if p[0] + count[r] <= leaf_max:
                    p[0] += count[r]
                    p[1].append(r)
                    break
            else:
                packs.append([count[r], [r]])
        return big, [rs for _, rs in packs]

    def make_bins(node):
        roots = [node]
        while True:
            big, packs = pack(roots)
            if len(big) + len(packs) >= 8 or not big:
                return big, packs
            r = max(big, key=count.__getitem__)  # the first of the largest
            roots.remove(r)
            roots += [left_l[r], right_l[r]]

    def collect_tris(roots):
        """The triangle ids under `roots`, each walked depth-first, right
        child first (the reference's stack order)."""
        out = []
        for root in roots:
            stack = [root]
            while stack:
                n = stack.pop()
                s = start_l[n]
                if s >= 0:
                    out += [t for t in order_l[s:s + ls] if t >= 0]
                else:
                    stack += [left_l[n], right_l[n]]
        return out

    # the tables of the rows, filled below: an internal row's (slot, child
    # row, box) per child; a leaf row's triangle ids
    int_row, int_slot, int_child, int_lo, int_hi = [], [], [], [], []
    leaves = {}  # row -> triangle ids
    root = int(bvh.root)
    pending = [(None if count[root] <= leaf_max else root, [root], 0, 1)]  # bin, row, depth
    next_row, depth = 1, 1
    while pending:
        node, roots, row, d = pending.pop()
        depth = max(depth, d)
        if node is None:
            leaves[row] = collect_tris(roots)
            continue
        big, packs = make_bins(node)
        bins = [(b, [b], amin[b], amax[b], centre[b]) for b in big]
        for rs in packs:
            lo, hi = amin[rs].min(axis=0), amax[rs].max(axis=0)
            bins.append((None, rs, lo, hi, np.float32(0.5) * (lo + hi)))
        c_node = centre[node]
        by_slot = {}
        for b in bins:
            c = b[4]
            want = (4 if c[0] >= c_node[0] else 0) | (2 if c[1] >= c_node[1] else 0) | (
                1 if c[2] >= c_node[2] else 0)
            slot = next((want + k) % 8 for k in range(8) if (want + k) % 8 not in by_slot)
            by_slot[slot] = b
        for slot in sorted(by_slot):
            b = by_slot[slot]
            int_row.append(row)
            int_slot.append(slot)
            int_child.append(next_row)
            int_lo.append(b[2])
            int_hi.append(b[3])
            pending.append((b[0], b[1], next_row, d + 1))
            next_row += 1

    rows = np.zeros((next_row, 128), np.float32)
    if int_row:
        r, slot, child = np.array(int_row), np.array(int_slot), np.array(int_child)
        rows[r, 0:24] = 3.0e38  # empty slots: inverted boxes
        rows[r, 24:48] = -3.0e38
        for axis, (lo, hi) in enumerate(zip(np.stack(int_lo).T, np.stack(int_hi).T)):
            rows[r, axis * 8 + slot] = lo
            rows[r, (3 + axis) * 8 + slot] = hi
        # children take consecutive rows, so base is the first child's row
        # and a slot's offset its rank among the row's children
        base = np.full(next_row, np.iinfo(np.int64).max)
        np.minimum.at(base, r, child)
        offmap = np.zeros(next_row, np.int64)
        np.bitwise_or.at(offmap, r, (child - base[r]) << (3 * slot))
        internal = np.unique(r)
        rows[internal, 48] = base[internal]
        rows[internal, 49] = offmap[internal]
    leaf_rows = np.fromiter(leaves, np.int64, len(leaves))
    tri8 = np.full((leaf_rows.shape[0], leaf_max), -1, np.int64)
    for i, ids in enumerate(leaves.values()):
        tri8[i, :len(ids)] = ids
    rows[leaf_rows, 127] = 1.0
    rows[leaf_rows, 9 * leaf_max:10 * leaf_max] = tri8
    # coordinate c of slot s at [c * leaf_max + s], c = corner * 3 + axis
    li, slot = np.nonzero(tri8 >= 0)
    cols = np.arange(9) * leaf_max + slot[:, None]
    rows[leaf_rows[li][:, None], cols] = tris.reshape(-1, 9)[tri8[li, slot]]
    return rows, depth + 2


def validate_host(b: BVH8, tri_verts) -> None:
    """Structural check of a BVH8 over its (T, 3, 3) triangles (a testing
    aid; the reference's validate_host, vectorized): from row 0, every row
    is reached exactly once, and none is left unreached; a leaf row (col
    127 == 1) has no children and each of its slots carries its triangle's
    nine coordinates exactly; an internal row's empty slot has an inverted
    box (lo.x > hi.x) and child -1, and its offset map and base give each
    valid slot's child8 row; every triangle sits in exactly one slot; the
    longest chain of rows is at most b.depth.  The reference's docstring
    also names child boxes inside their parents; its code does not check
    that, and neither does this.  Raises AssertionError on a violation.
    It reads f32 tables of either leaf width; a bf16 table's leaf rows
    carry rounded centroid-relative vertices and its integer lanes pieces,
    which the reference's check reads as f32 lanes and fails on: this one
    raises AssertionError on it at once."""
    if b.rows.dtype != torch.float32:
        raise AssertionError(f"validate_host checks f32 tables; got {b.rows.dtype} rows "
                             "(table_to_bf16's leaf vertices are rounded)")
    rows = b.rows.cpu().numpy()
    child8, valid8, tri8 = (b.child8.cpu().numpy(), b.valid8.cpu().numpy(),
                            b.tri8.cpu().numpy())
    tris = np.asarray(tri_verts.cpu() if torch.is_tensor(tri_verts) else tri_verts)
    n = rows.shape[0]
    seen = np.zeros(n, np.int64)
    frontier, depth = np.zeros(1, np.int64), 0
    leaf_rows = []
    while frontier.size:
        depth += 1
        np.add.at(seen, frontier, 1)
        if (seen[frontier] > 1).any():
            raise AssertionError(f"row {int(frontier[seen[frontier] > 1][0])} reachable twice")
        leaf = rows[frontier, 127] == 1.0
        leaf_rows.append(frontier[leaf])
        inner = frontier[~leaf]
        valid = valid8[inner]
        empty_ok = (rows[inner, 0:8] > rows[inner, 24:32]) & (child8[inner] == -1)
        bad = ~(valid | empty_ok).all(axis=1)
        if bad.any():
            raise AssertionError(f"row {int(inner[bad][0])}: an empty slot without an inverted "
                                 "box and child -1")
        base = rows[inner, 48].astype(np.int64)[:, None]
        offmap = rows[inner, 49].astype(np.int64)[:, None]
        child = base + ((offmap >> (3 * np.arange(8))) & 7)
        bad = ((child != child8[inner]) & valid).any(axis=1)
        if bad.any():
            raise AssertionError(f"row {int(inner[bad][0])}: offmap / base disagree with child8")
        frontier = child[valid]
    leaf_rows = np.concatenate(leaf_rows)
    if (child8[leaf_rows] != -1).any() or valid8[leaf_rows].any():
        raise AssertionError("a leaf row has children")
    ids = tri8[leaf_rows]
    li, slot = np.nonzero(ids >= 0)
    cols = np.arange(9) * b.leaf_max + slot[:, None]
    got = rows[leaf_rows[li][:, None], cols]
    want = tris.reshape(-1, 9)[ids[li, slot]].astype(np.float32)
    if not np.array_equal(got, want):
        raise AssertionError("a leaf slot does not carry its triangle's coordinates")
    if not np.array_equal(np.sort(ids[li, slot]), np.arange(tris.shape[0])):
        raise AssertionError("the triangles are not each in exactly one leaf slot")
    if (seen == 0).any():
        raise AssertionError(f"{int((seen == 0).sum())} rows unreachable (wasted table)")
    if depth > b.depth:
        raise AssertionError(f"depth {depth} > bound {b.depth}")


def refit8(b: BVH8, tri_verts, sweeps: int | None = None) -> BVH8:
    """The rows of `b` for moved triangles (T, 3, 3), with the topology kept
    (the reference's refit8, bvh8.py:430-522, UpdateBLAS in the original):
    leaf rows take their triangles' new coordinates, and `sweeps` bottom-up
    passes (default: the tree's depth bound; fewer leave upper boxes stale,
    which misses hits) recompute every internal row's child boxes.  As in the
    reference, an empty leaf slot takes triangle 0's coordinates (its id
    stays -1), so the rows equal the reference's bit for bit.  f32 tables
    of either leaf width; a bf16 table raises ValueError, as the
    reference's does."""
    if b.rows.dtype != torch.float32:
        raise ValueError(
            "refit8 needs an f32 table: bf16 rows (table_to_bf16) are for static "
            "scenes; use bvh_dtype='f32' when animating")
    if b.child8 is None:
        raise ValueError("refit8: the BVH8 has no refit metadata (BVH8.from_rows)")
    if sweeps is None:
        sweeps = b.depth
    n, lm = b.num_rows, b.leaf_max
    rows = b.rows
    leaf = rows[:, 127] > 0.5
    tvalid = b.tri8 >= 0
    tflat = tri_verts.reshape(-1, 9)  # [v0.xyz v1.xyz v2.xyz]
    coords = tflat[torch.clamp(b.tri8, min=0).long()]  # (N, leaf_max, 9)

    # leaf boxes over the valid slots: corner c, axis a at coords[..., 3c + a]
    lo, hi = [], []
    for a in range(3):
        axis = coords[..., a::3]  # (N, leaf_max, 3 corners)
        lo.append(torch.where(tvalid[..., None], axis, BIG).amin(dim=(1, 2)))
        hi.append(torch.where(tvalid[..., None], axis, -BIG).amax(dim=(1, 2)))
    amin = torch.where(leaf[:, None], torch.stack(lo, -1), BIG)
    amax = torch.where(leaf[:, None], torch.stack(hi, -1), -BIG)

    child = torch.clamp(b.child8, min=0).long()  # (N, 8)
    v = b.valid8[..., None]
    for _ in range(sweeps):
        new_min = torch.where(v, amin[child], BIG).amin(dim=1)
        new_max = torch.where(v, amax[child], -BIG).amax(dim=1)
        amin = torch.where(leaf[:, None], amin, new_min)
        amax = torch.where(leaf[:, None], amax, new_max)

    # re-pack: leaf rows [0 : 9*leaf_max] coordinate planes (plane c holds
    # coordinate c of the slots); internal rows [0:48] the child boxes,
    # axis-major, and their lanes [48 : 9*leaf_max] as they were
    leaf_cols = coords.permute(0, 2, 1).reshape(n, 9 * lm)
    int_lo = torch.where(v, amin[child], BIG).permute(0, 2, 1).reshape(n, 24)
    int_hi = torch.where(v, amax[child], -BIG).permute(0, 2, 1).reshape(n, 24)
    internal_cols = torch.cat([int_lo, int_hi, rows[:, 48:9 * lm]], dim=1)
    geom = torch.where(leaf[:, None], leaf_cols, internal_cols)
    return dataclasses.replace(b, rows=torch.cat([geom, rows[:, 9 * lm:]], dim=1).contiguous())
