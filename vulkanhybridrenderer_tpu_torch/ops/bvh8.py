"""BVH8 table (port of ``ops/bvh8.py``): the acceleration structure K2 walks.

Row layout ((N, 128) float32, slot-major SoA groups of 8):
  internal: [0:8]=lo.x[slot] [8:16]=lo.y [16:24]=lo.z [24:32]=hi.x [32:40]=hi.y
            [40:48]=hi.z  [48]=first child row  [49]=offset map (3 bits per
            slot: child row = base + (offmap >> 3*slot) & 7); empty slots
            carry inverted boxes (lo = 3e38 > hi = -3e38); [127]=0
  leaf:     [0:72] = v0.x[8] v0.y[8] v0.z[8] v1.x[8] ... v2.z[8]
            [72:80] = original triangle ids (-1 = empty slot); [127]=1

Static scenes build it once on the host: native binned-SAH binary tree,
collapsed to 8-wide rows with 8-triangle leaves (native_bridge.py); any
other binary tree, such as the device LBVH (ops/bvh.py), collapses the same
way (``collapse_host``), natively or, without a native build, in Python
with the same rows.  ``validate_host`` checks a table's structure.  The
per-slot refit metadata (child8 / valid8 / tri8) is read back from the rows
(``BVH8.from_rows``), and ``refit8`` recomputes the leaf triangles and every
box for moved vertices with the topology kept: animated scenes refit every
frame (models/passes.add_bvh_pass).  It is plain PyTorch on every device: a
refit is `depth` sweeps of a few gathers over the rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch import native_bridge

LEAF_MAX = 8
BIG = 3.0e38  # the inverted box of an empty slot: lo = BIG > hi = -BIG


@dataclasses.dataclass(frozen=True)
class BVH8:
    rows: Any  # (N, 128) float32 tensor
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
    def num_rows(self) -> int:
        return self.rows.shape[0]

    def to(self, device) -> "BVH8":
        move = lambda a: None if a is None else a.to(device)  # noqa: E731
        return dataclasses.replace(self, rows=self.rows.to(device),
                                   child8=move(self.child8), valid8=move(self.valid8),
                                   tri8=move(self.tri8))

    @classmethod
    def from_rows(cls, rows, depth: int, leaf_max: int = LEAF_MAX) -> "BVH8":
        """A BVH8 over `rows` with its refit metadata read from them: an
        internal row's non-inverted boxes are its valid slots, [48] and [49]
        give their child rows; a leaf row's [72:80] its triangle ids."""
        if leaf_max != LEAF_MAX:
            raise ValueError("the port builds 8-triangle leaf rows only")
        leaf = rows[:, 127] > 0.5
        valid = ~leaf[:, None] & (rows[:, 0:8] <= rows[:, 24:32])
        base = rows[:, 48].to(torch.int64)[:, None]
        offmap = rows[:, 49].to(torch.int64)[:, None]
        shift = 3 * torch.arange(8, device=rows.device)
        child = base + ((offmap >> shift) & 7)
        child8 = torch.where(valid, child, -1).to(torch.int32)
        tri8 = torch.where(leaf[:, None], rows[:, 72:80].to(torch.int32), -1)
        return cls(rows=rows, depth=int(depth), leaf_max=leaf_max,
                   child8=child8, valid8=valid, tri8=tri8)


def build_bvh8_host(tri_verts, leaf_max: int = LEAF_MAX) -> BVH8:
    """SAH build + BVH8 collapse of (T, 3, 3) world triangles on the host.
    Returns a BVH8 whose rows live on the CPU."""
    tris = np.asarray(tri_verts, np.float32)
    return collapse_host(native_bridge.build_sah_host(tris), tris, leaf_max)


def collapse_host(bvh, tri_verts, leaf_max: int = LEAF_MAX,
                  prefer_native: bool = True) -> BVH8:
    """The BVH8 of any binary tree (ops/bvh.BVH: the SAH tree, the native or
    the device LBVH, any leaf_size) over its (T, 3, 3) triangles, collapsed
    on the host (the reference's build_bvh8_host(bvh, tri_verts,
    prefer_native)): natively (native/bvh8.cpp) where prefer_native and the
    native build is available, else in Python; both give the same rows and
    depth.  Returns a BVH8 whose rows live on the CPU."""
    if leaf_max != LEAF_MAX:
        raise ValueError("the port builds 8-triangle leaf rows only")
    if prefer_native and native_bridge.native_available():
        rows, depth = native_bridge.bvh8_collapse_host(bvh, tri_verts, leaf_max)
    else:
        rows, depth = _collapse_python(bvh, np.asarray(tri_verts, np.float32), leaf_max)
    return BVH8.from_rows(torch.from_numpy(rows), depth, leaf_max)


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
    that, and neither does this.  Raises AssertionError on a violation."""
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
    stays -1), so the rows equal the reference's bit for bit."""
    if b.child8 is None:
        raise ValueError("refit8: the BVH8 has no refit metadata (BVH8.from_rows)")
    if sweeps is None:
        sweeps = b.depth
    n = b.num_rows
    rows = b.rows
    leaf = rows[:, 127] > 0.5
    tvalid = b.tri8 >= 0
    tflat = tri_verts.reshape(-1, 9)  # [v0.xyz v1.xyz v2.xyz]
    coords = tflat[torch.clamp(b.tri8, min=0).long()]  # (N, 8, 9)

    # leaf boxes over the valid slots: corner c, axis a at coords[..., 3c + a]
    lo, hi = [], []
    for a in range(3):
        axis = coords[..., a::3]  # (N, 8, 3 corners)
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

    # re-pack: leaf rows [0:72] coordinate planes (plane c holds coordinate c
    # of the 8 slots); internal rows [0:48] the child boxes, axis-major
    leaf_cols = coords.permute(0, 2, 1).reshape(n, 72)
    int_lo = torch.where(v, amin[child], BIG).permute(0, 2, 1).reshape(n, 24)
    int_hi = torch.where(v, amax[child], -BIG).permute(0, 2, 1).reshape(n, 24)
    internal_cols = torch.cat([int_lo, int_hi, rows[:, 48:72]], dim=1)
    geom = torch.where(leaf[:, None], leaf_cols, internal_cols)
    return dataclasses.replace(b, rows=torch.cat([geom, rows[:, 72:]], dim=1).contiguous())
