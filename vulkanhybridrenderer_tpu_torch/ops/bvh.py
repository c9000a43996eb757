"""The threaded binary LBVH (port of ``ops/bvh.py``): build, refit, octant
links and the world-triangle gather.

Every Renderer path traces the BVH8 (ops/bvh8.py), collapsed from the host
SAH tree; this module is the reference's device build, the tree its
renderer collapses when the native builder is missing
(``runtime/renderer.py:200-203``), and the tree the stackless walk of
``ops/traverse.trace_flat`` (kernel K4) checks the BVH8 against.

``build`` is the Karras 2012 parallel radix tree as vectorised tensor ops:
morton codes of the triangle centroids, a stable sort, the prefix function
``delta`` with equal codes tie-broken on the index bits, the direction and
range binary search and the split search with fixed iteration counts, then
escape links, boxes and octant links by ``max_depth`` fixed sweeps each
(not "until converged": a deeper tree gets the reference's stale links and
boxes, so ``tree_depth`` says when that happens).  It runs on whichever
device its tensors are on, with no host synchronisation but the tensors'
shapes; on the card it is a few hundred launches.  Every value equals the
reference's run op by op (``jax.disable_jit()``): codes are held in int64
(see ``_expand_bits``), count-leading-zeros comes from an exact float64
``frexp``, and every sort is stable.

Layout (2L-1 nodes): ids 0..L-2 internal, L-1..2L-2 leaves in morton order;
a leaf's ``leaf_tri`` is its start index into ``order``.  -1 ends a walk.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

INVALID = -1


@dataclasses.dataclass(frozen=True)
class BVH:
    """Threaded LBVH over L = ceil(T / leaf_size) leaves, int32 links and
    float32 boxes, all on one device."""

    aabb_min: Any  # (2L-1, 3) float32
    aabb_max: Any  # (2L-1, 3) float32
    left: Any  # (2L-1,) int32 left child (-1 for leaves)
    right: Any  # (2L-1,) int32 right child (-1 for leaves)
    escape: Any  # (2L-1,) int32 next node once this subtree is done (-1: exit)
    #: leaves: start index into `order` (= leaf * leaf_size); -1 internal
    leaf_tri: Any  # (2L-1,) int32
    #: (L * leaf_size,) int32 morton-sorted triangle ids, padded with -1
    order: Any
    #: (8, 2L-1) int32 ordered threading per direction octant o = (dx<0)<<2 |
    #: (dy<0)<<1 | (dz<0): next8[o, i] the near child of internal node i,
    #: esc8[o, i] the node after i's subtree in octant-o order.  None on a
    #: native tree until a caller asks for them (with_octant_links)
    next8: Any = None
    esc8: Any = None
    leaf_size: int = 1

    @property
    def num_leaves(self) -> int:
        return self.order.shape[0] // self.leaf_size

    @property
    def root(self) -> int:
        return 0 if self.num_leaves > 1 else self.num_leaves - 1  # L == 1: leaf 0

    def to(self, device) -> "BVH":
        move = lambda a: None if a is None else a.to(device)  # noqa: E731
        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)
            if f.name != "leaf_size"})


def world_triangles(world_pos, tri_vertex):
    """(V, 3) world positions + (T, 3) vertex ids -> (T, 3, 3) triangles."""
    t = tri_vertex.shape[0]
    return world_pos[tri_vertex.reshape(-1).long()].reshape(t, 3, 3)


def _clz32(x):
    """Leading zeros of the low 32 bits of integer tensor `x` (int32 as
    the reference's ``jax.lax.clz`` counts them; clz(0) = 32).  torch has
    no clz: the bit length is frexp's exponent in float64, exact below
    2^53."""
    bits = x.to(torch.int64) & 0xFFFFFFFF
    _, exp = torch.frexp(bits.to(torch.float64))
    return (32 - exp).to(torch.int32)


def _expand_bits(v):
    """Spread 10 bits to every 3rd position (the morton interleave).  The
    reference multiplies uint32 values, wrapping modulo 2^32; every mask
    here is below 2^32, so the same product in int64 (no overflow: v <
    2^32 times a factor < 2^17) keeps exactly the masked bits."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points, lo, hi):
    """30-bit morton codes (int64) of (..., 3) points normalised into the
    box [lo, hi].  The extent is a tensor divisor (a scalar divisor is not
    exact on CUDA, utils/math3d.div); the scale to 1024 truncates toward 0."""
    x = torch.clamp((points - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)
    q = torch.clamp((x * 1024.0).to(torch.int64), max=1023)
    return ((_expand_bits(q[..., 0]) << 2) | (_expand_bits(q[..., 1]) << 1)
            | _expand_bits(q[..., 2]))


def triangle_aabbs(tri_verts, pad: float = 1e-6):
    """(T, 3, 3) -> (lo (T, 3), hi (T, 3)), padded for flat triangles."""
    return tri_verts.amin(dim=1) - pad, tri_verts.amax(dim=1) + pad


def _ceil_log2(n: int) -> int:
    return max(1, (n - 1).bit_length())


def _octant_links(left_g, right_g, amin, amax, num_internal: int, max_depth: int):
    """Per-octant ordered threading (next8, esc8), each (8, total) int32: an
    octant-o ray visits the near child first, the child whose centroid is
    lower along the node's dominant separation axis (the first on ties) when
    the ray's direction is positive along it.  The eight octants sweep
    together, each as the reference sweeps it alone."""
    total = left_g.shape[0]
    dev = left_g.device
    li, ri = left_g[:num_internal].long(), right_g[:num_internal].long()
    c_l = 0.5 * (amin[li] + amax[li])
    c_r = 0.5 * (amin[ri] + amax[ri])
    diff = c_r - c_l  # (n - 1, 3)
    axis = torch.argmax(torch.abs(diff), dim=-1)
    left_is_lower = diff.gather(1, axis[:, None])[:, 0] >= 0
    octs = torch.arange(8, device=dev)
    # pos[o, a]: octant o's direction is positive along axis a
    pos = torch.stack([(octs >> 2) & 1 == 0, (octs >> 1) & 1 == 0, octs & 1 == 0], dim=1)
    first_is_left = left_is_lower[None, :] == pos[:, axis]  # (8, n - 1)
    first = torch.where(first_is_left, li, ri)
    second = torch.where(first_is_left, ri, li)
    nxt = torch.full((8, total), INVALID, dtype=torch.int32, device=dev)
    nxt[:, :num_internal] = first.to(torch.int32)
    esc = torch.full((8, total), INVALID, dtype=torch.int32, device=dev)
    esc.scatter_(1, first, second.to(torch.int32))
    for _ in range(max_depth):
        esc.scatter_(1, second, esc[:, :num_internal].clone())
    return nxt, esc


def _group_leaf_aabbs(tri_verts, order_padded, leaf_size: int):
    """Per-leaf boxes over `leaf_size` morton-consecutive triangles; padding
    ids (-1) add empty boxes."""
    lo, hi = triangle_aabbs(tri_verts)
    safe = torch.clamp(order_padded, min=0).long()
    valid = (order_padded >= 0)[:, None]
    mlo = torch.where(valid, lo[safe], torch.inf)
    mhi = torch.where(valid, hi[safe], -torch.inf)
    n = order_padded.shape[0] // leaf_size
    return (mlo.reshape(n, leaf_size, 3).amin(dim=1),
            mhi.reshape(n, leaf_size, 3).amax(dim=1))


def _refit_sweeps(left_g, right_g, leaf_lo, leaf_hi, num_internal: int, max_depth: int):
    n = leaf_lo.shape[0]
    total = 2 * n - 1
    dev = leaf_lo.device
    amin = torch.full((total, 3), torch.inf, dtype=torch.float32, device=dev)
    amax = torch.full((total, 3), -torch.inf, dtype=torch.float32, device=dev)
    amin[num_internal:] = leaf_lo
    amax[num_internal:] = leaf_hi
    li, ri = left_g[:num_internal].long(), right_g[:num_internal].long()
    for _ in range(max_depth):
        new_min = torch.minimum(amin[li], amin[ri])
        new_max = torch.maximum(amax[li], amax[ri])
        amin[:num_internal] = new_min
        amax[:num_internal] = new_max
    return amin, amax


def build(tri_verts, max_depth: int = 64, leaf_size: int = 1) -> BVH:
    """The LBVH of (T, 3, 3) float32 world triangles (T >= 1), with its
    octant links, on their device.  leaf_size groups morton-consecutive
    triangles per leaf."""
    t_count = tri_verts.shape[0]
    if t_count < 1:
        raise ValueError("cannot build a BVH over zero triangles")
    dev = tri_verts.device
    i32 = dict(dtype=torch.int32, device=dev)
    tri_lo, tri_hi = triangle_aabbs(tri_verts)
    centroids = 0.5 * (tri_lo + tri_hi)
    tcodes = morton_codes(centroids, tri_lo.amin(dim=0), tri_hi.amax(dim=0))
    torder = torch.argsort(tcodes, stable=True)
    tcodes_sorted = tcodes[torder]
    torder = torder.to(torch.int32)

    n = (t_count + leaf_size - 1) // leaf_size  # leaves
    pad = n * leaf_size - t_count
    order = torch.cat([torder, torch.full((pad,), INVALID, **i32)]) if pad else torder
    # a leaf's key: the code of its first member
    codes = tcodes_sorted[::leaf_size][:n]
    leaf_lo, leaf_hi = _group_leaf_aabbs(tri_verts, order, leaf_size)

    if n == 1:  # the leaf is the root
        none = torch.full((1,), INVALID, **i32)
        links = torch.full((8, 1), INVALID, **i32)
        return BVH(aabb_min=leaf_lo, aabb_max=leaf_hi, left=none, right=none.clone(),
                   escape=none.clone(), leaf_tri=torch.zeros(1, **i32), order=order,
                   next8=links, esc8=links.clone(), leaf_size=leaf_size)

    num_internal = n - 1
    kbits = _ceil_log2(n) + 1
    idx = torch.arange(num_internal, dtype=torch.int64, device=dev)

    def delta(i, j):
        """Common-prefix length of keys i and j, -1 where j is out of range;
        equal codes tie-break on the index bits (Karras sec. 4)."""
        valid = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        x = codes[i] ^ codes[jc]
        d = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
        return torch.where(valid, d, -1)

    # direction and range length (binary search, kbits + 1 halvings)
    d = torch.sign(delta(idx, idx + 1) - delta(idx, idx - 1)).to(torch.int64)
    d = torch.where(d == 0, 1, d)
    delta_min = delta(idx, idx - d)
    ln = torch.zeros(num_internal, dtype=torch.int64, device=dev)
    for k in range(kbits, -1, -1):
        cand = ln + (1 << k)
        ln = torch.where(delta(idx, idx + cand * d) > delta_min, cand, ln)
    j = idx + ln * d
    delta_node = delta(idx, j)

    # split search: do { t = (t + 1) >> 1; ... } while (t > 1), kbits + 2 times
    s = torch.zeros(num_internal, dtype=torch.int64, device=dev)
    t = ln
    active = torch.ones(num_internal, dtype=torch.bool, device=dev)
    for _ in range(kbits + 2):
        t = (t + 1) >> 1
        cand = s + t
        ok = active & (delta(idx, idx + cand * d) > delta_node)
        s = torch.where(ok, cand, s)
        active = active & (t > 1)
    gamma = idx + s * d + torch.clamp(d, max=0)

    left = torch.where(torch.minimum(idx, j) == gamma, gamma + num_internal, gamma)
    right = torch.where(torch.maximum(idx, j) == gamma + 1, gamma + 1 + num_internal,
                        gamma + 1)
    total = 2 * n - 1
    fill = torch.full((n,), INVALID, **i32)
    left_g = torch.cat([left.to(torch.int32), fill])
    right_g = torch.cat([right.to(torch.int32), fill])
    leaf_tri = torch.cat([torch.full((num_internal,), INVALID, **i32),
                          torch.arange(n, **i32) * leaf_size])

    # escape links: a left child escapes to its sibling, a right child to
    # its parent's escape (one level a sweep)
    escape = torch.full((total,), INVALID, **i32)
    escape[left] = right.to(torch.int32)
    for _ in range(max_depth):
        escape[right] = escape[:num_internal].clone()

    aabb_min, aabb_max = _refit_sweeps(left_g, right_g, leaf_lo, leaf_hi, num_internal,
                                       max_depth)
    next8, esc8 = _octant_links(left_g, right_g, aabb_min, aabb_max, num_internal, max_depth)
    return BVH(aabb_min=aabb_min, aabb_max=aabb_max, left=left_g, right=right_g,
               escape=escape, leaf_tri=leaf_tri, order=order, next8=next8, esc8=esc8,
               leaf_size=leaf_size)


def with_octant_links(bvh: BVH, max_depth: int = 64) -> BVH:
    """`bvh` with the per-octant ordered threading of any binary tree (the
    native builders' too)."""
    n = bvh.num_leaves
    if n == 1:
        links = torch.full((8, 1), INVALID, dtype=torch.int32, device=bvh.left.device)
        return dataclasses.replace(bvh, next8=links, esc8=links.clone())
    next8, esc8 = _octant_links(bvh.left, bvh.right, bvh.aabb_min, bvh.aabb_max, n - 1,
                                max_depth)
    return dataclasses.replace(bvh, next8=next8, esc8=esc8)


def refit(bvh: BVH, tri_verts, max_depth: int = 64) -> BVH:
    """Every box of `bvh` for moved triangles, the topology kept (the
    reference's refit; UpdateBLAS in the original)."""
    n = bvh.num_leaves
    leaf_lo, leaf_hi = _group_leaf_aabbs(tri_verts, bvh.order, bvh.leaf_size)
    if n == 1:
        return dataclasses.replace(bvh, aabb_min=leaf_lo, aabb_max=leaf_hi)
    amin, amax = _refit_sweeps(bvh.left, bvh.right, leaf_lo, leaf_hi, n - 1, max_depth)
    return dataclasses.replace(bvh, aabb_min=amin, aabb_max=amax)


def tree_depth(bvh: BVH) -> int:
    """The longest root-to-leaf chain, in edges (host).  The build's sweeps
    settle links and boxes only up to max_depth of it."""
    left = np.asarray(bvh.left.cpu()).astype(np.int64)
    right = np.asarray(bvh.right.cpu()).astype(np.int64)
    frontier, depth = np.array([bvh.root]), 0
    while True:
        frontier = frontier[left[frontier] >= 0]  # the internal nodes of this level
        if frontier.size == 0:
            return depth
        depth += 1
        frontier = np.concatenate([left[frontier], right[frontier]])


def validate_host(bvh: BVH) -> None:
    """Host-side structural check (testing aid): every leaf reached exactly
    once through (left, escape) and through each octant's (next8, esc8)
    where the tree has them, and every box containing its children."""
    left, right = bvh.left.cpu().numpy(), bvh.right.cpu().numpy()
    leaf_tri = bvh.leaf_tri.cpu().tolist()
    order = bvh.order.cpu().tolist()
    amin, amax = bvh.aabb_min.cpu().numpy(), bvh.aabb_max.cpu().numpy()
    n, ls = bvh.num_leaves, bvh.leaf_size

    def walk(nxt, esc):
        seen, node, steps = [], bvh.root, 0
        while node != -1:
            steps += 1
            if steps > 4 * (2 * n - 1) + 4:
                raise AssertionError("threaded traversal does not terminate")
            start = leaf_tri[node]
            if start >= 0:
                seen += [t for t in order[start:start + ls] if t >= 0]
                node = esc[node]
            else:
                node = nxt[node]
        return sorted(seen)

    expected = sorted(t for t in order if t >= 0)
    if walk(left.tolist(), bvh.escape.cpu().tolist()) != expected:
        raise AssertionError("the (left, escape) threading misses or repeats leaves")
    if bvh.next8 is not None:
        next8, esc8 = bvh.next8.cpu().tolist(), bvh.esc8.cpu().tolist()
        for o in range(8):
            if walk(next8[o], esc8[o]) != expected:
                raise AssertionError(f"octant {o} ordered threading misses leaves")
    inner = np.arange(n - 1)
    for child in (left[inner], right[inner]):
        ok = ((amin[inner] <= amin[child] + 1e-5).all(axis=1)
              & (amax[inner] >= amax[child] - 1e-5).all(axis=1))
        if not ok.all():
            i = int(inner[~ok][0])
            raise AssertionError(f"node {i}'s box does not contain child {child[i]}")
