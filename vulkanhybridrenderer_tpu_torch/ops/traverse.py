"""BVH8 ray traversal (port of ``ops/traverse.py``): kernel K2.

``trace(bvh8, origin, direction, tmin, tmax, anyhit)`` walks the BVH8 table of
ops/bvh8.py once per ray with the semantics of the reference's per-ray walk
(``_trace8``): near-first slot ^ octant child order, 8-wide slab tests with
empty slots masked, 8-wide Moller-Trumbore leaves without culling, any-hit
stopping at the first accepted hit, at most ``min(4 * rows + 4, 32768)``
steps per ray.  With ``alpha_tables`` (the scene's ShadeTables) the alpha
any-hit filter (``make_alpha_hit_filter``) rejects leaf candidates whose
base-color alpha at the hit is below the material's cutoff.  On CUDA tensors
it launches the hand-written kernel csrc/bvh8_trace.cu, which walks each ray
with a group of four lanes, two slots of the row each, so that a step reads
its row as whole 32-byte sectors; on CPU tensors it runs ``trace_plain``, a
lockstep port of ``_trace8`` that drops finished rays between steps and can
count the rows and slots each ray visits.  The reference's TPU schedules (strips,
packets, compaction, ray sorting, unrolling) have no counterpart.

Given a binary ``BVH`` (ops/bvh.py) and the triangles, or the tables
``pack_flat`` packs from them once per tree, ``trace`` runs the reference's
other walk, ``_trace_flat``: kernel K4 (``trace_flat``), the stackless
skip-pointer walk over the threaded tree, a thread a ray on CUDA tensors
(csrc/bvh_flat_trace.cu), ``trace_flat_plain`` on CPU tensors.  It is the
independent oracle the BVH8 walk is checked against, not a render path.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Any

import torch

from vulkanhybridrenderer_tpu_torch.ops import shadetab
from vulkanhybridrenderer_tpu_torch.ops.bvh import BVH
from vulkanhybridrenderer_tpu_torch.ops.bvh8 import BVH8


@dataclasses.dataclass(frozen=True)
class HitRecord:
    t: Any  # (R,) hit distance (== tmax when missed)
    tri: Any  # (R,) triangle index, -1 = miss
    u: Any  # (R,) barycentric of vertex 1
    v: Any  # (R,) barycentric of vertex 2

    @property
    def hit(self):
        return self.tri >= 0


@dataclasses.dataclass(frozen=True)
class Visits:
    """What each ray's walk did, counted by ``trace_plain(visits=True)``: the
    work K2 does for the same rays, which prices a launch."""
    internal: Any  # (R,) int64 internal rows visited
    leaf: Any  # (R,) int64 leaf rows visited
    boxes: Any  # (R,) int64 non-empty slots (lo.x <= hi.x) of those internal rows
    triangles: Any  # (R,) int64 non-empty slots (tri >= 0) of those leaf rows
    filtered: Any  # (R,) int64 alpha filter evaluations (geometric candidates)


def default_max_steps(bvh: BVH8) -> int:
    return min(4 * bvh.num_rows + 4, 32768)


def _octants(d):
    return (
        ((d[:, 0] < 0).to(torch.int32) << 2)
        | ((d[:, 1] < 0).to(torch.int32) << 1)
        | (d[:, 2] < 0).to(torch.int32)
    )


def _first_slot(mask, oct_):
    """First set slot of `mask` in slot ^ octant order, and the mask without
    it (mask == 0 gives an arbitrary slot and 0)."""
    slots8 = torch.arange(8, dtype=torch.int32, device=mask.device)
    bits = (mask[:, None] >> (slots8[None, :] ^ oct_[:, None])) & 1
    slot = torch.argmax(bits, dim=-1).to(torch.int32) ^ oct_
    return slot, mask & ~(1 << slot)


def moller_trumbore(v0, v1, v2, o, d, stage: bool = False):
    """Moller-Trumbore without culling (the reference's moller_trumbore,
    traverse.py:679), each product rounded, in the operation order of K2's
    and K3's kernels.  v0, v1, v2 (the triangle), o and d (the ray) are
    (x, y, z) triples of broadcastable tensors; returns (t, u, v, ok), ok
    the geometric hit before any t test.  With `stage` also the int64 test
    at which an early-returning walk (K3's) rejects the pair: 0 at det, 1 at
    u, 2 at v, 3 past them all (a full test)."""
    (v0x, v0y, v0z), (ox, oy, oz), (dx, dy, dz) = v0, o, d
    e1x, e1y, e1z = v1[0] - v0x, v1[1] - v0y, v1[2] - v0z
    e2x, e2y, e2z = v2[0] - v0x, v2[1] - v0y, v2[2] - v0z
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    okd = torch.abs(det) > 1e-9
    invdet = 1.0 / torch.where(okd, det, torch.ones_like(det))
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * invdet
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * invdet
    t = (e2x * qx + e2y * qy + e2z * qz) * invdet
    ok = okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    if not stage:
        return t, u, v, ok
    ok_u = (u >= 0.0) & (u <= 1.0)
    at = torch.where(~okd, 0, torch.where(~ok_u, 1, torch.where(ok, 3, 2)))
    return t, u, v, ok, at


def make_alpha_hit_filter(tables: shadetab.ShadeTables):
    """The non-opaque any-hit alpha test (shadow_anyhit.rahit:10-26):
    hit_filter(tri, u, v) -> accept mask, rejecting a hit whose base-color
    alpha at the hit uv is below its material's cutoff.  One tri_static row
    and one atlas quad row per candidate."""

    def hit_filter(tri, u, v):
        pm = shadetab.fetch_tri_static(tables, tri)
        uv = shadetab.interpolate3(pm["uv0"], torch.stack([1.0 - u - v, u, v], dim=-1))
        alpha = shadetab.sample_atlas4(
            tables, pm["base_tex"], pm["base_scale"], pm["base_offset"], uv
        )[..., 3]
        reject = ((pm["alpha_mask"] == 1.0) & (pm["base_tex"] >= 0)
                  & (alpha < pm["alpha_cutoff"]))
        return ~reject

    return hit_filter


def trace_plain(rows, depth: int, origin, direction, tmin, tmax,
                anyhit: bool, max_steps: int, hit_filter=None, visits: bool = False):
    """Plain PyTorch K2: ``_trace8`` stepped in lockstep over the live rays.
    rows (N, 128) f32; origin / direction (R, 3); tmin / tmax (R,).
    hit_filter(tri, u, v) -> accept mask is ANDed into the leaf candidates
    before the nearest is picked (``_trace8:264-270``); it is asked only
    about candidates that pass the geometric test.  Returns a HitRecord, or
    with ``visits`` (HitRecord, Visits): each ray's internal and leaf rows,
    their non-empty slots and its filter evaluations (a ray with tmax < tmin
    visits none); without it nothing is counted."""
    dev = origin.device
    r = origin.shape[0]
    t_out = tmax.clone()
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros(r, dtype=torch.float32, device=dev)
    v_out = torch.zeros(r, dtype=torch.float32, device=dev)

    ids = torch.nonzero(~(tmax < tmin)).squeeze(1)  # tmax < tmin: miss at once
    d = direction[ids]
    o = origin[ids]
    tn_ = tmin[ids]
    safe_d = torch.where(
        torch.abs(d) < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d
    )
    inv = 1.0 / safe_d
    oct_ = _octants(d)
    n = ids.shape[0]
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, depth), dtype=torch.int32, device=dev)
    stack_b = torch.zeros((n, depth), dtype=torch.int32, device=dev)
    tb = t_out[ids]
    trb = tri_out[ids]
    ub = u_out[ids]
    vb = v_out[ids]
    slots8 = torch.arange(8, dtype=torch.int32, device=dev)
    # internal rows, leaf rows, boxes, triangles, filter evaluations
    counts_out = torch.zeros((r, 5), dtype=torch.int64, device=dev)
    counts = torch.zeros((n, 5), dtype=torch.int64, device=dev)

    def retire(keep):
        t_out[ids[~keep]] = tb[~keep]
        tri_out[ids[~keep]] = trb[~keep]
        u_out[ids[~keep]] = ub[~keep]
        v_out[ids[~keep]] = vb[~keep]
        if visits:
            counts_out[ids[~keep]] = counts[~keep]

    steps = 0
    while n > 0 and steps < max_steps:
        row = rows[node.long()]  # (n, 128)
        is_leaf = row[:, 127] > 0.5
        ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
        ix, iy, iz = inv[:, 0:1], inv[:, 1:2], inv[:, 2:3]

        # internal: 8-wide slab test
        t0x = (row[:, 0:8] - ox) * ix
        t1x = (row[:, 24:32] - ox) * ix
        t0y = (row[:, 8:16] - oy) * iy
        t1y = (row[:, 32:40] - oy) * iy
        t0z = (row[:, 16:24] - oz) * iz
        t1z = (row[:, 40:48] - oz) * iz
        tnear = torch.maximum(
            torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
            torch.minimum(t0z, t1z),
        )
        tfar = torch.minimum(
            torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
            torch.maximum(t0z, t1z),
        )
        hit8 = torch.maximum(tnear, tn_[:, None]) <= torch.minimum(tfar, tb[:, None])
        hit8 &= row[:, 0:8] <= row[:, 24:32]
        mask = torch.sum(torch.where(hit8, 1 << slots8, 0), dim=-1, dtype=torch.int32)
        base = row[:, 48].to(torch.int32)
        offmap = row[:, 49].to(torch.int32)

        # leaf: 8-wide Moller-Trumbore
        g = lambda k: row[:, 8 * k:8 * (k + 1)]  # noqa: E731
        tri8 = row[:, 72:80].to(torch.int32)
        t8, u8, v8, ok8 = moller_trumbore(
            (g(0), g(1), g(2)), (g(3), g(4), g(5)), (g(6), g(7), g(8)), (ox, oy, oz),
            (d[:, 0:1], d[:, 1:2], d[:, 2:3]))
        ok8 &= ((tri8 >= 0) & (t8 >= tn_[:, None]) & (t8 < tb[:, None])
                & is_leaf[:, None])
        if visits:
            counts[:, 0] += ~is_leaf
            counts[:, 1] += is_leaf
            counts[:, 2] += torch.where(is_leaf, 0, (row[:, 0:8] <= row[:, 24:32]).sum(dim=-1))
            counts[:, 3] += torch.where(is_leaf, (tri8 >= 0).sum(dim=-1), 0)
        if hit_filter is not None:
            ri, si = torch.nonzero(ok8, as_tuple=True)
            if visits:
                counts[:, 4] += ok8.sum(dim=-1)
            rej = ~hit_filter(tri8[ri, si], u8[ri, si], v8[ri, si])
            ok8[ri[rej], si[rej]] = False
        t8m = torch.where(ok8, t8, torch.inf)
        sbest = torch.argmin(t8m, dim=-1)
        have = torch.any(ok8, dim=-1)
        pick = lambda a: a.gather(1, sbest[:, None]).squeeze(1)  # noqa: E731
        tb = torch.where(have, pick(t8m), tb)
        trb = torch.where(have, pick(tri8), trb)
        ub = torch.where(have, pick(u8), ub)
        vb = torch.where(have, pick(v8), vb)

        # next node: descend / pop
        slot, remaining = _first_slot(mask, oct_)
        descend = ~is_leaf & (mask != 0)
        child = base + ((offmap >> (3 * slot)) & 7)
        push = descend & (remaining != 0)
        rows_idx = torch.nonzero(push).squeeze(1)
        stack[rows_idx, sp[rows_idx]] = (base * 256 + remaining)[rows_idx]
        stack_b[rows_idx, sp[rows_idx]] = offmap[rows_idx]
        sp = sp + push.to(torch.int64)

        need_pop = is_leaf | (mask == 0)
        if anyhit:
            need_pop &= ~have  # terminate on the first accepted hit
        can_pop = need_pop & (sp > 0)
        top_i = torch.clamp(sp - 1, min=0)[:, None]
        top = stack.gather(1, top_i).squeeze(1)
        top_off = stack_b.gather(1, top_i).squeeze(1)
        pslot, prem = _first_slot(top & 255, oct_)
        pchild = (top >> 8) + ((top_off >> (3 * pslot)) & 7)
        new_top = (top & ~255) | prem
        stack.scatter_(1, top_i, torch.where(can_pop, new_top, top)[:, None])
        sp = torch.where(can_pop & (prem == 0), sp - 1, sp)
        node = torch.where(descend, child, torch.where(can_pop, pchild, -1))
        steps += 1

        keep = node >= 0
        if not bool(keep.all()):
            retire(keep)
            ids, o, d, inv, oct_, tn_ = ids[keep], o[keep], d[keep], inv[keep], oct_[keep], tn_[keep]
            node, sp, stack, stack_b = node[keep], sp[keep], stack[keep], stack_b[keep]
            if visits:
                counts = counts[keep]
            tb, trb, ub, vb = tb[keep], trb[keep], ub[keep], vb[keep]
            n = ids.shape[0]
    retire(torch.zeros(n, dtype=torch.bool, device=dev))
    rec = HitRecord(t=t_out, tri=tri_out, u=u_out, v=v_out)
    if not visits:
        return rec
    return rec, Visits(*counts_out.unbind(1))


@functools.cache
def load_kernel():
    """Build K2 (on first use) and load it; returns (launch function, the
    kernel's largest stack depth)."""
    from vulkanhybridrenderer_tpu_torch.utils.build import load_cuda_library

    lib = load_cuda_library("bvh8_trace.cu")
    fn = lib.bvh8_trace_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
    )
    lib.bvh8_trace_max_depth.restype = ctypes.c_int
    lib.bvh8_trace_max_depth.argtypes = []
    return fn, lib.bvh8_trace_max_depth()


def _ray_bounds(origin, tmin, tmax):
    """tmin / tmax (scalars or (R,)) as contiguous float32 (R,) tensors on
    the rays' device."""
    dev, r = origin.device, origin.shape[0]
    return (torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(r).contiguous(),
            torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(r).contiguous())


def _check_tensors(fn: str, checks) -> None:
    """Raise unless every (name, tensor, shape, dtype) is contiguous, of its
    dtype and shape, on the first tensor's device."""
    dev = checks[0][1].device
    for name, t, shape, dtype in checks:
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} {shape} tensor on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _table_checks(alpha_tables):
    if alpha_tables is None:
        return []
    ts, aq = alpha_tables.tri_static, alpha_tables.atlas_q
    return [("tri_static", ts, (ts.shape[0], shadetab._N_STATIC), torch.float32),
            ("atlas_q", aq, (aq.shape[0], 16), torch.float32)]


def _table_args(alpha_tables):
    if alpha_tables is None:
        return (None, None, 0, 0)
    return (alpha_tables.tri_static.data_ptr(), alpha_tables.atlas_q.data_ptr(),
            alpha_tables.atlas_q.shape[0], alpha_tables.atlas_w)


def trace(bvh: BVH8 | BVH | FlatTables, origin, direction, tmin, tmax, anyhit: bool = False,
          max_steps: int | None = None,
          alpha_tables: shadetab.ShadeTables | None = None,
          tri_verts=None) -> HitRecord:
    """Trace rays through `bvh`.  origin / direction: (R, 3) float32;
    tmin / tmax: scalars or (R,).  alpha_tables: the scene's shade tables,
    to apply the alpha any-hit filter (None: every geometric hit counts).
    A BVH8 goes to K2, where rays with tmax < tmin miss at once; a binary
    BVH goes to the threaded walk, K4 (``trace_flat``), which needs the
    (T, 3, 3) triangles `tri_verts` (ignored otherwise) and packs them with
    the tree on every call; pack_flat's tables, packed once per tree, go to
    K4 as they are."""
    if isinstance(bvh, BVH):
        if tri_verts is None:
            raise ValueError("trace: a binary BVH needs tri_verts, the (T, 3, 3) triangles")
        bvh = pack_flat(bvh, tri_verts)
    if isinstance(bvh, FlatTables):
        return trace_flat(bvh, origin, direction, tmin, tmax, anyhit=anyhit,
                          max_steps=max_steps, alpha_tables=alpha_tables)
    dev = origin.device
    r = origin.shape[0]
    tmin_a, tmax_a = _ray_bounds(origin, tmin, tmax)
    if max_steps is None:
        max_steps = default_max_steps(bvh)
    if bvh.leaf_max != 8:
        raise ValueError("trace: the port's BVH8 rows hold 8-triangle leaves")
    if dev.type == "cpu":
        return trace_plain(
            bvh.rows, bvh.depth, origin, direction, tmin_a, tmax_a, anyhit, max_steps,
            None if alpha_tables is None else make_alpha_hit_filter(alpha_tables))
    if dev.type != "cuda":
        raise ValueError(f"trace: unsupported device {dev}")
    f32 = torch.float32
    _check_tensors("trace", [("origin", origin, (r, 3), f32),
                             ("rows", bvh.rows, (bvh.num_rows, 128), f32),
                             ("direction", direction, (r, 3), f32)]
                   + _table_checks(alpha_tables))
    fn, max_depth = load_kernel()
    if bvh.depth > max_depth:
        raise ValueError(
            f"trace: BVH depth {bvh.depth} exceeds the kernel's stack of {max_depth}"
        )
    out_t = torch.empty(r, dtype=torch.float32, device=dev)
    out_tri = torch.empty(r, dtype=torch.int32, device=dev)
    out_u = torch.empty(r, dtype=torch.float32, device=dev)
    out_v = torch.empty(r, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            bvh.rows.data_ptr(), origin.data_ptr(), direction.data_ptr(),
            tmin_a.data_ptr(), tmax_a.data_ptr(), r, max_steps, int(anyhit),
            max(bvh.depth, 1), *_table_args(alpha_tables),
            out_t.data_ptr(), out_tri.data_ptr(), out_u.data_ptr(),
            out_v.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"bvh8_trace kernel launch failed: CUDA error {err}")
    mode = "any-hit" if anyhit else "closest-hit"
    trace.launches[mode if alpha_tables is None else f"filtered {mode}"] += 1
    return HitRecord(t=out_t, tri=out_tri, u=out_u, v=out_v)


#: launches of the kernel by mode: "any-hit", "closest-hit", "filtered
#: any-hit", "filtered closest-hit"
trace.launches = collections.Counter()


# ---- K4: the threaded walk of a binary BVH (the reference's _trace_flat) ----


def pack_nodes(bvh: BVH):
    """(2L-1, 8) float32 node rows [lo.xyz, hi.xyz, next, escape]: next is
    an internal node's left child, -(start + 2) for a leaf whose triangles
    start at order[start]; escape -1 ends the walk.  Ids stay exact as
    floats below 2^24."""
    is_leaf = bvh.leaf_tri >= 0
    nxt = torch.where(is_leaf, -(bvh.leaf_tri + 2), bvh.left).to(torch.float32)
    return torch.cat([bvh.aabb_min, bvh.aabb_max, nxt[:, None],
                      bvh.escape.to(torch.float32)[:, None]], dim=1).contiguous()


def pack_tris(tri_verts):
    """(T, 3, 3) -> (T, 9) float32 rows [v0.xyz v1.xyz v2.xyz]."""
    return tri_verts.reshape(tri_verts.shape[0], 9).to(torch.float32).contiguous()


@dataclasses.dataclass(frozen=True)
class FlatTables:
    """A binary BVH packed for K4 once per tree (``pack_flat``), on one
    device.  A link is an internal node's row (>= 0), a leaf as -(start + 2)
    (its first slot), or -1 (the walk's end).  nodes: the internal nodes'
    rows [lo.xyz, hi.xyz, next, escape], next the left child's link and
    escape the link after the node's subtree.  leaf_tris: slot k holds
    triangle order[k] as three 16-byte rows [v0.xyz, id], [v1.xyz, escape],
    [v2.xyz, 0]: the id (-1 and zero vertices in a padded slot) and the link
    after its leaf.  Links and ids are stored as their int32 bits
    (``table_ints``).  So the walk reads an internal node's row and a
    leaf's slots, never a leaf's row or `order`."""
    nodes: Any  # (L - 1, 8) float32
    leaf_tris: Any  # (L * leaf_size, 12) float32
    leaf_size: int
    root: int  # the root's link

    @property
    def num_nodes(self) -> int:
        """The tree's 2L - 1 nodes, leaves included."""
        return 2 * (self.leaf_tris.shape[0] // self.leaf_size) - 1


def flat_tables(nodes, tris9, order, leaf_size: int, root: int) -> FlatTables:
    """FlatTables from pack_nodes' rows of a tree, pack_tris' triangles,
    its order, leaf_size and root.  The rows hold their links as floats,
    exact up to 2^24, so a tree whose ids go past that raises: pack_flat
    packs any tree from its integer links."""
    if max(nodes.shape[0], order.shape[0] + 2) > 1 << 24:
        raise ValueError(f"flat_tables: {nodes.shape[0]} nodes and {order.shape[0]} slots; "
                         f"ids are exact as floats up to 2^24 (pack_flat takes any tree)")
    host = nodes.cpu()
    return _pack_links(host[:, :6], host[:, 6].to(torch.int64), host[:, 7].to(torch.int64),
                       tris9, order, leaf_size, root)


def pack_flat(bvh: BVH, tri_verts) -> FlatTables:
    """Pack `bvh` over the (T, 3, 3) triangles for trace / trace_flat,
    once per tree, from its integer links: no id goes through a float."""
    is_leaf = bvh.leaf_tri >= 0
    nxt = torch.where(is_leaf, -(bvh.leaf_tri.to(torch.int64) + 2), bvh.left.to(torch.int64))
    return _pack_links(torch.cat([bvh.aabb_min, bvh.aabb_max], dim=1).to(torch.float32),
                       nxt, bvh.escape.to(torch.int64), pack_tris(tri_verts), bvh.order,
                       bvh.leaf_size, bvh.root)


def _pack_links(boxes, nxt, esc, tris9, order, leaf_size: int, root: int) -> FlatTables:
    """FlatTables from a tree's (2L-1, 6) boxes [lo.xyz, hi.xyz] and int64
    node links (pack_nodes' next and escape), its (T, 9) triangles, order,
    leaf_size and root.  The internal nodes keep their order of ids.  Reads
    the links on the host once."""
    dev = tris9.device
    boxes, nxt, esc = boxes.cpu(), nxt.cpu(), esc.cpu()
    is_leaf = nxt <= -2
    inner = torch.nonzero(~is_leaf).squeeze(1)
    new_id = torch.full((nxt.shape[0],), -1, dtype=torch.int64)
    new_id[inner] = torch.arange(inner.shape[0])

    def link(ids):  # node ids (-1: the end) -> links
        i = ids.clamp(min=0)
        return torch.where(ids < 0, -1, torch.where(is_leaf[i], nxt[i], new_id[i]))

    rows = torch.empty((inner.shape[0], 8), dtype=torch.float32)
    rows[:, :6] = boxes[inner]
    rows[:, 6] = link(nxt[inner]).to(torch.int32).view(torch.float32)
    rows[:, 7] = link(esc[inner]).to(torch.int32).view(torch.float32)
    # each slot carries its leaf's escape link
    leaf_esc = torch.full((order.shape[0] // leaf_size,), -1, dtype=torch.int64)
    leaves = torch.nonzero(is_leaf).squeeze(1)
    leaf_esc[(-nxt[leaves] - 2) // leaf_size] = link(esc[leaves])
    ids = order.to(torch.int32)
    v = torch.where((ids >= 0)[:, None], tris9[ids.long().clamp(min=0)], 0.0)
    slots = torch.zeros((ids.shape[0], 3, 4), dtype=torch.float32, device=tris9.device)
    slots[:, :, :3] = v.reshape(-1, 3, 3)
    slots[:, 0, 3] = ids.view(torch.float32)
    slots[:, 1, 3] = leaf_esc.repeat_interleave(leaf_size).to(
        slots.device, torch.int32).view(torch.float32)
    return FlatTables(rows.to(dev), slots.reshape(-1, 12).to(dev), leaf_size,
                      int(link(torch.tensor([root]))[0]))


def table_ints(table, col: int):
    """Column `col` of a FlatTables table read as the int32 its bits hold:
    nodes' 6 and 7 (next and escape links), leaf_tris' 3 (the triangle id)
    and 7 (the leaf's escape link)."""
    return table[:, col].contiguous().view(torch.int32)


def _flat_tables(fn: str, nodes, args):
    """(FlatTables, the other arguments) of a trace_flat / trace_flat_plain
    call that passes pack_flat's tables first, or the packed (nodes, tris9,
    order, leaf_size, root) they are made from (packed anew)."""
    if isinstance(nodes, FlatTables):
        return nodes, args
    if len(args) < 4:
        raise TypeError(f"{fn}: pass FlatTables, or nodes, tris9, order, leaf_size and root")
    tris9, order, leaf_size, root, *rest = args
    return flat_tables(nodes, tris9, order, leaf_size, root), rest


def default_flat_max_steps(tree) -> int:
    """The reference's cap for the threaded walk (traverse.py:841), from
    pack_nodes' rows or a FlatTables."""
    n = tree.num_nodes if isinstance(tree, FlatTables) else tree.shape[0]
    return min(4 * n + 4, 32768)


@dataclasses.dataclass(frozen=True)
class FlatVisits:
    """What each ray's threaded walk did, counted by
    ``trace_flat_plain(visits=True)``: the work K4 does for the same rays,
    which prices a launch."""
    internal: Any  # (R,) int64 internal nodes visited (a slab test each)
    leaf: Any  # (R,) int64 leaves visited
    triangles: Any  # (R,) int64 triangles tested (ids >= 0 of those leaves)
    filtered: Any  # (R,) int64 alpha filter evaluations (geometric candidates)


def trace_flat_plain(nodes, *args, **kwargs):
    """Plain PyTorch K4: ``_trace_flat`` stepped in lockstep over the live
    rays.  trace_flat_plain(tables, origin, direction, tmin, tmax, anyhit,
    max_steps, hit_filter=None, visits=False) with pack_flat's tables, or
    with nodes, tris9, order, leaf_size, root (pack_nodes, pack_tris, the
    tree's order) in the tables' place; origin / direction (R, 3), tmin /
    tmax (R,).  Every ray starts at the root; an internal node is entered
    when its slab interval meets [tmin, t_best], a leaf's triangles are
    tested in order (each against the t_best the one before left) and its
    box is not; any-hit ends after the whole leaf.  hit_filter(tri, u, v)
    -> accept mask is asked about geometric candidates only.  Returns a
    HitRecord, or with ``visits`` (HitRecord, FlatVisits)."""
    tables, rest = _flat_tables("trace_flat_plain", nodes, args)
    return _walk_flat_plain(tables, *rest, **kwargs)


def _walk_flat_plain(tables: FlatTables, origin, direction, tmin, tmax, anyhit: bool,
                     max_steps: int, hit_filter=None, visits: bool = False):
    nodes, leaf_tris, leaf_size = tables.nodes, tables.leaf_tris, tables.leaf_size
    ids_all = table_ints(leaf_tris, 3).long()
    leaf_esc = table_ints(leaf_tris, 7).long()
    links = torch.cat([torch.stack([table_ints(nodes, 6), table_ints(nodes, 7)], dim=1),
                       nodes.new_zeros((1, 2), dtype=torch.int32)]).long()
    # a row for links that are no internal node (a tree of one leaf has none)
    rows_all = torch.cat([nodes, nodes.new_zeros((1, 8))])
    dev = origin.device
    r = origin.shape[0]
    t_out = tmax.clone()
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros(r, dtype=torch.float32, device=dev)
    v_out = torch.zeros(r, dtype=torch.float32, device=dev)
    counts_out = torch.zeros((r, 4), dtype=torch.int64, device=dev)

    ids = torch.arange(r, device=dev)
    o, d, tn_ = origin, direction, tmin
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
    node = torch.full((r,), tables.root, dtype=torch.int64, device=dev)  # links
    tb, trb, ub, vb = t_out.clone(), tri_out.clone(), u_out.clone(), v_out.clone()
    counts = torch.zeros((r, 4), dtype=torch.int64, device=dev)
    n, steps = r, 0
    while n > 0 and steps < max_steps:
        is_leaf = node <= -2
        row = rows_all[torch.where(is_leaf, nodes.shape[0], node)]
        t0 = (row[:, 0:3] - o) * inv
        t1 = (row[:, 3:6] - o) * inv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tnear = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        tfar = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        box_hit = torch.maximum(tnear, tn_) <= torch.minimum(tfar, tb)
        link = links[torch.where(is_leaf, nodes.shape[0], node)]
        nxt = torch.where(box_hit, link[:, 0], link[:, 1])

        # the leaves' triangles, in order, each against the t_best before it
        li = torch.nonzero(is_leaf).squeeze(1)
        any_ok = torch.zeros(n, dtype=torch.bool, device=dev)
        if visits:
            counts[:, 0] += ~is_leaf
            counts[:, 1] += is_leaf
        if li.numel():
            start = -node[li] - 2
            nxt[li] = leaf_esc[start]
            ol, dl = o[li], d[li]
            for j in range(leaf_size):
                tri = ids_all[start + j]
                tv = leaf_tris[start + j]  # [v0.xyz id v1.xyz escape v2.xyz 0]
                t, u, v, ok = moller_trumbore(
                    (tv[:, 0], tv[:, 1], tv[:, 2]), (tv[:, 4], tv[:, 5], tv[:, 6]),
                    (tv[:, 8], tv[:, 9], tv[:, 10]), (ol[:, 0], ol[:, 1], ol[:, 2]),
                    (dl[:, 0], dl[:, 1], dl[:, 2]))
                ok &= (tri >= 0) & (t >= tn_[li]) & (t < tb[li])
                if visits:
                    counts[li, 2] += tri >= 0
                if hit_filter is not None:
                    cand = torch.nonzero(ok).squeeze(1)
                    if visits:
                        counts[li, 3] += ok
                    ok[cand[~hit_filter(tri[cand].to(torch.int32), u[cand], v[cand])]] = False
                hit = li[ok]
                tb[hit], trb[hit] = t[ok], tri[ok].to(torch.int32)
                ub[hit], vb[hit] = u[ok], v[ok]
                any_ok[hit] = True

        node = torch.where(any_ok, -1, nxt) if anyhit else nxt
        steps += 1

        keep = node != -1
        if not bool(keep.all()):
            gone = ids[~keep]
            t_out[gone], tri_out[gone] = tb[~keep], trb[~keep]
            u_out[gone], v_out[gone] = ub[~keep], vb[~keep]
            counts_out[gone] = counts[~keep]
            ids, o, d, inv, tn_, node = ids[keep], o[keep], d[keep], inv[keep], tn_[keep], node[keep]
            tb, trb, ub, vb, counts = tb[keep], trb[keep], ub[keep], vb[keep], counts[keep]
            n = ids.shape[0]
    # rays still walking at the step cap keep what they found
    t_out[ids], tri_out[ids], u_out[ids], v_out[ids] = tb, trb, ub, vb
    counts_out[ids] = counts
    rec = HitRecord(t=t_out, tri=tri_out, u=u_out, v=v_out)
    if not visits:
        return rec
    return rec, FlatVisits(*counts_out.unbind(1))


@functools.cache
def load_flat_kernel():
    """Build K4 (on first use) and load it; returns its launch function."""
    from vulkanhybridrenderer_tpu_torch.utils.build import load_cuda_library

    return bind_flat_launch(load_cuda_library("bvh_flat_trace.cu"))


def bind_flat_launch(lib):
    """K4's launch function in the loaded library `lib`, its types set."""
    fn = lib.bvh_flat_trace_launch
    fn.restype = ctypes.c_int
    ptr, num, flt = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr] * 2 + [num] * 2 + [ptr] * 2 + [ptr, flt, ptr, flt] + [num] * 3
                   + [ptr] * 2 + [num] * 2 + [ptr] * 5 + [num, ptr])
    return fn


def flat_launch_args(tables: FlatTables, origin, direction, tmin, tmax, anyhit: bool,
                     max_steps: int, alpha_tables, out: HitRecord, stats=None):
    """The arguments of one K4 launch (load_flat_kernel()(*args)) writing
    `out`'s tensors, on tensors trace_flat has checked.  A Python float
    tmin / tmax goes by value, an (R,) float32 tensor by pointer.  `stats`:
    None, or a (2,) int64 CUDA tensor the kernel adds its busy lane-steps
    and all its lane-steps to."""
    from vulkanhybridrenderer_tpu_torch.utils.build import current_stream

    def scalar(t):
        return (t.data_ptr(), 0.0) if torch.is_tensor(t) else (None, float(t))

    index = origin.get_device()
    return (tables.nodes.data_ptr(), tables.leaf_tris.data_ptr(), tables.leaf_size,
            tables.root, origin.data_ptr(), direction.data_ptr(), *scalar(tmin), *scalar(tmax),
            origin.shape[0], max_steps, int(anyhit), *_table_args(alpha_tables),
            out.t.data_ptr(), out.tri.data_ptr(), out.u.data_ptr(), out.v.data_ptr(),
            None if stats is None else stats.data_ptr(), index, current_stream(index))


def trace_flat(nodes, *args, **kwargs) -> HitRecord:
    """K4: the threaded walk of a packed binary BVH.  trace_flat(tables,
    origin, direction, tmin, tmax, anyhit=False, max_steps=None,
    alpha_tables=None) with pack_flat's tables (packed once per tree), or
    with nodes, tris9, order, leaf_size, root (pack_nodes, pack_tris, the
    tree's order; packed anew on every call) in the tables' place.
    origin / direction: (R, 3) float32; tmin / tmax: scalars or (R,);
    max_steps defaults to the reference's min(4 * nodes + 4, 32768).  CPU
    tensors run trace_flat_plain; CUDA tensors launch csrc/bvh_flat_trace.cu;
    any other device raises."""
    origin = args[0] if isinstance(nodes, FlatTables) else args[4] if len(args) > 4 else None
    if origin is not None and origin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"trace_flat: unsupported device {origin.device}")  # before packing
    tables, rest = _flat_tables("trace_flat", nodes, args)
    return _trace_tables(tables, *rest, **kwargs)


def _trace_tables(tables: FlatTables, origin, direction, tmin, tmax, anyhit: bool = False,
                  max_steps: int | None = None,
                  alpha_tables: shadetab.ShadeTables | None = None) -> HitRecord:
    dev = origin.device
    r = origin.shape[0]
    nodes, leaf_tris = tables.nodes, tables.leaf_tris
    if max_steps is None:
        max_steps = default_flat_max_steps(tables)
    if dev.type == "cpu":
        return _walk_flat_plain(
            tables, origin, direction, *_ray_bounds(origin, tmin, tmax), anyhit, max_steps,
            None if alpha_tables is None else make_alpha_hit_filter(alpha_tables))
    if dev.type != "cuda":
        raise ValueError(f"trace_flat: unsupported device {dev}")
    slots = leaf_tris.shape[0]
    f32 = torch.float32
    _check_tensors("trace_flat", [
        ("origin", origin, (r, 3), f32), ("direction", direction, (r, 3), f32),
        ("nodes", nodes, (slots // tables.leaf_size - 1, 8), f32),
        ("leaf_tris", leaf_tris, (slots, 12), f32)]
        + _table_checks(alpha_tables))
    out = HitRecord(t=torch.empty(r, dtype=f32, device=dev),
                    tri=torch.empty(r, dtype=torch.int32, device=dev),
                    u=torch.empty(r, dtype=f32, device=dev), v=torch.empty(r, dtype=f32, device=dev))
    # a number goes to the kernel by value, a tensor as an (R,) float32 one
    tmin, tmax = (torch.as_tensor(t, dtype=f32, device=dev).expand(r).contiguous()
                  if torch.is_tensor(t) else float(t) for t in (tmin, tmax))
    err = load_flat_kernel()(*flat_launch_args(tables, origin, direction, tmin, tmax, anyhit,
                                               max_steps, alpha_tables, out))
    if err != 0:
        raise RuntimeError(f"bvh_flat_trace kernel launch failed: CUDA error {err}")
    mode = "any-hit" if anyhit else "closest-hit"
    trace_flat.launches[mode if alpha_tables is None else f"filtered {mode}"] += 1
    return out


#: launches of K4 by mode, as trace.launches
trace_flat.launches = collections.Counter()
