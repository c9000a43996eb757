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
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Any

import torch

from vulkanhybridrenderer_tpu_torch.ops import shadetab
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


def moller_trumbore(v0, v1, v2, o, d):
    """Moller-Trumbore without culling (the reference's moller_trumbore,
    traverse.py:679), each product rounded, in the operation order of K2's
    and K3's kernels.  v0, v1, v2 (the triangle), o and d (the ray) are
    (x, y, z) triples of broadcastable tensors; returns (t, u, v, ok), ok
    the geometric hit before any t test."""
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
    return t, u, v, okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)


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


def trace(bvh: BVH8, origin, direction, tmin, tmax, anyhit: bool = False,
          max_steps: int | None = None,
          alpha_tables: shadetab.ShadeTables | None = None) -> HitRecord:
    """Trace rays through `bvh`.  origin / direction: (R, 3) float32;
    tmin / tmax: scalars or (R,).  Rays with tmax < tmin miss at once.
    alpha_tables: the scene's shade tables, to apply the alpha any-hit
    filter (None: every geometric hit counts)."""
    dev = origin.device
    r = origin.shape[0]
    tmin_a = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(r).contiguous()
    tmax_a = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(r).contiguous()
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
    checks = [("rows", bvh.rows, (bvh.num_rows, 128)), ("origin", origin, (r, 3)),
              ("direction", direction, (r, 3))]
    if alpha_tables is not None:
        ts, aq = alpha_tables.tri_static, alpha_tables.atlas_q
        checks += [("tri_static", ts, (ts.shape[0], shadetab._N_STATIC)),
                   ("atlas_q", aq, (aq.shape[0], 16))]
    for name, t, shape in checks:
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(
                f"trace: {name} must be a contiguous float32 {shape} tensor on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    fn, max_depth = load_kernel()
    if bvh.depth > max_depth:
        raise ValueError(
            f"trace: BVH depth {bvh.depth} exceeds the kernel's stack of {max_depth}"
        )
    if alpha_tables is None:
        tables = (None, None, 0, 0)
    else:
        tables = (alpha_tables.tri_static.data_ptr(), alpha_tables.atlas_q.data_ptr(),
                  alpha_tables.atlas_q.shape[0], alpha_tables.atlas_w)
    out_t = torch.empty(r, dtype=torch.float32, device=dev)
    out_tri = torch.empty(r, dtype=torch.int32, device=dev)
    out_u = torch.empty(r, dtype=torch.float32, device=dev)
    out_v = torch.empty(r, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            bvh.rows.data_ptr(), origin.data_ptr(), direction.data_ptr(),
            tmin_a.data_ptr(), tmax_a.data_ptr(), r, max_steps, int(anyhit),
            max(bvh.depth, 1), *tables,
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
