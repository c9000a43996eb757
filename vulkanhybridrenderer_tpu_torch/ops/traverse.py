"""BVH8 ray traversal (port of ``ops/traverse.py``): kernel K2.

``trace(bvh8, origin, direction, tmin, tmax, anyhit)`` walks the BVH8 table of
ops/bvh8.py once per ray with the semantics of the reference's per-ray walk
(``_trace8``): near-first slot ^ octant child order, 8-wide slab tests with
empty slots masked, 8-wide Moller-Trumbore leaves without culling, any-hit
stopping at the first accepted hit, at most ``min(4 * rows + 4, 32768)``
steps per ray.  On CUDA tensors it launches the hand-written kernel
csrc/bvh8_trace.cu; on CPU tensors it runs ``trace_plain``, a lockstep port
of ``_trace8`` that drops finished rays between steps.  The reference's TPU
schedules (strips, packets, compaction, ray sorting, unrolling) have no
counterpart: a GPU thread per ray needs none of them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any

import torch

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


def trace_plain(rows, depth: int, origin, direction, tmin, tmax,
                anyhit: bool, max_steps: int) -> HitRecord:
    """Plain PyTorch K2: ``_trace8`` stepped in lockstep over the live rays.
    rows (N, 128) f32; origin / direction (R, 3); tmin / tmax (R,)."""
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

    def retire(keep):
        t_out[ids[~keep]] = tb[~keep]
        tri_out[ids[~keep]] = trb[~keep]
        u_out[ids[~keep]] = ub[~keep]
        v_out[ids[~keep]] = vb[~keep]

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
        v0x, v0y, v0z = g(0), g(1), g(2)
        e1x, e1y, e1z = g(3) - v0x, g(4) - v0y, g(5) - v0z
        e2x, e2y, e2z = g(6) - v0x, g(7) - v0y, g(8) - v0z
        tri8 = row[:, 72:80].to(torch.int32)
        dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        okd = torch.abs(det) > 1e-9
        invdet = 1.0 / torch.where(okd, det, torch.ones_like(det))
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        u8 = (tvx * px + tvy * py + tvz * pz) * invdet
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v8 = (dx * qx + dy * qy + dz * qz) * invdet
        t8 = (e2x * qx + e2y * qy + e2z * qz) * invdet
        ok8 = (
            okd & (u8 >= 0.0) & (v8 >= 0.0) & (u8 + v8 <= 1.0) & (tri8 >= 0)
            & (t8 >= tn_[:, None]) & (t8 < tb[:, None]) & is_leaf[:, None]
        )
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
            tb, trb, ub, vb = tb[keep], trb[keep], ub[keep], vb[keep]
            n = ids.shape[0]
    retire(torch.zeros(n, dtype=torch.bool, device=dev))
    return HitRecord(t=t_out, tri=tri_out, u=u_out, v=v_out)


@functools.cache
def load_kernel():
    """Build K2 (on first use) and load it; returns (launch function, the
    kernel's stack depth)."""
    from vulkanhybridrenderer_tpu_torch.utils.build import load_cuda_library

    lib = load_cuda_library("bvh8_trace.cu")
    fn = lib.bvh8_trace_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    )
    lib.bvh8_trace_max_depth.restype = ctypes.c_int
    lib.bvh8_trace_max_depth.argtypes = []
    return fn, lib.bvh8_trace_max_depth()


def trace(bvh: BVH8, origin, direction, tmin, tmax, anyhit: bool = False,
          max_steps: int | None = None) -> HitRecord:
    """Trace rays through `bvh`.  origin / direction: (R, 3) float32;
    tmin / tmax: scalars or (R,).  Rays with tmax < tmin miss at once."""
    dev = origin.device
    r = origin.shape[0]
    tmin_a = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(r).contiguous()
    tmax_a = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(r).contiguous()
    if max_steps is None:
        max_steps = default_max_steps(bvh)
    if bvh.leaf_max != 8:
        raise ValueError("trace: the port's BVH8 rows hold 8-triangle leaves")
    if dev.type == "cpu":
        return trace_plain(bvh.rows, bvh.depth, origin, direction, tmin_a,
                           tmax_a, anyhit, max_steps)
    if dev.type != "cuda":
        raise ValueError(f"trace: unsupported device {dev}")
    for name, t, shape in (("rows", bvh.rows, (bvh.num_rows, 128)),
                           ("origin", origin, (r, 3)),
                           ("direction", direction, (r, 3))):
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
    out_t = torch.empty(r, dtype=torch.float32, device=dev)
    out_tri = torch.empty(r, dtype=torch.int32, device=dev)
    out_u = torch.empty(r, dtype=torch.float32, device=dev)
    out_v = torch.empty(r, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            bvh.rows.data_ptr(), origin.data_ptr(), direction.data_ptr(),
            tmin_a.data_ptr(), tmax_a.data_ptr(), r, max_steps, int(anyhit),
            out_t.data_ptr(), out_tri.data_ptr(), out_u.data_ptr(),
            out_v.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"bvh8_trace kernel launch failed: CUDA error {err}")
    trace.launches += 1
    return HitRecord(t=out_t, tri=out_tri, u=out_u, v=out_v)


trace.launches = 0
