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
way (``collapse_host``).  The
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


def collapse_host(bvh, tri_verts, leaf_max: int = LEAF_MAX) -> BVH8:
    """The BVH8 of any binary tree (ops/bvh.BVH: the SAH tree, the native or
    the device LBVH, any leaf_size) over its (T, 3, 3) triangles, collapsed
    on the host (the reference's build_bvh8_host(bvh, tri_verts)).  Returns
    a BVH8 whose rows live on the CPU."""
    if leaf_max != LEAF_MAX:
        raise ValueError("the port builds 8-triangle leaf rows only")
    rows, depth = native_bridge.bvh8_collapse_host(bvh, tri_verts, leaf_max)
    return BVH8.from_rows(torch.from_numpy(rows), depth, leaf_max)


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
