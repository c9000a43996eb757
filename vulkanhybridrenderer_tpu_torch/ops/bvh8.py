"""BVH8 table (port of ``ops/bvh8.py``): the acceleration structure K2 walks.

Row layout ((N, 128) float32, slot-major SoA groups of 8):
  internal: [0:8]=lo.x[slot] [8:16]=lo.y [16:24]=lo.z [24:32]=hi.x [32:40]=hi.y
            [40:48]=hi.z  [48]=first child row  [49]=offset map (3 bits per
            slot: child row = base + (offmap >> 3*slot) & 7); empty slots
            carry inverted boxes (lo = 3e38 > hi = -3e38); [127]=0
  leaf:     [0:72] = v0.x[8] v0.y[8] v0.z[8] v1.x[8] ... v2.z[8]
            [72:80] = original triangle ids (-1 = empty slot); [127]=1

Static scenes build it once on the host: native binned-SAH binary tree,
collapsed to 8-wide rows with 8-triangle leaves (native_bridge.py).  The
per-slot refit metadata (child8 / valid8 / tri8) waits for animated scenes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch import native_bridge

LEAF_MAX = 8


@dataclasses.dataclass(frozen=True)
class BVH8:
    rows: Any  # (N, 128) float32 tensor
    #: stack bound: longest root-to-leaf chain of internal rows, plus 2
    depth: int = 16
    leaf_max: int = LEAF_MAX

    @property
    def num_rows(self) -> int:
        return self.rows.shape[0]

    def to(self, device) -> "BVH8":
        return dataclasses.replace(self, rows=self.rows.to(device))


def build_bvh8_host(tri_verts, leaf_max: int = LEAF_MAX) -> BVH8:
    """SAH build + BVH8 collapse of (T, 3, 3) world triangles on the host.
    Returns a BVH8 whose rows live on the CPU."""
    if leaf_max != LEAF_MAX:
        raise ValueError("the port builds 8-triangle leaf rows only")
    tris = np.asarray(tri_verts, np.float32)
    binary = native_bridge.build_sah_host(tris)
    rows, depth = native_bridge.bvh8_collapse_host(binary, tris, leaf_max)
    return BVH8(rows=torch.from_numpy(rows), depth=depth, leaf_max=leaf_max)
