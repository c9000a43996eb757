"""Screen-space reconstruction (glsl_common.h:110-122; port of ``ops/screen.py``).

Over a mesh (parallel/mesh.py) an image pass computes one row slab of the
image: ``Rows`` names it, and the coordinate grids take its first row and
the image's height, so a slab's pixels get the whole image's values.
"""
from __future__ import annotations

import dataclasses

import torch

from vulkanhybridrenderer_tpu_torch.utils.math3d import div, transform_points


@dataclasses.dataclass(frozen=True)
class Rows:
    """Rows [start, stop) of an image `height` rows tall: what a pass
    computes on one shard of a mesh."""

    start: int
    stop: int
    height: int

    @classmethod
    def whole(cls, height: int) -> "Rows":
        return cls(0, height, height)

    @property
    def count(self) -> int:
        return self.stop - self.start

    def window(self, halo: int) -> tuple[int, int]:
        """The rows within `halo` of these, clipped to the image."""
        return max(0, self.start - halo), min(self.height, self.stop + halo)


def _grid_rows(height: int, row0: int, rows: int | None, device):
    """Rows row0 .. row0 + rows (to the end by default) as float32."""
    stop = height if rows is None else row0 + rows
    return torch.arange(row0, stop, dtype=torch.float32, device=device)


def pixel_uv_grid(height: int, width: int, device="cpu", row0: int = 0,
                  rows: int | None = None):
    """(H, W, 2) uv at pixel centers: uv = (pixel + 0.5) / size; `rows`
    rows from `row0` of the `height`-row grid (all of it by default)."""
    xx = div(torch.arange(width, dtype=torch.float32, device=device) + 0.5, width)
    yy = div(_grid_rows(height, row0, rows, device) + 0.5, height)
    n = yy.shape[0]
    return torch.stack(
        [xx[None, :].expand(n, width), yy[:, None].expand(n, width)],
        dim=-1,
    )


def pixel_coords(height: int, width: int, device="cpu", row0: int = 0,
                 rows: int | None = None):
    """(H, W, 2) uv = pixel index / size, without the half-texel offset: the
    coords of ssao.comp:17 and ssr.comp; rows as pixel_uv_grid's."""
    xx = div(torch.arange(width, dtype=torch.float32, device=device), width)
    yy = div(_grid_rows(height, row0, rows, device), height)
    n = yy.shape[0]
    return torch.stack(
        [xx[None, :].expand(n, width), yy[:, None].expand(n, width)], dim=-1
    )


def position_from_depth(depth, uv, inverse_matrix):
    """inverse_matrix @ (uv*2-1, depth, 1), divided by w.  Sky (depth 0, w 0)
    is clamped to |w| >= 1e-8 so it stays finite, like the reference."""
    ndc = torch.cat([uv * 2.0 - 1.0, depth[..., None]], dim=-1)
    h = transform_points(inverse_matrix, ndc)
    w = h[..., 3:4]
    tiny = torch.where(w < 0, -1e-8, 1e-8)
    w = torch.where(torch.abs(w) < 1e-8, tiny, w)
    return h[..., :3] / w
