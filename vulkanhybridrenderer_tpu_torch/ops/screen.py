"""Screen-space reconstruction (glsl_common.h:110-122; port of ``ops/screen.py``)."""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.utils.math3d import transform_points


def pixel_uv_grid(height: int, width: int, device="cpu"):
    """(H, W, 2) uv at pixel centers: uv = (pixel + 0.5) / size."""
    xx = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    yy = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    return torch.stack(
        [xx[None, :].expand(height, width), yy[:, None].expand(height, width)],
        dim=-1,
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
