"""Alchemy screen-space ambient occlusion and its box blur (ssao.comp,
ssao_blur.comp; port of ``ops/ssao.py``).

The reference's quirks are kept:
  * coords = pixel index / display size, without the half-texel offset (:17);
  * perspective_radius = radius / P.z with P.z negative in front of the
    camera, unsigned, which mirrors the disk offsets (:28);
  * 16 samples from the shader RNG seeded (y * H + x) * frame_index, which
    seeds every pixel alike on frame 0 (:36-44);
  * AO = max(1 - (2 sigma / n) sum(max(V.N - beta, 0) / (V.V + 1e-4)), 0)
    with sigma 1 and beta 1e-4 (:31-46), and 0 on sky pixels (:17-23);
  * the blur sums the in-bounds taps of a 13x13 box and always divides by
    169 (ssao_blur.comp:14-25), which darkens the edges.

Over a mesh a shard computes its row slab (``rows``): SSAO from the whole
depth (a sample's screen radius has no bound) and its own rows' normals,
the blur from its rows and the BLUR_RADIUS rows above and below them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from vulkanhybridrenderer_tpu_torch.core.types import PerFrameData
from vulkanhybridrenderer_tpu_torch.ops import screen
from vulkanhybridrenderer_tpu_torch.ops.filters import bilinear_quad, quad2x2_rows
from vulkanhybridrenderer_tpu_torch.ops.screen import Rows
from vulkanhybridrenderer_tpu_torch.utils import rng
from vulkanhybridrenderer_tpu_torch.utils.math3d import TWO_PI, div, transform_directions

NUM_SAMPLES = 16
SIGMA = 1.0
BETA = 1e-4
BLUR_RADIUS = 6


def ssao(pfd: PerFrameData, depth, normal_oid, radius: float, rows: Rows | None = None):
    """depth (H, W), normal_oid (4, H, W) -> AO (H, W).  With `rows`,
    normal_oid and the output are those rows; depth is whole."""
    h, w = depth.shape
    rows = rows or Rows.whole(h)
    coords = screen.pixel_coords(h, w, depth.device, rows.start, rows.count)
    dq = quad2x2_rows(depth)
    d0 = bilinear_quad(dq, h, w, coords)
    p = screen.position_from_depth(d0, coords, pfd.camera_proj_inverse)
    n = transform_directions(pfd.camera_view, normal_oid[:3].permute(1, 2, 0))
    # a true division (python_scalar / tensor is a reciprocal times a product)
    perspective_radius = torch.div(torch.tensor(radius, dtype=torch.float32), p[..., 2])
    state = rng.pixel_seed(w, h, pfd.frame_index, depth.device, rows.start, rows.count)

    acc = torch.zeros((rows.count, w), dtype=torch.float32, device=depth.device)
    for _ in range(NUM_SAMPLES):
        state, r1 = rng.random01(state)
        state, r2 = rng.random01(state)
        ang = r1 * TWO_PI
        dist = r2 * perspective_radius
        suv = coords + torch.stack([torch.cos(ang) * dist, torch.sin(ang) * dist], dim=-1)
        ps = screen.position_from_depth(bilinear_quad(dq, h, w, suv), suv,
                                        pfd.camera_proj_inverse)
        v = ps - p
        acc = acc + torch.clamp(torch.sum(v * n, dim=-1) - BETA, min=0.0) / (
            torch.sum(v * v, dim=-1) + 1e-4)

    ao = torch.clamp(1.0 - (2.0 * SIGMA / NUM_SAMPLES) * acc, min=0.0)
    return torch.where(d0 == 0.0, 0.0, ao)


def ssao_blur(ao, rows: Rows | None = None):
    """13x13 box blur, every pixel divided by the full 169 (ssao_blur.comp:
    14-25).  The taps are added in the reference's row-major order, read as
    views of one copy zero-padded past the image's edges.  With `rows`, ao
    is rows.window(BLUR_RADIUS) of the image and the output is `rows`."""
    r = BLUR_RADIUS
    rows = rows or Rows.whole(ao.shape[0])
    top, bottom = rows.window(r)
    h, w = rows.count, ao.shape[1]
    pad = F.pad(ao, (r, r, r - (rows.start - top), r - (bottom - rows.stop)))
    acc = torch.zeros((h, w), dtype=ao.dtype, device=ao.device)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            acc = acc + pad[dy:dy + h, dx:dx + w]
    return div(acc, float((2 * r + 1) ** 2))
