"""Shadow-map lookups (port of ``ops/shadowmap.py``).

The map itself is the Depth Prepass (models/passes.add_shadow_map_pass):
every triangle rastered from the light's clip space, depth only, binned
through K1a, or with ``config.raster="brute"`` by the brute reference
rasterizer (render_shadow_map).  Lookups: shadow_coord = SHADOW_BIAS_MATRIX @ projview @ P; uv =
coord.xy, and the fragment is lit when coord.z >= stored - bias (reverse-Z:
the stored depth is the surface closest to the light).  Every tap is a hard
compare, so one ulp in shadow_coords can flip it; the products are written
out in a fixed order (utils/math3d) and the bias matrix, whose entries are 0,
0.5 and 1, multiplies exactly.
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.ops import rasterizer
from vulkanhybridrenderer_tpu_torch.ops.filters import quad4_rows
from vulkanhybridrenderer_tpu_torch.utils.math3d import (
    SHADOW_BIAS_MATRIX,
    matmul4,
    transform_points,
)

PCF_OFFSETS = (-1.5, -0.5, 0.5, 1.5)


def render_shadow_map(clip_light, tri_vertex, size: int, chunk: int = 64):
    """The brute depth prepass (the reference's render_shadow_map,
    shadowmap.py:22-31): (V, 4) light clip-space vertices -> the (size,
    size) reverse-Z depth map, back faces culled (RASTERIZATION_STATE_DEFAULT
    keeps culling on for the prepass) and no alpha test."""
    setup = rasterizer.triangle_setup(clip_light, tri_vertex, size, size)
    return rasterizer.rasterize(setup, size, size, chunk=chunk).depth


def _sample_nearest(shadow_map, uv):
    """Nearest-texel depth, clamped to the edge.  uv: (..., 2)."""
    size_y, size_x = shadow_map.shape
    x = torch.clamp((uv[..., 0] * size_x).to(torch.int64), 0, size_x - 1)
    y = torch.clamp((uv[..., 1] * size_y).to(torch.int64), 0, size_y - 1)
    return shadow_map[y, x]


def shadow_coords(light_projview, world_pos):
    """(..., 3): uv and reverse-Z depth of world positions in light space."""
    bias = torch.from_numpy(SHADOW_BIAS_MATRIX).to(light_projview.device)
    h = transform_points(matmul4(bias, light_projview), world_pos)
    return h[..., :3] / h[..., 3:4]


def shadow_single_tap(shadow_map, light_projview, world_pos, bias: float = 0.003):
    """forward default.frag:75-79: shadow = coord.z < depth - bias ? 0 : 1."""
    sc = shadow_coords(light_projview, world_pos)
    d = _sample_nearest(shadow_map, sc[..., :2])
    return torch.where(sc[..., 2] < d - bias, 0.0, 1.0)


def shadow_pcf16(shadow_map, light_projview, world_pos, bias: float = 1e-4):
    """composition.frag:88-111: 16 taps on a 4x4 grid of half-texel offsets
    scaled by the reference's hard-coded 1/4096, averaged.

    Up to 4096 texels a side the grid spans at most 4 consecutive texels per
    axis, and the reference reads each row of taps from one edge-clamped
    4-texel row starting at x0 = floor(fx - 1.5 texel offsets): tap x reads
    texel x0 + clip(xi - x0, 0, 3), not xi.  Kept as it is.  Larger maps take
    one nearest tap per offset."""
    sc = shadow_coords(light_projview, world_pos)
    h, w = shadow_map.shape
    z = sc[..., 2]
    acc = torch.zeros_like(z)
    if w > 4096 or h > 4096:
        scale = 1.0 / 4096.0
        for oy in PCF_OFFSETS:
            for ox in PCF_OFFSETS:
                off = torch.tensor([ox * scale, oy * scale], dtype=torch.float32,
                                   device=sc.device)
                d = _sample_nearest(shadow_map, sc[..., :2] + off)
                acc = acc + torch.where(z < d - bias, 0.0, 1.0)
        return acc / 16.0

    quad = quad4_rows(shadow_map)
    sx, sy = w / 4096.0, h / 4096.0  # the 1/4096 uv scale, in texels
    fx = sc[..., 0] * w
    fy = sc[..., 1] * h
    x0 = torch.clamp(torch.floor(fx - 1.5 * sx).to(torch.int64), 0, w - 4)
    for oy in PCF_OFFSETS:
        yj = torch.clamp((fy + oy * sy).to(torch.int64), 0, h - 1)
        row = quad[yj * w + x0]  # (..., 4)
        for ox in PCF_OFFSETS:
            xi = torch.clamp((fx + ox * sx).to(torch.int64), 0, w - 1)
            lane = torch.clamp(xi - x0, 0, 3)
            d = torch.gather(row, -1, lane[..., None])[..., 0]
            acc = acc + torch.where(z < d - bias, 0.0, 1.0)
    return acc / 16.0
