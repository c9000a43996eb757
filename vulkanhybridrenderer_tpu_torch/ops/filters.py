"""Image gather, shift and bilinear-tap helpers of the screen-space passes
(port of ``ops/filters.py``).

Two bilinear samplers, as in the reference, with different arithmetic:
``bilinear_sample`` takes the four-product form and clamps the integer texel
index; ``bilinear_quad`` clamps the continuous coordinate first and does two
lerps, reading one edge-clamped 2x2 row of ``quad2x2_rows`` per tap.  SSR
uses both, so they are not interchangeable.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def flat_gather(table, idx):
    """table: (N,) 1-D; idx: any integer shape -> table[idx]."""
    return table[idx]


def gather_2d(img, iy, ix):
    """img: (H, W) or (C, H, W); iy / ix integer (...,), clamped to bounds.
    Returns (...,) or (..., C)."""
    h, w = img.shape[-2:]
    lin = torch.clamp(iy, 0, h - 1).long() * w + torch.clamp(ix, 0, w - 1).long()
    if img.dim() == 2:
        return img.reshape(-1)[lin]
    c = img.shape[0]
    return img.reshape(c, -1)[:, lin.reshape(-1)].T.reshape(*iy.shape, c)


def _texel(v, size: int):
    """floor(v) as int64, first clamped to [-1, size] in float: every later
    clamp of the index (and of index + 1) to [0, size - 1] gives what it
    would on the unclamped value, and a huge or NaN coordinate cannot
    overflow the conversion into an out-of-range index."""
    return torch.clamp(torch.floor(v), -1.0, float(size)).to(torch.int64)


def bilinear_sample(img, uv):
    """GLSL texture() with a linear clamp-to-edge sampler.  img: (H, W) or
    (C, H, W); uv: (..., 2) in [0, 1] (texel centers at (i + .5) / size).
    Returns (...,) or (..., C)."""
    h, w = img.shape[-2:]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = _texel(x, w)
    y0i = _texel(y, h)
    c00 = gather_2d(img, y0i, x0i)
    c10 = gather_2d(img, y0i, x0i + 1)
    c01 = gather_2d(img, y0i + 1, x0i)
    c11 = gather_2d(img, y0i + 1, x0i + 1)
    if img.dim() == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def shifted(img, dy: int, dx: int, fill=0.0):
    """Shift of the last two dims with `fill` outside:
    shifted(img, dy, dx)[..., y, x] == img[..., y + dy, x + dx]."""
    h, w = img.shape[-2:]
    p = F.pad(img, (max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)), value=fill)
    y0, x0 = max(0, dy), max(0, dx)
    return p[..., y0:y0 + h, x0:x0 + w]


def inbounds_mask(height: int, width: int, dy: int, dx: int, device="cpu"):
    """(H, W) bool: True where pixel (y + dy, x + dx) is inside the image."""
    yy = torch.arange(height, device=device)[:, None] + dy
    xx = torch.arange(width, device=device)[None, :] + dx
    return ((yy >= 0) & (yy < height)) & ((xx >= 0) & (xx < width))


def _edge_shift(img, dy: int, dx: int):
    """shifted() for dy, dx >= 0 with edge replication (clamp-to-edge)."""
    h, w = img.shape[-2:]
    iy = torch.clamp(torch.arange(h, device=img.device) + dy, max=h - 1)
    ix = torch.clamp(torch.arange(w, device=img.device) + dx, max=w - 1)
    return img[..., iy[:, None], ix[None, :]]


def quad2x2_rows(img):
    """(H, W) -> (H*W, 4) rows [v(y,x), v(y,x+1), v(y+1,x), v(y+1,x+1)],
    edge-clamped: one bilinear tap reads one row (bilinear_quad)."""
    return torch.stack(
        [img, _edge_shift(img, 0, 1), _edge_shift(img, 1, 0), _edge_shift(img, 1, 1)],
        dim=-1,
    ).reshape(-1, 4)


def bilinear_quad(quad, h: int, w: int, uv):
    """GLSL texture() with a linear clamp-to-edge sampler over quad2x2_rows:
    the continuous coordinate is clamped first (which zeroes the weights of
    out-of-range texels), then two lerps per row and one between them."""
    x = torch.clamp(uv[..., 0] * w - 0.5, 0.0, w - 1.0)
    y = torch.clamp(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.clamp(_texel(x, w), max=w - 1)
    y0i = torch.clamp(_texel(y, h), max=h - 1)
    # a NaN coordinate gives a NaN tap either way; keep its address in range
    c = quad[torch.clamp(y0i * w + x0i, 0, quad.shape[0] - 1)]
    top = c[..., 0] * (1 - fx) + c[..., 1] * fx
    bot = c[..., 2] * (1 - fx) + c[..., 3] * fx
    return top * (1 - fy) + bot * fy


def quad4_rows(img):
    """(H, W) -> (H*W, 4) rows [v(y, x..x+3)], edge-clamped: four
    consecutive texels of a row in one gather (the 16-tap PCF)."""
    return torch.stack(
        [img, _edge_shift(img, 0, 1), _edge_shift(img, 0, 2), _edge_shift(img, 0, 3)],
        dim=-1,
    ).reshape(-1, 4)
