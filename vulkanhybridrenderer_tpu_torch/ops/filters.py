"""Image gather and shift helpers of the screen-space passes (port of
``ops/filters.py``, the parts SVGF reads)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gather_2d(img, iy, ix):
    """img: (H, W) or (C, H, W); iy / ix integer (...,), clamped to bounds.
    Returns (...,) or (..., C)."""
    h, w = img.shape[-2:]
    lin = torch.clamp(iy, 0, h - 1).long() * w + torch.clamp(ix, 0, w - 1).long()
    if img.dim() == 2:
        return img.reshape(-1)[lin]
    c = img.shape[0]
    return img.reshape(c, -1)[:, lin.reshape(-1)].T.reshape(*iy.shape, c)


def shifted(img, dy: int, dx: int, fill=0.0):
    """Shift of the last two dims with `fill` outside:
    shifted(img, dy, dx)[..., y, x] == img[..., y + dy, x + dx]."""
    h, w = img.shape[-2:]
    p = F.pad(img, (max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)), value=fill)
    y0, x0 = max(0, dy), max(0, dx)
    return p[..., y0:y0 + h, x0:x0 + w]
