"""Texture atlas packing on the host (port of ``scene/atlas.py``).

All textures are shelf-packed into one (4, AH, AW) array, float32 or, as
the reference allows, bfloat16 (half the bytes); sRGB textures are
linearized at packing time.  Each texture carries a 1-texel wrap
border (first column copied to the right, first row below, plus the corner),
so a texel's atlas-space +1 neighbor is its REPEAT-wrap neighbor: the bilinear
sampler (ops/shadetab.py) relies on it.
"""
from __future__ import annotations

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.core.types import TextureAtlas


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 EOTF; c in [0, 1]."""
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(
        np.float32
    )


def _shelf_pack(sizes: list[tuple[int, int]], max_width: int = 8192):
    """Shelf packer over (w, h) sizes sorted by height; returns (positions in
    the original order, atlas_w, atlas_h)."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i][1])
    pos = [None] * len(sizes)
    shelf_y = shelf_h = x = atlas_w = 0
    for i in order:
        w, h = sizes[i]
        if w > max_width:
            raise ValueError(f"texture {i} wider than atlas max width {max_width}")
        if x + w > max_width:
            shelf_y += shelf_h
            x = 0
            shelf_h = 0
        pos[i] = (x, shelf_y)
        x += w
        shelf_h = max(shelf_h, h)
        atlas_w = max(atlas_w, x)
    return pos, atlas_w, shelf_y + shelf_h


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _atlas_data(planes: np.ndarray, dtype):
    """The (4, AH, AW) float32 planes in `dtype`: the numpy array itself in
    float32, a CPU bfloat16 tensor rounded to nearest even (as the
    reference's jnp.asarray(x, jnp.bfloat16)) in bfloat16."""
    if dtype == torch.float32:
        return np.ascontiguousarray(planes, np.float32)
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(planes, np.float32)).to(torch.bfloat16)
    raise ValueError(f"build_atlas: dtype must be torch.float32 or torch.bfloat16, got {dtype}")


def build_atlas(images: list[np.ndarray], srgb: list[bool] | None = None,
                dtype=torch.float32) -> TextureAtlas:
    """Pack RGBA images ((H, W, 4) uint8 or float in [0, 1]) into a host
    TextureAtlas of numpy arrays; with dtype torch.bfloat16 its data is a
    bfloat16 tensor, which every sampler reads back as float32."""
    n = len(images)
    if n == 0:
        return TextureAtlas(
            data=_atlas_data(np.ones((4, 8, 128), np.float32), dtype),
            uv_offset=np.zeros((1, 2), np.float32),
            uv_scale=np.ones((1, 2), np.float32),
        )
    srgb = srgb or [False] * n
    sizes = [(im.shape[1] + 1, im.shape[0] + 1) for im in images]
    pos, aw, ah = _shelf_pack(sizes)
    # same padded atlas size as the reference, so texel addresses agree
    aw = _round_up(max(aw, 128), 128)
    ah = _round_up(max(ah, 8), 8)
    atlas = np.zeros((ah, aw, 4), np.float32)
    offsets = np.zeros((n, 2), np.float32)
    scales = np.zeros((n, 2), np.float32)
    for i, im in enumerate(images):
        im = np.asarray(im)
        if im.ndim == 2:
            im = np.repeat(im[..., None], 4, axis=-1)
        if im.shape[-1] == 3:
            im = np.concatenate([im, np.ones_like(im[..., :1])], axis=-1)
        if im.dtype == np.uint8:
            im = im.astype(np.float32) / 255.0
        im = im.astype(np.float32)
        if srgb[i]:
            im = np.concatenate([srgb_to_linear(im[..., :3]), im[..., 3:]], axis=-1)
        x, y = pos[i]
        h, w = im.shape[:2]
        atlas[y : y + h, x : x + w] = im
        atlas[y : y + h, x + w] = im[:, 0]  # wrap border column
        atlas[y + h, x : x + w] = im[0, :]  # wrap border row
        atlas[y + h, x + w] = im[0, 0]  # wrap corner
        offsets[i] = (x, y)
        scales[i] = (w, h)
    return TextureAtlas(
        data=_atlas_data(atlas.transpose(2, 0, 1), dtype),
        uv_offset=offsets,
        uv_scale=scales,
    )
