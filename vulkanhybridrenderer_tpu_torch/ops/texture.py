"""Atlas texture sampling by texture id (port of ``ops/texture.py``).

All scene textures live in one packed atlas (core/types.TextureAtlas); texture
t's texel is ``uv_offset[t] + wrap(uv) * uv_scale[t]``, sampled bilinearly
with REPEAT wrapping inside the texture's tile.  The frame paths sample
through ``shadetab.sample_atlas4``, whose rows carry each triangle's scale and
offset already; this is the standalone sampler, with the same math, for
callers without shade tables.
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.core.types import TextureAtlas
from vulkanhybridrenderer_tpu_torch.ops.filters import flat_gather


def _gather_texel(data, iy, ix):
    """data (4, AH, AW); iy / ix (...,) integer -> (..., 4)."""
    c, _, aw = data.shape
    rows = data.reshape(c, -1).T  # (AH * AW, 4) texel-major
    return rows[iy.long() * aw + ix.long()]


def sample_atlas_bilinear(atlas: TextureAtlas, tex_id, uv, fallback=None):
    """Bilinear samples of per-pixel texture ids.

    tex_id: (...,) integer, -1 selects `fallback` (default ones, so callers
    can multiply); uv: (..., 2) in texture space, REPEAT-wrapped as the
    default glTF sampler.  Returns (..., 4) float32."""
    safe_id = torch.clamp(tex_id.long(), min=0)
    scale = torch.stack([flat_gather(atlas.uv_scale[:, c], safe_id) for c in range(2)], dim=-1)
    offset = torch.stack([flat_gather(atlas.uv_offset[:, c], safe_id) for c in range(2)], dim=-1)

    # REPEAT wrap into [0, 1), then texel coordinates about texel centres
    u = uv - torch.floor(uv)
    t = u * scale - 0.5
    t0 = torch.floor(t)
    f = t - t0

    def wrap(i, size):
        return torch.remainder(i, torch.clamp(size, min=1.0))

    x0 = wrap(t0[..., 0], scale[..., 0])
    y0 = wrap(t0[..., 1], scale[..., 1])
    x1 = wrap(t0[..., 0] + 1.0, scale[..., 0])
    y1 = wrap(t0[..., 1] + 1.0, scale[..., 1])
    ox, oy = offset[..., 0], offset[..., 1]
    ix0, ix1 = (ox + x0).to(torch.int32), (ox + x1).to(torch.int32)
    iy0, iy1 = (oy + y0).to(torch.int32), (oy + y1).to(torch.int32)

    d = atlas.data.to(torch.float32)
    c00 = _gather_texel(d, iy0, ix0)
    c10 = _gather_texel(d, iy0, ix1)
    c01 = _gather_texel(d, iy1, ix0)
    c11 = _gather_texel(d, iy1, ix1)
    fx, fy = f[..., 0:1], f[..., 1:2]
    out = (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
           + c01 * (1 - fx) * fy + c11 * fx * fy)
    if fallback is None:
        fallback = torch.ones(4, dtype=torch.float32, device=out.device)
    return torch.where((tex_id >= 0)[..., None], out, fallback)


def sample_or_factor(atlas: TextureAtlas, tex_id, uv, factor):
    """``tex == -1 ? factor : texture(tex, uv)`` (gbuf.frag:20-26)."""
    return torch.where((tex_id >= 0)[..., None], sample_atlas_bilinear(atlas, tex_id, uv),
                       factor)
