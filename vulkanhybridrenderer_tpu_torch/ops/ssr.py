"""Screen-space reflections (ssr.comp:61-137; port of ``ops/ssr.py``).

A world-space march along reflect(I, N) of ray_distance / step_size fixed
steps (200 by default); a step hits when 0.3 < dist_to_ray - dist_to_screen
< thickness.  Then bsearch_steps halvings between the last miss and the
hit, and the hit's texel is shaded with the full BRDF (:28-59).  Every pixel
walks every step, as the reference's fixed-count loops do; the march is a
plain Python loop over whole-image tensors.  Over a mesh a shard marches
its row slab's pixels (``rows``) over the whole images, since a reflected
ray may reach any row.
"""
from __future__ import annotations

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.core.config import SSRSettings
from vulkanhybridrenderer_tpu_torch.core.types import PerFrameData
from vulkanhybridrenderer_tpu_torch.ops import brdf, screen
from vulkanhybridrenderer_tpu_torch.ops.filters import (
    bilinear_quad,
    bilinear_sample,
    quad2x2_rows,
)
from vulkanhybridrenderer_tpu_torch.ops.screen import Rows
from vulkanhybridrenderer_tpu_torch.utils.math3d import (
    PI_INVERSE,
    matmul4,
    normalize,
    reflect,
    transform_points,
)

DELTA_MIN = 0.3  # ssr.comp:97


def _length(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def ssr(pfd: PerFrameData, depth, normal_oid, albedo, motion_mr,
        settings: SSRSettings, rows: Rows | None = None):
    """Returns (4, H, W) reflections: rgb, and the hit flag in alpha; with
    `rows`, those rows of them (the images are whole)."""
    h, w = depth.shape
    rows = rows or Rows.whole(h)
    coords = screen.pixel_coords(h, w, depth.device, rows.start, rows.count)
    depth_quad = quad2x2_rows(depth)
    cam = pfd.camera_position
    viewproj = matmul4(pfd.camera_proj, pfd.camera_view)
    p = screen.position_from_depth(bilinear_quad(depth_quad, h, w, coords), coords,
                                   pfd.camera_viewproj_inverse)
    n = normal_oid[:3, rows.start:rows.stop].permute(1, 2, 0)
    r_dir = normalize(reflect(normalize(p - cam), n))

    def in_hit_band(offset):
        ray_pos = p + r_dir * offset[..., None]
        clip = transform_points(viewproj, ray_pos)
        suv = (clip[..., :2] / clip[..., 3:4]) * 0.5 + 0.5
        d = bilinear_quad(depth_quad, h, w, suv)
        screen_pos = screen.position_from_depth(d, suv, pfd.camera_viewproj_inverse)
        delta = _length(ray_pos - cam) - _length(screen_pos - cam)
        return (delta > DELTA_MIN) & (delta < settings.thickness), suv

    # linear march (:83-104)
    found = torch.zeros((rows.count, w), dtype=torch.bool, device=depth.device)
    prev_step = torch.zeros((rows.count, w), dtype=torch.float32, device=depth.device)
    final_step = torch.zeros_like(prev_step)
    for i in range(int(settings.ray_distance / settings.step_size)):
        # step_size * i rounded in f32, like the reference's float loop
        offset = torch.full((rows.count, w), float(np.float32(settings.step_size) * np.float32(i)),
                            dtype=torch.float32, device=depth.device)
        hit, _ = in_hit_band(offset)
        final_step = torch.where(hit & ~found, offset, final_step)
        found = found | hit
        prev_step = torch.where(~found, offset, prev_step)

    # binary search (:105-128)
    mid = (prev_step + final_step) * 0.5
    final_uv = torch.zeros((rows.count, w, 2), dtype=torch.float32, device=depth.device)
    for _ in range(settings.bsearch_steps):
        hit, final_uv = in_hit_band(mid)
        mid, prev_step = (torch.where(hit, (prev_step + mid) * 0.5, mid + (mid - prev_step)),
                          torch.where(hit, prev_step, mid))

    # shade the hit texel (:28-59)
    alb = bilinear_sample(albedo, final_uv)[..., :3]
    pos = screen.position_from_depth(bilinear_quad(depth_quad, h, w, final_uv), final_uv,
                                     pfd.camera_viewproj_inverse)
    mr = bilinear_sample(motion_mr, final_uv)[..., 2:4]
    nrm = bilinear_sample(normal_oid, final_uv)[..., :3]
    l = (-pfd.directional_light.direction[:3]).expand(nrm.shape)
    lighting = brdf.direct_lighting(
        alb, torch.clamp(mr[..., 0], 0.0, 1.0), mr[..., 1], nrm, normalize(cam - pos), l,
        pfd.directional_light.color[:3], pfd.directional_light.intensity[:3],
        ambient_factor=PI_INVERSE * 0.2,
    )
    rgb = torch.where(found[..., None], lighting, 0.0)
    a = torch.where(found, 1.0, 0.0)
    return torch.cat([rgb, a[..., None]], dim=-1).permute(2, 0, 1).contiguous()
