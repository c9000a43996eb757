"""Hybrid ray-trace pass (port of ``ops/raygen.py``): RT shadows, AO and
mirror reflections from the G-buffer (raygen.rgen:14-67, reflection_hit.rchit
and the miss shaders).

- RNG: seed_thread((y * H + x) * frame_index), xorshift draws in the
  reference's order: shadow rnd1, rnd2, then rnd1, rnd2 of each AO ray.
- Shadow: one direction in the cone around the light (cos_theta_max
  0.999995), traced any-hit through the BVH8 (K2) or, with
  ``shadow_accel="grid"``, the light-space shadow grid (K3); a miss is lit.
- AO: `ao_rays` cosine-hemisphere rays around N, tmax 5, traced any-hit as
  ONE wavefront of ao_rays * H * W rays; the result is the mean of misses.
- Reflection: the mirror reflect() of the camera ray, traced closest-hit and
  shaded by rt_shade.reflection_hit_shade; a miss is 0.
- Every ray starts at P + N * 0.1 with tmin 0.01.  Rays whose result cannot
  reach the image are dead (tmax = -1 < tmin, so K2 drops them at once): sky
  pixels, and shadow rays of pixels facing away from the light when denoise
  and reflections are off (composition multiplies the shadow by
  max(N.L, 0) = 0 there; SVGF and the reflection modes do read it, so then
  those rays stay live).  Channels no active mode reads are not traced
  (shadow / AO 1, reflections 0), as in the reference.
- Sky pixels are overridden after the trace: shadow_ao = (1, 1, 0, 1),
  reflections 0.

Rays are traced flat in image order: a GPU thread per ray needs none of the
reference's packet, strip or tiling schedules.
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.core.config import (
    AmbientOcclusionMode,
    HybridSettings,
    ReflectionMode,
    ShadowMode,
)
from vulkanhybridrenderer_tpu_torch.core.types import PerFrameData
from vulkanhybridrenderer_tpu_torch.ops import rt_shade, screen, shadowgrid, traverse
from vulkanhybridrenderer_tpu_torch.ops.bvh8 import BVH8
from vulkanhybridrenderer_tpu_torch.ops.sampling import (
    to_basis,
    uniform_sample_cone,
    uniform_sample_cosine_hemisphere,
)
from vulkanhybridrenderer_tpu_torch.utils import rng
from vulkanhybridrenderer_tpu_torch.utils.math3d import div, normalize, reflect

CONE_COS_THETA_MAX = 0.999995
SHADOW_TMIN = 0.01
SHADOW_TMAX = 10000.0
AO_TMAX = 5.0


def surface(pfd: PerFrameData, depth, normal_oid):
    """G-buffer surface per pixel: world position (H, W, 3), normal
    (H, W, 3) and the sky mask (depth == 0)."""
    h, w = depth.shape
    uv = screen.pixel_uv_grid(h, w, device=depth.device)
    p_world = screen.position_from_depth(depth, uv, pfd.camera_viewproj_inverse)
    n = normal_oid[:3].permute(1, 2, 0)
    return p_world, n, depth == 0.0


class Wavefronts:
    """Every ray of one frame's raytrace pass in image order (R = H * W):
    `origin` (R, 3); the shadow rays' `shadow_dir` (R, 3) and `shadow_tmax`
    (R,); the AO rays' `ao_dir` (ao_rays * R, 3), ray k of pixel i at
    k * R + i, and `ao_tmax` (R,); the reflection rays' `refl_dir` (R, 3)
    and `refl_tmax` (R,).  tmax is -1 for dead rays.  The AO and reflection
    rays are made only when `settings` traces them (else None); `settings`
    None traces all three kinds and keeps every lit pixel's shadow ray."""

    def __init__(self, pfd: PerFrameData, depth, normal_oid,
                 settings: HybridSettings | None = None, ao_rays: int = 2):
        h, w = depth.shape
        p_world, n, sky = surface(pfd, depth, normal_oid)
        sky_flat = sky.reshape(-1)
        n_flat = n.reshape(-1, 3)
        l = -pfd.directional_light.direction[:3]
        self.origin = (p_world + n * 0.1).reshape(-1, 3).contiguous()

        state = rng.pixel_seed(w, h, pfd.frame_index, device=depth.device)
        state, r1 = rng.random01(state)
        state, r2 = rng.random01(state)
        u2 = torch.stack([r1, r2], dim=-1).reshape(-1, 2)
        cone = normalize(uniform_sample_cone(u2, CONE_COS_THETA_MAX))
        self.shadow_dir = to_basis(l.expand(h * w, 3), cone).contiguous()
        tmax = torch.where(sky_flat, -1.0, SHADOW_TMAX)
        if (settings is not None and not settings.denoise
                and settings.reflection_mode == ReflectionMode.OFF):
            ndl = torch.sum(n_flat * l, dim=-1)
            tmax = torch.where(ndl <= 0.0, -1.0, tmax)
        self.shadow_tmax = tmax.contiguous()

        self.ao_dir = self.ao_tmax = self.refl_dir = self.refl_tmax = None
        if settings is None or settings.ao_mode == AmbientOcclusionMode.RAYTRACED:
            dirs = []
            for _ in range(ao_rays):
                state, r1 = rng.random01(state)
                state, r2 = rng.random01(state)
                u2 = torch.stack([r1, r2], dim=-1).reshape(-1, 2)
                dirs.append(to_basis(n_flat, uniform_sample_cosine_hemisphere(u2)))
            self.ao_dir = torch.cat(dirs).contiguous()
            self.ao_tmax = torch.where(sky_flat, -1.0, AO_TMAX).contiguous()
        if settings is None or settings.reflection_mode == ReflectionMode.RAYTRACED:
            i_dir = normalize(p_world - pfd.camera_position).reshape(-1, 3)
            self.refl_dir = reflect(i_dir, n_flat).contiguous()
            self.refl_tmax = torch.where(sky_flat, -1.0, SHADOW_TMAX).contiguous()


def hybrid_raytrace(scene, tables, tri_rows, bvh: BVH8 | None, tri_verts,
                    pfd: PerFrameData, depth, normal_oid, ao_rays: int = 2,
                    settings: HybridSettings | None = None,
                    shadow_grid: shadowgrid.ShadowGrid | None = None):
    """depth (H, W), normal_oid (4, H, W) -> ("Raytraced Shadows and Ambient
    Occlusion" (4, H, W), "Raytraced Reflections" (4, H, W)).  The
    reference's signature: `tri_verts` (the world triangles) is accepted and
    not read, as in the reference, since the BVH8's leaf rows hold the
    vertices.  `settings` None traces shadows, AO and reflections; otherwise
    the kinds no active mode reads are not traced.  With `shadow_grid`
    (``shadow_accel="grid"``) the shadow rays go through the light-space
    grid (K3) instead of the BVH8, with the same hit / miss answers; `bvh`
    may then be None when nothing else is traced."""
    h, w = depth.shape
    dev = depth.device
    rays = Wavefronts(pfd, depth, normal_oid, settings, ao_rays)
    ones = torch.ones((h, w), dtype=torch.float32, device=dev)

    if settings is None or settings.shadow_mode == ShadowMode.RAYTRACED:
        if shadow_grid is not None:
            hit = shadowgrid.trace_shadow(shadow_grid, rays.origin, rays.shadow_dir,
                                          SHADOW_TMIN, rays.shadow_tmax, width=w)
        else:
            hit = traverse.trace(bvh, rays.origin, rays.shadow_dir, SHADOW_TMIN,
                                 rays.shadow_tmax, anyhit=True).hit
        shadow = torch.where(hit, 0.0, 1.0).reshape(h, w)
    else:
        shadow = ones

    if rays.ao_dir is not None:
        rec = traverse.trace(
            bvh, rays.origin.repeat(ao_rays, 1), rays.ao_dir, SHADOW_TMIN,
            rays.ao_tmax.repeat(ao_rays), anyhit=True,
        )
        miss = torch.where(rec.hit, 0.0, 1.0).reshape(ao_rays, h, w)
        ao = div(torch.sum(miss, dim=0), ao_rays)
    else:
        ao = ones

    sky = depth == 0.0
    if rays.refl_dir is not None:
        rec = traverse.trace(bvh, rays.origin, rays.refl_dir, SHADOW_TMIN,
                             rays.refl_tmax, anyhit=False)
        shaded = rt_shade.reflection_hit_shade(
            scene, tables, tri_rows, pfd, rec.tri, rec.u, rec.v
        )
        refl = torch.where(rec.hit[:, None], shaded, 0.0).reshape(h, w, 4)
        refl = torch.where(sky[..., None], 0.0, refl).permute(2, 0, 1).contiguous()
    else:
        refl = torch.zeros((4, h, w), dtype=torch.float32, device=dev)

    shadow = torch.where(sky, 1.0, shadow)
    ao = torch.where(sky, 1.0, ao)
    shadow_ao = torch.stack([shadow, ao, torch.zeros_like(shadow), ones], dim=0)
    return shadow_ao, refl
