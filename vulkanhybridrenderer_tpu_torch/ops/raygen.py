"""Hybrid ray-trace pass, shadow branch (port of ``ops/raygen.py``).

raygen.rgen:14-41 for RT shadows: one cone-sampled direction around the
light per pixel (cos_theta_max 0.999995) from P + N * 0.1, tmin 0.01, traced
any-hit; a miss is lit.  RNG draws follow the reference: seed_thread((y * H +
x) * frame_index), shadow rnd1 then rnd2.  Rays whose result cannot reach
the image are dead (tmax = -1 < tmin, so K2 drops them at once): sky pixels,
and pixels facing away from the light when denoise and reflections are off
(composition multiplies the shadow by max(N.L, 0) = 0 there).  Sky pixels
are overridden after the trace: shadow_ao = (1, 1, 0, 1), reflections 0.
Rays are traced flat, one per pixel in image order.  RT AO and reflections
are not ported yet (ROADMAP item 8).
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
from vulkanhybridrenderer_tpu_torch.ops import screen, traverse
from vulkanhybridrenderer_tpu_torch.ops.bvh8 import BVH8
from vulkanhybridrenderer_tpu_torch.ops.sampling import to_basis, uniform_sample_cone
from vulkanhybridrenderer_tpu_torch.utils import rng
from vulkanhybridrenderer_tpu_torch.utils.math3d import normalize

CONE_COS_THETA_MAX = 0.999995
SHADOW_TMIN = 0.01
SHADOW_TMAX = 10000.0


def check_supported(settings: HybridSettings) -> None:
    if settings.ao_mode != AmbientOcclusionMode.OFF:
        raise NotImplementedError("ambient occlusion: ROADMAP items 8 and 13")
    if settings.reflection_mode != ReflectionMode.OFF:
        raise NotImplementedError("reflections: ROADMAP items 8 and 13")
    if settings.denoise:
        raise NotImplementedError("SVGF denoise: ROADMAP item 9")
    if settings.rt_scale != 1:
        raise NotImplementedError("half-resolution RT (rt_scale > 1): ROADMAP item 12")


def surface(pfd: PerFrameData, depth, normal_oid):
    """G-buffer surface per pixel: world position (H, W, 3), normal
    (H, W, 3) and the sky mask (depth == 0)."""
    h, w = depth.shape
    uv = screen.pixel_uv_grid(h, w, device=depth.device)
    p_world = screen.position_from_depth(depth, uv, pfd.camera_viewproj_inverse)
    n = normal_oid[:3].permute(1, 2, 0)
    return p_world, n, depth == 0.0


def shadow_rays(pfd: PerFrameData, depth, normal_oid, settings: HybridSettings):
    """Per-pixel shadow rays in image order: origin (R, 3), direction (R, 3),
    tmax (R,) with -1 for dead rays."""
    h, w = depth.shape
    p_world, n, sky = surface(pfd, depth, normal_oid)
    l = -pfd.directional_light.direction[:3]
    origin = (p_world + n * 0.1).reshape(-1, 3)
    state = rng.pixel_seed(w, h, pfd.frame_index, device=depth.device)
    state, r1 = rng.random01(state)
    state, r2 = rng.random01(state)
    u2 = torch.stack([r1, r2], dim=-1).reshape(-1, 2)
    cone = normalize(uniform_sample_cone(u2, CONE_COS_THETA_MAX))
    direction = to_basis(l.expand(h * w, 3), cone)
    tmax = torch.where(sky.reshape(-1), -1.0, SHADOW_TMAX)
    if not settings.denoise and settings.reflection_mode == ReflectionMode.OFF:
        ndl = torch.sum(n.reshape(-1, 3) * l, dim=-1)
        tmax = torch.where(ndl <= 0.0, -1.0, tmax)
    return origin.contiguous(), direction.contiguous(), tmax.contiguous()


def hybrid_raytrace(bvh: BVH8, pfd: PerFrameData, depth, normal_oid,
                    settings: HybridSettings):
    """depth (H, W), normal_oid (4, H, W) -> ("Raytraced Shadows and Ambient
    Occlusion" (4, H, W), "Raytraced Reflections" (4, H, W))."""
    check_supported(settings)
    h, w = depth.shape
    ones = torch.ones((h, w), dtype=torch.float32, device=depth.device)
    if settings.shadow_mode == ShadowMode.RAYTRACED:
        origin, direction, tmax = shadow_rays(pfd, depth, normal_oid, settings)
        rec = traverse.trace(bvh, origin, direction, SHADOW_TMIN, tmax, anyhit=True)
        shadow = torch.where(rec.hit, 0.0, 1.0).reshape(h, w)
    else:
        shadow = ones
    sky = depth == 0.0
    shadow = torch.where(sky, 1.0, shadow)
    shadow_ao = torch.stack([shadow, ones, torch.zeros_like(shadow), ones], dim=0)
    refl = torch.zeros((4, h, w), dtype=torch.float32, device=depth.device)
    return shadow_ao, refl
