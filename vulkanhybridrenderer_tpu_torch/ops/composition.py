"""Hybrid composition (composition.frag:64-161; port of ``ops/composition.py``).

G-buffer + shadow source -> final linear lighting.  Shadow sources: RAYTRACED
(the raytrace pass's channel 0) or OFF.  The rasterized shadow map, SSAO /
RT AO and SSR / RT reflections are not ported yet (ROADMAP items 8 and 13).
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.core.config import (
    AmbientOcclusionMode,
    HybridSettings,
    ReflectionMode,
    ShadowMode,
)
from vulkanhybridrenderer_tpu_torch.core.types import GBuffer, PerFrameData
from vulkanhybridrenderer_tpu_torch.ops import brdf, screen
from vulkanhybridrenderer_tpu_torch.utils.math3d import PI_INVERSE, normalize


def check_supported(settings: HybridSettings) -> None:
    if settings.shadow_mode == ShadowMode.RASTERIZED:
        raise NotImplementedError("rasterized shadows: ROADMAP item 13")
    if settings.ao_mode != AmbientOcclusionMode.OFF:
        raise NotImplementedError("ambient occlusion: ROADMAP items 8 and 13")
    if settings.reflection_mode != ReflectionMode.OFF:
        raise NotImplementedError("reflections: ROADMAP items 8 and 13")


def compose(gbuf: GBuffer, pfd: PerFrameData, settings: HybridSettings,
            rt_shadow_ao=None):
    """Returns the (4, H, W) linear frame (alpha 1)."""
    check_supported(settings)
    h, w = gbuf.depth.shape
    dev = gbuf.depth.device
    uv = screen.pixel_uv_grid(h, w, device=dev)
    albedo = gbuf.albedo[:3].permute(1, 2, 0)
    p = screen.position_from_depth(gbuf.depth, uv, pfd.camera_viewproj_inverse)
    n = gbuf.normal_oid[:3].permute(1, 2, 0)
    metallic = torch.clamp(gbuf.motion_mr[2], 0.0, 1.0)
    roughness = torch.clamp(gbuf.motion_mr[3], brdf.MIN_ROUGHNESS, 1.0)

    v = normalize(pfd.camera_position - p)
    l_b = (-pfd.directional_light.direction[:3]).expand(n.shape)
    h_vec = normalize(l_b + v)

    if settings.shadow_mode == ShadowMode.RAYTRACED:
        shadow = rt_shadow_ao[0]
    else:
        shadow = torch.ones((h, w), dtype=torch.float32, device=dev)
    ao = torch.ones((h, w), dtype=torch.float32, device=dev)

    light_i = pfd.directional_light.intensity[:3]
    light_c = pfd.directional_light.color[:3]
    f0 = torch.full_like(albedo, 0.04)
    f0 = f0 + (albedo - f0) * metallic[..., None]
    f = brdf.fresnel_schlick(f0, h_vec, v)
    n_dot_l = torch.clamp(torch.sum(n * l_b, dim=-1), min=0.0)

    ambient = ao[..., None] * albedo * PI_INVERSE
    common = (n_dot_l * shadow)[..., None] * light_i * light_c
    diffuse = brdf.diffuse_brdf(metallic, albedo, f) * common
    specular = brdf.specular_brdf(roughness, f, v, l_b, n, h_vec) * common
    rgb = ambient + diffuse + specular
    out = torch.cat([rgb, torch.ones((h, w, 1), dtype=torch.float32, device=dev)], -1)
    return out.permute(2, 0, 1).contiguous()
