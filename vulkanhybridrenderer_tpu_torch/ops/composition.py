"""Hybrid composition (composition.frag:64-161; port of ``ops/composition.py``).

G-buffer + shadow / AO / reflection sources -> final linear lighting.  The
sources: shadows from the raytrace pass (possibly denoised), the shadow map
through the 16-tap PCF, or OFF; AO from the raytrace pass, SSAO, or OFF;
reflections from the raytrace pass, SSR, or OFF.
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
from vulkanhybridrenderer_tpu_torch.ops import brdf, screen, shadowmap
from vulkanhybridrenderer_tpu_torch.utils.math3d import PI_INVERSE, normalize


def compose(gbuf: GBuffer, pfd: PerFrameData, settings: HybridSettings,
            shadow_map=None, ssao_tex=None, ssr_tex=None,
            rt_shadow_ao=None, rt_reflections=None, rows: screen.Rows | None = None):
    """shadow_map (S, S) when shadows are RASTERIZED; ssao_tex (H, W) when AO
    is SSAO; ssr_tex (4, H, W) when reflections are SSR; rt_shadow_ao
    (4, H, W) when any RT mode is on; rt_reflections (4, H, W) when
    reflections are RAYTRACED.  Returns the (4, H, W) linear frame (alpha
    1).  Per pixel: the images may be the `rows` of a taller frame (a mesh
    shard's slab); the shadow map is whole."""
    h, w = gbuf.depth.shape
    dev = gbuf.depth.device
    rows = rows or screen.Rows.whole(h)
    uv = screen.pixel_uv_grid(rows.height, w, dev, rows.start, h)
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
    elif settings.shadow_mode == ShadowMode.RASTERIZED:  # :88-111
        shadow = shadowmap.shadow_pcf16(shadow_map, pfd.directional_light.projview, p)
    else:
        shadow = torch.ones((h, w), dtype=torch.float32, device=dev)
    if settings.ao_mode == AmbientOcclusionMode.RAYTRACED:
        ao = rt_shadow_ao[1]
    elif settings.ao_mode == AmbientOcclusionMode.SSAO:
        ao = ssao_tex
    else:
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

    refl_src = {ReflectionMode.RAYTRACED: rt_reflections,
                ReflectionMode.SSR: ssr_tex}.get(settings.reflection_mode)
    if refl_src is not None:  # :145-156
        refl = refl_src[:3].permute(1, 2, 0) * shadow[..., None]
        specular = torch.where(
            (metallic == 1.0)[..., None], refl,
            specular + (refl - specular) * roughness[..., None],
        )
    rgb = ambient + diffuse + specular
    out = torch.cat([rgb, torch.ones((h, w, 1), dtype=torch.float32, device=dev)], -1)
    return out.permute(2, 0, 1).contiguous()
