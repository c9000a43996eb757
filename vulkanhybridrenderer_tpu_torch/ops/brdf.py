"""PBR BRDF terms (common.glsl:116-150; port of ``ops/brdf.py``)."""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.utils.math3d import PI, div, dot, normalize

MIN_ROUGHNESS = 0.04  # composition.frag:121


def fresnel_schlick(f0, h, v):
    """common.glsl:116-119 (five explicit multiplies, like the reference)."""
    h_dot_v = torch.clamp(dot(h, v, keepdim=True), min=0.0)
    m = 1.0 - h_dot_v
    return f0 + (1.0 - f0) * m * m * m * m * m


def d_ggx(roughness, n, h):
    """GGX distribution (common.glsl:122-127); a2 = roughness^2 as in the
    reference."""
    a2 = roughness * roughness
    n_dot_h = torch.clamp(dot(n, h), min=0.0)
    f = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI * f * f)


def g_ggx(roughness, n, v, l):
    """Schlick-GGX geometry term (common.glsl:130-139)."""
    k = (roughness + 1.0) * (roughness + 1.0) * 0.125
    n_dot_v = torch.clamp(dot(n, v), min=0.0)
    n_dot_l = torch.clamp(dot(n, l), min=0.0)
    return (n_dot_v / (n_dot_v * (1.0 - k) + k)) * (n_dot_l / (n_dot_l * (1.0 - k) + k))


def specular_brdf(roughness, f, v, l, n, h):
    """common.glsl:141-145.  roughness: (...,), f: (..., 3)."""
    dfg = (d_ggx(roughness, n, h) * g_ggx(roughness, n, v, l))[..., None] * f
    denom = 4.0 * torch.clamp(dot(n, v), min=0.0) * torch.clamp(dot(n, l), min=0.0)
    return dfg / torch.clamp(denom, min=1e-6)[..., None]


def diffuse_brdf(metallic, albedo, f):
    """common.glsl:147-150."""
    return div((1.0 - f) * (1.0 - metallic)[..., None] * albedo, PI)


def direct_lighting(albedo, metallic, roughness, n, v, l, light_color,
                    light_intensity, ambient_factor):
    """Ambient + GGX direct lighting (reflection_hit.rchit:52-71):
    ambient + (diffuse + specular) * max(N.L, 0) * intensity * color.
    albedo, n, v, l: (..., 3); metallic, roughness: (...,)."""
    roughness = torch.clamp(roughness, MIN_ROUGHNESS, 1.0)
    metallic = torch.clamp(metallic, 0.0, 1.0)
    h = normalize(l + v)
    f0 = torch.full_like(albedo, 0.04)
    f0 = f0 + (albedo - f0) * metallic[..., None]
    f = fresnel_schlick(f0, h, v)
    ambient = albedo * ambient_factor
    diffuse = diffuse_brdf(metallic, albedo, f)
    specular = specular_brdf(roughness, f, v, l, n, h)
    n_dot_l = torch.clamp(dot(n, l), min=0.0)[..., None]
    return ambient + (diffuse + specular) * n_dot_l * light_intensity * light_color
